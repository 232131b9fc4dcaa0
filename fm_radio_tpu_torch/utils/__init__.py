"""Host-side helpers: ingest conventions and state conversion."""
