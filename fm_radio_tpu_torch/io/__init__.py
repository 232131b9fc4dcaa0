"""Capture readers of the port (jax-free counterparts of
``fm_radio_tpu.io``)."""
