"""Wideband front end: the polyphase FFT channelizer — the counterpart of
``fm_radio_tpu.parallel`` (its sharding modules are not ported yet)."""
