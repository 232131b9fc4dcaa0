"""Input/output of the port: recorded-IQ readers, the WAV sink and the
software broadcast-FM modulator (jax-free counterparts of
``fm_radio_tpu.io``)."""
