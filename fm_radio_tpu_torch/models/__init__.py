"""The demodulator pipeline, its loop states and the application layer —
the counterparts of ``fm_radio_tpu.models``."""
