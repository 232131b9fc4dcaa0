"""DSP ops in plain PyTorch: the numpy filter designers, FIR/Hilbert, IIR,
AGC, discriminator, harmonic mixer and the shared scalar math.  Each op is a
function with explicit carried state, batched over a leading channel axis —
the counterparts of ``fm_radio_tpu.ops`` and the building blocks of the
kernels' plain versions."""
