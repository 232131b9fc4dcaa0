"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Each module holds one kernel's wrapper, its plain version and its launch
counter ``launches``; the wrapper runs the plain version for CPU tensors
and launches the kernel for CUDA tensors (``_build.py`` builds and loads
the libraries at first use)."""
