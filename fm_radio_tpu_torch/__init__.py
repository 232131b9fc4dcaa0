"""fm_radio_tpu_torch — the broadcast-FM receiver on PyTorch and CUDA.

The PyTorch/CUDA counterpart of the JAX package ``fm_radio_tpu``, module for
module under the same names.  Plain functions on tensors carry the
cross-block state explicitly, exactly as the JAX package does; every stage
that the JAX package ran as a Pallas kernel is a CUDA C++ kernel here
(``csrc/``), built with ``nvcc`` for ``sm_90a`` at first use.

Dispatch is by device: a kernel wrapper given CPU tensors runs its plain
PyTorch version; given CUDA tensors it launches its kernel or raises.

The package imports nothing of ``fm_radio_tpu``: the host-only modules it
needs are copies (``config``, ``rds``, ``io.{synth,wav,pcm}``, and the
design and transfer helpers), so it runs where jax is not installed.
"""

__version__ = "0.1.0"

import torch

from fm_radio_tpu_torch.config import DemodConfig  # noqa: F401

# The plain versions are compared with the kernels in full float32; TF32
# would cut a float32 convolution or matmul on the card to ~3 decimal digits.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
