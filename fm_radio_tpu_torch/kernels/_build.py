"""Build and load the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, under
``fm_radio_tpu_torch/_build/<hash>/``: the hash covers every source in
``csrc/`` and the flags, so an edited source builds anew.  The libraries
are loaded with ``ctypes``; every pointer and the stream cross as
``c_void_p``, and every C entry returns a ``cudaError_t`` that
:func:`check` turns into an exception.  Nothing here runs at import time.

``build(checked=True)`` builds the same sources with ``-DFMT_CHECKED``
into their own hash directory: the device code of K12, the sequential PLL
and extract then checks every index it reads or writes in device memory
and traps on one out of bounds (``csrc/common.cuh``,
``FMT_AT``), and every C entry synchronises after each launch.  Inside
``with checked_build():`` the wrappers launch those libraries; nothing
else selects them.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NAMES = ("k12", "pll", "extract", "bpsk", "channelizer", "channelizer_wgmma",
         "frontend", "midend", "chain", "hbm_sweep", "frontend_probe",
         "k2_probe", "k3_probe")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

P = ctypes.c_void_p
I = ctypes.c_int
I64 = ctypes.c_int64
F = ctypes.c_float

CHECKED_FLAGS = ("-DFMT_CHECKED",)

# loaded libraries by (name, checked)
_libs: dict[tuple[str, bool], ctypes.CDLL] = {}
_checked = False  # set only inside checked_build()


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or
    ``PATH``; raises if there is none."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _flags(checked: bool) -> tuple:
    return NVCC_FLAGS + (CHECKED_FLAGS if checked else ())


def _digest(checked: bool = False) -> str:
    h = hashlib.sha256(" ".join(_flags(checked)).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_dir(checked: bool = False) -> Path:
    return BUILD_ROOT / _digest(checked)


def build(checked: bool = False) -> float:
    """Compile every missing library (in parallel), bounds-checked with
    ``checked`` (module docstring).  Returns the seconds spent; raises
    RuntimeError with nvcc's output if a compile fails."""
    out = build_dir(checked)
    todo = [n for n in NAMES if not (out / f"lib{n}.so").is_file()]
    if not todo:
        return 0.0
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    exe = nvcc()
    jobs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
        os.close(fd)
        cmd = [exe, *_flags(checked), "-o", tmp, str(CSRC / f"{name}.cu")]
        jobs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {name}.cu:\n{log}")
        else:
            os.replace(tmp, out / f"lib{name}.so")
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


@contextlib.contextmanager
def checked_build():
    """Within the block, every wrapper launches the bounds-checked build's
    kernels (built here if needed; module docstring)."""
    global _checked
    build(checked=True)
    prev, _checked = _checked, True
    try:
        yield
    finally:
        _checked = prev


def function(lib: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of ``lib<lib>.so`` (built if needed), with
    its argument types set and an int (``cudaError_t``) result: from the
    checked build inside :func:`checked_build`, else the default one."""
    key = (lib, _checked)
    if key not in _libs:
        build(_checked)
        _libs[key] = ctypes.CDLL(str(build_dir(_checked) / f"lib{lib}.so"))
        _libs[key].fmt_error_string.argtypes = [I]
        _libs[key].fmt_error_string.restype = ctypes.c_char_p
    fn = getattr(_libs[key], symbol)
    fn.argtypes = argtypes
    fn.restype = I
    return fn


def check(lib: str, err: int) -> None:
    """Raise if a C entry reported a CUDA error (launch refused, bad
    configuration, an earlier asynchronous fault, or in the checked build
    an index out of bounds)."""
    if err != 0:
        msg = _libs[(lib, _checked)].fmt_error_string(err).decode()
        build = " (checked build)" if _checked else ""
        raise RuntimeError(f"CUDA kernel {lib} failed{build}: error {err} "
                           f"({msg})")


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device``, as the kernels take it.
    Launching there keeps a wrapper's temporaries safe after it returns:
    the caching allocator hands a freed block only to work queued behind
    the kernel on the same stream."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require(name: str, device, dtype, **tensors) -> None:
    """Validate what a kernel takes: every tensor on ``device`` (a CUDA
    device), contiguous and of ``dtype``; raises ValueError otherwise."""
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {key} is {t.dtype}, not {dtype}")


def on_cpu(name: str, device) -> bool:
    """Dispatch by device: True for the CPU (the caller runs its plain
    version), False for CUDA (the caller launches its kernel); any other
    device raises."""
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    return False
