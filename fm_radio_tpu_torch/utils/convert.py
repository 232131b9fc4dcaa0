"""Demodulator state between numpy and the port's torch tensors.

The JAX package's ``demod_init_state`` / ``demod_block`` state, fetched as
numpy (a dict of arrays, nested dicts and NamedTuples), becomes the port's
torch state on a device, and back.  NamedTuples are matched by field name,
so one state can start both packages.  The wideband state,
``{"chan": (sr, si), "demod": {...}}``, converts the same way: plain tuples
stay tuples and the nested demod dict keeps its NamedTuples.
"""

from __future__ import annotations

import numpy as np
import torch

from fm_radio_tpu_torch.models.bpsk import BPSKState
from fm_radio_tpu_torch.models.pilot_pll import PilotPLLState

# state keys whose value is a loop-state NamedTuple
_TUPLES = {"pll": PilotPLLState, "bpsk": BPSKState}


def state_from_numpy(state: dict, device="cpu") -> dict:
    """Numpy (or JAX-fetched) state -> torch state on ``device``.  Leaf
    dtypes are kept (complex64, int32, float32)."""

    def conv(key, v):
        if key in _TUPLES:
            cls = _TUPLES[key]
            get = v.get if isinstance(v, dict) else (lambda f: getattr(v, f))
            return cls(*(conv(None, get(f)) for f in cls._fields))
        if isinstance(v, dict):
            return {k: conv(k, w) for k, w in v.items()}
        if isinstance(v, (tuple, list)):
            return tuple(conv(None, w) for w in v)
        return torch.from_numpy(np.array(v)).to(device)

    return {k: conv(k, v) for k, v in state.items()}


def state_to_numpy(state: dict) -> dict:
    """Torch state -> numpy arrays, keeping the dict and NamedTuple
    structure."""

    def conv(v):
        if isinstance(v, tuple):
            items = (conv(w) for w in v)
            return type(v)(*items) if hasattr(v, "_fields") else tuple(items)
        if isinstance(v, dict):
            return {k: conv(w) for k, w in v.items()}
        return v.detach().cpu().numpy()

    return {k: conv(v) for k, v in state.items()}
