"""Checkpoint / resume: the complete stream-processing state as one .npz.

Counterpart of ``fm_radio_tpu/utils/checkpoint.py``.  The demodulator's
carry (``demod_init_state``: a dict of tensors, nested dicts and the
``pll`` / ``bpsk`` NamedTuples) is flattened to ``a/b`` keys, one array a
leaf in the leaf's own dtype (complex64, int32, float32), and host-side
extras go under ``__extra__/<name>``.  The keys and dtypes are the JAX
package's, so a checkpoint that either package writes resumes in the
other: kill the process at any block boundary, reload, and the output
continues bit-identically.
"""

from __future__ import annotations

import io

import numpy as np
import torch

_SEP = "/"
_EXTRA = f"__extra__{_SEP}"


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_asdict"):  # NamedTuple
        items = tree._asdict().items()
    else:
        return {prefix.rstrip(_SEP): tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    return out


def state_to_arrays(state) -> dict:
    """State -> {path: numpy array}, each leaf in its own dtype."""
    return {k: v.detach().cpu().numpy() for k, v in _flatten(state).items()}


def save_state(path_or_file, state, extra: dict | None = None) -> None:
    """Save the state (+ optional host-side extras) to .npz."""
    arrays = state_to_arrays(state)
    for k, v in (extra or {}).items():
        arrays[f"{_EXTRA}{k}"] = np.asarray(v)
    np.savez(path_or_file, **arrays)


def load_state(path_or_file, template) -> tuple:
    """Load a checkpoint into the structure of ``template`` (a state from
    ``demod_init_state``): each leaf in the template's dtype on the
    template's device.  Returns (state, extras dict)."""
    data = np.load(path_or_file, allow_pickle=False)
    arrays, extras = {}, {}
    for k in data.files:
        if k.startswith(_EXTRA):
            extras[k[len(_EXTRA):]] = data[k]
        else:
            arrays[k] = data[k]

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}{_SEP}")
                    for k, v in tree.items()}
        if hasattr(tree, "_asdict"):
            return type(tree)(**{k: rebuild(v, f"{prefix}{k}{_SEP}")
                                 for k, v in tree._asdict().items()})
        arr = arrays[prefix.rstrip(_SEP)]
        dtype = torch.empty(0, dtype=tree.dtype).numpy().dtype
        return torch.from_numpy(np.asarray(arr, dtype)).to(tree.device)

    return rebuild(template), extras


def roundtrip_bytes(state, extra=None) -> bytes:
    buf = io.BytesIO()
    save_state(buf, state, extra)
    return buf.getvalue()
