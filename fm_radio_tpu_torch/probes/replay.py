"""Save a kernel's disagreement with its plain version, and replay it.

When ``chip_smoke.py`` or the card test finds a kernel off its plain
version, :func:`save_case` writes the kernel's recorded arguments (carried
state included) and both outputs as one ``.npz``: every tensor as an
array, and the structure around them (the config, the coefficients'
NamedTuple, the state dicts, scalars) as a pickled skeleton in which each
tensor is a :class:`Leaf`.  :func:`replay` loads the case onto a device,
runs the arguments through the kernel's wrapper and its plain version
again, and reports each output leaf's max abs difference: the saved kernel
output against the saved plain one, the rerun kernel against the rerun
plain, and the rerun kernel against the saved kernel (a fault that does not
recur shows there).

    python -m fm_radio_tpu_torch.probes.replay chiprun_out/mismatch_k12_1.npz
    python -m fm_radio_tpu_torch.probes.replay FILE --device cpu

On the CPU both runs are the plain version.
"""

from __future__ import annotations

import argparse
import json
import pickle
from typing import NamedTuple

import numpy as np
import torch


class Leaf(NamedTuple):
    """A tensor's place in a saved skeleton: its array's key."""

    key: str


# the int16 format's kernels, by the names chip_smoke.py saves their cases
# under, and the kernel each is a form of
I16_VARIANTS = {"frontend_i16": "frontend", "frontend_i8_i16": "frontend_i8",
                "midend_i16": "midend", "pll_i16": "pll",
                "extract_i16": "extract", "extract_i16_f32dt": "extract"}


def stages() -> dict:
    """Each kernel's (wrapper, plain version), by the names under which
    ``demod_block``, ``wideband_demod_block`` and ``chip_smoke.py`` record
    their arguments.  The int16 variants (:data:`I16_VARIANTS`) share their
    kernel's entries: the recorded arguments carry the format."""
    from fm_radio_tpu_torch.kernels import (
        bpsk,
        chain,
        channelizer,
        extract,
        frontend,
        k12,
        midend,
        pll,
    )

    chan = (channelizer.channelize, channelizer.channelize_plain)
    st = {
        "k12": (k12.k12, k12.k12_plain),
        "pll": (pll.pilot_pll_theta, pll.pilot_pll_theta_plain),
        "extract": (extract.extract, extract.extract_plain),
        "bpsk": (bpsk.bpsk_sync, bpsk.bpsk_plain),
        "k12_ps": (k12.k12_ps, k12.k12_ps_plain),
        "channelizer": chan,
        "frontend": (frontend.frontend, frontend.frontend_plain),
        "frontend_i8": (frontend.frontend_i8, frontend.frontend_i8_plain),
        "midend": (midend.midend, midend.midend_plain),
        "chain": (chain.chain, chain.chain_plain),
        "pll_chunked": (pll.pilot_pll_chunked, pll.pll_chunked_plain),
        # every channelizer mode: the recorded arguments end with the mode
        "channelizer_i8mat": chan,
        "channelizer_bf16mat": chan,
    }
    st.update({name: st[base] for name, base in I16_VARIANTS.items()})
    return st


def _split(obj, arrays: dict, prefix: str):
    """``obj`` with every tensor moved into ``arrays`` and replaced by a
    :class:`Leaf`."""
    if isinstance(obj, torch.Tensor):
        key = f"{prefix}{len(arrays)}"
        arrays[key] = obj.detach().cpu().numpy()
        return Leaf(key)
    if isinstance(obj, dict):
        return {k: _split(v, arrays, prefix) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_split(v, arrays, prefix) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_split(v, arrays, prefix) for v in obj)
    return obj


def _join(obj, data, device):
    if isinstance(obj, Leaf):
        return torch.from_numpy(np.array(data[obj.key])).to(device)
    if isinstance(obj, dict):
        return {k: _join(v, data, device) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_join(v, data, device) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_join(v, data, device) for v in obj)
    return obj


def case_nbytes(*objs) -> int:
    """The bytes of every tensor in ``objs`` (what :func:`save_case`
    writes before compression)."""
    arrays: dict = {}
    _split(objs, arrays, "")
    return sum(a.nbytes for a in arrays.values())


def save_case(path, name: str, args, kernel_out, plain_out,
              errors: dict) -> None:
    """Write one disagreement as a compressed ``.npz`` (module
    docstring)."""
    arrays: dict = {}
    skeleton = {"name": name, "errors": errors,
                "args": _split(tuple(args), arrays, "a"),
                "kernel_out": _split(kernel_out, arrays, "k"),
                "plain_out": _split(plain_out, arrays, "p")}
    blob = np.frombuffer(pickle.dumps(skeleton), np.uint8)
    np.savez_compressed(path, __skeleton__=blob, **arrays)


def load_case(path, device="cpu") -> dict:
    """A saved case with its tensors on ``device``: {"name", "errors",
    "args", "kernel_out", "plain_out"}."""
    with np.load(path) as data:
        skeleton = pickle.loads(data["__skeleton__"].tobytes())
        return {k: _join(v, data, torch.device(device))
                for k, v in skeleton.items()}


def leaves(obj, prefix: str = "") -> list:
    """(path, tensor) for every tensor in a nested output."""
    if isinstance(obj, torch.Tensor):
        return [(prefix or "out", obj)]
    if isinstance(obj, dict):
        items = obj.items()
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        items = zip(obj._fields, obj)
    elif isinstance(obj, (tuple, list)):
        items = enumerate(obj)
    else:
        return []
    return [lf for k, v in items for lf in leaves(v, f"{prefix}/{k}")]


def leaf_diffs(a, b) -> dict:
    """Max abs difference of each tensor leaf of two outputs of one
    function (complex as re/im, bool as the count that differ)."""
    out = {}
    for (p, u), (_, v) in zip(leaves(a), leaves(b)):
        if u.dtype == torch.bool:
            out[p] = float((u != v.to(u.device)).sum())
            continue
        if u.is_complex():
            u, v = torch.view_as_real(u), torch.view_as_real(v)
        d = (u.double() - v.to(u.device).double()).abs()
        out[p] = float(d.max()) if d.numel() else 0.0
    return out


def replay(path, device="cpu") -> dict:
    """Rerun a saved case on ``device`` (module docstring).  Returns
    {"name", "saved_errors", "saved_kernel_vs_plain", "rerun_kernel_vs_plain",
    "rerun_vs_saved_kernel"}, the last three per output leaf."""
    case = load_case(path, device)
    kern, plain = stages()[case["name"]]
    kout, pout = kern(*case["args"]), plain(*case["args"])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return {"name": case["name"], "saved_errors": case["errors"],
            "saved_kernel_vs_plain": leaf_diffs(case["kernel_out"],
                                                case["plain_out"]),
            "rerun_kernel_vs_plain": leaf_diffs(kout, pout),
            "rerun_vs_saved_kernel": leaf_diffs(kout, case["kernel_out"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("case", help="a .npz written by save_case")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(replay(args.case, args.device), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
