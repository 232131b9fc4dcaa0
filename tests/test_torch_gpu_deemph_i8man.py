"""The de-emphasis recurrence's kernel and the K1 probe's manual-pipeline
kernel on the card, against their plain versions, bit for bit.

``chip_smoke.compare_deemph_edges``: ``k12_deemph_kernel`` against
``iir_filter`` at C = 1, 40 and 2,048 with 13, 14, 15, 65, 195 and 229
batches of 16 steps (one chunk of a lane's ring, several, the ring's
slots reused, the last chunk short), at the lenses' 2,048 x 16,384 and
the K2 probe's 1,024 x 32,768, in place and into NaN, on poisoned
memory.  ``chip_smoke.compare_man_edges``:
``fp_i8man_kernel`` against ``i8man_plain`` at the lens's tiles and
others, dots and full, on poisoned memory, a tile too large refused, and
its shared memory's C side against the host copy.  Each on the default
build and the bounds-checked one.  Marked ``gpu``: they skip where there
is no card (this file imports no JAX, so it runs on that machine with
``--noconftest``).
"""

import pytest
import torch


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("checked", [False, True],
                         ids=["default", "checked"])
def test_deemph_edges_on_card(checked):
    _need_card()
    import chip_smoke
    from fm_radio_tpu_torch.kernels import _build

    if checked:
        with _build.checked_build():
            rows = chip_smoke.compare_deemph_edges(seed=10)
    else:
        rows = chip_smoke.compare_deemph_edges()
    assert len(rows) == 2 * len(chip_smoke.DEEMPH_EDGE_SHAPES)
    assert all(r["ok"] for r in rows), [r for r in rows if not r["ok"]]


@pytest.mark.gpu
@pytest.mark.parametrize("checked", [False, True],
                         ids=["default", "checked"])
def test_man_edges_on_card(checked):
    _need_card()
    import chip_smoke
    from fm_radio_tpu_torch.kernels import _build

    if checked:
        with _build.checked_build():
            rows = chip_smoke.compare_man_edges(seed=11)
    else:
        rows = chip_smoke.compare_man_edges()
    assert len(rows) == 2 * len(chip_smoke.MAN_EDGE_TILES) + 1 + 5 * 5 * 2
    assert all(r["ok"] for r in rows), [r for r in rows if not r["ok"]]
