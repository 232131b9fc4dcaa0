"""The port's CUDA kernels on the card.

This file imports neither jax nor the JAX package, so it also runs on a
machine without them; tests/conftest.py imports jax, hence:

    python -m pytest tests/test_torch_gpu.py -q -m gpu --noconftest

Where there is no CUDA device every test skips.
"""

import pytest
import torch


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_cuda_kernels_match_plain_on_card():
    """Each CUDA kernel against its plain version on the card, two blocks
    with carried state, at a small shape (chip_smoke.py runs the same at
    C=256, B=131072)."""
    _need_card()
    import chip_smoke

    rows = chip_smoke.compare_kernels(channels=8, block=16384, blocks=2)
    assert all(r["ok"] for r in rows), rows


@pytest.mark.gpu
def test_cli_selftest_on_card(capsys):
    """The user entry point runs the kernels and passes its gates (at its
    default 2 s: the station name needs about that long to arrive)."""
    _need_card()
    from fm_radio_tpu_torch.apps.cli import main

    assert main(["selftest"]) == 0, capsys.readouterr().out
