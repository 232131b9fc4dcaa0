"""The port's wideband entry points on the CPU (plain versions): the
``stations`` command on a synthesized capture file and ``selftest
--stations``, each holding every station's PI, name and group count.
Each runs about 1 s of signal (the names need about that long to
arrive)."""

import json

import pytest
import torch

from fm_radio_tpu_torch.apps.cli import main, power_ceil, wideband_capture


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops; with pytest-xdist
    workers sharing the cores, torch's intra-op threads only contend
    (several times slower), so this module runs them on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _verdict(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_stations_auto(tmp_path, capsys):
    """Two stations on an M = 8 grid (channels 1 and 2) written as a u8
    capture: ``--auto`` finds exactly those channels, and each one's WAV
    and RDS database come out with its own PI and name."""
    m, block = 8, 16384
    n = 80 * block  # 1.28 s per channel
    pcm = tmp_path / "wide.pcm"
    wideband_capture(2, m, n).tofile(pcm)
    out = tmp_path / "out"
    rc = main(["stations", "-i", str(pcm), "-o", str(out), "-m", str(m),
               "-b", str(block), "--auto", "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert [s["channel"] for s in summary] == [1, 2]
    for i, s in enumerate(summary):
        assert s["pi_code"] == f"{0x1234 + i:04X}", s
        assert s["service_name"] == f"ST {i + 1:02d}".ljust(8), s
        assert (out / f"station_{i + 1:02d}.wav").stat().st_size > 44


def test_cli_selftest_stations(capsys, monkeypatch):
    """``selftest --stations 2 --device cpu`` passes its per-station gates
    (M = power_ceil(4) = 4 channels), and without a CUDA device the
    default device refuses with exit code 2 instead of falling back."""
    rc = main(["selftest", "--stations", "2", "--device", "cpu",
               "--seconds", "1.0", "-b", "16384"])
    verdict = _verdict(capsys)
    assert rc == 0, verdict
    assert verdict["mode"] == f"wideband x2 (m={power_ceil(4)})"
    assert set(verdict["checks"]) == {"station_1", "station_2"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["selftest", "--stations", "2"]) == 2
    with pytest.raises(SystemExit):
        main(["stations"])  # -o is required
