"""The port's copies of the JAX package's host modules (``config``,
``rds``, ``io.{synth,wav,pcm}``, ``utils/transfer``) against their
originals: the same values, bytes and decoded groups for the same input."""

import dataclasses

import numpy as np
import pytest
import torch

from fm_radio_tpu import config as jconfig
from fm_radio_tpu.io import pcm as jpcm
from fm_radio_tpu.io import synth as jsynth
from fm_radio_tpu.io import wav as jwav
from fm_radio_tpu.rds import chain as jchain
from fm_radio_tpu.utils import transfer as jtransfer
from fm_radio_tpu_torch import config as tconfig
from fm_radio_tpu_torch.io import pcm as tpcm
from fm_radio_tpu_torch.io import synth as tsynth
from fm_radio_tpu_torch.io import wav as twav
from fm_radio_tpu_torch.rds import chain as tchain
from fm_radio_tpu_torch.utils import transfer as ttransfer


def _fields(obj) -> dict:
    """A dataclass as a dict, nested dataclasses included."""
    return dataclasses.asdict(obj)


@pytest.mark.parametrize("cls", ["AnalogParams", "RateConfig", "BPSKConfig",
                                 "DemodConfig"])
def test_config_defaults_field_by_field(cls):
    """Every field and default of the copied dataclasses, and the derived
    cutoffs and rates, equal the JAX package's."""
    t, j = getattr(tconfig, cls)(), getattr(jconfig, cls)()
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert _fields(t) == _fields(j)
    if cls == "DemodConfig":
        for prop in ("k_deemphasis", "k_audio_lpr", "k_audio_lmr"):
            assert getattr(t, prop) == getattr(j, prop)
        assert [tconfig.AudioOut.LPR, tconfig.AudioOut.LMR,
                tconfig.AudioOut.STEREO] == [jconfig.AudioOut.LPR,
                                             jconfig.AudioOut.LMR,
                                             jconfig.AudioOut.STEREO]
        with pytest.raises(ValueError):
            tconfig.DemodConfig(frontend_band_no=64)
    if cls == "RateConfig":
        for prop in ("fs_fm_in", "fs_fm_out", "fs_rds", "fs_audio"):
            assert getattr(t, prop) == getattr(j, prop)
        assert t.block_sizes(65536) == j.block_sizes(65536)


def _symbols(seed: int):
    """Soft RDS symbols of a station's group schedule (three times over,
    after a few random bits), the stream the Manchester decoder takes,
    with noise; encoded by the JAX package's modulator helpers."""
    groups = jsynth.station_group_schedule(0x1234, ps="COPYTEST",
                                           rt="RADIOTEXT")
    rng = np.random.default_rng(seed)
    bits = np.concatenate([rng.integers(0, 2, 37).astype(np.uint8)]
                          + [jsynth.encode_rds_group(g) for g in groups * 3])
    sym = jsynth.rds_bits_to_symbols(bits)
    return (sym + 0.3 * rng.standard_normal(sym.size)).astype(np.float32)


def test_rds_chain_copy_decodes_identically():
    """One symbol stream through the copied chain and the original: the
    same bytes, groups, log lines and database summary."""
    sym = _symbols(3)
    t, j = tchain.make_rds_chain(), jchain.make_rds_chain()
    for lo in range(0, sym.size, 1000):
        t.process_symbols(sym[lo : lo + 1000])
        j.process_symbols(sym[lo : lo + 1000])
    np.testing.assert_array_equal(np.concatenate(t.rds_bytes),
                                  np.concatenate(j.rds_bytes))
    assert len(t.chain.groups) == len(j.chain.groups) > 0
    assert [[(b.data, b.block_type, b.is_valid) for b in g]
            for g in t.chain.groups] == \
        [[(b.data, b.block_type, b.is_valid) for b in g]
         for g in j.chain.groups]
    assert t.chain.log_lines == j.chain.log_lines
    assert t.db.summary() == j.db.summary()
    assert t.db.summary()["pi_code"] == "1234"


def test_modulator_copy_same_output():
    """FMModulator, station_group_schedule and make_wideband of the copy
    give the original's arrays for the same arguments and seed."""
    groups_t = tsynth.station_group_schedule(0xBEEF, ps="SYNTH", rt="X")
    groups_j = jsynth.station_group_schedule(0xBEEF, ps="SYNTH", rt="X")
    assert groups_t == groups_j
    kw = dict(left_hz=1000.0, right_hz=3000.0, rds_groups=groups_t)
    a = tsynth.FMModulator(tsynth.ModulatorConfig()).generate(20000, **kw)
    b = jsynth.FMModulator(jsynth.ModulatorConfig()).generate(20000, **kw)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tsynth.make_wideband({2: a}, 8),
                                  jsynth.make_wideband({2: b}, 8))


def test_wav_and_pcm_copies(tmp_path):
    """The WAV writer's bytes, the u8 recentring both ways, and the lazy
    int8-plane view against the originals."""
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((4000, 2)) * 0.3).astype(np.float32)
    twav.write_wav_int16(tmp_path / "t.wav", audio, 32000)
    jwav.write_wav_int16(tmp_path / "j.wav", audio, 32000)
    assert (tmp_path / "t.wav").read_bytes() == \
        (tmp_path / "j.wav").read_bytes()
    u8 = rng.integers(0, 256, (5000, 2), dtype=np.uint8)
    np.testing.assert_array_equal(tpcm.u8_to_c64(u8), jpcm.u8_to_c64(u8))
    iq = (rng.standard_normal(5000) + 1j * rng.standard_normal(5000)) * 60
    np.testing.assert_array_equal(tpcm.c64_to_u8(iq), jpcm.c64_to_u8(iq))
    u8.tofile(tmp_path / "cap.pcm")
    tl, jl = (m.LazyI8Pcm(str(tmp_path / "cap.pcm")) for m in (tpcm, jpcm))
    assert len(tl) == len(jl) == 5000
    np.testing.assert_array_equal(tl[100:3000], jl[100:3000])
    x8 = ttransfer.split_iq_i8(u8)
    np.testing.assert_array_equal(
        torch.stack(ttransfer.i8_planes_to_f32(torch.from_numpy(x8))).numpy(),
        np.stack([np.asarray(p) for p in jtransfer.i8_planes_to_f32(x8)]))


def test_copy_encoders_match():
    """The copy's RDS group encoder and symbol mapper give the original's
    bits and symbols."""
    g = (0x1234, (2 << 12) | 0b00000, 0x4845, 0x4C4C)
    np.testing.assert_array_equal(tsynth.encode_rds_group(g),
                                  jsynth.encode_rds_group(g))
    bits = jsynth.encode_rds_group(g)
    np.testing.assert_array_equal(tsynth.rds_bits_to_symbols(bits, 1),
                                  jsynth.rds_bits_to_symbols(bits, 1))
