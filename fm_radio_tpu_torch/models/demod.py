"""Broadcast-FM demodulator: the channel-batched pipeline.

Counterpart of ``fm_radio_tpu/models/demod.py`` (demod.py:247-658), on
every ingest form:

    x: [C, B] complex64 (u8 - 127 baseband), [2, C, B] float32 planes,
       [C, B] float32 packed u8 words (w = I * 256 + Q), [2, C, B] int8
       planes (u8 - 128), or the same as phase-split planes [2, 4, C, B/4]
       (x_p[u] = x[4u + p], the wideband channelizer's M = 32 output)
      -> with chain_fusion != "split", on complex64, float32 planes or
         words where the JAX gate holds (:func:`fuse_chain`):
         the megakernel (kernels/chain.py): K1 (float taps), K2, the
         sequential PLL and extract in one kernel -> L+R, L-R, RDS planes
      -> int8 planes with frontend_int8 and k12_fusion != "off":
         K12 (kernels/k12.py)     ds x4, discriminator, ds x2, de-emphasis,
                                  Hilbert, pilot peak IIR -> (re, im), theta
      -> every other form (the default DemodConfig()), and int8 planes
         under interstage_i16:
         K1 (kernels/frontend.py) ds x4, discriminator -> fm_demod
         K2 (kernels/midend.py)   ds x2, de-emphasis, Hilbert, peak IIR
      -> pilot PLL (kernels/pll.py), chunked where pll_time_chunks > 1
         passes its gate                                 -> dt
      -> extract (kernels/extract.py)  L+R, L-R, RDS planes + RDS power
      -> L-R phase correction (small tensor ops)
      -> RDS AGC: the gain from extract's power sum, applied at the BPSK
         kernel's ingest; after the megakernel the unfused AGC on the RDS
         planes, then BPSK without a gain
      -> BPSK sync (kernels/bpsk.py)
      -> stereo mix                                      -> audio [C, B/32, 2]

With ``interstage_i16`` the split path's intermediates cross device
memory in the int16 format of ``kernels/qformat.py`` wherever the JAX
package's kernel gates hold (:func:`_split`); the megakernel ignores the
flag, as the JAX gate does.

Every function is pure in (cfg, coeffs, state, x); the state dict has the
JAX package's keys, leaf shapes and dtypes.  Each kernel wrapper dispatches
by device: CPU tensors take the plain PyTorch version, CUDA tensors the
CUDA kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from fm_radio_tpu_torch.config import AudioOut, DemodConfig
from fm_radio_tpu_torch.kernels.bpsk import bpsk_sync
from fm_radio_tpu_torch.kernels.chain import chain, pick_tiles_chain
from fm_radio_tpu_torch.kernels.extract import (
    extract,
    harmonics,
    pick_tiles_ext,
)
from fm_radio_tpu_torch.kernels.frontend import (
    frontend,
    frontend_i8,
    pick_tiles,
)
from fm_radio_tpu_torch.kernels.k12 import (
    interleave_ps,
    k12,
    k12_ps,
    quantize_ds4_taps,
)
from fm_radio_tpu_torch.kernels.midend import midend, pick_tiles_mid
from fm_radio_tpu_torch.kernels.qformat import (
    FM_SCALE,
    PH_SCALE,
    dq_i16,
    dq_if_i16,
)
from fm_radio_tpu_torch.kernels.pll import (
    chunk_gate,
    pilot_pll_chunked,
    pilot_pll_theta,
)
from fm_radio_tpu_torch.models.bpsk import bpsk_init_state
from fm_radio_tpu_torch.models.pilot_pll import pilot_pll_init_state
from fm_radio_tpu_torch.ops.agc import (
    _agc_gain,
    agc_init_state,
    agc_process_p,
    mean_last,
)
from fm_radio_tpu_torch.ops.cmath import div_scalar, f32
from fm_radio_tpu_torch.ops.design import (
    create_fir_hilbert,
    create_fir_lpf,
    create_iir_peak_1_filter,
    create_iir_single_pole_lpf,
)
from fm_radio_tpu_torch.ops.iir import iir_init_state

# the int8 production configuration (demod --ingest i8, the wideband
# stations): int8 planes take the fused K12
INT8_CONFIG = DemodConfig(frontend_int8=True)
BLOCK_MULTIPLE = 8192
# the samples before its output that a kernel's tile holds (its halo)
MAX_HALO = 128


class DemodCoeffs(NamedTuple):
    """Filter taps (float32 tensors on the device) and IIR coefficients
    (float32-valued Python floats), designed on the host."""

    taps_fm_in: torch.Tensor      # [64]  ds x4 LPF
    taps_fm_out: torch.Tensor     # [64]  ds x2 LPF
    taps_hilbert: torch.Tensor    # [65]
    taps_audio_lpr: torch.Tensor  # [128] ds x4 LPF
    taps_audio_lmr: torch.Tensor  # [128] ds x4 LPF
    taps_rds: torch.Tensor        # [128] ds x8 LPF
    peak_b: tuple                 # [3] pilot IIR peak
    peak_a: tuple
    deemph_b: tuple               # [2] de-emphasis single-pole LPF
    deemph_a: tuple
    # ds x4 taps as quantize_band_int8 splits them: (b1, b2) int8 tensors in
    # reversed tap order, and the float32 recentre correction s_row
    k1_i8: tuple


def make_coeffs(cfg: DemodConfig, device="cpu") -> DemodCoeffs:
    """Design every filter as ``fm_radio_tpu.models.demod.make_coeffs``
    does (``broadcast_fm_demod.cpp:127-304,330-389``)."""
    r = cfg.rates
    roll = cfg.downsampling_rolloff_factor
    # reference quirk, replicated: the fm_in decimator is sized with
    # order_poly_ds_lpf_fm_out (broadcast_fm_demod.cpp:134)
    k_fm_in = (r.fs_fm_in / 2.0) / (r.fs_baseband / 2.0) * roll
    taps_fm_in = create_fir_lpf(cfg.order_poly_ds_lpf_fm_out, k_fm_in)
    k_fm_out = (r.fs_fm_out / 2.0) / (r.fs_fm_in / 2.0) * roll
    taps_fm_out = create_fir_lpf(cfg.order_poly_ds_lpf_fm_out, k_fm_out)
    taps_hilbert = create_fir_hilbert(cfg.order_fir_hilbert)
    taps_audio_lpr = create_fir_lpf(cfg.order_poly_ds_lpf_audio, cfg.k_audio_lpr)
    taps_audio_lmr = create_fir_lpf(cfg.order_poly_ds_lpf_audio, cfg.k_audio_lmr)
    k_rds = cfg.analog.f_rds_bandwidth / (r.fs_fm_out / 2.0)
    taps_rds = create_fir_lpf(cfg.order_poly_ds_lpf_rds, k_rds)
    k_pilot = cfg.analog.f_pilot / (r.fs_fm_out / 2.0)
    peak_b, peak_a = create_iir_peak_1_filter(k_pilot, 0.9999)
    deemph_b, deemph_a = create_iir_single_pole_lpf(cfg.k_deemphasis)

    def dev(taps):
        return torch.as_tensor(np.asarray(taps, np.float32), device=device)

    def host(coefs):
        return tuple(f32(v) for v in np.asarray(coefs, np.float32))

    b1, b2, s_row = quantize_ds4_taps(taps_fm_in)
    return DemodCoeffs(
        taps_fm_in=dev(taps_fm_in),
        taps_fm_out=dev(taps_fm_out),
        taps_hilbert=dev(taps_hilbert),
        taps_audio_lpr=dev(taps_audio_lpr),
        taps_audio_lmr=dev(taps_audio_lmr),
        taps_rds=dev(taps_rds),
        peak_b=host(peak_b),
        peak_a=host(peak_a),
        deemph_b=host(deemph_b),
        deemph_a=host(deemph_a),
        k1_i8=(torch.as_tensor(b1, device=device),
               torch.as_tensor(b2, device=device), s_row),
    )


def demod_init_state(cfg: DemodConfig, channels: int, device="cpu") -> dict:
    """The complete cross-block carry, keyed, shaped and typed exactly as
    ``fm_radio_tpu.models.demod.demod_init_state`` (demod.py:189-218)."""
    r = cfg.rates
    c = channels
    nn_in = cfg.order_poly_ds_lpf_fm_out
    nn_out = cfg.order_poly_ds_lpf_fm_out
    nn_aud = cfg.order_poly_ds_lpf_audio
    nn_rds = cfg.order_poly_ds_lpf_rds

    def z(n, dtype=torch.float32):
        return torch.zeros((c, n), dtype=dtype, device=device)

    return {
        "ds_fm_in": z(nn_in - r.ds_fm_in, torch.complex64),
        "disc_prev_theta": torch.zeros((c,), device=device),
        "ds_fm_out": z(nn_out - r.ds_fm_out),
        "deemph": iir_init_state(c, 1, device),
        "hilbert": z(cfg.order_fir_hilbert - 1),
        "peak_pilot": iir_init_state(2 * c, 2, device),
        "agc_pilot": agc_init_state(c, device),
        "pll": pilot_pll_init_state(c, device),
        "ds_audio_lpr": z(nn_aud - r.ds_audio, torch.complex64),
        "ds_audio_lmr": z(nn_aud - r.ds_audio, torch.complex64),
        "lmr_phase_err": torch.zeros((c,), device=device),
        "ds_rds": z(nn_rds - r.ds_rds, torch.complex64),
        "agc_rds": agc_init_state(c, device),
        "bpsk": bpsk_init_state(c, device),
    }


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md, {item}")


def ingest_form(x) -> str:
    """"complex", "planes", "words", "i8" or "i8ps" for an input that
    ``demod_block`` takes; NotImplementedError for anything else."""
    if x.dtype == torch.complex64 and x.ndim == 2:
        return "complex"
    if x.dtype == torch.float32 and x.ndim == 3 and x.shape[0] == 2:
        return "planes"
    if x.dtype == torch.float32 and x.ndim == 2:
        return "words"
    if x.dtype == torch.int8 and x.ndim == 3 and x.shape[0] == 2:
        return "i8"
    if x.dtype == torch.int8 and x.ndim == 4 and tuple(x.shape[:2]) == (2, 4):
        return "i8ps"
    raise _not_ported(f"{x.dtype} input of shape {tuple(x.shape)}",
                      "modules still to port, item 1 (other ingest forms)")


def filter_halos(coeffs: DemodCoeffs) -> dict:
    """Each filter's halo, the input samples before an output that its
    window reaches (the JAX gates' terms, demod.py:315-320, :348-350, :381,
    :431-432, :455-458, :524-528), by the taps' name."""
    return {"taps_fm_in": coeffs.taps_fm_in.shape[0] - 4,
            "taps_fm_out": coeffs.taps_fm_out.shape[0] - 2,
            "taps_hilbert": coeffs.taps_hilbert.shape[0] - 1,
            "taps_audio_lpr": coeffs.taps_audio_lpr.shape[0] - 4,
            "taps_audio_lmr": coeffs.taps_audio_lmr.shape[0] - 4,
            "taps_rds": coeffs.taps_rds.shape[0] - 8}


def check_slice(cfg: DemodConfig, coeffs: DemodCoeffs, x,
                include_taps: bool = False) -> str:
    """Raise NotImplementedError for any ingest form or option outside the
    ported slice, naming the ROADMAP.md item that will add it, before any
    launch and on every device: include_taps, a rate cascade other than
    4/2/4/8, a filter whose window reaches past the kernels' 128-sample
    halo (:func:`filter_halos`; the JAX package runs those stages as XLA
    ops), and L-R or RDS carriers other than the pilot's 2nd and 3rd
    harmonics (``kernels/extract.py::harmonics``).  Returns the ingest form
    (:func:`ingest_form`).
    ``frontend_band_no`` is the TPU kernel's tiling knob, output-identical,
    and is accepted."""
    form = ingest_form(x)
    if include_taps:
        raise _not_ported("include_taps", "modules still to port, item 2 "
                          "(include_taps and the scan loops)")
    long = {k: h for k, h in filter_halos(coeffs).items() if h > MAX_HALO}
    if long:
        raise _not_ported(
            f"a filter reaching past the kernels' {MAX_HALO}-sample halo "
            f"({', '.join(f'{k}: {h}' for k, h in long.items())})",
            "modules still to port, item 1 (filter orders past the halo)")
    r = cfg.rates
    if (r.ds_fm_in, r.ds_fm_out, r.ds_audio, r.ds_rds) != (4, 2, 4, 8):
        raise _not_ported("a rate cascade other than 4/2/4/8",
                          "modules still to port, item 1 (other options)")
    harmonics(cfg)
    b = x.shape[-1] * (4 if form == "i8ps" else 1)
    if b % BLOCK_MULTIPLE:
        raise ValueError(f"block size {b} is not a multiple of "
                         f"{BLOCK_MULTIPLE}")
    return form


def fuse_chain(cfg: DemodConfig, coeffs: DemodCoeffs, form: str, c: int,
               b: int) -> bool:
    """Whether ``demod_block`` takes the megakernel: the JAX gate
    (demod.py:307-323) with ``include_taps`` off (check_slice raises for
    it) and the 4/2/4/8 cascade (check_slice holds it): chain_fusion !=
    "split", every filter reaching at most 128 samples back, the L-R and
    L+R filters of one order, an ingest form other than int8 planes, and
    the JAX kernel's shape contract (:func:`pick_tiles_chain`, planes'
    channel tiles for complex64)."""
    return (cfg.chain_fusion != "split"
            and max(filter_halos(coeffs).values()) <= MAX_HALO
            and coeffs.taps_audio_lmr.shape == coeffs.taps_audio_lpr.shape
            and form in ("complex", "planes", "words")
            and pick_tiles_chain(c, b, form == "words") is not None)


def demod_block(cfg: DemodConfig, coeffs: DemodCoeffs, state: dict,
                x: torch.Tensor, include_taps: bool = False,
                record: dict | None = None):
    """Demodulate one block: x [C, B] complex64, [2, C, B] float32 planes,
    [C, B] float32 packed words, [2, C, B] int8 planes (u8 - 128), or the
    int8 block as phase-split planes [2, 4, C, B/4] (module docstring).

    Returns (state', outs): outs["audio"] [C, B/32, 2] float32,
    outs["rds_sym"] complex64, outs["rds_pred"] float32 and
    outs["rds_valid"] bool, each [C, B/64].  On CUDA tensors every stage
    runs in the kernels on the card; nothing falls back to the CPU.

    ``record``, if given, receives the arguments of each kernel wrapper
    under the kernel's name ("chain"; or "k12" or "k12_ps", or "frontend"
    or "frontend_i8" and "midend", then "pll" or "pll_chunked" and
    "extract"; then "bpsk"), so that a caller can run the wrapper or its
    plain version again on this block's own inputs (under
    ``interstage_i16`` they carry the int16 tensors and flags).
    """
    form = check_slice(cfg, coeffs, x, include_taps)
    st = dict(state)
    c = x.shape[-2]
    b = x.shape[-1] * (4 if form == "i8ps" else 1)

    def run(name, fn, *args):
        if record is not None:
            record[name] = tuple(dict(a) if isinstance(a, dict) else a
                                 for a in args)
        return fn(*args)

    if fuse_chain(cfg, coeffs, form, c, b):
        # ---- the megakernel (demod.py:325-331) ----------------------------
        if form == "complex":  # as demod.py:248-249 splits it
            x = torch.stack([x.real, x.imag])
        st, audio_lpr, tmp_lmr_p, rds_p = run("chain", chain, coeffs, cfg,
                                              st, x)
        rds_pow = None
    else:
        st, audio_lpr, tmp_lmr_p, rds_p, rds_pow = _split(cfg, coeffs, st, x,
                                                          form, run)

    # ---- L-R phase correction: read by extract above, updated here from
    # the strided decimated L-R IQ (demod.py:557-566) ---------------------
    stride = cfg.audio_lmr_phase_read_stride
    phase = torch.atan2(tmp_lmr_p[1][:, ::stride], tmp_lmr_p[0][:, ::stride])
    half_pi = f32(math.pi / 2.0)
    est = torch.where(phase > 0.0, half_pi - phase, -half_pi - phase)
    new_off = st["lmr_phase_err"] + f32(cfg.audio_lmr_phase_beta) * mean_last(est)
    st["lmr_phase_err"] = torch.fmod(new_off, f32(2.0 * math.pi))
    audio_lmr = tmp_lmr_p[1]

    if rds_pow is None:
        # ---- the unfused RDS AGC, then BPSK without a gain
        # (demod.py:599-609) ----------------------------------------------
        st["agc_rds"], rds_agc_p = agc_process_p(
            st["agc_rds"], rds_p, target_power=cfg.bpsk.agc_target_power)
        st["bpsk"], bpsk_outs = run("bpsk", bpsk_sync, cfg, st["bpsk"],
                                    rds_agc_p, None)
    else:
        # ---- RDS AGC from the extract kernel's power sum, applied at the
        # BPSK kernel's ingest (demod.py:576-598) -------------------------
        st["agc_rds"] = _agc_gain(st["agc_rds"],
                                  div_scalar(rds_pow, rds_p[0].shape[-1]),
                                  cfg.bpsk.agc_target_power, 0.2)
        st["bpsk"], bpsk_outs = run("bpsk", bpsk_sync, cfg, st["bpsk"],
                                    rds_p, st["agc_rds"])

    # ---- audio mix (demod.py:616-625) ----------------------------------
    if cfg.audio_out == AudioOut.STEREO:
        k = f32(cfg.audio_stereo_mix_factor)
        left = audio_lpr + k * audio_lmr
        right = audio_lpr - k * audio_lmr
    elif cfg.audio_out == AudioOut.LMR:
        left = right = audio_lmr
    else:
        left = right = audio_lpr
    audio = torch.stack([left, right], dim=-1) * 2.0

    outs = {
        "audio": audio,
        "rds_sym": bpsk_outs["sym"],
        "rds_pred": bpsk_outs["pred"],
        "rds_valid": bpsk_outs["valid"],
    }
    return st, outs


def _split(cfg, coeffs, st: dict, x, form: str, run):
    """K12, or K1 + K2; the pilot PLL; extract (demod.py:333-540).
    Returns (state', lpr, lmr planes, RDS planes, RDS power).

    Under ``interstage_i16`` the JAX gates decide each hop's format: K12
    refuses the flag (demod.py:345); K1 emits int16 where its tile gate
    holds (:377-389); K2 dequantises where its own gate fails (:435-440)
    and emits int16 where extract's gate is predicted to hold (:450-463);
    the PLL and extract take what arrives (kernels/pll.py,
    kernels/extract.py)."""
    c, b = x.shape[-2], x.shape[-1] * (4 if form == "i8ps" else 1)
    fuse_k12 = (form in ("i8", "i8ps") and cfg.frontend_int8
                and cfg.k12_fusion != "off" and not cfg.interstage_i16)
    if form == "i8ps" and not fuse_k12:
        if x.device.type != "cpu" and not cfg.interstage_i16:
            raise ValueError(
                "phase-split planes need the fused K12 on the card "
                "(frontend_int8=True, k12_fusion != 'off'); only the plain "
                "version and interstage_i16 re-interleave them")
        # one copy, as demod.py:353-358 re-interleaves in XLA
        x, form = interleave_ps(x), "i8"
    if fuse_k12:
        k12_fn = k12_ps if form == "i8ps" else k12
        st, fm_out_iq_p, theta = run(k12_fn.__name__, k12_fn, coeffs, cfg,
                                     st, x)
    else:
        # complex64 goes to K1 as it is: the kernel reads its float pairs in
        # place (the JAX package splits it into planes, demod.py:248-249:
        # the same samples)
        int8_taps = cfg.frontend_int8 and (
            form in ("words", "i8") or cfg.assume_integer_input)
        i16 = bool(cfg.interstage_i16)
        k1_i16 = i16 and pick_tiles(c, b, cfg.frontend_band_no) is not None
        if form == "i8" and int8_taps:
            st, fm_demod = run("frontend_i8", frontend_i8, coeffs, cfg, st, x,
                               k1_i16)
        else:
            st, fm_demod = run("frontend", frontend, coeffs, cfg, st, x,
                               int8_taps, k1_i16)
        fuse_mid = pick_tiles_mid(c, b // 4) is not None
        if fm_demod.dtype == torch.int16 and not fuse_mid:
            fm_demod = dq_i16(fm_demod, FM_SCALE)
        k2_i16 = i16 and fuse_mid and pick_tiles_ext(c, b // 8) is not None
        st, fm_out_iq_p, theta = run("midend", midend, coeffs, cfg, st,
                                     fm_demod, k2_i16)
    if chunk_gate(cfg, theta.shape[-1]):
        # the chunked PLL takes float32 theta (pll_pallas.py:204-211)
        st["pll"], dt = run("pll_chunked", pilot_pll_chunked, cfg, st["pll"],
                            dq_if_i16(theta, PH_SCALE))
    else:
        st["pll"], dt = run("pll", pilot_pll_theta, cfg, st["pll"], theta)

    # ---- extract (demod.py:514-540) ------------------------------------
    return run("extract", extract, coeffs, cfg, st, fm_out_iq_p, dt)


class BroadcastFMDemod:
    """Stateful host wrapper around the pure functions, with the surface of
    ``fm_radio_tpu.models.demod.BroadcastFMDemod`` (sample-rate getters,
    ``process``, ``reset``, ``update_controls``).  ``device`` places the
    coefficients, the state and every block."""

    def __init__(self, cfg: DemodConfig = DemodConfig(), channels: int = 1,
                 device="cuda"):
        self.cfg = cfg
        self.channels = channels
        self.device = torch.device(device)
        self.coeffs = make_coeffs(cfg, self.device)
        self.state = demod_init_state(cfg, channels, self.device)

    @property
    def fs_baseband(self):
        return self.cfg.rates.fs_baseband

    @property
    def fs_fm_in(self):
        return self.cfg.rates.fs_fm_in

    @property
    def fs_fm_out(self):
        return self.cfg.rates.fs_fm_out

    @property
    def fs_rds(self):
        return self.cfg.rates.fs_rds

    @property
    def fs_audio(self):
        return self.cfg.rates.fs_audio

    def update_controls(self, **changes) -> None:
        """Runtime-mutable controls (``broadcast_fm_demod.cpp:330-389``):
        re-design the coefficients on the host, keep the carried state."""
        allowed = {
            "audio_out",
            "audio_stereo_mix_factor",
            "use_deemphasis_filter",
            "deemphasis_cutoff_us",
            "audio_lpr_cutoff_hz",
            "audio_lmr_cutoff_hz",
        }
        bad = set(changes) - allowed
        if bad:
            raise ValueError(f"not runtime-mutable: {sorted(bad)}")
        self.cfg = dataclasses.replace(self.cfg, **changes)
        self.coeffs = make_coeffs(self.cfg, self.device)

    def process(self, x) -> dict:
        """x: any form of :func:`demod_block`, numpy or torch; one channel
        may drop its channel axis ([B] complex64 or words, [2, B] int8
        planes).  Returns the outs as numpy."""
        x = torch.as_tensor(x)
        if x.dtype in (torch.float64, torch.complex128):
            x = x.to(torch.complex64 if x.is_complex() else torch.float32)
        if x.ndim == 1:
            x = x[None, :]
        elif x.ndim == 2 and x.dtype == torch.int8:
            x = x[:, None, :]
        self.state, outs = demod_block(self.cfg, self.coeffs, self.state,
                                       x.to(self.device))
        return {k: v.cpu().numpy() for k, v in outs.items()}

    def reset(self):
        self.state = demod_init_state(self.cfg, self.channels, self.device)
