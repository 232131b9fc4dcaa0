// BPSK: the serial RDS symbol synchroniser of the demodulator on Hopper.
//
// Replaces fm_radio_tpu/kernels/bpsk_pallas.py::_bpsk_kernel as run by
// bpsk_sync_pallas, with or without gain=: with it (the fused RDS AGC of
// the split path) each sample of the RDS baseband [C, N] is scaled by the
// channel's AGC gain at ingest (bpsk_pallas.py:85-87); without it (the
// megakernel's route, whose RDS AGC runs before) the samples enter as
// they are, with no multiply.  Then one step of the loop of
// bpsk_pallas.py:98-160 runs: carrier PLL (PI + NCO, Chebyshev phasor),
// zero-crossing detector with cooldown, TED ramp clock, integrate-and-dump
// and the symbol-phase error fed back to the carrier PLL.  Per sample it
// emits pred = Im(dump), sym_re = Re(dump) and valid (1.0 where the TED
// clock fired).  The 14-row state is in _pack_state order
// (bpsk_pallas.py:25-42); cooldown is a float inside the loop.
//
// What bounds it on this card: the loop is serial in time, N = B/64 steps
// (2,048 at the 2048 x 131,072 bench cell) per channel, one thread per
// channel, and each step is a dependent chain: the carrier PLL's PI and
// NCO, the Chebyshev phasor, the mix, the zero-crossing decision, the TED's
// PI and the ramp clock's decision, whose phase error the next step's PLL
// reads.  Its bytes take 0.029 ms at the cell (PERF.md).
//
// What the design does about it: nothing but that chain is left in the
// loop.
// - The dump's phase error (atan2_poly, an IEEE division, then a second
//   division by pi/2) is used only where the TED clock fires, about once
//   in 8 steps (16 kHz over the 2 kHz symbol rate), so it runs under a
//   branch on the warp's vote: a warp in which no lane fires skips both
//   divisions.  That is exact: p_pe2 is the value's only consumer.  A warp
//   of L channels skips a step with probability about (7/8)^L: 1.4% at L =
//   32, 59% at 4, 88% at 1; kBpskLanes channels a block of one warp, the
//   fastest of L = 32, 8, 4 and 1 measured at the cells (PERF.md has the
//   table, and the loop's time without the branch).
// - Each lane keeps the next kBatch steps of x_re and x_im in flight in
//   registers while it runs the present ones (16-byte loads,
//   common.cuh::Batch; a batch of 16 steps outlasts a load's latency), and
//   stores pred, sym_re and valid four steps at a time in 16-byte stores.
// Built with -fmad=false: a flipped zero crossing or TED decision changes
// `valid`, so every step rounds op by op like the plain PyTorch version
// (kernels/bpsk.py::bpsk_plain) and the JAX kernel.

#include "common.cuh"

namespace fmt {

// channels a block (one warp); PERF.md has the measurement that chose it
constexpr int kBpskLanes = 4;

struct BpskConsts {
  float ts, pll_ki_ts, pll_kp, pll_f_gain, pll_lpf_b0, pll_lpf_a1;
  float ted_ki_ts, ted_kp, ted_f_center, ted_f_gain, ted_lpf_b0, ted_lpf_a1;
  float int_dump_kts, zcd_cooldown;
};

// the loop's carried values, in _pack_state order
struct BpskState {
  float p_x1, p_y1, p_int, p_t, p_pe, zq, cool;
  float t_x1, t_y1, t_int, t_pe, ramp, id_re, id_im;
};

// One step on the (gain-scaled) sample (xr, xi); returns 1.0 where the TED
// clock fired, else 0.0, with the dump's Im and Re there (0.0 elsewhere).
// `mask` names the warp's lanes, which all run the step together.
__device__ __forceinline__ float bpsk_step(BpskState& s, const BpskConsts& k,
                                           float xr, float xi, unsigned mask,
                                           float& pred, float& sym_re) {
  // carrier PLL PI + NCO
  const float p_lpf = k.pll_lpf_b0 * (s.p_pe + s.p_x1) - k.pll_lpf_a1 * s.p_y1;
  const float p_int2 = clip1(s.p_int + k.pll_ki_ts * s.p_pe);
  const float pi_pll = p_lpf * k.pll_kp + p_int2;
  const float control = clip1(pi_pll);
  const float t = wrap_cycles(s.p_t + k.ts * (control * k.pll_f_gain));
  const float cs = cheb_sine(wrap_cycles(t + 0.25f));
  const float sn = cheb_sine(t);
  const float iq_re = xr * cs - xi * sn;
  const float iq_im = xr * sn + xi * cs;

  // zero-crossing detector + cooldown
  const bool fire_zcd = ((iq_im * s.zq) < 0.0f) && (s.cool == 0.0f);
  const float cool2 = fire_zcd ? k.zcd_cooldown : fmaxf(s.cool - 1.0f, 0.0f);
  const float timing = 2.0f * s.ramp;
  const float timing_err = timing > 1.0f ? timing - 2.0f : timing;
  const float t_pe2 = fire_zcd ? timing_err : s.t_pe;

  // TED PI
  const float t_lpf = k.ted_lpf_b0 * (t_pe2 + s.t_x1) - k.ted_lpf_a1 * s.t_y1;
  const float t_int2 = clip1(s.t_int + k.ted_ki_ts * t_pe2);
  const float pi_ted = k.ted_kp * t_lpf + t_int2;

  // integrate & dump
  const float id_re2 = s.id_re + k.int_dump_kts * iq_re;
  const float id_im2 = s.id_im + k.int_dump_kts * iq_im;

  // TED ramp clock
  const float tctl = clip1(-pi_ted);
  const float tfreq = k.ted_f_center + tctl * k.ted_f_gain;
  const float v = s.ramp + k.ts * tfreq;
  const float offset = k.ts * tfreq * 0.5f;
  const bool fire_ted = v >= (1.0f - offset);

  // dump: the phase error only where some lane of the warp fires
  float p_pe2 = s.p_pe;
  if (__any_sync(mask, fire_ted)) {
    const float sym_phase = atan2_poly(id_im2, id_re2);
    const float est_pe =
        sym_phase > 0.0f ? kHalfPi - sym_phase : -kHalfPi - sym_phase;
    const float norm_pe = est_pe / kHalfPi;
    p_pe2 = fire_ted ? norm_pe : s.p_pe;
  }

  const float fire_f = fire_ted ? 1.0f : 0.0f;
  pred = id_im2 * fire_f;
  sym_re = id_re2 * fire_f;

  s.p_x1 = s.p_pe;
  s.p_y1 = p_lpf;
  s.p_int = p_int2;
  s.p_t = t;
  s.p_pe = p_pe2;
  s.zq = iq_im;
  s.cool = cool2;
  s.t_x1 = t_pe2;
  s.t_y1 = t_lpf;
  s.t_int = t_int2;
  s.t_pe = t_pe2;
  s.ramp = fire_ted ? 0.0f : v;
  s.id_re = fire_ted ? 0.0f : id_re2;
  s.id_im = fire_ted ? 0.0f : id_im2;
  return fire_f;
}

// kBatch steps over the loaded batch (br, bi); the outputs stored at
// row offset `at` four steps a 16-byte store, where `live`
__device__ __forceinline__ void bpsk_batch(
    BpskState& s, const BpskConsts& k, const Batch<float>& br,
    const Batch<float>& bi, bool scale, float g, unsigned mask, bool live,
    float* __restrict__ pred, float* __restrict__ sym_re,
    float* __restrict__ valid, int64_t at, int64_t total) {
#pragma unroll
  for (int u0 = 0; u0 < kBatch; u0 += 4) {
    float p4[4], s4[4], v4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float xr = batch_at(br, u0 + e, 1.0f);
      const float xi = batch_at(bi, u0 + e, 1.0f);
      v4[e] = bpsk_step(s, k, scale ? xr * g : xr,
                           scale ? xi * g : xi, mask, p4[e], s4[e]);
    }
    if (live) {
      *reinterpret_cast<float4*>(FMT_SPAN(pred, at + u0, 4, total)) =
          make_float4(p4[0], p4[1], p4[2], p4[3]);
      *reinterpret_cast<float4*>(FMT_SPAN(sym_re, at + u0, 4, total)) =
          make_float4(s4[0], s4[1], s4[2], s4[3]);
      *reinterpret_cast<float4*>(FMT_SPAN(valid, at + u0, 4, total)) =
          make_float4(v4[0], v4[1], v4[2], v4[3]);
    }
  }
}

// One warp of kBpskLanes channels a block.  A lane past the last channel
// runs the last channel's loop too (so that every lane of the warp votes)
// and stores nothing.  n % kBatch == 0; every row 16-byte aligned.
__global__ void __launch_bounds__(kBpskLanes, 16 / kBpskLanes)
bpsk_kernel(const float* __restrict__ x_re, const float* __restrict__ x_im,
            const float* __restrict__ gain, const float* __restrict__ st_in,
            float* __restrict__ st_out, float* __restrict__ pred,
            float* __restrict__ sym_re, float* __restrict__ valid,
            int channels, int n, BpskConsts k) {
  constexpr unsigned kMask = (1u << kBpskLanes) - 1;
  const int c_lane = blockIdx.x * kBpskLanes + threadIdx.x;
  const bool live = c_lane < channels;
  const int c = live ? c_lane : channels - 1;
  const int ns = 14 * channels;
  float st[14];
#pragma unroll
  for (int r = 0; r < 14; ++r) st[r] = FMT_AT(st_in, r * channels + c, ns);
  BpskState s{st[0], st[1], st[2],  st[3],  st[4],  st[5],  st[6],
              st[7], st[8], st[9], st[10], st[11], st[12], st[13]};
  const bool scale = gain != nullptr;
  const float g = scale ? FMT_AT(gain, c, channels) : 1.0f;
  const int64_t row = (int64_t)c * n, total = (int64_t)channels * n;
  const int nb = n / kBatch;
  // batch q's steps at row + q kBatch (a batch past the last reads the
  // last again: loaded, never run)
  auto at = [&](int q) { return row + (int64_t)min(q, nb - 1) * kBatch; };
  Batch<float> r0, i0, r1, i1;
  load_raw(x_re, at(0), total, r0);
  load_raw(x_im, at(0), total, i0);
  for (int q = 0; q < nb; q += 2) {
    load_raw(x_re, at(q + 1), total, r1);
    load_raw(x_im, at(q + 1), total, i1);
    bpsk_batch(s, k, r0, i0, scale, g, kMask, live, pred, sym_re, valid,
               at(q), total);
    if (q + 1 < nb) {
      load_raw(x_re, at(q + 2), total, r0);
      load_raw(x_im, at(q + 2), total, i0);
      bpsk_batch(s, k, r1, i1, scale, g, kMask, live, pred, sym_re, valid,
                 at(q + 1), total);
    }
  }
  if (live) {
    const float out[14] = {s.p_x1, s.p_y1, s.p_int, s.p_t,  s.p_pe,
                           s.zq,   s.cool, s.t_x1,  s.t_y1, s.t_int,
                           s.t_pe, s.ramp, s.id_re, s.id_im};
#pragma unroll
    for (int r = 0; r < 14; ++r) FMT_AT(st_out, r * channels + c, ns) = out[r];
  }
}

}  // namespace fmt

using namespace fmt;

// x_re, x_im [C, N], N % 16 == 0, 16-byte aligned; gain [C], or null for
// no gain; st_in, st_out [14, C]; pred, sym_re, valid [C, N], 16-byte
// aligned; the 14 loop constants of models/bpsk.py::bpsk_consts_from_cfg.
extern "C" int fmt_bpsk(const float* x_re, const float* x_im,
                        const float* gain, const float* st_in, float* st_out,
                        float* pred, float* sym_re, float* valid,
                        int channels, int n, float ts, float pll_ki_ts,
                        float pll_kp, float pll_f_gain, float pll_lpf_b0,
                        float pll_lpf_a1, float ted_ki_ts, float ted_kp,
                        float ted_f_center, float ted_f_gain,
                        float ted_lpf_b0, float ted_lpf_a1,
                        float int_dump_kts, float zcd_cooldown,
                        cudaStream_t stream) {
  const uintptr_t ptrs = (uintptr_t)x_re | (uintptr_t)x_im |
                         (uintptr_t)pred | (uintptr_t)sym_re |
                         (uintptr_t)valid;
  if (channels <= 0 || n <= 0 || n % kBatch || ptrs % 16)
    return (int)cudaErrorInvalidValue;
  const BpskConsts k{ts,         pll_ki_ts,  pll_kp,       pll_f_gain,
                     pll_lpf_b0, pll_lpf_a1, ted_ki_ts,    ted_kp,
                     ted_f_center, ted_f_gain, ted_lpf_b0, ted_lpf_a1,
                     int_dump_kts, zcd_cooldown};
  bpsk_kernel<<<blocks_for(channels, kBpskLanes), kBpskLanes, 0, stream>>>(
      x_re, x_im, gain, st_in, st_out, pred, sym_re, valid, channels, n, k);
  FMT_CHECK_LAUNCH();
  return 0;
}
