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
// What bounds it on this card: the loop is serial in time, with a long
// dependent chain per step (the dump's atan2_poly divides, and its result
// feeds the next step's PLL); N = B/64 steps (2,048 at the 2048 x 131,072
// bench cell) per channel, one thread per channel.  Measured: 0.595 ms of
// device time per block at the bench cell (torch.profiler; NVIDIA H100
// 80GB HBM3, power limit 700.00 W).  The suspect is latency that C threads
// cannot hide; not yet profiled further.
//
// What the design does about it, for now: one thread per channel, 32
// channels per block, each reading and writing its own channel-major row
// (uncoalesced), reading kBatch steps at a time into registers so one load
// latency covers kBatch steps (common.cuh).  Staging [64-step x 8-channel]
// tiles through shared memory with barriers was measured slower on the
// card (PERF.md).  Built with -fmad=false:
// a flipped zero crossing or TED decision changes `valid`, so every step
// rounds op by op like the plain PyTorch version (kernels/bpsk.py::
// bpsk_plain) and the JAX kernel.

#include "common.cuh"

namespace fmt {

struct BpskConsts {
  float ts, pll_ki_ts, pll_kp, pll_f_gain, pll_lpf_b0, pll_lpf_a1;
  float ted_ki_ts, ted_kp, ted_f_center, ted_f_gain, ted_lpf_b0, ted_lpf_a1;
  float int_dump_kts, zcd_cooldown;
};

__global__ void bpsk_kernel(const float* __restrict__ x_re,
                            const float* __restrict__ x_im,
                            const float* __restrict__ gain,
                            const float* __restrict__ st_in,
                            float* __restrict__ st_out,
                            float* __restrict__ pred,
                            float* __restrict__ sym_re,
                            float* __restrict__ valid, int channels, int n,
                            BpskConsts k) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= channels) return;
  float s[14];
  for (int r = 0; r < 14; ++r) s[r] = st_in[(int64_t)r * channels + c];
  float p_x1 = s[0], p_y1 = s[1], p_int = s[2], p_t = s[3], p_pe = s[4];
  float zq = s[5], cool = s[6];
  float t_x1 = s[7], t_y1 = s[8], t_int = s[9], t_pe = s[10], ramp = s[11];
  float id_re = s[12], id_im = s[13];
  const bool scale = gain != nullptr;
  const float g = scale ? gain[c] : 1.0f;
  const int64_t row = (int64_t)c * n;
  for (int i0 = 0; i0 < n; i0 += kBatch) {
    float br[kBatch], bi[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      br[u] = x_re[row + i0 + u];
      bi[u] = x_im[row + i0 + u];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      // carrier PLL PI + NCO
      const float p_lpf = k.pll_lpf_b0 * (p_pe + p_x1) - k.pll_lpf_a1 * p_y1;
      const float p_int2 = clip1(p_int + k.pll_ki_ts * p_pe);
      const float pi_pll = p_lpf * k.pll_kp + p_int2;
      const float control = clip1(pi_pll);
      const float t = wrap_cycles(p_t + k.ts * (control * k.pll_f_gain));
      const float cs = cheb_sine(wrap_cycles(t + 0.25f));
      const float sn = cheb_sine(t);
      const float xr = scale ? br[u] * g : br[u];
      const float xi = scale ? bi[u] * g : bi[u];
      const float iq_re = xr * cs - xi * sn;
      const float iq_im = xr * sn + xi * cs;

      // zero-crossing detector + cooldown
      const bool fire_zcd = ((iq_im * zq) < 0.0f) && (cool == 0.0f);
      const float cool2 =
          fire_zcd ? k.zcd_cooldown : fmaxf(cool - 1.0f, 0.0f);
      const float timing = 2.0f * ramp;
      const float timing_err = timing > 1.0f ? timing - 2.0f : timing;
      const float t_pe2 = fire_zcd ? timing_err : t_pe;

      // TED PI
      const float t_lpf = k.ted_lpf_b0 * (t_pe2 + t_x1) - k.ted_lpf_a1 * t_y1;
      const float t_int2 = clip1(t_int + k.ted_ki_ts * t_pe2);
      const float pi_ted = k.ted_kp * t_lpf + t_int2;

      // integrate & dump
      const float id_re2 = id_re + k.int_dump_kts * iq_re;
      const float id_im2 = id_im + k.int_dump_kts * iq_im;

      // TED ramp clock
      const float tctl = clip1(-pi_ted);
      const float tfreq = k.ted_f_center + tctl * k.ted_f_gain;
      const float v = ramp + k.ts * tfreq;
      const float offset = k.ts * tfreq * 0.5f;
      const bool fire_ted = v >= (1.0f - offset);
      const float ramp2 = fire_ted ? 0.0f : v;

      // dump
      const float sym_phase = atan2_poly(id_im2, id_re2);
      const float est_pe =
          sym_phase > 0.0f ? kHalfPi - sym_phase : -kHalfPi - sym_phase;
      const float norm_pe = est_pe / kHalfPi;
      const float p_pe2 = fire_ted ? norm_pe : p_pe;

      const float fire_f = fire_ted ? 1.0f : 0.0f;
      pred[row + i0 + u] = id_im2 * fire_f;
      sym_re[row + i0 + u] = id_re2 * fire_f;
      valid[row + i0 + u] = fire_f;

      p_x1 = p_pe;
      p_y1 = p_lpf;
      p_int = p_int2;
      p_t = t;
      p_pe = p_pe2;
      zq = iq_im;
      cool = cool2;
      t_x1 = t_pe2;
      t_y1 = t_lpf;
      t_int = t_int2;
      t_pe = t_pe2;
      ramp = ramp2;
      id_re = fire_ted ? 0.0f : id_re2;
      id_im = fire_ted ? 0.0f : id_im2;
    }
  }
  const float out[14] = {p_x1, p_y1, p_int, p_t,   p_pe, zq,    cool,
                         t_x1, t_y1, t_int, t_pe,  ramp, id_re, id_im};
  for (int r = 0; r < 14; ++r) st_out[(int64_t)r * channels + c] = out[r];
}

}  // namespace fmt

using namespace fmt;

// x_re, x_im [C, N]; gain [C], or null for no gain; st_in, st_out
// [14, C]; pred, sym_re, valid [C, N]; the 14 loop constants of models/bpsk.py::bpsk_consts_from_cfg.
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
  if (n % kBatch != 0) return (int)cudaErrorInvalidValue;
  const BpskConsts k{ts,         pll_ki_ts,  pll_kp,       pll_f_gain,
                     pll_lpf_b0, pll_lpf_a1, ted_ki_ts,    ted_kp,
                     ted_f_center, ted_f_gain, ted_lpf_b0, ted_lpf_a1,
                     int_dump_kts, zcd_cooldown};
  bpsk_kernel<<<blocks_for(channels, kSerialThreads), kSerialThreads, 0,
                stream>>>(x_re, x_im, gain, st_in, st_out, pred, sym_re,
                          valid, channels, n, k);
  FMT_CHECK_LAUNCH();
  return 0;
}
