// Pilot PLL: the serial 19 kHz loop of the demodulator on Hopper.
//
// Replaces fm_radio_tpu/kernels/pll_pallas.py::_pll_kernel as run by
// _pilot_pll_run (wrapper pilot_pll_pallas_theta): over the precomputed
// pilot phase theta [C, N] (cycles) it runs the 1-pole loop filter, the
// clipped PI controller and the NCO, pe = 2*pi*wrap(theta + t), and emits
// the NCO phase track dt [C, N] (pll_pallas.py:130-140, same carry
// rotation: (lpf_x1, lpf_y1, integ, nco_t, prev_pe) <- (prev_pe, lpf_pe,
// integ, t, pe)).
//
// What bounds it on this card: the loop is serial in time with a dependent
// chain per step (loop filter -> PI -> NCO -> phase error); N = B/8 steps
// (16,384 at the 2048 x 131,072 bench cell) per channel, one thread per
// channel.  Measured: 1.895 ms of device time per block at the bench cell
// (torch.profiler; NVIDIA H100 80GB HBM3, power limit 700.00 W).  The
// suspect is latency that C threads cannot hide; not yet profiled further.
//
// What the design does about it, for now: one thread per channel, 32
// channels per block, each reading its own channel-major row (uncoalesced:
// a warp's 32 loads of one step touch 32 rows) kBatch steps at a time into
// registers, so one load latency covers kBatch steps (common.cuh).
// Staging [64-step x 8-channel] tiles through shared memory with barriers
// was measured slower on the card (PERF.md).  Built with -fmad=false so
// every step rounds op by op like the plain PyTorch version
// (kernels/pll.py::pll_plain) and the JAX kernel.  The chunked
// block-parallel variant (more threads than channels) is later work.

#include "common.cuh"

namespace fmt {

__global__ void pll_kernel(const float* __restrict__ theta,
                           float* __restrict__ dt,
                           const float* __restrict__ st_in,
                           float* __restrict__ st_out, int channels, int n,
                           float ts, float f_center, float f_gain,
                           float ki_ts, float kp, float b0, float a1) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= channels) return;
  float lpf_x1 = st_in[c];
  float lpf_y1 = st_in[channels + c];
  float integ = st_in[2 * channels + c];
  float nco_t = st_in[3 * channels + c];
  float prev_pe = st_in[4 * channels + c];
  const float* th = theta + (int64_t)c * n;
  float* out = dt + (int64_t)c * n;
  for (int i0 = 0; i0 < n; i0 += kBatch) {
    float bt[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) bt[u] = th[i0 + u];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const float lpf_pe = b0 * (prev_pe + lpf_x1) - a1 * lpf_y1;
      integ = clip1(integ + ki_ts * prev_pe);
      const float pi_err = lpf_pe * kp + integ;
      const float control = clip1(pi_err);
      const float t = wrap_cycles(nco_t + ts * (f_center + control * f_gain));
      const float pe = kTwoPi * wrap_cycles(bt[u] + t);
      out[i0 + u] = t;
      lpf_x1 = prev_pe;
      lpf_y1 = lpf_pe;
      nco_t = t;
      prev_pe = pe;
    }
  }
  st_out[c] = lpf_x1;
  st_out[channels + c] = lpf_y1;
  st_out[2 * channels + c] = integ;
  st_out[3 * channels + c] = nco_t;
  st_out[4 * channels + c] = prev_pe;
}

}  // namespace fmt

using namespace fmt;

// theta, dt [C, N]; st_in, st_out [5, C] rows (lpf_x1, lpf_y1, integ,
// nco_t, prev_pe); loop constants from models/pilot_pll.py.
extern "C" int fmt_pll(const float* theta, float* dt, const float* st_in,
                       float* st_out, int channels, int n, float ts,
                       float f_center, float f_gain, float ki_ts, float kp,
                       float b0, float a1, cudaStream_t stream) {
  if (n % kBatch != 0) return (int)cudaErrorInvalidValue;
  pll_kernel<<<blocks_for(channels, kSerialThreads), kSerialThreads, 0,
               stream>>>(theta, dt, st_in, st_out, channels, n, ts, f_center,
                         f_gain, ki_ts, kp, b0, a1);
  FMT_CHECK_LAUNCH();
  return 0;
}
