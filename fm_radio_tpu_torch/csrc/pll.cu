// Pilot PLL: the serial 19 kHz loop of the demodulator on Hopper, and its
// chunked, block-parallel form.
//
// pll_kernel replaces fm_radio_tpu/kernels/pll_pallas.py::_pll_kernel as
// run by _pilot_pll_run (wrapper pilot_pll_pallas_theta): over the
// precomputed pilot phase theta [C, N] (cycles) it runs the 1-pole loop
// filter, the clipped PI controller and the NCO, pe = 2*pi*wrap(theta + t),
// and emits the NCO phase track dt [C, N] (pll_pallas.py:130-140, same
// carry rotation: (lpf_x1, lpf_y1, integ, nco_t, prev_pe) <- (prev_pe,
// lpf_pe, integ, t, pe)).  The step is pll_step.cuh, which the chunked
// kernel below and the megakernel (chain.cu) run too.
//
// pll_chunked_kernel replaces the same _pll_kernel as run by
// _pilot_pll_chunked (pll_pallas.py:297-423, pll_time_chunks = G > 1): the
// block's N steps are cut into G chunks of L = N/G that run at once, one
// lane per (chunk, channel).  Lane (g, c) starts W = pll_chunk_warmup steps
// early, at s_g = max(gL - W, 0), runs over theta[c, s_g : gL + L] and
// keeps its last L outputs as dt[c, gL : gL + L]; chunk 0 starts from the
// carried state, chunks g >= 1 from it with the NCO phase seeded from the
// signal, wrap(-theta[c, s_g] - ts * f_center); the carried-out state is
// the last chunk's.  Chunk 0 keeps all of its first L steps and stops
// there: the TPU kernel runs it L + W steps and drops the last W, so its
// kept outputs are the same.
//
// What bounds them on this card: the loop is serial in time with a
// dependent chain per step (loop filter -> PI -> NCO -> phase error); the
// sequential kernel runs N = B/8 steps (16,384 at the 2048 x 131,072 bench
// cell) per channel, one thread per channel; the chunked one L + W steps
// (20,480 at C = 256, B = 1,048,576, G = 8) on G times the threads.  The
// suspect is latency that the threads cannot hide; times are in PERF.md.
//
// What the design does about it, for now: one thread per lane, 32 lanes
// per block, each reading its own channel-major row (uncoalesced: a warp's
// 32 loads of one step touch 32 rows) kBatch steps at a time into
// registers, so one load latency covers kBatch steps (common.cuh).  The
// chunked lanes read their windows straight from theta [C, N] and write
// only their kept outputs into dt [C, N]: no gathered copy of the windows,
// no transposes and no concatenation, which the TPU wrapper needs
// (pll_pallas.py:336-339, 407-415).  Staging [64-step x 8-channel] tiles
// through shared memory with barriers was measured slower on the card
// (PERF.md).  Built with -fmad=false so every step rounds op by op like
// the plain PyTorch versions (kernels/pll.py::pll_plain,
// pll_chunked_plain) and the JAX kernel.

#include "pll_step.cuh"

namespace fmt {

// theta and dt are float32, or both the int16 inter-stage format at
// kPhScale (the TPU kernel's io_i16, pll_pallas.py:114-147): theta
// dequantised as it is loaded, dt quantised as it is stored (kBatch steps
// at a time, store_i16_batch); the loop and its state stay float32.
template <class T>
__global__ void pll_kernel(const T* __restrict__ theta, T* __restrict__ dt,
                           const float* __restrict__ st_in,
                           float* __restrict__ st_out, int channels, int n,
                           PllConsts k) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= channels) return;
  PllState s = pll_load(st_in, channels, c);
  const T* th = theta + (int64_t)c * n;
  T* out = dt + (int64_t)c * n;
  for (int i0 = 0; i0 < n; i0 += kBatch) {
    float bt[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) bt[u] = load_f32(th, i0 + u, kPhScale);
    if constexpr (sizeof(T) == sizeof(float)) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) out[i0 + u] = pll_step(s, k, bt[u]);
    } else {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) bt[u] = pll_step(s, k, bt[u]);
      store_i16_batch(out, i0, bt, kPhScale);
    }
  }
  pll_store(s, st_out, channels, c);
}

// Lanes are chunk-major, as the TPU kernel's: lane = g * C + c.
// seed_k = float32(ts * f_center), the product formed in double.
__global__ void pll_chunked_kernel(const float* __restrict__ theta,
                                   float* __restrict__ dt,
                                   const float* __restrict__ st_in,
                                   float* __restrict__ st_out, int channels,
                                   int n, int chunks, int warmup,
                                   float seed_k, PllConsts k) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= channels * chunks) return;
  const int g = lane / channels;
  const int c = lane % channels;
  const int l = n / chunks;
  const int start = max(g * l - warmup, 0);
  const int keep = g * l - start;  // first kept step of the window
  const int steps = keep + l;
  const float* th = theta + (int64_t)c * n + start;
  float* out = dt + (int64_t)c * n + (int64_t)g * l - keep;
  PllState s = pll_load(st_in, channels, c);
  // every lane's NCO phase is wrapped, chunk 0's carried one included
  // (pll_pallas.py:353-362); chunks g >= 1 take theirs from the signal
  const float seed = g == 0 ? s.nco_t : -th[0] - seed_k;
  s.nco_t = wrap_cycles(seed);
  for (int i0 = 0; i0 < steps; i0 += kBatch) {
    float bt[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      bt[u] = i0 + u < steps ? th[i0 + u] : 0.0f;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u;
      if (i < steps) {
        const float t = pll_step(s, k, bt[u]);
        if (i >= keep) out[i] = t;
      }
    }
  }
  if (g == chunks - 1) pll_store(s, st_out, channels, c);
}

}  // namespace fmt

using namespace fmt;

// theta, dt [C, N], float32 or, with io_i16, both int16 (PH_SCALE); st_in,
// st_out [5, C] rows (lpf_x1, lpf_y1, integ, nco_t, prev_pe); loop
// constants from models/pilot_pll.py.
extern "C" int fmt_pll(const void* theta, void* dt, const float* st_in,
                       float* st_out, int channels, int n, float ts,
                       float f_center, float f_gain, float ki_ts, float kp,
                       float b0, float a1, int io_i16, cudaStream_t stream) {
  if (n % kBatch != 0) return (int)cudaErrorInvalidValue;
  const PllConsts k{ts, f_center, f_gain, ki_ts, kp, b0, a1};
  const unsigned grid = blocks_for(channels, kSerialThreads);
  if (io_i16) {
    pll_kernel<int16_t><<<grid, kSerialThreads, 0, stream>>>(
        (const int16_t*)theta, (int16_t*)dt, st_in, st_out, channels, n, k);
  } else {
    pll_kernel<float><<<grid, kSerialThreads, 0, stream>>>(
        (const float*)theta, (float*)dt, st_in, st_out, channels, n, k);
  }
  FMT_CHECK_LAUNCH();
  return 0;
}

// The chunked form: as fmt_pll, with chunks = G > 1 dividing N, warmup W
// with 0 <= W < N / G (the gate of pll_pallas.py:204), and seed_k =
// float32(ts * f_center).
extern "C" int fmt_pll_chunked(const float* theta, float* dt,
                               const float* st_in, float* st_out,
                               int channels, int n, int chunks, int warmup,
                               float seed_k, float ts, float f_center,
                               float f_gain, float ki_ts, float kp, float b0,
                               float a1, cudaStream_t stream) {
  if (chunks < 2 || n % chunks != 0 || warmup < 0 || n / chunks <= warmup)
    return (int)cudaErrorInvalidValue;
  const PllConsts k{ts, f_center, f_gain, ki_ts, kp, b0, a1};
  pll_chunked_kernel<<<blocks_for((int64_t)channels * chunks, kSerialThreads),
                       kSerialThreads, 0, stream>>>(
      theta, dt, st_in, st_out, channels, n, chunks, warmup, seed_k, k);
  FMT_CHECK_LAUNCH();
  return 0;
}
