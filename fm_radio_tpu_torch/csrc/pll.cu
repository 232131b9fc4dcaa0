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
// dependent chain per step (loop filter -> PI -> NCO -> phase error, ~17
// float32 operations, two of them rintf); the sequential kernel runs N =
// B/8 steps (16,384 at the 2048 x 131,072 bench cell) per channel, one
// thread per channel; the chunked one L + W steps (20,480 at C = 256, B =
// 1,048,576, G = 8) on G times the threads.  Both are bound by that chain's
// latency, far above their bytes (0.090 ms at the bench cell, PERF.md).
//
// What the sequential kernel's design does about it: nothing but the
// chain is left in its loop.  One thread per channel, kPllLanes channels a
// block (256 blocks at C = 2048, on every SM).  Each lane keeps three
// batches of kBatch theta steps in flight in four register buffers while
// it runs the present one (16-byte loads; int16 theta is dequantised only
// where a step uses it), and stores dt kBatch steps at a time (float4, or
// store_i16_batch), the pattern of k12_stages.cuh::k12_peak_rec_kernel.
// Measured at the bench cell (NVIDIA H100 80GB HBM3, 700.00 W): 1.959 ms
// (int16 1.530) before, with one 4-byte store a step and one exposed load
// a batch; ~1.00 ms for both forms after, ~61 ns a step: the dependent
// chain read from the SASS (17 instructions from one phase error to the
// next, two of them FRND) is what is left (PERF.md).
//
// The chunked kernel has the same design on its lanes: kPllLanes lanes a
// block (256 blocks at the chunked cell's 2,048 lanes, on every SM),
// three batches in flight, the kept dt stored kBatch steps at a time, the
// warm-up steps storing nothing.
// Its lanes read their windows straight from theta [C, N] and write only
// their kept outputs into dt [C, N]: no gathered copy of the windows, no
// transposes and no concatenation, which the TPU wrapper needs
// (pll_pallas.py:336-339, 407-415).  A window starts at max(gL - W, 0),
// which is 16-byte aligned only for some L, W and N, so each lane walks
// the flat array's own batch grid from the batch that holds its first step
// and masks the steps before it and past its end (chunk_batch).
// Built with -fmad=false so every step rounds op by op like the plain
// PyTorch versions (kernels/pll.py::pll_plain, pll_chunked_plain) and the
// JAX kernel.

#include "pll_step.cuh"

namespace fmt {

// channels (lanes) a block of the sequential (chunked) kernel: one warp of
// its own for each kPllLanes channels (256 warps at C = 2048), as
// k12_peak_rec_kernel measured best (k12_stages.cuh)
constexpr int kPllLanes = 8;

__device__ __forceinline__ PllState pll_load_at(const float* __restrict__ st,
                                                int channels, int c) {
  const int ns = 5 * channels;
  return {FMT_AT(st, c, ns), FMT_AT(st, channels + c, ns),
          FMT_AT(st, 2 * channels + c, ns), FMT_AT(st, 3 * channels + c, ns),
          FMT_AT(st, 4 * channels + c, ns)};
}

__device__ __forceinline__ void pll_store_at(const PllState& s,
                                             float* __restrict__ st,
                                             int channels, int c) {
  const int ns = 5 * channels;
  FMT_AT(st, c, ns) = s.lpf_x1;
  FMT_AT(st, channels + c, ns) = s.lpf_y1;
  FMT_AT(st, 2 * channels + c, ns) = s.integ;
  FMT_AT(st, 3 * channels + c, ns) = s.nco_t;
  FMT_AT(st, 4 * channels + c, ns) = s.prev_pe;
}

// kBatch steps over batch b, dt stored at dt + at
template <class T>
__device__ __forceinline__ void pll_batch(PllState& s, const PllConsts& k,
                                          const Batch<T>& b,
                                          T* __restrict__ dt, int64_t at,
                                          int64_t total) {
  float t[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u)
    t[u] = pll_step(s, k, batch_at(b, u, kPhScale));
  store_batch(dt, at, total, t, kPhScale);
}

// theta and dt are float32, or both the int16 inter-stage format at
// kPhScale (the TPU kernel's io_i16, pll_pallas.py:114-147): theta
// dequantised as a step uses it, dt quantised as it is stored; the loop
// and its state stay float32.  n % kBatch == 0; theta and dt 16-byte
// aligned.
template <class T>
__global__ void __launch_bounds__(kPllLanes)
pll_kernel(const T* __restrict__ theta, T* __restrict__ dt,
           const float* __restrict__ st_in, float* __restrict__ st_out,
           int channels, int n, PllConsts k) {
  const int c = blockIdx.x * kPllLanes + threadIdx.x;
  if (c >= channels) return;
  PllState s = pll_load_at(st_in, channels, c);
  const int64_t row = (int64_t)c * n, total = (int64_t)channels * n;
  const int nb = n / kBatch;
  // batch q's steps at row + q kBatch (a batch past the last reads the
  // last again: loaded, never run)
  auto at = [&](int q) { return row + (int64_t)min(q, nb - 1) * kBatch; };
  Batch<T> b0, b1, b2, b3;
  load_raw(theta, at(0), total, b0);
  load_raw(theta, at(1), total, b1);
  load_raw(theta, at(2), total, b2);
  for (int q = 0; q < nb; q += 4) {
    load_raw(theta, at(q + 3), total, b3);
    pll_batch(s, k, b0, dt, at(q), total);
    load_raw(theta, at(q + 4), total, b0);
    if (q + 1 < nb) pll_batch(s, k, b1, dt, at(q + 1), total);
    load_raw(theta, at(q + 5), total, b1);
    if (q + 2 < nb) pll_batch(s, k, b2, dt, at(q + 2), total);
    load_raw(theta, at(q + 6), total, b2);
    if (q + 3 < nb) pll_batch(s, k, b3, dt, at(q + 3), total);
  }
  pll_store_at(s, st_out, channels, c);
}

// theta[at .. at + kBatch) into b, by 16-byte loads where the batch lies
// inside the array, else element by element with the steps past its end
// read as 0 (the chunked lanes' batch grid is aligned on the flat array,
// whose length need not be a multiple of kBatch)
__device__ __forceinline__ void load_clamped(const float* __restrict__ p,
                                             int64_t at, int64_t total,
                                             Batch<float>& b) {
  if (at + kBatch <= total) {
    load_raw(p, at, total, b);
  } else {
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      b.v[u] = at + u < total ? FMT_AT(p, at + u, total) : 0.0f;
  }
}

// One batch of a chunked lane on the flat grid: the steps e = at + u with
// a0 <= e < a1 run (all kBatch of them but in the lane's first and last
// batch), and those with e >= k0 are stored into dt: a whole batch by
// 16-byte stores, a partial one (which it shares with the neighbouring
// lane) element by element.
__device__ __forceinline__ void chunk_batch(PllState& s, const PllConsts& k,
                                            const Batch<float>& b,
                                            float* __restrict__ dt,
                                            int64_t at, int64_t total,
                                            int64_t a0, int64_t k0,
                                            int64_t a1) {
  float t[kBatch];
  if (at >= a0 && at + kBatch <= a1) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) t[u] = pll_step(s, k, b.v[u]);
  } else {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      t[u] = 0.0f;
      if (at + u >= a0 && at + u < a1) t[u] = pll_step(s, k, b.v[u]);
    }
  }
  if (at >= k0 && at + kBatch <= a1) {
    store_batch(dt, at, total, t, 1.0f);
  } else if (at + kBatch > k0) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (at + u >= k0 && at + u < a1) FMT_AT(dt, at + u, total) = t[u];
  }
}

// Lanes are chunk-major, as the TPU kernel's: lane = g * C + c, kPllLanes
// a block.  Lane (g, c) runs the steps [a0, a1) of the flat array theta
// [C * N] (a0 = c N + max(g L - W, 0), a1 = c N + g L + L) and keeps those
// from k0 = c N + g L.  Its batches lie on the array's kBatch grid, from
// the one that holds a0 to the one that holds a1 - 1, so every load and
// every whole store is 16-byte aligned whatever L, W and N; the first and
// last are masked (chunk_batch).  Three batches are in flight in four
// register buffers, as in pll_kernel; the look-ahead past the last batch
// loads the last again (never run).  seed_k = float32(ts * f_center), the
// product formed in double.  theta and dt 16-byte aligned.
__global__ void __launch_bounds__(kPllLanes)
pll_chunked_kernel(const float* __restrict__ theta, float* __restrict__ dt,
                   const float* __restrict__ st_in,
                   float* __restrict__ st_out, int channels, int n,
                   int chunks, int warmup, float seed_k, PllConsts k) {
  const int lane = blockIdx.x * kPllLanes + threadIdx.x;
  if (lane >= channels * chunks) return;
  const int g = lane / channels;
  const int c = lane % channels;
  const int l = n / chunks;
  const int64_t total = (int64_t)channels * n;
  const int64_t row = (int64_t)c * n;
  const int64_t a0 = row + max(g * l - warmup, 0);  // first step
  const int64_t k0 = row + (int64_t)g * l;          // first kept step
  const int64_t a1 = k0 + l;                        // past the last
  const int64_t q0 = a0 / kBatch;
  const int nb = (int)((a1 + kBatch - 1) / kBatch - q0);
  PllState s = pll_load_at(st_in, channels, c);
  // every lane's NCO phase is wrapped, chunk 0's carried one included
  // (pll_pallas.py:353-362); chunks g >= 1 take theirs from the signal
  const float seed = g == 0 ? s.nco_t : -FMT_AT(theta, a0, total) - seed_k;
  s.nco_t = wrap_cycles(seed);
  // batch q's steps at (q0 + q) kBatch, the look-ahead clamped
  auto at = [&](int q) { return (q0 + min(q, nb - 1)) * kBatch; };
  Batch<float> b0, b1, b2, b3;
  load_clamped(theta, at(0), total, b0);
  load_clamped(theta, at(1), total, b1);
  load_clamped(theta, at(2), total, b2);
  for (int q = 0; q < nb; q += 4) {
    load_clamped(theta, at(q + 3), total, b3);
    chunk_batch(s, k, b0, dt, at(q), total, a0, k0, a1);
    load_clamped(theta, at(q + 4), total, b0);
    if (q + 1 < nb) chunk_batch(s, k, b1, dt, at(q + 1), total, a0, k0, a1);
    load_clamped(theta, at(q + 5), total, b1);
    if (q + 2 < nb) chunk_batch(s, k, b2, dt, at(q + 2), total, a0, k0, a1);
    load_clamped(theta, at(q + 6), total, b2);
    if (q + 3 < nb) chunk_batch(s, k, b3, dt, at(q + 3), total, a0, k0, a1);
  }
  if (g == chunks - 1) pll_store_at(s, st_out, channels, c);
}

}  // namespace fmt

using namespace fmt;

// theta, dt [C, N], float32 or, with io_i16, both int16 (PH_SCALE), N %
// kBatch == 0, both 16-byte aligned (kernels/pll.py::pilot_pll_seq); st_in,
// st_out [5, C] rows (lpf_x1, lpf_y1, integ, nco_t, prev_pe); loop
// constants from models/pilot_pll.py.
extern "C" int fmt_pll(const void* theta, void* dt, const float* st_in,
                       float* st_out, int channels, int n, float ts,
                       float f_center, float f_gain, float ki_ts, float kp,
                       float b0, float a1, int io_i16, cudaStream_t stream) {
  if (n % kBatch != 0 || ((uintptr_t)theta | (uintptr_t)dt) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const PllConsts k{ts, f_center, f_gain, ki_ts, kp, b0, a1};
  const unsigned grid = blocks_for(channels, kPllLanes);
  if (io_i16) {
    pll_kernel<int16_t><<<grid, kPllLanes, 0, stream>>>(
        (const int16_t*)theta, (int16_t*)dt, st_in, st_out, channels, n, k);
  } else {
    pll_kernel<float><<<grid, kPllLanes, 0, stream>>>(
        (const float*)theta, (float*)dt, st_in, st_out, channels, n, k);
  }
  FMT_CHECK_LAUNCH();
  return 0;
}

// The chunked form: as fmt_pll, float32 only, with chunks = G > 1 dividing
// N, warmup W with 0 <= W < N / G (the gate of pll_pallas.py:204; any N,
// L = N / G and W it admits), and seed_k = float32(ts * f_center).
extern "C" int fmt_pll_chunked(const float* theta, float* dt,
                               const float* st_in, float* st_out,
                               int channels, int n, int chunks, int warmup,
                               float seed_k, float ts, float f_center,
                               float f_gain, float ki_ts, float kp, float b0,
                               float a1, cudaStream_t stream) {
  if (chunks < 2 || n % chunks != 0 || warmup < 0 || n / chunks <= warmup ||
      ((uintptr_t)theta | (uintptr_t)dt) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const PllConsts k{ts, f_center, f_gain, ki_ts, kp, b0, a1};
  pll_chunked_kernel<<<blocks_for((int64_t)channels * chunks, kPllLanes),
                       kPllLanes, 0, stream>>>(
      theta, dt, st_in, st_out, channels, n, chunks, warmup, seed_k, k);
  FMT_CHECK_LAUNCH();
  return 0;
}
