// Device math and building blocks shared by the receiver's CUDA kernels.
//
// The formulas are those of fm_radio_tpu_torch/ops/cmath.py (and of the JAX
// package's ops/cmath.py and kernels/pll_pallas.py::_atan2), evaluated in
// float32.  Constants are hex literals of the exact float32 values that the
// Python side uses, so no decimal-to-binary rounding can differ.
//
// Each .cu file of csrc/ is built into its own shared library
// (kernels/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -std=c++17 -fmad=false, without --use_fast_math (atan2_poly divides and
// rintf must round half to even).  -fmad=false keeps every a*b+c as two
// rounded operations, the order the plain PyTorch versions evaluate.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// FMT_AT(p, i, n): element i of p as an lvalue, for an array of n
// elements; FMT_SPAN(p, i, len, n): the pointer p + i to the len elements
// i .. i + len - 1 (a vector load or store, a bulk copy), checked as FMT_AT
// checks its first and last.  The default build indexes plainly, p[i], so
// its code is the same as without the macro; a build with -DFMT_CHECKED
// (kernels/_build.py::build(checked=True)) checks 0 <= i < n first and,
// where that fails, prints the function, file, line, index, bound, block
// and thread, and traps.  K12's device code (k12.cu, k12_stages.cuh and
// fir_decimate_kernel below) reads and writes through it, so the split
// K1/K2 and the megakernel that share that code are checked too, and so do
// the sequential PLL (pll.cu::pll_kernel), the extract kernels on both
// routes' global memory (extract.cu), BPSK (bpsk.cu) and the matrix
// channelizer (channelizer_wgmma.cu, with the carried-state kernel of
// chan_common.cuh).  In the
// checked build every C entry also synchronises after each launch
// (FMT_CHECK_LAUNCH), so a trap is reported by the entry whose kernel
// raised it.
#ifdef FMT_CHECKED
#include <cstdio>

namespace fmt {
template <class T>
__device__ __forceinline__ T& checked_at(T* p, int64_t i, int64_t n,
                                         const char* fn, const char* file,
                                         int line) {
  if (i < 0 || i >= n) {
    printf("FMT_CHECKED: %s (%s:%d): index %lld outside [0, %lld), block "
           "(%d, %d), thread %d\n",
           fn, file, line, (long long)i, (long long)n, (int)blockIdx.x,
           (int)blockIdx.y, (int)threadIdx.x);
    __trap();
  }
  return p[i];
}
}  // namespace fmt

#define FMT_AT(p, i, n)                                                   \
  (::fmt::checked_at((p), (int64_t)(i), (int64_t)(n), __func__, __FILE__, \
                     __LINE__))
#define FMT_SPAN(p, i, len, n) \
  (FMT_AT(p, i, n), FMT_AT(p, (i) + (len) - 1, n), (p) + (i))
#define FMT_CHECK_LAUNCH()                                    \
  do {                                                        \
    cudaError_t e_ = cudaGetLastError();                      \
    if (e_ == cudaSuccess) e_ = cudaDeviceSynchronize();      \
    if (e_ != cudaSuccess) return (int)e_;                    \
  } while (0)
#else
#define FMT_AT(p, i, n) ((p)[(i)])
#define FMT_SPAN(p, i, len, n) ((p) + (i))
#define FMT_CHECK_LAUNCH()                 \
  do {                                     \
    cudaError_t e_ = cudaGetLastError();   \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)
#endif

namespace fmt {

constexpr float kPi = 0x1.921fb6p+1f;
constexpr float kHalfPi = 0x1.921fb6p+0f;
constexpr float kTwoPi = 0x1.921fb6p+2f;
constexpr float kInvTwoPi = 0x1.45f306p-3f;

constexpr int kThreads = 256;

// Serial kernels run one thread per channel (or per chunk and channel:
// the chunked PLL), a few a block (the PLLs and the peak IIR's recurrence
// 8, BPSK 4; the de-emphasis a warp of 32).  Each loads the next
// kBatch steps of its row into registers ahead: the loads do not depend on
// the recurrence, so their latency is paid once per batch instead of once
// per step.  Their step counts must be multiples of kBatch (the C entries
// check), but the chunked PLL's, which masks its lanes' first and last
// batch.
constexpr int kSerialThreads = 32;
constexpr int kBatch = 16;

inline unsigned int blocks_for(int64_t n, int threads = kThreads) {
  return (unsigned int)((n + threads - 1) / threads);
}

// t - round(t), round half to even (rintf, not roundf)
__device__ __forceinline__ float wrap_cycles(float t) { return t - rintf(t); }

__device__ __forceinline__ float clip1(float x) {
  return fminf(fmaxf(x, -1.0f), 1.0f);
}

// sin(2*pi*x) on [-0.5, 0.5]: the reference's 6-coefficient Chebyshev
// polynomial (chebyshev_sine.h:13-46), Horner from the highest term
__device__ __forceinline__ float cheb_sine(float x) {
  const float z = x * x;
  float b = 0x1.9a1b62p+1f;
  b = b * z + -0x1.c249bep+3f;
  b = b * z + 0x1.340056p+5f;
  b = b * z + -0x1.0c4eb8p+6f;
  b = b * z + 0x1.0357e4p+6f;
  b = b * z + -0x1.921fb6p+4f;
  return b * (z - 0.25f) * x;
}

// four-quadrant arctangent: range reduction + degree-8 polynomial in r^2
// (kernels/pll_pallas.py:38-65); atan2(0, -1) = +pi, atan2(0, 0) = 0
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float mx = fmaxf(ax, ay), mn = fminf(ax, ay);
  const float r = mn / fmaxf(mx, 0x1.1039d4p-123f);
  const float s = r * r;
  float p = 0x1.85aa96p-9f;
  p = p * s + -0x1.0f40b0p-6f;
  p = p * s + 0x1.642a6ap-5f;
  p = p * s + -0x1.361684p-4f;
  p = p * s + 0x1.b520a0p-4f;
  p = p * s + -0x1.230e36p-3f;
  p = p * s + 0x1.99786cp-3f;
  p = p * s + -0x1.5554ccp-2f;
  p = p * s + 0x1.000000p+0f;
  float a = p * r;
  a = (ay > ax) ? kHalfPi - a : a;
  a = (x < 0.0f) ? kPi - a : a;
  return (y < 0.0f) ? -a : a;
}

// The int16 inter-stage format (kernels/qformat.py; the JAX package's
// kernels/qformat.py): fm_demod at 2^15, the analytic planes at 2^14, the
// phases (theta, dt; cycles) at 2^16.
constexpr float kFmScale = 32768.0f;
constexpr float kIqScale = 16384.0f;
constexpr float kPhScale = 65536.0f;

// float32 -> int16 at `scale`: round half to even, clamp to +-32767, as
// qformat.py::q_i16 evaluates it.  The rounding converts to int32
// (__float2int_rn: half to even, saturating past +-2^31) and the clamp is
// on integers, which equals rounding and clamping in float32 on every
// input but NaN; NaN converts to 0.
__device__ __forceinline__ int16_t q_i16(float x, float scale) {
  return (int16_t)min(max(__float2int_rn(x * scale), -32767), 32767);
}

// int16 -> float32 through int32, times 1/scale (exact: a power of two)
__device__ __forceinline__ float dq_i16(int16_t v, float scale) {
  return (float)(int)v * (1.0f / scale);
}

// Element i of a plane that is float32, or int16 at `scale`, as float32;
// and the store of a float32 value into either.  The kernels that take the
// int16 format are templated on the plane type and go through these.
__device__ __forceinline__ float load_f32(const float* __restrict__ p,
                                          int64_t i, float) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const int16_t* __restrict__ p,
                                          int64_t i, float scale) {
  return dq_i16(p[i], scale);
}
__device__ __forceinline__ void store_f32(float* __restrict__ p, int64_t i,
                                          float v, float) {
  p[i] = v;
}
__device__ __forceinline__ void store_f32(int16_t* __restrict__ p, int64_t i,
                                          float v, float scale) {
  p[i] = q_i16(v, scale);
}

// kBatch float32 values stored at p[i0 .. i0 + kBatch) as q_i16 at `scale`
// in two 16-byte stores (p + i0 must be 32-byte aligned): the PLL's int16
// dt, one thread per channel row, where this measured ~0.3 ms per bench
// block faster than one 2-byte store per step (PERF.md)
__device__ __forceinline__ void store_i16_batch(int16_t* __restrict__ p,
                                                int64_t i0, const float* v,
                                                float scale) {
  static_assert(kBatch == 16, "two 16-byte stores of int16");
  uint32_t w[kBatch / 2];
#pragma unroll
  for (int k = 0; k < kBatch / 2; ++k)
    w[k] = (uint32_t)(uint16_t)q_i16(v[2 * k], scale) |
           ((uint32_t)(uint16_t)q_i16(v[2 * k + 1], scale) << 16);
  uint4* d = (uint4*)(p + i0);
  d[0] = make_uint4(w[0], w[1], w[2], w[3]);
  d[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// four float32 values as q_i16 at `scale`, packed for one 8-byte store
// (the fused mid end's int16 re, im and theta)
__device__ __forceinline__ uint2 q_i16x4(const float (&v)[4], float scale) {
  return make_uint2(
      (uint32_t)(uint16_t)q_i16(v[0], scale) |
          ((uint32_t)(uint16_t)q_i16(v[1], scale) << 16),
      (uint32_t)(uint16_t)q_i16(v[2], scale) |
          ((uint32_t)(uint16_t)q_i16(v[3], scale) << 16));
}

// The batches of a serial kernel's row (the peak IIR's recurrence in
// k12_stages.cuh, the PLL in pll.cu), kBatch steps at a time by 16-byte
// loads and stores.  A Batch<T> holds kBatch steps as they were loaded,
// float32 (four float4) or the int16 format (two 16-byte words, eight
// values each); batch_at dequantises step u only where it is used, so no
// instruction waits on a load before its batch runs.

// p[at .. at + kBatch) into v, four floats a load (at % 4 == 0)
__device__ __forceinline__ void load_batch(const float* __restrict__ p,
                                           int64_t at, int64_t total,
                                           float (&v)[kBatch]) {
#ifdef FMT_CHECKED
  FMT_AT(p, at + kBatch - 1, total);
#endif
#pragma unroll
  for (int u = 0; u < kBatch; u += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + at + u);
    v[u] = q.x;
    v[u + 1] = q.y;
    v[u + 2] = q.z;
    v[u + 3] = q.w;
  }
}

template <class T>
struct Batch;
template <>
struct Batch<float> {
  float v[kBatch];
};
template <>
struct Batch<int16_t> {
  uint4 w[kBatch / 8];
};

// p[at .. at + kBatch) into b (p + at 16-byte aligned)
__device__ __forceinline__ void load_raw(const float* __restrict__ p,
                                         int64_t at, int64_t total,
                                         Batch<float>& b) {
  load_batch(p, at, total, b.v);
}
__device__ __forceinline__ void load_raw(const int16_t* __restrict__ p,
                                         int64_t at, int64_t total,
                                         Batch<int16_t>& b) {
#ifdef FMT_CHECKED
  FMT_AT(p, at + kBatch - 1, total);
#endif
#pragma unroll
  for (int k = 0; k < kBatch / 8; ++k)
    b.w[k] = *reinterpret_cast<const uint4*>(p + at + 8 * k);
}

// step u of the batch as float32 (the int16 format at `scale`, as
// load_f32 dequantises it); u is a constant after unrolling
__device__ __forceinline__ float batch_at(const Batch<float>& b, int u,
                                          float) {
  return b.v[u];
}
__device__ __forceinline__ float batch_at(const Batch<int16_t>& b, int u,
                                          float scale) {
  const uint4 q = b.w[u / 8];
  const int j = (u % 8) / 2;
  const uint32_t w = j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;
  return dq_i16((int16_t)(uint16_t)(u % 2 ? w >> 16 : w & 0xffffu), scale);
}

// v[0 .. kBatch) stored at p[at ..) as float32 (four float4) or as the
// int16 format at `scale` (store_i16_batch)
__device__ __forceinline__ void store_batch(float* __restrict__ p, int64_t at,
                                            int64_t total,
                                            const float (&v)[kBatch],
                                            float) {
#ifdef FMT_CHECKED
  FMT_AT(p, at + kBatch - 1, total);
#endif
#pragma unroll
  for (int u = 0; u < kBatch; u += 4)
    *reinterpret_cast<float4*>(p + at + u) =
        make_float4(v[u], v[u + 1], v[u + 2], v[u + 3]);
}
__device__ __forceinline__ void store_batch(int16_t* __restrict__ p,
                                            int64_t at, int64_t total,
                                            const float (&v)[kBatch],
                                            float scale) {
#ifdef FMT_CHECKED
  FMT_AT(p, at + kBatch - 1, total);
#endif
  store_i16_batch(p, at, v, scale);
}

// A plane stored skewed in shared memory: one pad word every 32, so that
// threads whose windows start 32 samples apart (a register-blocked FIR's
// neighbours) load from distinct banks.
__host__ __device__ constexpr int mid_skew(int x) { return x + (x >> 5); }

// sum_k w_rev[k] * v[k] for k < nn, from the oldest sample up: one
// decimated-correlation output over a window that lies in one array (the
// tiles of shared memory in extract.cu and chain.cu).  fir_dot2 runs two
// planes through the same taps.
__device__ __forceinline__ float fir_dot(const float* v,
                                         const float* __restrict__ w_rev,
                                         int nn) {
  float acc = 0.0f;
  for (int k = 0; k < nn; ++k) acc += __ldg(w_rev + k) * v[k];
  return acc;
}

__device__ __forceinline__ void fir_dot2(const float* a, const float* b,
                                         const float* __restrict__ w_rev,
                                         int nn, float& ya, float& yb) {
  float ar = 0.0f, ai = 0.0f;
  for (int k = 0; k < nn; ++k) {
    const float wk = __ldg(w_rev + k);
    ar += wk * a[k];
    ai += wk * b[k];
  }
  ya = ar;
  yb = ai;
}

// One decimated-correlation output: sum_k w_rev[k] * v[base + k] over
// v = [tail (halo samples) | x (n_x samples)] (index n < 0 reads
// tail[halo + n]), summed from the oldest sample as ops/fir.py::
// decimate_core does.  x is float32, or int16 at `scale`, dequantised on
// load; the tail is float32.
template <class T>
__device__ __forceinline__ float fir_point(const T* __restrict__ x, int n_x,
                                           const float* __restrict__ tail,
                                           int halo,
                                           const float* __restrict__ w_rev,
                                           int nn, int base,
                                           float scale = 1.0f) {
  float acc = 0.0f;
  for (int k = 0; k < nn; ++k) {
    const int n = base + k;
    const float v = n < 0 ? FMT_AT(tail, halo + n, halo)
                          : load_f32(&FMT_AT(x, n, n_x), 0, scale);
    acc += __ldg(&FMT_AT(w_rev, k, nn)) * v;
  }
  return acc;
}

// y[c, i] = fir_point(x[c], tail[c], base = m*i - halo) for i < n_out:
// a decimate-by-m FIR with a carried tail of halo = nn - m samples.
// One thread per output; neighbouring threads read neighbouring windows.
template <class T>
__global__ void fir_decimate_kernel(const T* __restrict__ x, int n_in,
                                    const float* __restrict__ tail,
                                    const float* __restrict__ w_rev, int nn,
                                    int m, float* __restrict__ y, int n_out,
                                    int channels, float scale) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)channels * n_out;
  if (idx >= total) return;
  const int c = (int)(idx / n_out);
  const int i = (int)(idx % n_out);
  const int halo = nn - m;
  FMT_AT(y, idx, total) =
      fir_point(x + (int64_t)c * n_in, n_in, tail + (int64_t)c * halo, halo,
                w_rev, nn, m * i - halo, scale);
}

template <class T>
inline int fir_decimate(const T* x, int n_in, const float* tail,
                        const float* w_rev, int nn, int m, float* y,
                        int channels, cudaStream_t stream,
                        float scale = 1.0f) {
  const int n_out = n_in / m;
  fir_decimate_kernel<T><<<blocks_for((int64_t)channels * n_out), kThreads,
                           0, stream>>>(x, n_in, tail, w_rev, nn, m, y, n_out,
                                        channels, scale);
  FMT_CHECK_LAUNCH();
  return 0;
}

}  // namespace fmt

// Each .cu file is its own library, so each carries one copy of this.
extern "C" const char* fmt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
