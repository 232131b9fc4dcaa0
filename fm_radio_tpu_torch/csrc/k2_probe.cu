// The K2 (mid end) engine probe on Hopper, and the block-parallel IIR.
//
// Replaces the Pallas kernel of tools/k2_probe.py (build :48, kernel :69,
// pallas_call :202; a TPU diagnostic, not a kernel of the receiver):
//   stream      re, im, theta copied from the two halves of each time tile
//               of fm_demod (k2_stream_kernel): the bytes alone
//   ds2         + the ds x2 FIR, written to all three outputs
//               (k2_ds2_kernel, on fir_point)
//   hilb        + the Hilbert FIR: re delayed, im filtered, theta = im
//               (k2_hilb_kernel, on fir_point, after fir_decimate_kernel).
//               The TPU probe reads re after it has carried the tile's
//               tail into the buffer's head (tools/k2_probe.py:117-118), so
//               its re is each tile of the ds x2 output rotated by the
//               delay: re[u] = fm_out[u - d] within the tile, the first d
//               from the tile's own last d.  The port reproduces that.
//   full        the production K2 (launch_midend of k12_stages.cuh, its
//               launches route: ds x2, serial de-emphasis, Hilbert, the
//               peak IIR's recurrence + power, the theta pass), on the
//               probe's coefficients and zero state
//   restruct:li[:stk]
//               the de-emphasis and the peak IIR as block-Toeplitz
//               recurrences (k2_deemph_block_kernel, k2_peak_block_kernel):
//               within a block of li outputs the zero-state response is a
//               causal FIR of length <= li, y[j] = sum_{i<=j} h[j-i] x[i]
//               (the TPU's lower-triangular Toeplitz T[i, j] = h[j - i],
//               midend_pallas.py::_iir_tile_mats :68, :83-84), plus the
//               carried inputs times the rows hm and the carried outputs
//               times the rows pm.  One CTA per channel holds h, hm, pm in
//               shared memory (li + 2 r li floats, <= 10 KB at li = 512;
//               not the li x li matrix, 1 MiB at li = 512) and computes a
//               block's li outputs in parallel, one per thread; only the
//               l / li block steps are serial.  stk: the re and im peak
//               chains of a channel run on the same li threads one after
//               the other; without it on 2 li threads, one chain each.
//
// What the TPU kernel never writes (the ds x2 and Hilbert buffers' heads,
// the IIR state, the power accumulator at the first tile) reads as zeros:
// the carried state of a channel starts at zero, so every variant but
// stream is K2 on zero state.  Each block output sums its zero-state part
// from i = 0 up, then adds the carried terms in the TPU's order (x1 hm[0],
// x2 hm[1], y1 pm[0], y2 pm[1]); the power sums each thread's outputs in
// double over the blocks, then the threads in order.  The plain versions
// (probes/k2_probe.py) add in that order: the kernels equal them bit for
// bit.
//
// What bounds them is what this probe measures; the times are in PERF.md.

#include "k12_stages.cuh"

namespace fmt {

// out[c, ti*l + u] for the halves of tile ti of x [C, n] (l = t_blk / 2):
// re from the first half, im from the second, theta = re; float4 a thread
__global__ void k2_stream_kernel(const float4* __restrict__ x, int64_t nv,
                                 int l4, float4* __restrict__ re,
                                 float4* __restrict__ im,
                                 float4* __restrict__ th, int64_t total4) {
  const int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total4) return;
  const int64_t half4 = nv / 2;  // float4 per output row (nv per input row)
  const int64_t c = o / half4, u = o % half4;
  const int64_t ti = u / l4, k = u % l4;
  const int64_t src = c * nv + ti * 2 * l4 + k;
  const float4 a = x[src];
  re[o] = a;
  th[o] = a;
  im[o] = x[src + l4];
}

// the ds x2 FIR on zero state (zero tail of nn - 2), into all three outputs
__global__ void k2_ds2_kernel(const float* __restrict__ x, int n_in,
                              const float* __restrict__ zeros,
                              const float* __restrict__ w_rev, int nn,
                              int channels, float* __restrict__ re,
                              float* __restrict__ im,
                              float* __restrict__ th) {
  const int n_out = n_in / 2;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)channels * n_out) return;
  const int c = (int)(idx / n_out), i = (int)(idx % n_out);
  const int halo = nn - 2;
  const float y = fir_point(x + (int64_t)c * n_in, n_in, zeros, halo, w_rev,
                            nn, 2 * i - halo);
  re[idx] = y;
  im[idx] = y;
  th[idx] = y;
}

// the Hilbert on fm_out [C, n] and zero state: im = nh-tap FIR
// (k12_hilbert_kernel's sum), re = each tile of lt samples rotated by the
// delay d = (nh - 1)/2, theta = im
__global__ void k2_hilb_kernel(const float* __restrict__ fm_out, int n,
                               int lt, const float* __restrict__ zeros,
                               const float* __restrict__ wh_rev, int nh,
                               int channels, float* __restrict__ re,
                               float* __restrict__ im,
                               float* __restrict__ th) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)channels * n) return;
  const int c = (int)(idx / n), i = (int)(idx % n);
  const int halo = nh - 1;
  const float* x = fm_out + (int64_t)c * n;
  const float vi = fir_point(x, n, zeros, halo, wh_rev, nh, i - halo);
  const int d = (nh - 1) / 2, u = i % lt;
  re[idx] = x[u < d ? i + lt - d : i - d];
  im[idx] = vi;
  th[idx] = vi;
}

// h [li], then the rows hm [r, li] and pm [r, li], staged in shared memory
__device__ __forceinline__ void stage_mats(float* s, const float* h,
                                           const float* hm, const float* pm,
                                           int li, int r) {
  for (int e = threadIdx.x; e < li; e += blockDim.x) s[e] = h[e];
  for (int e = threadIdx.x; e < r * li; e += blockDim.x) {
    s[li + e] = hm[e];
    s[li + r * li + e] = pm[e];
  }
}

// sum_{i <= j} h[j - i] x[i], from i = 0 up
__device__ __forceinline__ float toeplitz_row(const float* h, const float* x,
                                              int j) {
  float acc = 0.0f;
  for (int i = 0; i <= j; ++i) acc += h[j - i] * x[i];
  return acc;
}

// order-1 de-emphasis in place on x [C, n] (zero state), one CTA of li
// threads per channel
__global__ void k2_deemph_block_kernel(float* __restrict__ x, int n, int li,
                                       const float* __restrict__ h,
                                       const float* __restrict__ hm,
                                       const float* __restrict__ pm) {
  extern __shared__ float s[];
  float* hs = s;                 // h [li], hm [li], pm [li]
  float* xs = s + 3 * li;        // the block's inputs [li]
  float* ys = xs + li;           // its last output [1]
  stage_mats(s, h, hm, pm, li, 1);
  const int j = threadIdx.x;
  float* row = x + (int64_t)blockIdx.x * n;
  float x1 = 0.0f, y1 = 0.0f;
  for (int b0 = 0; b0 < n; b0 += li) {
    xs[j] = row[b0 + j];
    __syncthreads();
    const float y = (toeplitz_row(hs, xs, j) + x1 * hs[li + j]) +
                    y1 * hs[2 * li + j];
    row[b0 + j] = y;
    if (j == li - 1) ys[0] = y;
    __syncthreads();
    x1 = xs[li - 1];
    y1 = ys[0];
    __syncthreads();
  }
}

// order-2 peak IIR on re and im [C, n] (zero state), theta [C, n] =
// atan2(yi, yr) / 2pi and power [C]; one CTA per channel, li threads (stk:
// each thread runs re then im) or 2 li (thread t: plane t / li)
template <bool kStk>
__global__ void k2_peak_block_kernel(const float* __restrict__ re,
                                     const float* __restrict__ im, int n,
                                     int li, const float* __restrict__ h,
                                     const float* __restrict__ hm,
                                     const float* __restrict__ pm,
                                     float* __restrict__ theta,
                                     float* __restrict__ power) {
  extern __shared__ float s[];
  float* hs = s;                              // h, hm [2][li], pm [2][li]
  float* xs = s + 5 * li;                     // [2][li]
  float* ys = xs + 2 * li;                    // [2][li]
  double* pw_s = (double*)(ys + 2 * li + (li & 1));  // [li]
  stage_mats(s, h, hm, pm, li, 2);
  const int64_t row = (int64_t)blockIdx.x * n;
  const float* planes[2] = {re + row, im + row};
  float x1[2] = {0.0f, 0.0f}, x2[2] = {0.0f, 0.0f};
  float y1[2] = {0.0f, 0.0f}, y2[2] = {0.0f, 0.0f};
  double pw = 0.0;
  const int t = threadIdx.x;
  for (int b0 = 0; b0 < n; b0 += li) {
    if (kStk) {
      xs[t] = planes[0][b0 + t];
      xs[li + t] = planes[1][b0 + t];
    } else {
      xs[t] = planes[t / li][b0 + t % li];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < (kStk ? 2 : 1); ++q) {
      const int p = kStk ? q : t / li, j = kStk ? t : t % li;
      const float* hp = hs + li;      // hm rows
      const float* pp = hs + 3 * li;  // pm rows
      const float y = (((toeplitz_row(hs, xs + p * li, j) + x1[p] * hp[j]) +
                        x2[p] * hp[li + j]) +
                       y1[p] * pp[j]) +
                      y2[p] * pp[li + j];
      ys[p * li + j] = y;
    }
    __syncthreads();
    if (t < li) {
      const float yr = ys[t], yi = ys[li + t];
      theta[row + b0 + t] = atan2_poly(yi, yr) * kInvTwoPi;
      pw += (double)(yr * yr + yi * yi);
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      x1[p] = xs[p * li + li - 1];
      x2[p] = xs[p * li + li - 2];
      y1[p] = ys[p * li + li - 1];
      y2[p] = ys[p * li + li - 2];
    }
    __syncthreads();
  }
  if (t < li) pw_s[t] = pw;
  __syncthreads();
  if (t == 0) {
    double acc = 0.0;
    for (int j = 0; j < li; ++j) acc += pw_s[j];
    power[blockIdx.x] = (float)acc;
  }
}

inline int peak_smem(int li) {
  return (9 * li + (li & 1)) * 4 + li * 8;
}

}  // namespace fmt

using namespace fmt;

// mode 0 stream, 1 ds2, 2 hilb (x [C, n4]; stream and hilb: t_blk | n4,
// t_blk % 8 == 0):
// re, im, th [C, n4/2].  w2_rev [nn2], wh_rev [nh] reversed taps
// (nn2 - 2, nh - 1 <= 128); zeros [C, 128] float32 zeros (every carried
// tail); fm_out [C, n4/2] scratch (hilb).
extern "C" int fmt_k2_engine(const float* x, int mode, int channels, int n4,
                             int t_blk, const float* w2_rev, int nn2,
                             const float* wh_rev, int nh, const float* zeros,
                             float* fm_out, float* re, float* im, float* th,
                             cudaStream_t stream) {
  const int64_t total = (int64_t)channels * (n4 / 2);
  if (n4 % 2 || (mode != 1 && (t_blk <= 0 || n4 % t_blk || t_blk % 8)) ||
      (mode == 2 && (nh - 1) / 2 > t_blk / 2))
    return (int)cudaErrorInvalidValue;
  if (mode == 0) {
    k2_stream_kernel<<<blocks_for(total / 4), kThreads, 0, stream>>>(
        (const float4*)x, n4 / 4, t_blk / 8, (float4*)re, (float4*)im,
        (float4*)th, total / 4);
  } else if (mode == 1) {
    k2_ds2_kernel<<<blocks_for(total), kThreads, 0, stream>>>(
        x, n4, zeros, w2_rev, nn2, channels, re, im, th);
  } else {
    fir_decimate_kernel<float><<<blocks_for(total), kThreads, 0, stream>>>(
        x, n4, zeros, w2_rev, nn2, 2, fm_out, n4 / 2, channels, 1.0f);
    FMT_CHECK_LAUNCH();
    k2_hilb_kernel<<<blocks_for(total), kThreads, 0, stream>>>(
        fm_out, n4 / 2, t_blk / 2, zeros, wh_rev, nh, channels, re, im, th);
  }
  FMT_CHECK_LAUNCH();
  return 0;
}

// full: the production mid end (launch_midend, de-emphasis on) on zero
// state (zeros as above: the tails and the IIR states in).  de = {b0, b1,
// a1}, pk = {b0, b1, b2, a1, a2} (host arrays); de_out [C, 2], pk_out
// [C, 8] the states out (scratch); fm_out [C, n4/2] scratch, which the
// peak IIR's recurrence also takes as its yi once Hilbert has read it (the
// probe carries no state, so nothing reads fm_out's tail after); re, im,
// theta [C, n4/2]; power [C].
extern "C" int fmt_k2_full(const float* x, int channels, int n4,
                           const float* w2_rev, int nn2, const float* wh_rev,
                           int nh, const float* zeros, const float* de,
                           const float* pk, float* de_out, float* pk_out,
                           float* fm_out, float* re, float* im, float* theta,
                           float* power, cudaStream_t stream) {
  if (n4 % (2 * kBatch)) return (int)cudaErrorInvalidValue;
  return launch_midend(x, w2_rev, nn2, zeros, 1, de[0], de[1], de[2], zeros,
                       de_out, wh_rev, nh, zeros, pk[0], pk[1], pk[2], pk[3],
                       pk[4], zeros, pk_out, channels, n4, fm_out, re, im,
                       theta, nullptr, nullptr, nullptr, power, stream,
                       fm_out);
}

// restruct: ds x2 (fir_decimate_kernel) -> block de-emphasis in place ->
// Hilbert (k12_hilbert_kernel) -> block peak IIR.  h_de [li], hm_de,
// pm_de [1, li]; h_pk [li], hm_pk, pm_pk [2, li]; l = n4/2, li | l,
// 2 <= li <= 512; fm_out scratch, re, im, theta [C, l]; power [C].
extern "C" int fmt_k2_restruct(const float* x, int channels, int n4, int li,
                               int stk, const float* w2_rev, int nn2,
                               const float* wh_rev, int nh,
                               const float* zeros, const float* h_de,
                               const float* hm_de, const float* pm_de,
                               const float* h_pk, const float* hm_pk,
                               const float* pm_pk, float* fm_out, float* re,
                               float* im, float* theta, float* power,
                               cudaStream_t stream) {
  const int l = n4 / 2;
  if (n4 % 2 || li < 2 || li > 512 || l % li) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)channels * l;
  fir_decimate_kernel<float><<<blocks_for(total), kThreads, 0, stream>>>(
      x, n4, zeros, w2_rev, nn2, 2, fm_out, l, channels, 1.0f);
  FMT_CHECK_LAUNCH();
  k2_deemph_block_kernel<<<channels, li, (4 * li + 1) * 4, stream>>>(
      fm_out, l, li, h_de, hm_de, pm_de);
  FMT_CHECK_LAUNCH();
  k12_hilbert_kernel<false><<<blocks_for(total), kThreads, 0, stream>>>(
      fm_out, zeros, wh_rev, nh, channels, l, re, im, nullptr, nullptr);
  FMT_CHECK_LAUNCH();
  if (stk) {
    k2_peak_block_kernel<true><<<channels, li, peak_smem(li), stream>>>(
        re, im, l, li, h_pk, hm_pk, pm_pk, theta, power);
  } else {
    k2_peak_block_kernel<false><<<channels, 2 * li, peak_smem(li), stream>>>(
        re, im, l, li, h_pk, hm_pk, pm_pk, theta, power);
  }
  FMT_CHECK_LAUNCH();
  return 0;
}
