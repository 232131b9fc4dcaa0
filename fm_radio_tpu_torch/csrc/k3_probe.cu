// The extract (K3) engine probe on Hopper.
//
// Replaces the Pallas kernels of tools/k3_probe.py (a TPU diagnostic, not
// a kernel of the receiver), and the stream kernel of tools/chain_probe.py:
//   build (:80, kernel :92, pallas_call :187)
//     stream1, stream     the per-tile sums of one plane (re) or of the
//                         three (re, im, dt): the read alone
//                         (tools/chain_probe.py::_stream3_pallas :35, :52
//                         is `stream` at t_blk = 1024)
//     phasor              + the harmonic phasors and the four mixes,
//                         summed per tile
//     value               extract without the shared-memory tile
//                         (k3_value_kernel): each thread register-blocks
//                         16 consecutive audio outputs (8 RDS) of one
//                         channel and mixes its own window samples as it
//                         slides over them, so nothing is staged and no
//                         shared-memory bank is read; ROADMAP performance
//                         item 1's question.  It recomputes the mix of
//                         the samples its window shares with the
//                         neighbouring runs (184 mixed per 64 new).
//     full                the production extract kernel (extract.cu), run
//                         by the wrapper on the probe's taps
//   build_stream31 (:55, kernel :61, pallas_call :66)
//     stream31            the per-tile sums of one row-stacked [3C, B8]
//                         plane (c_blk-interleaved row groups); the TPU
//                         output keeps the first c_blk rows of each group
//
// The stream-style sums are probe_sum.cuh's: the [C, 128] output of the
// last time tile, as the TPU kernels leave it, and every tile's sums.  The
// mix is extract_stages.cuh's mix_sample and the FIR sums add from the
// oldest sample up, as fir_dot, so `value` equals `full` (extract on zero
// carried tails: the TPU probe never writes its tails) bit for bit.
//
// What bounds them is what this probe measures; the times are in PERF.md.

#include "extract_stages.cuh"
#include "probe_sum.cuh"

namespace fmt {

// The Ops of tile_sum_kernel (probe_sum.cuh; frontend_probe.cu says what
// each member does).

// float32 rows, float4 at a time (stream1; stream31 keeps rows k < c_blk
// of each 3 * c_blk row group, at g * c_blk + k)
struct F32Sum {
  static constexpr int kVec = 4, kPlanes = 1;
  using Raw = float4;
  using Acc = float;
  const float* x;
  int rows, n, c_blk;  // c_blk > 0: the stream31 row groups
  __device__ __forceinline__ Acc zero() const { return 0.0f; }
  __device__ __forceinline__ int64_t base(int r, int ti, int t_blk) const {
    return tile_base(r, ti, rows, n, t_blk, false);
  }
  __device__ __forceinline__ Raw fetch(int64_t b, int v) const {
    return ld_once((const float4*)(x + b) + v);
  }
  __device__ __forceinline__ void add(Acc& acc, const Raw& v) const {
    acc += v.x;
    acc += v.y;
    acc += v.z;
    acc += v.w;
  }
  __device__ __forceinline__ float done(Acc acc) const { return acc; }
  __device__ __forceinline__ bool keep(int r, int rows_blk, int& o) const {
    if (c_blk == 0) {
      o = r;
      return true;
    }
    const int g = r / rows_blk, k = r % rows_blk;
    o = g * c_blk + k;
    return k < c_blk;
  }
};

// the same sample of the three float32 planes re, im, dt
struct Three {
  float4 r, i, d;
};

struct ThreePlanes : KeepAll {
  static constexpr int kVec = 4, kPlanes = 3;
  using Raw = Three;
  const float *xr, *xi, *dt;
  int rows, n;
  __device__ __forceinline__ int64_t base(int r, int ti, int t_blk) const {
    return tile_base(r, ti, rows, n, t_blk, false);
  }
  __device__ __forceinline__ Raw fetch(int64_t b, int v) const {
    return {ld_once((const float4*)(xr + b) + v),
            ld_once((const float4*)(xi + b) + v),
            ld_once((const float4*)(dt + b) + v)};
  }
};

// three float32 planes: the lane's sums of re, im and dt, added as
// (re + im) + dt
struct F32Sum3 : ThreePlanes {
  struct Acc {
    float a[3];
  };
  __device__ __forceinline__ Acc zero() const { return {{0.0f, 0.0f, 0.0f}}; }
  __device__ __forceinline__ void add(Acc& acc, const Raw& v) const {
    const float4 p[3] = {v.r, v.i, v.d};
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      acc.a[q] += p[q].x;
      acc.a[q] += p[q].y;
      acc.a[q] += p[q].z;
      acc.a[q] += p[q].w;
    }
  }
  __device__ __forceinline__ float done(const Acc& acc) const {
    return (acc.a[0] + acc.a[1]) + acc.a[2];
  }
};

// the four mixes of each sample (harmonics 2 and 3, offset 0) summed:
// ((L-R re + L-R im) + RDS re) + RDS im
struct PhasorSum : ThreePlanes {
  struct Acc {
    float s, co, so;  // the sum, and offset 0's phasor
  };
  __device__ __forceinline__ Acc zero() const {
    Acc acc{0.0f, 0.0f, 0.0f};
    offset_phasor(0.0f, acc.co, acc.so);
    return acc;
  }
  __device__ __forceinline__ void add(Acc& acc, const Raw& v) const {
    const float er[4] = {v.r.x, v.r.y, v.r.z, v.r.w};
    const float ei[4] = {v.i.x, v.i.y, v.i.z, v.i.w};
    const float ed[4] = {v.d.x, v.d.y, v.d.z, v.d.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float vmr, vmi, vrr, vri;
      mix_sample(er[u], ei[u], ed[u], acc.co, acc.so, vmr, vmi, vrr, vri);
      acc.s += ((vmr + vmi) + vrr) + vri;
    }
  }
  __device__ __forceinline__ float done(const Acc& acc) const {
    return acc.s;
  }
};

// extract's five outputs without a staged tile: thread (c, run) computes
// audio outputs j0 .. j0 + kRun - 1 (L+R, L-R re and im: ds x4 of nn_a
// taps) and RDS outputs j0/2 .. j0/2 + kRun/2 - 1 (ds x8 of nn_r taps) of
// channel c, sliding over samples j0*4 - max(halo) .. (j0 + kRun)*4 - 1:
// each sample is loaded and mixed once per thread (samples before the row
// read 0: zero carried tails) and added into every output whose window
// holds it, so each output sums from its oldest sample up, as fir_dot.
template <int kRun>
__global__ void k3_value_kernel(const float* __restrict__ xr,
                                const float* __restrict__ xi,
                                const float* __restrict__ dt, int n,
                                const float* __restrict__ wa,
                                const float* __restrict__ wm, int nn_a,
                                const float* __restrict__ wr, int nn_r,
                                int channels, float* __restrict__ lpr,
                                float* __restrict__ lmr_re,
                                float* __restrict__ lmr_im,
                                float* __restrict__ rds_re,
                                float* __restrict__ rds_im) {
  const int na = n / 4, runs = na / kRun;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)channels * runs) return;
  const int c = (int)(idx / runs);
  const int j0 = (int)(idx % runs) * kRun, i0 = j0 / 2;
  const int halo_a = nn_a - 4, halo_r = nn_r - 8;
  const int64_t row = (int64_t)c * n;
  float co, so;
  offset_phasor(0.0f, co, so);
  float al[kRun], amr[kRun], ami[kRun], arr[kRun / 2], ari[kRun / 2];
#pragma unroll
  for (int r = 0; r < kRun; ++r) al[r] = amr[r] = ami[r] = 0.0f;
#pragma unroll
  for (int q = 0; q < kRun / 2; ++q) arr[q] = ari[q] = 0.0f;
  const int g0 = min(4 * j0 - halo_a, 8 * i0 - halo_r);
  const int g1 = 4 * (j0 + kRun);
  for (int g = g0; g < g1; ++g) {
    float vl = 0.0f, vmr = 0.0f, vmi = 0.0f, vrr = 0.0f, vri = 0.0f;
    if (g >= 0) {
      vl = xr[row + g];
      mix_sample(vl, xi[row + g], dt[row + g], co, so, vmr, vmi, vrr, vri);
    }
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      const int k = g - (4 * (j0 + r) - halo_a);
      if (k >= 0 && k < nn_a) {
        const float w = __ldg(wa + k), v = __ldg(wm + k);
        al[r] += w * vl;
        amr[r] += v * vmr;
        ami[r] += v * vmi;
      }
    }
#pragma unroll
    for (int q = 0; q < kRun / 2; ++q) {
      const int k = g - (8 * (i0 + q) - halo_r);
      if (k >= 0 && k < nn_r) {
        const float w = __ldg(wr + k);
        arr[q] += w * vrr;
        ari[q] += w * vri;
      }
    }
  }
  const int64_t oa = (int64_t)c * na + j0, orr = (int64_t)c * (n / 8) + i0;
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    lpr[oa + r] = al[r];
    lmr_re[oa + r] = amr[r];
    lmr_im[oa + r] = ami[r];
  }
#pragma unroll
  for (int q = 0; q < kRun / 2; ++q) {
    rds_re[orr + q] = arr[q];
    rds_im[orr + q] = ari[q];
  }
}

constexpr int kValueRun = 16;

}  // namespace fmt

using namespace fmt;

// The per-tile sums.  mode 0 stream1 (x [C, N]), 1 stream (x, x2, x3 =
// re, im, dt [C, N]), 2 phasor (the same), 3 stream31 (x [3C, N], row
// groups of 3 * c_blk, `last` [C, 128]).  sums [rows, N / t_blk]; c_blk |
// C, t_blk | N, t_blk % 128 == 0; 16-byte aligned rows.
extern "C" int fmt_k3_sum(const float* x, const float* x2, const float* x3,
                          int mode, int channels, int n, int c_blk, int t_blk,
                          float* sums, float* last, cudaStream_t stream) {
  if (c_blk <= 0 || channels % c_blk || t_blk <= 0 || n % t_blk ||
      mode < 0 || mode > 3)
    return (int)cudaErrorInvalidValue;
  const int n_tt = n / t_blk;
  switch (mode) {
    case 0:
      return launch_tile_sum(F32Sum{x, channels, n, 0}, channels, c_blk,
                             n_tt, t_blk, 0, sums, last, stream);
    case 1:
      return launch_tile_sum(F32Sum3{{{}, x, x2, x3, channels, n}}, channels,
                             c_blk, n_tt, t_blk, 0, sums, last, stream);
    case 2:
      return launch_tile_sum(PhasorSum{{{}, x, x2, x3, channels, n}}, channels,
                             c_blk, n_tt, t_blk, 0, sums, last, stream);
    default:
      return launch_tile_sum(F32Sum{x, 3 * channels, n, c_blk}, 3 * channels,
                             3 * c_blk, n_tt, t_blk, 0, sums, last, stream);
  }
}

// value: re, im, dt [C, N] float32; wa, wm [nn_a], wr [nn_r] reversed taps
// (nn_a - 4 and nn_r - 8 <= 128); lpr, lmr_* [C, N/4], rds_* [C, N/8].
// N % (4 * 16) == 0.
extern "C" int fmt_k3_value(const float* xr, const float* xi, const float* dt,
                            int channels, int n, const float* wa,
                            const float* wm, int nn_a, const float* wr,
                            int nn_r, float* lpr, float* lmr_re,
                            float* lmr_im, float* rds_re, float* rds_im,
                            cudaStream_t stream) {
  if (n % (4 * kValueRun) || nn_a < 4 || nn_r < 8 || nn_a - 4 > 128 ||
      nn_r - 8 > 128)
    return (int)cudaErrorInvalidValue;
  const int64_t threads = (int64_t)channels * (n / 4 / kValueRun);
  k3_value_kernel<kValueRun><<<blocks_for(threads), kThreads, 0, stream>>>(
      xr, xi, dt, n, wa, wm, nn_a, wr, nn_r, channels, lpr, lmr_re, lmr_im,
      rds_re, rds_im);
  FMT_CHECK_LAUNCH();
  return 0;
}
