// Per-tile row sums for the engine probes (frontend_probe.cu, k3_probe.cu):
// the "stream"-style variants of the TPU probes read every sample of a
// tile and keep one sum per row.
//
// The TPU kernels write the sum of each row's tile into a [C, 128] block
// whose index is constant over the time axis, so only the LAST time tile's
// sums survive.  tile_sum_kernel reproduces that output (`last`) and also
// writes every tile's sums (`sums` [rows, n_tt]), so that a kernel that
// skipped a tile shows.  The order of the additions is fixed: lane l of a
// warp adds its 16-byte vectors k*32 + l in order, element by element
// (op.add), then the 32 lanes add by butterfly (warp_allsum); the plain
// versions (probes/frontend_probe.py, probes/k3_probe.py) add in that
// order, so kernel and plain version agree bit for bit.
//
// What bounds it: the bytes read (an add per element).  The design keeps
// the read at the card's read rate:
//   - the unit of work is one row's tile (an item), taken by one warp; a
//     CTA of kSumThreads takes kSumThreads / 32 items in the walk's order
//     (sum_item; raster 0: the rows' tiles in memory order), and the grid
//     has a CTA for every such group, so the card's block scheduler hands
//     out the items in order: the CTAs resident at a time read one window
//     of the input, and the SMs finish within a CTA of each other (a warp
//     that finds no item, in the last CTA, stops; a grid smaller than the
//     items would walk them by its stride).  A persistent grid whose warps
//     walked pairs of rows, two in flight a warp, read more slowly on the
//     H100 and was not kept;
//   - at the probes' tile lengths (kSumTBlks) the lane loop is compiled
//     for that length: a row's loads go out sum_batch() vectors at a time,
//     up to kSumLoads 16-byte loads a lane, all of a batch before its first
//     add (stream31's rows of 1,024 samples in one batch, the K1 probe's
//     2,048 words in two).  Any other length runs the loop at run time, a
//     vector at a time;
//   - every load evicts first from L2 (ld.global.cs): each byte is read
//     once.
// The host copy of the walk is probes/_probe.py (sum_item, sum_walk,
// sum_batch).
#pragma once

#include "common.cuh"

namespace fmt {

// the tile lengths the lane loop is compiled for (probes/_probe.py
// SUM_T_BLKS); 16-byte loads a lane in flight at most; a CTA's threads
constexpr int kSumTBlks[3] = {1024, 2048, 4096};
constexpr int kSumLoads = 8;
constexpr int kSumThreads = 256;

// (ci, ti) of CTA b over n_ct channel tiles x n_tt time tiles.  raster 0
// walks the time tiles fastest (the TPU grid's order: time innermost),
// raster 1 the channel tiles fastest (the K1 probe's staged FIR,
// frontend_probe.cu).
__device__ __forceinline__ void tile_of(int b, int n_ct, int n_tt, int raster,
                                        int& ci, int& ti) {
  if (raster == 0) {
    ci = b / n_tt;
    ti = b % n_tt;
  } else {
    ci = b % n_ct;
    ti = b / n_ct;
  }
}

// Item i of rows x n_tt items -> (row r, time tile ti).  raster 0 walks
// the time tiles fastest (the TPU grid's order: time innermost): row r's
// tiles in order, then row r + 1's; raster 1 the rows fastest (any
// semantics marking the channel axis parallel): every row's tile ti, then
// tile ti + 1.  The card has no dimension semantics, so the probes' `sem`
// rows map to this order.
__host__ __device__ __forceinline__ void sum_item(int64_t i, int rows,
                                                  int n_tt, int raster,
                                                  int& r, int& ti) {
  if (raster == 0) {
    r = (int)(i / n_tt);
    ti = (int)(i % n_tt);
  } else {
    ti = (int)(i / rows);
    r = (int)(i % rows);
  }
}

// a row's vectors a batch: the largest power of two that divides kK with
// a batch of every plane within kSumLoads (at least 1)
template <int kK, int kPlanes>
__host__ __device__ constexpr int sum_batch() {
  int b = 1;
  while (b * 2 <= kK && kK % (b * 2) == 0 && b * 2 * kPlanes <= kSumLoads)
    b *= 2;
  return b;
}

// every lane's value added over the warp by butterfly; every lane ends
// with the same sum
__device__ __forceinline__ float warp_allsum(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a += __shfl_xor_sync(0xffffffffu, a, off);
  return a;
}

// 16 bytes read once (streaming: evict first)
template <class T>
__device__ __forceinline__ T ld_once(const T* p) {
  return __ldcs(p);
}

// Row r's tile ti: lane `lane`'s ordered partial sum.  kK > 0: kK vectors
// a lane, in batches; kK = 0: k_run vectors, one at a time.
template <int kK, class Op>
__device__ __forceinline__ float sum_row(const Op& op, int r, int ti,
                                         int t_blk, int k_run, int lane) {
  typename Op::Acc a = op.zero();
  const int64_t b = op.base(r, ti, t_blk);
  if constexpr (kK > 0) {
    constexpr int kB = sum_batch<kK, Op::kPlanes>();
#pragma unroll
    for (int k0 = 0; k0 < kK; k0 += kB) {
      typename Op::Raw v[kB];
#pragma unroll
      for (int u = 0; u < kB; ++u) v[u] = op.fetch(b, (k0 + u) * 32 + lane);
#pragma unroll
      for (int u = 0; u < kB; ++u) op.add(a, v[u]);
    }
  } else {
    for (int k = 0; k < k_run; ++k) op.add(a, op.fetch(b, k * 32 + lane));
  }
  return op.done(a);
}

// Warp p of W (p = CTA * warps + warp) sums items p, p + W, ... (one
// each on the launch's grid).  op.keep(r, rows_blk, o) says whether (and
// where, o) a row's sum of the last tile goes into `last`.
template <class Op, int kK>
__global__ void __launch_bounds__(kSumThreads)
    tile_sum_kernel(Op op, int rows, int rows_blk, int n_tt, int t_blk,
                    int raster, float* __restrict__ sums,
                    float* __restrict__ last) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int64_t items = (int64_t)rows * n_tt;
  const int64_t w_all = (int64_t)gridDim.x * warps;
  const int k_run = t_blk / (32 * Op::kVec);
  for (int64_t i = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5);
       i < items; i += w_all) {
    int r, ti;
    sum_item(i, rows, n_tt, raster, r, ti);
    const float s = warp_allsum(sum_row<kK>(op, r, ti, t_blk, k_run, lane));
    if (lane == 0) sums[(int64_t)r * n_tt + ti] = s;
    int o;
    if (ti == n_tt - 1 && op.keep(r, rows_blk, o)) {
      for (int e = lane; e < 128; e += 32) last[(int64_t)o * 128 + e] = s;
    }
  }
}

// A CTA of kSumThreads for every kSumThreads / 32 items (2^31 - 1 CTAs
// at most: beyond, the warps walk by the grid's stride).
template <class Op, int kK>
int launch_tile_sum_k(Op op, int rows, int rows_blk, int n_tt, int t_blk,
                      int raster, float* sums, float* last,
                      cudaStream_t stream) {
  constexpr int kWarps = kSumThreads / 32;
  const int64_t want = ((int64_t)rows * n_tt + kWarps - 1) / kWarps;
  const int grid = (int)(want < 0x7fffffff ? want : 0x7fffffff);
  tile_sum_kernel<Op, kK><<<grid, kSumThreads, 0, stream>>>(
      op, rows, rows_blk, n_tt, t_blk, raster, sums, last);
  FMT_CHECK_LAUNCH();
  return 0;
}

// rows = n_ct * rows_blk rows of n_tt tiles of t_blk samples; the lane
// loop compiled for the lengths of kSumTBlks, at run time for any other.
template <class Op>
int launch_tile_sum(Op op, int rows, int rows_blk, int n_tt, int t_blk,
                    int raster, float* sums, float* last,
                    cudaStream_t stream) {
  if (rows_blk <= 0 || rows % rows_blk || t_blk <= 0 ||
      t_blk % (32 * Op::kVec) || n_tt <= 0 || (raster != 0 && raster != 1))
    return (int)cudaErrorInvalidValue;
  switch (t_blk) {
    case kSumTBlks[0]:
      return launch_tile_sum_k<Op, kSumTBlks[0] / (32 * Op::kVec)>(
          op, rows, rows_blk, n_tt, t_blk, raster, sums, last, stream);
    case kSumTBlks[1]:
      return launch_tile_sum_k<Op, kSumTBlks[1] / (32 * Op::kVec)>(
          op, rows, rows_blk, n_tt, t_blk, raster, sums, last, stream);
    case kSumTBlks[2]:
      return launch_tile_sum_k<Op, kSumTBlks[2] / (32 * Op::kVec)>(
          op, rows, rows_blk, n_tt, t_blk, raster, sums, last, stream);
    default:
      return launch_tile_sum_k<Op, 0>(op, rows, rows_blk, n_tt, t_blk,
                                      raster, sums, last, stream);
  }
}

// the first element of row r's tile ti: [rows, n] rows, or tile-major
// [n_tt, rows, t_blk]
__device__ __forceinline__ int64_t tile_base(int r, int ti, int rows, int n,
                                             int t_blk, bool tile_major) {
  return tile_major ? ((int64_t)ti * rows + r) * t_blk
                    : (int64_t)r * n + (int64_t)ti * t_blk;
}

// Every row's sums kept in `last` at its own index.
struct KeepAll {
  __device__ __forceinline__ bool keep(int r, int, int& o) const {
    o = r;
    return true;
  }
};

}  // namespace fmt
