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
// (op.lane), then the 32 lanes add by butterfly (warp_allsum); the plain
// versions (probes/frontend_probe.py, probes/k3_probe.py) add in that
// order, so kernel and plain version agree bit for bit.
#pragma once

#include "common.cuh"

namespace fmt {

// (ci, ti) of CTA b over n_ct channel tiles x n_tt time tiles.  raster 0
// walks the time tiles fastest (the TPU grid's order: time innermost),
// raster 1 the channel tiles fastest; the card has no dimension
// semantics, so the probes' `sem` rows map to this order.
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

// every lane's value added over the warp by butterfly; every lane ends
// with the same sum
__device__ __forceinline__ float warp_allsum(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a += __shfl_xor_sync(0xffffffffu, a, off);
  return a;
}

// CTA (ci, ti) sums rows ci*rows_blk .. of tile ti (t_blk samples); warp w
// takes rows w, w + 8, ...  op.lane(r, ti, lane, t_blk) is lane `lane`'s
// ordered partial sum of row r's tile; op.keep(r, rows_blk, o) says
// whether (and where, o) the row's sum goes into `last`.
template <class Op>
__global__ void tile_sum_kernel(Op op, int rows_blk, int n_ct, int n_tt,
                                int t_blk, int raster, float* __restrict__ sums,
                                float* __restrict__ last) {
  int ci, ti;
  tile_of(blockIdx.x, n_ct, n_tt, raster, ci, ti);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int rr = warp; rr < rows_blk; rr += blockDim.x >> 5) {
    const int r = ci * rows_blk + rr;
    const float s = warp_allsum(op.lane(r, ti, lane, t_blk));
    if (lane == 0) sums[(int64_t)r * n_tt + ti] = s;
    int o;
    if (ti == n_tt - 1 && op.keep(r, rows_blk, o)) {
      for (int e = lane; e < 128; e += 32) last[(int64_t)o * 128 + e] = s;
    }
  }
}

template <class Op>
int launch_tile_sum(Op op, int rows, int rows_blk, int n_tt, int t_blk,
                    int raster, float* sums, float* last,
                    cudaStream_t stream) {
  if (rows_blk <= 0 || rows % rows_blk || t_blk % (32 * Op::kVec))
    return (int)cudaErrorInvalidValue;
  const int n_ct = rows / rows_blk;
  tile_sum_kernel<Op><<<n_ct * n_tt, kThreads, 0, stream>>>(
      op, rows_blk, n_ct, n_tt, t_blk, raster, sums, last);
  FMT_CHECK_LAUNCH();
  return 0;
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
