// Polyphase FFT channelizer, the single-bf16 matrix mode, on Hopper's
// warpgroup MMA (wgmma) with its operator tiles brought in by bulk copies.
//
// Replaces fm_radio_tpu/kernels/channelizer_pallas.py::_chan_core_t's
// single-bf16 Karatsuba body (splits == 2 on packed words, :133-153), as
// _chan_kernel_t_packed (:226) runs it.  The function is that of
// kernels/channelizer.py::channelize_bf16mat_plain: per capture w and
// column j of 128 wide samples,
//
//   P_g[o, j] = sum_{c < n_c, s < 128} A_{g,c}[o, s] * X_g[128 (j + c) + s]
//
// for the three Karatsuba operators A_0 = M_re, A_1 = M_im, A_2 = M_re +
// M_im (each rounded once to bf16 on the host) and the three ring planes
// X_0 = x_r, X_1 = x_i, X_2 = x_r + x_i (u8 - 127, exact bf16 integers)
// over the ring [zeros(base) | state | x]; P accumulated in float32; y_re =
// P1 - P2, y_im = (P3 - P1) - P2, then the output form (csrc/
// channelizer_mma.cu's header has the forms and the ring's geometry).  The
// tensor cores sum in their own order, so the kernel agrees with the plain
// version within float32 summation error (chip_smoke.py states the
// tolerance).
//
// It is one GEMM [128 x 128 n_c] x [128 n_c x J] per plane whose B operand
// is the stream itself: for shift c the B tile is the staged ring tile
// offset by c rows, so one staged tile serves all n_c shifts through the
// descriptors' start address, with no im2col copy.
//
// Design.  A CTA of three warpgroups is persistent, one a SM: it walks
// output tiles of 128 columns (ring rows [j0, j0 + 128 + tl)) of the
// captures, one tile of every gridDim.x.
// - Warpgroup 0 produces.  One thread streams the operator tiles: each
//   stage is one (plane g, shift c, 32 of the 128 inputs s) block of 128
//   rows, 8 KB, laid out on the host in wgmma's no-swizzle K-major core-
//   matrix layout (kernels/channelizer.py::wgmma_order), so one
//   cp.async.bulk moves it into a ring of n_a stages on mbarriers.  It
//   also prefetches the next tile's packed words into L2.  The other three warps unpack the next tile's
//   packed words (and the carried state) into the three bf16 ring planes
//   while the consumers run the products on the present one (n_ring = 2
//   ring stages where shared memory holds them: tl <= 8).
// - Warpgroups 1 and 2 consume: output rows 64 (wg - 1) .. + 63, all 128
//   columns, three m64n128 float32 accumulators (P1, P2, P3: 192 registers
//   a thread, after setmaxnreg moves the producer's registers to them).
//   Per operator stage two wgmma.mma_async m64n128k16, both operands in
//   shared memory; a stage is released once its wgmma group has completed
//   (wgmma.wait_group 1 after the next one is committed).
// - The epilogue stages each output plane through the finished ring stage
//   in shared memory and stores every channel row contiguously (16-byte
//   stores for the phase-split int8 form), as csrc/channelizer_mma.cu
//   does.  A second small launch writes the carried state.
//
// Operator bytes from L2 to the SMs per call: every tile streams all
// 3 x n_c x 32 KB of operators once, so at the wideband cell (W = 64, T =
// 2^22, n_c = 5: 16,384 tiles of 480 KB) 8.05 GB (kernels/channelizer.py::
// wgmma_operator_bytes), against 16.1 GB for csrc/channelizer_mma.cu's
// 32,768 CTAs of 64 columns.  Pairs of CTAs in a cluster, each copying
// half of every stage and multicasting it to both (4.03 GB), measured four
// times slower (PERF.md) and were dropped.
//
// What bounds it: the products, 1.03e12 bf16 FLOP at the wideband cell
// (1.04 ms at 989 TFLOP/s), against 1.5 GiB of words in and int8 out; the
// measured times are in PERF.md.

#include <cuda_bf16.h>

#include "bulk_copy.cuh"
#include "chan_common.cuh"

namespace fmt {

constexpr int kWgCols = 128;        // output columns (128 samples) a tile
constexpr int kWgThreads = 384;     // producer + two consumer warpgroups
constexpr int kUnpackThreads = 96;  // warps 1-3 of the producer warpgroup
constexpr int kAStage = 8192;       // bytes of one operator stage
constexpr int kAStagesPerShift = 4;  // 128 inputs s / 32 per stage
constexpr int kMaxAStages = 8;
constexpr int kStagingI8 = 144;  // bytes per staged int8 row (16-aligned)
constexpr int kStagingF32 = kWgCols + 1;  // floats per staged f32 row

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// an mbarrier that `count` arrivals complete
__device__ __forceinline__ void mbar_init_n(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(src),
               "r"(bytes)
               : "memory");
}

// wgmma shared-memory matrix descriptor, no swizzle (K-major core
// matrices of 8 rows x 16 bytes): start address, the byte offset between
// core matrices along K (lbo) and along M or N (sbo)
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of the accumulators across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], bf16 in, float32 sums, both
// operands K-major in shared memory; d is overwritten where accumulate is 0
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// named barrier of the two consumer warpgroups
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// The shared-memory plan of a launch (the host computes it; the kernel
// derives its offsets from it): n_ring ring stages of 3 planes, each plane
// 16 K-chunks x rows x 16 bytes, then n_a operator stages, then the
// barriers.
struct WgPlan {
  int tl, rows, n_ring, n_a;
  uint32_t plane_bytes, ring_bytes, smem_bytes;
};

inline WgPlan wg_plan(int m, int k_taps, int smem_limit) {
  WgPlan p{};
  const int n_state = (k_taps - 1) * m;
  p.tl = n_state > 128 ? (n_state + 127) / 128 : 1;
  p.rows = kWgCols + p.tl;
  p.plane_bytes = 256u * (uint32_t)p.rows;
  p.ring_bytes = 3 * p.plane_bytes;
  const int bars = 8 * 2 * (kMaxAStages + 2);
  const int two = (smem_limit - 2 * (int)p.ring_bytes - bars) / kAStage;
  if (two >= 3) {
    p.n_ring = 2;
    p.n_a = two < kMaxAStages ? two : kMaxAStages;
  } else {
    p.n_ring = 1;
    const int one = (smem_limit - (int)p.ring_bytes - bars) / kAStage;
    p.n_a = one < kMaxAStages ? one : kMaxAStages;
  }
  p.smem_bytes = p.n_ring * p.ring_bytes + p.n_a * kAStage + bars;
  return p;
}

// Unpack ring rows j0 - tl .. j0 + 127 of one capture into the three bf16
// planes of a ring stage: row r, inputs 8 kc .. 8 kc + 7 of plane g at
// g * plane_bytes + (kc * rows + r) * 16 (consecutive threads, consecutive
// rows: conflict-free 16-byte stores).  Sample t = 128 (j0 + r - tl) + s
// of the stream; t < 0 is the carried tail, zeros then the state.
__device__ __forceinline__ void unpack_ring(uint8_t* stage, const WgPlan& p,
                                            const float* __restrict__ xw,
                                            const float* __restrict__ srw,
                                            const float* __restrict__ siw,
                                            int64_t j0, int base, int u) {
  const int items = p.rows * 16;
  for (int it = u; it < items; it += kUnpackThreads) {
    const int kc = it / p.rows, r = it - kc * p.rows;
    const int64_t t = (j0 + r - p.tl) * 128 + kc * 8;  // t % 8 == 0
    float re[8], im[8];
    if (t >= 0) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(xw + t));
      const float4 b = __ldg(reinterpret_cast<const float4*>(xw + t + 4));
      const float w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float ihi = floorf(w[e] * (1.0f / 256.0f));
        re[e] = ihi - 127.0f;
        im[e] = (w[e] - ihi * 256.0f) - 127.0f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int v = (int)(t + e) + p.tl * 128;  // position in the tail
        re[e] = v < base ? 0.0f : srw[v - base];
        im[e] = v < base ? 0.0f : siw[v - base];
      }
    }
    uint4 q[3];
    q[0] = make_uint4(pack_bf16x2(re[0], re[1]), pack_bf16x2(re[2], re[3]),
                      pack_bf16x2(re[4], re[5]), pack_bf16x2(re[6], re[7]));
    q[1] = make_uint4(pack_bf16x2(im[0], im[1]), pack_bf16x2(im[2], im[3]),
                      pack_bf16x2(im[4], im[5]), pack_bf16x2(im[6], im[7]));
    float sm[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) sm[e] = re[e] + im[e];
    q[2] = make_uint4(pack_bf16x2(sm[0], sm[1]), pack_bf16x2(sm[2], sm[3]),
                      pack_bf16x2(sm[4], sm[5]), pack_bf16x2(sm[6], sm[7]));
    uint8_t* dst = stage + ((int64_t)kc * p.rows + r) * 16;
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      *reinterpret_cast<uint4*>(dst + g * p.plane_bytes) = q[g];
    }
  }
}

template <int kOut>
__global__ void __launch_bounds__(kWgThreads, 1)
chan_wgmma_kernel(const float* __restrict__ words,
                  const float* __restrict__ sr, const float* __restrict__ si,
                  const uint8_t* __restrict__ opers, WgPlan plan, int m,
                  int k_taps, int n_captures, int64_t t_len,
                  float* __restrict__ y_re, float* __restrict__ y_im,
                  int8_t* __restrict__ y8) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int n_state = (k_taps - 1) * m;
  const int base = plan.tl * 128 - n_state;
  const int n_c = plan.tl + 1;
  uint8_t* ring = smem;
  uint8_t* abuf = smem + plan.n_ring * plan.ring_bytes;
  uint64_t* a_full = reinterpret_cast<uint64_t*>(abuf + plan.n_a * kAStage);
  uint64_t* a_empty = a_full + kMaxAStages;
  uint64_t* r_full = a_empty + kMaxAStages;
  uint64_t* r_empty = r_full + 2;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < plan.n_a; ++s) {
      mbar_init_n(&a_full[s], 1);
      mbar_init_n(&a_empty[s], 2);
    }
    for (int r = 0; r < plan.n_ring; ++r) {
      mbar_init_n(&r_full[r], kUnpackThreads);
      mbar_init_n(&r_empty[r], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int64_t tiles_per_w = t_len / (128 * kWgCols);
  const int64_t n_tiles = (int64_t)n_captures * tiles_per_w;
  const int stages_per_tile = 3 * n_c * kAStagesPerShift;

  if (tid < 128) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int64_t nxt = tile + gridDim.x;
        if (nxt < n_tiles) {
          const int64_t w = nxt / tiles_per_w;
          const int64_t j0 = (nxt % tiles_per_w) * kWgCols;
          const int64_t t0 = (j0 - plan.tl) * 128 > 0 ? (j0 - plan.tl) * 128
                                                      : 0;
          prefetch_l2(words + w * t_len + t0,
                      (uint32_t)((j0 + kWgCols) * 128 - t0) * 4u);
        }
        for (int i = 0; i < stages_per_tile; ++i) {
          mbar_wait(&a_empty[s], ph ^ 1);
          mbar_expect(&a_full[s], kAStage);
          const uint8_t* src = opers + (int64_t)i * kAStage;
          bulk_g2s(abuf + s * kAStage, src, kAStage, &a_full[s]);
          if (++s == plan.n_a) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    } else if (tid >= 32) {
      const int u = tid - 32;
      int r = 0;
      uint32_t ph = 0;
      for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        mbar_wait(&r_empty[r], ph ^ 1);
        const int64_t w = tile / tiles_per_w;
        unpack_ring(ring + r * plan.ring_bytes, plan, words + w * t_len,
                    sr + w * n_state, si + w * n_state,
                    (tile % tiles_per_w) * kWgCols, base, u);
        fence_async_shared();
        mbar_arrive(&r_full[r]);
        if (++r == plan.n_ring) {
          r = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = (tid - 128) >> 7;  // output rows 64 wg .. 64 wg + 63
    const int lt = tid & 127;
    const int ct = tid - 128;  // 0 .. 255
    const int lane = tid & 31, wq = lt >> 5;
    const int channels = n_captures * m;
    const int q = 128 / m;
    const int64_t n_cols = t_len / 128, n_frames = t_len / m;
    const uint32_t a_base = smem_addr(abuf) + wg * 1024;
    float acc[3][64];
    int s = 0, prev = -1;
    uint32_t aph = 0;
    int r = 0;
    uint32_t rph = 0;
    for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      mbar_wait(&r_full[r], rph);
      uint8_t* stage = ring + r * plan.ring_bytes;
      const uint32_t rb = smem_addr(stage);
#pragma unroll
      for (int pg = 0; pg < 3; ++pg) {
        for (int c = 0; c < n_c; ++c) {
          for (int kh = 0; kh < kAStagesPerShift; ++kh) {
            mbar_wait(&a_full[s], aph);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
              const int ks = 2 * kh + kk;  // k16 step within the shift
              const uint64_t da =
                  wg_desc(a_base + s * kAStage + kk * 4096, 2048, 128);
              const uint64_t db =
                  wg_desc(rb + pg * plan.plane_bytes +
                              2 * ks * plan.rows * 16 + c * 16,
                          plan.rows * 16, 128);
              wgmma_m64n128k16(acc[pg], da, db, (c | kh | kk) != 0);
            }
            wgmma_commit();
            wgmma_wait<1>();
            if (prev >= 0 && lt == 0) mbar_arrive(&a_empty[prev]);
            prev = s;
            if (++s == plan.n_a) {
              s = 0;
              aph ^= 1;
            }
          }
        }
      }
      wgmma_wait<0>();
      if (lt == 0) mbar_arrive(&a_empty[prev]);
      prev = -1;
#pragma unroll
      for (int pg = 0; pg < 3; ++pg) fence_acc(acc[pg]);

      const int w = (int)(tile / tiles_per_w);
      const int64_t j0 = (tile % tiles_per_w) * kWgCols;
      float* stf = reinterpret_cast<float*>(stage);
      int8_t* st8 = reinterpret_cast<int8_t*>(stage);
      const int row0 = 64 * wg + 16 * wq + (lane >> 2);
      const int col0 = 2 * (lane & 3);
#pragma unroll
      for (int pi = 0; pi < 2; ++pi) {
        consumer_sync();  // the ring stage, or the previous plane, is free
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int o = row0 + 8 * ((i >> 1) & 1);
          const int j = 8 * (i >> 2) + col0 + (i & 1);
          const float p1 = acc[0][i], p2 = acc[1][i];
          const float v = pi == 0 ? p1 - p2 : (acc[2][i] - p1) - p2;
          if (kOut == kOutF32) {
            stf[o * kStagingF32 + j] = v;
          } else {
            st8[o * kStagingI8 + j] = chan_q8(v, 1.0f);
          }
        }
        consumer_sync();
        if (kOut == kOutI8PS) {
          // plane q' = rows q' M .. q' M + M - 1 (M = 32): 16 bytes a
          // thread
          for (int it = ct; it < 128 * (kWgCols / 16); it += 256) {
            const int o = it / (kWgCols / 16);
            const int jj = (it % (kWgCols / 16)) * 16;
            const int qp = o / m, ch = o % m;
            int8_t* dst = y8 +
                          ((int64_t)(pi * 4 + qp) * channels + w * m + ch) *
                              n_cols +
                          j0 + jj;
            *reinterpret_cast<uint4*>(dst) =
                *reinterpret_cast<const uint4*>(st8 + o * kStagingI8 + jj);
          }
        } else {
          // channel ch's frames q j0 .. q (j0 + 128) - 1: f = q j + q'
          const int run = kWgCols * q;
          for (int it = ct; it < 128 * kWgCols; it += 256) {
            const int ch = it / run, f = it % run;
            const int o = (f % q) * m + ch, j = f / q;
            const int64_t at = ((int64_t)w * m + ch) * n_frames + j0 * q + f;
            if (kOut == kOutF32) {
              (pi == 0 ? y_re : y_im)[at] = stf[o * kStagingF32 + j];
            } else {
              y8[(int64_t)pi * channels * n_frames + at] =
                  st8[o * kStagingI8 + j];
            }
          }
        }
      }
      consumer_sync();  // every read of the stage is done
      if (lt == 0) mbar_arrive(&r_empty[r]);
      if (++r == plan.n_ring) {
        r = 0;
        rph ^= 1;
      }
    }
  }
}

template <int kOut>
int chan_wgmma_launch(const float* words, const float* sr, const float* si,
                      const uint8_t* opers, int m, int k_taps,
                      int n_captures, int64_t t_len, float* y_re,
                      float* y_im, int8_t* y8, float* sr_out, float* si_out,
                      cudaStream_t stream) {
  int dev = 0, n_sm = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const WgPlan plan = wg_plan(m, k_taps, limit);
  if (plan.n_a < 2) return (int)cudaErrorInvalidConfiguration;
  auto kern = chan_wgmma_kernel<kOut>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)plan.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  // one persistent CTA a SM (its shared memory allows no second)
  const int64_t n_tiles = (int64_t)n_captures * (t_len / (128 * kWgCols));
  const unsigned grid = (unsigned)(n_tiles < n_sm ? n_tiles : n_sm);
  kern<<<grid, kWgThreads, plan.smem_bytes, stream>>>(
      words, sr, si, opers, plan, m, k_taps, n_captures, t_len, y_re, y_im,
      y8);
  FMT_CHECK_LAUNCH();
  const int n_state = (k_taps - 1) * m;
  if (n_state > 0) {
    chan_state_kernel<true>
        <<<blocks_for((int64_t)n_captures * n_state), kThreads, 0, stream>>>(
            words, nullptr, sr, si, n_state, n_captures, t_len, sr_out,
            si_out);
    FMT_CHECK_LAUNCH();
  }
  return 0;
}

}  // namespace fmt

using namespace fmt;

// All pointers are device pointers to contiguous tensors.  Returns the first
// cudaError_t of the launches (0 = all launched).
// words [W, T] packed u8 IQ (16-byte aligned); sr, si [W, (K-1)*M] carried
// state in, sr_out, si_out the same shape out (distinct buffers); opers the
// bf16 operators in stage order (kernels/channelizer.py::wgmma_order:
// [3, n_c, 4, 4, 128, 8], 16-byte aligned).  out 0: y_re, y_im [W, M, T/M]
// float32; out 1: y8 [2, W, M, T/M]; out 2 (M = 32): y8 [2, 4, W*M, T/128].
// Limits (the wrapper checks them too): M in {8, 16, 32, 64, 128},
// 1 <= K <= 17, T a multiple of 16384.
extern "C" int fmt_channelize_wgmma(const float* words, const float* sr,
                                    const float* si, const void* opers,
                                    int m, int k_taps, int n_captures,
                                    int64_t t_len, int out, float* y_re,
                                    float* y_im, int8_t* y8, float* sr_out,
                                    float* si_out, cudaStream_t stream) {
  if (m < 8 || m > 128 || 128 % m != 0 || k_taps < 1 || k_taps > 17 ||
      t_len <= 0 || t_len % (128 * kWgCols) != 0 || n_captures <= 0 ||
      out < kOutF32 || out > kOutI8PS || (out == kOutI8PS && m != 32)) {
    return (int)cudaErrorInvalidValue;
  }
  const uint8_t* o = static_cast<const uint8_t*>(opers);
  switch (out) {
    case kOutF32:
      return chan_wgmma_launch<kOutF32>(words, sr, si, o, m, k_taps,
                                        n_captures, t_len, y_re, y_im, y8,
                                        sr_out, si_out, stream);
    case kOutI8:
      return chan_wgmma_launch<kOutI8>(words, sr, si, o, m, k_taps,
                                       n_captures, t_len, y_re, y_im, y8,
                                       sr_out, si_out, stream);
    default:
      return chan_wgmma_launch<kOutI8PS>(words, sr, si, o, m, k_taps,
                                         n_captures, t_len, y_re, y_im, y8,
                                         sr_out, si_out, stream);
  }
}
