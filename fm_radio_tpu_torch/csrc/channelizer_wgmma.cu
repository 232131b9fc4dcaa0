// Polyphase FFT channelizer, the quantised-matrix modes, on Hopper's
// warpgroup MMA (wgmma) with their operator tiles brought in by bulk copies.
//
// Replaces fm_radio_tpu/kernels/channelizer_pallas.py::_chan_core_t's two
// matrix bodies, as _chan_kernel_t_packed (:226) runs them: the int8 body
// (splits == 1 on packed words, :104-132) and the single-bf16 Karatsuba
// body (splits == 2, :133-153).  Both fuse the phase filter and the DFT
// into n_c = tl + 1 operator matrices A_c [128 (o) x 128 (s)] built on the
// host (kernels/channelizer.py::fused_operators) and compute, per capture w
// and column j of 128 wide samples,
//
//   Y[o, j] = sum_{c < n_c, s < 128} A_c[o, s] * ring[128 (j + c) + s]
//
// over the ring [zeros(base) | state | x] (tl = max(ceil((K-1) M / 128), 1),
// base = 128 tl - (K-1) M).  That is one GEMM [128 x 128 n_c] x [128 n_c x
// J] per ring plane whose B operand is the stream itself: for shift c the B
// tile is the staged ring tile offset by c rows, so one staged tile serves
// all n_c shifts through the descriptors' start address, with no im2col
// copy.  Output o = q' M + k (q' < 128/M) of column j is channel k's frame
// (128/M) j + q'.
//
// - int8 (mode 1, kernels/channelizer.py::channelize_i8mat_plain): the ring
//   holds x_r, x_i = u8 - 128 as int8 (the carried state, u8 - 127
//   integers, enters as state - 1, truncated as the TPU kernel casts) and
//   the tables are A_re, A_im and -A_im, int8 at scale q_M (integer wgmma
//   has no negate, so -A_im is a table of its own; |A| <= 127, so the
//   negation is exact).  wgmma m64n128k32 s8 x s8 -> s32 accumulates y_re =
//   A_re x_r + (-A_im) x_i and y_im = A_im x_r + A_re x_i: the TPU kernel's
//   four products rr - ii and ri + ir, exact in int32 in any order.  The
//   epilogue is the plain version's, float32(acc) * (1/q_M) + corr[o], so
//   with -fmad=false the kernel equals the plain version bit for bit on
//   packed words (the unpack reads each word as an integer: a fractional
//   word, which no IQ stream holds, may differ).
// - bf16 (mode 2, channelize_bf16mat_plain): the three Karatsuba tables A_0
//   = M_re, A_1 = M_im, A_2 = M_re + M_im (each rounded once to bf16 on the
//   host) against the ring planes x_r, x_i, x_r + x_i (u8 - 127, exact bf16
//   integers); P accumulated in float32; y_re = P1 - P2, y_im = (P3 - P1) -
//   P2.  The tensor cores sum in their own order, so this mode agrees with
//   its plain version within float32 summation error (chip_smoke.py states
//   the tolerance).
//
// Outputs: float32 (y_re, y_im) [W, M, T/M] (unscaled: the tables for this
// form fold no 1/M), int8 [2, W, M, T/M] of clip(rint(y) - 1, -128, 127)
// (the 1/M folded into the tables), or at M = 32 phase-split int8
// [2, 4, W*M, T/128] (plane q' is output rows q' M .. q' M + M - 1, column
// j as it stands).
//
// Design.  A CTA of three warpgroups is persistent, one a SM: it walks
// output tiles of 128 columns (ring rows [j0, j0 + 128 + tl)) of the
// captures, one tile of every gridDim.x.
// - Warpgroup 0 produces.  One thread streams the operator tables: each
//   stage is 128 rows x 64 bytes, 8 KB (one table g, shift c and 32 bf16 or
//   64 int8 inputs s), laid out on the host in wgmma's no-swizzle K-major
//   core-matrix layout (kernels/channelizer.py::wgmma_order), so one
//   cp.async.bulk moves it into a ring of n_a stages on mbarriers.  It also
//   prefetches the next tile's packed words into L2.  The other three warps
//   unpack the next tile's packed words (and the carried state) into the
//   ring planes while the consumers run the products on the present one
//   (n_ring = 2 ring stages where shared memory holds them).
// - Warpgroups 1 and 2 consume: output rows 64 (wg - 1) .. + 63, all 128
//   columns, in m64n128 accumulators (bf16: P1, P2, P3 in float32, 192
//   registers a thread, after setmaxnreg moves the producer's registers to
//   them; int8: y_re, y_im in int32, 128).  Per operator stage two k-steps
//   of 32 bytes (bf16 m64n128k16, one product; int8 m64n128k32, two
//   products for A_re, one for A_im and -A_im), both operands in shared
//   memory; a stage is released once its wgmma group has completed
//   (wgmma.wait_group 1 after the next one is committed).
// - The epilogue stages each output plane through the finished ring stage
//   in shared memory (the int8 mode's float32 form, which a ring stage
//   cannot hold, through a staging area of its own) and stores every
//   channel row contiguously, 16 or 4 bytes a thread.  A second small
//   launch writes the carried state.
//
// Operator bytes from L2 to the SMs per call: every tile streams all of its
// tables once, 3 x n_c x 16 KB (int8) or 32 KB (bf16); at the wideband cell
// (W = 64, T = 2^22, n_c = 5: 16,384 tiles) 4.03 GB in int8 and 8.05 GB in
// bf16 (kernels/channelizer.py::wgmma_operator_bytes); the modes' earlier
// mma.sync kernels read their tables into each of 32,768 CTAs of 64
// columns, 5.37 GB in int8 (A_re and A_im) and 16.1 GB in bf16.  Pairs of
// CTAs in a cluster, each copying half of every stage and multicasting it
// to both, measured four times slower in bf16 (PERF.md) and were dropped.
//
// What bounds it: the products, at the wideband cell 1.37e12 int8
// operations (0.69 ms at 1,979 TOP/s) or 1.03e12 bf16 FLOP (1.04 ms at 989
// TFLOP/s), against 1.5 GiB of words in and int8 out; the measured times
// are in PERF.md.

#include <cuda_bf16.h>

#include "bulk_copy.cuh"
#include "chan_common.cuh"

namespace fmt {

constexpr int kWgCols = 128;        // output columns (128 samples) a tile
static_assert(kWgCols == 128, "the epilogue indexes a tile by shifts of 7");
constexpr int kWgThreads = 384;     // producer + two consumer warpgroups
constexpr int kUnpackThreads = 96;  // warps 1-3 of the producer warpgroup
constexpr int kAStage = 8192;       // bytes of one operator stage
constexpr int kMaxAStages = 16;
constexpr int kStagingI8 = 144;  // bytes per staged int8 row (16-aligned)
constexpr int kStagingF32 = kWgCols + 1;  // floats per staged f32 row

// The two matrix modes: bytes an input, ring planes, operator tables and
// accumulators.  A table's shift (128 inputs) is 2 * kElem stages of 64
// bytes of inputs, each two k-steps of 32 bytes.
template <int kMode>
struct WgMode;
template <>
struct WgMode<1> {  // int8: planes x_r, x_i; tables A_re, A_im, -A_im
  using Acc = int;
  static constexpr int kElem = 1, kPlanes = 2, kTables = 3, kAccs = 2;
};
template <>
struct WgMode<2> {  // bf16: planes x_r, x_i, x_r + x_i; three tables
  using Acc = float;
  static constexpr int kElem = 2, kPlanes = 3, kTables = 3, kAccs = 3;
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_i8(float v0, float v1, float v2,
                                            float v3) {
  // the centred value - 1, truncated to an integer as the TPU kernel's cast
  return (uint32_t)(uint8_t)(int8_t)(int)(v0 - 1.0f) |
         ((uint32_t)(uint8_t)(int8_t)(int)(v1 - 1.0f) << 8) |
         ((uint32_t)(uint8_t)(int8_t)(int)(v2 - 1.0f) << 16) |
         ((uint32_t)(uint8_t)(int8_t)(int)(v3 - 1.0f) << 24);
}

// a packed word's centred samples: u8 - 127 of its high (re) and low (im)
// byte
__device__ __forceinline__ void unpack_word(float w, float& re, float& im) {
  const float ihi = floorf(w * (1.0f / 256.0f));
  re = ihi - 127.0f;
  im = (w - ihi * 256.0f) - 127.0f;
}

// chan_q8(v, 1.0f), clip(rint(v) - 1, -128, 127), without the conversion
// unit: v clamped to +-2^22 plus 1.5 * 2^23 rounds half to even to an
// integer whose bits, less those of 1.5 * 2^23, are rint(v) (for |v| <=
// 2^22; a larger |v| clamps to the same end), and the clamp to the int8
// range runs on integers.  Equal to chan_q8 for every finite v (the
// epilogue's values are finite: float32 of a sum, times 1/q_M, plus a
// correction).
__device__ __forceinline__ int8_t q8_int(float v) {
  const float c = fminf(fmaxf(v, -4194304.0f), 4194304.0f);
  const int r = __float_as_int(c + 12582912.0f) - 0x4B400000;
  return (int8_t)(min(max(r, -127), 128) - 1);
}

// Four packed words -> their x_r and x_i bytes, u8 - 128 as int8, with one
// conversion a word: for an integer-valued word w (every packed word; so
// for all |w| < 2^31) pack_i8 of unpack_word's values truncates
// floor(w / 256) - 128 and (w mod 256) - 128 to a byte, which is bits
// 8..15, and 0..7, of w, each xor 0x80.
__device__ __forceinline__ void pack_words_i8(const float4& a, uint32_t& wr,
                                              uint32_t& wi) {
  const uint32_t w[4] = {(uint32_t)__float2int_rz(a.x),
                         (uint32_t)__float2int_rz(a.y),
                         (uint32_t)__float2int_rz(a.z),
                         (uint32_t)__float2int_rz(a.w)};
  uint32_t r = 0, i = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    r |= ((w[e] >> 8) & 0xFFu) << (8 * e);
    i |= (w[e] & 0xFFu) << (8 * e);
  }
  wr = r ^ 0x80808080u;
  wi = i ^ 0x80808080u;
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

// the 64 accumulator operands of an m64n128 wgmma, with constraint c
#define FMT_D8(c, d, i)                                                  \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), \
      c(d[i + 6]), c(d[i + 7])
#define FMT_D64(c, d)                                                      \
  FMT_D8(c, d, 0), FMT_D8(c, d, 8), FMT_D8(c, d, 16), FMT_D8(c, d, 24),    \
      FMT_D8(c, d, 32), FMT_D8(c, d, 40), FMT_D8(c, d, 48), FMT_D8(c, d, 56)
#define FMT_WG_D64                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// keep the compiler from moving accesses of the accumulators across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// One k-step of 32 bytes of K, both operands K-major in shared memory; d
// is overwritten where accumulate is 0.  bf16: d[64 x 128] (+)= A[64 x 16]
// B[16 x 128] in float32; int8: d[64 x 128] (+)= A[64 x 32] B[32 x 128] in
// int32 (exact).
__device__ __forceinline__ void wgmma_step(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FMT_WG_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FMT_D64("+f", d)
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_step(int (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " FMT_WG_D64
      ", %64, %65, p;\n}\n"
      : FMT_D64("+r", d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// named barrier of the two consumer warpgroups
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// The shared-memory plan of a launch (the host computes it; the kernel
// derives its offsets from it): n_ring ring stages of kPlanes planes, each
// plane (128 kElem / 16) K-chunks x rows x 16 bytes, then n_a operator
// stages, then the epilogue's staging area where a ring stage is too small
// for one output plane (the int8 mode's float32 form; staging_bytes 0: the
// epilogue stages through the finished ring stage), then the barriers.
struct WgPlan {
  int tl, rows, n_ring, n_a;
  uint32_t plane_bytes, ring_bytes, staging_bytes, smem_bytes;
};

template <int kMode, int kOut>
inline WgPlan wg_plan(int m, int k_taps, int smem_limit) {
  WgPlan p{};
  const int n_state = (k_taps - 1) * m;
  p.tl = n_state > 128 ? (n_state + 127) / 128 : 1;
  p.rows = kWgCols + p.tl;
  p.plane_bytes = 128u * WgMode<kMode>::kElem * (uint32_t)p.rows;
  p.ring_bytes = WgMode<kMode>::kPlanes * p.plane_bytes;
  const uint32_t staged = kOut == kOutF32 ? 128u * kStagingF32 * 4u
                                          : 128u * kStagingI8;
  p.staging_bytes = staged > p.ring_bytes ? staged : 0u;
  const int bars = 8 * 2 * (kMaxAStages + 2);
  const int fixed = (int)p.staging_bytes + bars;
  const int two = (smem_limit - 2 * (int)p.ring_bytes - fixed) / kAStage;
  if (two >= 3) {
    p.n_ring = 2;
    p.n_a = two < kMaxAStages ? two : kMaxAStages;
  } else {
    p.n_ring = 1;
    const int one = (smem_limit - (int)p.ring_bytes - fixed) / kAStage;
    p.n_a = one < kMaxAStages ? one : kMaxAStages;
  }
  p.smem_bytes =
      p.n_ring * p.ring_bytes + p.n_a * kAStage + p.staging_bytes + bars;
  return p;
}

// Unpack ring rows j0 - tl .. j0 + 127 of one capture into the planes of a
// ring stage: row r, K-chunk kc (16 bytes) of plane g at g * plane_bytes +
// (kc * rows + r) * 16 (consecutive threads, consecutive rows:
// conflict-free 16-byte stores).  Sample t = 128 (j0 + r - tl) + s of the
// stream; t < 0 is the carried tail, zeros then the state.  xw holds n_x
// samples, srw and siw the state's n_state.
//
// bf16: three planes, 8 inputs a chunk; the producer warpgroup's threads
// run on 40 registers.
__device__ __forceinline__ void unpack_ring_bf16(
    uint8_t* stage, const WgPlan& p, const float* __restrict__ xw,
    int64_t n_x, const float* __restrict__ srw,
    const float* __restrict__ siw, int n_state, int64_t j0, int base,
    int u) {
  const int items = p.rows * 16;
  for (int it = u; it < items; it += kUnpackThreads) {
    const int kc = it / p.rows, r = it - kc * p.rows;
    const int64_t t = (j0 + r - p.tl) * 128 + kc * 8;  // t % 8 == 0
    float re[8], im[8];
    if (t >= 0) {
      const float4* src =
          reinterpret_cast<const float4*>(FMT_SPAN(xw, t, 8, n_x));
      const float4 a = __ldg(src);
      const float4 b = __ldg(src + 1);
      const float w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) unpack_word(w[e], re[e], im[e]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int v = (int)(t + e) + p.tl * 128;  // position in the tail
        re[e] = v < base ? 0.0f : FMT_AT(srw, v - base, n_state);
        im[e] = v < base ? 0.0f : FMT_AT(siw, v - base, n_state);
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

// int8: two planes, 16 inputs a chunk.  The producer warpgroup keeps its
// registers (the consumers' accumulators fit without them), so a thread
// issues the loads of kI8Depth chunks before it converts the first: their
// latency is paid once.
constexpr int kI8Depth = 4;

__device__ __forceinline__ void unpack_ring_i8(
    uint8_t* stage, const WgPlan& p, const float* __restrict__ xw,
    int64_t n_x, const float* __restrict__ srw,
    const float* __restrict__ siw, int n_state, int64_t j0, int base,
    int u) {
  const int items = p.rows * 8;
  for (int it0 = u; it0 < items; it0 += kI8Depth * kUnpackThreads) {
    float4 a[kI8Depth][4];
#pragma unroll
    for (int d = 0; d < kI8Depth; ++d) {
      const int it = it0 + d * kUnpackThreads;
      const int kc = it / p.rows, r = it - kc * p.rows;
      const int64_t t = (j0 + r - p.tl) * 128 + kc * 16;
      if (it < items && t >= 0) {
        const float4* src =
            reinterpret_cast<const float4*>(FMT_SPAN(xw, t, 16, n_x));
#pragma unroll
        for (int k = 0; k < 4; ++k) a[d][k] = __ldg(src + k);
      }
    }
#pragma unroll
    for (int d = 0; d < kI8Depth; ++d) {
      const int it = it0 + d * kUnpackThreads;
      if (it >= items) break;
      const int kc = it / p.rows, r = it - kc * p.rows;
      const int64_t t = (j0 + r - p.tl) * 128 + kc * 16;  // t % 16 == 0
      uint32_t wr[4], wi[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (t >= 0) {
          pack_words_i8(a[d][k], wr[k], wi[k]);
        } else {
          float re[4], im[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int v = (int)(t + 4 * k + e) + p.tl * 128;  // in the tail
            re[e] = v < base ? 0.0f : FMT_AT(srw, v - base, n_state);
            im[e] = v < base ? 0.0f : FMT_AT(siw, v - base, n_state);
          }
          wr[k] = pack_i8(re[0], re[1], re[2], re[3]);
          wi[k] = pack_i8(im[0], im[1], im[2], im[3]);
        }
      }
      uint8_t* dst = stage + ((int64_t)kc * p.rows + r) * 16;
      *reinterpret_cast<uint4*>(dst) = make_uint4(wr[0], wr[1], wr[2], wr[3]);
      *reinterpret_cast<uint4*>(dst + p.plane_bytes) =
          make_uint4(wi[0], wi[1], wi[2], wi[3]);
    }
  }
}

// The tile's ring rows into a ring stage (unpack_ring_i8 or _bf16)
template <int kMode>
__device__ __forceinline__ void unpack_tile(
    uint8_t* stage, const WgPlan& p, const float* __restrict__ words,
    const float* __restrict__ sr, const float* __restrict__ si, int n_state,
    int64_t t_len, int64_t tile, int64_t tiles_per_w, int base, int u) {
  const int64_t w = tile / tiles_per_w;
  const int64_t j0 = (tile % tiles_per_w) * kWgCols;
  if constexpr (kMode == 1) {
    unpack_ring_i8(stage, p, words + w * t_len, t_len, sr + w * n_state,
                   si + w * n_state, n_state, j0, base, u);
  } else {
    unpack_ring_bf16(stage, p, words + w * t_len, t_len, sr + w * n_state,
                     si + w * n_state, n_state, j0, base, u);
  }
}

// aux (int8 mode): float32 [3, 128], 1/q_M then the corrections of y_re
// and y_im per output row; null in the bf16 mode
template <int kMode, int kOut>
__global__ void __launch_bounds__(kWgThreads, 1)
chan_wgmma_kernel(const float* __restrict__ words,
                  const float* __restrict__ sr, const float* __restrict__ si,
                  const uint8_t* __restrict__ opers,
                  const float* __restrict__ aux, WgPlan plan, int m,
                  int k_taps, int n_captures, int64_t t_len,
                  float* __restrict__ y_re, float* __restrict__ y_im,
                  int8_t* __restrict__ y8) {
  using Mode = WgMode<kMode>;
  using Acc = typename Mode::Acc;
  constexpr int kStagesPerShift = 2 * Mode::kElem;
  extern __shared__ __align__(128) uint8_t smem[];
  const int n_state = (k_taps - 1) * m;
  const int base = plan.tl * 128 - n_state;
  const int n_c = plan.tl + 1;
  uint8_t* ring = smem;
  uint8_t* abuf = smem + plan.n_ring * plan.ring_bytes;
  uint8_t* staging = abuf + plan.n_a * kAStage;  // if staging_bytes > 0
  uint64_t* a_full =
      reinterpret_cast<uint64_t*>(staging + plan.staging_bytes);
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
  const int stages_per_tile = Mode::kTables * n_c * kStagesPerShift;

  if (tid < 128) {
    // ---- producer warpgroup ----
    // bf16: the consumers' three accumulators need the producer's
    // registers; int8's two fit the launch's 168 a thread, so the
    // unpacking threads keep theirs for loads in flight
    if constexpr (kMode == 2) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    }
    if (tid == 0) {
      const int64_t n_opers = (int64_t)stages_per_tile * kAStage;
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
          const uint8_t* src =
              FMT_SPAN(opers, (int64_t)i * kAStage, kAStage, n_opers);
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
        unpack_tile<kMode>(ring + r * plan.ring_bytes, plan, words, sr, si,
                           n_state, t_len, tile, tiles_per_w, base, u);
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
    if constexpr (kMode == 2) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    }
    const int wg = (tid - 128) >> 7;  // output rows 64 wg .. 64 wg + 63
    const int lt = tid & 127;
    const int ct = tid - 128;  // 0 .. 255
    const int lane = tid & 31, wq = lt >> 5;
    const int channels = n_captures * m;
    // m and q = 128 / m are powers of two: index by shifts and masks
    const int lm = 31 - __clz(m), lq = 7 - lm, q = 1 << lq;
    const int64_t n_cols = t_len / 128, n_frames = t_len / m;
    const int64_t n_y = (int64_t)channels * n_frames;
    const uint32_t a_base = smem_addr(abuf) + wg * 1024;
    // this thread's rows: row0 and row0 + 8
    const int row0 = 64 * wg + 16 * wq + (lane >> 2);
    const int col0 = 2 * (lane & 3);
    float inv_q = 0.0f, corr[2][2] = {};
    if constexpr (kMode == 1) {
      inv_q = FMT_AT(aux, 0, 384);
#pragma unroll
      for (int pi = 0; pi < 2; ++pi) {
        corr[pi][0] = FMT_AT(aux, 128 * (pi + 1) + row0, 384);
        corr[pi][1] = FMT_AT(aux, 128 * (pi + 1) + row0 + 8, 384);
      }
    }
    Acc acc[Mode::kAccs][64];
    int s = 0, prev = -1;
    uint32_t aph = 0;
    int r = 0;
    uint32_t rph = 0;
    for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      mbar_wait(&r_full[r], rph);
      uint8_t* stage = ring + r * plan.ring_bytes;
      const uint32_t rb = smem_addr(stage);
#pragma unroll
      for (int g = 0; g < Mode::kTables; ++g) {
        for (int c = 0; c < n_c; ++c) {
          for (int kh = 0; kh < kStagesPerShift; ++kh) {
            mbar_wait(&a_full[s], aph);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
              const int ks = 2 * kh + kk;  // k-step of 32 bytes in the shift
              const uint64_t da =
                  wg_desc(a_base + s * kAStage + kk * 4096, 2048, 128);
              auto db = [&](int pl) {
                return wg_desc(rb + pl * plan.plane_bytes +
                                   2 * ks * plan.rows * 16 + c * 16,
                               plan.rows * 16, 128);
              };
              const int more = (c | kh | kk) != 0;
              if constexpr (kMode == 2) {
                wgmma_step(acc[g], da, db(g), more);
              } else if (g == 0) {  // A_re: x_r -> y_re, x_i -> y_im
                wgmma_step(acc[0], da, db(0), more);
                wgmma_step(acc[1], da, db(1), more);
              } else if (g == 1) {  // A_im: x_r -> y_im
                wgmma_step(acc[1], da, db(0), 1);
              } else {  // -A_im: x_i -> y_re
                wgmma_step(acc[0], da, db(1), 1);
              }
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
      for (int g = 0; g < Mode::kAccs; ++g) fence_acc(acc[g]);
      // with a staging area of its own (wg_plan: the int8 mode's float32
      // form) the epilogue no longer needs the ring stage: release it now
      constexpr bool kOwnStaging = kMode == 1 && kOut == kOutF32;
      if (kOwnStaging && lt == 0) mbar_arrive(&r_empty[r]);

      const int w = (int)(tile / tiles_per_w);
      const int64_t j0 = (tile % tiles_per_w) * kWgCols;
      uint8_t* st = kOwnStaging ? staging : stage;
      float* stf = reinterpret_cast<float*>(st);
      int8_t* st8 = reinterpret_cast<int8_t*>(st);
#pragma unroll
      for (int pi = 0; pi < 2; ++pi) {
        consumer_sync();  // the stage, or the previous plane, is free
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int hi = (i >> 1) & 1;
          const int o = row0 + 8 * hi;
          const int j = 8 * (i >> 2) + col0 + (i & 1);
          float v;
          if constexpr (kMode == 1) {
            v = __int2float_rn(acc[pi][i]) * inv_q + corr[pi][hi];
          } else {
            const float p1 = acc[0][i], p2 = acc[1][i];
            v = pi == 0 ? p1 - p2 : (acc[2][i] - p1) - p2;
          }
          if (kOut == kOutF32) {
            stf[o * kStagingF32 + j] = v;
          } else if constexpr (kMode == 1) {
            st8[o * kStagingI8 + j] = q8_int(v);
          } else {
            st8[o * kStagingI8 + j] = chan_q8(v, 1.0f);
          }
        }
        consumer_sync();
        if (kOut == kOutI8PS) {
          // plane q' = rows q' M .. q' M + M - 1 (M = 32): 16 bytes a
          // thread
          for (int it = ct; it < 128 * (kWgCols / 16); it += 256) {
            const int o = it >> 3;  // kWgCols / 16 = 8 chunks a row
            const int jj = (it & 7) * 16;
            const int qp = o >> lm, ch = o & (m - 1);
            const int64_t at =
                ((int64_t)(pi * 4 + qp) * channels + w * m + ch) * n_cols +
                j0 + jj;
            *reinterpret_cast<uint4*>(FMT_SPAN(y8, at, 16, 2 * n_y)) =
                *reinterpret_cast<const uint4*>(st8 + o * kStagingI8 + jj);
          }
        } else {
          // channel ch's frames q j0 .. q (j0 + 128) - 1 (f = q j + q',
          // staged row q' M + ch, column j), four frames a thread: one
          // 16-byte or 4-byte store
          const int run4 = kWgCols * q / 4;
          for (int it = ct; it < m * run4; it += 256) {
            const int ch = it >> (5 + lq), f = (it & (run4 - 1)) * 4;
            const int64_t at = ((int64_t)w * m + ch) * n_frames + j0 * q + f;
            auto so = [&](int e) { return (((f + e) & (q - 1)) << lm) + ch; };
            auto sj = [&](int e) { return (f + e) >> lq; };
            if (kOut == kOutF32) {
              float v[4];
#pragma unroll
              for (int e = 0; e < 4; ++e)
                v[e] = stf[so(e) * kStagingF32 + sj(e)];
              *reinterpret_cast<float4*>(
                  FMT_SPAN(pi == 0 ? y_re : y_im, at, 4, n_y)) =
                  make_float4(v[0], v[1], v[2], v[3]);
            } else {
              uint32_t b = 0;
#pragma unroll
              for (int e = 0; e < 4; ++e)
                b |= (uint32_t)(uint8_t)st8[so(e) * kStagingI8 + sj(e)]
                     << (8 * e);
              *reinterpret_cast<uint32_t*>(
                  FMT_SPAN(y8, (int64_t)pi * n_y + at, 4, 2 * n_y)) = b;
            }
          }
        }
      }
      consumer_sync();  // every read of the staged planes is done
      if (!kOwnStaging && lt == 0) mbar_arrive(&r_empty[r]);
      if (++r == plan.n_ring) {
        r = 0;
        rph ^= 1;
      }
    }
  }
}

template <int kMode, int kOut>
int chan_wgmma_launch(const float* words, const float* sr, const float* si,
                      const uint8_t* opers, const float* aux, int m,
                      int k_taps, int n_captures, int64_t t_len, float* y_re,
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
  const WgPlan plan = wg_plan<kMode, kOut>(m, k_taps, limit);
  if (plan.n_a < 2) return (int)cudaErrorInvalidConfiguration;
  auto kern = chan_wgmma_kernel<kMode, kOut>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)plan.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  // one persistent CTA a SM (its shared memory allows no second)
  const int64_t n_tiles = (int64_t)n_captures * (t_len / (128 * kWgCols));
  const unsigned grid = (unsigned)(n_tiles < n_sm ? n_tiles : n_sm);
  kern<<<grid, kWgThreads, plan.smem_bytes, stream>>>(
      words, sr, si, opers, aux, plan, m, k_taps, n_captures, t_len, y_re,
      y_im, y8);
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

template <int kMode>
int chan_wgmma_dispatch(int out, const float* words, const float* sr,
                        const float* si, const uint8_t* opers,
                        const float* aux, int m, int k_taps, int n_captures,
                        int64_t t_len, float* y_re, float* y_im, int8_t* y8,
                        float* sr_out, float* si_out, cudaStream_t stream) {
  switch (out) {
    case kOutF32:
      return chan_wgmma_launch<kMode, kOutF32>(
          words, sr, si, opers, aux, m, k_taps, n_captures, t_len, y_re,
          y_im, y8, sr_out, si_out, stream);
    case kOutI8:
      return chan_wgmma_launch<kMode, kOutI8>(
          words, sr, si, opers, aux, m, k_taps, n_captures, t_len, y_re,
          y_im, y8, sr_out, si_out, stream);
    default:
      return chan_wgmma_launch<kMode, kOutI8PS>(
          words, sr, si, opers, aux, m, k_taps, n_captures, t_len, y_re,
          y_im, y8, sr_out, si_out, stream);
  }
}

}  // namespace fmt

using namespace fmt;

// All pointers are device pointers to contiguous tensors.  Returns the first
// cudaError_t of the launches (0 = all launched).
// words [W, T] packed u8 IQ (16-byte aligned); sr, si [W, (K-1)*M] carried
// state in, sr_out, si_out the same shape out (distinct buffers); opers the
// tables in stage order (kernels/channelizer.py::wgmma_order, 16-byte
// aligned): mode 1 int8 [3, n_c, 2, 4, 128, 16] (A_re, A_im, -A_im), with
// aux [3, 128] float32 (1/q_M, corr_re, corr_im); mode 2 bf16 [3, n_c, 4,
// 4, 128, 8], aux null.  out 0: y_re, y_im [W, M, T/M] float32; out 1: y8
// [2, W, M, T/M]; out 2 (M = 32): y8 [2, 4, W*M, T/128].
// Limits (the wrapper checks them too): mode 1 or 2, M in {8, 16, 32, 64,
// 128}, 1 <= K <= 17, T a multiple of 16384.
extern "C" int fmt_channelize_wgmma(const float* words, const float* sr,
                                    const float* si, const void* opers,
                                    const float* aux, int mode, int m,
                                    int k_taps, int n_captures,
                                    int64_t t_len, int out, float* y_re,
                                    float* y_im, int8_t* y8, float* sr_out,
                                    float* si_out, cudaStream_t stream) {
  if ((mode != 1 && mode != 2) || (mode == 1 && aux == nullptr) || m < 8 ||
      m > 128 || 128 % m != 0 || k_taps < 1 || k_taps > 17 || t_len <= 0 ||
      t_len % (128 * kWgCols) != 0 || n_captures <= 0 || out < kOutF32 ||
      out > kOutI8PS || (out == kOutI8PS && m != 32)) {
    return (int)cudaErrorInvalidValue;
  }
  const uint8_t* o = static_cast<const uint8_t*>(opers);
  if (mode == 1) {
    return chan_wgmma_dispatch<1>(out, words, sr, si, o, aux, m, k_taps,
                                  n_captures, t_len, y_re, y_im, y8, sr_out,
                                  si_out, stream);
  }
  return chan_wgmma_dispatch<2>(out, words, sr, si, o, aux, m, k_taps,
                                n_captures, t_len, y_re, y_im, y8, sr_out,
                                si_out, stream);
}
