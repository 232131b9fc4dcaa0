// Polyphase FFT channelizer, the int8-matrix mode, on Hopper's tensor cores.
//
// Replaces fm_radio_tpu/kernels/channelizer_pallas.py::_chan_core_t's int8
// body (splits == 1 on packed words, :104-132), as _chan_kernel_t_packed
// (:226) runs it; its single-bf16 body (splits == 2) is
// csrc/channelizer_wgmma.cu, on the same operators and ring.  Both fuse the
// phase filter and the DFT into n_c = tl + 1 operator matrices A_c [128 (o) x 128 (s)] built on the host
// (kernels/channelizer.py::fused_operators) and compute, per capture w and
// column j of 128 wide samples,
//
//   Y[o, j] = sum_{c < n_c, s < 128} A_c[o, s] * ring[128 (j + c) + s]
//
// over the ring [zeros(base) | state | x] (tl = max(ceil((K-1) M / 128), 1),
// base = 128 tl - (K-1) M).  That is one GEMM [128 x 128 n_c] x
// [128 n_c x J] whose B operand is the stream itself: column j is the
// contiguous window at sample 128 j of the ring, so B needs no im2col copy.
// Output o = q' M + k (q' < 128/M) of column j is channel k's frame
// (128/M) j + q'.
//
// - int8 (mode 1): the ring holds u8 - 128 as int8 (the carried state, u8 -
//   127 integers, enters as state - 1) and A int8 at scale q_M.
//   mma.sync m16n8k32 s8 x s8 -> s32 accumulates y_re = A_re x_r +
//   (-A_im) x_i and y_im = A_im x_r + A_re x_i: the TPU kernel's four
//   products rr - ii and ri + ir, exact in int32 in any order (|A| <= 127, so
//   the negation is exact).  The epilogue is the plain version's:
//   float32(acc) * (1/q_M) + corr[o], then the output form; with
//   -fmad=false the kernel equals kernels/channelizer.py::
//   channelize_i8mat_plain bit for bit.
//
// Outputs as csrc/channelizer.cu: float32 (y_re, y_im) [W, M, T/M]
// (unscaled: the tables for this form fold no 1/M), int8 [2, W, M, T/M] of
// clip(rint(y) - 1, -128, 127) (the 1/M folded into the tables), or at
// M = 32 phase-split int8 [2, 4, W*M, T/128] (plane q' is output rows
// q' M .. q' M + M - 1, column j as it stands).
//
// Design (mma.sync; csrc/channelizer_wgmma.cu is the wgmma form of the
// bf16 mode): a CTA of 8 warps
// takes one capture and kTileCols = 64 output columns.  It stages its
// 64 + tl ring columns from the packed words (and the carried state) into
// shared memory as rows of 128 elements, padded by 16 bytes so that the
// B-fragment loads (rows g = 0..7, 4-byte words t = 0..3 of a lane) fall in
// 32 distinct banks.  Warp (i, h) owns output rows 32 i .. 32 i + 31 and
// columns 32 h .. 32 h + 31: 2 x 4 m16n8 tiles.  A is read from device
// memory (it stays in L1/L2: 160 KB at n_c = 5) in the
// order the host laid it out (kernels/channelizer.py::frag_order), one
// 16-byte load per lane per fragment.  The epilogue stages each output
// plane through shared memory so that every channel row is stored
// contiguously.  A second small launch writes the carried state.
//
// What bounds it: at the wideband cell (W = 64, M = 32, K = 16, T = 2^22)
// the products are 1.37e12 int8 operations (0.69 ms at 1,979 TOP/s) against
// 1.5 GiB of words in and int8 out (0.48 ms); the measured times are in
// PERF.md.

#include "chan_common.cuh"

namespace fmt {

constexpr int kMmaThreads = 256;  // 8 warps: 4 row groups x 2 column groups
constexpr int kTileCols = 64;     // output columns (128 samples each) a CTA
constexpr int kRowPad = 16;       // bytes after each 128-element smem row

template <int kMode>
struct MatMode;
template <>
struct MatMode<1> {  // int8: planes re, im
  static constexpr int kElem = 1, kPlanes = 2, kMinBlocks = 2;
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_i8(float v0, float v1, float v2,
                                            float v3) {
  // the centred value - 1, truncated to an integer as the TPU kernel's cast
  return (uint32_t)(uint8_t)(int8_t)(int)(v0 - 1.0f) |
         ((uint32_t)(uint8_t)(int8_t)(int)(v1 - 1.0f) << 8) |
         ((uint32_t)(uint8_t)(int8_t)(int)(v2 - 1.0f) << 16) |
         ((uint32_t)(uint8_t)(int8_t)(int)(v3 - 1.0f) << 24);
}

// Stage ring columns j0 .. j0 + rows - 1 of one capture into shared memory,
// plane p at smem + p * rows * S, row r at + r * S: sample t = 128 (j0 + r -
// tl) + s of the stream (t < 0: the carried tail, zeros then the state).
template <int kMode>
__device__ __forceinline__ void stage_ring(uint8_t* smem,
                                           const float* __restrict__ xw,
                                           const float* __restrict__ srw,
                                           const float* __restrict__ siw,
                                           int64_t j0, int rows, int tl,
                                           int base) {
  constexpr int E = MatMode<kMode>::kElem;
  constexpr int S = 128 * E + kRowPad;
  const int plane = rows * S;
  for (int it = threadIdx.x; it < rows * 32; it += kMmaThreads) {
    const int r = it >> 5, s = (it & 31) * 4;
    const int64_t t = (j0 + r - tl) * 128 + s;  // t % 4 == 0
    float re[4], im[4];
    if (t >= 0) {
      const float4 w4 = __ldg(reinterpret_cast<const float4*>(xw + t));
      const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ihi = floorf(w[e] * (1.0f / 256.0f));
        re[e] = ihi - 127.0f;
        im[e] = (w[e] - ihi * 256.0f) - 127.0f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = (int)(t + e) + tl * 128;  // position in the tail
        re[e] = u < base ? 0.0f : srw[u - base];
        im[e] = u < base ? 0.0f : siw[u - base];
      }
    }
    uint8_t* row = smem + r * S + s * E;
    *reinterpret_cast<uint32_t*>(row) = pack_i8(re[0], re[1], re[2], re[3]);
    *reinterpret_cast<uint32_t*>(row + plane) =
        pack_i8(im[0], im[1], im[2], im[3]);
  }
}

// Write the CTA's output tile: for each plane (re, im), the warps' fragment
// values value(pi, ot, jt, e) (rows (ot0 + ot) * 16 + g + 8 (e >> 1),
// columns jw + 8 jt + 2 t + (e & 1)) go through shared memory, then every
// channel row of the tile is stored contiguously.
template <int kOut, typename Value>
__device__ __forceinline__ void store_tile(uint8_t* smem, Value value,
                                           int ot0, int jw, int m, int w,
                                           int64_t j0, int64_t t_len,
                                           float* __restrict__ y_re,
                                           float* __restrict__ y_im,
                                           int8_t* __restrict__ y8) {
  constexpr int SF = kTileCols + 1;  // floats per staged row
  constexpr int S8 = kTileCols + 4;  // bytes per staged row
  float* stf = reinterpret_cast<float*>(smem);
  int8_t* st8 = reinterpret_cast<int8_t*>(smem);
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int q = 128 / m;
  const int channels = gridDim.y * m;
  const int64_t n_cols = t_len / 128, n_frames = t_len / m;
  // unrolled, so that value() indexes the accumulators with constants
#pragma unroll
  for (int pi = 0; pi < 2; ++pi) {
    __syncthreads();  // the ring, or the previous plane, is no longer read
#pragma unroll
    for (int ot = 0; ot < 2; ++ot) {
#pragma unroll
      for (int jt = 0; jt < 4; ++jt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = (ot0 + ot) * 16 + g + 8 * (e >> 1);
          const int j = jw + jt * 8 + tq * 2 + (e & 1);
          const float v = value(pi, ot, jt, e);
          if (kOut == kOutF32) {
            stf[o * SF + j] = v;
          } else {
            st8[o * S8 + j] = chan_q8(v, 1.0f);
          }
        }
      }
    }
    __syncthreads();
    if (kOut == kOutI8PS) {
      // plane q' = rows q' M .. q' M + M - 1 (M = 32), 4 columns a thread
      for (int it = threadIdx.x; it < 128 * (kTileCols / 4);
           it += kMmaThreads) {
        const int o = it / (kTileCols / 4), j = (it % (kTileCols / 4)) * 4;
        const int qp = o / m, ch = o % m;
        int8_t* dst = y8 + ((int64_t)(pi * 4 + qp) * channels + w * m + ch) *
                               n_cols + j0 + j;
        *reinterpret_cast<uint32_t*>(dst) =
            *reinterpret_cast<const uint32_t*>(st8 + o * S8 + j);
      }
    } else {
      // channel ch's frames q j0 .. q (j0 + 64) - 1: f = q j + q'
      const int run = kTileCols * q;
      for (int it = threadIdx.x; it < 128 * kTileCols; it += kMmaThreads) {
        const int ch = it / run, f = it % run;
        const int o = (f % q) * m + ch, j = f / q;
        const int64_t at = ((int64_t)w * m + ch) * n_frames + j0 * q + f;
        if (kOut == kOutF32) {
          (pi == 0 ? y_re : y_im)[at] = stf[o * SF + j];
        } else {
          y8[(int64_t)pi * channels * n_frames + at] = st8[o * S8 + j];
        }
      }
    }
  }
}

template <int kMode, int kOut>
__global__ void __launch_bounds__(kMmaThreads, MatMode<kMode>::kMinBlocks)
chan_mma_kernel(const float* __restrict__ words, const float* __restrict__ sr,
                const float* __restrict__ si, const uint4* __restrict__ frag,
                const float* __restrict__ aux, int m, int k_taps,
                int64_t t_len, float* __restrict__ y_re,
                float* __restrict__ y_im, int8_t* __restrict__ y8) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int E = MatMode<kMode>::kElem;
  constexpr int S = 128 * E + kRowPad;
  constexpr int kSteps = 128 * E / 32;  // k-steps (32 bytes) per shift c
  const int n_state = (k_taps - 1) * m;
  const int tl = n_state > 128 ? (n_state + 127) / 128 : 1;
  const int n_ks = (tl + 1) * kSteps;
  const int rows = kTileCols + tl;
  const int plane = rows * S;
  const int w = blockIdx.y;
  const int64_t j0 = (int64_t)blockIdx.x * kTileCols;
  stage_ring<kMode>(smem, words + (int64_t)w * t_len,
                    sr + (int64_t)w * n_state, si + (int64_t)w * n_state, j0,
                    rows, tl, tl * 128 - n_state);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int ot0 = (warp & 3) * 2;   // the warp's two 16-row tiles
  const int jw = (warp >> 2) * 32;  // its first of 32 columns
  const uint8_t* bcol = smem + (jw + g) * S + tq * 4;

  {
    int acc[2][2][4][4] = {};  // [re, im][row tile][column tile][fragment]
    for (int ks = 0; ks < n_ks; ++ks) {
      const int c = ks / kSteps, kb = (ks % kSteps) * 32;
      uint4 are[2], aim[2], anim[2];
#pragma unroll
      for (int ot = 0; ot < 2; ++ot) {
        are[ot] = __ldg(frag + ((int64_t)ks * 8 + ot0 + ot) * 32 + lane);
        aim[ot] = __ldg(frag + ((int64_t)(n_ks + ks) * 8 + ot0 + ot) * 32 +
                        lane);
        anim[ot] = make_uint4(__vneg4(aim[ot].x), __vneg4(aim[ot].y),
                              __vneg4(aim[ot].z), __vneg4(aim[ot].w));
      }
#pragma unroll
      for (int jt = 0; jt < 4; ++jt) {
        const uint8_t* b = bcol + (jt * 8 + c) * S + kb;
        const uint32_t xr0 = *reinterpret_cast<const uint32_t*>(b);
        const uint32_t xr1 = *reinterpret_cast<const uint32_t*>(b + 16);
        const uint32_t xi0 = *reinterpret_cast<const uint32_t*>(b + plane);
        const uint32_t xi1 =
            *reinterpret_cast<const uint32_t*>(b + plane + 16);
#pragma unroll
        for (int ot = 0; ot < 2; ++ot) {
          mma_s8(acc[0][ot][jt], are[ot], xr0, xr1);
          mma_s8(acc[0][ot][jt], anim[ot], xi0, xi1);
          mma_s8(acc[1][ot][jt], aim[ot], xr0, xr1);
          mma_s8(acc[1][ot][jt], are[ot], xi0, xi1);
        }
      }
    }
    const float inv_q = __ldg(aux);
    auto value = [&](int pi, int ot, int jt, int e) {
      const int o = (ot0 + ot) * 16 + g + 8 * (e >> 1);
      return __int2float_rn(acc[pi][ot][jt][e]) * inv_q +
             __ldg(aux + 128 * (pi + 1) + o);
    };
    store_tile<kOut>(smem, value, ot0, jw, m, w, j0, t_len, y_re, y_im, y8);
  }
}

template <int kMode, int kOut>
int chan_mma_launch(const float* words, const float* sr, const float* si,
                    const uint4* frag, const float* aux, int m, int k_taps,
                    int n_captures, int64_t t_len, float* y_re, float* y_im,
                    int8_t* y8, float* sr_out, float* si_out,
                    cudaStream_t stream) {
  constexpr int S = 128 * MatMode<kMode>::kElem + kRowPad;
  const int n_state = (k_taps - 1) * m;
  const int tl = n_state > 128 ? (n_state + 127) / 128 : 1;
  const size_t ring =
      (size_t)MatMode<kMode>::kPlanes * (kTileCols + tl) * S;
  const size_t stage = kOut == kOutF32 ? (size_t)128 * (kTileCols + 1) * 4
                                       : (size_t)128 * (kTileCols + 4);
  const size_t smem = ring > stage ? ring : stage;
  auto kern = chan_mma_kernel<kMode, kOut>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)(t_len / (kTileCols * 128)),
                  (unsigned)n_captures);
  kern<<<grid, kMmaThreads, smem, stream>>>(words, sr, si, frag, aux, m,
                                            k_taps, t_len, y_re, y_im, y8);
  FMT_CHECK_LAUNCH();
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
int chan_mma_dispatch(int out, const float* words, const float* sr,
                      const float* si, const uint4* frag, const float* aux,
                      int m, int k_taps, int n_captures, int64_t t_len,
                      float* y_re, float* y_im, int8_t* y8, float* sr_out,
                      float* si_out, cudaStream_t stream) {
  switch (out) {
    case kOutF32:
      return chan_mma_launch<kMode, kOutF32>(words, sr, si, frag, aux, m,
                                             k_taps, n_captures, t_len, y_re,
                                             y_im, y8, sr_out, si_out, stream);
    case kOutI8:
      return chan_mma_launch<kMode, kOutI8>(words, sr, si, frag, aux, m,
                                            k_taps, n_captures, t_len, y_re,
                                            y_im, y8, sr_out, si_out, stream);
    default:
      return chan_mma_launch<kMode, kOutI8PS>(words, sr, si, frag, aux, m,
                                              k_taps, n_captures, t_len, y_re,
                                              y_im, y8, sr_out, si_out,
                                              stream);
  }
}

}  // namespace fmt

using namespace fmt;

// All pointers are device pointers to contiguous tensors.  Returns the first
// cudaError_t of the launches (0 = all launched).
// words [W, T] packed u8 IQ (16-byte aligned); sr, si [W, (K-1)*M] carried
// state in, sr_out, si_out the same shape out (distinct buffers); frag the
// matrices in fragment order (kernels/channelizer.py::frag_order: int8
// [2, n_c*4, 8, 32, 4] words); aux [3, 128] float32 (1/q_M, corr_re,
// corr_im).  out 0: y_re, y_im [W, M, T/M] float32; out 1: y8
// [2, W, M, T/M]; out 2 (M = 32): y8 [2, 4, W*M, T/128].
// Limits (the wrapper checks them too): mode 1 (the bf16 mode 2 is
// fmt_channelize_wgmma), M in {8, 16, 32, 64, 128}, 1 <= K <= 17, T a
// multiple of 8192.
extern "C" int fmt_channelize_mma(const float* words, const float* sr,
                                  const float* si, const void* frag,
                                  const float* aux, int mode, int m,
                                  int k_taps, int n_captures, int64_t t_len,
                                  int out, float* y_re, float* y_im,
                                  int8_t* y8, float* sr_out, float* si_out,
                                  cudaStream_t stream) {
  if (mode != 1 || m < 8 || m > 128 || 128 % m != 0 ||
      k_taps < 1 || k_taps > 17 || t_len <= 0 ||
      t_len % (kTileCols * 128) != 0 || n_captures <= 0 ||
      n_captures > 65535 || out < kOutF32 || out > kOutI8PS ||
      (out == kOutI8PS && m != 32)) {
    return (int)cudaErrorInvalidValue;
  }
  return chan_mma_dispatch<1>(out, words, sr, si,
                              static_cast<const uint4*>(frag), aux, m,
                              k_taps, n_captures, t_len, y_re, y_im, y8,
                              sr_out, si_out, stream);
}
