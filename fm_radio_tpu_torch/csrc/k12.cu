// K12: int8 front end + mid end of the demodulator on Hopper.
//
// Replaces fm_radio_tpu/kernels/k12_pallas.py::_k12_kernel (the Pallas
// composition of frontend_pallas.py::_i8_direct_tile_body and
// midend_pallas.py::_midend_body): [2, C, B] int8 IQ planes (u8 - 128) ->
// ds x4 LPF (64 int8-quantised taps, int32 accumulation) -> polynomial-atan2
// discriminator -> ds x2 LPF (64 taps) -> optional 1-pole de-emphasis ->
// 65-tap Hilbert -> order-2 19 kHz peak IIR on re and im -> pilot phase
// theta = atan2/2pi and the pilot power sum.
//
// What bounds it, and what the design does about it (the times per launch
// are PERF.md's, NVIDIA H100 80GB HBM3 at 700 W):
// - ds x4 + atan2 (k12_stages.cuh::ds4_i8_blocked_kernel): 64 __dp4a an
//   output (four exact products an instruction), ~0.26 ms of the integer
//   pipe a block at C = 2048, about the byte bound (0.27: the int8 planes
//   in, theta1 out).  A CTA stages a tile of 1,024 outputs' int32 words
//   once in shared memory, its loads all in flight before the first store,
//   so each word is read from device memory once (not once for each of
//   the 16 outputs whose window holds it); a thread sums a run of 8
//   outputs from a sliding window of 8 words in registers (16 measured
//   slower: half the warps).  theta1 goes to device memory for the mid
//   end: feeding the mid end's ds x2 tile directly would recompute its
//   126-output halo a tile inside that kernel's register budget (PERF.md).
// - The mid end takes one of two routes (k12_stages.cuh::midend_route).
//   At every filter order within the 128-sample halo, with de-emphasis
//   off (the receiver's default) or on, the split route: its first launch
//   (k12_mid_ds2_kernel) runs the discriminator on the staged theta1 and
//   the register-blocked ds x2 (one shared-memory load per tap, not per
//   multiply-add) and writes fm_out; where the de-emphasis is on it runs
//   in place over fm_out (one thread a channel, kDeemphLanes a block, each
//   lane's row staged in shared memory by bulk copies, whole chunks in
//   flight while one runs); the second launch (k12_mid_hilb_kernel)
//   stages fm_out back for the register-blocked Hilbert.  The peak IIR's
//   serial loop then carries only the two biquads and the pilot power
//   (kBatch steps loaded ahead, the outputs stored kBatch at a time);
//   theta = atan2 / 2 pi of the filtered planes is a parallel pass.  The
//   split route won over a fused kernel that ran discriminator -> ds x2 ->
//   Hilbert in one launch with fm_demod and fm_out in shared memory only:
//   fm_out's round trip through device memory costs less than the fused
//   kernel lost to its occupancy.  It held 127-128 registers a thread, so
//   2 CTAs of 256 threads an SM, against the two launches' 8 and 5 CTAs
//   (64 and 48 registers); each CTA stages its window, then sums, so few
//   CTAs leave the loads uncovered (0.95 device ms a block at the
//   pre-split cell against 0.57 for the two launches; PERF.md).  Before
//   either, four launches ran ds x2, Hilbert and the peak IIR with the
//   polynomial atan2 and its IEEE division inside the serial loop (7.27
//   ms a block at the pre-split cell, the peak IIR 2.31 of it).  Other
//   orders than the receiver's 64 / 65 taps run the two launches'
//   any-order forms (k12_mid_ds2_any_kernel, k12_mid_hilb_any_kernel: the
//   order at run time, the same tiles and register budget); a block
//   shorter than a carried tail (a direct call only: demod_block's blocks
//   are multiples of 8,192 samples) takes one launch per stage (the
//   launches route), with the discriminator's own launch.
//
// The stages are shared with the split path through k12_stages.cuh: its
// ds x4 + discriminator are K1's int8-direct entry (frontend.cu) and its
// mid end K2 (midend.cu, which enters the same routes after the
// discriminator), so K1 + K2 equal K12 bit for bit.
//
// With phase_split set, fmt_k12 replaces k12_pallas.py::_k12_kernel_ps
// (body frontend_pallas.py::_i8_phase_tile_body): the same function on
// [2, 4, C, B/4] int8 polyphase planes, x_p[u] = x[4u + p], which the
// wideband channelizer writes at M = 32.  Only its first launch differs
// (k12_ds4_ps_blocked_kernel below); the launches after ds x4 are shared.
// Its windows are not word-aligned: it stages each phase row's four byte
// alignments once (32 sub-planes), so its inner loop is the flat form's;
// the staging (three funnel shifts a word, 34 KB a CTA) is what it pays
// more (times in PERF.md).  The other exact form, the data words aligned
// and the taps shifted once per alignment (80 __dp4a an output against
// 64), measured 1.4 times slower and was removed (PERF.md).
//
// Arithmetic kept from the TPU kernel (not its layout): the ds x4 taps are
// exactly quantize_band_int8's two int8 planes (b1, b2) and column sum
// s_row, accumulated exactly in int32 and combined as
// y1 + y2 * (1/128) + s_row in float32 (frontend_pallas.py:411-417).  The
// +1 recentre of the u8 - 128 planes is folded into s_row; the carried
// ds x4 tail is int8 (float(i8 + 1) in the state, converted by the wrapper).

#include "k12_stages.cuh"

namespace fmt {

// ds x4 (int8 taps) + atan2 on phase-split planes [2, 4, C, n], register-
// blocked as the flat form (k12_stages.cuh::ds4_i8_blocked_kernel).
// Output j of the flat form sums b[k] * x[4j - halo + k]; with k = 4e + p
// that is sum_p sum_e b[4e + p] * x_p[j - ne + 1 + e] (ne = nn/4 taps per
// phase), so each phase is an ne-tap correlation over bytes j - ne + 1 .. j
// of its row: nwq = ne / 4 words from word (j + 1) / 4 - nwq, cut at byte s
// = (j + 1) % 4.  A CTA stages, for each of the 8 rows (plane, phase) of its
// channel's tile, the four byte alignments of the row's words (s = 0: the
// words; s > 0: __funnelshift_r of two neighbours) as 32 skewed sub-planes,
// once; a thread's run of R outputs (R a multiple of 4) holds, for each
// phase and alignment, the R / 4 outputs of that alignment, and sums them
// from a sliding window of R / 4 words of the sub-plane, as the flat form
// sums its run.  The int32 sums are exact, so theta1 is the flat kernel's
// bit for bit.  tail4 [2, 4, C, ne] holds each phase's last ne - 1 bytes
// after one pad byte; bps1w, bps2w hold phase p's taps b[4e + p] packed four
// to a word (nwq words a phase), zero-padded here at the oldest end to a
// whole number of R / 4-word blocks.
__host__ __device__ constexpr int ds4_ps_plane(int nwq) {
  // staged words: the halo (the padded window) and the tile's R/4-word runs
  return mid_skew(ds4_pad_words(nwq, kDs4Run / 4) + kDs4Tile / 4) + 1;
}
inline size_t ds4_ps_smem(int nwq) {
  return 32 * sizeof(int) * (size_t)ds4_ps_plane(nwq) +
         4 * sizeof(int2) * (size_t)ds4_pad_words(nwq, kDs4Run / 4);
}

__global__ void __launch_bounds__(kDs4Tile / kDs4Run)
k12_ds4_ps_blocked_kernel(const int8_t* __restrict__ x4,
                          const int8_t* __restrict__ tail4,
                          const int* __restrict__ bps1w,
                          const int* __restrict__ bps2w, int nn, float s_row,
                          int channels, int n_in,
                          float* __restrict__ theta1) {
  constexpr int R = kDs4Run, RS = R / 4;  // RS: outputs of one alignment
  static_assert(R % 4 == 0, "whole groups of the four alignments");
  extern __shared__ __align__(16) int ps_sm[];
  const int nwq = nn / 16, nwqp = ds4_pad_words(nwq, RS);
  const int h = nwqp, plane = ds4_ps_plane(nwq);
  int2* s_tap = reinterpret_cast<int2*>(ps_sm + 32 * plane);
  const int c = blockIdx.y, tid = threadIdx.x;
  const int n = n_in / 4;      // outputs = bytes of a phase row
  const int nrow = n / 4;      // words of a phase row
  const int t0 = blockIdx.x * kDs4Tile;
  const int pad = nwqp - nwq;
  for (int k = tid; k < 4 * nwqp; k += blockDim.x) {
    const int p = k / nwqp, w = k % nwqp;
    s_tap[k] = w < pad ? make_int2(0, 0)
                       : make_int2(FMT_AT(bps1w, p * nwq + w - pad, 4 * nwq),
                                   FMT_AT(bps2w, p * nwq + w - pad, 4 * nwq));
  }
  // row rw = 4 pl + p: word i of (plane pl, phase p, channel c); before
  // the row the tail (word nwq + i), before that 0
  auto raw = [&](int rw, int i) -> int {
    const int64_t row = (int64_t)rw * channels + c;
    if (i >= nrow) return 0;
    if (i >= 0) return FMT_AT((const int*)(x4 + row * n), i, nrow);
    if (i >= -nwq) return FMT_AT((const int*)(tail4 + row * 4 * nwq),
                                 nwq + i, nwq);
    return 0;
  };
  // each row's staged words in groups of four (words e .. e + 3 and the
  // next one), kStage groups a thread in flight: all loads first, then the
  // shifts and stores
  const int n_e = h + kDs4Tile / 4 + 1, n_g = (n_e + 3) / 4;
  constexpr int kThreadsPs = kDs4Tile / R;
  constexpr int kStage = (8 * (kDs4Tile / 16 + 4)) / kThreadsPs + 1;
  for (int g0 = 0; g0 < 8 * n_g; g0 += kStage * kThreadsPs) {
    unsigned w[kStage][5];
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int g = g0 + tid + k * kThreadsPs;
      const int rw = g / n_g, i0 = t0 / 4 - h + 4 * (g % n_g);
#pragma unroll
      for (int u = 0; u < 5; ++u)
        w[k][u] = g < 8 * n_g ? (unsigned)raw(rw, i0 + u) : 0u;
    }
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int g = g0 + tid + k * kThreadsPs;
      if (g >= 8 * n_g) continue;
      const int rw = g / n_g, e0 = 4 * (g % n_g);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (e0 + u >= n_e) continue;
        int* sp = ps_sm + 4 * rw * plane + mid_skew(e0 + u);
        sp[0] = (int)w[k][u];
#pragma unroll
        for (int s = 1; s < 4; ++s)
          sp[s * plane] = (int)__funnelshift_r(w[k][u], w[k][u + 1], 8 * s);
      }
    }
  }
  __syncthreads();

  int y1r[R], y2r[R], y1i[R], y2i[R];
#pragma unroll
  for (int r = 0; r < R; ++r) y1r[r] = y2r[r] = y1i[r] = y2i[r] = 0;
  // alignment s's k-th output of the run is r = 4 k + (s + 3) % 4; its
  // window starts at e = h - nwqp + (s == 0) + RS tid + k
#pragma unroll 1
  for (int p = 0; p < 4; ++p) {
    const int* sre = ps_sm + 4 * p * plane;         // plane re, phase p
    const int* sim = ps_sm + 4 * (4 + p) * plane;   // plane im, phase p
    int vr[4][RS], vi[4][RS];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int k = 0; k < RS; ++k) {
        const int e = mid_skew(h - nwqp + (s == 0) + RS * tid + k);
        vr[s][k] = sre[s * plane + e];
        vi[s][k] = sim[s * plane + e];
      }
#pragma unroll 1
    for (int qb = 0; qb < nwqp; qb += RS) {
#pragma unroll
      for (int qq = 0; qq < RS; ++qq) {
        const int2 tp = s_tap[p * nwqp + qb + qq];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
#pragma unroll
          for (int k = 0; k < RS; ++k) {
            const int r = 4 * k + (s + 3) % 4, slot = (k + qq) % RS;
            y1r[r] = __dp4a(vr[s][slot], tp.x, y1r[r]);
            y2r[r] = __dp4a(vr[s][slot], tp.y, y2r[r]);
            y1i[r] = __dp4a(vi[s][slot], tp.x, y1i[r]);
            y2i[r] = __dp4a(vi[s][slot], tp.y, y2i[r]);
          }
          const int e =
              mid_skew(h - nwqp + (s == 0) + RS * tid + RS + qb + qq);
          vr[s][qq] = sre[s * plane + e];
          vi[s][qq] = sim[s * plane + e];
        }
      }
    }
  }
  float th[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    th[r] = ds4_i8_theta(y1r[r], y2r[r], y1i[r], y2i[r], s_row);
  ds4_finish<R>(Ds4Theta{theta1}, c, channels, n, t0, tid, th, 0.0f,
                nullptr);
}

// the phase-split form's launch: x4 [2, 4, C, n_in / 4] (4-byte aligned
// rows, n_in % 16 == 0), tail4 [2, 4, C, nn / 4], bps1, bps2 [4, nn / 4];
// nn % 16 == 0
inline int launch_ds4_ps(const int8_t* x4, const int8_t* tail4,
                         const int8_t* b1, const int8_t* b2, int nn,
                         float s_row, int channels, int n_in, float* theta1,
                         cudaStream_t stream) {
  const size_t smem = ds4_ps_smem(nn / 16);
  if (nn % 16 != 0 || n_in % 16 != 0 || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const int n = n_in / 4;
  const dim3 grid((unsigned)((n + kDs4Tile - 1) / kDs4Tile),
                  (unsigned)channels);
  k12_ds4_ps_blocked_kernel<<<grid, kDs4Tile / kDs4Run, smem, stream>>>(
      x4, tail4, (const int*)b1, (const int*)b2, nn, s_row, channels, n_in,
      theta1);
  FMT_CHECK_LAUNCH();
  return 0;
}

// K12's first launch
inline int launch_k12_ds4(const int8_t* x8, const int8_t* tail8,
                          const int8_t* b1, const int8_t* b2, int nn,
                          float s_row, int channels, int b, int phase_split,
                          float* theta1, cudaStream_t stream) {
  if (phase_split)
    return launch_ds4_ps(x8, tail8, b1, b2, nn, s_row, channels, b, theta1,
                         stream);
  return launch_ds4_i8(I8Rows{x8, b}, tail8, b1, b2, nn, s_row, channels, b,
                       Ds4Theta{theta1}, stream);
}

}  // namespace fmt

using namespace fmt;

// All pointers are device pointers to contiguous float32 / int8 tensors.
// Returns the first cudaError_t of the launches (0 = all launched).
// phase_split == 0: x8 [2, C, B] and tail8 [2, C, nn1-4] 4-byte aligned,
// nn1 % 4 == 0; b1, b2 [nn1] int8 (reversed-tap order, read as nn1/4 int32
// words).  phase_split == 1: x8 [2, 4, C, B/4] (phase planes, 4-byte
// aligned, B % 16 == 0), tail8 [2, 4, C, nn1/4] (per phase: one pad byte,
// then its last nn1/4 - 1 samples) and b1, b2 [4, nn1/4] (phase p: b[4e + p],
// e = 0..nn1/4-1), nn1 % 16 == 0.  Both: prev_theta [C]; w2_rev [nn2],
// tail2 [C, nn2-2]; de_st_* [C, 2]; wh_rev [nh], htail [C, nh-1]; pk_st_*
// [C, 8]; scratch theta1 [C, B/4]; outputs re, im, theta [C, B/8], power
// [C]; the scratch yi [C, B/8].  By midend_route (k12_stages.cuh): on the
// split route the scratch fm_out [C, B/8] and the output tails [C, nn2-2]
// (the new ds x2 tail; null only where it is empty), fmd unused (may be
// null); on the launches route the scratch fmd [C, B/4] and fm_out
// [C, B/8], tails unused; orders past the halo are refused.
extern "C" int fmt_k12(const int8_t* x8, const int8_t* tail8,
                       const int8_t* b1, const int8_t* b2, int nn1,
                       float s_row, const float* prev_theta, float scale,
                       const float* w2_rev, int nn2, const float* tail2,
                       int use_deemph, float de_b0, float de_b1, float de_a1,
                       const float* de_st_in, float* de_st_out,
                       const float* wh_rev, int nh, const float* htail,
                       float pk_b0, float pk_b1, float pk_b2, float pk_a1,
                       float pk_a2, const float* pk_st_in, float* pk_st_out,
                       int channels, int b, int phase_split, float* theta1,
                       float* fmd, float* fm_out, float* re, float* im,
                       float* theta, float* power, float* yi, float* tails,
                       cudaStream_t stream) {
  const int route = midend_route(nn2, nh, b / 4);
  const bool bufs = fm_out != nullptr && route != kMidRefused &&
                    (route == kMidSplit ? tails != nullptr || nn2 == 2
                                        : fmd != nullptr);
  if (nn1 % (phase_split ? 16 : 4) != 0 || b % (8 * kBatch) != 0 ||
      yi == nullptr || !bufs) {
    return (int)cudaErrorInvalidValue;
  }
  const int err1 = launch_k12_ds4(x8, tail8, b1, b2, nn1, s_row, channels,
                                  b, phase_split, theta1, stream);
  if (err1) return err1;
  if (route == kMidSplit) {
    return launch_mid_split<true>(
        theta1, prev_theta, scale, w2_rev, nn2, tail2, use_deemph, de_b0,
        de_b1, de_a1, de_st_in, de_st_out, wh_rev, nh, htail, pk_b0, pk_b1,
        pk_b2, pk_a1, pk_a2, pk_st_in, pk_st_out, channels, b / 4, fm_out, re,
        im, theta, yi, tails, power, nullptr, nullptr, nullptr, stream);
  }
  const int err = launch_disc(theta1, prev_theta, scale, channels, b / 4, fmd,
                              stream);
  if (err) return err;
  return launch_midend(fmd, w2_rev, nn2, tail2, use_deemph, de_b0, de_b1,
                       de_a1, de_st_in, de_st_out, wh_rev, nh, htail, pk_b0,
                       pk_b1, pk_b2, pk_a1, pk_a2, pk_st_in, pk_st_out,
                       channels, b / 4, fm_out, re, im, theta, nullptr,
                       nullptr, nullptr, power, stream, yi);
}
