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
// - ds x4 + atan2 (k12_ds4_theta_kernel): the int8 window read as aligned
//   int32 words and summed with __dp4a (four exact products an
//   instruction); one thread an output, theta1 [C, B/4] to device memory.
// - The mid end takes one of two routes (k12_stages.cuh::midend_route).
//   With de-emphasis off (the receiver's default) it is fused: one tiled
//   kernel runs discriminator -> ds x2 -> Hilbert per (channel, 1024
//   outputs) with fm_demod and fm_out in shared memory only, its FIRs
//   register-blocked (one shared-memory load per tap, not per
//   multiply-add); the peak IIR's serial loop carries only the two
//   biquads and the pilot power (kBatch steps loaded ahead, the outputs
//   stored kBatch at a time); theta = atan2 / 2 pi of the filtered planes
//   is a parallel pass.  Before, four launches ran ds x2, Hilbert and the
//   peak IIR with the polynomial atan2 and its IEEE division inside the
//   serial loop (7.27 ms a block at the pre-split cell, the peak IIR 2.31
//   of it).  The bound is the bytes (0.31 ms at the cell): int8 planes in,
//   re, im, theta out.
// - With de-emphasis on (a serial stage between ds x2 and Hilbert) the
//   launches route runs: discriminator, ds x2, de-emphasis (one thread a
//   channel, kBatch steps loaded at once), Hilbert, peak IIR with theta,
//   the intermediates in device memory; staging those serial loops'
//   tiles through shared memory with barriers was measured slower
//   (PERF.md).
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
// (k12_ds4_ps_theta_kernel); the launches after ds x4 are shared.
// Measured at the wideband cell (2048 stations x 131,072; NVIDIA H100 80GB
// HBM3, power limit 700.00 W): its ds x4 + atan2 takes 2.674 ms per block
// against the flat launch's 1.579 ms.  Each output reads five words from
// each of four plane rows B/4 bytes apart instead of sixteen words of one
// row; whether those scattered loads are the whole difference is not
// measured.
//
// Arithmetic kept from the TPU kernel (not its layout): the ds x4 taps are
// exactly quantize_band_int8's two int8 planes (b1, b2) and column sum
// s_row, accumulated exactly in int32 and combined as
// y1 + y2 * (1/128) + s_row in float32 (frontend_pallas.py:411-417).  The
// +1 recentre of the u8 - 128 planes is folded into s_row; the carried
// ds x4 tail is int8 (float(i8 + 1) in the state, converted by the wrapper).

#include "k12_stages.cuh"

namespace fmt {

// ds x4 (int8 taps) + atan2 on phase-split planes.  Output j of the flat
// form sums b[k] * x[4j - halo + k]; with k = 4e + p that is
// sum_p sum_e b[4e + p] * x_p[j - ne + 1 + e] (ne = nn/4 taps per phase), so
// each phase is an ne-tap correlation over bytes j - ne + 1 .. j of its
// plane.  The int32 partial sums are exact, so the result equals the flat
// kernel's bit for bit.  The window is not word-aligned: each group of four
// bytes is cut from two aligned words with __funnelshift_r.  tail4
// [2, 4, C, ne] holds each phase's last ne - 1 bytes after one pad byte;
// bps1w, bps2w hold phase p's taps b[4e + p] packed four to a word.
__global__ void k12_ds4_ps_theta_kernel(const int8_t* __restrict__ x4,
                                        const int8_t* __restrict__ tail4,
                                        const int* __restrict__ bps1w,
                                        const int* __restrict__ bps2w, int nn,
                                        float s_row, int channels, int n_in,
                                        float* __restrict__ theta1) {
  const int n_out = n_in / 4;  // = the length of each phase plane
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)channels * n_out;
  if (idx >= total) return;
  const int c = (int)(idx / n_out);
  const int j = (int)(idx % n_out);
  const int ne = nn / 4, nwp = ne / 4;  // taps and tap words per phase
  const int a = j - ne + 1;             // first byte of the window
  const int sh = 8 * (a & 3);
  const int q0 = a >> 2;                // its word (floor: a may be < 0)
  const int last = n_out / 4 - 1;       // last word of a plane row
  int y1r = 0, y2r = 0, y1i = 0, y2i = 0;
  for (int p = 0; p < 4; ++p) {
    const int64_t rr = (int64_t)p * channels + c;                 // re row
    const int64_t ri = ((int64_t)4 + p) * channels + c;           // im row
    const int* xr = (const int*)(x4 + rr * n_out);
    const int* xi = (const int*)(x4 + ri * n_out);
    const int* tr = (const int*)(tail4 + rr * ne);
    const int* ti = (const int*)(tail4 + ri * ne);
    const int nw = n_out / 4;  // words of a plane row
    int lr = q0 < 0 ? FMT_AT(tr, nwp + q0, nwp) : FMT_AT(xr, q0, nw);
    int li = q0 < 0 ? FMT_AT(ti, nwp + q0, nwp) : FMT_AT(xi, q0, nw);
    for (int w = 0; w < nwp; ++w) {
      const int q = min(q0 + w + 1, last);  // unused when sh == 0
      const int hr = q < 0 ? FMT_AT(tr, nwp + q, nwp) : FMT_AT(xr, q, nw);
      const int hi = q < 0 ? FMT_AT(ti, nwp + q, nwp) : FMT_AT(xi, q, nw);
      const int vr = (int)__funnelshift_r((unsigned)lr, (unsigned)hr, sh);
      const int vi = (int)__funnelshift_r((unsigned)li, (unsigned)hi, sh);
      const int w1 = __ldg(&FMT_AT(bps1w, p * nwp + w, 4 * nwp));
      const int w2 = __ldg(&FMT_AT(bps2w, p * nwp + w, 4 * nwp));
      y1r = __dp4a(vr, w1, y1r);
      y2r = __dp4a(vr, w2, y2r);
      y1i = __dp4a(vi, w1, y1i);
      y2i = __dp4a(vi, w2, y2i);
      lr = hr;
      li = hi;
    }
  }
  const float fr = ((float)y1r + (float)y2r * (1.0f / 128.0f)) + s_row;
  const float fi = ((float)y1i + (float)y2i * (1.0f / 128.0f)) + s_row;
  FMT_AT(theta1, idx, total) = atan2_poly(fi, fr);
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
// [C].  By midend_route (k12_stages.cuh): on the fused route the scratch
// yi [C, B/8] and the output tails [C, (nn2-2) + (nh-1)] (the new ds x2 and
// Hilbert tails), fmd and fm_out unused (may be null); on the launches
// route the scratch fmd [C, B/4] and fm_out [C, B/8], yi and tails unused.
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
  const int route = midend_route(0, 0, use_deemph, nn2, nh, b / 4);
  if (nn1 % (phase_split ? 16 : 4) != 0 || b % (8 * kBatch) != 0 ||
      (route == kMidFused ? yi == nullptr || tails == nullptr
                          : fmd == nullptr || fm_out == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned grid = blocks_for((int64_t)channels * (b / 4));
  if (phase_split) {
    k12_ds4_ps_theta_kernel<<<grid, kThreads, 0, stream>>>(
        x8, tail8, (const int*)b1, (const int*)b2, nn1, s_row, channels, b,
        theta1);
  } else {
    k12_ds4_theta_kernel<<<grid, kThreads, 0, stream>>>(
        x8, tail8, (const int*)b1, (const int*)b2, nn1, s_row, channels, b,
        theta1);
  }
  FMT_CHECK_LAUNCH();
  if (route == kMidFused) {
    return launch_mid_fused<true>(theta1, prev_theta, scale, w2_rev, tail2,
                                  wh_rev, htail, pk_b0, pk_b1, pk_b2, pk_a1,
                                  pk_a2, pk_st_in, pk_st_out, channels, b / 4,
                                  re, im, theta, yi, tails, power, stream);
  }
  const int err = launch_disc(theta1, prev_theta, scale, channels, b / 4, fmd,
                              stream);
  if (err) return err;
  return launch_midend(fmd, w2_rev, nn2, tail2, use_deemph, de_b0, de_b1,
                       de_a1, de_st_in, de_st_out, wh_rev, nh, htail, pk_b0,
                       pk_b1, pk_b2, pk_a1, pk_a2, pk_st_in, pk_st_out,
                       channels, b / 4, fm_out, re, im, theta, nullptr,
                       nullptr, nullptr, power, stream);
}
