// The stages that K12 shares with the split front end (K1) and mid end (K2).
//
// K12 (k12.cu) runs them back to back; the split path runs the int8-direct
// ds x4 + discriminator as K1 (frontend.cu, fmt_frontend_i8) and the rest as
// K2 (midend.cu).  One copy of the device code serves all three, so the
// split int8 path equals K12 bit for bit on the card, as the TPU's K1 + K2
// equal its fused K12 (kernels/k12_pallas.py:15-16).
//
//   k12_ds4_theta_kernel  ds x4 (int8 taps, __dp4a) + atan2 on int8 planes
//                         (frontend_pallas.py::_i8_direct_tile_body :388)
//   k12_disc_kernel       the discriminator (frontend_pallas.py:196-209)
//   launch_midend         ds x2 -> de-emphasis -> Hilbert -> peak IIR, theta,
//                         pilot power (midend_pallas.py::_midend_body :119)
//
// The per-sample formulas (disc_value, deemph_step, peak_step) are device
// functions that the full-chain megakernel (chain.cu) evaluates too, tile
// by tile, so the chain equals the split path bit for bit.
//
// What bounds each launch, and what its design does about it, is noted in
// k12.cu, where the times per launch are.
#pragma once

#include "common.cuh"

namespace fmt {

// The int8-tap ds x4 window sum: (fr, fi) over nw words from word q0 of
// the re and im rows xr, xi (n_w words each; four int8 samples to a word),
// words q < 0 from the carried tails tr, ti (halo_w words each, word q at
// halo_w + q), each accumulated exactly with __dp4a against the reversed
// taps b1w, b2w (nw words each), combined as y1 + y2 / 128 + s_row.  The
// tails may be null where q0 >= 0.
__device__ __forceinline__ void ds4_i8_words(
    const int* __restrict__ xr, const int* __restrict__ xi, int n_w,
    const int* __restrict__ tr, const int* __restrict__ ti, int halo_w,
    const int* __restrict__ b1w, const int* __restrict__ b2w, int nw, int q0,
    float s_row, float& fr, float& fi) {
  int y1r = 0, y2r = 0, y1i = 0, y2i = 0;
  for (int w = 0; w < nw; ++w) {
    const int q = q0 + w;
    const int vr =
        q < 0 ? FMT_AT(tr, halo_w + q, halo_w) : FMT_AT(xr, q, n_w);
    const int vi =
        q < 0 ? FMT_AT(ti, halo_w + q, halo_w) : FMT_AT(xi, q, n_w);
    const int w1 = __ldg(&FMT_AT(b1w, w, nw));
    const int w2 = __ldg(&FMT_AT(b2w, w, nw));
    y1r = __dp4a(vr, w1, y1r);
    y2r = __dp4a(vr, w2, y2r);
    y1i = __dp4a(vi, w1, y1i);
    y2i = __dp4a(vi, w2, y2i);
  }
  fr = ((float)y1r + (float)y2r * (1.0f / 128.0f)) + s_row;
  fi = ((float)y1i + (float)y2i * (1.0f / 128.0f)) + s_row;
}

// ds x4 (int8 taps) + atan2: theta1[c, j] = angle(fm_in[c, j]).  The
// window of output j starts at input 4j - halo, a multiple of 4, so it is
// nn/4 aligned words of x (or of the carried tail, whose length halo is a
// multiple of 4 too); b1w, b2w are the reversed taps packed 4 to a word in
// the same byte order.
__global__ void k12_ds4_theta_kernel(const int8_t* __restrict__ x8,
                                     const int8_t* __restrict__ tail8,
                                     const int* __restrict__ b1w,
                                     const int* __restrict__ b2w, int nn,
                                     float s_row, int channels, int n_in,
                                     float* __restrict__ theta1) {
  const int n_out = n_in / 4;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)channels * n_out;
  if (idx >= total) return;
  const int c = (int)(idx / n_out);
  const int j = (int)(idx % n_out);
  const int halo = nn - 4;
  const int* xr = (const int*)(x8 + (int64_t)c * n_in);
  const int* xi = (const int*)(x8 + ((int64_t)channels + c) * n_in);
  const int* tr = (const int*)(tail8 + (int64_t)c * halo);
  const int* ti = (const int*)(tail8 + ((int64_t)channels + c) * halo);
  float fr, fi;
  ds4_i8_words(xr, xi, n_in / 4, tr, ti, halo / 4, b1w, b2w, nn / 4,
               j - halo / 4, s_row, fr, fi);
  FMT_AT(theta1, idx, total) = atan2_poly(fi, fr);
}

// discriminator: fmd = wrap(theta1[j] - theta1[j-1]) * scale
__device__ __forceinline__ float disc_value(float theta, float prev,
                                            float scale) {
  float d = theta - prev;
  d = d >= kPi ? d - kTwoPi : d;
  d = d <= -kPi ? d + kTwoPi : d;
  return d * scale;
}

// de-emphasis: y = (b1*x[n-1] + b0*x[n]) - a1*y[n-1]; state (x1, y1)
__device__ __forceinline__ float deemph_step(float& x1, float& y1, float x,
                                             float b0, float b1, float a1) {
  const float y = (x1 * b1 + x * b0) - y1 * a1;
  x1 = x;
  y1 = y;
  return y;
}

// order-2 peak IIR on one plane: ff = b2*x[n-2] + b1*x[n-1] + b0*x[n];
// y = (ff - a1*y[n-1]) - a2*y[n-2]
struct Peak2 {
  float x1, x2, y1, y2;
};

__device__ __forceinline__ float peak_step(Peak2& s, float v, float b0,
                                           float b1, float b2, float a1,
                                           float a2) {
  const float f = (s.x2 * b2 + s.x1 * b1) + v * b0;
  const float y = (f - s.y1 * a1) - s.y2 * a2;
  s.x2 = s.x1;
  s.x1 = v;
  s.y2 = s.y1;
  s.y1 = y;
  return y;
}

// discriminator: fmd[c, j] = disc_value(theta1[j], theta1[j-1]), stored as
// float32 or, in the int16 format, as q_i16 at kFmScale (K1's out_i16,
// frontend_pallas.py:204-207 and :482-485; K12 stores float32)
template <class Out>
__global__ void k12_disc_kernel(const float* __restrict__ theta1,
                                const float* __restrict__ prev_theta,
                                float scale, int channels, int n,
                                Out* __restrict__ fmd) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)channels * n;
  if (idx >= total) return;
  const int c = (int)(idx / n);
  const int j = (int)(idx % n);
  const float prev = j == 0 ? FMT_AT(prev_theta, c, channels)
                            : FMT_AT(theta1, idx - 1, total);
  store_f32(&FMT_AT(fmd, idx, total), 0,
            disc_value(FMT_AT(theta1, idx, total), prev, scale), kFmScale);
}

// de-emphasis, one thread per channel, in place; state (x1, y1) per
// channel
__global__ void k12_deemph_kernel(float* __restrict__ fm_out, int n,
                                  int channels, float b0, float b1, float a1,
                                  const float* __restrict__ st_in,
                                  float* __restrict__ st_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= channels) return;
  float* row = fm_out + (int64_t)c * n;
  float x1 = FMT_AT(st_in, 2 * c, 2 * channels);
  float y1 = FMT_AT(st_in, 2 * c + 1, 2 * channels);
  for (int i0 = 0; i0 < n; i0 += kBatch) {
    float bx[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) bx[u] = FMT_AT(row, i0 + u, n);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      FMT_AT(row, i0 + u, n) = deemph_step(x1, y1, bx[u], b0, b1, a1);
  }
  FMT_AT(st_out, 2 * c, 2 * channels) = x1;
  FMT_AT(st_out, 2 * c + 1, 2 * channels) = y1;
}

// Hilbert: im = nh-tap FIR, re = input delayed by (nh - 1)/2, written as
// float32 (the peak IIR reads them); with kI16 also as q_i16 at kIqScale
// into re16, im16 (K2's out_i16 stores, midend_pallas.py:254-256)
template <bool kI16>
__global__ void k12_hilbert_kernel(const float* __restrict__ fm_out,
                                   const float* __restrict__ htail,
                                   const float* __restrict__ wh_rev, int nh,
                                   int channels, int n,
                                   float* __restrict__ re,
                                   float* __restrict__ im,
                                   int16_t* __restrict__ re16,
                                   int16_t* __restrict__ im16) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)channels * n;
  if (idx >= total) return;
  const int c = (int)(idx / n);
  const int i = (int)(idx % n);
  const int halo = nh - 1;
  const float* x = fm_out + (int64_t)c * n;
  const float* t = htail + (int64_t)c * halo;
  const float vi = fir_point(x, n, t, halo, wh_rev, nh, i - halo);
  const int d = i - (nh - 1) / 2;
  const float vr = d < 0 ? FMT_AT(t, halo + d, halo) : FMT_AT(x, d, n);
  FMT_AT(im, idx, total) = vi;
  FMT_AT(re, idx, total) = vr;
  if constexpr (kI16) {
    FMT_AT(re16, idx, total) = q_i16(vr, kIqScale);
    FMT_AT(im16, idx, total) = q_i16(vi, kIqScale);
  }
}

// order-2 peak IIR (peak_step) on both planes, one thread per channel;
// theta = atan2(yi, yr) / 2pi; power summed in double, in time order.
// state per channel: re (x1, x2, y1, y2), im (x1, x2, y1, y2)
__global__ void k12_peak_kernel(const float* __restrict__ re,
                                const float* __restrict__ im, int n,
                                int channels, float b0, float b1, float b2,
                                float a1, float a2,
                                const float* __restrict__ st_in,
                                float* __restrict__ st_out,
                                float* __restrict__ theta,
                                float* __restrict__ power) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= channels) return;
  const int ns = 8 * channels;  // state floats
  const int s0 = 8 * c;
  Peak2 pr{FMT_AT(st_in, s0, ns), FMT_AT(st_in, s0 + 1, ns),
           FMT_AT(st_in, s0 + 2, ns), FMT_AT(st_in, s0 + 3, ns)};
  Peak2 pi{FMT_AT(st_in, s0 + 4, ns), FMT_AT(st_in, s0 + 5, ns),
           FMT_AT(st_in, s0 + 6, ns), FMT_AT(st_in, s0 + 7, ns)};
  const float* xr = re + (int64_t)c * n;
  const float* xi = im + (int64_t)c * n;
  float* th = theta + (int64_t)c * n;
  double pw = 0.0;
  for (int i0 = 0; i0 < n; i0 += kBatch) {
    float br[kBatch], bi[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      br[u] = FMT_AT(xr, i0 + u, n);
      bi[u] = FMT_AT(xi, i0 + u, n);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const float yr = peak_step(pr, br[u], b0, b1, b2, a1, a2);
      const float yi = peak_step(pi, bi[u], b0, b1, b2, a1, a2);
      FMT_AT(th, i0 + u, n) = atan2_poly(yi, yr) * kInvTwoPi;
      pw += (double)(yr * yr + yi * yi);
    }
  }
  const float out[8] = {pr.x1, pr.x2, pr.y1, pr.y2,
                        pi.x1, pi.x2, pi.y1, pi.y2};
#pragma unroll
  for (int k = 0; k < 8; ++k) FMT_AT(st_out, s0 + k, ns) = out[k];
  FMT_AT(power, c, channels) = (float)pw;
}

// q[i] = q_i16(x[i], scale) for i < n: the int16 format's store of a plane
// that a serial kernel wrote as float32 (K2's theta: the peak IIR storing
// int16 itself, one 2-byte store per step or 16 at a time, was measured
// 0.2-0.65 ms slower per bench block than its float32 store plus this
// pass, PERF.md)
__global__ void q_i16_kernel(const float* __restrict__ x,
                             int16_t* __restrict__ q, int64_t n,
                             float scale) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) FMT_AT(q, i, n) = q_i16(FMT_AT(x, i, n), scale);
}

// The discriminator over theta1 [C, n4] -> fmd [C, n4] (float32 or int16).
template <class Out>
inline int launch_disc(const float* theta1, const float* prev_theta,
                       float scale, int channels, int n4, Out* fmd,
                       cudaStream_t stream) {
  k12_disc_kernel<Out><<<blocks_for((int64_t)channels * n4), kThreads, 0,
                         stream>>>(theta1, prev_theta, scale, channels, n4,
                                   fmd);
  FMT_CHECK_LAUNCH();
  return 0;
}

// The mid end on fmd [C, n4] (float32, or int16 at kFmScale dequantised by
// the ds x2's loads): ds x2 into fm_out [C, n4/2] (scratch), the optional
// de-emphasis in place, Hilbert -> re, im, and the peak IIR -> theta
// [C, n4/2] and the pilot power [C], all float32.  Given re16 (the int16
// format's outputs re16, im16, theta16), the Hilbert launch also writes
// re16, im16 at kIqScale and q_i16_kernel theta16 at kPhScale from theta;
// re, im and theta are then scratch.  n4/2 % kBatch == 0.
template <class In>
inline int launch_midend(const In* fmd, const float* w2_rev, int nn2,
                         const float* tail2, int use_deemph, float de_b0,
                         float de_b1, float de_a1, const float* de_st_in,
                         float* de_st_out, const float* wh_rev, int nh,
                         const float* htail, float pk_b0, float pk_b1,
                         float pk_b2, float pk_a1, float pk_a2,
                         const float* pk_st_in, float* pk_st_out,
                         int channels, int n4, float* fm_out, float* re,
                         float* im, float* theta, int16_t* re16,
                         int16_t* im16, int16_t* theta16, float* power,
                         cudaStream_t stream) {
  const int n8 = n4 / 2;
  const int64_t t8 = (int64_t)channels * n8;
  int err = fir_decimate(fmd, n4, tail2, w2_rev, nn2, 2, fm_out, channels,
                         stream, kFmScale);
  if (err) return err;
  if (use_deemph) {
    k12_deemph_kernel<<<blocks_for(channels, kSerialThreads),
                        kSerialThreads, 0, stream>>>(
        fm_out, n8, channels, de_b0, de_b1, de_a1, de_st_in, de_st_out);
    FMT_CHECK_LAUNCH();
  }
  if (re16 != nullptr) {
    k12_hilbert_kernel<true><<<blocks_for(t8), kThreads, 0, stream>>>(
        fm_out, htail, wh_rev, nh, channels, n8, re, im, re16, im16);
  } else {
    k12_hilbert_kernel<false><<<blocks_for(t8), kThreads, 0, stream>>>(
        fm_out, htail, wh_rev, nh, channels, n8, re, im, nullptr, nullptr);
  }
  FMT_CHECK_LAUNCH();
  k12_peak_kernel<<<blocks_for(channels, kSerialThreads), kSerialThreads, 0,
                    stream>>>(re, im, n8, channels, pk_b0, pk_b1, pk_b2,
                              pk_a1, pk_a2, pk_st_in, pk_st_out, theta,
                              power);
  FMT_CHECK_LAUNCH();
  if (re16 != nullptr) {
    q_i16_kernel<<<blocks_for(t8), kThreads, 0, stream>>>(theta, theta16, t8,
                                                          kPhScale);
    FMT_CHECK_LAUNCH();
  }
  return 0;
}

}  // namespace fmt
