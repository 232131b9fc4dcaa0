// Split K1: the front end of the demodulator on Hopper, on every ingest form.
//
// Replaces fm_radio_tpu/kernels/frontend_pallas.py::ds4_disc_pallas (:743,
// kernels _ds4_disc_kernel :223, _ds4_disc_packed_kernel :241,
// _ds4_disc_i8_kernel :263, core _ds4_disc_core :114) and its int8-direct
// form (:528, _ds4_disc_i8_direct_kernel :448): baseband IQ [C, B] -> ds x4
// LPF (64 taps) -> polynomial atan2 -> discriminator -> fm_demod [C, B/4]
// float32.  The carried input tail and the discriminator's last phase are
// assembled by the wrapper (kernels/frontend.py).
//
// fmt_frontend is one kernel templated on the load and on the arithmetic:
//   load   (re, im) float32 planes [2, C, B]; packed u8 words [C, B] float32,
//          w = I * 256 + Q, unpacked exactly and recentred by -127; or int8
//          planes [2, C, B] (u8 - 128), recentred by +1.  The carried tail
//          is float32 [2, C, nn - 4] in every form (the u8 - 127 values).
//   taps   float32: sum_k w_rev[k] * x[4j - halo + k] in float32, from the
//          oldest sample up, one fixed order (the TPU kernel's bf16 hi/lo
//          splits, frontend_pallas.py:65-92, existed only to reach float32 on
//          its matrix unit; the card has float32 units).  Or int8:
//          quantize_band_int8's two planes (b1, b2), the input shifted by -1
//          into int8 (truncated, as the TPU kernel's astype), four samples to
//          a word, accumulated exactly in int32 with __dp4a, combined as
//          y1 + y2 / 128 + s_row (frontend_pallas.py:133-170).  int8 taps
//          need integer input (u8 - 127 in [-127, 128]).
// Both entries store fm_demod as float32 or, with out_i16, in the int16
// inter-stage format at 2^15 (interstage_i16; the TPU kernels' out_i16
// stores, frontend_pallas.py:204-207 and :482-485): the discriminator's
// store is templated on its type, its phase carry stays float32, and K12
// keeps the float32 instantiation.
// fmt_frontend_i8 is the int8-direct form (int8 planes, int8 taps): K12's
// first two launches, shared through k12_stages.cuh, so the split int8 path
// equals K12 bit for bit.  The loads and the float-tap sum are
// frontend_stages.cuh, which the megakernel (chain.cu) runs too.
//
// What bounds it on this card: each output reads its 64-sample window from
// device memory (neighbouring threads share most of it through L1) and does
// 128 float32 multiply-adds (float taps) or 32 __dp4a (int8 taps) and one
// polynomial atan2 with a division.  Measured times are in PERF.md.  What
// the design does about it, for now: one thread per output, windows read
// directly (no shared-memory staging), ds x4 + atan2 in one launch and the
// discriminator in a second (as K12); register blocking and one launch are
// ROADMAP performance items.

#include "frontend_stages.cuh"
#include "k12_stages.cuh"

namespace fmt {

// ds x4 + atan2 on one ingest form: theta1[c, j] = angle(fm_in[c, j]).
// tail [2, C, halo] float32 (re rows, then im rows), halo = nn - 4.
template <class Load, bool kI8Taps>
__global__ void ds4_theta_kernel(Load in, const float* __restrict__ tail,
                                 const float* __restrict__ w_rev,
                                 const int* __restrict__ b1w,
                                 const int* __restrict__ b2w, int nn,
                                 float s_row, int channels, int n_in,
                                 float* __restrict__ theta1) {
  const int n_out = n_in / 4;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)channels * n_out) return;
  const int c = (int)(idx / n_out);
  const int j = (int)(idx % n_out);
  const int halo = nn - 4;
  const int64_t row = (int64_t)c * n_in;
  const float* tr = tail + (int64_t)c * halo;
  const float* ti = tail + ((int64_t)channels + c) * halo;
  const int base = 4 * j - halo;
  auto src = [&](int n, float& vr, float& vi) {
    if (n < 0) {
      vr = tr[halo + n];
      vi = ti[halo + n];
    } else {
      in.load(row, n, vr, vi);
    }
  };
  float fr, fi;
  if constexpr (kI8Taps) {
    ds4_i8(src, b1w, b2w, nn, s_row, base, fr, fi);
  } else {
    ds4_float(src, w_rev, nn, base, fr, fi);
  }
  theta1[idx] = atan2_poly(fi, fr);
}

template <class Load, bool kI8Taps>
int launch_ds4(Load in, const float* tail, const float* w_rev,
               const int8_t* b1, const int8_t* b2, int nn, float s_row,
               int channels, int b, float* theta1, cudaStream_t stream) {
  ds4_theta_kernel<Load, kI8Taps>
      <<<blocks_for((int64_t)channels * (b / 4)), kThreads, 0, stream>>>(
          in, tail, w_rev, (const int*)b1, (const int*)b2, nn, s_row,
          channels, b, theta1);
  FMT_CHECK_LAUNCH();
  return 0;
}

}  // namespace fmt

using namespace fmt;

namespace fmt {

// The discriminator's store: fmd float32, or int16 at kFmScale (out_i16)
inline int launch_disc_as(int out_i16, const float* theta1,
                          const float* prev_theta, float scale, int channels,
                          int n4, void* fmd, cudaStream_t stream) {
  return out_i16 ? launch_disc(theta1, prev_theta, scale, channels, n4,
                               (int16_t*)fmd, stream)
                 : launch_disc(theta1, prev_theta, scale, channels, n4,
                               (float*)fmd, stream);
}

}  // namespace fmt

// form: 0 = float32 planes [2, C, B], 1 = packed words [C, B] float32,
// 2 = int8 planes [2, C, B] (float taps only: int8 planes with int8 taps
// take fmt_frontend_i8).  tail [2, C, nn - 4] float32; w_rev [nn] float32
// (reversed taps); b1, b2 [nn] int8 (reversed, read as nn/4 int32 words,
// 4-byte aligned; used with int8_taps); prev_theta [C]; scratch theta1
// [C, B/4] float32 and output fmd [C, B/4], float32 or, with out_i16, the
// int16 inter-stage format.  nn % 4 == 0, B % 4 == 0.  Returns the first
// cudaError_t of the two launches (0 = both launched).
extern "C" int fmt_frontend(const void* x, int form, int int8_taps,
                            const float* tail, const float* w_rev,
                            const int8_t* b1, const int8_t* b2, int nn,
                            float s_row, const float* prev_theta, float scale,
                            int channels, int b, float* theta1, void* fmd,
                            int out_i16, cudaStream_t stream) {
  if (nn % 4 != 0 || nn < 4 || b % 4 != 0 || form < 0 || form > 2
      || (form == 2 && int8_taps)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t plane = (int64_t)channels * b;
  int err;
  if (form == 0) {
    const PlanesF32 in{(const float*)x, plane};
    err = int8_taps ? launch_ds4<PlanesF32, true>(in, tail, w_rev, b1, b2, nn,
                                                  s_row, channels, b, theta1,
                                                  stream)
                    : launch_ds4<PlanesF32, false>(in, tail, w_rev, b1, b2,
                                                   nn, s_row, channels, b,
                                                   theta1, stream);
  } else if (form == 1) {
    const PackedWords in{(const float*)x, plane};
    err = int8_taps ? launch_ds4<PackedWords, true>(in, tail, w_rev, b1, b2,
                                                    nn, s_row, channels, b,
                                                    theta1, stream)
                    : launch_ds4<PackedWords, false>(in, tail, w_rev, b1, b2,
                                                     nn, s_row, channels, b,
                                                     theta1, stream);
  } else {
    const I8Planes in{(const int8_t*)x, plane};
    err = launch_ds4<I8Planes, false>(in, tail, w_rev, b1, b2, nn, s_row,
                                      channels, b, theta1, stream);
  }
  if (err) return err;
  return launch_disc_as(out_i16, theta1, prev_theta, scale, channels, b / 4,
                        fmd, stream);
}

// The int8-direct form: x8 [2, C, B] int8 planes and tail8 [2, C, nn - 4]
// int8 (u8 - 128), both 4-byte aligned; b1, b2 [nn] int8 as above; the rest
// as fmt_frontend.  nn % 4 == 0, B % 4 == 0.
extern "C" int fmt_frontend_i8(const int8_t* x8, const int8_t* tail8,
                               const int8_t* b1, const int8_t* b2, int nn,
                               float s_row, const float* prev_theta,
                               float scale, int channels, int b,
                               float* theta1, void* fmd, int out_i16,
                               cudaStream_t stream) {
  if (nn % 4 != 0 || nn < 4 || b % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  k12_ds4_theta_kernel<<<blocks_for((int64_t)channels * (b / 4)), kThreads,
                         0, stream>>>(x8, tail8, (const int*)b1,
                                      (const int*)b2, nn, s_row, channels, b,
                                      theta1);
  FMT_CHECK_LAUNCH();
  return launch_disc_as(out_i16, theta1, prev_theta, scale, channels, b / 4,
                        fmd, stream);
}
