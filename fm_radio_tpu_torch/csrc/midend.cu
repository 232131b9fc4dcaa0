// Split K2: the mid end of the demodulator on Hopper.
//
// Replaces fm_radio_tpu/kernels/midend_pallas.py::midend_pallas (:407,
// kernel _midend_kernel :225, body _midend_body :119): fm_demod [C, B/4]
// float32 -> ds x2 LPF (64 taps) -> optional 1-pole de-emphasis -> 65-tap
// Hilbert -> (re, im) [C, B/8] -> order-2 19 kHz peak IIR on both planes ->
// theta = angle / 2pi [C, B/8] and the pilot power sum [C].
//
// This is K12's mid end (k12.cu), shared through k12_stages.cuh: one copy
// of the device code, so the split path's K1 + K2 equal K12 bit for bit.
// launch_midend picks the route (midend_route, exported as
// fmt_midend_route), in float32 and in every int16 form alike: at every
// filter order within the 128-sample halo the split route (a tiled ds x2
// kernel and a tiled Hilbert kernel, with the serial de-emphasis between
// them where it is on; at other orders than the receiver's their
// any-order forms); on a block shorter than a carried tail one launch per
// stage up to Hilbert.  Every route
// ends with the peak IIR cut to its recurrence and a parallel theta pass.
// What bounds each and what the design does about it is noted in k12.cu
// and k12_stages.cuh.
//
// The int16 inter-stage format (interstage_i16; the TPU kernel's in_i16
// :246 and out_i16 :254-257): fm_demod may arrive as int16 at 2^15, which
// the loads of the ds x2 dequantise (no separate dequantising pass: halving
// those bytes is the format's purpose); with the int16 outputs, re and im
// leave as int16 at 2^14 and theta at 2^16.  The de-emphasis, the Hilbert
// FIR, the peak IIR and the power sum run on float32 values as before: the
// Hilbert launch writes re/im as float32 scratch, which the peak IIR's
// recurrence reads, and quantised as the outputs; the theta pass quantises
// theta as it stores it.  Bytes per output sample n8 (C * B/8 of them) on
// the split route without de-emphasis: float32 52 (fmd 8 in, fm_out 4 out
// and 4 in, re/im 8 out; the recurrence 8 in, 8 out; the theta pass 8 in,
// 4 out), int16 in and out 50 (fmd 4 in; re/im 8 + 4 out; theta 2 out);
// the consumers, the PLL and extract, read 12 -> 6.

#include "k12_stages.cuh"

using namespace fmt;

// fmd [C, n4] float32, or int16 (in_i16); w2_rev [nn2], tail2 [C, nn2 - 2];
// de_st_* [C, 2] (x1, y1); wh_rev [nh], htail [C, nh - 1]; pk_st_* [C, 8]
// (re x1 x2 y1 y2, im x1 x2 y1 y2); re, im, theta [C, n4/2] float32, the
// outputs, or, given re16, im16 and theta16 [C, n4/2] int16 (all three or
// none), scratch beside those outputs; power [C]; the scratch yi
// [C, n4/2]; the scratch fm_out [C, n4/2] (whose last nh - 1 samples are
// the new Hilbert tail).  By midend_route (fmt_midend_route): on the split
// route the output tails [C, nn2 - 2] (the new ds x2 tail; null only where
// it is empty); on the launches route tails unused; orders past the halo
// refused.  n4 % (2 * kBatch) == 0.
// Returns the first cudaError_t of the launches.
extern "C" int fmt_midend(const void* fmd, int in_i16, const float* w2_rev,
                          int nn2, const float* tail2, int use_deemph,
                          float de_b0, float de_b1, float de_a1,
                          const float* de_st_in, float* de_st_out,
                          const float* wh_rev, int nh, const float* htail,
                          float pk_b0, float pk_b1, float pk_b2, float pk_a1,
                          float pk_a2, const float* pk_st_in,
                          float* pk_st_out, int channels, int n4,
                          float* fm_out, float* re, float* im, float* theta,
                          int16_t* re16, int16_t* im16, int16_t* theta16,
                          float* power, float* yi, float* tails,
                          cudaStream_t stream) {
  const int route = midend_route(nn2, nh, n4);
  if (n4 % (2 * kBatch) != 0 || route == kMidRefused ||
      (re16 == nullptr) != (im16 == nullptr) ||
      (re16 == nullptr) != (theta16 == nullptr) || yi == nullptr ||
      (route == kMidSplit && tails == nullptr && nn2 > 2) ||
      fm_out == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
#define FMT_MIDEND_ARGS                                                     \
  w2_rev, nn2, tail2, use_deemph, de_b0, de_b1, de_a1, de_st_in, de_st_out, \
      wh_rev, nh, htail, pk_b0, pk_b1, pk_b2, pk_a1, pk_a2, pk_st_in,        \
      pk_st_out, channels, n4, fm_out, re, im, theta, re16, im16, theta16,  \
      power, stream, yi, tails
  const int err = in_i16 ? launch_midend((const int16_t*)fmd, FMT_MIDEND_ARGS)
                         : launch_midend((const float*)fmd, FMT_MIDEND_ARGS);
#undef FMT_MIDEND_ARGS
  return err;
}

// The route fmt_midend and fmt_k12 take for these arguments, in every
// format and with de-emphasis on or off: 1 split, 0 launches, -1 refused
// (kernels/midend.py::midend_route is its host copy, which the wrappers
// allocate by).
extern "C" int fmt_midend_route(int nn2, int nh, int n4) {
  return midend_route(nn2, nh, n4);
}

// The split route's two tiled kernels alone (kernels/midend.py::
// mid_ds2, mid_hilb: the card's comparisons and timings of each kernel).
// ds x2: src [C, n4] by form (0 float32 fm_demod, 1 int16 fm_demod at
// kFmScale, 2 theta1 float32 with prev_theta [C] and the discriminator's
// scale, K12's form); w2_rev [nn2], tail2 [C, nn2 - 2] -> fm_out [C, n4/2]
// and the new ds x2 tail tails [C, nn2 - 2] (k12_mid_ds2_kernel at 64
// taps, k12_mid_ds2_any_kernel at any other nn2 the halo admits).
// 2 <= nn2 <= kMaxNn2, n4 % 16 == 0, n4 >= nn2 - 2.
extern "C" int fmt_mid_ds2(const void* src, int form,
                           const float* prev_theta, float scale,
                           const float* w2_rev, int nn2, const float* tail2,
                           int channels, int n4, float* fm_out, float* tails,
                           cudaStream_t stream) {
  if (form == 0)
    return launch_mid_ds2<false>((const float*)src, nullptr, 1.0f, w2_rev,
                                 nn2, tail2, channels, n4, fm_out, tails,
                                 stream);
  if (form == 1)
    return launch_mid_ds2<false>((const int16_t*)src, nullptr, 1.0f, w2_rev,
                                 nn2, tail2, channels, n4, fm_out, tails,
                                 stream);
  if (form == 2)
    return launch_mid_ds2<true>((const float*)src, prev_theta, scale, w2_rev,
                                nn2, tail2, channels, n4, fm_out, tails,
                                stream);
  return (int)cudaErrorInvalidValue;
}

// Hilbert: fm_out [C, n8], wh_rev [nh], htail [C, nh - 1] -> re, im
// [C, n8] float32 and, given re16 and im16, int16 at kIqScale
// (k12_mid_hilb_kernel at 65 taps, k12_mid_hilb_any_kernel at any other
// nh the halo admits).  1 <= nh <= kMaxNh, n8 % 8 == 0, n8 >= nh - 1.
extern "C" int fmt_mid_hilb(const float* fm_out, const float* wh_rev, int nh,
                            const float* htail, int channels, int n8,
                            float* re, float* im, int16_t* re16,
                            int16_t* im16, cudaStream_t stream) {
  return launch_mid_hilb(fm_out, wh_rev, nh, htail, channels, n8, re, im,
                         re16, im16, stream);
}

// The de-emphasis recurrence alone (kernels/midend.py::deemph: the card's
// comparisons and timings of k12_deemph_kernel): x [C, n] -> y [C, n]
// (x == y: in place, as the routes run it), de_st_in / de_st_out [C, 2]
// (x1, y1).  n % kBatch == 0 and x, y 16-byte aligned, as the bulk copies
// and the batches' stores need.
extern "C" int fmt_deemph(const float* x, float* y, int n, int channels,
                          float b0, float b1, float a1, const float* de_st_in,
                          float* de_st_out, cudaStream_t stream) {
  if (n % kBatch || ((uintptr_t)x | (uintptr_t)y) % 16 || channels < 1)
    return (int)cudaErrorInvalidValue;
  return launch_deemph(x, y, n, channels, b0, b1, a1, de_st_in, de_st_out,
                       stream);
}
