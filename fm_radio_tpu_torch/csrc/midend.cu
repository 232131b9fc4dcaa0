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
// fmt_midend_route): with de-emphasis off, in float32 and in every int16
// form, the fused route (ds x2 and Hilbert in one tiled kernel with fm_out
// in shared memory); with de-emphasis on, one launch per stage up to
// Hilbert.  Both end with the peak IIR cut to its recurrence and a parallel
// theta pass.  What bounds each and what the design does about it is noted
// in k12.cu and k12_stages.cuh.
//
// The int16 inter-stage format (interstage_i16; the TPU kernel's in_i16
// :246 and out_i16 :254-257): fm_demod may arrive as int16 at 2^15, which
// the loads of the ds x2 dequantise (no separate dequantising pass: halving
// those bytes is the format's purpose); with the int16 outputs, re and im
// leave as int16 at 2^14 and theta at 2^16.  The de-emphasis, the Hilbert
// FIR, the peak IIR and the power sum run on float32 values as before: the
// fused kernel (or the Hilbert launch) writes re/im as float32 scratch,
// which the peak IIR's recurrence reads, and quantised as the outputs; the
// theta pass quantises theta as it stores it.  Bytes per output sample n8
// (C * B/8 of them) on the fused route: float32 44 (fmd 8 in, re/im 8 out;
// the recurrence 8 in, 8 out; the theta pass 8 in, 4 out), int16 in and
// out 42 (fmd 4 in; re/im 8 + 4 out; theta 2 out); the consumers, the PLL
// and extract, read 12 -> 6.

#include "k12_stages.cuh"

using namespace fmt;

// fmd [C, n4] float32, or int16 (in_i16); w2_rev [nn2], tail2 [C, nn2 - 2];
// de_st_* [C, 2] (x1, y1); wh_rev [nh], htail [C, nh - 1]; pk_st_* [C, 8]
// (re x1 x2 y1 y2, im x1 x2 y1 y2); re, im, theta [C, n4/2] float32, the
// outputs, or, given re16, im16 and theta16 [C, n4/2] int16 (all three or
// none), scratch beside those outputs; power [C]; the scratch yi
// [C, n4/2].  By midend_route (fmt_midend_route): on the fused route the
// output tails [C, (nn2 - 2) + (nh - 1)] (the new ds x2 and Hilbert tails),
// fm_out unused; on the launches route the scratch fm_out [C, n4/2],
// tails unused.  n4 % (2 * kBatch) == 0.  Returns the first cudaError_t of
// the launches.
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
  const int route = midend_route(use_deemph, nn2, nh, n4);
  if (n4 % (2 * kBatch) != 0 || nn2 < 2 || nh < 1 ||
      (re16 == nullptr) != (im16 == nullptr) ||
      (re16 == nullptr) != (theta16 == nullptr) ||
      yi == nullptr ||
      (route == kMidFused ? tails == nullptr : fm_out == nullptr)) {
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
// format: 1 fused, 0 launches (kernels/midend.py::midend_route is its host
// copy, which the wrappers allocate by).
extern "C" int fmt_midend_route(int use_deemph, int nn2, int nh, int n4) {
  return midend_route(use_deemph, nn2, nh, n4);
}
