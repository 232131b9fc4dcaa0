// Split K2: the mid end of the demodulator on Hopper.
//
// Replaces fm_radio_tpu/kernels/midend_pallas.py::midend_pallas (:407,
// kernel _midend_kernel :225, body _midend_body :119): fm_demod [C, B/4]
// float32 -> ds x2 LPF (64 taps) -> optional 1-pole de-emphasis -> 65-tap
// Hilbert -> (re, im) [C, B/8] -> order-2 19 kHz peak IIR on both planes ->
// theta = angle / 2pi [C, B/8] and the pilot power sum [C].
//
// These are K12's last four launches (k12.cu), shared through
// k12_stages.cuh: one copy of the device code, so the split path's K1 + K2
// equal K12 bit for bit.  What bounds each launch and what the design does
// about it is noted in k12.cu (the FIR stages read their windows from
// device memory; the serial IIRs run one thread per channel).

#include "k12_stages.cuh"

using namespace fmt;

// fmd [C, n4]; w2_rev [nn2], tail2 [C, nn2 - 2]; de_st_* [C, 2] (x1, y1);
// wh_rev [nh], htail [C, nh - 1]; pk_st_* [C, 8] (re x1 x2 y1 y2, im x1 x2
// y1 y2); scratch fm_out and outputs re, im, theta [C, n4/2]; power [C].
// n4 % (2 * kBatch) == 0.  Returns the first cudaError_t of the launches.
extern "C" int fmt_midend(const float* fmd, const float* w2_rev, int nn2,
                          const float* tail2, int use_deemph, float de_b0,
                          float de_b1, float de_a1, const float* de_st_in,
                          float* de_st_out, const float* wh_rev, int nh,
                          const float* htail, float pk_b0, float pk_b1,
                          float pk_b2, float pk_a1, float pk_a2,
                          const float* pk_st_in, float* pk_st_out,
                          int channels, int n4, float* fm_out, float* re,
                          float* im, float* theta, float* power,
                          cudaStream_t stream) {
  if (n4 % (2 * kBatch) != 0 || nn2 < 2 || nh < 1) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_midend(fmd, w2_rev, nn2, tail2, use_deemph, de_b0, de_b1,
                       de_a1, de_st_in, de_st_out, wh_rev, nh, htail, pk_b0,
                       pk_b1, pk_b2, pk_a1, pk_a2, pk_st_in, pk_st_out,
                       channels, n4, fm_out, re, im, theta, power, stream);
}
