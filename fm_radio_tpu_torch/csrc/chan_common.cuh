// The channelizer kernels' shared device code: the input sample, the int8
// bridge's quantiser and the carried-state kernel (csrc/channelizer.cu, the
// exact float32 filterbank, and csrc/channelizer_wgmma.cu, its int8 and
// bf16 matrix modes).
#pragma once

#include "common.cuh"

namespace fmt {

// output forms (kernels/channelizer.py::OUTS)
enum ChanOut { kOutF32 = 0, kOutI8 = 1, kOutI8PS = 2 };

// sample s of x_pad = [state | x] for one capture, centred float32
template <bool kPacked>
__device__ __forceinline__ void chan_sample(const float* __restrict__ x0,
                                            const float* __restrict__ x1,
                                            const float* __restrict__ sr,
                                            const float* __restrict__ si,
                                            int64_t s, int n_state,
                                            float& re, float& im) {
  if (s < n_state) {
    re = sr[s];
    im = si[s];
    return;
  }
  const int64_t t = s - n_state;
  if (kPacked) {
    const float w = x0[t];
    const float ihi = floorf(w * (1.0f / 256.0f));
    re = ihi - 127.0f;
    im = (w - ihi * 256.0f) - 127.0f;
  } else {
    re = x0[t];
    im = x1[t];
  }
}

// u8-grid int8 of one channel sample: clip(rint(v * inv_m) - 1, -128, 127)
__device__ __forceinline__ int8_t chan_q8(float v, float inv_m) {
  const float q = fminf(fmaxf(rintf(v * inv_m) - 1.0f, -128.0f), 127.0f);
  return (int8_t)(int)q;
}

// new carried state: the last (K-1)*M samples of x_pad, per capture
template <bool kPacked>
__global__ void chan_state_kernel(const float* __restrict__ x0,
                                  const float* __restrict__ x1,
                                  const float* __restrict__ sr,
                                  const float* __restrict__ si, int n_state,
                                  int n_captures, int64_t t_len,
                                  float* __restrict__ sr_out,
                                  float* __restrict__ si_out) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)n_captures * n_state;
  if (idx >= total) return;
  const int w = (int)(idx / n_state);
  const int i = (int)(idx % n_state);
#ifdef FMT_CHECKED
  // the one element chan_sample reads: sample t_len + i of x_pad
  const int64_t s = t_len + i, n_x = (int64_t)n_captures * t_len;
  if (s < n_state) {
    FMT_AT(sr, (int64_t)w * n_state + s, total);
    FMT_AT(si, (int64_t)w * n_state + s, total);
  } else {
    FMT_AT(x0, (int64_t)w * t_len + s - n_state, n_x);
    if (!kPacked) FMT_AT(x1, (int64_t)w * t_len + s - n_state, n_x);
  }
#endif
  float re, im;
  chan_sample<kPacked>(x0 + (int64_t)w * t_len,
                       kPacked ? nullptr : x1 + (int64_t)w * t_len,
                       sr + (int64_t)w * n_state, si + (int64_t)w * n_state,
                       t_len + i, n_state, re, im);
  FMT_AT(sr_out, idx, total) = re;
  FMT_AT(si_out, idx, total) = im;
}

}  // namespace fmt
