// The float-tap front end's device code, shared by the split K1
// (frontend.cu) and the full-chain megakernel (chain.cu):
//
//   PlanesF32, PackedWords, I8Planes  load one sample of an ingest form as
//                                     the centred (u8 - 127) float pair
//   ds4_float                         the float32 ds x4 window sum, summed
//                                     from the oldest sample up
//   ds4_i8                            the int8-tap ds x4 window sum on
//                                     those float samples (__dp4a)
//
// K1 reads its windows from device memory and the megakernel from a tile
// in shared memory; both sum them through ds4_float, so the chain's K1
// equals the split K1 bit for bit (the discriminator is k12_stages.cuh's
// disc_value).  The K1 probe (frontend_probe.cu) sums through the same two
// functions.
#pragma once

#include "common.cuh"

namespace fmt {

// Sample n of a channel as the centred (u8 - 127) float pair; row is the
// channel's offset into one plane, plane the size of one plane.
struct PlanesF32 {
  const float* x;
  int64_t plane;
  __device__ __forceinline__ void load(int64_t row, int n, float& r,
                                       float& i) const {
    r = x[row + n];
    i = x[plane + row + n];
  }
};

struct PackedWords {
  const float* x;
  int64_t plane;  // unused: one word holds both
  __device__ __forceinline__ void load(int64_t row, int n, float& r,
                                       float& i) const {
    const float w = x[row + n];
    const float hi = floorf(w * (1.0f / 256.0f));  // exact below 2^16
    r = hi - 127.0f;
    i = (w - hi * 256.0f) - 127.0f;
  }
};

struct I8Planes {
  const int8_t* x;
  int64_t plane;
  __device__ __forceinline__ void load(int64_t row, int n, float& r,
                                       float& i) const {
    r = (float)x[row + n] + 1.0f;
    i = (float)x[plane + row + n] + 1.0f;
  }
};

// (fr, fi) = sum_k w_rev[k] * v[base + k] for k < nn, in float32 from k = 0
// up, where src(n, vr, vi) yields sample n of the window's (re, im).
template <class Src>
__device__ __forceinline__ void ds4_float(const Src& src,
                                          const float* __restrict__ w_rev,
                                          int nn, int base, float& fr,
                                          float& fi) {
  float ar = 0.0f, ai = 0.0f;
  for (int k = 0; k < nn; ++k) {
    float vr, vi;
    src(base + k, vr, vi);
    const float wk = __ldg(w_rev + k);
    ar += wk * vr;
    ai += wk * vi;
  }
  fr = ar;
  fi = ai;
}

// The input shifted by -1 into int8 (C conversion truncates, as astype).
__device__ __forceinline__ unsigned int i8_byte(float v, int u) {
  return ((unsigned int)(int)(v - 1.0f) & 0xffu) << (8 * u);
}

// (fr, fi) with the int8 taps: src(n, vr, vi)'s samples shifted into int8
// (i8_byte), four to a word, accumulated exactly in int32 with __dp4a
// against the reversed taps b1w, b2w (nn/4 words each), combined as
// y1 + y2 / 128 + s_row.
template <class Src>
__device__ __forceinline__ void ds4_i8(const Src& src,
                                       const int* __restrict__ b1w,
                                       const int* __restrict__ b2w, int nn,
                                       float s_row, int base, float& fr,
                                       float& fi) {
  int y1r = 0, y2r = 0, y1i = 0, y2i = 0;
  for (int w = 0; w < nn / 4; ++w) {
    unsigned int pr = 0u, pi = 0u;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float vr, vi;
      src(base + 4 * w + u, vr, vi);
      pr |= i8_byte(vr, u);
      pi |= i8_byte(vi, u);
    }
    const int w1 = __ldg(b1w + w), w2 = __ldg(b2w + w);
    y1r = __dp4a((int)pr, w1, y1r);
    y2r = __dp4a((int)pr, w2, y2r);
    y1i = __dp4a((int)pi, w1, y1i);
    y2i = __dp4a((int)pi, w2, y2i);
  }
  fr = ((float)y1r + (float)y2r * (1.0f / 128.0f)) + s_row;
  fi = ((float)y1i + (float)y2i * (1.0f / 128.0f)) + s_row;
}

}  // namespace fmt
