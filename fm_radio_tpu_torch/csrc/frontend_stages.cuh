// The float-tap front end's device code, shared by the split K1
// (frontend.cu) and the full-chain megakernel (chain.cu):
//
//   PlanesF32, PackedWords, I8Planes  load one sample of an ingest form as
//                                     the centred (u8 - 127) float pair
//   ds4_float                         the float32 ds x4 window sum, summed
//                                     from the oldest sample up
//
// K1 reads its windows from device memory and the megakernel from a tile
// in shared memory; both sum them through ds4_float, so the chain's K1
// equals the split K1 bit for bit (the discriminator is k12_stages.cuh's
// disc_value).
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

}  // namespace fmt
