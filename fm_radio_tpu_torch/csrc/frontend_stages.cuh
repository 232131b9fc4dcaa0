// The float-tap front end's device code, shared by the split K1
// (frontend.cu) and the full-chain megakernel (chain.cu):
//
//   PlanesF32, PackedWords, I8Planes,  load one sample of an ingest form as
//   Complex64                          the centred (u8 - 127) float pair
//                                      (load), or four aligned ones (fetch
//                                      and unpack, K1's staged tile)
//   i8_byte                            a sample shifted into int8, for the
//                                      int8 taps' words
//
// K1 stages its tile in shared memory and sums it register-blocked
// (extract_stages.cuh::fir_block at the receiver's order, fir_block_any at
// others: each output from the oldest sample up, fir_dot's order); the
// megakernel sums its tile the same way, so the chain's K1 equals the
// split K1 bit for bit (the discriminator is k12_stages.cuh's
// disc_value).  The K1 probe
// (frontend_probe.cu) stages its tiles through these loads too and sums
// them as K1 does: fir_block for the float taps, K12's ds4_i8_window on
// i8_byte words for the int8 taps.
#pragma once

#include "common.cuh"

namespace fmt {

// Sample n of a channel as the centred (u8 - 127) float pair; row is the
// channel's offset into one plane (in samples), plane the size of one
// plane.  fetch loads samples n .. n + 3 (n % 4 == 0, the row 16-byte
// aligned) with vector loads as they lie in memory (Raw), unpack turns
// them into the centred pairs: a tile issues all its fetches before the
// first unpack waits on one.  load4 is the two in turn.
struct PlanesF32 {
  const float* x;
  int64_t plane;
  struct Raw {
    float4 a, b;
  };
  __device__ __forceinline__ void load(int64_t row, int n, float& r,
                                       float& i) const {
    r = x[row + n];
    i = x[plane + row + n];
  }
  __device__ __forceinline__ Raw fetch(int64_t row, int n) const {
    return {*reinterpret_cast<const float4*>(
                FMT_SPAN(x, row + n, 4, 2 * plane)),
            *reinterpret_cast<const float4*>(
                FMT_SPAN(x, plane + row + n, 4, 2 * plane))};
  }
  __device__ __forceinline__ static void unpack(const Raw& w, float (&r)[4],
                                                float (&i)[4]) {
    r[0] = w.a.x, r[1] = w.a.y, r[2] = w.a.z, r[3] = w.a.w;
    i[0] = w.b.x, i[1] = w.b.y, i[2] = w.b.z, i[3] = w.b.w;
  }
  __device__ __forceinline__ void load4(int64_t row, int n, float (&r)[4],
                                        float (&i)[4]) const {
    unpack(fetch(row, n), r, i);
  }
};

struct PackedWords {
  const float* x;
  int64_t plane;  // unused: one word holds both
  using Raw = float4;
  __device__ __forceinline__ static void unpack1(float w, float& r,
                                                 float& i) {
    const float hi = floorf(w * (1.0f / 256.0f));  // exact below 2^16
    r = hi - 127.0f;
    i = (w - hi * 256.0f) - 127.0f;
  }
  __device__ __forceinline__ void load(int64_t row, int n, float& r,
                                       float& i) const {
    unpack1(x[row + n], r, i);
  }
  __device__ __forceinline__ Raw fetch(int64_t row, int n) const {
    return *reinterpret_cast<const float4*>(FMT_SPAN(x, row + n, 4, plane));
  }
  __device__ __forceinline__ static void unpack(const Raw& w, float (&r)[4],
                                                float (&i)[4]) {
    unpack1(w.x, r[0], i[0]);
    unpack1(w.y, r[1], i[1]);
    unpack1(w.z, r[2], i[2]);
    unpack1(w.w, r[3], i[3]);
  }
  __device__ __forceinline__ void load4(int64_t row, int n, float (&r)[4],
                                        float (&i)[4]) const {
    unpack(fetch(row, n), r, i);
  }
};

struct I8Planes {
  const int8_t* x;
  int64_t plane;
  struct Raw {
    char4 a, b;
  };
  __device__ __forceinline__ void load(int64_t row, int n, float& r,
                                       float& i) const {
    r = (float)x[row + n] + 1.0f;
    i = (float)x[plane + row + n] + 1.0f;
  }
  __device__ __forceinline__ Raw fetch(int64_t row, int n) const {
    return {*reinterpret_cast<const char4*>(
                FMT_SPAN(x, row + n, 4, 2 * plane)),
            *reinterpret_cast<const char4*>(
                FMT_SPAN(x, plane + row + n, 4, 2 * plane))};
  }
  __device__ __forceinline__ static void unpack(const Raw& w, float (&r)[4],
                                                float (&i)[4]) {
    r[0] = (float)w.a.x + 1.0f, r[1] = (float)w.a.y + 1.0f;
    r[2] = (float)w.a.z + 1.0f, r[3] = (float)w.a.w + 1.0f;
    i[0] = (float)w.b.x + 1.0f, i[1] = (float)w.b.y + 1.0f;
    i[2] = (float)w.b.z + 1.0f, i[3] = (float)w.b.w + 1.0f;
  }
  __device__ __forceinline__ void load4(int64_t row, int n, float (&r)[4],
                                        float (&i)[4]) const {
    unpack(fetch(row, n), r, i);
  }
};

// complex64 [C, B] read in place as interleaved (re, im) float pairs: the
// same samples as the float32 planes that torch.stack([x.real, x.imag])
// would make, without that copy
struct Complex64 {
  const float* x;  // view_as_real: [C, B, 2]
  int64_t plane;   // C B: the samples of all channels
  struct Raw {
    float4 a, b;
  };
  __device__ __forceinline__ void load(int64_t row, int n, float& r,
                                       float& i) const {
    r = x[2 * (row + n)];
    i = x[2 * (row + n) + 1];
  }
  __device__ __forceinline__ Raw fetch(int64_t row, int n) const {
    const float4* p = reinterpret_cast<const float4*>(
        FMT_SPAN(x, 2 * (row + n), 8, 2 * plane));
    return {p[0], p[1]};
  }
  __device__ __forceinline__ static void unpack(const Raw& w, float (&r)[4],
                                                float (&i)[4]) {
    r[0] = w.a.x, i[0] = w.a.y, r[1] = w.a.z, i[1] = w.a.w;
    r[2] = w.b.x, i[2] = w.b.y, r[3] = w.b.z, i[3] = w.b.w;
  }
  __device__ __forceinline__ void load4(int64_t row, int n, float (&r)[4],
                                        float (&i)[4]) const {
    unpack(fetch(row, n), r, i);
  }
};

// The input shifted by -1 into int8 (C conversion truncates, as astype).
__device__ __forceinline__ unsigned int i8_byte(float v, int u) {
  return ((unsigned int)(int)(v - 1.0f) & 0xffu) << (8 * u);
}

}  // namespace fmt
