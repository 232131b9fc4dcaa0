// Split K1: the front end of the demodulator on Hopper, on every ingest form.
//
// Replaces fm_radio_tpu/kernels/frontend_pallas.py::ds4_disc_pallas (:743,
// kernels _ds4_disc_kernel :223, _ds4_disc_packed_kernel :241,
// _ds4_disc_i8_kernel :263, core _ds4_disc_core :114) and its int8-direct
// form (:528, _ds4_disc_i8_direct_kernel :448): baseband IQ [C, B] -> ds x4
// LPF (64 taps) -> polynomial atan2 -> discriminator -> fm_demod [C, B/4]
// float32, in one launch.  The carried input tail is assembled by the
// wrapper (kernels/frontend.py); the discriminator's last phase is written
// by the kernel (theta_last [C]).
//
// fmt_frontend takes every load and both arithmetics:
//   load   (re, im) float32 planes [2, C, B]; packed u8 words [C, B] float32,
//          w = I * 256 + Q, unpacked exactly and recentred by -127; int8
//          planes [2, C, B] (u8 - 128), recentred by +1; or complex64 [C, B]
//          read in place as interleaved float pairs (the JAX package splits
//          it into planes first, demod.py:248-249: the same samples).  The
//          carried tail is float32 [2, C, nn - 4] in every form (the u8 - 127
//          values), and its int8 image (truncated u8 - 128) for int8 taps.
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
// stores, frontend_pallas.py:204-207 and :482-485) through the templated
// store of k12_stages.cuh::ds4_finish; the phase carry stays float32.
// fmt_frontend_i8 is the int8-direct form (int8 planes, int8 taps): K12's
// first launch (k12_stages.cuh::ds4_i8_blocked_kernel) with the
// discriminator's store, so the split int8 path equals K12 bit for bit.
//
// What bounds it on this card, and what the design does about it (times
// in PERF.md, NVIDIA H100 80GB HBM3 at 700 W):
// - The float taps: 64 products and 64 sums an output on each plane, each
//   rounded (-fmad=false keeps the plain version's order), ~17 G float32
//   instructions a block at C = 2048: an issue floor of ~0.5 ms at 128 a
//   clock an SM, above the byte bound of packed words.  The kernel
//   (k1_tile_kernel) stages a tile of kDs4Tile outputs' samples (4 kDs4Tile
//   + the nn-sample halo, the carried tail for a channel's first tile) once
//   as centred float32 re and im planes, skewed in shared memory: each
//   input sample is loaded, and a packed word unpacked, once, not once for
//   each of the 16 outputs whose window holds it.  The sum is
//   extract_stages.cuh::fir_block<4, 8, 64, 4>, register-blocked, one
//   shared-memory load for eight multiply-adds, in ds4_float's order.
// - The int8 taps: k12_stages.cuh::ds4_i8_blocked_kernel over the tile's
//   samples packed into int8 words once (LoadI8).
// - The discriminator is in the same launch: theta1 (268 MB a block at the
//   cell) never goes to device memory and back.

#include "extract_stages.cuh"
#include "frontend_stages.cuh"
#include "k12_stages.cuh"

namespace fmt {

// The int8 words of a float ingest form: four centred samples shifted by -1
// into int8 (i8_byte's truncation), for the int8-tap forms
template <class Load>
struct LoadI8 {
  Load in;
  int n_in;
  using Raw = typename Load::Raw;
  __device__ __forceinline__ Raw fetch(int c, int, int q) const {
    return in.fetch((int64_t)c * n_in, 4 * q);
  }
  __device__ __forceinline__ static void words_of(const Raw& w, int& wr,
                                                  int& wi) {
    float r[4], i[4];
    Load::unpack(w, r, i);
    unsigned int pr = 0u, pi = 0u;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      pr |= i8_byte(r[u], u);
      pi |= i8_byte(i[u], u);
    }
    wr = (int)pr;
    wi = (int)pi;
  }
};

// The float K1's tile: kDs4Tile outputs a CTA, kK1Run a lane (fir_block's
// R; 32 lanes x 8 outputs = 256 a warp); warps 0-3 sum the re plane, warps
// 4-7 the im plane (half the registers a thread of one that sums both:
// twice the warps an SM to hide the shared-memory and sum latencies), at the
// receiver's order kK1Taps register-blocked; other orders sum each output
// by itself, in the same order.
constexpr int kK1Run = 8;
constexpr int kK1Runs = kDs4Tile / kK1Run;  // runs a tile (a plane's lanes)
constexpr int kK1Threads = 2 * kK1Runs;
constexpr int kK1Taps = 64;

// a staged plane's floats (samples 4 t0 - nn .. 4 t0 + 4 kDs4Tile - 1,
// skewed), rounded up to a whole float4
__host__ __device__ constexpr int k1_plane(int nn) {
  return (mid_skew(nn + 4 * kDs4Tile - 1) + 1 + 3) / 4 * 4;
}
// the planes, the taps, the im sums (kDs4Tile) and the runs' last phases
inline size_t k1_smem(int nn) {
  return sizeof(float) * (2 * (size_t)k1_plane(nn) + (nn + 3) / 4 * 4 +
                          kDs4Tile + kK1Runs);
}

// ds x4 (float taps) + atan2 + the discriminator (st) of one channel's
// tile (blockIdx.y the channel, blockIdx.x the tile).  Plane index e holds
// sample 4 t0 - nn + e (e < 0 ... the tail [2, C, nn - 4], before it 0;
// past the row 0); output t0 + u sums e = 4 u + 4 + k, k < nn.
template <class Load, class Store>
__global__ void __launch_bounds__(kK1Threads)
k1_tile_kernel(Load in, const float* __restrict__ tail,
               const float* __restrict__ w_rev, int nn, int channels,
               int n_in, Store st) {
  extern __shared__ __align__(16) float k1_sm[];
  const int plane = k1_plane(nn);
  float* s_re = k1_sm;
  float* s_im = s_re + plane;
  float* s_w = s_im + plane;
  float* s_fi = s_w + (nn + 3) / 4 * 4;
  float* s_last = s_fi + kDs4Tile;
  const int c = blockIdx.y, tid = threadIdx.x;
  const int n = n_in / 4;
  const int t0 = blockIdx.x * kDs4Tile;
  for (int k = tid; k < nn; k += kK1Threads) s_w[k] = FMT_AT(w_rev, k, nn);
  const int halo = nn - 4;
  const int64_t row = (int64_t)c * n_in;
  const int n_g = nn / 4 + kDs4Tile;  // groups of four samples
  auto put = [&](int g, const float (&r)[4], const float (&i)[4]) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      s_re[mid_skew(4 * g + u)] = r[u];
      s_im[mid_skew(4 * g + u)] = i[u];
    }
  };
  if (4 * t0 - nn >= 0 && t0 + kDs4Tile <= n) {
    // a tile inside the row: kStage groups a thread in flight, all fetched
    // before the first is unpacked and stored (the receiver's halo fits
    // one round)
    constexpr int kStage = (kDs4Tile + 64) / kK1Threads + 1;
    for (int g0 = 0; g0 < n_g; g0 += kStage * kK1Threads) {
      typename Load::Raw raw[kStage];
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        const int g = g0 + tid + k * kK1Threads;
        if (g < n_g) raw[k] = in.fetch(row, 4 * (t0 - nn / 4 + g));
      }
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        const int g = g0 + tid + k * kK1Threads;
        if (g < n_g) {
          float r[4], i[4];
          Load::unpack(raw[k], r, i);
          put(g, r, i);
        }
      }
    }
  } else {
    // the channel's first tile (the carried tail, zeros before it) or its
    // last (zeros past the row)
    const float* tr = tail + (int64_t)c * halo;
    const float* ti = tail + ((int64_t)channels + c) * halo;
    for (int g = tid; g < n_g; g += kK1Threads) {
      const int m = 4 * (t0 - nn / 4 + g);
      float r[4] = {0.0f, 0.0f, 0.0f, 0.0f}, i[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (m >= 0) {
        if (m < n_in) in.load4(row, m, r, i);
      } else if (m >= -halo) {
        const float4 a = *reinterpret_cast<const float4*>(
            FMT_SPAN(tr, halo + m, 4, halo));
        const float4 b = *reinterpret_cast<const float4*>(
            FMT_SPAN(ti, halo + m, 4, halo));
        r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
        i[0] = b.x, i[1] = b.y, i[2] = b.z, i[3] = b.w;
      }
      put(g, r, i);
    }
  }
  __syncthreads();

  // warp w sums plane w / 4 for the outputs 256 (w % 4) + 8 lane + r
  const int warp = tid / 32, lane = tid % 32;
  const int wq = warp % 4, run = 32 * wq + lane;
  const float* sp = warp < 4 ? s_re : s_im;
  float acc[kK1Run];
  if (nn == kK1Taps) {
    // the outputs of warp quarter wq start at e = 1024 wq: mid_skew(1024 wq
    // + b) = 1056 wq + mid_skew(b)
    fir_block<4, kK1Run, kK1Taps, 4>(sp + 1056 * wq, lane, s_w, acc);
  } else {
#pragma unroll
    for (int r = 0; r < kK1Run; ++r) {
      const int base = 4 * (kK1Run * run + r) + 4;
      float a = 0.0f;
      for (int k = 0; k < nn; ++k) a += s_w[k] * sp[mid_skew(base + k)];
      acc[r] = a;
    }
  }
  // the im sums to the re warps: s_fi[r kK1Runs + run], conflict-free
  if (warp >= 4) {
#pragma unroll
    for (int r = 0; r < kK1Run; ++r) s_fi[r * kK1Runs + run] = acc[r];
  }
  float extra = 0.0f;
  if (tid == 0 && t0 > 0) {  // output t0 - 1: e = k
    float a = 0.0f, b = 0.0f;
    for (int k = 0; k < nn; ++k) {
      a += s_w[k] * s_re[mid_skew(k)];
      b += s_w[k] * s_im[mid_skew(k)];
    }
    extra = atan2_poly(b, a);
  }
  __syncthreads();
  float th[kK1Run];
  if (warp < 4) {
#pragma unroll
    for (int r = 0; r < kK1Run; ++r)
      th[r] = atan2_poly(s_fi[r * kK1Runs + run], acc[r]);
  }
  ds4_finish<kK1Run>(st, c, channels, n, t0, warp < 4 ? run : -1, th, extra,
                     s_last);
}

template <class Load, class Store>
inline int launch_k1_float(Load in, const float* tail, const float* w_rev,
                           int nn, int channels, int n_in, Store st,
                           cudaStream_t stream) {
  const size_t smem = k1_smem(nn);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int n = n_in / 4;
  const dim3 grid((unsigned)((n + kDs4Tile - 1) / kDs4Tile),
                  (unsigned)channels);
  k1_tile_kernel<Load, Store><<<grid, kK1Threads, smem, stream>>>(
      in, tail, w_rev, nn, channels, n_in, st);
  FMT_CHECK_LAUNCH();
  return 0;
}

// K1 on one load form: float or int8 taps, the discriminator's store into
// fmd (Out: float32, or int16 at kFmScale) and theta_last
template <class Load, class Out>
inline int launch_k1(Load in, int int8_taps, const float* tail,
                     const int8_t* tail8, const float* w_rev,
                     const int8_t* b1, const int8_t* b2, int nn, float s_row,
                     const float* prev_theta, float scale, int channels,
                     int b, Out* fmd, float* theta_last,
                     cudaStream_t stream) {
  const Ds4Disc<Out> st{fmd, prev_theta, theta_last, scale};
  if (int8_taps)
    return launch_ds4_i8(LoadI8<Load>{in, b}, tail8, b1, b2, nn, s_row,
                         channels, b, st, stream);
  return launch_k1_float(in, tail, w_rev, nn, channels, b, st, stream);
}

template <class Out>
inline int launch_k1_form(const void* x, int form, int int8_taps,
                          const float* tail, const int8_t* tail8,
                          const float* w_rev, const int8_t* b1,
                          const int8_t* b2, int nn, float s_row,
                          const float* prev_theta, float scale, int channels,
                          int b, Out* fmd, float* theta_last,
                          cudaStream_t stream) {
  const int64_t plane = (int64_t)channels * b;
  switch (form) {
    case 0:
      return launch_k1(PlanesF32{(const float*)x, plane}, int8_taps, tail,
                       tail8, w_rev, b1, b2, nn, s_row, prev_theta, scale,
                       channels, b, fmd, theta_last, stream);
    case 1:
      return launch_k1(PackedWords{(const float*)x, plane}, int8_taps, tail,
                       tail8, w_rev, b1, b2, nn, s_row, prev_theta, scale,
                       channels, b, fmd, theta_last, stream);
    case 3:
      return launch_k1(Complex64{(const float*)x, plane}, int8_taps, tail,
                       tail8, w_rev, b1, b2, nn, s_row, prev_theta, scale,
                       channels, b, fmd, theta_last, stream);
    default:  // int8 planes, float taps (int8 taps: fmt_frontend_i8)
      return launch_k1_float(I8Planes{(const int8_t*)x, plane}, tail, w_rev,
                             nn, channels, b,
                             Ds4Disc<Out>{fmd, prev_theta, theta_last, scale},
                             stream);
  }
}

}  // namespace fmt

using namespace fmt;

// form: 0 = float32 planes [2, C, B], 1 = packed words [C, B] float32,
// 2 = int8 planes [2, C, B] (float taps only: int8 planes with int8 taps
// take fmt_frontend_i8), 3 = complex64 [C, B] (interleaved float pairs);
// x 16-byte aligned (int8 planes: 4-byte).  tail [2, C, nn - 4] float32
// (16-byte aligned rows: nn % 4 == 0); with int8_taps tail8 [2, C, nn - 4]
// int8 (4-byte aligned; may be null without); w_rev [nn] float32 (reversed
// taps); b1, b2 [nn] int8 (reversed, read as nn/4 int32 words, 4-byte
// aligned; used with int8_taps); prev_theta [C]; outputs fmd [C, B/4],
// float32 or, with out_i16, the int16 inter-stage format, and theta_last
// [C] (the carried disc_prev_theta).  nn % 4 == 0, B % 4 == 0.  Returns
// the launch's cudaError_t (0 = launched).
extern "C" int fmt_frontend(const void* x, int form, int int8_taps,
                            const float* tail, const int8_t* tail8,
                            const float* w_rev, const int8_t* b1,
                            const int8_t* b2, int nn, float s_row,
                            const float* prev_theta, float scale,
                            int channels, int b, void* fmd,
                            float* theta_last, int out_i16,
                            cudaStream_t stream) {
  if (nn % 4 != 0 || nn < 4 || b % 4 != 0 || form < 0 || form > 3 ||
      (form == 2 && int8_taps) || (int8_taps && tail8 == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  return out_i16 ? launch_k1_form(x, form, int8_taps, tail, tail8, w_rev, b1,
                                  b2, nn, s_row, prev_theta, scale, channels,
                                  b, (int16_t*)fmd, theta_last, stream)
                 : launch_k1_form(x, form, int8_taps, tail, tail8, w_rev, b1,
                                  b2, nn, s_row, prev_theta, scale, channels,
                                  b, (float*)fmd, theta_last, stream);
}

// The int8-direct form: x8 [2, C, B] int8 planes and tail8 [2, C, nn - 4]
// int8 (u8 - 128), both 4-byte aligned; b1, b2 [nn] int8 as above; the rest
// as fmt_frontend.  nn % 4 == 0, B % 4 == 0.
extern "C" int fmt_frontend_i8(const int8_t* x8, const int8_t* tail8,
                               const int8_t* b1, const int8_t* b2, int nn,
                               float s_row, const float* prev_theta,
                               float scale, int channels, int b, void* fmd,
                               float* theta_last, int out_i16,
                               cudaStream_t stream) {
  if (nn % 4 != 0 || nn < 4 || b % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const I8Rows src{x8, b};
  return out_i16
             ? launch_ds4_i8(src, tail8, b1, b2, nn, s_row, channels, b,
                             Ds4Disc<int16_t>{(int16_t*)fmd, prev_theta,
                                              theta_last, scale},
                             stream)
             : launch_ds4_i8(src, tail8, b1, b2, nn, s_row, channels, b,
                             Ds4Disc<float>{(float*)fmd, prev_theta,
                                            theta_last, scale},
                             stream);
}
