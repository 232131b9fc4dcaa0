// The extraction's device code, shared by the extract kernel (extract.cu)
// and the full-chain megakernel (chain.cu): one copy, so the chain's
// extraction equals the split path's bit for bit.
//
//   offset_phasor  the per-channel L-R offset phasor (cos, sin)(2*pi*off)
//   mix_sample     the harmonic phasors of one sample from ONE base phasor
//                  e^{j2pi dt} (p2 = p1^2 rotated by the offset, p3 = p1^2 *
//                  p1; extract_pallas.py:55-71) and the mixed L-R and RDS
//                  values
//   extract_item   one output of the five decimating FIRs of a tile held in
//                  shared memory: L+R ds x4 on Re, L-R ds x4 on both planes,
//                  RDS ds x8 on both planes (the megakernel's FIRs, and the
//                  extract kernel's at other filter orders)
//   fir_block      R neighbouring outputs of one decimating FIR of NN taps
//                  over a skewed plane in shared memory, register-blocked
//                  (the extract kernel's FIRs at the receiver's orders)
//   ext_put, ext_firs  the blocked tile: a sample mixed into the skewed
//                  planes, and the five FIRs over them (extract.cu's blocked
//                  route)
#pragma once

#include "common.cuh"

namespace fmt {

__device__ __forceinline__ void offset_phasor(float off, float& co,
                                              float& so) {
  co = cheb_sine(wrap_cycles(off + 0.25f));
  so = cheb_sine(wrap_cycles(off));
}

// x = (x_r, x_i) mixed with harmonic 2 (rotated by the offset phasor (co,
// so)) into (vmr, vmi) and with harmonic 3 into (vrr, vri)
__device__ __forceinline__ void mix_sample(float x_r, float x_i, float d,
                                           float co, float so, float& vmr,
                                           float& vmi, float& vrr,
                                           float& vri) {
  const float c1 = cheb_sine(wrap_cycles(d + 0.25f));
  const float s1 = cheb_sine(wrap_cycles(d));
  const float c2r = c1 * c1 - s1 * s1;
  const float s2r = 2.0f * c1 * s1;
  const float c2 = c2r * co - s2r * so;
  const float s2 = s2r * co + c2r * so;
  const float c3 = c2r * c1 - s2r * s1;
  const float s3 = s2r * c1 + c2r * s1;
  vmr = x_r * c2 - x_i * s2;
  vmi = x_r * s2 + x_i * c2;
  vrr = x_r * c3 - x_i * s3;
  vri = x_r * s3 + x_i * c3;
}

// The five planes of one channel's tile in shared memory, sample n of the
// tile at index h0 + n (the carried or previous samples below h0).
struct ExtPlanes {
  const float *lpr, *mr, *mi, *rr, *ri;
  int h0;
};

struct ExtTaps {
  const float *wa, *wm;  // reversed L+R and L-R taps, nn_a each
  int nn_a;
  const float* wr;       // reversed RDS taps
  int nn_r;
};

// Output row pointers at the tile's first output: lpr, lmr_re, lmr_im
// advance by 1 per audio output, rds_re, rds_im per RDS output.
struct ExtOut {
  float *lpr, *lmr_re, *lmr_im, *rds_re, *rds_im;
};

// Work item w < 2 * na + nr of a tile with na audio and nr RDS outputs:
// w < na the L+R output w, w < 2 na the L-R output w - na (both planes),
// else the RDS output w - 2 na (both planes).  Returns the RDS output's
// power re^2 + im^2 (0 for the audio items).
__device__ __forceinline__ float extract_item(int w, int na,
                                              const ExtPlanes& p,
                                              const ExtTaps& t,
                                              const ExtOut& o) {
  if (w < na) {
    o.lpr[w] = fir_dot(p.lpr + p.h0 + 4 * w - (t.nn_a - 4), t.wa, t.nn_a);
    return 0.0f;
  }
  if (w < 2 * na) {
    const int j = w - na;
    const int base = p.h0 + 4 * j - (t.nn_a - 4);
    fir_dot2(p.mr + base, p.mi + base, t.wm, t.nn_a, o.lmr_re[j],
             o.lmr_im[j]);
    return 0.0f;
  }
  const int j = w - 2 * na;
  const int base = p.h0 + 8 * j - (t.nn_r - 8);
  float ar, ai;
  fir_dot2(p.rr + base, p.ri + base, t.wr, t.nn_r, ar, ai);
  o.rds_re[j] = ar;
  o.rds_im[j] = ai;
  return ar * ar + ai * ai;
}

// R neighbouring outputs of a decimate-by-M FIR of NN taps over the plane
// x, stored skewed (mid_skew) in shared memory, for lane L of a warp whose
// lanes take neighbouring blocks of R outputs (M R = 32 samples apart):
//   acc[r] = sum_{k < NN} w[k] * x[32 L + B0 + M r + k],
// summed as fir_dot sums it (from 0.0f, k ascending, each product and sum
// rounded: -fmad=false), so the outputs equal extract_item's bit for bit.
// Tap k = M q + p is step q of polyphase phase p.  Each phase keeps a
// window of R samples in registers, one an output: at step q output r
// reads slot (r + q) % R, and the slot output 0 read is then refilled
// with the sample output R - 1 reads at step q + 1, so each shared-memory
// load serves R multiply-adds and no register moves.  The taps w (16-byte
// aligned) are read four at a time, as broadcasts.  Lanes 32 samples
// apart load from distinct banks of the skewed plane, and since mid_skew(32
// a + b) = 33 a + mid_skew(b), every load is a constant offset from the
// lane's pointer for its block of R steps.
//
// fir_steps runs R steps from step qb (a multiple of R) of every phase,
// over xq = the lane's plane pointer advanced by qb's blocks and wq = w +
// M qb; kLast: the last R, whose final step loads nothing.
template <int M, int R, int B0, bool kLast>
__device__ __forceinline__ void fir_steps(const float* __restrict__ xq,
                                          const float* __restrict__ wq,
                                          float (&v)[M][R],
                                          float (&acc)[R]) {
#pragma unroll
  for (int qq = 0; qq < R; ++qq) {
    float wk[M];
#pragma unroll
    for (int p = 0; p < M; p += 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(wq + M * qq + p);
      wk[p] = w4.x;
      wk[p + 1] = w4.y;
      wk[p + 2] = w4.z;
      wk[p + 3] = w4.w;
    }
#pragma unroll
    for (int p = 0; p < M; ++p) {
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] += wk[p] * v[p][(r + qq) % R];
      if (!kLast || qq + 1 < R)
        v[p][qq] = xq[mid_skew(B0 + M * (R + qq) + p)];
    }
  }
}

template <int M, int R, int NN, int B0>
__device__ __forceinline__ void fir_block(const float* __restrict__ x,
                                          int lane,
                                          const float* __restrict__ w,
                                          float (&acc)[R]) {
  constexpr int NQ = NN / M;  // steps of each phase
  static_assert(M * R == 32 && B0 >= 0 && NN % M == 0 && NQ % R == 0 &&
                    M % 4 == 0,
                "lanes 32 samples apart, whole blocks of R steps, float4 "
                "taps");
  const float* xl = x + 33 * lane;  // the lane's first sample, skewed
  float v[M][R];
#pragma unroll
  for (int p = 0; p < M; ++p)
#pragma unroll
    for (int r = 0; r < R; ++r) v[p][r] = xl[mid_skew(B0 + M * r + p)];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
  // a block of R steps advances every load by M R = 32 samples: 33 words
#pragma unroll 1
  for (int qb = 0; qb < NQ - R; qb += R)
    fir_steps<M, R, B0, false>(xl + 33 * (qb / R), w + M * qb, v, acc);
  fir_steps<M, R, B0, true>(xl + 33 * (NQ / R - 1), w + M * (NQ - R), v,
                            acc);
}

// The tile of the extract kernels: kExtTile samples a CTA, after a halo of
// kExtHalo carried or previous samples.
constexpr int kExtTile = 1024;  // fm_out samples per block
constexpr int kExtHalo = 128;   // >= max(nn_audio - 4, nn_rds - 8)
constexpr int kExtW = kExtHalo + kExtTile;

// ---- The blocked extraction's tile (extract.cu's blocked route) ----
//
// A CTA of kExtThreads takes the same tile, halo, mix and carried tails as
// extract_kernel, the planes stored skewed (mid_skew), and the FIRs
// register-blocked (extract_stages.cuh::fir_block): warp 0 computes the
// tile's 256 L+R outputs, warps 1 and 2 the L-R re and im outputs (8
// neighbouring outputs a lane), warp 3 the 128 RDS outputs of both planes
// (4 a lane, re then im), each output the same sum in the same tap order
// as extract_item's.  The taps sit in shared memory and are read as
// broadcasts; the outputs are stored as float4.
constexpr int kExtTaps = 128;    // the order the blocked kernel is built for
constexpr int kExtThreads = 128;
constexpr int kAudioOuts = 8;    // ds x4 outputs a lane: 32 x 8 = 256 a tile
constexpr int kRdsOuts = 4;      // ds x8 outputs a lane: 32 x 4 = 128 a tile
constexpr int kExtWP = mid_skew(kExtW) + 1;  // a skewed plane's floats
constexpr int kExtHa = kExtTaps - 4, kExtHr = kExtTaps - 8;  // tails

// the blocked kernel's arguments (fmt_extract's, at kExtTaps taps)
template <class TX, class TD>
struct ExtArgs {
  const TX *xr, *xi;
  const TD* dt;
  int n;
  const float *off, *t_lpr, *t_lmr_re, *t_lmr_im, *t_rds_re, *t_rds_im;
  const float *wa, *wm, *wr;
  float *lpr, *lmr_re, *lmr_im, *rds_re, *rds_im, *pow_part;
  float *o_lmr_re, *o_lmr_im, *o_rds_re, *o_rds_im;
};

// a CTA's shared memory: the five skewed planes (lpr, L-R re, L-R im, RDS
// re, RDS im), the taps (wa, wm, wr) and the tile's RDS powers
struct ExtShared {
  float p[5][kExtWP];
  __align__(16) float w[3][kExtTaps];
  float pow[kExtTile / 8];
};

template <class TX, class TD>
__device__ __forceinline__ void ext_taps(ExtShared& sh,
                                         const ExtArgs<TX, TD>& a) {
  for (int k = threadIdx.x; k < kExtTaps; k += kExtThreads) {
    sh.w[0][k] = FMT_AT(a.wa, k, kExtTaps);
    sh.w[1][k] = FMT_AT(a.wm, k, kExtTaps);
    sh.w[2][k] = FMT_AT(a.wr, k, kExtTaps);
  }
}

// plane index e of channel c's tile whose first sample is t0: a sample g
// = t0 - kExtHalo + e of the block (already loaded, mixed here), or
// before the block, the carried tails (zero before them)
template <class TX, class TD>
__device__ __forceinline__ void ext_put(ExtShared& sh,
                                        const ExtArgs<TX, TD>& a, int c,
                                        int channels, int e, int g, float x_r,
                                        float x_i, float d, float co,
                                        float so) {
  float vl = 0.0f, vmr = 0.0f, vmi = 0.0f, vrr = 0.0f, vri = 0.0f;
  if (g >= 0) {
    vl = x_r;
    mix_sample(x_r, x_i, d, co, so, vmr, vmi, vrr, vri);
  } else {
    if (g >= -kExtHa) {
      const int64_t j = (int64_t)c * kExtHa + kExtHa + g;
      const int64_t nj = (int64_t)channels * kExtHa;
      vl = FMT_AT(a.t_lpr, j, nj);
      vmr = FMT_AT(a.t_lmr_re, j, nj);
      vmi = FMT_AT(a.t_lmr_im, j, nj);
    }
    if (g >= -kExtHr) {
      const int64_t j = (int64_t)c * kExtHr + kExtHr + g;
      const int64_t nj = (int64_t)channels * kExtHr;
      vrr = FMT_AT(a.t_rds_re, j, nj);
      vri = FMT_AT(a.t_rds_im, j, nj);
    }
  }
  const int se = mid_skew(e);
  sh.p[0][se] = vl;
  sh.p[1][se] = vmr;
  sh.p[2][se] = vmi;
  sh.p[3][se] = vrr;
  sh.p[4][se] = vri;
}

// the five FIRs over the planes of channel c's tile: output j of a ds x4
// plane sums the plane from index kExtHalo - kExtHa + 4 j on, of a ds x8
// plane from kExtHalo - kExtHr + 8 j; the tile's RDS power summed in
// output order (as extract_kernel sums it) into pow_part; from the last
// tile, the carried tails
template <class TX, class TD>
__device__ __forceinline__ void ext_firs(ExtShared& sh,
                                         const ExtArgs<TX, TD>& a, int c,
                                         int channels, int tile,
                                         int n_tiles) {
  constexpr int na = kExtTile / 4, nr = kExtTile / 8;
  static_assert(32 * kAudioOuts == na && 32 * kRdsOuts == nr &&
                    4 * kAudioOuts == 32 && 8 * kRdsOuts == 32,
                "a warp a plane, neighbouring lanes 32 samples apart");
  const int n = a.n, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < 3) {
    float acc[kAudioOuts];
    const int j0 = kAudioOuts * lane;
    fir_block<4, kAudioOuts, kExtTaps, kExtHalo - kExtHa>(
        sh.p[warp], lane, sh.w[warp == 0 ? 0 : 1], acc);
    float* y = warp == 0 ? a.lpr : warp == 1 ? a.lmr_re : a.lmr_im;
    const int64_t o = (int64_t)c * (n / 4) + tile * na + j0;
#ifdef FMT_CHECKED
    FMT_AT(y, o + kAudioOuts - 1, (int64_t)channels * (n / 4));
#endif
#pragma unroll
    for (int r = 0; r < kAudioOuts; r += 4)
      *reinterpret_cast<float4*>(y + o + r) =
          make_float4(acc[r], acc[r + 1], acc[r + 2], acc[r + 3]);
  } else {
    float ar[kRdsOuts], ai[kRdsOuts];
    const int j0 = kRdsOuts * lane;
    fir_block<8, kRdsOuts, kExtTaps, kExtHalo - kExtHr>(sh.p[3], lane,
                                                        sh.w[2], ar);
    fir_block<8, kRdsOuts, kExtTaps, kExtHalo - kExtHr>(sh.p[4], lane,
                                                        sh.w[2], ai);
    const int64_t o = (int64_t)c * (n / 8) + tile * nr + j0;
#ifdef FMT_CHECKED
    FMT_AT(a.rds_re, o + kRdsOuts - 1, (int64_t)channels * (n / 8));
    FMT_AT(a.rds_im, o + kRdsOuts - 1, (int64_t)channels * (n / 8));
#endif
    static_assert(kRdsOuts == 4, "one float4 store a plane");
    *reinterpret_cast<float4*>(a.rds_re + o) =
        make_float4(ar[0], ar[1], ar[2], ar[3]);
    *reinterpret_cast<float4*>(a.rds_im + o) =
        make_float4(ai[0], ai[1], ai[2], ai[3]);
#pragma unroll
    for (int r = 0; r < kRdsOuts; ++r)
      sh.pow[j0 + r] = ar[r] * ar[r] + ai[r] * ai[r];
    __syncwarp();
    if (lane == 0) {
      float p = 0.0f;
      for (int j = 0; j < nr; ++j) p += sh.pow[j];
      FMT_AT(a.pow_part, (int64_t)c * n_tiles + tile,
             (int64_t)channels * n_tiles) = p;
    }
  }
  // the block's last samples, mixed, become the carried tails
  if (tile == n_tiles - 1) {
    for (int k = threadIdx.x; k < kExtHa; k += kExtThreads) {
      const int se = mid_skew(kExtW - kExtHa + k);
      const int64_t j = (int64_t)c * kExtHa + k;
      const int64_t nj = (int64_t)channels * kExtHa;
      FMT_AT(a.o_lmr_re, j, nj) = sh.p[1][se];
      FMT_AT(a.o_lmr_im, j, nj) = sh.p[2][se];
    }
    for (int k = threadIdx.x; k < kExtHr; k += kExtThreads) {
      const int se = mid_skew(kExtW - kExtHr + k);
      const int64_t j = (int64_t)c * kExtHr + k;
      const int64_t nj = (int64_t)channels * kExtHr;
      FMT_AT(a.o_rds_re, j, nj) = sh.p[3][se];
      FMT_AT(a.o_rds_im, j, nj) = sh.p[4][se];
    }
  }
}

// pow[c] = sum of the per-tile partials, in tile order
__global__ void extract_pow_kernel(const float* __restrict__ pow_part,
                                   int n_tiles, int channels,
                                   float* __restrict__ pow) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= channels) return;
  float p = 0.0f;
  for (int t = 0; t < n_tiles; ++t)
    p += FMT_AT(pow_part, (int64_t)c * n_tiles + t,
                (int64_t)channels * n_tiles);
  FMT_AT(pow, c, channels) = p;
}

}  // namespace fmt
