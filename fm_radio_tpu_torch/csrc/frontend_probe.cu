// The K1 engine probe on Hopper: the float K1's time split into its parts.
//
// Replaces the four Pallas kernels of tools/frontend_probe.py (a TPU
// diagnostic, not a kernel of the receiver):
//   build (:138, _variant_kernel :52, pallas_call :210)
//     fp_sum (stream, unpack)  read each tile (and unpack it), one sum per
//                              row and tile (probe_sum.cuh)
//     fp_fir (dots, full)      + the ds x4 window sums (dots: fr + fi), +
//                              the polynomial atan2 and the in-tile
//                              difference wrapped to +-pi, x 0.123 (full)
//   build_dbuf (:228, pallas_call :293)
//     fp_dbuf_kernel           packed words staged in shared memory, one
//                              CTA walking its channels' time tiles with one
//                              buffer, or two where cp.async fills tile i+1
//                              while tile i's FIR runs
//   build_i8direct (:316, pallas_call :394)
//     fp_i8d_kernel            int8 planes, int8 taps, windows read from
//                              device memory with the tail carried (or
//                              `noasm`: each tile's first `no` outputs
//                              read the tile from its start, mis-filtered,
//                              as the TPU lens does)
//   build_i8manual (:426, pallas_call :518)
//     fp_i8man_kernel          one CTA per channel block, the time loop
//                              inside: tiles in by cp.async.bulk on an
//                              mbarrier into a 2-slot ring, outputs out
//                              through a 2-slot ring by bulk stores
//
// The sums are the production K1's device code: ds4_float and ds4_i8 on
// the ingest loads of frontend_stages.cuh (the float taps in float32, where
// the TPU used bf16 hi/lo products to reach float32 on its matrix unit),
// ds4_i8_words of k12_stages.cuh for the int8-direct forms, atan2_poly and
// disc_value: the sums and formulas of the kernels the cells run (which
// stage their tiles in shared memory and sum them register-blocked, in the
// same order).  `full` is two launches: ds x4 + atan2 into a theta
// scratch, then the difference (fp_disc_kernel).  The int8-direct `full`
// without `noasm` runs K12's own first launch
// (k12_stages.cuh::ds4_i8_blocked_kernel) on a zero tail.
//
// What the TPU kernel leaves unwritten reads as zeros of the scratch's own
// type: build's float scratch head (every tile's first window reaches 128
// samples before the tile: 0.0, which the int8 taps see as int8(0 - 1));
// the carried tails and the other buffer at the first tile of a channel
// block (dbuf: the word of the sample (0, 0); i8direct: zero bytes).
//
// What bounds them is what this probe measures; the times are in PERF.md.

#include "bulk_copy.cuh"
#include "frontend_stages.cuh"
#include "k12_stages.cuh"
#include "probe_sum.cuh"

namespace fmt {

constexpr int kFpHead = 128;     // the TPU tool's _TB: window reach before
                                 // a tile, and the carried tail's length
constexpr float kFpScale = 0.123f;
// the packed word of the sample (0, 0): (0 + 127) * 256 + (0 + 127)
constexpr float kZeroWord = 32639.0f;

// Sample n of a row as the centred float pair, for the forms the probe
// reads besides PackedWords (frontend_stages.cuh): int16 words w - 32768,
// and two separate int8 planes (u8 - 128).
struct I16Words {
  const int16_t* x;
  int64_t plane;  // unused
  __device__ __forceinline__ void load(int64_t row, int n, float& r,
                                       float& i) const {
    const float v = (float)x[row + n] + 32768.0f;
    const float hi = floorf(v * (1.0f / 256.0f));
    r = hi - 127.0f;
    i = (v - hi * 256.0f) - 127.0f;
  }
};

struct F32Pair {
  const float* r;
  const float* q;
  __device__ __forceinline__ void load(int64_t row, int n, float& re,
                                       float& im) const {
    re = r[row + n];
    im = q[row + n];
  }
};

struct I8Pair {
  const int8_t* r8;
  const int8_t* q8;
  __device__ __forceinline__ void load(int64_t row, int n, float& r,
                                       float& i) const {
    r = (float)r8[row + n] + 1.0f;
    i = (float)q8[row + n] + 1.0f;
  }
};

// ---- stream / unpack: the per-tile sums ---------------------------------

// packed words, float4 at a time: the word (stream) or re - im (unpack)
template <bool kUnpack, bool kTM>
struct WordsSum : KeepAll {
  static constexpr int kVec = 4;
  const float* x;
  int rows, n;
  __device__ __forceinline__ float lane(int r, int ti, int l,
                                        int t_blk) const {
    const float4* p =
        (const float4*)(x + tile_base(r, ti, rows, n, t_blk, kTM));
    float acc = 0.0f;
    for (int k = 0; k < t_blk / (32 * kVec); ++k) {
      const float4 v = p[k * 32 + l];
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if constexpr (kUnpack) {
          float re, im;
          PackedWords{e + u, 0}.load(0, 0, re, im);
          acc += re - im;
        } else {
          acc += e[u];
        }
      }
    }
    return acc;
  }
};

// int16 words, eight to 16 bytes: (float) w (stream) or re - im (unpack)
template <bool kUnpack, bool kTM>
struct I16Sum : KeepAll {
  static constexpr int kVec = 8;
  const int16_t* x;
  int rows, n;
  __device__ __forceinline__ float lane(int r, int ti, int l,
                                        int t_blk) const {
    const int16_t* base = x + tile_base(r, ti, rows, n, t_blk, kTM);
    const int4* p = (const int4*)base;
    float acc = 0.0f;
    for (int k = 0; k < t_blk / (32 * kVec); ++k) {
      const int4 v = p[k * 32 + l];
      const int16_t* e = (const int16_t*)&v;
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        if constexpr (kUnpack) {
          float re, im;
          I16Words{e + u, 0}.load(0, 0, re, im);
          acc += re - im;
        } else {
          acc += (float)e[u];
        }
      }
    }
    return acc;
  }
};

// two int8 planes, sixteen to 16 bytes: the sum of each plane, added at
// the end (stream), or (r + 1) - (q + 1) (unpack)
template <bool kUnpack, bool kTM>
struct U8Sum : KeepAll {
  static constexpr int kVec = 16;
  const int8_t* xr;
  const int8_t* xq;
  int rows, n;
  __device__ __forceinline__ float lane(int r, int ti, int l,
                                        int t_blk) const {
    const int64_t b0 = tile_base(r, ti, rows, n, t_blk, kTM);
    const int4* pr = (const int4*)(xr + b0);
    const int4* pq = (const int4*)(xq + b0);
    float ar = 0.0f, aq = 0.0f;
    for (int k = 0; k < t_blk / (32 * kVec); ++k) {
      const int4 vr = pr[k * 32 + l], vq = pq[k * 32 + l];
      const int8_t* er = (const int8_t*)&vr;
      const int8_t* eq = (const int8_t*)&vq;
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        if constexpr (kUnpack) {
          ar += ((float)er[u] + 1.0f) - ((float)eq[u] + 1.0f);
        } else {
          ar += (float)er[u];
          aq += (float)eq[u];
        }
      }
    }
    return kUnpack ? ar : ar + aq;
  }
};

// two float32 planes, float4 at a time: the sum of each plane, added at
// the end (stream), or re - im (unpack)
template <bool kUnpack, bool kTM>
struct F32PairSum : KeepAll {
  static constexpr int kVec = 4;
  const float* xr;
  const float* xq;
  int rows, n;
  __device__ __forceinline__ float lane(int r, int ti, int l,
                                        int t_blk) const {
    const int64_t b0 = tile_base(r, ti, rows, n, t_blk, kTM);
    const float4* pr = (const float4*)(xr + b0);
    const float4* pq = (const float4*)(xq + b0);
    float ar = 0.0f, aq = 0.0f;
    for (int k = 0; k < t_blk / (32 * kVec); ++k) {
      const float4 vr = pr[k * 32 + l], vq = pq[k * 32 + l];
      const float er[4] = {vr.x, vr.y, vr.z, vr.w};
      const float eq[4] = {vq.x, vq.y, vq.z, vq.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if constexpr (kUnpack) {
          ar += er[u] - eq[u];
        } else {
          ar += er[u];
          aq += eq[u];
        }
      }
    }
    return kUnpack ? ar : ar + aq;
  }
};

// ---- dots / full: the direct-read FIR -----------------------------------

// CTA = one (c_blk x t_blk) tile; each thread computes outputs j of its
// rows from the window 4j - halo .. 4j + 3 of the tile, samples before the
// tile reading 0.0 (the TPU kernel's never-written scratch head).
// out [C, B/4]: fr + fi (dots), or atan2(fi, fr) (full; then
// fp_disc_kernel).
template <class Load, bool kI8, bool kTM, bool kFull>
__global__ void fp_fir_kernel(Load in, int channels, int b,
                              const float* __restrict__ w_rev,
                              const int* __restrict__ b1w,
                              const int* __restrict__ b2w, int nn,
                              float s_row, int c_blk, int t_blk, int n_ct,
                              int n_tt, int raster, float* __restrict__ out) {
  int ci, ti;
  tile_of(blockIdx.x, n_ct, n_tt, raster, ci, ti);
  const int no = t_blk / 4;
  const int halo = nn - 4;
  for (int e = threadIdx.x; e < c_blk * no; e += blockDim.x) {
    const int c = ci * c_blk + e / no;
    const int j = e % no;
    const int64_t row = tile_base(c, ti, channels, b, t_blk, kTM);
    auto src = [&](int n, float& vr, float& vi) {
      if (n < 0) {
        vr = 0.0f;
        vi = 0.0f;
      } else {
        in.load(row, n, vr, vi);
      }
    };
    float fr, fi;
    if constexpr (kI8) {
      ds4_i8(src, b1w, b2w, nn, s_row, 4 * j - halo, fr, fi);
    } else {
      ds4_float(src, w_rev, nn, 4 * j - halo, fr, fi);
    }
    const int64_t o = (int64_t)c * (b / 4) + (int64_t)ti * no + j;
    out[o] = kFull ? atan2_poly(fi, fr) : fr + fi;
  }
}

// full's second launch: out = wrap(theta[j] - theta[j - 1]) * 0.123 within
// each tile of `no` outputs (0 at a tile's first output)
__global__ void fp_disc_kernel(const float* __restrict__ theta, int64_t total,
                               int no, float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float t = theta[i];
  out[i] = disc_value(t, i % no == 0 ? t : theta[i - 1], kFpScale);
}

// ---- dbuf: tiles staged in shared memory --------------------------------

// One CTA per c_blk channels walks the time tiles.  Buffer [c_blk][head +
// t_blk] words: the head holds the previous tile's last 128 words (the
// word of (0, 0) at the first tile), the rest the tile, copied by cp.async
// 16 bytes a thread.  nbuf 1: load, wait, FIR; nbuf 2: tile i + 1 is in
// flight into the other buffer while tile i's FIR runs.  The FIR reads the
// words from shared memory and unpacks them on each read (PackedWords).
template <bool kFull>
__global__ void fp_dbuf_kernel(const float* __restrict__ x, int b,
                               const float* __restrict__ w_rev, int nn,
                               int c_blk, int t_blk, int nbuf,
                               float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int stride = kFpHead + t_blk;
  float* bufs[2] = {smem, smem + (nbuf == 2 ? c_blk * stride : 0)};
  float* th = smem + nbuf * c_blk * stride;  // [c_blk][no] (full)
  const int c0 = blockIdx.x * c_blk;
  const int n_tt = b / t_blk, no = t_blk / 4, halo = nn - 4;
  const int chunks = c_blk * (t_blk / 4);  // 16-byte chunks of a tile

  auto issue = [&](float* buf, int tile) {
    for (int e = threadIdx.x; e < chunks; e += blockDim.x) {
      const int r = e / (t_blk / 4), q = e % (t_blk / 4);
      cp_async16(buf + r * stride + kFpHead + 4 * q,
                 x + (int64_t)(c0 + r) * b + (int64_t)tile * t_blk + 4 * q);
    }
    cp_async_commit();
  };

  for (int e = threadIdx.x; e < c_blk * kFpHead; e += blockDim.x)
    bufs[0][(e / kFpHead) * stride + e % kFpHead] = kZeroWord;
  if (nbuf == 2) issue(bufs[0], 0);
  for (int i = 0; i < n_tt; ++i) {
    float* cur = bufs[nbuf == 2 ? (i & 1) : 0];
    float* nxt = bufs[nbuf == 2 ? ((i + 1) & 1) : 0];
    if (nbuf == 1) issue(cur, i);
    cp_async_wait_all();
    __syncthreads();
    if (nbuf == 2 && i + 1 < n_tt) issue(nxt, i + 1);
    for (int e = threadIdx.x; e < c_blk * no; e += blockDim.x) {
      const int r = e / no, j = e % no;
      const PackedWords w{cur + r * stride + kFpHead, 0};
      auto src = [&](int n, float& vr, float& vi) { w.load(0, n, vr, vi); };
      float fr, fi;
      ds4_float(src, w_rev, nn, 4 * j - halo, fr, fi);
      const int64_t o = (int64_t)(c0 + r) * (b / 4) + (int64_t)i * no + j;
      if constexpr (kFull) {
        th[r * no + j] = atan2_poly(fi, fr);
      } else {
        out[o] = fr + fi;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < c_blk * kFpHead; e += blockDim.x) {
      const int r = e / kFpHead, k = e % kFpHead;
      nxt[r * stride + k] = cur[r * stride + t_blk + k];
    }
    if constexpr (kFull) {
      for (int e = threadIdx.x; e < c_blk * no; e += blockDim.x) {
        const int r = e / no, j = e % no;
        const float t = th[r * no + j];
        out[(int64_t)(c0 + r) * (b / 4) + (int64_t)i * no + j] =
            disc_value(t, j == 0 ? t : th[r * no + j - 1], kFpScale);
      }
    }
    __syncthreads();
  }
}

// ---- i8direct: int8 planes, int8 taps, windows read directly -------------

// One thread per output.  Without noasm the window of output jg (of the
// row) is words jg - halo/4 .. of the row, the words before the row from
// the zero tail: the TPU kernel's [carried tail | tile] assembly is
// invisible here.  With noasm, output j < no of each tile reads words j ..
// of its tile (the mis-filtered first sub-window of the TPU lens).
__global__ void fp_i8d_kernel(const int8_t* __restrict__ xr8,
                              const int8_t* __restrict__ xi8,
                              const int* __restrict__ tail0,
                              const int* __restrict__ b1w,
                              const int* __restrict__ b2w, int nn,
                              float s_row, int channels, int b, int t_blk,
                              int no, int noasm, int full,
                              float* __restrict__ out) {
  const int n4 = b / 4;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)channels * n4) return;
  const int c = (int)(idx / n4);
  const int jg = (int)(idx % n4);
  const int halo_w = (nn - 4) / 4;
  const int* xr = (const int*)(xr8 + (int64_t)c * b);
  const int* xi = (const int*)(xi8 + (int64_t)c * b);
  int q0 = jg - halo_w;
  if (noasm) {
    const int tw = t_blk / 4, j = jg % tw;
    q0 = jg - j + (j < no ? j : j - halo_w);
  }
  float fr, fi;
  ds4_i8_words(xr, xi, n4, tail0, tail0, halo_w, b1w, b2w, nn / 4, q0, s_row,
               fr, fi);
  out[idx] = full ? atan2_poly(fi, fr) : fr + fi;
}

// ---- i8manual: the time loop inside, bulk copies through 2-slot rings ----

// One CTA per c_blk channels.  Shared memory: the input ring [2][2 planes]
// [c_blk][t_blk] bytes, the output ring [2][c_blk][t_blk/4] float32, the
// theta tile [c_blk][t_blk/4] (full).  Thread 0 issues the loads of tile
// i + 1 (one cp.async.bulk per row and plane, on the slot's mbarrier)
// before the CTA computes tile i, and the bulk stores of tile i's outputs
// after; an output slot is written again only after its store of two
// tiles ago has read it.  Windows as noasm (the TPU lens: no carried tail).
template <bool kFull>
__global__ void fp_i8man_kernel(const int8_t* __restrict__ xr8,
                                const int8_t* __restrict__ xi8,
                                const int* __restrict__ b1w,
                                const int* __restrict__ b2w, int nn,
                                float s_row, int b, int c_blk, int t_blk,
                                int no, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char sm[];
  __shared__ __align__(8) uint64_t bar[2];
  const int tw = t_blk / 4, halo_w = (nn - 4) / 4;
  int8_t* in_ring = (int8_t*)sm;                           // 2 x 2 x c_blk x t_blk
  float* out_ring = (float*)(sm + 4 * c_blk * t_blk);      // 2 x c_blk x tw
  float* th = out_ring + 2 * c_blk * tw;                   // c_blk x tw
  const int c0 = blockIdx.x * c_blk, n_tt = b / t_blk;
  const uint32_t tile_bytes = 2u * c_blk * t_blk;

  auto load = [&](int slot, int tile) {
    int8_t* dst = in_ring + (int64_t)slot * tile_bytes;
    mbar_expect(&bar[slot], tile_bytes);
    for (int p = 0; p < 2; ++p) {
      const int8_t* src = p == 0 ? xr8 : xi8;
      for (int r = 0; r < c_blk; ++r)
        bulk_g2s(dst + (p * c_blk + r) * t_blk,
                 src + (int64_t)(c0 + r) * b + (int64_t)tile * t_blk, t_blk,
                 &bar[slot]);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    mbar_fence_init();
    load(0, 0);
  }
  __syncthreads();
  uint32_t phase[2] = {0u, 0u};
  for (int i = 0; i < n_tt; ++i) {
    const int s = i & 1;
    if (threadIdx.x == 0) {
      if (i + 1 < n_tt) load(1 - s, i + 1);
      bulk_wait_read<1>();  // the store of tile i - 2 has read slot s
    }
    mbar_wait(&bar[s], phase[s]);
    phase[s] ^= 1u;
    __syncthreads();
    const int8_t* slot = in_ring + (int64_t)s * tile_bytes;
    float* ys = out_ring + s * c_blk * tw;
    for (int e = threadIdx.x; e < c_blk * tw; e += blockDim.x) {
      const int r = e / tw, j = e % tw;
      const int* xr = (const int*)(slot + r * t_blk);
      const int* xi = (const int*)(slot + (c_blk + r) * t_blk);
      float fr, fi;
      ds4_i8_words(xr, xi, tw, nullptr, nullptr, 0, b1w, b2w, nn / 4,
                   j < no ? j : j - halo_w, s_row, fr, fi);
      if constexpr (kFull) {
        th[e] = atan2_poly(fi, fr);
      } else {
        ys[e] = fr + fi;
      }
    }
    if constexpr (kFull) {
      __syncthreads();
      for (int e = threadIdx.x; e < c_blk * tw; e += blockDim.x) {
        const int j = e % tw;
        ys[e] = disc_value(th[e], j == 0 ? th[e] : th[e - 1], kFpScale);
      }
    }
    fence_async_shared();
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int r = 0; r < c_blk; ++r)
        bulk_s2g(out + (int64_t)(c0 + r) * (b / 4) + (int64_t)i * tw,
                 ys + r * tw, tw * 4);
      bulk_commit();
    }
  }
  if (threadIdx.x == 0) bulk_wait_all();
}

// ---- dispatch -------------------------------------------------------------

template <bool kUnpack, bool kTM>
int launch_fp_sum(const void* x, const void* x2, int form, int channels,
                  int b, int c_blk, int t_blk, int raster, float* sums,
                  float* last, cudaStream_t stream) {
  const int n_tt = b / t_blk;
  if (form == 0)
    return launch_tile_sum(WordsSum<kUnpack, kTM>{{}, (const float*)x,
                                                  channels, b},
                           channels, c_blk, n_tt, t_blk, raster, sums, last,
                           stream);
  if (form == 1)
    return launch_tile_sum(I16Sum<kUnpack, kTM>{{}, (const int16_t*)x,
                                                channels, b},
                           channels, c_blk, n_tt, t_blk, raster, sums, last,
                           stream);
  if (form == 2)
    return launch_tile_sum(U8Sum<kUnpack, kTM>{{}, (const int8_t*)x,
                                               (const int8_t*)x2, channels,
                                               b},
                           channels, c_blk, n_tt, t_blk, raster, sums, last,
                           stream);
  return launch_tile_sum(F32PairSum<kUnpack, kTM>{{}, (const float*)x,
                                                  (const float*)x2, channels,
                                                  b},
                         channels, c_blk, n_tt, t_blk, raster, sums, last,
                         stream);
}

template <class Load, bool kI8, bool kTM, bool kFull>
int launch_fp_fir(Load in, int channels, int b, const float* w_rev,
                  const int8_t* b1, const int8_t* b2, int nn, float s_row,
                  int c_blk, int t_blk, int raster, float* out,
                  cudaStream_t stream) {
  const int n_ct = channels / c_blk, n_tt = b / t_blk;
  fp_fir_kernel<Load, kI8, kTM, kFull><<<n_ct * n_tt, kThreads, 0, stream>>>(
      in, channels, b, w_rev, (const int*)b1, (const int*)b2, nn, s_row,
      c_blk, t_blk, n_ct, n_tt, raster, out);
  FMT_CHECK_LAUNCH();
  return 0;
}

template <class Load, bool kI8, bool kTM>
int fp_fir_full(Load in, int full, int channels, int b, const float* w_rev,
                const int8_t* b1, const int8_t* b2, int nn, float s_row,
                int c_blk, int t_blk, int raster, float* theta, float* out,
                cudaStream_t stream) {
  if (!full)
    return launch_fp_fir<Load, kI8, kTM, false>(in, channels, b, w_rev, b1,
                                                b2, nn, s_row, c_blk, t_blk,
                                                raster, out, stream);
  const int err = launch_fp_fir<Load, kI8, kTM, true>(
      in, channels, b, w_rev, b1, b2, nn, s_row, c_blk, t_blk, raster, theta,
      stream);
  if (err) return err;
  const int64_t total = (int64_t)channels * (b / 4);
  fp_disc_kernel<<<blocks_for(total), kThreads, 0, stream>>>(theta, total,
                                                             t_blk / 4, out);
  FMT_CHECK_LAUNCH();
  return 0;
}

template <class Load, bool kTM>
int fp_fir_taps(Load in, int int8_taps, int full, int channels, int b,
                const float* w_rev, const int8_t* b1, const int8_t* b2,
                int nn, float s_row, int c_blk, int t_blk, int raster,
                float* theta, float* out, cudaStream_t stream) {
  return int8_taps
             ? fp_fir_full<Load, true, kTM>(in, full, channels, b, w_rev, b1,
                                            b2, nn, s_row, c_blk, t_blk,
                                            raster, theta, out, stream)
             : fp_fir_full<Load, false, kTM>(in, full, channels, b, w_rev,
                                             b1, b2, nn, s_row, c_blk, t_blk,
                                             raster, theta, out, stream);
}

template <bool kTM>
int fp_fir_form(const void* x, const void* x2, int form, int int8_taps,
                int full, int channels, int b, const float* w_rev,
                const int8_t* b1, const int8_t* b2, int nn, float s_row,
                int c_blk, int t_blk, int raster, float* theta, float* out,
                cudaStream_t stream) {
  if (form == 0)
    return fp_fir_taps<PackedWords, kTM>(
        PackedWords{(const float*)x, 0}, int8_taps, full, channels, b, w_rev,
        b1, b2, nn, s_row, c_blk, t_blk, raster, theta, out, stream);
  if (form == 1)
    return fp_fir_taps<I16Words, kTM>(
        I16Words{(const int16_t*)x, 0}, int8_taps, full, channels, b, w_rev,
        b1, b2, nn, s_row, c_blk, t_blk, raster, theta, out, stream);
  if (form == 2)
    return fp_fir_taps<I8Pair, kTM>(
        I8Pair{(const int8_t*)x, (const int8_t*)x2}, int8_taps, full,
        channels, b, w_rev, b1, b2, nn, s_row, c_blk, t_blk, raster, theta,
        out, stream);
  return fp_fir_taps<F32Pair, kTM>(
      F32Pair{(const float*)x, (const float*)x2}, int8_taps, full, channels,
      b, w_rev, b1, b2, nn, s_row, c_blk, t_blk, raster, theta, out, stream);
}

inline bool fp_tiles_ok(int channels, int b, int c_blk, int t_blk) {
  return c_blk > 0 && t_blk > 0 && channels % c_blk == 0 && b % t_blk == 0 &&
         t_blk % 512 == 0;
}

}  // namespace fmt

using namespace fmt;

// build's stream (unpack = 0) and unpack (1) variants.  form 0: x packed
// words [C, B] float32; 1: x int16 words [C, B]; 2: x, x2 int8 planes
// [C, B]; 3: x, x2 float32 planes [C, B] (the port's own form: K1 on the
// complex cell's planes).  tile_major: each input [n_tt, C, t_blk] instead.  sums [C,
// B / t_blk] and last [C, 128] float32.  c_blk | C, t_blk | B, t_blk % 512
// == 0, 16-byte aligned inputs.
extern "C" int fmt_fp_sum(const void* x, const void* x2, int form, int unpack,
                          int tile_major, int channels, int b, int c_blk,
                          int t_blk, int raster, float* sums, float* last,
                          cudaStream_t stream) {
  if (!fp_tiles_ok(channels, b, c_blk, t_blk) || form < 0 || form > 3)
    return (int)cudaErrorInvalidValue;
  if (unpack)
    return tile_major ? launch_fp_sum<true, true>(x, x2, form, channels, b,
                                                  c_blk, t_blk, raster, sums,
                                                  last, stream)
                      : launch_fp_sum<true, false>(x, x2, form, channels, b,
                                                   c_blk, t_blk, raster, sums,
                                                   last, stream);
  return tile_major ? launch_fp_sum<false, true>(x, x2, form, channels, b,
                                                 c_blk, t_blk, raster, sums,
                                                 last, stream)
                    : launch_fp_sum<false, false>(x, x2, form, channels, b,
                                                  c_blk, t_blk, raster, sums,
                                                  last, stream);
}

// build's dots (full = 0) and full (1) variants on the forms of
// fmt_fp_sum, float taps (w_rev [nn] reversed) or int8 taps (b1, b2 [nn]
// reversed, read as nn/4 words; s_row); nn - 4 <= 128, nn % 4 == 0.
// theta [C, B/4] scratch (full); out [C, B/4] float32.
extern "C" int fmt_fp_fir(const void* x, const void* x2, int form,
                          int int8_taps, int tile_major, int full,
                          const float* w_rev, const int8_t* b1,
                          const int8_t* b2, int nn, float s_row, int channels,
                          int b, int c_blk, int t_blk, int raster,
                          float* theta, float* out, cudaStream_t stream) {
  if (!fp_tiles_ok(channels, b, c_blk, t_blk) || form < 0 || form > 3 ||
      nn % 4 || nn < 4 || nn - 4 > kFpHead)
    return (int)cudaErrorInvalidValue;
  return tile_major
             ? fp_fir_form<true>(x, x2, form, int8_taps, full, channels, b,
                                 w_rev, b1, b2, nn, s_row, c_blk, t_blk,
                                 raster, theta, out, stream)
             : fp_fir_form<false>(x, x2, form, int8_taps, full, channels, b,
                                  w_rev, b1, b2, nn, s_row, c_blk, t_blk,
                                  raster, theta, out, stream);
}

// build_dbuf: x packed words [C, B] float32 (16-byte aligned), float taps
// w_rev [nn]; nbuf 1 or 2; out [C, B/4].  Shared memory nbuf * c_blk *
// (128 + t_blk) * 4 bytes (+ c_blk * t_blk for full) <= 227 KB.
extern "C" int fmt_fp_dbuf(const float* x, int full, const float* w_rev,
                           int nn, int channels, int b, int c_blk, int t_blk,
                           int nbuf, float* out, cudaStream_t stream) {
  if (!fp_tiles_ok(channels, b, c_blk, t_blk) || (nbuf != 1 && nbuf != 2) ||
      nn % 4 || nn - 4 > kFpHead || t_blk < 2 * kFpHead)
    return (int)cudaErrorInvalidValue;
  const int smem = nbuf * c_blk * (kFpHead + t_blk) * 4 +
                   (full ? c_blk * t_blk : 0);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const dim3 grid(channels / c_blk);
  if (full) {
    cudaError_t e = cudaFuncSetAttribute(
        fp_dbuf_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    fp_dbuf_kernel<true><<<grid, kThreads, smem, stream>>>(
        x, b, w_rev, nn, c_blk, t_blk, nbuf, out);
  } else {
    cudaError_t e = cudaFuncSetAttribute(
        fp_dbuf_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    fp_dbuf_kernel<false><<<grid, kThreads, smem, stream>>>(
        x, b, w_rev, nn, c_blk, t_blk, nbuf, out);
  }
  FMT_CHECK_LAUNCH();
  return 0;
}

// build_i8direct: x8 int8 planes [2, C, B] (4-byte aligned rows); tail8
// [2, C, nn - 4] int8 zeros (full without noasm runs K12's first launch,
// k12_stages.cuh::ds4_i8_blocked_kernel, on it; the other forms read its
// first row as the zero tail); b1, b2 [nn]; theta [C, B/4] scratch (full);
// out [C, B/4].
extern "C" int fmt_fp_i8d(const int8_t* x8, const int8_t* tail8,
                          const int8_t* b1, const int8_t* b2, int nn,
                          float s_row, int channels, int b, int t_blk, int no,
                          int noasm, int full, float* theta, float* out,
                          cudaStream_t stream) {
  if (b % t_blk || t_blk % 16 || nn % 4 || nn - 4 > kFpHead ||
      4 * no > t_blk)
    return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)channels * (b / 4);
  if (full && !noasm) {
    // K12's own first launch
    const int err = launch_ds4_i8(I8Rows{x8, b}, tail8, b1, b2, nn, s_row,
                                  channels, b, Ds4Theta{theta}, stream);
    if (err) return err;
  } else {
    fp_i8d_kernel<<<blocks_for(total), kThreads, 0, stream>>>(
        x8, x8 + (int64_t)channels * b, (const int*)tail8, (const int*)b1,
        (const int*)b2, nn, s_row, channels, b, t_blk, no, noasm, full,
        full ? theta : out);
  }
  FMT_CHECK_LAUNCH();
  if (full) {
    fp_disc_kernel<<<blocks_for(total), kThreads, 0, stream>>>(
        theta, total, t_blk / 4, out);
    FMT_CHECK_LAUNCH();
  }
  return 0;
}

// build_i8manual: x8 int8 planes [2, C, B] (16-byte aligned rows); b1,
// b2 [nn]; out [C, B/4] (16-byte aligned rows).  Shared memory
// 6 * c_blk * t_blk bytes (+ c_blk * t_blk for full) <= 227 KB.
extern "C" int fmt_fp_i8man(const int8_t* x8, const int8_t* b1,
                            const int8_t* b2, int nn, float s_row,
                            int channels, int b, int c_blk, int t_blk,
                            int no, int full, float* out,
                            cudaStream_t stream) {
  const int8_t* xr8 = x8;
  const int8_t* xi8 = x8 + (int64_t)channels * b;
  if (!fp_tiles_ok(channels, b, c_blk, t_blk) || nn % 4 ||
      nn - 4 > kFpHead || 4 * no > t_blk)
    return (int)cudaErrorInvalidValue;
  const int smem = 6 * c_blk * t_blk + (full ? c_blk * t_blk : 0);
  if (smem > 232448 - 64) return (int)cudaErrorInvalidValue;
  const dim3 grid(channels / c_blk);
  if (full) {
    cudaError_t e = cudaFuncSetAttribute(
        fp_i8man_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    fp_i8man_kernel<true><<<grid, kThreads, smem, stream>>>(
        xr8, xi8, (const int*)b1, (const int*)b2, nn, s_row, b, c_blk, t_blk,
        no, out);
  } else {
    cudaError_t e = cudaFuncSetAttribute(
        fp_i8man_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    fp_i8man_kernel<false><<<grid, kThreads, smem, stream>>>(
        xr8, xi8, (const int*)b1, (const int*)b2, nn, s_row, b, c_blk, t_blk,
        no, out);
  }
  FMT_CHECK_LAUNCH();
  return 0;
}
