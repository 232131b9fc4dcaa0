// The stages that K12 shares with the split front end (K1) and mid end (K2).
//
// K12 (k12.cu) runs them back to back; the split path runs the int8-direct
// ds x4 + discriminator as K1 (frontend.cu, fmt_frontend_i8) and the rest as
// K2 (midend.cu).  One copy of the device code serves all three, so the
// split int8 path equals K12 bit for bit on the card, as the TPU's K1 + K2
// equal its fused K12 (kernels/k12_pallas.py:15-16).
//
//   ds4_i8_blocked_kernel ds x4 (int8 taps, __dp4a) + atan2 on int8 words,
//                         register-blocked on a staged tile (launch_ds4_i8;
//                         frontend_pallas.py::_i8_direct_tile_body :388):
//                         theta1 for K12's mid end, or with the
//                         discriminator's store for K1's int8-tap forms
//   k12_disc_kernel       the discriminator (frontend_pallas.py:196-209)
//   launch_midend         ds x2 -> de-emphasis -> Hilbert -> peak IIR, theta,
//                         pilot power (midend_pallas.py::_midend_body :119),
//                         float32 or the int16 format, by midend_route:
//                         fused (launch_mid_fused: one tiled kernel for
//                         [discriminator ->] ds x2 -> Hilbert) with
//                         de-emphasis off, else one launch per stage up to
//                         Hilbert; both then run the peak IIR cut to its
//                         recurrence and a parallel theta pass
//                         (launch_peak_theta)
//
// The per-sample formulas (disc_value, deemph_step, peak_step) are device
// functions that the full-chain megakernel (chain.cu) evaluates too, tile
// by tile, so the chain equals the split path bit for bit.
//
// What bounds each launch, and what its design does about it, is noted in
// k12.cu and above the fused route's kernels below; the times per launch
// are in PERF.md.
#pragma once

#include "common.cuh"

namespace fmt {

// The int8-tap ds x4 window sum of one output, read from device memory
// (the K1 probe's int8-direct variants, frontend_probe.cu; the kernels
// sum their staged tiles, ds4_i8_blocked_kernel): (fr, fi) over nw words
// from word q0 of the re and im rows xr, xi (n_w words each; four int8
// samples to a word),
// words q < 0 from the carried tails tr, ti (halo_w words each, word q at
// halo_w + q), each accumulated exactly with __dp4a against the reversed
// taps b1w, b2w (nw words each), combined as y1 + y2 / 128 + s_row.  The
// tails may be null where q0 >= 0.
__device__ __forceinline__ void ds4_i8_words(
    const int* __restrict__ xr, const int* __restrict__ xi, int n_w,
    const int* __restrict__ tr, const int* __restrict__ ti, int halo_w,
    const int* __restrict__ b1w, const int* __restrict__ b2w, int nw, int q0,
    float s_row, float& fr, float& fi) {
  int y1r = 0, y2r = 0, y1i = 0, y2i = 0;
  for (int w = 0; w < nw; ++w) {
    const int q = q0 + w;
    const int vr =
        q < 0 ? FMT_AT(tr, halo_w + q, halo_w) : FMT_AT(xr, q, n_w);
    const int vi =
        q < 0 ? FMT_AT(ti, halo_w + q, halo_w) : FMT_AT(xi, q, n_w);
    const int w1 = __ldg(&FMT_AT(b1w, w, nw));
    const int w2 = __ldg(&FMT_AT(b2w, w, nw));
    y1r = __dp4a(vr, w1, y1r);
    y2r = __dp4a(vr, w2, y2r);
    y1i = __dp4a(vi, w1, y1i);
    y2i = __dp4a(vi, w2, y2i);
  }
  fr = ((float)y1r + (float)y2r * (1.0f / 128.0f)) + s_row;
  fi = ((float)y1i + (float)y2i * (1.0f / 128.0f)) + s_row;
}

// discriminator: fmd = wrap(theta1[j] - theta1[j-1]) * scale
__device__ __forceinline__ float disc_value(float theta, float prev,
                                            float scale) {
  float d = theta - prev;
  d = d >= kPi ? d - kTwoPi : d;
  d = d <= -kPi ? d + kTwoPi : d;
  return d * scale;
}

// ---- ds x4 (int8 taps) + atan2, register-blocked ----
//
// One CTA takes one channel and a tile of kDs4Tile outputs (ds x4 outputs,
// one int32 word of four int8 samples each); it stages the tile's words and
// the window's halo once in shared memory (skewed, mid_skew), and each
// thread computes a run of R neighbouring outputs from a sliding window of R
// words in registers: each shared-memory load serves 4 R __dp4a.  The taps
// (b1, b2 word pairs) are read as shared-memory broadcasts, zero-padded at
// the oldest end to a whole number of R-word blocks (a zero tap adds an
// exact 0 to the int32 sums, so every filter order takes the same code).
// The int32 sums are exact in any order, and the float combine and
// atan2_poly are evaluated as the plain version evaluates them, so theta1
// is bit for bit the plain version's.  The stores (Ds4Theta, Ds4Disc) are shared with the
// float K1's tiled kernel (frontend.cu).
constexpr int kDs4Tile = 1024;  // outputs a CTA
constexpr int kDs4Run = 8;      // outputs a thread (PERF.md: 16 was slower)

// the staged halo, in words, before the tile's first word: the padded
// window (nwp words) rounded up to 4, so that the extra output t0 - 1 (the
// discriminator's previous phase) is staged too
__host__ __device__ constexpr int ds4_halo_words(int nwp) {
  return (nwp + 3) / 4 * 4;
}
__host__ __device__ constexpr int ds4_pad_words(int nw, int run) {
  return (nw + run - 1) / run * run;
}

// A source of the staged words of channel c: fetch loads row word q of
// the re and im planes (0 <= q < n_in / 4) as it lies in memory (Raw),
// words_of turns it into the two int8 words; a tile issues all its
// fetches before the first words_of waits on one.  I8Rows: the int8
// planes themselves (u8 - 128, as the int8-direct forms and K12 take
// them).
struct I8Rows {
  const int8_t* x8;
  int n_in;
  using Raw = int2;
  __device__ __forceinline__ Raw fetch(int c, int channels, int q) const {
    const int nw = n_in / 4;
    const int* xr = (const int*)(x8 + (int64_t)c * n_in);
    const int* xi = (const int*)(x8 + ((int64_t)channels + c) * n_in);
    return make_int2(FMT_AT(xr, q, nw), FMT_AT(xi, q, nw));
  }
  __device__ __forceinline__ static void words_of(const Raw& w, int& wr,
                                                  int& wi) {
    wr = w.x;
    wi = w.y;
  }
};

// The ds x4 stores of a run of R outputs j0 .. j0 + R - 1 of channel c.
// Ds4Theta: theta1 [C, n] (K12's first launch: the mid end takes theta1).
struct Ds4Theta {
  float* theta1;
  static constexpr bool kDisc = false;
};
// Ds4Disc: the discriminator in the same launch (disc_value, unchanged):
// fmd [C, n] float32 or, with Out = int16_t, q_i16 at kFmScale, and the
// channel's last theta1 into theta_last [C] (the carried disc_prev_theta).
// theta1[j - 1] of a run's first output is its neighbour thread's last, of
// the tile's first output (t0 - 1) computed once more by thread 0 from the
// staged halo (the same operations: the same bits), of the channel's
// first output prev_theta[c].
template <class Out>
struct Ds4Disc {
  Out* fmd;
  const float* prev_theta;
  float* theta_last;
  float scale;
  static constexpr bool kDisc = true;
};

// R values stored at p[o .. o + R) (p + o 16-byte aligned where vec), the
// first nv of them where nv < R; float32 or q_i16 at `scale`
template <int R>
__device__ __forceinline__ void ds4_store(float* __restrict__ p, int64_t o,
                                          int64_t total, const float (&v)[R],
                                          int nv, bool vec, float) {
  if (vec && nv >= R) {
    static_assert(R % 4 == 0, "float4 stores");
    float4* d = reinterpret_cast<float4*>(FMT_SPAN(p, o, R, total));
#pragma unroll
    for (int r = 0; r < R; r += 4)
      d[r / 4] = make_float4(v[r], v[r + 1], v[r + 2], v[r + 3]);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < nv) FMT_AT(p, o + r, total) = v[r];
  }
}
template <int R>
__device__ __forceinline__ void ds4_store(int16_t* __restrict__ p, int64_t o,
                                          int64_t total, const float (&v)[R],
                                          int nv, bool vec, float scale) {
  if (vec && nv >= R) {
    static_assert(R % 8 == 0, "uint4 stores of 8 int16");
    uint4* d = reinterpret_cast<uint4*>(FMT_SPAN(p, o, R, total));
#pragma unroll
    for (int r = 0; r < R; r += 8) {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = (uint32_t)(uint16_t)q_i16(v[r + 2 * k], scale) |
               ((uint32_t)(uint16_t)q_i16(v[r + 2 * k + 1], scale) << 16);
      d[r / 8] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < nv) FMT_AT(p, o + r, total) = q_i16(v[r], scale);
  }
}

// Run `run` of the tile: R outputs j0 = t0 + R run .. of channel c, theta1
// values th, stored by `st` (n the row's outputs).  Every thread of the CTA
// calls it (Ds4Disc syncs the CTA), a thread without a run with run < 0;
// s_last is kDs4Tile / R floats of shared memory, extra theta1[t0 - 1]
// (read by run 0 where t0 > 0).
template <int R, class Store>
__device__ __forceinline__ void ds4_finish(const Store& st, int c,
                                           int channels, int n, int t0,
                                           int run, const float (&th)[R],
                                           float extra, float* s_last) {
  const int j0 = t0 + R * run;
  const int nv = run < 0 ? 0 : n - j0;
  const int64_t o = (int64_t)c * n + j0, total = (int64_t)channels * n;
  if constexpr (!Store::kDisc) {
    if (nv > 0) ds4_store<R>(st.theta1, o, total, th, nv, n % 4 == 0, 1.0f);
  } else {
    if (run >= 0) s_last[run] = th[R - 1];
    __syncthreads();
    if (run < 0) return;
    float prev = run > 0 ? s_last[run - 1]
                 : t0 > 0 ? extra
                          : FMT_AT(st.prev_theta, c, channels);
    float d[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      d[r] = disc_value(th[r], prev, st.scale);
      prev = th[r];
    }
    constexpr int kVec = sizeof(*st.fmd) == 2 ? 8 : 4;
    if (nv > 0) ds4_store<R>(st.fmd, o, total, d, nv, n % kVec == 0, kFmScale);
    if (nv > 0 && nv <= R) {  // the run holds the row's last output
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r == nv - 1) FMT_AT(st.theta_last, c, channels) = th[r];
    }
  }
}

// y1 + y2 / 128 + s_row of the int32 sums, then atan2_poly
__device__ __forceinline__ float ds4_i8_theta(int y1r, int y2r, int y1i,
                                              int y2i, float s_row) {
  const float fr = ((float)y1r + (float)y2r * (1.0f / 128.0f)) + s_row;
  const float fi = ((float)y1i + (float)y2i * (1.0f / 128.0f)) + s_row;
  return atan2_poly(fi, fr);
}

// The int8-tap ds x4 + atan2 of one channel's tile (blockIdx.y the channel,
// blockIdx.x the tile), kDs4Tile / R threads (R = kDs4Run).  Word q of
// the row (q < 0: the carried tail8 [2, C, 4 (nw - 1)], tail word
// nw - 1 + q; before it 0) is staged at e = q - (t0 - H); output
// j = t0 + R t + r sums the padded
// window's nwp words ending at j: e = e0 + R t + r + w, e0 = H - nwp + 1,
// w < nwp, against the taps s_tap[w] (zero for w < nwp - nw).  Dynamic
// shared memory: ds4_i8_smem(nw).
__host__ __device__ constexpr int ds4_i8_plane(int nw) {
  return mid_skew(ds4_halo_words(ds4_pad_words(nw, kDs4Run)) + kDs4Tile) + 1;
}
inline size_t ds4_i8_smem(int nw) {
  return 2 * sizeof(int) * (size_t)ds4_i8_plane(nw) +
         sizeof(int2) * (size_t)ds4_pad_words(nw, kDs4Run) +
         sizeof(float) * (kDs4Tile / kDs4Run);
}

template <class Src, class Store>
__global__ void __launch_bounds__(kDs4Tile / kDs4Run)
ds4_i8_blocked_kernel(Src src, const int8_t* __restrict__ tail8,
                      const int* __restrict__ b1w,
                      const int* __restrict__ b2w, int nn, float s_row,
                      int channels, int n_in, Store st) {
  constexpr int R = kDs4Run;
  extern __shared__ __align__(16) int ds4_sm[];
  const int nw = nn / 4, nwp = ds4_pad_words(nw, R);
  const int h = ds4_halo_words(nwp), plane = ds4_i8_plane(nw);
  int* s_re = ds4_sm;
  int* s_im = s_re + plane;
  int2* s_tap = reinterpret_cast<int2*>(s_im + plane);
  float* s_last = reinterpret_cast<float*>(s_tap + nwp);
  const int c = blockIdx.y, tid = threadIdx.x;
  const int n = n_in / 4;  // outputs = words of a row
  const int t0 = blockIdx.x * kDs4Tile;
  const int pad = nwp - nw;
  for (int w = tid; w < nwp; w += blockDim.x) {
    s_tap[w] = w < pad ? make_int2(0, 0)
                       : make_int2(FMT_AT(b1w, w - pad, nw),
                                   FMT_AT(b2w, w - pad, nw));
  }
  const int halo = nn - 4;  // tail samples (halo / 4 = nw - 1 words)
  const int* tr = (const int*)(tail8 + (int64_t)c * halo);
  const int* ti = (const int*)(tail8 + ((int64_t)channels + c) * halo);
  const int n_e = h + kDs4Tile + 1;
  constexpr int kThreads = kDs4Tile / R;
  if (t0 - h >= 0 && t0 - h + n_e <= n) {
    // a tile inside the row: kStage words a thread in flight, all fetched
    // before the first is converted and stored (the halo of the receiver's
    // order fits one round)
    constexpr int kStage = (kDs4Tile + 64) / kThreads + 1;
    for (int e0 = 0; e0 < n_e; e0 += kStage * kThreads) {
      typename Src::Raw raw[kStage];
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        const int e = e0 + tid + k * kThreads;
        if (e < n_e) raw[k] = src.fetch(c, channels, t0 - h + e);
      }
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        const int e = e0 + tid + k * kThreads;
        if (e < n_e) {
          int wr, wi;
          Src::words_of(raw[k], wr, wi);
          s_re[mid_skew(e)] = wr;
          s_im[mid_skew(e)] = wi;
        }
      }
    }
  } else {
    // the channel's first tile (the carried tail, zeros before it) or its
    // last (zeros past the row)
    for (int e = tid; e < n_e; e += kThreads) {
      const int q = t0 - h + e;
      int wr = 0, wi = 0;
      if (q >= 0) {
        if (q < n) Src::words_of(src.fetch(c, channels, q), wr, wi);
      } else if (q >= 1 - nw) {
        wr = FMT_AT(tr, nw - 1 + q, nw - 1);
        wi = FMT_AT(ti, nw - 1 + q, nw - 1);
      }
      s_re[mid_skew(e)] = wr;
      s_im[mid_skew(e)] = wi;
    }
  }
  __syncthreads();

  const int eb = h - nwp + 1 + R * tid;
  int vr[R], vi[R], y1r[R], y2r[R], y1i[R], y2i[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    vr[r] = s_re[mid_skew(eb + r)];
    vi[r] = s_im[mid_skew(eb + r)];
    y1r[r] = y2r[r] = y1i[r] = y2i[r] = 0;
  }
  // step w = qb + qq: output r reads slot (r + qq) % R, which holds word
  // eb + r + w; slot qq is then refilled with the word output 0 reads R
  // steps on
#pragma unroll 1
  for (int qb = 0; qb < nwp; qb += R) {
#pragma unroll
    for (int qq = 0; qq < R; ++qq) {
      const int2 tp = s_tap[qb + qq];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int k = (r + qq) % R;
        y1r[r] = __dp4a(vr[k], tp.x, y1r[r]);
        y2r[r] = __dp4a(vr[k], tp.y, y2r[r]);
        y1i[r] = __dp4a(vi[k], tp.x, y1i[r]);
        y2i[r] = __dp4a(vi[k], tp.y, y2i[r]);
      }
      const int en = mid_skew(eb + R + qb + qq);
      vr[qq] = s_re[en];
      vi[qq] = s_im[en];
    }
  }
  float th[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    th[r] = ds4_i8_theta(y1r[r], y2r[r], y1i[r], y2i[r], s_row);
  float extra = 0.0f;
  if (Store::kDisc && tid == 0 && t0 > 0) {  // output t0 - 1
    int a1r = 0, a2r = 0, a1i = 0, a2i = 0;
    for (int w = 0; w < nwp; ++w) {
      const int2 tp = s_tap[w];
      const int e = mid_skew(h - nwp + w);
      a1r = __dp4a(s_re[e], tp.x, a1r);
      a2r = __dp4a(s_re[e], tp.y, a2r);
      a1i = __dp4a(s_im[e], tp.x, a1i);
      a2i = __dp4a(s_im[e], tp.y, a2i);
    }
    extra = ds4_i8_theta(a1r, a2r, a1i, a2i, s_row);
  }
  ds4_finish<R>(st, c, channels, n, t0, tid, th, extra, s_last);
}

// ds x4 (int8 taps) + atan2 on the words of src, stored by st: [C, n_in / 4]
// outputs; tail8 [2, C, nn - 4] int8, 4-byte aligned rows; b1w, b2w the
// reversed taps packed four to a word (nn / 4 each).  nn % 4 == 0.
template <class Src, class Store>
inline int launch_ds4_i8(Src src, const int8_t* tail8, const int8_t* b1,
                         const int8_t* b2, int nn, float s_row, int channels,
                         int n_in, Store st, cudaStream_t stream) {
  const size_t smem = ds4_i8_smem(nn / 4);
  if (nn % 4 != 0 || nn < 4 || n_in % 4 != 0 || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const int n = n_in / 4;
  const dim3 grid((unsigned)((n + kDs4Tile - 1) / kDs4Tile),
                  (unsigned)channels);
  ds4_i8_blocked_kernel<Src, Store><<<grid, kDs4Tile / kDs4Run, smem,
                                       stream>>>(
      src, tail8, (const int*)b1, (const int*)b2, nn, s_row, channels, n_in,
      st);
  FMT_CHECK_LAUNCH();
  return 0;
}

// de-emphasis: y = (b1*x[n-1] + b0*x[n]) - a1*y[n-1]; state (x1, y1)
__device__ __forceinline__ float deemph_step(float& x1, float& y1, float x,
                                             float b0, float b1, float a1) {
  const float y = (x1 * b1 + x * b0) - y1 * a1;
  x1 = x;
  y1 = y;
  return y;
}

// order-2 peak IIR on one plane: ff = b2*x[n-2] + b1*x[n-1] + b0*x[n];
// y = (ff - a1*y[n-1]) - a2*y[n-2]
struct Peak2 {
  float x1, x2, y1, y2;
};

__device__ __forceinline__ float peak_step(Peak2& s, float v, float b0,
                                           float b1, float b2, float a1,
                                           float a2) {
  const float f = (s.x2 * b2 + s.x1 * b1) + v * b0;
  const float y = (f - s.y1 * a1) - s.y2 * a2;
  s.x2 = s.x1;
  s.x1 = v;
  s.y2 = s.y1;
  s.y1 = y;
  return y;
}

// discriminator: fmd[c, j] = disc_value(theta1[j], theta1[j-1]), stored as
// float32 or, in the int16 format, as q_i16 at kFmScale (K1's out_i16,
// frontend_pallas.py:204-207 and :482-485; K12 stores float32)
template <class Out>
__global__ void k12_disc_kernel(const float* __restrict__ theta1,
                                const float* __restrict__ prev_theta,
                                float scale, int channels, int n,
                                Out* __restrict__ fmd) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)channels * n;
  if (idx >= total) return;
  const int c = (int)(idx / n);
  const int j = (int)(idx % n);
  const float prev = j == 0 ? FMT_AT(prev_theta, c, channels)
                            : FMT_AT(theta1, idx - 1, total);
  store_f32(&FMT_AT(fmd, idx, total), 0,
            disc_value(FMT_AT(theta1, idx, total), prev, scale), kFmScale);
}

// de-emphasis, one thread per channel, in place; state (x1, y1) per
// channel
__global__ void k12_deemph_kernel(float* __restrict__ fm_out, int n,
                                  int channels, float b0, float b1, float a1,
                                  const float* __restrict__ st_in,
                                  float* __restrict__ st_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= channels) return;
  float* row = fm_out + (int64_t)c * n;
  float x1 = FMT_AT(st_in, 2 * c, 2 * channels);
  float y1 = FMT_AT(st_in, 2 * c + 1, 2 * channels);
  for (int i0 = 0; i0 < n; i0 += kBatch) {
    float bx[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) bx[u] = FMT_AT(row, i0 + u, n);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      FMT_AT(row, i0 + u, n) = deemph_step(x1, y1, bx[u], b0, b1, a1);
  }
  FMT_AT(st_out, 2 * c, 2 * channels) = x1;
  FMT_AT(st_out, 2 * c + 1, 2 * channels) = y1;
}

// Hilbert (the launches route): im = nh-tap FIR, re = input delayed by
// (nh - 1)/2, written as float32 (the peak IIR reads them); with kI16 also
// as q_i16 at kIqScale into re16, im16 (K2's out_i16 stores,
// midend_pallas.py:254-256)
template <bool kI16>
__global__ void k12_hilbert_kernel(const float* __restrict__ fm_out,
                                   const float* __restrict__ htail,
                                   const float* __restrict__ wh_rev, int nh,
                                   int channels, int n,
                                   float* __restrict__ re,
                                   float* __restrict__ im,
                                   int16_t* __restrict__ re16,
                                   int16_t* __restrict__ im16) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)channels * n;
  if (idx >= total) return;
  const int c = (int)(idx / n);
  const int i = (int)(idx % n);
  const int halo = nh - 1;
  const float* x = fm_out + (int64_t)c * n;
  const float* t = htail + (int64_t)c * halo;
  const float vi = fir_point(x, n, t, halo, wh_rev, nh, i - halo);
  const int d = i - (nh - 1) / 2;
  const float vr = d < 0 ? FMT_AT(t, halo + d, halo) : FMT_AT(x, d, n);
  FMT_AT(im, idx, total) = vi;
  FMT_AT(re, idx, total) = vr;
  if constexpr (kI16) {
    FMT_AT(re16, idx, total) = q_i16(vr, kIqScale);
    FMT_AT(im16, idx, total) = q_i16(vi, kIqScale);
  }
}

// ---- The mid end's fused route (de-emphasis off) ----
//
// k12_mid_fused_kernel runs discriminator (K12) -> ds x2 -> Hilbert for one
// channel and one tile of kMidTile re/im outputs per CTA, with fm_demod
// and fm_out only in shared memory: only re and im (and, from the last
// tile of a channel, the two carried tails) leave the CTA.  Each FIR output
// is the same sum, in the same tap order, as fir_point computes it, so the
// route equals the launches route (and the plain version) bit for bit.
// In the int16 format (K2's in_i16 / out_i16, midend_pallas.py:246,
// :254-257) fm_demod is staged from int16, dequantised as
// fir_decimate_kernel<int16_t> dequantises it (half the source bytes), and
// the carried ds x2 tail is the dequantised value; with the int16 outputs
// the epilogue stores re and im as float32 scratch (the peak IIR runs on
// the unquantised values) and as q_i16 at kIqScale, one 8-byte store a
// plane, and the theta pass stores theta as q_i16 at kPhScale.
// The FIRs are register-blocked: a thread computes kDs2Outs (ds x2) or
// kHilbOuts (Hilbert) neighbouring outputs and slides one window of
// samples through registers, so each tap costs one shared-memory load per
// thread instead of one per multiply-add.  Neighbouring threads' windows
// start 2 kDs2Outs or kHilbOuts samples apart; the planes are stored
// skewed (one pad word every 32) so those loads fall in distinct banks.
// k12_peak_rec_kernel is the peak IIR cut to its recurrence: the two
// biquads and the pilot power (in double, in time order, as the
// megakernel sums it), the filtered planes stored 16 steps at a time;
// k12_theta_kernel then takes theta = atan2 / 2 pi of them in parallel.
// The launches route ends with the same two launches.
constexpr int kMidTile = 1024;   // re/im outputs a CTA of the fused kernel
constexpr int kMidThreads = 256;
constexpr int kDs2Outs = 8;      // ds x2 outputs a thread
constexpr int kHilbOuts = 4;     // Hilbert outputs a thread
// the tap counts the fused kernel is built for (the receiver's ds x2 and
// Hilbert filters); other orders take the launches route
constexpr int kFusedNn2 = 64;
constexpr int kFusedNh = 65;

// The mid end's route (kernels/midend.py::midend_route is its host copy):
// the fused kernel where de-emphasis is off, the filters have the orders
// the fused kernel is built for and the block holds both carried tails,
// in float32 and in every int16 form alike; else the launches
// (fir_decimate_kernel, k12_deemph_kernel, k12_hilbert_kernel).  Both
// routes end with launch_peak_theta.
enum MidRoute { kMidLaunches = 0, kMidFused = 1 };

inline int midend_route(int use_deemph, int nn2, int nh, int n4) {
  if (use_deemph || nn2 != kFusedNn2 || nh != kFusedNh || n4 < nn2 - 2 ||
      n4 / 2 < nh - 1) {
    return kMidLaunches;
  }
  return kMidFused;
}

// the fused kernel's source sample as float32: theta1 or float32 fm_demod
// as loaded, int16 fm_demod dequantised at kFmScale (as load_f32 does for
// fir_decimate_kernel<int16_t>)
__device__ __forceinline__ float mid_src(float v) { return v; }
__device__ __forceinline__ float mid_src(int16_t v) {
  return dq_i16(v, kFmScale);
}

// one tap of the register-blocked ds x2: acc[r] += w * v[r], then, unless
// it was the window's last use, v slides by one output
__device__ __forceinline__ void ds2_tap(float (&acc)[kDs2Outs],
                                        float (&v)[kDs2Outs], float w,
                                        bool slide, const float* s_u,
                                        int next) {
#pragma unroll
  for (int r = 0; r < kDs2Outs; ++r) acc[r] += w * v[r];
  if (slide) {
#pragma unroll
    for (int r = 0; r + 1 < kDs2Outs; ++r) v[r] = v[r + 1];
    v[kDs2Outs - 1] = s_u[mid_skew(next)];
  }
}

// src: theta1 [C, n4] float32 (kFromTheta: the discriminator runs here,
// with prev_theta [C]) or fm_demod [C, n4], float32 or int16 at kFmScale
// (In).  re, im [C, n4/2] float32; with kOut16 also re16, im16 [C, n4/2]
// int16 at kIqScale.  tails [C, (NN2 - 2) + (NH - 1)]: the new ds x2 tail
// (the last NN2 - 2 fm_demod samples, dequantised) then the new Hilbert
// tail (the last NH - 1 fm_out samples), written by each channel's last
// tile.
template <bool kFromTheta, class In, bool kOut16, int NN2, int NH>
__global__ void __launch_bounds__(kMidThreads)
k12_mid_fused_kernel(const In* __restrict__ src,
                     const float* __restrict__ prev_theta, float scale,
                     const float* __restrict__ w2_rev,
                     const float* __restrict__ tail2,
                     const float* __restrict__ wh_rev,
                     const float* __restrict__ htail, int n4,
                     float* __restrict__ re, float* __restrict__ im,
                     int16_t* __restrict__ re16, int16_t* __restrict__ im16,
                     float* __restrict__ tails) {
  static_assert(!kFromTheta || sizeof(In) == sizeof(float),
                "theta1 is float32");
  constexpr int H2 = NN2 - 2, HH = NH - 1, D = (NH - 1) / 2;
  constexpr int NF = kMidTile + HH;  // fm_out window: tile + Hilbert halo
  constexpr int NFP = (NF + kDs2Outs - 1) / kDs2Outs * kDs2Outs;
  // fmd window: every sample the ds x2 items read (their last loads
  // included), from fmd index 2 (i0 - HH) - H2
  constexpr int NU = 2 * NFP + NN2;
  constexpr int OFF = kFromTheta ? 1 : 0;  // the discriminator's previous
  constexpr int NLOAD = (NU + OFF + kMidThreads - 1) / kMidThreads;
  __shared__ float s_u[mid_skew(NU) + 1];
  __shared__ float s_t[kFromTheta ? NU + 1 : 1];
  __shared__ float s_f[mid_skew(NF + kHilbOuts + NH) + 1];
  __shared__ float s_w2[NN2], s_wh[NH];
  const int n8 = n4 / 2;
  const int c = blockIdx.y;
  const int i0 = blockIdx.x * kMidTile;
  const int nt = min(kMidTile, n8 - i0);  // outputs of this tile
  const bool last = i0 + nt == n8;
  const int nf = nt + HH;                 // fm_out values it needs
  const int j0 = 2 * (i0 - HH) - H2;      // fmd index of s_u[0]
  const int nu = 2 * nf + H2;             // fmd values they read
  const In* x = src + (int64_t)c * n4;
  for (int k = threadIdx.x; k < NN2; k += kMidThreads)
    s_w2[k] = FMT_AT(w2_rev, k, NN2);
  for (int k = threadIdx.x; k < NH; k += kMidThreads)
    s_wh[k] = FMT_AT(wh_rev, k, NH);

  // the source over the window, every load of a thread issued before any
  // is used (kFromTheta: one sample more, the discriminator's first
  // previous one, staged in s_t; int16 is dequantised where it is used)
  In raw[NLOAD];
#pragma unroll
  for (int k = 0; k < NLOAD; ++k) {
    const int b = threadIdx.x + k * kMidThreads;  // source j0 - OFF + b
    const int j = j0 - OFF + b;
    raw[k] = b < nu + OFF && j >= 0 ? FMT_AT(x, j, n4) : In(0);
  }
  if constexpr (kFromTheta) {
#pragma unroll
    for (int k = 0; k < NLOAD; ++k) {
      const int b = threadIdx.x + k * kMidThreads;
      if (b < nu + 1) s_t[b] = raw[k];
    }
    __syncthreads();
  }

  // fm_demod over the window (j < 0: the carried ds x2 tail; below it
  // nothing reads: fm_out before the block comes from the Hilbert tail)
#pragma unroll
  for (int k = 0; k < NLOAD; ++k) {
    const int b = threadIdx.x + k * kMidThreads;
    if (b >= nu) continue;
    const int j = j0 + b;
    float v = 0.0f;
    if (j >= 0) {
      if constexpr (kFromTheta) {
        const float prev =
            j == 0 ? FMT_AT(prev_theta, c, gridDim.y) : s_t[b];
        v = disc_value(s_t[b + 1], prev, scale);
      } else {
        v = mid_src(raw[k]);
      }
      if (last && j >= n4 - H2)
        FMT_AT(tails, (int64_t)c * (H2 + HH) + j - (n4 - H2),
               (int64_t)gridDim.y * (H2 + HH)) = v;
    } else if (j >= -H2) {
      v = FMT_AT(tail2, (int64_t)c * H2 + H2 + j, (int64_t)gridDim.y * H2);
    }
    s_u[mid_skew(b)] = v;
  }
  __syncthreads();

  // ds x2: fm_out[i] = sum_k w2[k] fmd[2 i - H2 + k] = s_u[2 a + k] for
  // window position a = i - (i0 - HH); before the block, the Hilbert tail
  for (int it = threadIdx.x; it * kDs2Outs < nf; it += kMidThreads) {
    const int a0 = it * kDs2Outs;
    float acc[kDs2Outs], ev[kDs2Outs], od[kDs2Outs];
#pragma unroll
    for (int r = 0; r < kDs2Outs; ++r) {
      acc[r] = 0.0f;
      ev[r] = s_u[mid_skew(2 * a0 + 2 * r)];
      od[r] = s_u[mid_skew(2 * a0 + 2 * r + 1)];
    }
    // even taps read ev, odd taps od; after its tap each slides by one
    // output (two samples)
#pragma unroll
    for (int k = 0; k < NN2; ++k) {
      const float wk = s_w2[k];
      if (k & 1) {
        ds2_tap(acc, od, wk, k + 2 < NN2, s_u, 2 * a0 + 2 * kDs2Outs + k);
      } else {
        ds2_tap(acc, ev, wk, k + 2 < NN2, s_u, 2 * a0 + 2 * kDs2Outs + k);
      }
    }
#pragma unroll
    for (int r = 0; r < kDs2Outs; ++r) {
      const int a = a0 + r;
      if (a < nf) {
        const int i = i0 - HH + a;
        float f = acc[r];
        if (i < 0) {
          f = FMT_AT(htail, (int64_t)c * HH + HH + i,
                     (int64_t)gridDim.y * HH);
        } else if (last && i >= n8 - HH) {
          FMT_AT(tails, (int64_t)c * (H2 + HH) + H2 + i - (n8 - HH),
                 (int64_t)gridDim.y * (H2 + HH)) = f;
        }
        s_f[mid_skew(a)] = f;
      }
    }
  }
  __syncthreads();

  // Hilbert: im[i] = sum_k wh[k] fm_out[i - HH + k] = s_f[(i - i0) + k],
  // re[i] = fm_out[i - D] = s_f[(i - i0) + HH - D]
  for (int it = threadIdx.x; it * kHilbOuts < nt; it += kMidThreads) {
    const int a0 = it * kHilbOuts;
    float acc[kHilbOuts], v[kHilbOuts];
#pragma unroll
    for (int r = 0; r < kHilbOuts; ++r) {
      acc[r] = 0.0f;
      v[r] = s_f[mid_skew(a0 + r)];
    }
#pragma unroll
    for (int k = 0; k < NH; ++k) {
      const float wk = s_wh[k];
#pragma unroll
      for (int r = 0; r < kHilbOuts; ++r) acc[r] += wk * v[r];
      if (k + 1 < NH) {
#pragma unroll
        for (int r = 0; r + 1 < kHilbOuts; ++r) v[r] = v[r + 1];
        v[kHilbOuts - 1] = s_f[mid_skew(a0 + kHilbOuts + k)];
      }
    }
    float d[kHilbOuts];
#pragma unroll
    for (int r = 0; r < kHilbOuts; ++r) d[r] = s_f[mid_skew(a0 + r + HH - D)];
    static_assert(kHilbOuts == 4, "one float4 store a plane");
    const int64_t o = (int64_t)c * n8 + i0 + a0;  // nt % 4 == 0
#ifdef FMT_CHECKED
    FMT_AT(im, o + 3, (int64_t)gridDim.y * n8);
    FMT_AT(re, o + 3, (int64_t)gridDim.y * n8);
#endif
    *reinterpret_cast<float4*>(im + o) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(re + o) = make_float4(d[0], d[1], d[2], d[3]);
    if constexpr (kOut16) {
#ifdef FMT_CHECKED
      FMT_AT(im16, o + 3, (int64_t)gridDim.y * n8);
      FMT_AT(re16, o + 3, (int64_t)gridDim.y * n8);
#endif
      *reinterpret_cast<uint2*>(im16 + o) = q_i16x4(acc, kIqScale);
      *reinterpret_cast<uint2*>(re16 + o) = q_i16x4(d, kIqScale);
    }
  }
}

// kBatch steps of the peak IIR's recurrence on both planes from (br, bi),
// the pilot power summed in double in time order, the outputs stored at
// yr, yi + at (four floats a store)
__device__ __forceinline__ void peak_batch(Peak2& pr, Peak2& pi, double& pw,
                                           const float (&br)[kBatch],
                                           const float (&bi)[kBatch],
                                           float b0, float b1, float b2,
                                           float a1, float a2,
                                           float* __restrict__ yr,
                                           float* __restrict__ yi,
                                           int64_t at, int64_t total) {
  float orr[kBatch], oi[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    orr[u] = peak_step(pr, br[u], b0, b1, b2, a1, a2);
    oi[u] = peak_step(pi, bi[u], b0, b1, b2, a1, a2);
    pw += (double)(orr[u] * orr[u] + oi[u] * oi[u]);
  }
  store_batch(yr, at, total, orr, 1.0f);
  store_batch(yi, at, total, oi, 1.0f);
}

// the peak IIR's channel spread: kPeakLanes channels a block, a warp of
// its own (256 warps at C = 2048, on every SM).  Measured at the pre-split
// cell (PERF.md): K12 3.414 ms at 32 lanes, 3.300 at 16, 3.242 at 8, 3.225
// at 4: the same recurrence, its loads spread over more SMs.
constexpr int kPeakLanes = 8;

// the peak IIR's recurrence (peak_step on both planes) and the pilot power,
// one thread a channel, kPeakLanes a block; yr, yi [C, n] the filtered
// planes (theta is their angle: k12_theta_kernel).  Each lane keeps three
// batches of kBatch steps of its rows in flight (four register buffers in
// turn) while it runs the present one: one thread a channel gives few
// warps, so the loads' latency, not the recurrence, sets the pace unless
// enough of them are under way.  n % kBatch == 0.
__global__ void __launch_bounds__(kPeakLanes)
k12_peak_rec_kernel(const float* __restrict__ re, const float* __restrict__ im,
                    int n, int channels, float b0, float b1, float b2,
                    float a1, float a2, const float* __restrict__ st_in,
                    float* __restrict__ st_out, float* __restrict__ yr,
                    float* __restrict__ yi, float* __restrict__ power) {
  const int c = blockIdx.x * kPeakLanes + threadIdx.x;
  if (c >= channels) return;
  const int ns = 8 * channels;  // state floats
  const int s0 = 8 * c;
  Peak2 pr{FMT_AT(st_in, s0, ns), FMT_AT(st_in, s0 + 1, ns),
           FMT_AT(st_in, s0 + 2, ns), FMT_AT(st_in, s0 + 3, ns)};
  Peak2 pi{FMT_AT(st_in, s0 + 4, ns), FMT_AT(st_in, s0 + 5, ns),
           FMT_AT(st_in, s0 + 6, ns), FMT_AT(st_in, s0 + 7, ns)};
  const int64_t row = (int64_t)c * n, total = (int64_t)channels * n;
  const int nb = n / kBatch;
  double pw = 0.0;
  // batch q's rows at row + q kBatch (a batch past the last reads the
  // last again: loaded, never run)
  auto at = [&](int q) { return row + (int64_t)min(q, nb - 1) * kBatch; };
  float r0[kBatch], i0[kBatch], r1[kBatch], i1[kBatch], r2[kBatch],
      i2[kBatch], r3[kBatch], i3[kBatch];
  load_batch(re, at(0), total, r0);
  load_batch(im, at(0), total, i0);
  load_batch(re, at(1), total, r1);
  load_batch(im, at(1), total, i1);
  load_batch(re, at(2), total, r2);
  load_batch(im, at(2), total, i2);
  for (int q = 0; q < nb; q += 4) {
    load_batch(re, at(q + 3), total, r3);
    load_batch(im, at(q + 3), total, i3);
    peak_batch(pr, pi, pw, r0, i0, b0, b1, b2, a1, a2, yr, yi, at(q), total);
    load_batch(re, at(q + 4), total, r0);
    load_batch(im, at(q + 4), total, i0);
    if (q + 1 < nb)
      peak_batch(pr, pi, pw, r1, i1, b0, b1, b2, a1, a2, yr, yi, at(q + 1),
                 total);
    load_batch(re, at(q + 5), total, r1);
    load_batch(im, at(q + 5), total, i1);
    if (q + 2 < nb)
      peak_batch(pr, pi, pw, r2, i2, b0, b1, b2, a1, a2, yr, yi, at(q + 2),
                 total);
    load_batch(re, at(q + 6), total, r2);
    load_batch(im, at(q + 6), total, i2);
    if (q + 3 < nb)
      peak_batch(pr, pi, pw, r3, i3, b0, b1, b2, a1, a2, yr, yi, at(q + 3),
                 total);
  }
  const float out[8] = {pr.x1, pr.x2, pr.y1, pr.y2,
                        pi.x1, pi.x2, pi.y1, pi.y2};
#pragma unroll
  for (int k = 0; k < 8; ++k) FMT_AT(st_out, s0 + k, ns) = out[k];
  FMT_AT(power, c, channels) = (float)pw;
}

// theta[i] = atan2_poly(yi[i], yr[i]) / 2 pi for i < n, four a thread
// (n % 4 == 0): in place over yr (float32), or with kI16 stored as q_i16
// at kPhScale into theta16 (the int16 format's theta: the same float32
// operations, then the format's rounding, one 8-byte store)
template <bool kI16>
__global__ void k12_theta_kernel(float* __restrict__ yr,
                                 const float* __restrict__ yi,
                                 int16_t* __restrict__ theta16, int64_t n) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
#ifdef FMT_CHECKED
  FMT_AT(yr, i + 3, n);
  FMT_AT(yi, i + 3, n);
  if constexpr (kI16) FMT_AT(theta16, i + 3, n);
#endif
  const float4 r = *reinterpret_cast<const float4*>(yr + i);
  const float4 q = *reinterpret_cast<const float4*>(yi + i);
  const float t[4] = {atan2_poly(q.x, r.x) * kInvTwoPi,
                      atan2_poly(q.y, r.y) * kInvTwoPi,
                      atan2_poly(q.z, r.z) * kInvTwoPi,
                      atan2_poly(q.w, r.w) * kInvTwoPi};
  if constexpr (kI16) {
    *reinterpret_cast<uint2*>(theta16 + i) = q_i16x4(t, kPhScale);
  } else {
    *reinterpret_cast<float4*>(yr + i) = make_float4(t[0], t[1], t[2], t[3]);
  }
}

// The end of both routes: the peak IIR's recurrence on re, im [C, n8] ->
// yr (into theta), yi (scratch), the pilot power [C] and the peak state;
// then the theta pass, in place over theta, or into theta16 (the int16
// format; theta is then scratch too).
inline int launch_peak_theta(const float* re, const float* im, int channels,
                             int n8, float pk_b0, float pk_b1, float pk_b2,
                             float pk_a1, float pk_a2, const float* pk_st_in,
                             float* pk_st_out, float* theta, float* yi,
                             float* power, int16_t* theta16,
                             cudaStream_t stream) {
  k12_peak_rec_kernel<<<blocks_for(channels, kPeakLanes), kPeakLanes, 0,
                        stream>>>(re, im, n8, channels, pk_b0, pk_b1, pk_b2,
                                  pk_a1, pk_a2, pk_st_in, pk_st_out, theta,
                                  yi, power);
  FMT_CHECK_LAUNCH();
  const int64_t t8 = (int64_t)channels * n8;
  if (theta16 != nullptr) {
    k12_theta_kernel<true><<<blocks_for(t8 / 4), kThreads, 0, stream>>>(
        theta, yi, theta16, t8);
  } else {
    k12_theta_kernel<false><<<blocks_for(t8 / 4), kThreads, 0, stream>>>(
        theta, yi, nullptr, t8);
  }
  FMT_CHECK_LAUNCH();
  return 0;
}

// The fused route after fm_demod (K2: src = fmd, float32 or int16) or after
// ds x4 + atan2 (K12: src = theta1, kFromTheta): the fused kernel -> re, im
// (and, given re16, im16 and theta16, the int16 outputs) and the tails;
// then launch_peak_theta.
template <bool kFromTheta, class In>
inline int launch_mid_fused(const In* src, const float* prev_theta,
                            float scale, const float* w2_rev,
                            const float* tail2, const float* wh_rev,
                            const float* htail, float pk_b0, float pk_b1,
                            float pk_b2, float pk_a1, float pk_a2,
                            const float* pk_st_in, float* pk_st_out,
                            int channels, int n4, float* re, float* im,
                            float* theta, float* yi, float* tails,
                            float* power, int16_t* re16, int16_t* im16,
                            int16_t* theta16, cudaStream_t stream) {
  const int n8 = n4 / 2;
  const dim3 grid((unsigned)((n8 + kMidTile - 1) / kMidTile),
                  (unsigned)channels);
  if (re16 == nullptr) {
    k12_mid_fused_kernel<kFromTheta, In, false, kFusedNn2, kFusedNh>
        <<<grid, kMidThreads, 0, stream>>>(src, prev_theta, scale, w2_rev,
                                           tail2, wh_rev, htail, n4, re, im,
                                           nullptr, nullptr, tails);
  } else if constexpr (!kFromTheta) {
    k12_mid_fused_kernel<false, In, true, kFusedNn2, kFusedNh>
        <<<grid, kMidThreads, 0, stream>>>(src, prev_theta, scale, w2_rev,
                                           tail2, wh_rev, htail, n4, re, im,
                                           re16, im16, tails);
  } else {
    return (int)cudaErrorInvalidValue;  // K12 stores float32
  }
  FMT_CHECK_LAUNCH();
  return launch_peak_theta(re, im, channels, n8, pk_b0, pk_b1, pk_b2, pk_a1,
                           pk_a2, pk_st_in, pk_st_out, theta, yi, power,
                           theta16, stream);
}

// The discriminator over theta1 [C, n4] -> fmd [C, n4] (float32 or int16).
template <class Out>
inline int launch_disc(const float* theta1, const float* prev_theta,
                       float scale, int channels, int n4, Out* fmd,
                       cudaStream_t stream) {
  k12_disc_kernel<Out><<<blocks_for((int64_t)channels * n4), kThreads, 0,
                         stream>>>(theta1, prev_theta, scale, channels, n4,
                                   fmd);
  FMT_CHECK_LAUNCH();
  return 0;
}

// The mid end on fmd [C, n4] (float32, or int16 at kFmScale dequantised
// where it is loaded), by midend_route:
// - fused (launch_mid_fused): re, im, the carried tails into tails
//   [C, (nn2 - 2) + (nh - 1)], theta and the pilot power; yi [C, n4/2] is
//   scratch, fm_out unused;
// - launches: ds x2 into fm_out [C, n4/2] (scratch, whose last samples
//   the host keeps as the Hilbert tail), the optional de-emphasis in
//   place, Hilbert -> re, im, then launch_peak_theta with the scratch yi
//   [C, n4/2]; tails unused.
// Given re16 (the int16 format's outputs re16, im16, theta16), both routes
// write them (re16, im16 at kIqScale, theta16 at kPhScale) and re, im and
// theta are float32 scratch; else re, im, theta are the outputs.
// n4/2 % kBatch == 0.
template <class In>
inline int launch_midend(const In* fmd, const float* w2_rev, int nn2,
                         const float* tail2, int use_deemph, float de_b0,
                         float de_b1, float de_a1, const float* de_st_in,
                         float* de_st_out, const float* wh_rev, int nh,
                         const float* htail, float pk_b0, float pk_b1,
                         float pk_b2, float pk_a1, float pk_a2,
                         const float* pk_st_in, float* pk_st_out,
                         int channels, int n4, float* fm_out, float* re,
                         float* im, float* theta, int16_t* re16,
                         int16_t* im16, int16_t* theta16, float* power,
                         cudaStream_t stream, float* yi,
                         float* tails = nullptr) {
  if (yi == nullptr) return (int)cudaErrorInvalidValue;
  if (midend_route(use_deemph, nn2, nh, n4) == kMidFused) {
    if (tails == nullptr) return (int)cudaErrorInvalidValue;
    return launch_mid_fused<false>(fmd, nullptr, 1.0f, w2_rev, tail2, wh_rev,
                                   htail, pk_b0, pk_b1, pk_b2, pk_a1, pk_a2,
                                   pk_st_in, pk_st_out, channels, n4, re, im,
                                   theta, yi, tails, power, re16, im16,
                                   theta16, stream);
  }
  const int n8 = n4 / 2;
  const int64_t t8 = (int64_t)channels * n8;
  int err = fir_decimate(fmd, n4, tail2, w2_rev, nn2, 2, fm_out, channels,
                         stream, kFmScale);
  if (err) return err;
  if (use_deemph) {
    k12_deemph_kernel<<<blocks_for(channels, kSerialThreads),
                        kSerialThreads, 0, stream>>>(
        fm_out, n8, channels, de_b0, de_b1, de_a1, de_st_in, de_st_out);
    FMT_CHECK_LAUNCH();
  }
  if (re16 != nullptr) {
    k12_hilbert_kernel<true><<<blocks_for(t8), kThreads, 0, stream>>>(
        fm_out, htail, wh_rev, nh, channels, n8, re, im, re16, im16);
  } else {
    k12_hilbert_kernel<false><<<blocks_for(t8), kThreads, 0, stream>>>(
        fm_out, htail, wh_rev, nh, channels, n8, re, im, nullptr, nullptr);
  }
  FMT_CHECK_LAUNCH();
  return launch_peak_theta(re, im, channels, n8, pk_b0, pk_b1, pk_b2, pk_a1,
                           pk_a2, pk_st_in, pk_st_out, theta, yi, power,
                           theta16, stream);
}

}  // namespace fmt
