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
//                         at every filter order within the 128-sample
//                         halo, on a block that holds both carried tails,
//                         the split route (launch_mid_split: a tiled ds x2
//                         kernel, the de-emphasis where it is on, a tiled
//                         Hilbert kernel; the receiver's orders on kernels
//                         built for them, any other on any-order forms);
//                         on a shorter block one launch per stage up to
//                         Hilbert; every route then runs the peak IIR
//                         cut to its recurrence and a parallel theta pass
//                         (launch_peak_theta)
//
// The per-sample formulas (disc_value, deemph_step, peak_step) are device
// functions that the full-chain megakernel (chain.cu) evaluates too, tile
// by tile, so the chain equals the split path bit for bit.
//
// What bounds each launch, and what its design does about it, is noted in
// k12.cu and above the split route's kernels below; the times per launch
// are in PERF.md.
#pragma once

#include "bulk_copy.cuh"
#include "common.cuh"

namespace fmt {

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

// What ds4_i8_blocked_kernel does with a store's runs: where the window
// of the run from output j starts (shift: words past K12's, whose window
// of output j ends at word j), the value of an output from its int32
// sums, whether thread tid sums the output before the tile (t0 - 1, the
// finish's `extra`, K12's window), and the run's finish.  K12's rule
// (theta1, ds4_finish) serves Ds4Theta and Ds4Disc; the K1 probe's
// int8-direct stores (frontend_probe.cu) specialise it.
template <class Store>
struct Ds4Rule {
  __device__ __forceinline__ static int shift(const Store&, int) {
    return 0;
  }
  __device__ __forceinline__ static bool prev_output(const Store&, int tid,
                                                     int t0) {
    return Store::kDisc && tid == 0 && t0 > 0;
  }
  __device__ __forceinline__ static float value(int y1r, int y2r, int y1i,
                                                int y2i, float s_row) {
    return ds4_i8_theta(y1r, y2r, y1i, y2i, s_row);
  }
  template <int R>
  __device__ __forceinline__ static void finish(const Store& st, int c,
                                                int channels, int n, int t0,
                                                int run,
                                                const float (&th)[R],
                                                float extra, float* s_last) {
    ds4_finish<R>(st, c, channels, n, t0, run, th, extra, s_last);
  }
};

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

// The sliding window of ds4_i8_blocked_kernel: R neighbouring outputs of
// skewed int8-word planes s_re, s_im whose windows start at word eb, summed
// exactly in int32 against the nwp (a multiple of R) tap pairs s_tap.  Step
// w = qb + qq: output r reads slot (r + qq) % R, which holds word eb + r +
// w; slot qq is then refilled with the word output 0 reads R steps on, so
// each shared-memory load serves 4 R __dp4a.  (The K1 probe,
// frontend_probe.cu, sums its staged words with it too.)
template <int R>
__device__ __forceinline__ void ds4_i8_window(
    const int* s_re, const int* s_im, const int2* s_tap, int eb, int nwp,
    int (&y1r)[R], int (&y2r)[R], int (&y1i)[R], int (&y2i)[R]) {
  int vr[R], vi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    vr[r] = s_re[mid_skew(eb + r)];
    vi[r] = s_im[mid_skew(eb + r)];
    y1r[r] = y2r[r] = y1i[r] = y2i[r] = 0;
  }
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

  int y1r[R], y2r[R], y1i[R], y2i[R];
  ds4_i8_window<R>(s_re, s_im, s_tap,
                   h - nwp + 1 + R * tid +
                       Ds4Rule<Store>::shift(st, t0 + R * tid),
                   nwp, y1r, y2r, y1i, y2i);
  float th[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    th[r] = Ds4Rule<Store>::value(y1r[r], y2r[r], y1i[r], y2i[r], s_row);
  float extra = 0.0f;
  if (Ds4Rule<Store>::prev_output(st, tid, t0)) {  // output t0 - 1
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
  Ds4Rule<Store>::template finish<R>(st, c, channels, n, t0, tid, th,
                                     extra, s_last);
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

// The de-emphasis's shape: kDeemphLanes channels a block (a lane a
// channel), each lane's row brought into shared memory kDeemphChunk steps
// at a time by bulk copies, kDeemphSlots chunks a lane (all but the one
// that runs in flight).  A measured choice (PERF.md: the sweep over lanes,
// chunk and slots); kernels/midend.py keeps a host copy of the lanes
// (DEEMPH_LANES).
constexpr int kDeemphLanes = 16;
constexpr int kDeemphChunk = 512;
constexpr int kDeemphSlots = 6;
// a lane's ring of kDeemphSlots chunks, each lane's ring 16 bytes longer
// than the last (a quarter warp's 16-byte reads of its lanes' rings then
// fall in distinct bank groups), and a block's dynamic shared memory
constexpr int kDeemphRing = kDeemphSlots * kDeemphChunk + 4;
constexpr int kDeemphSmem = 4 * kDeemphLanes * kDeemphRing;

// de-emphasis (deemph_step) of x [C, n] into y [C, n], one thread a
// channel, kDeemphLanes a block; state (x1, y1) a channel.  The
// recurrence's chain is two dependent float operations a step, so a load
// that waits costs it: a lane's row comes into its shared-memory ring by
// cp.async.bulk, kDeemphSlots - 1 chunks of kDeemphChunk steps in flight
// on their mbarriers while it runs the present one, the next batch of
// kBatch steps read (16-byte loads) while one runs; the outputs leave
// kBatch at a time from registers.  A register ring of batches (kBatch-step loads a few
// batches ahead, k12_peak_rec_kernel's form) ran several times slower
// here (PERF.md): a chain this short does not cover its loads' latency.
// In place where x == y (the receiver's launches: fm_out), so x and y
// may alias: a chunk is loaded before any of it is stored, and no load
// reaches past the row.  n % kBatch == 0, x and y 16-byte aligned;
// dynamic shared memory kDeemphSmem.
__global__ void __launch_bounds__(kDeemphLanes)
k12_deemph_kernel(const float* x, float* y, int n, int channels, float b0,
                  float b1, float a1, const float* __restrict__ st_in,
                  float* __restrict__ st_out) {
  static_assert(kDeemphChunk % kBatch == 0 && kDeemphSlots >= 2,
                "whole batches");
  extern __shared__ __align__(128) float de_ring[];
  __shared__ __align__(8) uint64_t bar[kDeemphLanes][kDeemphSlots];
  const int lane = threadIdx.x;
  const int c = blockIdx.x * kDeemphLanes + lane;
  if (c >= channels) return;
  const int64_t row = (int64_t)c * n, total = (int64_t)channels * n;
  // the last chunk may be short
  const int nc = (n + kDeemphChunk - 1) / kDeemphChunk;
  float* ring = de_ring + lane * kDeemphRing;
  uint64_t* mb = bar[lane];
#pragma unroll
  for (int s = 0; s < kDeemphSlots; ++s) mbar_init(&mb[s]);
  mbar_fence_init();
  auto issue = [&](int k) {  // chunk k into slot k % kDeemphSlots
    const int slot = k % kDeemphSlots;
    const uint32_t bytes =
        4u * (uint32_t)min(kDeemphChunk, n - k * kDeemphChunk);
#ifdef FMT_CHECKED
    FMT_AT(x, row + (int64_t)k * kDeemphChunk + bytes / 4 - 1, total);
#endif
    mbar_expect(&mb[slot], bytes);
    bulk_g2s(ring + slot * kDeemphChunk, x + row + (int64_t)k * kDeemphChunk,
             bytes, &mb[slot]);
  };
  for (int k = 0; k < kDeemphSlots - 1 && k < nc; ++k) issue(k);
  float x1 = FMT_AT(st_in, 2 * c, 2 * channels);
  float y1 = FMT_AT(st_in, 2 * c + 1, 2 * channels);
  for (int k = 0; k < nc; ++k) {
    if (k + kDeemphSlots - 1 < nc) {
      fence_async_shared();  // this lane's reads of the slot chunk k - 1 left
      issue(k + kDeemphSlots - 1);
    }
    const int slot = k % kDeemphSlots;
    mbar_wait(&mb[slot], (uint32_t)((k / kDeemphSlots) & 1));
    const float* src = ring + slot * kDeemphChunk;
    const int steps = min(kDeemphChunk, n - k * kDeemphChunk);
    float cur[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; u += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + u);
      cur[u] = v.x;
      cur[u + 1] = v.y;
      cur[u + 2] = v.z;
      cur[u + 3] = v.w;
    }
    for (int i0 = 0; i0 < steps; i0 += kBatch) {
      float nxt[kBatch];
      if (i0 + kBatch < steps) {
#pragma unroll
        for (int u = 0; u < kBatch; u += 4) {
          const float4 v =
              *reinterpret_cast<const float4*>(src + i0 + kBatch + u);
          nxt[u] = v.x;
          nxt[u + 1] = v.y;
          nxt[u + 2] = v.z;
          nxt[u + 3] = v.w;
        }
      }
      float out[kBatch];
#pragma unroll
      for (int s = 0; s < kBatch; ++s)
        out[s] = deemph_step(x1, y1, cur[s], b0, b1, a1);
      store_batch(y, row + (int64_t)k * kDeemphChunk + i0, total, out, 1.0f);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) cur[u] = nxt[u];
    }
  }
  FMT_AT(st_out, 2 * c, 2 * channels) = x1;
  FMT_AT(st_out, 2 * c + 1, 2 * channels) = y1;
}

// the de-emphasis of x into y (x == y: in place)
inline int launch_deemph(const float* x, float* y, int n, int channels,
                         float b0, float b1, float a1, const float* st_in,
                         float* st_out, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      k12_deemph_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDeemphSmem);
  if (e != cudaSuccess) return (int)e;
  k12_deemph_kernel<<<blocks_for(channels, kDeemphLanes), kDeemphLanes,
                      kDeemphSmem, stream>>>(x, y, n, channels, b0, b1, a1,
                                             st_in, st_out);
  FMT_CHECK_LAUNCH();
  return 0;
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

// ---- The mid end's split route ----
//
// At every filter order within the halo the mid end runs two tiled
// kernels (at other orders than the receiver's their any-order forms,
// below), one channel and one tile of kMidTile outputs a CTA each:
// k12_mid_ds2_kernel ([K12's discriminator on the staged theta1 ->] ds
// x2, fm_out to device memory) and k12_mid_hilb_kernel (fm_out staged
// back, Hilbert -> re, im), with the de-emphasis in place over fm_out
// between them where it is on (k12_deemph_kernel).  Each FIR output is the same sum, in the same tap
// order, as fir_point computes it, so the route equals the launches route
// (and the plain version) bit for bit.  With de-emphasis off this route
// replaced a fused kernel that ran both FIRs in one launch with fm_out in
// shared memory only: the two launches, fm_out's round trip through device
// memory included, took 0.57 device ms a block at the pre-split cell where
// the fused kernel took 0.95 (PERF.md: its registers, spills and CTAs an
// SM against the halves').  The device functions (mid_stage_fmd, mid_ds2,
// mid_hilb_runs under mid_hilb) also serve the K2 probe's engine kernels
// (csrc/k2_probe.cu), which store other planes.
// In the int16 format (K2's in_i16 / out_i16, midend_pallas.py:246,
// :254-257) fm_demod is staged from int16, dequantised as
// fir_decimate_kernel<int16_t> dequantises it (half the source bytes), and
// the carried ds x2 tail is the dequantised value; with the int16 outputs
// the Hilbert kernel stores re and im as float32 scratch (the peak IIR runs
// on the unquantised values) and as q_i16 at kIqScale, one 8-byte store a
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
// Every route ends with the same two launches.
constexpr int kMidTile = 1024;   // re/im outputs a CTA of the tiled kernels
constexpr int kMidThreads = 256; // threads a CTA of the Hilbert kernel
constexpr int kDs2Outs = 8;      // ds x2 outputs a thread
constexpr int kHilbOuts = 4;     // Hilbert outputs a thread
// the ds x2 kernel's threads: one run of kDs2Outs outputs each
constexpr int kDs2Threads = kMidTile / kDs2Outs;
// the tap counts the tiled kernels are built for (the receiver's ds x2 and
// Hilbert filters); every other order within the halo takes their
// any-order forms (k12_mid_ds2_any_kernel, k12_mid_hilb_any_kernel)
constexpr int kTiledNn2 = 64;
constexpr int kTiledNh = 65;
// the longest carried tail the tiles hold (models/demod.py::check_slice
// admits no filter reaching further back), and the orders it admits:
// ds x2 tail nn2 - 2, Hilbert tail nh - 1
constexpr int kMidHalo = 128;
constexpr int kMaxNn2 = kMidHalo + 2;
constexpr int kMaxNh = kMidHalo + 1;

// The mid end's route (kernels/midend.py::midend_route is its host copy):
// at every order within the halo (2 <= nn2 <= kMaxNn2, 1 <= nh <=
// kMaxNh) on a block that holds both carried tails, in float32 and in
// every int16 form alike and with de-emphasis on or off, the split route;
// on a block shorter than a tail (n4 < nn2 - 2 or n4/2 < nh - 1) the
// launches (fir_decimate_kernel, k12_deemph_kernel, k12_hilbert_kernel;
// demod_block never sends one: its blocks are whole multiples of 8,192
// samples, so direct wrapper calls alone take them); other orders are
// refused.  Every route ends with launch_peak_theta.
enum MidRoute { kMidRefused = -1, kMidLaunches = 0, kMidSplit = 1 };

inline int midend_route(int nn2, int nh, int n4) {
  if (nn2 < 2 || nn2 > kMaxNn2 || nh < 1 || nh > kMaxNh) return kMidRefused;
  if (n4 < nn2 - 2 || n4 / 2 < nh - 1) return kMidLaunches;
  return kMidSplit;
}

// the ds x2 kernel's source sample as float32: theta1 or float32 fm_demod
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

// fm_demod over a window of nu samples from fmd index j0 into s_u
// (skewed), kThr threads of the CTA: every load of a thread issued before
// any is used.  The source x is channel c's row [n4] of theta1
// (kFromTheta: one sample more, the discriminator's first previous one,
// staged in s_t; the discriminator runs here, prev_theta [C] before the
// block) or of fm_demod, float32 or int16 (dequantised where it is used).
// j < 0 reads the carried ds x2 tail tail2 [C, H2]; below it nothing
// reads (fm_out before the block comes from the Hilbert tail).  From the
// channel's last tile (last), the new ds x2 tail (j >= n4 - H2) goes to
// the first H2 floats of tails' row c (row stride TS).  Ends with the
// CTA's barrier.
template <bool kFromTheta, class In, int H2, int TS, int NLOAD, int kThr>
__device__ __forceinline__ void mid_stage_fmd(
    const In* __restrict__ x, const float* __restrict__ prev_theta,
    float scale, const float* __restrict__ tail2, int n4, int c, int j0,
    int nu, bool last, float* __restrict__ tails, float* s_u, float* s_t) {
  constexpr int OFF = kFromTheta ? 1 : 0;  // the discriminator's previous
  In raw[NLOAD];
#pragma unroll
  for (int k = 0; k < NLOAD; ++k) {
    const int b = threadIdx.x + k * kThr;  // source j0 - OFF + b
    const int j = j0 - OFF + b;
    raw[k] = b < nu + OFF && j >= 0 ? FMT_AT(x, j, n4) : In(0);
  }
  if constexpr (kFromTheta) {
#pragma unroll
    for (int k = 0; k < NLOAD; ++k) {
      const int b = threadIdx.x + k * kThr;
      if (b < nu + 1) s_t[b] = raw[k];
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < NLOAD; ++k) {
    const int b = threadIdx.x + k * kThr;
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
        FMT_AT(tails, (int64_t)c * TS + j - (n4 - H2),
               (int64_t)gridDim.y * TS) = v;
    } else if (j >= -H2) {
      v = FMT_AT(tail2, (int64_t)c * H2 + H2 + j, (int64_t)gridDim.y * H2);
    }
    s_u[mid_skew(b)] = v;
  }
  __syncthreads();
}

// The register-blocked ds x2 over the staged window s_u: output a (a <
// n_out, window position a) = sum_k w2[k] s_u[2 a + k], kDs2Outs
// neighbouring outputs a thread, one run a thread (n_out <= the CTA's
// threads x kDs2Outs: no loop, whose invariant tap loads the compiler
// would hold in registers across it), handed to emit(a0, acc) (its
// outputs a0 .. a0 + kDs2Outs - 1; the last run may hold positions past
// n_out, which emit leaves out).
template <int NN2, class Emit>
__device__ __forceinline__ void mid_ds2(const float* s_u, const float* s_w2,
                                        int n_out, Emit emit) {
  const int a0 = threadIdx.x * kDs2Outs;
  if (a0 >= n_out) return;
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
  emit(a0, acc);
}

// The register-blocked Hilbert over the staged fm_out s_f (s_f[a] is
// fm_out[i0 - HH + a]): for the tile's nt outputs (nt % 4 == 0), output a
// = sum_k wh[k] s_f[a + k], kHilbOuts neighbouring outputs a thread, one
// run a thread (nt <= the CTA's threads x kHilbOuts), handed to emit(a0,
// acc) (its outputs a0 .. a0 + kHilbOuts - 1).
template <int NH, class Emit>
__device__ __forceinline__ void mid_hilb_runs(const float* s_f,
                                              const float* s_wh, int nt,
                                              Emit emit) {
  const int a0 = threadIdx.x * kHilbOuts;
  if (a0 >= nt) return;
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
  emit(a0, acc);
}

// mid_hilb_runs and the mid end's stores: for the tile's outputs i = i0 +
// a, im[i] = sum_k wh[k] fm_out[i - HH + k] = s_f[a + k] and re[i] =
// fm_out[i - D] = s_f[a + HH - D], one float4 store a plane (with kOut16
// also q_i16 at kIqScale, one 8-byte store a plane) into row c of re, im
// [C, n8].
template <bool kOut16, int NH>
__device__ __forceinline__ void mid_hilb(const float* s_f, const float* s_wh,
                                         int c, int n8, int i0, int nt,
                                         float* __restrict__ re,
                                         float* __restrict__ im,
                                         int16_t* __restrict__ re16,
                                         int16_t* __restrict__ im16) {
  constexpr int HH = NH - 1, D = (NH - 1) / 2;
  mid_hilb_runs<NH>(
      s_f, s_wh, nt, [&](int a0, const float (&acc)[kHilbOuts]) {
        float d[kHilbOuts];
#pragma unroll
        for (int r = 0; r < kHilbOuts; ++r)
          d[r] = s_f[mid_skew(a0 + r + HH - D)];
        static_assert(kHilbOuts == 4, "one float4 store a plane");
        const int64_t o = (int64_t)c * n8 + i0 + a0;  // nt % 4 == 0
#ifdef FMT_CHECKED
        FMT_AT(im, o + 3, (int64_t)gridDim.y * n8);
        FMT_AT(re, o + 3, (int64_t)gridDim.y * n8);
#endif
        *reinterpret_cast<float4*>(im + o) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
        *reinterpret_cast<float4*>(re + o) =
            make_float4(d[0], d[1], d[2], d[3]);
        if constexpr (kOut16) {
#ifdef FMT_CHECKED
          FMT_AT(im16, o + 3, (int64_t)gridDim.y * n8);
          FMT_AT(re16, o + 3, (int64_t)gridDim.y * n8);
#endif
          *reinterpret_cast<uint2*>(im16 + o) = q_i16x4(acc, kIqScale);
          *reinterpret_cast<uint2*>(re16 + o) = q_i16x4(d, kIqScale);
        }
      });
}

// The split route's CTAs an SM that the register budget must admit
// (__launch_bounds__' second argument): a CTA stages its window, waits at
// the barrier and only then sums, so the loads of one CTA overlap only
// the sums of the others on its SM.  At the lenses' shape both kernels
// ran fastest, of the counts tried, at these (ds x2 at most 64 registers,
// Hilbert 48, neither spilling; PERF.md).
constexpr int kDs2MinBlocks = 8;
constexpr int kHilbMinBlocks = 5;

// The split route's first launch: the staging and ds x2 over one
// channel's tile of kMidTile fm_out outputs (no Hilbert halo),
// kDs2Threads threads a CTA, one run of kDs2Outs outputs each, stored to
// fm_out [C, n4/2] with two 16-byte stores (n4/2 % 8 == 0).  src: theta1
// [C, n4] float32 (kFromTheta: the discriminator runs here, with
// prev_theta [C] and its scale) or fm_demod [C, n4], float32 or int16 at
// kFmScale (In); tails [C, NN2 - 2]: the new ds x2 tail (the last NN2 - 2
// fm_demod samples, dequantised, or K12's discriminator outputs), written
// by each channel's last tile.  Its bound is the bytes (src in, fm_out
// out) beside the FMUL+FADD issue of 2 NN2 instructions an output.
template <bool kFromTheta, class In, int NN2>
__global__ void __launch_bounds__(kDs2Threads, kDs2MinBlocks)
k12_mid_ds2_kernel(const In* __restrict__ src,
                   const float* __restrict__ prev_theta, float scale,
                   const float* __restrict__ w2_rev,
                   const float* __restrict__ tail2, int n4,
                   float* __restrict__ fm_out, float* __restrict__ tails) {
  static_assert(!kFromTheta || sizeof(In) == sizeof(float),
                "theta1 is float32");
  static_assert(kDs2Outs == 8, "two float4 stores a run");
  static_assert(kDs2Threads * kDs2Outs >= kMidTile, "one run a thread");
  constexpr int H2 = NN2 - 2;
  constexpr int NU = 2 * kMidTile + NN2;  // every sample the runs read
  constexpr int OFF = kFromTheta ? 1 : 0;
  constexpr int NLOAD = (2 * kMidTile + H2 + OFF + kDs2Threads - 1) /
                        kDs2Threads;
  __shared__ float s_u[mid_skew(NU) + 1];
  __shared__ float s_t[kFromTheta ? NU + 1 : 1];
  __shared__ float s_w2[NN2];
  const int n8 = n4 / 2;
  const int c = blockIdx.y;
  const int i0 = blockIdx.x * kMidTile;
  const int nt = min(kMidTile, n8 - i0);  // outputs of this tile
  for (int k = threadIdx.x; k < NN2; k += kDs2Threads)
    s_w2[k] = FMT_AT(w2_rev, k, NN2);
  mid_stage_fmd<kFromTheta, In, H2, H2, NLOAD, kDs2Threads>(
      src + (int64_t)c * n4, prev_theta, scale, tail2, n4, c, 2 * i0 - H2,
      2 * nt + H2, i0 + nt == n8, tails, s_u, s_t);
  const int64_t total = (int64_t)gridDim.y * n8;
  mid_ds2<NN2>(
      s_u, s_w2, nt, [&](int a0, const float (&acc)[kDs2Outs]) {
        float4* d = reinterpret_cast<float4*>(
            FMT_SPAN(fm_out, (int64_t)c * n8 + i0 + a0, kDs2Outs, total));
        d[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        d[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
      });
}

// The split route's second launch: the tile's kMidTile + NH - 1 fm_out
// [C, n8] samples (de-emphasised where the de-emphasis is on) staged
// (skewed; i < 0 from the carried Hilbert tail htail [C, NH - 1]), every
// load of a thread issued before any is stored, then the register-blocked
// Hilbert and stores (mid_hilb): re, im
// [C, n8] float32, with kOut16 also re16, im16 int16 at kIqScale.  Its
// bound is the bytes (fm_out in, re and im out) beside the FMUL+FADD issue
// of 2 NH instructions an output.
template <bool kOut16, int NH>
__global__ void __launch_bounds__(kMidThreads, kHilbMinBlocks)
k12_mid_hilb_kernel(const float* __restrict__ fm_out,
                    const float* __restrict__ wh_rev,
                    const float* __restrict__ htail, int n8,
                    float* __restrict__ re, float* __restrict__ im,
                    int16_t* __restrict__ re16, int16_t* __restrict__ im16) {
  static_assert(kMidThreads * kHilbOuts >= kMidTile, "one run a thread");
  constexpr int HH = NH - 1;
  constexpr int NF = kMidTile + HH;  // fm_out window: tile + Hilbert halo
  constexpr int NLOAD = (NF + kMidThreads - 1) / kMidThreads;
  __shared__ float s_f[mid_skew(NF + kHilbOuts + NH) + 1];
  __shared__ float s_wh[NH];
  const int c = blockIdx.y;
  const int i0 = blockIdx.x * kMidTile;
  const int nt = min(kMidTile, n8 - i0);  // outputs of this tile
  const int nf = nt + HH;                 // fm_out values it needs
  for (int k = threadIdx.x; k < NH; k += kMidThreads)
    s_wh[k] = FMT_AT(wh_rev, k, NH);
  const float* x = fm_out + (int64_t)c * n8;
  // this staging (the raw[] loads, the halo's select, the skewed stores)
  // has a copy in k2_probe.cu's k2_hilb_kernel: a change here goes there
  float raw[NLOAD];
#pragma unroll
  for (int k = 0; k < NLOAD; ++k) {
    const int a = threadIdx.x + k * kMidThreads;  // fm_out i0 - HH + a
    const int i = i0 - HH + a;
    raw[k] = a >= nf ? 0.0f
             : i >= 0
                 ? FMT_AT(x, i, n8)
                 : FMT_AT(htail, (int64_t)c * HH + HH + i,
                          (int64_t)gridDim.y * HH);
  }
#pragma unroll
  for (int k = 0; k < NLOAD; ++k) {
    const int a = threadIdx.x + k * kMidThreads;
    if (a < nf) s_f[mid_skew(a)] = raw[k];
  }
  __syncthreads();
  mid_hilb<kOut16, NH>(s_f, s_wh, c, n8, i0, nt, re, im,
                                          re16, im16);
}

// ---- The split route at other filter orders ----
//
// Every other order within the halo takes k12_mid_ds2_any_kernel and
// k12_mid_hilb_any_kernel: the tiled kernels' tiles, threads, runs and
// stores, with the order passed at run time (the receiver's kernels, built
// for 64 / 65 taps, keep their own code).  Each FIR is mid_fir_any, the
// form of extract_stages.cuh::fir_block_any for a thread's run: tap k =
// M q + p is step q of phase p, each phase keeps a window of R samples in
// registers, one an output (at step q output r reads slot (r + q) % R; the
// slot output 0 has just read is refilled with the sample output R - 1
// reads next), whole blocks of R steps run in a run-time loop, the last
// 1 .. R steps and the extra step of the nn % M phases in a switch of
// compile-time instantiations.  So each output is fir_point's sum, in
// ascending tap order, and no tap is padded (a zero tap would read a
// sample the plain version never reads for that output: an Inf there
// would make a NaN).  The window is staged for that loop: a thread's runs
// start P = M R samples after its neighbour's (ds x2 16, Hilbert 4), and
// sample j lies at word any_word<P>(j) = j + j / P, so a block of R steps
// moves every load by P + 1 words (a constant offset from the thread's
// pointer, no address arithmetic in the loop), and since P + 1 is odd a
// warp's loads fall in 32 distinct banks.  The taps are read four at a
// time, as broadcasts.
// the staged taps' floats: the longest filter and the float4 reads past
// its last tap
constexpr int kAnyTaps = kMidHalo + 8;

template <int P>
__host__ __device__ constexpr int any_word(int j) {
  return j + j / P;
}

// S <= R steps of mid_fir_any from a block's first step: xq the thread's
// window advanced by the blocks before (P + 1 words each), wq the taps
// from the block's first step (16-byte aligned: a block is P taps, a
// multiple of 4; the float4 reads may pass the last tap, never used);
// kLast: the FIR's last steps, whose final one loads nothing.
template <int M, int R, int S, bool kLast>
__device__ __forceinline__ void mid_any_steps(const float* __restrict__ xq,
                                              const float* __restrict__ wq,
                                              float (&v)[M][R],
                                              float (&acc)[R]) {
  constexpr int P = M * R;
  static_assert(P % 4 == 0 && S <= R, "float4 taps, a block's steps");
  float4 w4;
#pragma unroll
  for (int qq = 0; qq < S; ++qq) {
#pragma unroll
    for (int p = 0; p < M; ++p) {
      const int m = M * qq + p;
      if (m % 4 == 0) w4 = *reinterpret_cast<const float4*>(wq + m);
      const float wk = m % 4 == 0   ? w4.x
                       : m % 4 == 1 ? w4.y
                       : m % 4 == 2 ? w4.z
                                    : w4.w;
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] += wk * v[p][(r + qq) % R];
      if (!kLast || qq + 1 < S) v[p][qq] = xq[any_word<P>(M * (R + qq) + p)];
    }
  }
}

// the last S steps, then the extra step of the phases p < px, its R
// samples a phase loaded and used once
template <int M, int R, int S>
__device__ __forceinline__ void mid_any_tail(const float* __restrict__ xq,
                                             const float* __restrict__ wq,
                                             int px, float (&v)[M][R],
                                             float (&acc)[R]) {
  constexpr int P = M * R;
  mid_any_steps<M, R, S, true>(xq, wq, v, acc);
#pragma unroll
  for (int p = 0; p < M - 1; ++p) {
    if (p < px) {
      const float wk = wq[M * S + p];
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] += wk * xq[any_word<P>(M * (S + r) + p)];
    }
  }
}

// R neighbouring outputs of a decimate-by-M FIR of nn taps (nn >= M,
// known at run time) over the window staged at any_word<M R>, from the
// thread's first sample xl[0] (its run's window starts there):
//   acc[r] = sum_{k < nn} w[k] * x[M r + k], k ascending, from 0.0f
template <int M, int R>
__device__ __forceinline__ void mid_fir_any(const float* __restrict__ xl,
                                            const float* __restrict__ w,
                                            int nn, float (&acc)[R]) {
  constexpr int P = M * R;
  static_assert(R <= 8, "the switch's cases");
  const int nq = nn / M, px = nn % M;  // nq >= 1
  const int q1 = (nq - 1) / R * R;     // steps of the whole blocks
  float v[M][R];
#pragma unroll
  for (int p = 0; p < M; ++p)
#pragma unroll
    for (int r = 0; r < R; ++r) v[p][r] = xl[any_word<P>(M * r + p)];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll 1
  for (int qb = 0; qb < q1; qb += R)
    mid_any_steps<M, R, R, false>(xl + (P + 1) * (qb / R), w + M * qb, v,
                                  acc);
  const float* xq = xl + (P + 1) * (q1 / R);
  const float* wq = w + M * q1;
  switch (nq - q1) {
#define FMT_MID_TAIL(S)                                                \
  case S:                                                              \
    if constexpr (S <= R) mid_any_tail<M, R, S>(xq, wq, px, v, acc);   \
    break;
    FMT_MID_TAIL(1)
    FMT_MID_TAIL(2)
    FMT_MID_TAIL(3)
    FMT_MID_TAIL(4)
    FMT_MID_TAIL(5)
    FMT_MID_TAIL(6)
    FMT_MID_TAIL(7)
    FMT_MID_TAIL(8)
#undef FMT_MID_TAIL
  }
}

// k12_mid_ds2_kernel's staging (mid_stage_fmd) with the ds x2 tail's
// length h2 = nn2 - 2 at run time (both the carried tail2 [C, h2] and the
// new one, into tails [C, h2]) and the window at any_word<P>; NLOAD loads
// a thread cover the longest window.  Ends with the CTA's barrier.
template <bool kFromTheta, class In, int NLOAD, int kThr, int P>
__device__ __forceinline__ void mid_stage_any(
    const In* __restrict__ x, const float* __restrict__ prev_theta,
    float scale, const float* __restrict__ tail2, int h2, int n4, int c,
    int j0, int nu, bool last, float* __restrict__ tails, float* s_u,
    float* s_t) {
  constexpr int OFF = kFromTheta ? 1 : 0;  // the discriminator's previous
  const int64_t nt2 = (int64_t)gridDim.y * h2;
  In raw[NLOAD];
#pragma unroll
  for (int k = 0; k < NLOAD; ++k) {
    const int b = threadIdx.x + k * kThr;  // source j0 - OFF + b
    const int j = j0 - OFF + b;
    raw[k] = b < nu + OFF && j >= 0 ? FMT_AT(x, j, n4) : In(0);
  }
  if constexpr (kFromTheta) {
#pragma unroll
    for (int k = 0; k < NLOAD; ++k) {
      const int b = threadIdx.x + k * kThr;
      if (b < nu + 1) s_t[b] = raw[k];
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < NLOAD; ++k) {
    const int b = threadIdx.x + k * kThr;
    if (b >= nu) continue;
    const int j = j0 + b;  // >= -h2
    float v;
    if (j >= 0) {
      if constexpr (kFromTheta) {
        const float prev =
            j == 0 ? FMT_AT(prev_theta, c, gridDim.y) : s_t[b];
        v = disc_value(s_t[b + 1], prev, scale);
      } else {
        v = mid_src(raw[k]);
      }
      if (last && j >= n4 - h2)
        FMT_AT(tails, (int64_t)c * h2 + j - (n4 - h2), nt2) = v;
    } else {
      v = FMT_AT(tail2, (int64_t)c * h2 + h2 + j, nt2);
    }
    s_u[any_word<P>(b)] = v;
  }
  __syncthreads();
}

// k12_mid_ds2_kernel at any order 2 <= nn2 <= kMaxNn2 (its arguments, and
// nn2): the staging (mid_stage_any) and ds x2 (mid_fir_any<2, kDs2Outs>,
// each thread's run of kDs2Outs outputs) of one channel's tile, stored as
// two float4 a run.  The same register budget as the receiver's kernel
// (kDs2MinBlocks CTAs an SM); shared memory for the longest window.
template <bool kFromTheta, class In>
__global__ void __launch_bounds__(kDs2Threads, kDs2MinBlocks)
k12_mid_ds2_any_kernel(const In* __restrict__ src,
                       const float* __restrict__ prev_theta, float scale,
                       const float* __restrict__ w2_rev, int nn2,
                       const float* __restrict__ tail2, int n4,
                       float* __restrict__ fm_out,
                       float* __restrict__ tails) {
  static_assert(!kFromTheta || sizeof(In) == sizeof(float),
                "theta1 is float32");
  static_assert(kDs2Outs == 8, "two float4 stores a run");
  constexpr int P = 2 * kDs2Outs;  // samples between neighbouring runs
  constexpr int NU = 2 * kMidTile + kMidHalo;  // the longest window
  constexpr int OFF = kFromTheta ? 1 : 0;
  constexpr int NLOAD = (NU + OFF + kDs2Threads - 1) / kDs2Threads;
  __shared__ __align__(16) float s_u[any_word<P>(NU) + 1];
  __shared__ float s_t[kFromTheta ? NU + 1 : 1];
  __shared__ __align__(16) float s_w2[kAnyTaps];
  const int h2 = nn2 - 2;
  const int n8 = n4 / 2;
  const int c = blockIdx.y;
  const int i0 = blockIdx.x * kMidTile;
  const int nt = min(kMidTile, n8 - i0);  // outputs of this tile
  for (int k = threadIdx.x; k < nn2; k += kDs2Threads)
    s_w2[k] = FMT_AT(w2_rev, k, nn2);
  mid_stage_any<kFromTheta, In, NLOAD, kDs2Threads, P>(
      src + (int64_t)c * n4, prev_theta, scale, tail2, h2, n4, c,
      2 * i0 - h2, 2 * nt + h2, i0 + nt == n8, tails, s_u, s_t);
  const int a0 = threadIdx.x * kDs2Outs;
  if (a0 >= nt) return;
  float acc[kDs2Outs];
  mid_fir_any<2, kDs2Outs>(s_u + (P + 1) * threadIdx.x, s_w2, nn2, acc);
  const int64_t total = (int64_t)gridDim.y * n8;
  float4* d = reinterpret_cast<float4*>(
      FMT_SPAN(fm_out, (int64_t)c * n8 + i0 + a0, kDs2Outs, total));
  d[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  d[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

// k12_mid_hilb_kernel at any order 1 <= nh <= kMaxNh (its arguments, and
// nh): the tile's fm_out window (the carried Hilbert tail before the
// block) staged at any_word<P>, then Hilbert (mid_fir_any<1, kHilbOuts>)
// and mid_hilb's stores: im, and re = the window from position
// (nh - 1) / 2 (ops/fir.py::hilbert_fir_p's re; at odd nh fm_out delayed
// by (nh - 1) / 2).
template <bool kOut16>
__global__ void __launch_bounds__(kMidThreads, kHilbMinBlocks)
k12_mid_hilb_any_kernel(const float* __restrict__ fm_out,
                        const float* __restrict__ wh_rev, int nh,
                        const float* __restrict__ htail, int n8,
                        float* __restrict__ re, float* __restrict__ im,
                        int16_t* __restrict__ re16,
                        int16_t* __restrict__ im16) {
  static_assert(kHilbOuts == 4, "one float4 store a plane");
  constexpr int P = kHilbOuts;  // samples between neighbouring runs
  constexpr int NF = kMidTile + kMidHalo;  // the longest window
  constexpr int NLOAD = (NF + kMidThreads - 1) / kMidThreads;
  __shared__ __align__(16) float s_f[any_word<P>(NF) + 1];
  __shared__ __align__(16) float s_wh[kAnyTaps];
  const int hh = nh - 1;
  const int c = blockIdx.y;
  const int i0 = blockIdx.x * kMidTile;
  const int nt = min(kMidTile, n8 - i0);  // outputs of this tile
  const int nf = nt + hh;                 // fm_out values it needs
  for (int k = threadIdx.x; k < nh; k += kMidThreads)
    s_wh[k] = FMT_AT(wh_rev, k, nh);
  const float* x = fm_out + (int64_t)c * n8;
  float raw[NLOAD];
#pragma unroll
  for (int k = 0; k < NLOAD; ++k) {
    const int a = threadIdx.x + k * kMidThreads;  // fm_out i0 - hh + a
    const int i = i0 - hh + a;
    raw[k] = a >= nf ? 0.0f
             : i >= 0
                 ? FMT_AT(x, i, n8)
                 : FMT_AT(htail, (int64_t)c * hh + hh + i,
                          (int64_t)gridDim.y * hh);
  }
#pragma unroll
  for (int k = 0; k < NLOAD; ++k) {
    const int a = threadIdx.x + k * kMidThreads;
    if (a < nf) s_f[any_word<P>(a)] = raw[k];
  }
  __syncthreads();
  const int a0 = threadIdx.x * kHilbOuts;
  if (a0 >= nt) return;
  float acc[kHilbOuts], d[kHilbOuts];
  mid_fir_any<1, kHilbOuts>(s_f + (P + 1) * threadIdx.x, s_wh, nh, acc);
  const int dl = hh / 2;  // re[i0 + a] = window position a + dl
#pragma unroll
  for (int r = 0; r < kHilbOuts; ++r) d[r] = s_f[any_word<P>(a0 + r + dl)];
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

// The end of every route: the peak IIR's recurrence on re, im [C, n8] ->
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

// ds x2 on the split route's tiled kernel (k12_mid_ds2_kernel at the
// receiver's kTiledNn2 taps, k12_mid_ds2_any_kernel at any other nn2 up
// to kMaxNn2): src [C, n4] (theta1 with kFromTheta, prev_theta [C] and
// the discriminator's scale; else fm_demod, float32 or int16) -> fm_out
// [C, n4/2] (16-byte aligned) and the new ds x2 tail into tails
// [C, nn2 - 2] (null only where it is empty); w2_rev [nn2], tail2
// [C, nn2 - 2].  n4 % 16 == 0 and n4 >= nn2 - 2, else refused.
template <bool kFromTheta, class In>
inline int launch_mid_ds2(const In* src, const float* prev_theta,
                          float scale, const float* w2_rev, int nn2,
                          const float* tail2, int channels, int n4,
                          float* fm_out, float* tails, cudaStream_t stream) {
  if (n4 % 16 != 0 || nn2 < 2 || nn2 > kMaxNn2 || n4 < nn2 - 2 ||
      fm_out == nullptr || (tails == nullptr && nn2 > 2) ||
      (uintptr_t)fm_out % 16 != 0 || (kFromTheta && prev_theta == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int n8 = n4 / 2;
  const dim3 grid((unsigned)((n8 + kMidTile - 1) / kMidTile),
                  (unsigned)channels);
  if (nn2 == kTiledNn2) {
    k12_mid_ds2_kernel<kFromTheta, In, kTiledNn2>
        <<<grid, kDs2Threads, 0, stream>>>(src, prev_theta, scale, w2_rev,
                                           tail2, n4, fm_out, tails);
  } else {
    k12_mid_ds2_any_kernel<kFromTheta, In>
        <<<grid, kDs2Threads, 0, stream>>>(src, prev_theta, scale, w2_rev,
                                           nn2, tail2, n4, fm_out, tails);
  }
  FMT_CHECK_LAUNCH();
  return 0;
}

// Hilbert on the split route's tiled kernel (k12_mid_hilb_kernel at the
// receiver's kTiledNh taps, k12_mid_hilb_any_kernel at any other nh up to
// kMaxNh): fm_out [C, n8] -> re, im [C, n8] float32 and, given re16 and
// im16, int16 at kIqScale (all 16-byte aligned); wh_rev [nh], htail
// [C, nh - 1].  n8 % 8 == 0 and n8 >= nh - 1, else refused.  NH: the
// order the tiled kernel is built for (a template, so that only the
// sources that launch it build its kernels).
template <int NH = kTiledNh>
inline int launch_mid_hilb(const float* fm_out, const float* wh_rev, int nh,
                           const float* htail, int channels, int n8,
                           float* re, float* im, int16_t* re16,
                           int16_t* im16, cudaStream_t stream) {
  const uintptr_t align = (uintptr_t)re | (uintptr_t)im |
                          (uintptr_t)re16 | (uintptr_t)im16;
  if (n8 % 8 != 0 || nh < 1 || nh > kMaxNh || n8 < nh - 1 ||
      (re16 == nullptr) != (im16 == nullptr) || align % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)((n8 + kMidTile - 1) / kMidTile),
                  (unsigned)channels);
  if (nh == NH && re16 != nullptr) {
    k12_mid_hilb_kernel<true, NH><<<grid, kMidThreads, 0, stream>>>(
        fm_out, wh_rev, htail, n8, re, im, re16, im16);
  } else if (nh == NH) {
    k12_mid_hilb_kernel<false, NH><<<grid, kMidThreads, 0, stream>>>(
        fm_out, wh_rev, htail, n8, re, im, nullptr, nullptr);
  } else if (re16 != nullptr) {
    k12_mid_hilb_any_kernel<true><<<grid, kMidThreads, 0, stream>>>(
        fm_out, wh_rev, nh, htail, n8, re, im, re16, im16);
  } else {
    k12_mid_hilb_any_kernel<false><<<grid, kMidThreads, 0, stream>>>(
        fm_out, wh_rev, nh, htail, n8, re, im, nullptr, nullptr);
  }
  FMT_CHECK_LAUNCH();
  return 0;
}

// The split route after fm_demod (K2: src = fmd, float32 or int16) or
// after ds x4 + atan2 (K12: src = theta1, kFromTheta): ds x2 into fm_out
// [C, n4/2] (scratch, whose last nh - 1 samples the host keeps as the
// Hilbert tail) and the new ds x2 tail into tails [C, nn2 - 2]; given
// use_deemph the de-emphasis in place over fm_out; Hilbert -> re, im (and,
// given re16, im16 and theta16, the int16 outputs); then
// launch_peak_theta.
template <bool kFromTheta, class In>
inline int launch_mid_split(const In* src, const float* prev_theta,
                            float scale, const float* w2_rev, int nn2,
                            const float* tail2, int use_deemph, float de_b0,
                            float de_b1, float de_a1, const float* de_st_in,
                            float* de_st_out, const float* wh_rev, int nh,
                            const float* htail, float pk_b0, float pk_b1,
                            float pk_b2, float pk_a1, float pk_a2,
                            const float* pk_st_in, float* pk_st_out,
                            int channels, int n4, float* fm_out, float* re,
                            float* im, float* theta, float* yi, float* tails,
                            float* power, int16_t* re16, int16_t* im16,
                            int16_t* theta16, cudaStream_t stream) {
  const int n8 = n4 / 2;
  int err = launch_mid_ds2<kFromTheta>(src, prev_theta, scale, w2_rev, nn2,
                                       tail2, channels, n4, fm_out, tails,
                                       stream);
  if (err) return err;
  if (use_deemph) {
    err = launch_deemph(fm_out, fm_out, n8, channels, de_b0, de_b1, de_a1,
                        de_st_in, de_st_out, stream);
    if (err) return err;
  }
  err = launch_mid_hilb(fm_out, wh_rev, nh, htail, channels, n8, re, im,
                        re16, im16, stream);
  if (err) return err;
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
// - split (launch_mid_split): fm_out [C, n4/2] as on the launches route,
//   the new ds x2 tail into tails [C, nn2 - 2] (null only where it is
//   empty), re, im, theta and the pilot power; yi scratch;
// - launches: ds x2 into fm_out [C, n4/2] (scratch, whose last samples
//   the host keeps as the Hilbert tail), the optional de-emphasis in
//   place, Hilbert -> re, im, then launch_peak_theta with the scratch yi
//   [C, n4/2]; tails unused;
// - refused: nothing launched.
// Given re16 (the int16 format's outputs re16, im16, theta16), every route
// writes them (re16, im16 at kIqScale, theta16 at kPhScale) and re, im and
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
  const int route = midend_route(nn2, nh, n4);
  if (route == kMidRefused ||
      (route == kMidSplit && tails == nullptr && nn2 > 2))
    return (int)cudaErrorInvalidValue;
  if (route == kMidSplit) {
    return launch_mid_split<false>(
        fmd, nullptr, 1.0f, w2_rev, nn2, tail2, use_deemph, de_b0, de_b1,
        de_a1, de_st_in, de_st_out, wh_rev, nh, htail, pk_b0, pk_b1, pk_b2,
        pk_a1, pk_a2, pk_st_in, pk_st_out, channels, n4, fm_out, re, im,
        theta, yi, tails, power, re16, im16, theta16, stream);
  }
  const int n8 = n4 / 2;
  const int64_t t8 = (int64_t)channels * n8;
  int err = fir_decimate(fmd, n4, tail2, w2_rev, nn2, 2, fm_out, channels,
                         stream, kFmScale);
  if (err) return err;
  if (use_deemph) {
    err = launch_deemph(fm_out, fm_out, n8, channels, de_b0, de_b1, de_a1,
                        de_st_in, de_st_out, stream);
    if (err) return err;
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
