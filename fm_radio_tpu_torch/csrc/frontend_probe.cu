// The K1 engine probe on Hopper: the float K1's time split into its parts.
//
// Replaces the four Pallas kernels of tools/frontend_probe.py (a TPU
// diagnostic, not a kernel of the receiver):
//   build (:138, _variant_kernel :52, pallas_call :210)
//     fp_sum (stream, unpack)  read each tile (and unpack it), one sum per
//                              row and tile (probe_sum.cuh)
//     fp_fir (dots, full)      + the ds x4 window sums (dots: fr + fi), +
//                              the polynomial atan2 and the in-tile
//                              difference wrapped to +-pi, x 0.123 (full),
//                              one launch: fp_fir_kernel (float taps),
//                              fp_fir_i8_kernel (int8 taps)
//   build_dbuf (:228, pallas_call :293)
//     fp_dbuf_kernel           one CTA walking its channels' time tiles,
//                              the window carried across them: each tile's
//                              raw words brought into shared memory by
//                              cp.async (nbuf 2: tile i + 1's copy in
//                              flight while tile i is unpacked and summed)
//   build_i8direct (:316, pallas_call :394)
//     fp_i8d (FpI8dStore)      int8 planes, int8 taps, on K12's staged ds x4
//                              tile (ds4_i8_blocked_kernel) with the tail
//                              carried (or `noasm`: each tile's first `no`
//                              outputs read the tile from its start,
//                              mis-filtered, as the TPU lens does); full's
//                              difference in the same launch, one launch
//                              a call
//   build_i8manual (:426, pallas_call :518)
//     fp_i8man_kernel          one CTA per channel block, the time loop
//                              inside: tiles in by cp.async.bulk on an
//                              mbarrier into a 2-slot ring, outputs out
//                              through a 2-slot ring by bulk stores; each
//                              tile summed 8 outputs a thread from a
//                              sliding window of 16-byte word reads
//
// fp_fir and fp_dbuf run the design of the float K1 the cells run
// (frontend.cu::k1_tile_kernel) on the probe's tiles and 132 taps.  A CTA
// stages each segment it sums (a row's tile of t_blk / 4 outputs, or
// kFpPass (fp_fir) / kFpGroup (fp_dbuf) outputs of a longer one) once in
// shared memory, as centred float32 re and im planes skewed by mid_skew,
// behind 132 samples of head: zeros before a build tile (the TPU kernel's
// never-written scratch), the carried samples in dbuf.  fp_fir issues all
// of a thread's vector loads before the first unpack waits (the forms'
// fetch / unpack); fp_dbuf unpacks its cp.async'd words, each once.  The
// sum is extract_stages.cuh::fir_block<4, 8, 132, 4>: 8 outputs a thread,
// one shared-memory load for eight products, in fir_dot's order (from
// 0.0f, k ascending, every product and sum rounded: -fmad=false), 33 steps
// a phase ending in a partial block of one; re and im on separate warps,
// the im sums handed over in shared memory, atan2 and the difference from
// theta in the same launch.  The int8 taps pack each staged sample into
// int8 words once (i8_byte) and sum them with k12_stages.cuh::
// ds4_i8_window, K12's sliding __dp4a window.  So every output is the
// plain version's float32 sum, bit for bit.  The probe has one order, the
// TPU tool's 132 taps (halo 128); the entries refuse any other.
//
// What the sections measure against k1_tile_kernel (64 taps, times in
// PERF.md): split reads the words (stream), unpacks them (unpack), stages
// and sums them (dots) and adds atan2 and the difference (full), in K1's
// design at 132 taps; engines, ingest, tm and sem the same kernel on the
// other forms, taps, tiles, layouts and grid orders; tiles and dbuf a
// persistent CTA over c_blk channels (fp_dbuf), with the next tile's copy in
// flight or not, against the one-CTA-a-segment-group launch (fp_fir,
// `direct`).
//
// What the TPU kernel leaves unwritten reads as zeros of the scratch's own
// type: build's float scratch head (every tile's first window reaches 128
// samples before the tile: 0.0, which the int8 taps see as int8(0 - 1));
// the carried tails and the other buffer at the first tile of a channel
// block (dbuf: the word of the sample (0, 0); i8direct: zero bytes).

#include "bulk_copy.cuh"
#include "extract_stages.cuh"
#include "frontend_stages.cuh"
#include "k12_stages.cuh"
#include "probe_sum.cuh"

namespace fmt {

constexpr int kFpHead = 128;     // the TPU tool's _TB: window reach before
                                 // a tile, and the carried tail's length
constexpr float kFpScale = 0.123f;
constexpr int kFpSmemMax = 232448;  // shared memory a CTA may use

// Sample n of a row as the centred float pair, for the forms the probe
// reads besides PackedWords (frontend_stages.cuh): int16 words w - 32768,
// and two separate int8 or float32 planes; fetch loads samples n .. n + 3
// as they lie in memory, unpack centres them (the staged tiles issue every
// fetch before the first unpack).  total: the elements of one plane, the
// bound the checked build holds every load to.
struct I16Words {
  const int16_t* x;
  int64_t total;
  using Raw = short4;
  __device__ __forceinline__ static void unpack1(int16_t w, float& r,
                                                 float& i) {
    PackedWords::unpack1((float)w + 32768.0f, r, i);
  }
  __device__ __forceinline__ Raw fetch(int64_t row, int n) const {
    return *reinterpret_cast<const short4*>(FMT_SPAN(x, row + n, 4, total));
  }
  __device__ __forceinline__ static void unpack(const Raw& w, float (&r)[4],
                                                float (&i)[4]) {
    unpack1(w.x, r[0], i[0]);
    unpack1(w.y, r[1], i[1]);
    unpack1(w.z, r[2], i[2]);
    unpack1(w.w, r[3], i[3]);
  }
};

struct F32Pair {
  const float* r;
  const float* q;
  int64_t total;
  struct Raw {
    float4 a, b;
  };
  __device__ __forceinline__ Raw fetch(int64_t row, int n) const {
    return {*reinterpret_cast<const float4*>(FMT_SPAN(r, row + n, 4, total)),
            *reinterpret_cast<const float4*>(FMT_SPAN(q, row + n, 4, total))};
  }
  __device__ __forceinline__ static void unpack(const Raw& w, float (&re)[4],
                                                float (&im)[4]) {
    PlanesF32::unpack({w.a, w.b}, re, im);
  }
};

struct I8Pair {
  const int8_t* r8;
  const int8_t* q8;
  int64_t total;
  struct Raw {
    char4 a, b;
  };
  __device__ __forceinline__ Raw fetch(int64_t row, int n) const {
    return {*reinterpret_cast<const char4*>(FMT_SPAN(r8, row + n, 4, total)),
            *reinterpret_cast<const char4*>(FMT_SPAN(q8, row + n, 4, total))};
  }
  __device__ __forceinline__ static void unpack(const Raw& w, float (&r)[4],
                                                float (&i)[4]) {
    I8Planes::unpack({w.a, w.b}, r, i);
  }
};

// ---- stream / unpack: the per-tile sums ---------------------------------

// Each Op of tile_sum_kernel: kVec elements a 16-byte vector, kPlanes
// vectors a fetch (one of each plane), base(r, ti, t_blk) the tile's first
// element, fetch(b, v) vector v of the tile, add(acc, raw) its elements in
// order, done(acc) the lane's value.

// packed words, float4 at a time: the word (stream) or re - im (unpack)
template <bool kUnpack, bool kTM>
struct WordsSum : KeepAll {
  static constexpr int kVec = 4, kPlanes = 1;
  using Raw = float4;
  using Acc = float;
  const float* x;
  int rows, n;
  __device__ __forceinline__ Acc zero() const { return 0.0f; }
  __device__ __forceinline__ int64_t base(int r, int ti, int t_blk) const {
    return tile_base(r, ti, rows, n, t_blk, kTM);
  }
  __device__ __forceinline__ Raw fetch(int64_t b, int v) const {
    return ld_once((const float4*)(x + b) + v);
  }
  __device__ __forceinline__ void add(Acc& acc, const Raw& v) const {
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if constexpr (kUnpack) {
        float re, im;
        PackedWords::unpack1(e[u], re, im);
        acc += re - im;
      } else {
        acc += e[u];
      }
    }
  }
  __device__ __forceinline__ float done(Acc acc) const { return acc; }
};

// int16 words, eight to 16 bytes: (float) w (stream) or re - im (unpack)
template <bool kUnpack, bool kTM>
struct I16Sum : KeepAll {
  static constexpr int kVec = 8, kPlanes = 1;
  using Raw = int4;
  using Acc = float;
  const int16_t* x;
  int rows, n;
  __device__ __forceinline__ Acc zero() const { return 0.0f; }
  __device__ __forceinline__ int64_t base(int r, int ti, int t_blk) const {
    return tile_base(r, ti, rows, n, t_blk, kTM);
  }
  __device__ __forceinline__ Raw fetch(int64_t b, int v) const {
    return ld_once((const int4*)(x + b) + v);
  }
  __device__ __forceinline__ void add(Acc& acc, const Raw& raw) const {
    const int4 v = raw;
    const int16_t* e = (const int16_t*)&v;
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      if constexpr (kUnpack) {
        float re, im;
        I16Words::unpack1(e[u], re, im);
        acc += re - im;
      } else {
        acc += (float)e[u];
      }
    }
  }
  __device__ __forceinline__ float done(Acc acc) const { return acc; }
};

// the sums of two planes, added at the end (stream), or one sum (unpack)
struct PairAcc {
  float r, q;
};

// two int8 planes, sixteen to 16 bytes: the sum of each plane, added at
// the end (stream), or (r + 1) - (q + 1) (unpack)
template <bool kUnpack, bool kTM>
struct U8Sum : KeepAll {
  static constexpr int kVec = 16, kPlanes = 2;
  struct Raw {
    int4 r, q;
  };
  using Acc = PairAcc;
  const int8_t* xr;
  const int8_t* xq;
  int rows, n;
  __device__ __forceinline__ Acc zero() const { return {0.0f, 0.0f}; }
  __device__ __forceinline__ int64_t base(int r, int ti, int t_blk) const {
    return tile_base(r, ti, rows, n, t_blk, kTM);
  }
  __device__ __forceinline__ Raw fetch(int64_t b, int v) const {
    return {ld_once((const int4*)(xr + b) + v),
            ld_once((const int4*)(xq + b) + v)};
  }
  __device__ __forceinline__ void add(Acc& acc, const Raw& raw) const {
    const int4 vr = raw.r, vq = raw.q;
    const int8_t* er = (const int8_t*)&vr;
    const int8_t* eq = (const int8_t*)&vq;
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      if constexpr (kUnpack) {
        acc.r += ((float)er[u] + 1.0f) - ((float)eq[u] + 1.0f);
      } else {
        acc.r += (float)er[u];
        acc.q += (float)eq[u];
      }
    }
  }
  __device__ __forceinline__ float done(Acc acc) const {
    return kUnpack ? acc.r : acc.r + acc.q;
  }
};

// two float32 planes, float4 at a time: the sum of each plane, added at
// the end (stream), or re - im (unpack)
template <bool kUnpack, bool kTM>
struct F32PairSum : KeepAll {
  static constexpr int kVec = 4, kPlanes = 2;
  struct Raw {
    float4 r, q;
  };
  using Acc = PairAcc;
  const float* xr;
  const float* xq;
  int rows, n;
  __device__ __forceinline__ Acc zero() const { return {0.0f, 0.0f}; }
  __device__ __forceinline__ int64_t base(int r, int ti, int t_blk) const {
    return tile_base(r, ti, rows, n, t_blk, kTM);
  }
  __device__ __forceinline__ Raw fetch(int64_t b, int v) const {
    return {ld_once((const float4*)(xr + b) + v),
            ld_once((const float4*)(xq + b) + v)};
  }
  __device__ __forceinline__ void add(Acc& acc, const Raw& v) const {
    const float er[4] = {v.r.x, v.r.y, v.r.z, v.r.w};
    const float eq[4] = {v.q.x, v.q.y, v.q.z, v.q.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if constexpr (kUnpack) {
        acc.r += er[u] - eq[u];
      } else {
        acc.r += er[u];
        acc.q += eq[u];
      }
    }
  }
  __device__ __forceinline__ float done(Acc acc) const {
    return kUnpack ? acc.r : acc.r + acc.q;
  }
};

// ---- dots / full and dbuf: the staged, register-blocked FIR -------------

constexpr int kFpRun = 8;       // outputs a thread (fir_block's R)
constexpr int kFpTaps = 132;    // the probe's order (its only one)
static_assert(kFpTaps % 4 == 0, "whole ds x4 steps");
constexpr int kFpPass = 1024;   // fp_fir: outputs a CTA and plane (K1's tile)
constexpr int kFpGroup = 2048;  // fp_dbuf: outputs a group and plane
constexpr int kFpMaxSegs = kFpGroup / 128;  // segments a group (t_blk >= 512)

// A segment: ns = min(no, cap) outputs j0 .. j0 + ns - 1 of one row's tile
// of no = t_blk / 4 (the whole tile, or a part of a longer one).  Its float
// plane holds samples 4 j0 - kFpTaps + e of the tile (e < kFpTaps + 4 ns),
// skewed, so output j0 + u sums e = 4 u + 4 + k (k < kFpTaps: fir_block's
// B0 = 4) and the output before the segment e = k.  The planes of a group
// lie fp_stride floats apart: the skewed plane rounded up to 32, plus
// ns / 8 mod 32, so that the lanes of a warp over two or more segments
// (fewer than 32 runs a segment) load from distinct banks.
__host__ __device__ constexpr int fp_seg_outs(int no, int cap) {
  return no < cap ? no : cap;
}
__host__ __device__ constexpr int fp_stride(int ns) {
  return (mid_skew(kFpTaps + 4 * ns - 1) + 1 + 31) / 32 * 32 +
         (ns / kFpRun) % 32;
}

// The float shared memory of a group of p segments: the re and im planes,
// the taps, the im sums handed to the re threads ([kFpRun][p ns / 8]), each
// run's last theta and each segment's theta before its first output.
__host__ __device__ constexpr int64_t fp_group_floats(int ns, int p) {
  return 2 * (int64_t)p * fp_stride(ns) + kFpTaps + (int64_t)p * ns +
         (int64_t)p * ns / kFpRun + kFpMaxSegs;
}

struct FpGroup {
  int ns, p, stride;
  float *re, *im, *w, *fi, *last, *extra;
  __device__ FpGroup(float* base, int ns_, int p_)
      : ns(ns_), p(p_), stride(fp_stride(ns_)) {
    re = base;
    im = re + (int64_t)p * stride;
    w = im + (int64_t)p * stride;
    fi = w + kFpTaps;
    last = fi + (int64_t)p * ns;
    extra = last + (int64_t)p * ns / kFpRun;
  }
  __device__ __forceinline__ void put(int s, int e, float r, float i) const {
    re[s * stride + mid_skew(e)] = r;
    im[s * stride + mid_skew(e)] = i;
  }
};

// Thread t of a float group's p ns / 4: plane t / h (0 re, 1 im; h = p ns /
// 8 runs a plane), run t % h of it: segment s, its run q (outputs j0 + 8 q
// + r)
struct FpRun {
  int plane, run, s, q;
  __device__ FpRun(int t, int ns, int p) {
    const int rps = ns / kFpRun, h = p * rps;
    plane = t / h;
    run = t % h;
    s = run / rps;
    q = run % rps;
  }
};

// full: a run's thetas v into the in-tile difference, prev the theta before
// the run (the run's own first at a tile's first output: 0 there)
__device__ __forceinline__ void fp_disc(float (&v)[kFpRun], float prev) {
#pragma unroll
  for (int r = 0; r < kFpRun; ++r) {
    const float t = v[r];
    v[r] = disc_value(t, prev, kFpScale);
    prev = t;
  }
}

__device__ __forceinline__ void fp_store(float* __restrict__ out, int64_t o,
                                         int64_t total,
                                         const float (&v)[kFpRun]) {
  float4* d = reinterpret_cast<float4*>(FMT_SPAN(out, o, kFpRun, total));
  d[0] = make_float4(v[0], v[1], v[2], v[3]);
  d[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The sums of a staged float group and what dots / full make of them, for
// thread run r; valid: its segment holds outputs, the first at out[o] and
// j0 of its tile.  Every thread of the group calls it (it syncs the CTA).
template <bool kFull>
__device__ __forceinline__ void fp_group_sum(const FpGroup& g, const FpRun& r,
                                             bool valid, int64_t o, int j0,
                                             float* __restrict__ out,
                                             int64_t total) {
  const int h = g.p * (g.ns / kFpRun);
  const float* sp = (r.plane == 0 ? g.re : g.im) + r.s * g.stride;
  float acc[kFpRun];
  if (valid) {
    fir_block<4, kFpRun, kFpTaps, 4>(sp + 33 * r.q, 0, g.w, acc);
    if (r.plane == 1) {
#pragma unroll
      for (int u = 0; u < kFpRun; ++u) g.fi[u * h + r.run] = acc[u];
    }
    if (kFull && r.plane == 0 && r.q == 0 && j0 > 0) {  // output j0 - 1
      const float* si = g.im + r.s * g.stride;
      float a = 0.0f, b = 0.0f;
      for (int k = 0; k < kFpTaps; ++k) {
        a += g.w[k] * sp[mid_skew(k)];
        b += g.w[k] * si[mid_skew(k)];
      }
      g.extra[r.s] = atan2_poly(b, a);
    }
  }
  __syncthreads();
  const bool mine = valid && r.plane == 0;
  float v[kFpRun];
  if (mine) {
#pragma unroll
    for (int u = 0; u < kFpRun; ++u) {
      const float fi = g.fi[u * h + r.run];
      v[u] = kFull ? atan2_poly(fi, acc[u]) : acc[u] + fi;
    }
    if (kFull) g.last[r.run] = v[kFpRun - 1];
  }
  if constexpr (kFull) {
    __syncthreads();
    if (mine)
      fp_disc(v, r.q > 0 ? g.last[r.run - 1] : j0 > 0 ? g.extra[r.s] : v[0]);
  }
  if (mine) fp_store(out, o, total, v);
}

// fp_fir's CTAs: segments of ns = min(no, kFpPass) outputs, p of them a
// CTA (at most kFpPass outputs a plane: K1's tile), `passes` CTAs a (c_blk
// x t_blk) tile, the tiles in `raster` order
struct FpFirGeom {
  int ns, p, passes;
};
inline FpFirGeom fp_fir_geom(int c_blk, int t_blk) {
  const int no = t_blk / 4, ns = fp_seg_outs(no, kFpPass);
  const int segs = c_blk * (no / ns), cap = kFpPass / ns;
  const int p = segs < cap ? segs : cap;
  return {ns, p, (segs + p - 1) / p};
}

// The segment z of tile (ci, ti): row ci c_blk + z / sigma, outputs from
// j0 = (z % sigma) ns; valid while z / sigma < c_blk
struct FpSeg {
  int row, j0;
  bool valid;
  __device__ FpSeg(int z, int ci, int c_blk, int sigma, int ns)
      : row(ci * c_blk + z / sigma), j0((z % sigma) * ns),
        valid(z / sigma < c_blk) {}
};

constexpr int kFpStage = 6;  // loads a thread in flight while staging

// build's dots / full with float taps.  CTA blockIdx.x: pass blockIdx.x %
// passes of tile blockIdx.x / passes; it stages its p segments (samples
// before the tile 0.0), then sums them.
template <class Load, bool kTM, bool kFull>
__global__ void __launch_bounds__(2 * kFpPass / kFpRun)
fp_fir_kernel(Load in, int channels, int b, const float* __restrict__ w_rev,
              int c_blk, int t_blk, int n_ct, int n_tt, int raster, int p,
              int passes, float* __restrict__ out) {
  extern __shared__ __align__(16) float fp_sm[];
  const int no = t_blk / 4, ns = fp_seg_outs(no, kFpPass), sigma = no / ns;
  const FpGroup g(fp_sm, ns, p);
  int ci, ti;
  tile_of(blockIdx.x / passes, n_ct, n_tt, raster, ci, ti);
  const int z0 = (blockIdx.x % passes) * p;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int k = tid; k < kFpTaps; k += nt) g.w[k] = FMT_AT(w_rev, k, kFpTaps);
  // group gi of segment s: tile samples m = 4 (j0 - kFpTaps / 4 + gi) .. + 3
  const int ng = kFpTaps / 4 + ns;
  for (int a0 = 0; a0 < p * ng; a0 += kFpStage * nt) {
    typename Load::Raw raw[kFpStage];
    bool got[kFpStage];
#pragma unroll
    for (int k = 0; k < kFpStage; ++k) {
      const int a = a0 + tid + k * nt, s = a / ng, gi = a % ng;
      const FpSeg sg(z0 + s, ci, c_blk, sigma, ns);
      const int m = 4 * (sg.j0 - kFpTaps / 4 + gi);
      got[k] = a < p * ng && sg.valid && m >= 0;
      if (got[k])
        raw[k] = in.fetch(tile_base(sg.row, ti, channels, b, t_blk, kTM), m);
    }
#pragma unroll
    for (int k = 0; k < kFpStage; ++k) {
      const int a = a0 + tid + k * nt;
      if (a < p * ng) {
        float r[4] = {0.0f, 0.0f, 0.0f, 0.0f}, i[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (got[k]) Load::unpack(raw[k], r, i);
#pragma unroll
        for (int u = 0; u < 4; ++u) g.put(a / ng, 4 * (a % ng) + u, r[u], i[u]);
      }
    }
  }
  __syncthreads();
  const FpRun r(tid, ns, p);
  const FpSeg sg(z0 + r.s, ci, c_blk, sigma, ns);
  const int64_t o = (int64_t)sg.row * (b / 4) + (int64_t)ti * no + sg.j0 +
                    kFpRun * r.q;
  fp_group_sum<kFull>(g, r, sg.valid, o, sg.j0, out,
                      (int64_t)channels * (b / 4));
}

// The int8 taps' word planes (fp_fir_i8_kernel): tile word q = j0 - h + e of
// a segment at e < h + ns + 1 (h = ds4_halo_words of the padded window),
// fp_wstride ints apart (the skewed plane rounded up to 32, plus 4 below 32
// runs a segment: distinct banks for the lanes of two segments)
__host__ __device__ constexpr int fp_wstride(int h, int ns) {
  return (mid_skew(h + ns) + 1 + 31) / 32 * 32 + (ns / kFpRun < 32 ? 4 : 0);
}
constexpr int kFpTapWords = ds4_pad_words(kFpTaps / 4, kFpRun);
__host__ __device__ constexpr int64_t fp_i8_bytes(int ns, int p) {
  return 4 * (2 * (int64_t)p * fp_wstride(ds4_halo_words(kFpTapWords), ns) +
              2 * kFpTapWords + (int64_t)p * ns / kFpRun + kFpMaxSegs);
}

// build's dots / full with int8 taps: thread t sums run t % (ns / 8) of
// segment t / (ns / 8), both planes, from its p segments' staged words
// (each sample packed into int8 once, i8_byte; before the tile 0.0, the
// byte 0xff), with ds4_i8_window against the padded taps; combined as y1 +
// y2 / 128 + s_row, as ds4_i8_theta.
template <class Load, bool kTM, bool kFull>
__global__ void __launch_bounds__(kFpPass / kFpRun)
fp_fir_i8_kernel(Load in, int channels, int b, const int* __restrict__ b1w,
                 const int* __restrict__ b2w, float s_row, int c_blk,
                 int t_blk, int n_ct, int n_tt, int raster, int p, int passes,
                 float* __restrict__ out) {
  extern __shared__ __align__(16) int fp_smi[];
  const int no = t_blk / 4, ns = fp_seg_outs(no, kFpPass), sigma = no / ns;
  const int rps = ns / kFpRun, nw = kFpTaps / 4, nwp = kFpTapWords;
  const int h = ds4_halo_words(nwp), stride = fp_wstride(h, ns);
  int* s_re = fp_smi;
  int* s_im = s_re + p * stride;
  int2* s_tap = reinterpret_cast<int2*>(s_im + p * stride);
  float* s_last = reinterpret_cast<float*>(s_tap + nwp);
  float* s_extra = s_last + p * rps;
  int ci, ti;
  tile_of(blockIdx.x / passes, n_ct, n_tt, raster, ci, ti);
  const int z0 = (blockIdx.x % passes) * p;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int pad = nwp - nw;
  for (int w = tid; w < nwp; w += nt)
    s_tap[w] = w < pad ? make_int2(0, 0)
                       : make_int2(FMT_AT(b1w, w - pad, nw),
                                   FMT_AT(b2w, w - pad, nw));
  const int n_e = h + ns + 1;
  for (int a0 = 0; a0 < p * n_e; a0 += kFpStage * nt) {
    typename Load::Raw raw[kFpStage];
    bool got[kFpStage];
#pragma unroll
    for (int k = 0; k < kFpStage; ++k) {
      const int a = a0 + tid + k * nt;
      const FpSeg sg(z0 + a / n_e, ci, c_blk, sigma, ns);
      const int q = sg.j0 - h + a % n_e;
      got[k] = a < p * n_e && sg.valid && q >= 0 && q < no;
      if (got[k])
        raw[k] = in.fetch(tile_base(sg.row, ti, channels, b, t_blk, kTM),
                          4 * q);
    }
#pragma unroll
    for (int k = 0; k < kFpStage; ++k) {
      const int a = a0 + tid + k * nt;
      if (a < p * n_e) {
        const int s = a / n_e, e = a % n_e;
        // before the tile 0.0 (the byte 0xff); past it never summed
        int wr = FpSeg(z0 + s, ci, c_blk, sigma, ns).j0 - h + e < 0 ? -1 : 0;
        int wi = wr;
        if (got[k]) {
          float r[4], i[4];
          Load::unpack(raw[k], r, i);
          unsigned int pr = 0u, pi = 0u;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            pr |= i8_byte(r[u], u);
            pi |= i8_byte(i[u], u);
          }
          wr = (int)pr;
          wi = (int)pi;
        }
        s_re[s * stride + mid_skew(e)] = wr;
        s_im[s * stride + mid_skew(e)] = wi;
      }
    }
  }
  __syncthreads();
  const int s = tid / rps, q = tid % rps;
  const FpSeg sg(z0 + s, ci, c_blk, sigma, ns);
  const int* sr = s_re + s * stride;
  const int* si = s_im + s * stride;
  float v[kFpRun];
  if (sg.valid) {
    int y1r[kFpRun], y2r[kFpRun], y1i[kFpRun], y2i[kFpRun];
    ds4_i8_window<kFpRun>(sr, si, s_tap, h - nwp + 1 + kFpRun * q, nwp, y1r,
                          y2r, y1i, y2i);
#pragma unroll
    for (int u = 0; u < kFpRun; ++u) {
      if (kFull) {
        v[u] = ds4_i8_theta(y1r[u], y2r[u], y1i[u], y2i[u], s_row);
      } else {
        const float fr = ((float)y1r[u] + (float)y2r[u] * (1.0f / 128.0f)) +
                         s_row;
        const float fi = ((float)y1i[u] + (float)y2i[u] * (1.0f / 128.0f)) +
                         s_row;
        v[u] = fr + fi;
      }
    }
    if (kFull && q == 0 && sg.j0 > 0) {  // output j0 - 1
      int a1r = 0, a2r = 0, a1i = 0, a2i = 0;
      for (int w = 0; w < nwp; ++w) {
        const int2 tp = s_tap[w];
        const int e = mid_skew(h - nwp + w);
        a1r = __dp4a(sr[e], tp.x, a1r);
        a2r = __dp4a(sr[e], tp.y, a2r);
        a1i = __dp4a(si[e], tp.x, a1i);
        a2i = __dp4a(si[e], tp.y, a2i);
      }
      s_extra[s] = ds4_i8_theta(a1r, a2r, a1i, a2i, s_row);
    }
    if (kFull) s_last[tid] = v[kFpRun - 1];
  }
  if constexpr (kFull) {
    __syncthreads();
    if (sg.valid)
      fp_disc(v, q > 0 ? s_last[tid - 1] : sg.j0 > 0 ? s_extra[s] : v[0]);
  }
  if (sg.valid)
    fp_store(out,
             (int64_t)sg.row * (b / 4) + (int64_t)ti * no + sg.j0 + kFpRun * q,
             (int64_t)channels * (b / 4), v);
}

// ---- dbuf: a persistent CTA, the window carried across its tiles -------

// fp_dbuf's shared memory: the raw ring [nbuf][c_blk][t_blk] words, the
// carried heads [c_blk][2][kFpHead] in plane form, then the float group of
// p segments (of ns = min(no, kFpGroup) outputs: p ns / 4 threads).  p is
// the most segments up to kFpGroup outputs a plane that fit.  The one
// formula: fmt_fp_dbuf_layout exports it to the wrapper; the CPU models'
// copy is probes/frontend_probe.py::dbuf_layout.
struct FpDbufLayout {
  int ns, p, threads;
  int64_t bytes;
};
__host__ __device__ inline FpDbufLayout fp_dbuf_layout(int c_blk, int t_blk,
                                                       int nbuf) {
  const int no = t_blk / 4, ns = fp_seg_outs(no, kFpGroup);
  const int64_t own =
      (int64_t)nbuf * c_blk * t_blk + 2 * (int64_t)kFpHead * c_blk;
  int p = c_blk * (no / ns);
  if (p > kFpGroup / ns) p = kFpGroup / ns;
  while (p > 1 && 4 * (own + fp_group_floats(ns, p)) > kFpSmemMax) p /= 2;
  return {ns, p, p * ns / 4, 4 * (own + fp_group_floats(ns, p))};
}

// One CTA per c_blk channels walks the time tiles.  Tile i's words arrive
// in raw by cp.async, 16 bytes a thread (nbuf 1: issued, waited for, then
// used; nbuf 2: tile i + 1's copy issued into the other buffer once tile i
// has arrived, in flight while tile i is unpacked and summed).  Then, a
// group of p segments at a time: each segment's samples unpacked once into
// the skewed planes, behind the carried head (the previous tile's last
// kFpHead samples; 0.0, the word of (0, 0), before a row's first tile);
// the row's last segment hands its own last kFpHead samples on; the group
// summed (fp_group_sum).  full's difference restarts at each tile.
template <bool kFull>
__global__ void __launch_bounds__(2 * kFpGroup / kFpRun)
fp_dbuf_kernel(const float* __restrict__ x, int channels, int b,
               const float* __restrict__ w_rev, int c_blk, int t_blk, int nbuf,
               int p, float* __restrict__ out) {
  extern __shared__ __align__(16) float fp_sm[];
  const int no = t_blk / 4, ns = fp_seg_outs(no, kFpGroup), sigma = no / ns;
  float* raw[2] = {fp_sm, fp_sm + (nbuf == 2 ? (int64_t)c_blk * t_blk : 0)};
  float* carry = fp_sm + (int64_t)nbuf * c_blk * t_blk;
  const FpGroup g(carry + 2 * kFpHead * c_blk, ns, p);
  const int c0 = blockIdx.x * c_blk, n_tt = b / t_blk;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t total = (int64_t)channels * b;
  const int chunks = c_blk * (t_blk / 4);  // 16-byte chunks of a tile

  auto issue = [&](float* buf, int tile) {
    for (int e = tid; e < chunks; e += nt) {
      const int r = e / (t_blk / 4), q = e % (t_blk / 4);
      cp_async16(buf + r * t_blk + 4 * q,
                 FMT_SPAN(x, (int64_t)(c0 + r) * b + (int64_t)tile * t_blk +
                                 4 * q,
                          4, total));
    }
    cp_async_commit();
  };

  for (int k = tid; k < kFpTaps; k += nt) g.w[k] = FMT_AT(w_rev, k, kFpTaps);
  for (int e = tid; e < 2 * kFpHead * c_blk; e += nt) carry[e] = 0.0f;
  const int groups = (c_blk * sigma + p - 1) / p, ng = kFpTaps / 4 + ns;
  const FpRun r(tid, ns, p);
  if (nbuf == 2) issue(raw[0], 0);
  for (int i = 0; i < n_tt; ++i) {
    const float* cur = raw[nbuf == 2 ? (i & 1) : 0];
    if (nbuf == 1) issue(raw[0], i);
    cp_async_wait_all();
    __syncthreads();
    if (nbuf == 2 && i + 1 < n_tt) issue(raw[(i + 1) & 1], i + 1);
    for (int gi = 0; gi < groups; ++gi) {
      // group e4 of segment s: tile samples m = 4 j0 - kFpTaps + 4 e4 .. + 3
      for (int a = tid; a < p * ng; a += nt) {
        const int s = a / ng, e4 = a % ng;
        const FpSeg sg(gi * p + s, 0, c_blk, sigma, ns);
        if (!sg.valid) continue;
        const int m = 4 * sg.j0 - kFpTaps + 4 * e4;
        float re[4], im[4];
        if (m >= 0) {
          PackedWords::unpack(
              *reinterpret_cast<const float4*>(cur + sg.row * t_blk + m), re,
              im);
        } else {
          const float* hr = carry + 2 * kFpHead * sg.row + kFpHead;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const bool in_head = m + u >= -kFpHead;
            re[u] = in_head ? hr[m + u] : 0.0f;
            im[u] = in_head ? hr[kFpHead + m + u] : 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) g.put(s, 4 * e4 + u, re[u], im[u]);
      }
      __syncthreads();
      // the row's last kFpHead samples (e = 4 ns + kFpTaps - kFpHead + k of its
      // last segment), the next tile's head
      for (int a = tid; a < p * kFpHead; a += nt) {
        const int s = a / kFpHead, k = a % kFpHead;
        const FpSeg sg(gi * p + s, 0, c_blk, sigma, ns);
        if (sg.valid && sg.j0 + ns == no) {
          const int e =
              s * g.stride + mid_skew(4 * ns + kFpTaps - kFpHead + k);
          carry[2 * kFpHead * sg.row + k] = g.re[e];
          carry[2 * kFpHead * sg.row + kFpHead + k] = g.im[e];
        }
      }
      const FpSeg sg(gi * p + r.s, 0, c_blk, sigma, ns);
      fp_group_sum<kFull>(g, r, sg.valid,
                          (int64_t)(c0 + sg.row) * (b / 4) +
                              (int64_t)i * no + sg.j0 + kFpRun * r.q,
                          sg.j0, out, (int64_t)channels * (b / 4));
    }
  }
}

// ---- i8direct: int8 planes, int8 taps, on K12's staged ds x4 tile ---------
//
// Every form runs K12's first launch, k12_stages.cuh::ds4_i8_blocked_kernel
// (a CTA stages a channel's segment of kDs4Tile = 1,024 outputs once,
// skewed, behind its head: the previous words, or before the row the zero
// tail; each thread sums a run of 8 outputs from ds4_i8_window's sliding
// __dp4a window, the 33 tap words as shared-memory pairs, zero-padded at
// the oldest end to 40: a zero tap adds an exact 0 to the int32 sums).
// Every form stores through FpI8dStore, whose Ds4Rule specialisation
// sets the window's start, the value and the finish:
//   no noasm         K12's windows over the row: dots fr + fi, full
//                    atan2 and the in-tile difference;
//   noasm            output j < no of each probe tile of tw = t_blk / 4
//                    outputs starts its window at the tile's word j,
//                    halo_w = 32 words past K12's start (the TPU lens's
//                    mis-filtered first sub-window); no % 8 == 0, so no
//                    run of 8 holds both kinds;
//   full             atan2, then the in-tile difference in the same
//                    launch: each run's last theta through shared memory
//                    (ds4_finish's s_last), a tile's first output 0 (a
//                    tile may start inside a run: tw % 8 != 0).
// Without noasm a probe tile may straddle CTAs (tw > kDs4Tile, or tw not
// dividing it): the CTA's first output t0 then differs from theta(t0 -
// 1), which thread 0 sums once more from the staged head (prev_output;
// K12's window, words t0 - 40 .. t0 - 1, all staged: the head is 40
// words, zeros before the row) as K12's Ds4Disc does.
// A noasm tile must lie inside one CTA's segment: fmt_fp_i8d refuses a noasm
// t_blk that does not divide 4 kDs4Tile (it is not staged), and a no
// outside [halo_w, tw - halo_w], before any launch
// (probes/frontend_probe.py::i8d_check its host copy).  Then a shifted
// output j of a tile from word W reads words j - 7 .. j + 32 (the padded
// taps), and its run's last refill from j0 reads word j0 + 40, with j0 <=
// W + no - 8 <= W + tw - 40: nothing past the tile's end, and so nothing
// past the segment's last staged word (t0 + kDs4Tile); every read is of
// the CTA's staged words.  The int32 sums are exact in any
// order and the float combine is the plain version's, so each output
// equals it bit for bit.

// The int8-direct forms' store: out [C, n] float32; tw outputs a probe
// tile; the outputs j < no of each tile start their window halo_w words
// later (no = 0: K12's windows everywhere).
template <bool kFull>
struct FpI8dStore {
  float* out;
  int tw, no, halo_w;
  static constexpr bool kDisc = false;
};

template <bool kFull>
struct Ds4Rule<FpI8dStore<kFull>> {
  using St = FpI8dStore<kFull>;
  __device__ __forceinline__ static int shift(const St& st, int j) {
    return j % st.tw < st.no ? st.halo_w : 0;
  }
  // full's output t0 - 1 where the CTA starts inside a probe tile
  __device__ __forceinline__ static bool prev_output(const St& st, int tid,
                                                     int t0) {
    return kFull && tid == 0 && t0 % st.tw != 0;
  }
  __device__ __forceinline__ static float value(int y1r, int y2r, int y1i,
                                                int y2i, float s_row) {
    const float fr = ((float)y1r + (float)y2r * (1.0f / 128.0f)) + s_row;
    const float fi = ((float)y1i + (float)y2i * (1.0f / 128.0f)) + s_row;
    return kFull ? atan2_poly(fi, fr) : fr + fi;
  }
  // every thread of the CTA calls it (run = its thread, >= 0): the run's
  // outputs j0 .. j0 + R - 1, stored where they lie in the row; full's
  // output j0 follows the previous run's last theta, or at run 0 `extra`
  // (theta(t0 - 1), prev_output), and each tile's first output itself
  template <int R>
  __device__ __forceinline__ static void finish(const St& st, int c,
                                                int channels, int n, int t0,
                                                int run,
                                                const float (&th)[R],
                                                float extra, float* s_last) {
    const int j0 = t0 + R * run;
    float v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = th[r];
    if constexpr (kFull) {
      s_last[run] = th[R - 1];
      __syncthreads();
      int k = j0 % st.tw;  // output j0's place in its probe tile
      float prev = k == 0 ? th[0] : run > 0 ? s_last[run - 1] : extra;
      if (st.tw % R == 0) {  // whole runs a tile: a seam only at r = 0
#pragma unroll
        for (int r = 0; r < R; ++r) {
          v[r] = disc_value(th[r], prev, kFpScale);
          prev = th[r];
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          v[r] = disc_value(th[r], k == 0 ? th[r] : prev, kFpScale);
          prev = th[r];
          k = k + 1 == st.tw ? 0 : k + 1;
        }
      }
    }
    if (j0 < n)
      ds4_store<R>(st.out, (int64_t)c * n + j0, (int64_t)channels * n, v,
                   n - j0, n % 4 == 0, 1.0f);
  }
};

// ---- i8manual: the time loop inside, bulk copies through 2-slot rings ----

// The probe's manual pipeline, as the TPU lens has it: one CTA per c_blk
// channels walks the time tiles; tile i + 1's int8 rows come in by
// cp.async.bulk on an mbarrier into a 2-slot ring while tile i is summed,
// and each tile's outputs leave from a 2-slot ring by bulk stores.  The
// sums are K12's design (ds4_i8_window): a thread takes a run of
// kManRun = 8 neighbouring outputs of one row from a sliding window of
// int8 words in registers, the taps packed once into shared memory as
// (b1, b2) word pairs.  Each tile's two runs of windows (the lens's
// noasm: output j < no reads words j .. j + 32 of the tile, the others
// words j - 32 .. j) are summed apart; no % 8 == 0, so no thread's run
// straddles them, and the window differs only in where it starts.
//
// A bulk copy lands each row unskewed, 16-byte aligned, so a window
// that reads one word at a time (ds4_i8_window, over mid_skew'd planes)
// would meet 4- to 8-way bank conflicts however the lanes are laid out:
// every run starts on a multiple of 4 words.  Here a window word is read
// 16 bytes at a time, and the rows of the ring lie kManPad words apart
// beyond their tw words: a pitch of 16 bytes more than a multiple of 128.
// Run (row r, run m) is thread e = m c_blk + r, so with c_blk = 8 (the
// lens's tiles) a quarter warp takes one run of the 8 rows, whose 16-byte
// reads fall in 8 distinct bank groups; so do the stores of its outputs
// into the output ring, padded the same way.  The window holds 12 words
// of each plane (three quads) and steps 4 tap words at a time over the
// 33 tap words padded to kManTapWords = 36 with zeros at the newest end
// (a zero tap adds an exact 0): 144 IDP4A an output, the floor's 132
// rounded up to whole quads.  The integer sums are exact in any order and
// the float combine (y1 + y2 / 128 + s_row, then atan2_poly or fr + fi)
// is the plain version's, so each output equals it bit for bit.
// full's difference needs the output before each run's first: the run
// before it in the row stores its last theta in shared memory (s_last),
// read after a barrier; the tile's first output differs from itself (0).
constexpr int kManRun = 8;
constexpr int kManThreads = 512;
constexpr int kManPasses = 2;  // runs a thread a tile at most
constexpr int kManPad = 4;     // words past each row of the rings
constexpr int kManTapWords = 36;
static_assert(kManTapWords >= kFpTaps / 4 && kManTapWords % 4 == 0,
              "the padded taps in whole quads");

// fp_i8man_kernel's shared memory, in bytes: the input ring [2 slots][2
// planes][c_blk rows] of tw + kManPad words, the output ring [2][c_blk] of
// tw + kManPad floats, the kManTapWords tap pairs and, for full, the last
// theta of every run of the tile.  The wrapper's host copy is
// probes/frontend_probe.py::i8man_smem (fmt_fp_i8man_smem exports this).
__host__ __device__ inline int64_t fp_man_bytes(int c_blk, int t_blk,
                                                int full) {
  const int64_t pitch = t_blk / 4 + kManPad;
  return 4 * (6 * (int64_t)c_blk * pitch + 2 * kManTapWords +
              (full ? (int64_t)c_blk * (t_blk / 4 / kManRun) : 0));
}

__device__ __forceinline__ int4 ld_quad(const int* p) {
  return *reinterpret_cast<const int4*>(p);
}

// the run of kManRun outputs whose windows start at word eb of the
// unskewed rows sr, si (eb % 4 == 0): output u sums words eb + u + w
// (w < kManTapWords) against s_tap[w], into y1r[u] .. y2i[u]
__device__ __forceinline__ void man_window(const int* sr, const int* si,
                                           const int4* s_tap4, int eb,
                                           int (&y1r)[kManRun],
                                           int (&y2r)[kManRun],
                                           int (&y1i)[kManRun],
                                           int (&y2i)[kManRun]) {
  int4 r0 = ld_quad(sr + eb), r1 = ld_quad(sr + eb + 4);
  int4 i0 = ld_quad(si + eb), i1 = ld_quad(si + eb + 4);
#pragma unroll
  for (int u = 0; u < kManRun; ++u) y1r[u] = y2r[u] = y1i[u] = y2i[u] = 0;
#pragma unroll
  for (int g = 0; g < kManTapWords / 4; ++g) {
    const int4 r2 = ld_quad(sr + eb + 4 * g + 8);
    const int4 i2 = ld_quad(si + eb + 4 * g + 8);
    const int4 ta = s_tap4[2 * g], tb = s_tap4[2 * g + 1];
    const int wr[12] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y,
                        r1.z, r1.w, r2.x, r2.y, r2.z, r2.w};
    const int wi[12] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y,
                        i1.z, i1.w, i2.x, i2.y, i2.z, i2.w};
    const int t1[4] = {ta.x, ta.z, tb.x, tb.z};
    const int t2[4] = {ta.y, ta.w, tb.y, tb.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int u = 0; u < kManRun; ++u) {
        y1r[u] = __dp4a(wr[u + k], t1[k], y1r[u]);
        y2r[u] = __dp4a(wr[u + k], t2[k], y2r[u]);
        y1i[u] = __dp4a(wi[u + k], t1[k], y1i[u]);
        y2i[u] = __dp4a(wi[u + k], t2[k], y2i[u]);
      }
    }
    r0 = r1;
    r1 = r2;
    i0 = i1;
    i1 = i2;
  }
}

template <bool kFull>
__global__ void __launch_bounds__(kManThreads, 1)
fp_i8man_kernel(const int8_t* __restrict__ xr8,
                const int8_t* __restrict__ xi8, const int* __restrict__ b1w,
                const int* __restrict__ b2w, float s_row, int b, int c_blk,
                int t_blk, int no, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char sm[];
  __shared__ __align__(8) uint64_t bar[2];
  const int tw = t_blk / 4, pitch = tw + kManPad;  // words, floats
  const int halo_w = kFpTaps / 4 - 1;
  int* in_ring = (int*)sm;                            // [2][2][c_blk][pitch]
  float* out_ring = (float*)(in_ring + 4 * c_blk * pitch);  // [2][c_blk][pitch]
  int4* s_tap4 = (int4*)(out_ring + 2 * c_blk * pitch);
  int2* s_tap = (int2*)s_tap4;
  float* s_last = (float*)(s_tap + kManTapWords);     // [runs] (full)
  const int c0 = blockIdx.x * c_blk, n_tt = b / t_blk;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int runs = c_blk * (tw / kManRun);
  const uint32_t tile_bytes = 2u * c_blk * t_blk;

  auto load = [&](int slot, int tile) {
    int* dst = in_ring + (int64_t)slot * 2 * c_blk * pitch;
    mbar_expect(&bar[slot], tile_bytes);
    for (int p = 0; p < 2; ++p) {
      const int8_t* src = p == 0 ? xr8 : xi8;
      for (int r = 0; r < c_blk; ++r)
        bulk_g2s(dst + (p * c_blk + r) * pitch,
                 src + (int64_t)(c0 + r) * b + (int64_t)tile * t_blk, t_blk,
                 &bar[slot]);
    }
  };

  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    mbar_fence_init();
    load(0, 0);
  }
  for (int w = tid; w < kManTapWords; w += nt)
    s_tap[w] = w <= halo_w ? make_int2(FMT_AT(b1w, w, halo_w + 1),
                                       FMT_AT(b2w, w, halo_w + 1))
                           : make_int2(0, 0);
  // the words past each row, read only against zero taps: zeros, once
  for (int e = tid; e < 4 * c_blk * kManPad; e += nt)
    in_ring[(e / kManPad) * pitch + tw + e % kManPad] = 0;
  __syncthreads();
  uint32_t phase[2] = {0u, 0u};
  for (int i = 0; i < n_tt; ++i) {
    const int s = i & 1;
    if (tid == 0) {
      if (i + 1 < n_tt) load(1 - s, i + 1);
      bulk_wait_read<1>();  // the store of tile i - 2 has read slot s
    }
    mbar_wait(&bar[s], phase[s]);
    phase[s] ^= 1u;
    __syncthreads();
    const int* slot = in_ring + (int64_t)s * 2 * c_blk * pitch;
    float* ys = out_ring + s * c_blk * pitch;
    float v[kManPasses][kManRun];
#pragma unroll
    for (int k = 0; k < kManPasses; ++k) {
      const int e = tid + k * nt;
      if (e < runs) {
        const int r = e % c_blk, j0 = kManRun * (e / c_blk);
        int y1r[kManRun], y2r[kManRun], y1i[kManRun], y2i[kManRun];
        man_window(slot + r * pitch, slot + (c_blk + r) * pitch, s_tap4,
                   j0 < no ? j0 : j0 - halo_w, y1r, y2r, y1i, y2i);
#pragma unroll
        for (int u = 0; u < kManRun; ++u) {
          const float fr =
              ((float)y1r[u] + (float)y2r[u] * (1.0f / 128.0f)) + s_row;
          const float fi =
              ((float)y1i[u] + (float)y2i[u] * (1.0f / 128.0f)) + s_row;
          v[k][u] = kFull ? atan2_poly(fi, fr) : fr + fi;
        }
        if (kFull) s_last[e] = v[k][kManRun - 1];
      }
    }
    if constexpr (kFull) __syncthreads();
#pragma unroll
    for (int k = 0; k < kManPasses; ++k) {
      const int e = tid + k * nt;
      if (e < runs) {
        const int r = e % c_blk, j0 = kManRun * (e / c_blk);
        float o[kManRun];
#pragma unroll
        for (int u = 0; u < kManRun; ++u) o[u] = v[k][u];
        if (kFull) {
          float prev = j0 == 0 ? v[k][0] : s_last[e - c_blk];
#pragma unroll
          for (int u = 0; u < kManRun; ++u) {
            o[u] = disc_value(v[k][u], prev, kFpScale);
            prev = v[k][u];
          }
        }
        float* dst = ys + r * pitch + j0;
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(o[4], o[5], o[6], o[7]);
      }
    }
    fence_async_shared();
    __syncthreads();
    if (tid == 0) {
      for (int r = 0; r < c_blk; ++r)
        bulk_s2g(out + (int64_t)(c0 + r) * (b / 4) + (int64_t)i * tw,
                 ys + r * pitch, tw * 4);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_all();
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

// a kernel's dynamic shared memory, above 48 KB only once it is allowed
template <class Kernel>
inline cudaError_t fp_smem(Kernel kernel, int64_t bytes) {
  if (bytes > kFpSmemMax) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <class Load, bool kTM, bool kFull>
int launch_fp_fir(Load in, int int8_taps, int channels, int b,
                  const float* w_rev, const int8_t* b1, const int8_t* b2,
                  float s_row, int c_blk, int t_blk, int raster, float* out,
                  cudaStream_t stream) {
  const FpFirGeom gm = fp_fir_geom(c_blk, t_blk);
  const int n_ct = channels / c_blk, n_tt = b / t_blk;
  const dim3 grid((unsigned)((int64_t)n_ct * n_tt * gm.passes));
  if (int8_taps) {
    const int64_t smem = fp_i8_bytes(gm.ns, gm.p);
    const cudaError_t e = fp_smem(fp_fir_i8_kernel<Load, kTM, kFull>, smem);
    if (e != cudaSuccess) return (int)e;
    fp_fir_i8_kernel<Load, kTM, kFull><<<grid, gm.p * gm.ns / kFpRun, smem,
                                         stream>>>(
        in, channels, b, (const int*)b1, (const int*)b2, s_row, c_blk, t_blk,
        n_ct, n_tt, raster, gm.p, gm.passes, out);
  } else {
    const int64_t smem = 4 * fp_group_floats(gm.ns, gm.p);
    const cudaError_t e = fp_smem(fp_fir_kernel<Load, kTM, kFull>, smem);
    if (e != cudaSuccess) return (int)e;
    fp_fir_kernel<Load, kTM, kFull><<<grid, gm.p * gm.ns / 4, smem, stream>>>(
        in, channels, b, w_rev, c_blk, t_blk, n_ct, n_tt, raster, gm.p,
        gm.passes, out);
  }
  FMT_CHECK_LAUNCH();
  return 0;
}

template <class Load, bool kTM>
int fp_fir_full(Load in, int int8_taps, int full, int channels, int b,
                const float* w_rev, const int8_t* b1, const int8_t* b2,
                float s_row, int c_blk, int t_blk, int raster, float* out,
                cudaStream_t stream) {
  return full ? launch_fp_fir<Load, kTM, true>(in, int8_taps, channels, b,
                                               w_rev, b1, b2, s_row, c_blk,
                                               t_blk, raster, out, stream)
              : launch_fp_fir<Load, kTM, false>(in, int8_taps, channels, b,
                                                w_rev, b1, b2, s_row, c_blk,
                                                t_blk, raster, out, stream);
}

template <bool kTM>
int fp_fir_form(const void* x, const void* x2, int form, int int8_taps,
                int full, int channels, int b, const float* w_rev,
                const int8_t* b1, const int8_t* b2, float s_row, int c_blk,
                int t_blk, int raster, float* out, cudaStream_t stream) {
  const int64_t total = (int64_t)channels * b;
  if (form == 0)
    return fp_fir_full<PackedWords, kTM>(
        PackedWords{(const float*)x, total}, int8_taps, full, channels, b,
        w_rev, b1, b2, s_row, c_blk, t_blk, raster, out, stream);
  if (form == 1)
    return fp_fir_full<I16Words, kTM>(
        I16Words{(const int16_t*)x, total}, int8_taps, full, channels, b,
        w_rev, b1, b2, s_row, c_blk, t_blk, raster, out, stream);
  if (form == 2)
    return fp_fir_full<I8Pair, kTM>(
        I8Pair{(const int8_t*)x, (const int8_t*)x2, total}, int8_taps, full,
        channels, b, w_rev, b1, b2, s_row, c_blk, t_blk, raster, out,
        stream);
  return fp_fir_full<F32Pair, kTM>(
      F32Pair{(const float*)x, (const float*)x2, total}, int8_taps, full,
      channels, b, w_rev, b1, b2, s_row, c_blk, t_blk, raster, out,
      stream);
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
// reversed, read as nn/4 words; s_row); nn, the length of the caller's taps,
// must be kFpTaps (132), the one order the kernels are built for.  out
// [C, B/4] float32; one launch.
extern "C" int fmt_fp_fir(const void* x, const void* x2, int form,
                          int int8_taps, int tile_major, int full,
                          const float* w_rev, const int8_t* b1,
                          const int8_t* b2, int nn, float s_row, int channels,
                          int b, int c_blk, int t_blk, int raster, float* out,
                          cudaStream_t stream) {
  if (!fp_tiles_ok(channels, b, c_blk, t_blk) || form < 0 || form > 3 ||
      nn != kFpTaps)
    return (int)cudaErrorInvalidValue;
  return tile_major
             ? fp_fir_form<true>(x, x2, form, int8_taps, full, channels, b,
                                 w_rev, b1, b2, s_row, c_blk, t_blk, raster,
                                 out, stream)
             : fp_fir_form<false>(x, x2, form, int8_taps, full, channels, b,
                                  w_rev, b1, b2, s_row, c_blk, t_blk, raster,
                                  out, stream);
}

// fp_dbuf_layout, read by the wrapper and the probe's sections (and held
// against the host copy): layout [4] = {ns, p, threads, shared-memory
// bytes}.
extern "C" int fmt_fp_dbuf_layout(int c_blk, int t_blk, int nbuf,
                                  int64_t* layout) {
  const FpDbufLayout l = fp_dbuf_layout(c_blk, t_blk, nbuf);
  layout[0] = l.ns;
  layout[1] = l.p;
  layout[2] = l.threads;
  layout[3] = l.bytes;
  return 0;
}

// build_dbuf: x packed words [C, B] float32 (16-byte aligned), float taps
// w_rev [nn], nn == kFpTaps (checked); nbuf 1 or 2; out [C, B/4].  Shared
// memory fp_dbuf_layout's bytes <= 227 KB.
extern "C" int fmt_fp_dbuf(const float* x, int full, const float* w_rev,
                           int nn, int channels, int b, int c_blk, int t_blk,
                           int nbuf, float* out, cudaStream_t stream) {
  if (!fp_tiles_ok(channels, b, c_blk, t_blk) || (nbuf != 1 && nbuf != 2) ||
      nn != kFpTaps)
    return (int)cudaErrorInvalidValue;
  const FpDbufLayout l = fp_dbuf_layout(c_blk, t_blk, nbuf);
  const dim3 grid(channels / c_blk);
  if (full) {
    const cudaError_t e = fp_smem(fp_dbuf_kernel<true>, l.bytes);
    if (e != cudaSuccess) return (int)e;
    fp_dbuf_kernel<true><<<grid, l.threads, l.bytes, stream>>>(
        x, channels, b, w_rev, c_blk, t_blk, nbuf, l.p, out);
  } else {
    const cudaError_t e = fp_smem(fp_dbuf_kernel<false>, l.bytes);
    if (e != cudaSuccess) return (int)e;
    fp_dbuf_kernel<false><<<grid, l.threads, l.bytes, stream>>>(
        x, channels, b, w_rev, c_blk, t_blk, nbuf, l.p, out);
  }
  FMT_CHECK_LAUNCH();
  return 0;
}

// build_i8direct: x8 int8 planes [2, C, B] (4-byte aligned rows); tail8
// [2, C, nn - 4] int8 zeros (the carried tail before the row); b1, b2 [nn];
// out [C, B/4].  Every form is one launch of ds4_i8_blocked_kernel
// through FpI8dStore.  With noasm a tile of t_blk must lie inside one
// CTA's segment of 4 kDs4Tile samples and hold whole runs (t_blk % 32 ==
// 0, (4 kDs4Tile) % t_blk == 0) and every window of it inside it (no %
// 8 == 0, halo_w <= no <= t_blk / 4 - halo_w); else refused before any
// launch.
extern "C" int fmt_fp_i8d(const int8_t* x8, const int8_t* tail8,
                          const int8_t* b1, const int8_t* b2, int nn,
                          float s_row, int channels, int b, int t_blk, int no,
                          int noasm, int full, float* out,
                          cudaStream_t stream) {
  const int halo_w = (nn - 4) / 4, tw = t_blk / 4;
  if (t_blk <= 0 || b % t_blk || t_blk % 16 || nn % 4 || nn - 4 > kFpHead ||
      4 * no > t_blk)
    return (int)cudaErrorInvalidValue;
  if (noasm && (t_blk % (4 * kDs4Run) || (4 * kDs4Tile) % t_blk ||
                no % kDs4Run || no < halo_w || no > tw - halo_w))
    return (int)cudaErrorInvalidValue;
  const I8Rows src{x8, b};
  const int nq = noasm ? no : 0;
  if (full)
    return launch_ds4_i8(src, tail8, b1, b2, nn, s_row, channels, b,
                         FpI8dStore<true>{out, tw, nq, halo_w}, stream);
  return launch_ds4_i8(src, tail8, b1, b2, nn, s_row, channels, b,
                       FpI8dStore<false>{out, tw, nq, halo_w}, stream);
}

// build_i8manual: x8 int8 planes [2, C, B] (16-byte aligned rows); b1,
// b2 [nn] (nn == kFpTaps, the probe's one order); out [C, B/4] (16-byte
// aligned rows); no, the outputs a tile whose window starts at the tile's
// word j: a multiple of kManRun in [halo_w, t_blk / 4 - halo_w] (every
// window inside the tile).  At most kManPasses runs a thread (c_blk x
// t_blk <= 32,768) and fp_man_bytes <= 227 KB.
extern "C" int fmt_fp_i8man(const int8_t* x8, const int8_t* b1,
                            const int8_t* b2, int nn, float s_row,
                            int channels, int b, int c_blk, int t_blk,
                            int no, int full, float* out,
                            cudaStream_t stream) {
  const int8_t* xr8 = x8;
  const int8_t* xi8 = x8 + (int64_t)channels * b;
  const int halo_w = kFpTaps / 4 - 1, tw = t_blk / 4;
  if (!fp_tiles_ok(channels, b, c_blk, t_blk) || nn != kFpTaps ||
      no % kManRun || no < halo_w || no + halo_w > tw ||
      (int64_t)c_blk * (tw / kManRun) > (int64_t)kManPasses * kManThreads ||
      ((uintptr_t)x8 | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  const int64_t smem = fp_man_bytes(c_blk, t_blk, full);
  const dim3 grid(channels / c_blk);
  if (full) {
    const cudaError_t e = fp_smem(fp_i8man_kernel<true>, smem);
    if (e != cudaSuccess) return (int)e;
    fp_i8man_kernel<true><<<grid, kManThreads, smem, stream>>>(
        xr8, xi8, (const int*)b1, (const int*)b2, s_row, b, c_blk, t_blk, no,
        out);
  } else {
    const cudaError_t e = fp_smem(fp_i8man_kernel<false>, smem);
    if (e != cudaSuccess) return (int)e;
    fp_i8man_kernel<false><<<grid, kManThreads, smem, stream>>>(
        xr8, xi8, (const int*)b1, (const int*)b2, s_row, b, c_blk, t_blk, no,
        out);
  }
  FMT_CHECK_LAUNCH();
  return 0;
}

// fp_man_bytes, for the wrapper's host copy (i8man_smem) to be held
// against on the card
extern "C" int64_t fmt_fp_i8man_smem(int c_blk, int t_blk, int full) {
  return fp_man_bytes(c_blk, t_blk, full);
}
