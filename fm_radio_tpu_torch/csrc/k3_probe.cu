// The extract (K3) engine probe on Hopper.
//
// Replaces the Pallas kernels of tools/k3_probe.py (a TPU diagnostic, not
// a kernel of the receiver), and the stream kernel of tools/chain_probe.py:
//   build (:80, kernel :92, pallas_call :187)
//     stream1, stream     the per-tile sums of one plane (re) or of the
//                         three (re, im, dt): the read alone
//                         (tools/chain_probe.py::_stream3_pallas :35, :52
//                         is `stream` at t_blk = 1024)
//     phasor              + the harmonic phasors and the four mixes,
//                         summed per tile
//     value               extract without the shared-memory tile
//                         (k3_value_kernel): a warp takes a block of one
//                         channel's samples in registers, 16-byte loads,
//                         each sample mixed once, and slides every FIR's
//                         phase windows through the lanes by
//                         __shfl_down_sync, kValueRun audio outputs (half
//                         as many RDS) a lane; no shared memory at all;
//                         ROADMAP performance item 1's question.  Built at
//                         the probe's orders only (64 / 128 taps).
//     full                the production extract kernel (extract.cu), run
//                         by the wrapper on the probe's taps
//   build_stream31 (:55, kernel :61, pallas_call :66)
//     stream31            the per-tile sums of one row-stacked [3C, B8]
//                         plane (c_blk-interleaved row groups); the TPU
//                         output keeps the first c_blk rows of each group
//
// The stream-style sums are probe_sum.cuh's: the [C, 128] output of the
// last time tile, as the TPU kernels leave it, and every tile's sums.  The
// mix is extract_stages.cuh's mix_sample and the FIR sums add from the
// oldest sample up, as fir_dot, so `value` equals `full` (extract on zero
// carried tails: the TPU probe never writes its tails) bit for bit.
//
// What bounds them is what this probe measures; the times are in PERF.md.

#include <utility>

#include "extract_stages.cuh"
#include "probe_sum.cuh"

namespace fmt {

// The Ops of tile_sum_kernel (probe_sum.cuh; frontend_probe.cu says what
// each member does).

// float32 rows, float4 at a time (stream1; stream31 keeps rows k < c_blk
// of each 3 * c_blk row group, at g * c_blk + k)
struct F32Sum {
  static constexpr int kVec = 4, kPlanes = 1;
  using Raw = float4;
  using Acc = float;
  const float* x;
  int rows, n, c_blk;  // c_blk > 0: the stream31 row groups
  __device__ __forceinline__ Acc zero() const { return 0.0f; }
  __device__ __forceinline__ int64_t base(int r, int ti, int t_blk) const {
    return tile_base(r, ti, rows, n, t_blk, false);
  }
  __device__ __forceinline__ Raw fetch(int64_t b, int v) const {
    return ld_once((const float4*)(x + b) + v);
  }
  __device__ __forceinline__ void add(Acc& acc, const Raw& v) const {
    acc += v.x;
    acc += v.y;
    acc += v.z;
    acc += v.w;
  }
  __device__ __forceinline__ float done(Acc acc) const { return acc; }
  __device__ __forceinline__ bool keep(int r, int rows_blk, int& o) const {
    if (c_blk == 0) {
      o = r;
      return true;
    }
    const int g = r / rows_blk, k = r % rows_blk;
    o = g * c_blk + k;
    return k < c_blk;
  }
};

// the same sample of the three float32 planes re, im, dt
struct Three {
  float4 r, i, d;
};

struct ThreePlanes : KeepAll {
  static constexpr int kVec = 4, kPlanes = 3;
  using Raw = Three;
  const float *xr, *xi, *dt;
  int rows, n;
  __device__ __forceinline__ int64_t base(int r, int ti, int t_blk) const {
    return tile_base(r, ti, rows, n, t_blk, false);
  }
  __device__ __forceinline__ Raw fetch(int64_t b, int v) const {
    return {ld_once((const float4*)(xr + b) + v),
            ld_once((const float4*)(xi + b) + v),
            ld_once((const float4*)(dt + b) + v)};
  }
};

// three float32 planes: the lane's sums of re, im and dt, added as
// (re + im) + dt
struct F32Sum3 : ThreePlanes {
  struct Acc {
    float a[3];
  };
  __device__ __forceinline__ Acc zero() const { return {{0.0f, 0.0f, 0.0f}}; }
  __device__ __forceinline__ void add(Acc& acc, const Raw& v) const {
    const float4 p[3] = {v.r, v.i, v.d};
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      acc.a[q] += p[q].x;
      acc.a[q] += p[q].y;
      acc.a[q] += p[q].z;
      acc.a[q] += p[q].w;
    }
  }
  __device__ __forceinline__ float done(const Acc& acc) const {
    return (acc.a[0] + acc.a[1]) + acc.a[2];
  }
};

// the four mixes of each sample (harmonics 2 and 3, offset 0) summed:
// ((L-R re + L-R im) + RDS re) + RDS im
struct PhasorSum : ThreePlanes {
  struct Acc {
    float s, co, so;  // the sum, and offset 0's phasor
  };
  __device__ __forceinline__ Acc zero() const {
    Acc acc{0.0f, 0.0f, 0.0f};
    offset_phasor(0.0f, acc.co, acc.so);
    return acc;
  }
  __device__ __forceinline__ void add(Acc& acc, const Raw& v) const {
    const float er[4] = {v.r.x, v.r.y, v.r.z, v.r.w};
    const float ei[4] = {v.i.x, v.i.y, v.i.z, v.i.w};
    const float ed[4] = {v.d.x, v.d.y, v.d.z, v.d.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float vmr, vmi, vrr, vri;
      mix_sample(er[u], ei[u], ed[u], acc.co, acc.so, vmr, vmi, vrr, vri);
      acc.s += ((vmr + vmi) + vrr) + vri;
    }
  }
  __device__ __forceinline__ float done(const Acc& acc) const {
    return acc.s;
  }
};

// ---- value: extract's five outputs without a staged tile ----
//
// The probe's question (ROADMAP performance item 1): can a register-blocked
// extract that stages no sample in shared memory compete with the staged
// tile (extract.cu)?  Here no shared memory holds a sample, or anything
// else: the kernel's shared memory is 0 bytes.  The samples move between
// the lanes of a warp by __shfl_down_sync instead.
//
// A warp takes one block of one channel row.  Its window is kK3Slots
// float4 steps of the three planes (t = T0 .. T0 + 32 R - 1, sample 4 t +
// p is phase p of step t), lane L holding steps T0 + R L .. T0 + R L + R -
// 1: R coalesced 16-byte loads a plane, each sample loaded and mixed once
// (mix_sample, as extract's tile) into five planes of four phases, R
// registers each.  Samples before the row read 0 (the zero carried tails
// of the TPU probe); past its end 0 (no output that is stored reads them).
//
// The FIRs keep their phases apart, as fir_block does: an audio output
// (ds x4 of NA taps) starting at step s sums tap k = 4 m + p times phase p
// of step s + m for m = 0 .. NA/4 - 1, p = 0 .. 3; an RDS output (ds x8 of
// NR taps) the same with m = 0 .. NR/4 - 1 from an even start.  So a lane's
// accumulator at position P of the window (its logical slot r: P = R L +
// r) takes at step m the value at P + m: after every step each plane-phase
// window slides by one, the slot that logical output 0 read taking the
// next lane's (one __shfl_down_sync a plane-phase a step; fir_steps'
// rotation, so no register moves).  Positions, tap indices and window
// slots are compile-time and warp-uniform: no membership test, no branch.
// Each output adds its products from 0.0f, k ascending, each product and
// sum rounded (-fmad=false): fir_dot's sum, so value equals full bit for
// bit.  What enters lane 31 is never read by an output that is stored:
// the block's last G lanes (K3Geom::kG) only carry the halo, so
// neighbouring warps' windows overlap by 32 R - NU steps (K3Geom::kNu
// audio outputs a warp), loaded and mixed by both.
//
// R (kValueRun) is the run of audio outputs a lane, R / 2 of RDS: the
// five windows hold 20 R floats a lane and the accumulators 4 R.  R = 4
// keeps every FIR live at once in 127 registers (4 CTAs, 16 warps an SM;
// no spill); a shuffle issues at a quarter of the FMUL/FADD rate, and a
// step's 2 R products a plane-phase against its one shuffle keep the FIR,
// not the shuffles, the pace.  The halo costs 32 R / NU = 1.33x in loads,
// mixes and products.  R = 8 (1.14x) took 243 registers, 2 CTAs an SM,
// and ran slower (PERF.md).  Only the
// probe's orders are built (kK3Na, kK3Nr): fmt_k3_value refuses any other
// before a launch, as does probes/k3_probe.py::value on every device.
constexpr int kK3Na = 64;    // the probe's L+R and L-R taps
constexpr int kK3Nr = 128;   // its RDS taps
constexpr int kValueRun = 4;
constexpr int kValueThreads = 128;  // 4 warps a CTA, each its own block

template <int R, int NA, int NR>
struct K3Geom {
  static constexpr int kSa = NA / 4;         // audio steps
  static constexpr int kSr = NR / 4;         // RDS steps
  static constexpr int kHa = kSa - 1;        // audio halo, steps
  static constexpr int kHr = (NR - 8) / 4;   // RDS halo, steps
  static constexpr int kD = kHr - kHa;       // audio start - RDS start
  static constexpr int kW = 32 * R;          // the window's steps
  // the lanes whose outputs are stored: every value they read lies in
  // the window (RDS positions P <= NU - 2 read up to P + kSr - 1, audio
  // positions kD .. kD + NU - 1 up to + kHa)
  static constexpr int kLanes =
      (kW - kSr + 2 < kW - kD - kHa ? kW - kSr + 2 : kW - kD - kHa) / R;
  static constexpr int kNu = R * kLanes;     // audio outputs a warp
  static constexpr int kG = 32 - kLanes;     // lanes that carry the halo
  static_assert(NA % 4 == 0 && NR % 8 == 0 && kD >= 0 && R % 4 == 0 &&
                    kSa % R == 0 && kSr % R == 0 && kLanes > 0,
                "whole float4 steps, the RDS halo at least the audio's, "
                "whole runs of steps");
};

// one step m = g R + QQ of every FIR (the audio ones only where kAudio):
// the products of each phase p in turn, then that phase's windows slide
template <int R, int QQ, bool kAudio>
__device__ __forceinline__ void k3_step(
    const float* __restrict__ wa, const float* __restrict__ wm,
    const float* __restrict__ wr, int m, float (&vl)[4][R],
    float (&vmr)[4][R], float (&vmi)[4][R], float (&vrr)[4][R],
    float (&vri)[4][R], float (&al)[R], float (&amr)[R], float (&ami)[R],
    float (&arr)[R / 2], float (&ari)[R / 2]) {
  constexpr unsigned kAll = 0xffffffffu;
  float ta[4], tm[4], tr[4];
  const float4 r4 = __ldg(reinterpret_cast<const float4*>(wr) + m);
  tr[0] = r4.x, tr[1] = r4.y, tr[2] = r4.z, tr[3] = r4.w;
  if constexpr (kAudio) {
    const float4 a4 = __ldg(reinterpret_cast<const float4*>(wa) + m);
    const float4 m4 = __ldg(reinterpret_cast<const float4*>(wm) + m);
    ta[0] = a4.x, ta[1] = a4.y, ta[2] = a4.z, ta[3] = a4.w;
    tm[0] = m4.x, tm[1] = m4.y, tm[2] = m4.z, tm[3] = m4.w;
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    if constexpr (kAudio) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        al[r] += ta[p] * vl[p][(r + QQ) % R];
        amr[r] += tm[p] * vmr[p][(r + QQ) % R];
        ami[r] += tm[p] * vmi[p][(r + QQ) % R];
      }
      vl[p][QQ] = __shfl_down_sync(kAll, vl[p][QQ], 1);
      vmr[p][QQ] = __shfl_down_sync(kAll, vmr[p][QQ], 1);
      vmi[p][QQ] = __shfl_down_sync(kAll, vmi[p][QQ], 1);
    }
#pragma unroll
    for (int q = 0; q < R / 2; ++q) {
      arr[q] += tr[p] * vrr[p][(2 * q + QQ) % R];
      ari[q] += tr[p] * vri[p][(2 * q + QQ) % R];
    }
    vrr[p][QQ] = __shfl_down_sync(kAll, vrr[p][QQ], 1);
    vri[p][QQ] = __shfl_down_sync(kAll, vri[p][QQ], 1);
  }
}

template <int R, bool kAudio, int... QQ>
__device__ __forceinline__ void k3_steps(
    std::integer_sequence<int, QQ...>, const float* __restrict__ wa,
    const float* __restrict__ wm, const float* __restrict__ wr, int m0,
    float (&vl)[4][R], float (&vmr)[4][R], float (&vmi)[4][R],
    float (&vrr)[4][R], float (&vri)[4][R], float (&al)[R], float (&amr)[R],
    float (&ami)[R], float (&arr)[R / 2], float (&ari)[R / 2]) {
  (k3_step<R, QQ, kAudio>(wa, wm, wr, m0 + QQ, vl, vmr, vmi, vrr, vri, al,
                          amr, ami, arr, ari),
   ...);
}

// channels x ceil((n/4) / NU) warps; warp (c, b) writes audio outputs
// b NU .. b NU + NU - 1 and RDS outputs b NU/2 .. of channel c
template <int R, int NA, int NR>
__global__ void __launch_bounds__(kValueThreads)
k3_value_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                const float* __restrict__ dt, int n,
                const float* __restrict__ wa, const float* __restrict__ wm,
                const float* __restrict__ wr, int channels,
                float* __restrict__ lpr, float* __restrict__ lmr_re,
                float* __restrict__ lmr_im, float* __restrict__ rds_re,
                float* __restrict__ rds_im) {
  using G = K3Geom<R, NA, NR>;
  const int na = n / 4, nr = n / 8, nb = (na + G::kNu - 1) / G::kNu;
  const int64_t w = ((int64_t)blockIdx.x * kValueThreads + threadIdx.x) / 32;
  if (w >= (int64_t)channels * nb) return;  // whole warps
  const int lane = threadIdx.x % 32;
  const int c = (int)(w / nb);
  const int j0 = (int)(w % nb) * G::kNu;  // the warp's first audio output
  const int t0 = j0 - G::kHr;             // its window's first step
  const int64_t row = (int64_t)c * n, total = (int64_t)channels * n;
  float co, so;
  offset_phasor(0.0f, co, so);
  float vl[4][R], vmr[4][R], vmi[4][R], vrr[4][R], vri[4][R];
  float4 raw[3][R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = t0 + R * lane + r;
    const bool in = t >= 0 && t < na;
    const auto load = [&](const float* x) {
      return in ? __ldg(reinterpret_cast<const float4*>(
                      FMT_SPAN(x, row + 4 * t, 4, total)))
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    };
    raw[0][r] = load(xr);
    raw[1][r] = load(xi);
    raw[2][r] = load(dt);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = t0 + R * lane + r;
    const float er[4] = {raw[0][r].x, raw[0][r].y, raw[0][r].z, raw[0][r].w};
    const float ei[4] = {raw[1][r].x, raw[1][r].y, raw[1][r].z, raw[1][r].w};
    const float ed[4] = {raw[2][r].x, raw[2][r].y, raw[2][r].z, raw[2][r].w};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      vl[p][r] = vmr[p][r] = vmi[p][r] = vrr[p][r] = vri[p][r] = 0.0f;
      if (t >= 0) {
        vl[p][r] = er[p];
        mix_sample(er[p], ei[p], ed[p], co, so, vmr[p][r], vmi[p][r],
                   vrr[p][r], vri[p][r]);
      }
    }
  }
  float al[R], amr[R], ami[R], arr[R / 2], ari[R / 2];
#pragma unroll
  for (int r = 0; r < R; ++r) al[r] = amr[r] = ami[r] = 0.0f;
#pragma unroll
  for (int q = 0; q < R / 2; ++q) arr[q] = ari[q] = 0.0f;
  const auto qs = std::make_integer_sequence<int, R>{};
  // steps 0 .. kSa - 1 of every FIR, then the RDS FIRs' rest
#pragma unroll 1
  for (int m0 = 0; m0 < G::kSa; m0 += R)
    k3_steps<R, true>(qs, wa, wm, wr, m0, vl, vmr, vmi, vrr, vri, al, amr,
                      ami, arr, ari);
#pragma unroll 1
  for (int m0 = G::kSa; m0 < G::kSr; m0 += R)
    k3_steps<R, false>(qs, wa, wm, wr, m0, vl, vmr, vmi, vrr, vri, al, amr,
                       ami, arr, ari);

  // the audio accumulator at position P = R L + r is output t0 + P + kHa
  // = j0 + P - kD: lane L stores outputs j0 + R L .. + R - 1, taken from
  // kD positions on; the RDS accumulator q is output (j0 + R L + 2 q) / 2
  float ol[R], omr[R], omi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    constexpr unsigned kAll = 0xffffffffu;
    const int s = (r + G::kD) % R, d = (r + G::kD) / R;
    ol[r] = __shfl_down_sync(kAll, al[s], d);
    omr[r] = __shfl_down_sync(kAll, amr[s], d);
    omi[r] = __shfl_down_sync(kAll, ami[s], d);
  }
  const int ja = j0 + R * lane, jr = j0 / 2 + R / 2 * lane;
  if (lane >= G::kLanes || ja >= na) return;  // the halo's lanes; past the row
  const int64_t oa = (int64_t)c * na + ja, orr = (int64_t)c * nr + jr;
  const int64_t ta = (int64_t)channels * na, tr = (int64_t)channels * nr;
  const auto store = [&](float* y, const float (&v)[R]) {
#pragma unroll
    for (int r = 0; r < R; r += 4)
      *reinterpret_cast<float4*>(FMT_SPAN(y, oa + r, 4, ta)) =
          make_float4(v[r], v[r + 1], v[r + 2], v[r + 3]);
  };
  store(lpr, ol);
  store(lmr_re, omr);
  store(lmr_im, omi);
  static_assert(R == 4, "one float2 RDS store a plane");
  *reinterpret_cast<float2*>(FMT_SPAN(rds_re, orr, 2, tr)) =
      make_float2(arr[0], arr[1]);
  *reinterpret_cast<float2*>(FMT_SPAN(rds_im, orr, 2, tr)) =
      make_float2(ari[0], ari[1]);
}

}  // namespace fmt

using namespace fmt;

// The per-tile sums.  mode 0 stream1 (x [C, N]), 1 stream (x, x2, x3 =
// re, im, dt [C, N]), 2 phasor (the same), 3 stream31 (x [3C, N], row
// groups of 3 * c_blk, `last` [C, 128]).  sums [rows, N / t_blk]; c_blk |
// C, t_blk | N, t_blk % 128 == 0; 16-byte aligned rows.
extern "C" int fmt_k3_sum(const float* x, const float* x2, const float* x3,
                          int mode, int channels, int n, int c_blk, int t_blk,
                          float* sums, float* last, cudaStream_t stream) {
  if (c_blk <= 0 || channels % c_blk || t_blk <= 0 || n % t_blk ||
      mode < 0 || mode > 3)
    return (int)cudaErrorInvalidValue;
  const int n_tt = n / t_blk;
  switch (mode) {
    case 0:
      return launch_tile_sum(F32Sum{x, channels, n, 0}, channels, c_blk,
                             n_tt, t_blk, 0, sums, last, stream);
    case 1:
      return launch_tile_sum(F32Sum3{{{}, x, x2, x3, channels, n}}, channels,
                             c_blk, n_tt, t_blk, 0, sums, last, stream);
    case 2:
      return launch_tile_sum(PhasorSum{{{}, x, x2, x3, channels, n}}, channels,
                             c_blk, n_tt, t_blk, 0, sums, last, stream);
    default:
      return launch_tile_sum(F32Sum{x, 3 * channels, n, c_blk}, 3 * channels,
                             3 * c_blk, n_tt, t_blk, 0, sums, last, stream);
  }
}

// value: re, im, dt [C, N] float32 (16-byte aligned rows); wa, wm
// [kK3Na], wr [kK3Nr] reversed taps (16-byte aligned); lpr, lmr_* [C, N/4],
// rds_* [C, N/8].  N % 64 == 0.  Only the probe's orders are built: any
// other nn_a, nn_r is refused, as is a misaligned pointer.
extern "C" int fmt_k3_value(const float* xr, const float* xi, const float* dt,
                            int channels, int n, const float* wa,
                            const float* wm, int nn_a, const float* wr,
                            int nn_r, float* lpr, float* lmr_re,
                            float* lmr_im, float* rds_re, float* rds_im,
                            cudaStream_t stream) {
  const uintptr_t align = (uintptr_t)xr | (uintptr_t)xi | (uintptr_t)dt |
                          (uintptr_t)wa | (uintptr_t)wm | (uintptr_t)wr |
                          (uintptr_t)lpr | (uintptr_t)lmr_re |
                          (uintptr_t)lmr_im | (uintptr_t)rds_re |
                          (uintptr_t)rds_im;
  if (n <= 0 || n % 64 || nn_a != kK3Na || nn_r != kK3Nr || channels < 1 ||
      align % 16)
    return (int)cudaErrorInvalidValue;
  using G = K3Geom<kValueRun, kK3Na, kK3Nr>;
  const int64_t warps =
      (int64_t)channels * ((n / 4 + G::kNu - 1) / G::kNu);
  k3_value_kernel<kValueRun, kK3Na, kK3Nr>
      <<<blocks_for(32 * warps, kValueThreads), kValueThreads, 0, stream>>>(
          xr, xi, dt, n, wa, wm, wr, channels, lpr, lmr_re, lmr_im, rds_re,
          rds_im);
  FMT_CHECK_LAUNCH();
  return 0;
}

// the value kernel's geometry, for its host copy (probes/k3_probe.py::
// value_geom): out = {R, NU, lanes that store, threads a CTA}
extern "C" int fmt_k3_value_geom(int* out) {
  using G = K3Geom<kValueRun, kK3Na, kK3Nr>;
  out[0] = kValueRun;
  out[1] = G::kNu;
  out[2] = G::kLanes;
  out[3] = kValueThreads;
  return 0;
}
