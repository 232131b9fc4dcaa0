// Extract: L+R / L-R / RDS band extraction of the demodulator on Hopper.
//
// Replaces fm_radio_tpu/kernels/extract_pallas.py::_extract_kernel (body
// _extract_body): from the analytic signal fm_out_iq (re, im) [C, N] and
// the pilot NCO track dt [C, N] it builds the harmonic phasors from ONE
// base phasor per sample (p1 = e^{j2pi dt}; p2 = p1^2 rotated by the
// per-channel L-R offset; p3 = p1^2 * p1, extract_pallas.py:55-71), mixes,
// and runs the five decimating FIRs: L+R ds x4 on Re, L-R ds x4 on both
// planes, RDS ds x8 on both planes (128 taps each).  It also returns the
// per-channel RDS power sum for the fused RDS AGC.
//
// What bounds it on this card: instruction issue in the FIRs.  Each input
// sample feeds 32 multiply-adds per audio plane (three planes) and 16 per
// RDS plane (two): 4.29 G at the bench cell (2048 channels x 16,384
// samples), each a rounded FMUL and FADD under -fmad=false (8.6 G FP32
// operations: ~0.29 ms at the card's 67 TFLOP/s), far above its bytes
// (0.179 ms).  One output a thread, each multiply-add's sample loaded
// from shared memory with 4- and 8-way bank conflicts and its tap by
// __ldg, took 2.964 ms per block (NVIDIA H100 80GB HBM3, 700.00 W).
//
// What the design does about it: one block per (time tile of 1024
// samples, channel).  The block mixes its tile plus a 128-sample halo into
// shared memory once (5 planes), so every phasor is evaluated once per
// sample.  Halo samples before the block start come from the carried
// tails: ds_audio_lpr carries the RAW re/im tail, ds_audio_lmr and ds_rds
// carry ALREADY MIXED tails (mixed with the previous block's L-R offset),
// exactly as extract_pallas.py:292-306.  The FIRs then run
// register-blocked (extract_stages.cuh::fir_block: 8 outputs a thread on
// the ds x4 planes, 4 on the ds x8 planes, one sliding window a polyphase
// phase, so one shared-memory load serves 8 or 4 multiply-adds; the
// planes skewed so neighbouring threads hit distinct banks; the taps read
// from shared memory as broadcasts), each output the same sum in the same
// order as the plain version, so it stays bit-equal: ~0.57 ms at the
// bench cell (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).  The receiver's
// orders (128 taps each) are compiled in (extract_blocked_kernel); every
// other order the 128-sample halos admit runs the same tile with the
// order's whole blocks of steps in a run-time loop
// (extract_blocked_any_kernel, fir_block_any).  The RDS power is summed
// per tile in output order and then per channel in tile order by a
// second small kernel: deterministic, no atomics.  The mix and the FIRs
// are extract_stages.cuh, which the megakernel (chain.cu) runs too.

#include "extract_stages.cuh"

namespace fmt {

// ---- The blocked route ----
//
// extract_blocked_kernel: the receiver's filter orders (128 taps each),
// the planes stored skewed and the FIRs register-blocked
// (extract_stages.cuh: ext_put, ext_firs), one CTA a (tile, channel).  A
// time-ordered walk of a channel's tiles by one CTA (the halo kept in
// shared memory, the next tile's inputs fetched by cp.async.bulk) was
// timed against it and was slower where C is small and no faster at C =
// 2048 (PERF.md), so it was not kept.  extract_blocked_any_kernel: the
// same at any other order within the halos (ext_put_any, ext_firs_any).

// CTAs an SM the blocked kernels are built for (their registers a thread:
// nvcc -Xptxas -v)
constexpr int kExtMinBlocks = 4;

// The route (kernels/extract.py::extract_route is its host copy): the
// blocked kernels where the L+R / L-R and the RDS filters fit the
// 128-sample halos, else none (fmt_extract refuses the call).
enum ExtRoute { kExtRefused = 0, kExtBlocked = 1 };

inline int extract_route(int nn_a, int nn_r) {
  return nn_a >= 4 && nn_a - 4 <= kExtHalo && nn_r >= 8 &&
                 nn_r - 8 <= kExtHalo
             ? kExtBlocked
             : kExtRefused;
}

// one CTA a (tile, channel): grid (n / kExtTile, C)
template <class TX, class TD>
__global__ void __launch_bounds__(kExtThreads, kExtMinBlocks)
extract_blocked_kernel(const ExtArgs<TX, TD> a) {
  constexpr int NL = kExtW / kExtThreads;
  static_assert(kExtW % kExtThreads == 0, "whole loads a thread");
  __shared__ ExtShared sh;
  const int tile = blockIdx.x, c = blockIdx.y;
  const int n_tiles = gridDim.x, channels = gridDim.y;
  const int t0 = tile * kExtTile;
  const int64_t row = (int64_t)c * a.n, total = (int64_t)channels * a.n;
  ext_taps(sh, a);
  float co, so;
  offset_phasor(FMT_AT(a.off, c, channels), co, so);
  // the tile and its halo: every load of a thread issued before any is
  // used, then the mix of each sample once
  float lr[NL], li[NL], ld[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const int g = t0 - kExtHalo + (int)threadIdx.x + k * kExtThreads;
    if (g >= 0) {
      lr[k] = load_f32(&FMT_AT(a.xr, row + g, total), 0, kIqScale);
      li[k] = load_f32(&FMT_AT(a.xi, row + g, total), 0, kIqScale);
      ld[k] = load_f32(&FMT_AT(a.dt, row + g, total), 0, kPhScale);
    }
  }
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const int e = threadIdx.x + k * kExtThreads;
    ext_put(sh, a, c, channels, e, t0 - kExtHalo + e, lr[k], li[k], ld[k],
            co, so);
  }
  __syncthreads();
  ext_firs(sh, a, c, channels, tile, n_tiles);
}

// extract_blocked_kernel at the orders (nn_a, nn_r): grid (n / kExtTile,
// C)
template <class TX, class TD>
__global__ void __launch_bounds__(kExtThreads, kExtMinBlocks)
extract_blocked_any_kernel(const ExtArgs<TX, TD> a, int nn_a, int nn_r) {
  constexpr int NL = kExtW / kExtThreads;
  __shared__ ExtSharedAny sh;
  const ExtOrders o(nn_a, nn_r);
  const int tile = blockIdx.x, c = blockIdx.y;
  const int n_tiles = gridDim.x, channels = gridDim.y;
  const int t0 = tile * kExtTile;
  const int64_t row = (int64_t)c * a.n, total = (int64_t)channels * a.n;
  ext_taps_any(sh, a, o);
  float co, so;
  offset_phasor(FMT_AT(a.off, c, channels), co, so);
  float lr[NL], li[NL], ld[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const int g = t0 - kExtHalo + (int)threadIdx.x + k * kExtThreads;
    if (g >= 0) {
      lr[k] = load_f32(&FMT_AT(a.xr, row + g, total), 0, kIqScale);
      li[k] = load_f32(&FMT_AT(a.xi, row + g, total), 0, kIqScale);
      ld[k] = load_f32(&FMT_AT(a.dt, row + g, total), 0, kPhScale);
    }
  }
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const int e = threadIdx.x + k * kExtThreads;
    ext_put_any(sh, a, o, c, channels, e, t0 - kExtHalo + e, lr[k], li[k],
                ld[k], co, so);
  }
  __syncthreads();
  ext_firs_any(sh, a, o, c, channels, tile, n_tiles);
}

}  // namespace fmt

using namespace fmt;

// xr, xi, dt [C, N] with N % 1024 == 0: float32, or with iq_i16 the planes
// and with dt_i16 dt in the int16 format (dt_i16 needs iq_i16: the route
// gives no other combination); off [C]; tails [C, halo] (raw L+R re, mixed
// L-R re/im with halo_a = nn_a - 4; mixed RDS re/im with halo_r = nn_r -
// 8); taps reversed; outputs lpr, lmr_re, lmr_im [C, N/4], rds_re, rds_im
// [C, N/8] (16-byte aligned), pow [C], scratch pow_part [C, N/1024], new
// mixed tails.  Filters outside the halos (fmt_extract_route 0) are
// refused.
extern "C" int fmt_extract(
    const void* xr, const void* xi, const void* dt, int iq_i16, int dt_i16,
    const float* off, const float* t_lpr, const float* t_lmr_re,
    const float* t_lmr_im, int halo_a, const float* t_rds_re,
    const float* t_rds_im, int halo_r, const float* wa_rev,
    const float* wm_rev, int nn_a, const float* wr_rev, int nn_r,
    int channels, int n, float* lpr, float* lmr_re, float* lmr_im,
    float* rds_re, float* rds_im, float* pow_part, float* pow,
    float* o_lmr_re, float* o_lmr_im, float* o_rds_re, float* o_rds_im,
    cudaStream_t stream) {
  if (n % kExtTile != 0 || extract_route(nn_a, nn_r) != kExtBlocked ||
      halo_a != nn_a - 4 || halo_r != nn_r - 8 || (dt_i16 && !iq_i16) ||
      ((uintptr_t)lpr | (uintptr_t)lmr_re | (uintptr_t)lmr_im |
       (uintptr_t)rds_re | (uintptr_t)rds_im) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = n / kExtTile;
  const dim3 grid(n_tiles, channels);
  const bool built = nn_a == kExtTaps && nn_r == kExtTaps;
#define FMT_EXTRACT_LAUNCH(TX, TD)                                          \
  {                                                                         \
    const ExtArgs<TX, TD> a{                                                \
        (const TX*)xr, (const TX*)xi, (const TD*)dt, n, off, t_lpr,         \
        t_lmr_re, t_lmr_im, t_rds_re, t_rds_im, wa_rev, wm_rev, wr_rev,    \
        lpr, lmr_re, lmr_im, rds_re, rds_im, pow_part, o_lmr_re, o_lmr_im, \
        o_rds_re, o_rds_im};                                                \
    if (built)                                                              \
      extract_blocked_kernel<TX, TD><<<grid, kExtThreads, 0, stream>>>(a); \
    else                                                                    \
      extract_blocked_any_kernel<TX, TD>                                   \
          <<<grid, kExtThreads, 0, stream>>>(a, nn_a, nn_r);               \
  }
  if (dt_i16) {
    FMT_EXTRACT_LAUNCH(int16_t, int16_t)
  } else if (iq_i16) {
    FMT_EXTRACT_LAUNCH(int16_t, float)
  } else {
    FMT_EXTRACT_LAUNCH(float, float)
  }
#undef FMT_EXTRACT_LAUNCH
  FMT_CHECK_LAUNCH();
  extract_pow_kernel<<<blocks_for(channels), kThreads, 0, stream>>>(
      pow_part, n_tiles, channels, pow);
  FMT_CHECK_LAUNCH();
  return 0;
}

// the route fmt_extract takes for filters of nn_a (L+R, L-R) and nn_r
// (RDS) taps: 1 the blocked kernels, 0 refused (outside the halos)
extern "C" int fmt_extract_route(int nn_a, int nn_r) {
  return extract_route(nn_a, nn_r);
}
