// Full-chain megakernel: ds x4 + discriminator + ds x2 + de-emphasis +
// Hilbert + peak IIR + pilot PLL + L+R / L-R / RDS extraction in one
// kernel, one pass over the baseband, on Hopper.
//
// Replaces fm_radio_tpu/kernels/chain_pallas.py::_chain_kernel (:74, entry
// kernels _chain_kernel_packed :221 and _chain_kernel_planes :231, wrapper
// demod_chain_pallas :253-462): baseband [C, B] as packed u8 words or
// float32 (re, im) planes -> audio lpr, (lmr_re, lmr_im) [C, B/32] and
// (rds_re, rds_im) [C, B/64], plus the carried state of every stage and
// the pilot power sum.  K1 is the exact float32 ds x4 (never int8 taps, as
// chain_pallas.py:294-297 takes the float band); the RDS power is not
// summed (the megakernel's route runs the unfused RDS AGC,
// demod.py:576-609).
//
// Every per-sample formula is the split path's device code, shared through
// headers: the loads and the float ds x4 sum (frontend_stages.cuh), the
// discriminator, de-emphasis and peak IIR steps (k12_stages.cuh), the PLL
// step (pll_step.cuh), the mix and the five FIRs (extract_stages.cuh).
// Each output sums its window in the same order as the split kernels, the
// serial stages run their steps in time order across the tiles, and the
// pilot power is summed in double in time order, as k12_peak_rec_kernel
// sums it: so the chain equals the split path with float taps (K1 -> K2 ->
// PLL -> extract) bit for bit, outputs and state.
//
// Design.  One launch per block; each CTA owns kChCh = 4 channels (half
// the gate's channel multiple of 8, chain_pallas.py:237-250) and walks the
// block's time tiles of kChT = 512 baseband samples in order.  A tile's
// working set lives in shared memory: the input window with the ds x4
// halo, theta1, fm_demod and fm_out with their FIR halos, the pilot IIR
// outputs, theta, dt, and six planes (the analytic re and im, the mixed
// L-R and RDS pairs) with the extraction halos.  Every halo region is kChH
// = 128 samples (the tap bounds of demod.py:315-320), filled from the
// carried state before the first tile and slid along after each tile, so
// only the input, the five output planes and the state touch device
// memory.  The parallel stages spread over the CTA's 128 threads; the
// serial ones (de-emphasis, peak IIR, PLL) run one thread per channel, as
// the split kernels do, with their state in that thread's registers from
// tile to tile.
//
// The H100 redesign (before it: 13.222 ms at the 2048 x 131,072 chain
// cell, of which ~4.2 ms ds x4 and ~3.6 ms the extract FIRs, each
// multiply-add reading shared memory with a warp's threads at bases 4 and
// 8 apart, its taps by __ldg; probes/chain_phases.py; NVIDIA H100 80GB
// HBM3, 700.00 W).  At the receiver's orders (ds x4 kChDs4Taps = 64 taps,
// the extract filters kExtTaps = 128) those two stages run the split
// kernels' register-blocked code, extract_stages.cuh::fir_block, in the
// same tap order as fir_dot (K1 sums its tile so too), so the outputs stay
// bit-equal:
// - the input window is staged skewed (mid_skew), each plane kChInS
//   floats apart (16 mod 32: a warp's two channel planes on distinct
//   banks), by float4 fetches all in flight before the first store; ds x4
//   is fir_block<4, 8, 64, 68>, a warp two channel planes of one of re and
//   im (16 lanes of 8 outputs each), as frontend.cu::k1_tile_kernel; the
//   re sums go to theta1's buffer and the im sums to fm_demod's, and one
//   pass takes atan2 in place;
// - the six planes are stored skewed, each channel kChPlS floats apart (2
//   mod 32), the planes in the slot order ch_slot (8 banks apart); two
//   warps run the five FIRs, two lanes a channel plane:
//   fir_block<4, 8, 128, 4> for L+R and L-R, fir_block<8, 4, 128, 8> for
//   RDS (extract.cu's blocked route), float4 stores.
// At every other order chain_any_kernel runs the same tile with those two
// stages on extract_stages.cuh::fir_block_any (the order at run time,
// the same tap order): the input window staged as K1's tile stages it
// (sample t0 - h1 at index 4, so ds x4's B0 is 4 at every order) and each
// extraction plane shifted by its filter's order (ch_shift), so every
// load of the loop is a constant offset as at the receiver's orders.  The
// ds x2 and Hilbert stages sum each output by itself (fir_dot) at every
// order.
//
// Two tries (NVIDIA H100 80GB HBM3, 700.00 W).  The first kept 8
// channels and 256 threads a CTA: 107,776 bytes of shared memory, two
// CTAs an SM, 5.930 ms at the chain cell (chip_smoke.py; 13.222 before).
// Its serial stages, hidden before behind the slow parallel ones, then
// held ~1.7 ms of it (probes/chain_phases.py: 5.88-6.01 whole, 4.30
// without them).  This one halves the CTA: 54,784 bytes and 128 threads,
// four CTAs an SM (with the 1 KB each reserves, 223,232 of the SM's
// 233,472 bytes; 128 registers a thread), so while one CTA runs a serial
// stage three others can run parallel ones: 5.74-5.89 whole, 4.51 without
// them (the same probe).  Each CTA still walks all of the block's tiles
// in order, so the chains add to its own timeline; hiding them needs the
// next tile's parallel stages run beside them.  PERF.md section 6, row
// 11, holds the final run's times.
//
// Shared memory: 13,696 floats, most of it the input window (2 x 4 x 688)
// and the six extraction planes (6 x 4 x 226); the IIR outputs, theta, dt
// and the slide's staging overlay the input window once ds x4 has read
// it.  chain_any_kernel stages room for the longest taps every halo
// admits, 13,780 floats (55,120 bytes: still four CTAs an SM).  At C =
// 2048 the 512 CTAs run in one wave on the 132 SMs.  Built with
// -fmad=false, like every kernel here.

#include "extract_stages.cuh"
#include "frontend_stages.cuh"
#include "k12_stages.cuh"
#include "pll_step.cuh"

namespace fmt {

constexpr int kChT = 512;                // baseband samples per tile
constexpr int kChN4 = kChT / 4;          // fm_demod samples per tile
constexpr int kChN8 = kChT / 8;          // fm_out, theta, dt per tile
constexpr int kChNA = kChT / 32;         // audio outputs per tile
constexpr int kChNR = kChT / 64;         // RDS outputs per tile
constexpr int kChH = 128;                // halo room of every buffer
constexpr int kChCh = 4;                 // channels per CTA
constexpr int kChThreads = 128;
constexpr int kChIn = kChH + kChT;       // one input plane's window
constexpr int kChFmd = kChH + kChN4;
constexpr int kChFo = kChH + kChN8;
constexpr int kChPl = kChH + kChN8;
constexpr int kChPlanes = 6;             // re, im, lmr re, lmr im, rds re, rds im
constexpr int kChDs4Taps = 64;           // the receiver's ds x4 order
// skewed strides: an input plane (16 mod 32), an extraction plane's
// channel (2 mod 32) and plane (4 channels: 8 mod 32)
constexpr int kChInS = 688;
constexpr int kChPlS = 226;
constexpr int kChPlB = kChCh * kChPlS;
constexpr int kChU = 2 * kChCh * kChInS;  // the input window's floats
// the staged taps: the receiver's orders (chain_kernel), and room for the
// longest every halo admits (chain_any_kernel: ds x4, L+R and L-R kChH + 4,
// RDS kChH + 8; each a multiple of 4, so every filter's taps start
// 16-byte aligned)
constexpr int kChTaps = kChDs4Taps + 3 * kExtTaps;
constexpr int kChTapsAny = 3 * (kChH + 4) + kChH + 8;
template <bool kAny>
constexpr int kChSmemFloats = kChU + kChCh * kChN4 + 4 * kChCh
                              + kChCh * kChFmd + kChCh * kChFo
                              + kChPlanes * kChPlB
                              + (kAny ? kChTapsAny : kChTaps);
static_assert(kChInS >= mid_skew(kChH + 4 + kChT - 1) + 1 &&
                  kChInS >= mid_skew(kChIn - 1) + 1 && kChInS % 32 == 16,
              "input planes skewed (at any order sample t0 - h1 at index 4),"
              " a warp's two on distinct banks");
static_assert(kChPlS >= mid_skew(kChPl - 1 + 8) + 1 && kChPlS % 32 == 2 &&
                  kChPlB % 32 == 8,
              "extraction planes skewed (shifted up to 8 samples at any "
              "order), a warp's lanes on distinct banks");
static_assert(kChN4 >= kChH, "fm_demod slides without overlap");
static_assert(4 * kChCh * kChN8 <= kChU, "IIR outputs overlay the window");
static_assert((1 + kChPlanes) * kChCh * kChH <= kChU,
              "the slide's staging overlays the window");
static_assert(kChCh <= kChThreads, "one serial thread per channel");
static_assert(2 * kChCh * kChN4 / 8 == kChThreads,
              "the blocked ds x4: 8 outputs a thread");
static_assert(kChNA == 2 * 8 && kChNR == 2 * 4,
              "the blocked FIRs: two lanes a channel plane");
static_assert(kChH % 32 == 0, "halos of whole bank rows");

// where plane p (re, im, lmr re, lmr im, rds re, rds im) lies: the planes
// one extraction warp reads (lpr, lmr re and im; rds re and im) in
// neighbouring slots, 8 banks apart
__host__ __device__ constexpr int ch_slot(int p) {
  return p == 0 ? 0 : p == 1 ? 5 : p - 1;
}

// An extraction plane at any order, for its FIR of nn taps (decimation M):
// output j's window starts at sample kChH + M - nn + M j of the plane, so
// the plane is stored shifted by ch_shift(nn) = nn - 32 ch_rows(nn)
// (sample i at mid_skew(i + shift)), which puts it at M + 32 (kChH / 32 -
// ch_rows(nn)) + M j: fir_block_any's B0 = M from the pointer 33
// (kChH / 32 - ch_rows(nn) + lane) words into the plane, every load a
// constant offset.  The shift lies in (-32, 0] up to 128 taps (the
// window's first sample then at index >= M), 1 .. 8 above: no sample of a
// window leaves the plane's kChPlS words.
__host__ __device__ constexpr int ch_rows(int nn) {
  return (nn + 31) / 32 < kChH / 32 ? (nn + 31) / 32 : kChH / 32;
}
__host__ __device__ constexpr int ch_shift(int nn) {
  return nn - 32 * ch_rows(nn);
}

struct ChainArgs {
  int channels, b;
  // K1: tail1 [2, C, nn1 - 4] (re rows, then im rows), w1 [nn1] reversed
  const float* tail1;
  const float* w1;
  int nn1;
  const float* prev_theta;
  float scale;
  // K2: tails [C, nn2 - 2] and [C, nh - 1]; de [C, 2]; pk [C, 8]
  const float* w2;
  int nn2;
  const float* tail2;
  int use_deemph;
  float de_b0, de_b1, de_a1;
  const float* de_in;
  float* de_out;
  const float* wh;
  int nh;
  const float* htail;
  float pk_b0, pk_b1, pk_b2, pk_a1, pk_a2;
  const float* pk_in;
  float* pk_out;
  // PLL: [5, C]
  const float* pll_in;
  float* pll_out;
  PllConsts pll;
  // extract: off [C]; plane tails [C, h] with h = nn_a - 4 for the first
  // four planes and nn_r - 8 for the RDS pair
  const float* off;
  const float* t_ext[kChPlanes];
  const float *wa, *wm;
  int nn_a;
  const float* wr;
  int nn_r;
  // outputs
  float *lpr, *lmr_re, *lmr_im, *rds_re, *rds_im;
  float *prev_out, *tail2_out, *htail_out, *power;
  float* o_ext[kChPlanes];
};

// Phase 2a's sums: warp w takes channel planes 2w and 2w + 1 (re for w <
// 2), 16 lanes of 8 outputs each; the re sums go to theta1's buffer, the im
// sums to fm_demod's (free until the discriminator).  At the receiver's
// order the window's sample t0 - 64 lies at index kChH - 64 (B0 = kChH -
// 60), at any order sample t0 - h1 at index 4 (B0 = 4, K1's layout)
template <bool kAny>
__device__ __forceinline__ void ch_ds4(const float* s_in, const float* s_w1,
                                       int nn1, float* s_th1, float* s_fmd,
                                       int warp, int lane) {
  const int cp = 2 * warp + lane / 16, ch = cp % kChCh, l = lane % 16;
  float acc[8];
  if constexpr (kAny)
    fir_block_any<4, 8, 4>(s_in + cp * kChInS + 33 * l, s_w1, nn1, acc);
  else
    fir_block<4, 8, kChDs4Taps, kChH - (kChDs4Taps - 4)>(s_in + cp * kChInS,
                                                         l, s_w1, acc);
  float* dst = (cp < kChCh ? s_th1 + ch * kChN4
                           : s_fmd + ch * kChFmd + kChH) + 8 * l;
  *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2],
                                                acc[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[4], acc[5], acc[6],
                                                    acc[7]);
}

// Phase 11's sums, the five decimating FIRs into the output planes: warp
// 0 lpr, L-R re and im (lanes 0-7, 8-15, 16-23), warp 1 RDS re and im
// (lanes 0-7, 8-15), two lanes (li) a channel (ch), 8 audio or 4 RDS
// outputs a lane, float4 stores; at any order over the shifted planes
// (ch_shift)
template <bool kAny>
__device__ __forceinline__ void ch_ext_firs(const float* s_pl,
                                            const float* s_wa,
                                            const float* s_wm,
                                            const float* s_wr,
                                            const ChainArgs& a, int c0,
                                            int tile, int warp, int lane) {
  const int q = lane / 8, ch = (lane % 8) / 2, li = lane % 2;
  const int p = warp == 0 ? (q == 0 ? 0 : q + 1) : 4 + q;
  const int64_t c = c0 + ch;
  const int nc = a.channels;
  const float* x = s_pl + ch_slot(p) * kChPlB + ch * kChPlS;
  if (warp == 0 && q < 3) {
    const float* w = p == 0 ? s_wa : s_wm;
    float acc[8];
    if constexpr (kAny)
      fir_block_any<4, 8, 4>(x + 33 * (kChH / 32 - ch_rows(a.nn_a) + li), w,
                             a.nn_a, acc);
    else
      fir_block<4, 8, kExtTaps, kChH - (kExtTaps - 4)>(x, li, w, acc);
    float* y = p == 0 ? a.lpr : p == 2 ? a.lmr_re : a.lmr_im;
    const int64_t n = (int64_t)nc * (a.b / 32);
    float* o = FMT_SPAN(y, c * (a.b / 32) + tile * kChNA + 8 * li, 8, n);
    *reinterpret_cast<float4*>(o) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(o + 4) =
        make_float4(acc[4], acc[5], acc[6], acc[7]);
  } else if (warp == 1 && q < 2) {
    float acc[4];
    if constexpr (kAny)
      fir_block_any<8, 4, 8>(x + 33 * (kChH / 32 - ch_rows(a.nn_r) + li),
                             s_wr, a.nn_r, acc);
    else
      fir_block<8, 4, kExtTaps, kChH - (kExtTaps - 8)>(x, li, s_wr, acc);
    float* y = p == 4 ? a.rds_re : a.rds_im;
    const int64_t n = (int64_t)nc * (a.b / 64);
    *reinterpret_cast<float4*>(
        FMT_SPAN(y, c * (a.b / 64) + tile * kChNR + 4 * li, 4, n)) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

// One CTA's channels through the block, kAny: the ds x4 and extract
// orders known only at run time (chain_any_kernel), else the receiver's
// (chain_kernel)
template <bool kAny, class Load>
__device__ __forceinline__ void chain_body(Load in, const ChainArgs& a) {
  extern __shared__ __align__(16) float sm[];
  float* s_in = sm;                       // [2][kChCh][kChInS], skewed
  float* s_yr = sm;                       // [kChCh][kChN8], after ds x4
  float* s_yi = s_yr + kChCh * kChN8;
  float* s_th = s_yi + kChCh * kChN8;
  float* s_dt = s_th + kChCh * kChN8;
  float* s_tmp = sm;                      // [7][kChCh][kChH], the slide
  float* s_th1 = sm + kChU;               // [kChCh][kChN4]
  float* s_prev = s_th1 + kChCh * kChN4;  // [kChCh] discriminator phase
  float* s_co = s_prev + kChCh;           // [kChCh] L-R offset phasor
  float* s_so = s_co + kChCh;
  float* s_fmd = s_prev + 4 * kChCh;      // [kChCh][kChFmd]
  float* s_fo = s_fmd + kChCh * kChFmd;   // [kChCh][kChFo]
  float* s_pl = s_fo + kChCh * kChFo;     // [slot][kChCh][kChPlS], skewed
  float* s_w1 = s_pl + kChPlanes * kChPlB;  // the blocked FIRs' taps
  float* s_wa = s_w1 + (kAny ? kChH + 4 : kChDs4Taps);
  float* s_wm = s_wa + (kAny ? kChH + 4 : kExtTaps);
  float* s_wr = s_wm + (kAny ? kChH + 4 : kExtTaps);

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kChCh;
  const int nc = a.channels;
  const int h1 = a.nn1 - 4, h2 = a.nn2 - 2, hh = a.nh - 1;
  const int hd = (a.nh - 1) / 2;  // the Hilbert delay of the re plane
  const int ha = a.nn_a - 4, hr = a.nn_r - 8;
  // the extraction planes' shifts (0 at the receiver's orders)
  const int sa = kAny ? ch_shift(a.nn_a) : 0;
  const int sr = kAny ? ch_shift(a.nn_r) : 0;
  // sample i (i < kChPl) of plane p of channel ch
  auto pl = [&](int p, int ch, int i) -> float& {
    return s_pl[ch_slot(p) * kChPlB + ch * kChPlS +
                mid_skew(i + (p < 4 ? sa : sr))];
  };

  // ---- the carried tails into the halos (samples -kChH .. -1) ----------
  for (int e = tid; e < kChCh * kChH; e += kChThreads) {
    const int ch = e / kChH, k = e % kChH, n = k - kChH;
    const int64_t c = c0 + ch;
    s_fmd[ch * kChFmd + k] =
        n >= -h2 ? FMT_AT(a.tail2, c * h2 + h2 + n, nc * h2) : 0.0f;
    s_fo[ch * kChFo + k] =
        n >= -hh ? FMT_AT(a.htail, c * hh + hh + n, nc * hh) : 0.0f;
    for (int p = 0; p < kChPlanes; ++p) {
      const int h = p < 4 ? ha : hr;
      // a shifted plane holds the window's samples only
      if (!kAny || n >= -h)
        pl(p, ch, k) = n >= -h ? FMT_AT(a.t_ext[p], c * h + h + n, nc * h)
                               : 0.0f;
    }
  }
  if constexpr (kAny) {
    for (int k = tid; k < a.nn1; k += kChThreads)
      s_w1[k] = FMT_AT(a.w1, k, a.nn1);
    for (int k = tid; k < a.nn_a; k += kChThreads) {
      s_wa[k] = FMT_AT(a.wa, k, a.nn_a);
      s_wm[k] = FMT_AT(a.wm, k, a.nn_a);
    }
    for (int k = tid; k < a.nn_r; k += kChThreads)
      s_wr[k] = FMT_AT(a.wr, k, a.nn_r);
  } else {
    for (int k = tid; k < kChDs4Taps; k += kChThreads)
      s_w1[k] = FMT_AT(a.w1, k, kChDs4Taps);
    for (int k = tid; k < kExtTaps; k += kChThreads) {
      s_wa[k] = FMT_AT(a.wa, k, kExtTaps);
      s_wm[k] = FMT_AT(a.wm, k, kExtTaps);
      s_wr[k] = FMT_AT(a.wr, k, kExtTaps);
    }
  }
  // serial state, in the registers of thread ch < kChCh
  float de_x1 = 0.0f, de_y1 = 0.0f;
  Peak2 pr{}, pi{};
  double pw = 0.0;
  PllState ps{};
  if (tid < kChCh) {
    const int c = c0 + tid;
    s_prev[tid] = FMT_AT(a.prev_theta, c, nc);
    offset_phasor(FMT_AT(a.off, c, nc), s_co[tid], s_so[tid]);
    de_x1 = FMT_AT(a.de_in, 2 * c, 2 * nc);
    de_y1 = FMT_AT(a.de_in, 2 * c + 1, 2 * nc);
    const float* s = &FMT_AT(a.pk_in, 8 * c, 8 * nc);
    pr = {s[0], s[1], s[2], s[3]};
    pi = {s[4], s[5], s[6], s[7]};
    ps = pll_load(a.pll_in, nc, c);
  }
  __syncthreads();

  const int n_tiles = a.b / kChT;
  const int win = h1 + kChT;
  const int warp = tid / 32, lane = tid % 32;
  // the plane index of sample t0 of the input window: kChH at the
  // receiver's order, nn1 at any (sample t0 - h1 at index 4)
  const int i_t0 = kAny ? a.nn1 : kChH;
  // the first sample a tile fetches whole: t0 - 64 at the receiver's
  // order (one float4 before its halo), t0 - h1 at any (h1 % 4 == 0)
  const int g0 = kAny ? h1 : kChDs4Taps;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * kChT;
    // 1. the input window [t0 - h1, t0 + kChT) as centred (re, im), sample
    // g at index mid_skew(i_t0 + g - t0) of its plane
    if (t0 >= g0) {
      // samples t0 - g0 .. t0 + kChT - 1 as float4 fetches, all in flight
      const int n_g = (g0 + kChT) / 4;  // fetches a channel
      constexpr int kN = (kChCh * (kChH + kChT) / 4 + kChThreads - 1) /
                         kChThreads;
      typename Load::Raw raw[kN];
#pragma unroll
      for (int u = 0; u < kN; ++u) {
        const int e = tid + u * kChThreads;
        if (e < kChCh * n_g)
          raw[u] = in.fetch((int64_t)(c0 + e / n_g) * a.b,
                            t0 - g0 + 4 * (e % n_g));
      }
#pragma unroll
      for (int u = 0; u < kN; ++u) {
        const int e = tid + u * kChThreads;
        if (e < kChCh * n_g) {
          const int ch = e / n_g, j0 = i_t0 - g0 + 4 * (e % n_g);
          float r[4], i[4];
          Load::unpack(raw[u], r, i);
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            s_in[ch * kChInS + mid_skew(j0 + v)] = r[v];
            s_in[(kChCh + ch) * kChInS + mid_skew(j0 + v)] = i[v];
          }
        }
      }
    } else {
      for (int e = tid; e < kChCh * win; e += kChThreads) {
        const int ch = e / win, j = e % win;
        const int64_t c = c0 + ch;
        const int g = t0 - h1 + j;
        float vr, vi;
        if (g < 0) {
          vr = FMT_AT(a.tail1, c * h1 + h1 + g, nc * h1);
          vi = FMT_AT(a.tail1, (nc + c) * h1 + h1 + g, 2 * nc * h1);
        } else {
#ifdef FMT_CHECKED
          FMT_AT(in.x, c * a.b + g, (int64_t)nc * a.b);
#endif
          in.load(c * a.b, g, vr, vi);
        }
        s_in[ch * kChInS + mid_skew(i_t0 - h1 + j)] = vr;
        s_in[(kChCh + ch) * kChInS + mid_skew(i_t0 - h1 + j)] = vi;
      }
    }
    __syncthreads();
    // 2a. ds x4: the re sums into theta1's buffer, the im sums into
    // fm_demod's
    ch_ds4<kAny>(s_in, s_w1, a.nn1, s_th1, s_fmd, warp, lane);
    __syncthreads();
    // 2b. atan2 -> theta1, in place
    for (int e = tid; e < kChCh * kChN4; e += kChThreads) {
      const int ch = e / kChN4, j = e % kChN4;
      s_th1[e] = atan2_poly(s_fmd[ch * kChFmd + kChH + j], s_th1[e]);
    }
    __syncthreads();
    // 3. discriminator -> fm_demod
    for (int e = tid; e < kChCh * kChN4; e += kChThreads) {
      const int ch = e / kChN4, j = e % kChN4;
      const float prev = j == 0 ? s_prev[ch] : s_th1[e - 1];
      s_fmd[ch * kChFmd + kChH + j] = disc_value(s_th1[e], prev, a.scale);
    }
    __syncthreads();
    // 4. ds x2 -> fm_out
    for (int e = tid; e < kChCh * kChN8; e += kChThreads) {
      const int ch = e / kChN8, i = e % kChN8;
      s_fo[ch * kChFo + kChH + i] =
          fir_dot(s_fmd + ch * kChFmd + kChH + 2 * i - h2, a.w2, a.nn2);
    }
    __syncthreads();
    // 5. serial: the discriminator's carried phase; de-emphasis in place
    if (tid < kChCh) {
      s_prev[tid] = s_th1[tid * kChN4 + kChN4 - 1];
      if (a.use_deemph) {
        float* f = s_fo + tid * kChFo + kChH;
        for (int i = 0; i < kChN8; ++i)
          f[i] = deemph_step(de_x1, de_y1, f[i], a.de_b0, a.de_b1, a.de_a1);
      }
    }
    __syncthreads();
    // 6. Hilbert -> the analytic re (delayed fm_out) and im planes
    for (int e = tid; e < kChCh * kChN8; e += kChThreads) {
      const int ch = e / kChN8, i = e % kChN8;
      const float* f = s_fo + ch * kChFo + kChH;
      pl(1, ch, kChH + i) = fir_dot(f + i - hh, a.wh, a.nh);
      pl(0, ch, kChH + i) = f[i - hd];
    }
    __syncthreads();
    // 7. serial: the pilot peak IIR on both planes; power in double
    if (tid < kChCh) {
      for (int i = 0; i < kChN8; ++i) {
        const float yr = peak_step(pr, pl(0, tid, kChH + i), a.pk_b0,
                                   a.pk_b1, a.pk_b2, a.pk_a1, a.pk_a2);
        const float yi = peak_step(pi, pl(1, tid, kChH + i), a.pk_b0,
                                   a.pk_b1, a.pk_b2, a.pk_a1, a.pk_a2);
        s_yr[tid * kChN8 + i] = yr;
        s_yi[tid * kChN8 + i] = yi;
        pw += (double)(yr * yr + yi * yi);
      }
    }
    __syncthreads();
    // 8. pilot phase theta (cycles)
    for (int e = tid; e < kChCh * kChN8; e += kChThreads)
      s_th[e] = atan2_poly(s_yi[e], s_yr[e]) * kInvTwoPi;
    __syncthreads();
    // 9. serial: the PLL -> dt
    if (tid < kChCh) {
      for (int i = 0; i < kChN8; ++i)
        s_dt[tid * kChN8 + i] = pll_step(ps, a.pll, s_th[tid * kChN8 + i]);
    }
    __syncthreads();
    // 10. the harmonic mixes -> the L-R and RDS planes
    for (int e = tid; e < kChCh * kChN8; e += kChThreads) {
      const int ch = e / kChN8, i = kChH + e % kChN8;
      mix_sample(pl(0, ch, i), pl(1, ch, i), s_dt[e], s_co[ch], s_so[ch],
                 pl(2, ch, i), pl(3, ch, i), pl(4, ch, i), pl(5, ch, i));
    }
    __syncthreads();
    // 11. the five decimating FIRs -> the output planes
    ch_ext_firs<kAny>(s_pl, s_wa, s_wm, s_wr, a, c0, tile, warp, lane);
    __syncthreads();
    // 12. slide: each buffer's last kChH samples become the next halo (at
    // any order a plane's window samples only)
    for (int e = tid; e < kChCh * kChH; e += kChThreads) {
      const int ch = e / kChH, k = e % kChH;
      s_fmd[ch * kChFmd + k] = s_fmd[ch * kChFmd + kChN4 + k];
      s_tmp[ch * kChH + k] = s_fo[ch * kChFo + kChN8 + k];
      for (int p = 0; p < kChPlanes; ++p)
        s_tmp[((1 + p) * kChCh + ch) * kChH + k] = pl(p, ch, kChN8 + k);
    }
    __syncthreads();
    for (int e = tid; e < kChCh * kChH; e += kChThreads) {
      const int ch = e / kChH, k = e % kChH;
      s_fo[ch * kChFo + k] = s_tmp[ch * kChH + k];
      for (int p = 0; p < kChPlanes; ++p)
        if (!kAny || k >= kChH - (p < 4 ? ha : hr))
          pl(p, ch, k) = s_tmp[((1 + p) * kChCh + ch) * kChH + k];
    }
    __syncthreads();
  }

  // ---- carried-out state: the halos now hold each buffer's last samples
  for (int e = tid; e < kChCh * kChH; e += kChThreads) {
    const int ch = e / kChH, k = e % kChH, n = k - kChH;
    const int64_t c = c0 + ch;
    if (n >= -h2)
      FMT_AT(a.tail2_out, c * h2 + h2 + n, nc * h2) = s_fmd[ch * kChFmd + k];
    if (n >= -hh)
      FMT_AT(a.htail_out, c * hh + hh + n, nc * hh) = s_fo[ch * kChFo + k];
    for (int p = 0; p < kChPlanes; ++p) {
      const int h = p < 4 ? ha : hr;
      if (n >= -h) FMT_AT(a.o_ext[p], c * h + h + n, nc * h) = pl(p, ch, k);
    }
  }
  if (tid < kChCh) {
    const int c = c0 + tid;
    FMT_AT(a.prev_out, c, nc) = s_prev[tid];
    FMT_AT(a.de_out, 2 * c, 2 * nc) = de_x1;
    FMT_AT(a.de_out, 2 * c + 1, 2 * nc) = de_y1;
    float* s = FMT_SPAN(a.pk_out, 8 * c, 8, 8 * nc);
    s[0] = pr.x1; s[1] = pr.x2; s[2] = pr.y1; s[3] = pr.y2;
    s[4] = pi.x1; s[5] = pi.x2; s[6] = pi.y1; s[7] = pi.y2;
    FMT_AT(a.power, c, nc) = (float)pw;
    pll_store(ps, a.pll_out, nc, c);
  }
}

// the receiver's orders (ds x4 kChDs4Taps, extract kExtTaps) and every
// other, each a function of its own, which a profile tells apart
template <class Load>
__global__ void __launch_bounds__(kChThreads, 4)
    chain_kernel(Load in, ChainArgs a) {
  chain_body<false>(in, a);
}

template <class Load>
__global__ void __launch_bounds__(kChThreads, 4)
    chain_any_kernel(Load in, ChainArgs a) {
  chain_body<true>(in, a);
}

template <class Load>
int launch_chain(Load in, const ChainArgs& a, cudaStream_t stream) {
  const bool receiver = a.nn1 == kChDs4Taps && a.nn_a == kExtTaps &&
                        a.nn_r == kExtTaps;
  void (*kernel)(Load, ChainArgs) =
      receiver ? chain_kernel<Load> : chain_any_kernel<Load>;
  const int bytes = (receiver ? kChSmemFloats<false> : kChSmemFloats<true>) *
                    (int)sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<a.channels / kChCh, kChThreads, bytes, stream>>>(in, a);
  FMT_CHECK_LAUNCH();
  return 0;
}

}  // namespace fmt

using namespace fmt;

// x: float32 planes [2, C, B] (form 0) or packed u8 words [C, B] float32
// (form 1).  K1: tail1 [2, C, nn1 - 4], w1_rev [nn1], prev_theta [C] and
// the discriminator scale.  K2: the run of arguments fmt_midend takes from
// w2_rev to pk_out.  PLL: [5, C] state rows and the loop constants.
// Extract: off [C]; the carried planes (lpr re/im = ds_audio_lpr, lmr
// re/im = ds_audio_lmr, [C, nn_a - 4]; rds re/im = ds_rds, [C, nn_r - 8]);
// reversed taps.  Outputs lpr, lmr_re, lmr_im [C, B/32]; rds_re, rds_im
// [C, B/64]; prev_out [C]; tail2_out, htail_out and the six planes' tails
// as their inputs; power [C].  C % 8 == 0, B % 512 == 0, nn1 % 4 == 0, and
// every filter reaches at most 128 samples back (nn1 - 4, nn2 - 2, nh - 1,
// nn_a - 4, nn_r - 8 <= 128).  Returns the launch's cudaError_t (0 =
// launched).
extern "C" int fmt_chain(
    const void* x, int form, int channels, int b, const float* tail1,
    const float* w1_rev, int nn1, const float* prev_theta, float scale,
    const float* w2_rev, int nn2, const float* tail2, int use_deemph,
    float de_b0, float de_b1, float de_a1, const float* de_in, float* de_out,
    const float* wh_rev, int nh, const float* htail, float pk_b0,
    float pk_b1, float pk_b2, float pk_a1, float pk_a2, const float* pk_in,
    float* pk_out, const float* pll_in, float* pll_out, float ts,
    float f_center, float f_gain, float ki_ts, float kp, float b0, float a1,
    const float* off, const float* t_lpr_re, const float* t_lpr_im,
    const float* t_lmr_re, const float* t_lmr_im, const float* t_rds_re,
    const float* t_rds_im, const float* wa_rev, const float* wm_rev,
    int nn_a, const float* wr_rev, int nn_r, float* lpr, float* lmr_re,
    float* lmr_im, float* rds_re, float* rds_im, float* prev_out,
    float* tail2_out, float* htail_out, float* power, float* o_lpr_re,
    float* o_lpr_im, float* o_lmr_re, float* o_lmr_im, float* o_rds_re,
    float* o_rds_im, cudaStream_t stream) {
  const bool bad_halo = nn1 < 4 || nn1 - 4 > kChH || nn1 % 4 != 0 ||
                        nn2 < 2 ||
                        nn2 - 2 > kChH || nh < 1 || nh - 1 > kChH ||
                        nn_a < 4 || nn_a - 4 > kChH || nn_r < 8 ||
                        nn_r - 8 > kChH;
  if (form < 0 || form > 1 || channels % kChCh != 0 || channels <= 0 ||
      b % kChT != 0 || b <= 0 || bad_halo)
    return (int)cudaErrorInvalidValue;
  ChainArgs a{};
  a.channels = channels;
  a.b = b;
  a.tail1 = tail1;
  a.w1 = w1_rev;
  a.nn1 = nn1;
  a.prev_theta = prev_theta;
  a.scale = scale;
  a.w2 = w2_rev;
  a.nn2 = nn2;
  a.tail2 = tail2;
  a.use_deemph = use_deemph;
  a.de_b0 = de_b0;
  a.de_b1 = de_b1;
  a.de_a1 = de_a1;
  a.de_in = de_in;
  a.de_out = de_out;
  a.wh = wh_rev;
  a.nh = nh;
  a.htail = htail;
  a.pk_b0 = pk_b0;
  a.pk_b1 = pk_b1;
  a.pk_b2 = pk_b2;
  a.pk_a1 = pk_a1;
  a.pk_a2 = pk_a2;
  a.pk_in = pk_in;
  a.pk_out = pk_out;
  a.pll_in = pll_in;
  a.pll_out = pll_out;
  a.pll = {ts, f_center, f_gain, ki_ts, kp, b0, a1};
  a.off = off;
  const float* t_ext[kChPlanes] = {t_lpr_re, t_lpr_im, t_lmr_re,
                                   t_lmr_im, t_rds_re, t_rds_im};
  float* o_ext[kChPlanes] = {o_lpr_re, o_lpr_im, o_lmr_re,
                             o_lmr_im, o_rds_re, o_rds_im};
  for (int p = 0; p < kChPlanes; ++p) {
    a.t_ext[p] = t_ext[p];
    a.o_ext[p] = o_ext[p];
  }
  a.wa = wa_rev;
  a.wm = wm_rev;
  a.nn_a = nn_a;
  a.wr = wr_rev;
  a.nn_r = nn_r;
  a.lpr = lpr;
  a.lmr_re = lmr_re;
  a.lmr_im = lmr_im;
  a.rds_re = rds_re;
  a.rds_im = rds_im;
  a.prev_out = prev_out;
  a.tail2_out = tail2_out;
  a.htail_out = htail_out;
  a.power = power;
  const int64_t plane = (int64_t)channels * b;
  if (form == 0) return launch_chain(PlanesF32{(const float*)x, plane}, a, stream);
  return launch_chain(PackedWords{(const float*)x, plane}, a, stream);
}
