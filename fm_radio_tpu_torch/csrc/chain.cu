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
// pilot power is summed in double in time order, as k12_peak_kernel sums
// it: so the chain equals the split path with float taps (K1 -> K2 -> PLL
// -> extract) bit for bit, outputs and state.
//
// Design.  One launch per block; each CTA owns kChCh = 8 channels (the
// gate's channel multiple, chain_pallas.py:237-250) and walks the block's
// time tiles of kChT = 512 baseband samples in order.  A tile's working set
// lives in shared memory: the input window with the ds x4 halo, theta1,
// fm_demod and fm_out with their FIR halos, the pilot IIR outputs, theta,
// dt, and six planes (the analytic re and im, the mixed L-R and RDS pairs)
// with the extraction halos.  Every halo region is kChH = 128 samples (the
// tap bounds of demod.py:315-320), filled from the carried state before
// the first tile and slid along after each tile, so only the input, the
// five output planes and the state touch device memory.  The parallel
// stages (ds x4 + atan2, discriminator, ds x2, Hilbert, theta, mixes,
// FIRs) spread over the CTA's 256 threads; the serial ones (de-emphasis,
// peak IIR, PLL) run one thread per channel, as the split kernels do, with
// their state in that thread's registers from tile to tile.
//
// Shared memory: 24,096 floats = 96,384 bytes per CTA, most of it the
// input window (2 x 8 x 640) and the six extraction planes (6 x 8 x 192);
// the IIR outputs, theta, dt and the slide's staging overlay the input
// window once ds x4 has read it.  Two CTAs fit on an SM (228 KB), so at
// C = 2048 the 256 CTAs run in one wave on the 132 SMs: while one CTA's
// warp 0 runs a serial stage, the other CTA's threads can run a parallel
// one.  A tile of 512 keeps the halos (128 each) from dominating: at 256
// the six planes would be 5/6 halo.
//
// What bounds it on this card: not the serial stages (2 or 3 x B/8
// dependent steps per channel, ~0.9 ms of 13.4 at the 2048 x 131,072
// chain cell, mostly hidden behind the SM's other CTA) but the parallel
// ones: every multiply-add of ds x4 and of the extract FIRs reads shared
// memory, a warp's threads at bases 4 and 8 apart (bank conflicts), ~4.2
// and ~3.6 ms (probes/chain_phases.py, PERF.md).  Built with -fmad=false,
// like every kernel here.

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
constexpr int kChCh = 8;                 // channels per CTA
constexpr int kChThreads = 256;
constexpr int kChIn = kChH + kChT;       // one input plane's window
constexpr int kChFmd = kChH + kChN4;
constexpr int kChFo = kChH + kChN8;
constexpr int kChPl = kChH + kChN8;
constexpr int kChPlanes = 6;             // re, im, lmr re, lmr im, rds re, rds im
constexpr int kChU = 2 * kChCh * kChIn;  // the input window's floats
constexpr int kChSmemFloats = kChU + kChCh * kChN4 + 4 * kChCh
                              + kChCh * kChFmd + kChCh * kChFo
                              + kChPlanes * kChCh * kChPl;
static_assert(kChN4 >= kChH, "fm_demod slides without overlap");
static_assert(4 * kChCh * kChN8 <= kChU, "IIR outputs overlay the window");
static_assert((1 + kChPlanes) * kChCh * kChH <= kChU,
              "the slide's staging overlays the window");
static_assert(kChCh <= kChThreads, "one serial thread per channel");

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

template <class Load>
__global__ void __launch_bounds__(kChThreads, 2)
    chain_kernel(Load in, ChainArgs a) {
  extern __shared__ float sm[];
  float* s_in = sm;                       // [2][kChCh][kChIn]
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
  float* s_pl = s_fo + kChCh * kChFo;     // [kChPlanes][kChCh][kChPl]
  auto plane = [&](int p, int ch) { return s_pl + (p * kChCh + ch) * kChPl; };

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kChCh;
  const int nc = a.channels;
  const int h1 = a.nn1 - 4, h2 = a.nn2 - 2, hh = a.nh - 1;
  const int hd = (a.nh - 1) / 2;  // the Hilbert delay of the re plane
  const int ha = a.nn_a - 4, hr = a.nn_r - 8;

  // ---- the carried tails into the halos (samples -kChH .. -1) ----------
  for (int e = tid; e < kChCh * kChH; e += kChThreads) {
    const int ch = e / kChH, k = e % kChH, n = k - kChH;
    const int64_t c = c0 + ch;
    s_fmd[ch * kChFmd + k] = n >= -h2 ? a.tail2[c * h2 + h2 + n] : 0.0f;
    s_fo[ch * kChFo + k] = n >= -hh ? a.htail[c * hh + hh + n] : 0.0f;
    for (int p = 0; p < kChPlanes; ++p) {
      const int h = p < 4 ? ha : hr;
      plane(p, ch)[k] = n >= -h ? a.t_ext[p][c * h + h + n] : 0.0f;
    }
  }
  // serial state, in the registers of thread ch < kChCh
  float de_x1 = 0.0f, de_y1 = 0.0f;
  Peak2 pr{}, pi{};
  double pw = 0.0;
  PllState ps{};
  if (tid < kChCh) {
    const int c = c0 + tid;
    s_prev[tid] = a.prev_theta[c];
    offset_phasor(a.off[c], s_co[tid], s_so[tid]);
    de_x1 = a.de_in[2 * c];
    de_y1 = a.de_in[2 * c + 1];
    const float* s = a.pk_in + 8 * c;
    pr = {s[0], s[1], s[2], s[3]};
    pi = {s[4], s[5], s[6], s[7]};
    ps = pll_load(a.pll_in, nc, c);
  }
  __syncthreads();

  const int n_tiles = a.b / kChT;
  const int win = h1 + kChT;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * kChT;
    // 1. the input window [t0 - h1, t0 + kChT) as centred (re, im)
    for (int e = tid; e < kChCh * win; e += kChThreads) {
      const int ch = e / win, j = e % win;
      const int64_t c = c0 + ch;
      const int g = t0 - h1 + j;
      float vr, vi;
      if (g < 0) {
        vr = a.tail1[c * h1 + h1 + g];
        vi = a.tail1[(nc + c) * h1 + h1 + g];
      } else {
        in.load(c * a.b, g, vr, vi);
      }
      s_in[ch * kChIn + kChH - h1 + j] = vr;
      s_in[(kChCh + ch) * kChIn + kChH - h1 + j] = vi;
    }
    __syncthreads();
    // 2. ds x4 + atan2 -> theta1
    for (int e = tid; e < kChCh * kChN4; e += kChThreads) {
      const int ch = e / kChN4, j = e % kChN4;
      const float* xr = s_in + ch * kChIn;
      const float* xi = s_in + (kChCh + ch) * kChIn;
      auto src = [&](int n, float& vr, float& vi) {
        vr = xr[n];
        vi = xi[n];
      };
      float fr, fi;
      ds4_float(src, a.w1, a.nn1, kChH + 4 * j - h1, fr, fi);
      s_th1[e] = atan2_poly(fi, fr);
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
      plane(1, ch)[kChH + i] = fir_dot(f + i - hh, a.wh, a.nh);
      plane(0, ch)[kChH + i] = f[i - hd];
    }
    __syncthreads();
    // 7. serial: the pilot peak IIR on both planes; power in double
    if (tid < kChCh) {
      const float* re = plane(0, tid) + kChH;
      const float* im = plane(1, tid) + kChH;
      for (int i = 0; i < kChN8; ++i) {
        const float yr =
            peak_step(pr, re[i], a.pk_b0, a.pk_b1, a.pk_b2, a.pk_a1, a.pk_a2);
        const float yi =
            peak_step(pi, im[i], a.pk_b0, a.pk_b1, a.pk_b2, a.pk_a1, a.pk_a2);
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
      mix_sample(plane(0, ch)[i], plane(1, ch)[i], s_dt[e], s_co[ch],
                 s_so[ch], plane(2, ch)[i], plane(3, ch)[i], plane(4, ch)[i],
                 plane(5, ch)[i]);
    }
    __syncthreads();
    // 11. the five decimating FIRs -> the output planes
    const ExtTaps taps{a.wa, a.wm, a.nn_a, a.wr, a.nn_r};
    constexpr int items = 2 * kChNA + kChNR;
    for (int w = tid; w < kChCh * items; w += kChThreads) {
      const int ch = w / items;
      const int64_t c = c0 + ch;
      const int64_t oa = c * (a.b / 32) + tile * kChNA;
      const int64_t orr = c * (a.b / 64) + tile * kChNR;
      const ExtPlanes p{plane(0, ch), plane(2, ch), plane(3, ch),
                        plane(4, ch), plane(5, ch), kChH};
      const ExtOut o{a.lpr + oa, a.lmr_re + oa, a.lmr_im + oa,
                     a.rds_re + orr, a.rds_im + orr};
      extract_item(w % items, kChNA, p, taps, o);
    }
    __syncthreads();
    // 12. slide: each buffer's last kChH samples become the next halo
    for (int e = tid; e < kChCh * kChH; e += kChThreads) {
      const int ch = e / kChH, k = e % kChH;
      s_fmd[ch * kChFmd + k] = s_fmd[ch * kChFmd + kChN4 + k];
      s_tmp[ch * kChH + k] = s_fo[ch * kChFo + kChN8 + k];
      for (int p = 0; p < kChPlanes; ++p)
        s_tmp[((1 + p) * kChCh + ch) * kChH + k] = plane(p, ch)[kChN8 + k];
    }
    __syncthreads();
    for (int e = tid; e < kChCh * kChH; e += kChThreads) {
      const int ch = e / kChH, k = e % kChH;
      s_fo[ch * kChFo + k] = s_tmp[ch * kChH + k];
      for (int p = 0; p < kChPlanes; ++p)
        plane(p, ch)[k] = s_tmp[((1 + p) * kChCh + ch) * kChH + k];
    }
    __syncthreads();
  }

  // ---- carried-out state: the halos now hold each buffer's last samples
  for (int e = tid; e < kChCh * kChH; e += kChThreads) {
    const int ch = e / kChH, k = e % kChH, n = k - kChH;
    const int64_t c = c0 + ch;
    if (n >= -h2) a.tail2_out[c * h2 + h2 + n] = s_fmd[ch * kChFmd + k];
    if (n >= -hh) a.htail_out[c * hh + hh + n] = s_fo[ch * kChFo + k];
    for (int p = 0; p < kChPlanes; ++p) {
      const int h = p < 4 ? ha : hr;
      if (n >= -h) a.o_ext[p][c * h + h + n] = plane(p, ch)[k];
    }
  }
  if (tid < kChCh) {
    const int c = c0 + tid;
    a.prev_out[c] = s_prev[tid];
    a.de_out[2 * c] = de_x1;
    a.de_out[2 * c + 1] = de_y1;
    float* s = a.pk_out + 8 * c;
    s[0] = pr.x1; s[1] = pr.x2; s[2] = pr.y1; s[3] = pr.y2;
    s[4] = pi.x1; s[5] = pi.x2; s[6] = pi.y1; s[7] = pi.y2;
    a.power[c] = (float)pw;
    pll_store(ps, a.pll_out, nc, c);
  }
}

template <class Load>
int launch_chain(Load in, const ChainArgs& a, cudaStream_t stream) {
  const int bytes = kChSmemFloats * (int)sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      chain_kernel<Load>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  chain_kernel<Load><<<a.channels / kChCh, kChThreads, bytes, stream>>>(in, a);
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
// as their inputs; power [C].  C % 8 == 0, B % 512 == 0, and every filter
// reaches at most 128 samples back (nn1 - 4, nn2 - 2, nh - 1, nn_a - 4,
// nn_r - 8 <= 128).  Returns the launch's cudaError_t (0 = launched).
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
  const bool bad_halo = nn1 < 4 || nn1 - 4 > kChH || nn2 < 2 ||
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
