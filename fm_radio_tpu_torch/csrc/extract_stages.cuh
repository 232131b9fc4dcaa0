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
//                  RDS ds x8 on both planes
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

}  // namespace fmt
