// The pilot PLL's serial step, shared by the sequential PLL (pll.cu,
// pll_kernel), the chunked PLL (pll.cu, pll_chunked_kernel) and the
// full-chain megakernel (chain.cu): one copy of the device code, so the
// three evaluate the same float32 operations in the same order
// (fm_radio_tpu/kernels/pll_pallas.py:130-140, and
// chain_pallas.py:157-167, which repeats it).
#pragma once

#include "common.cuh"

namespace fmt {

// loop constants of models/pilot_pll.py::pll_consts_from_cfg
struct PllConsts {
  float ts, f_center, f_gain, ki_ts, kp, b0, a1;
};

// the carry: rows (lpf_x1, lpf_y1, integ, nco_t, prev_pe) of the [5, C]
// state
struct PllState {
  float lpf_x1, lpf_y1, integ, nco_t, prev_pe;
};

__device__ __forceinline__ PllState pll_load(const float* __restrict__ st,
                                             int channels, int c) {
  return {st[c], st[channels + c], st[2 * channels + c],
          st[3 * channels + c], st[4 * channels + c]};
}

__device__ __forceinline__ void pll_store(const PllState& s,
                                          float* __restrict__ st,
                                          int channels, int c) {
  st[c] = s.lpf_x1;
  st[channels + c] = s.lpf_y1;
  st[2 * channels + c] = s.integ;
  st[3 * channels + c] = s.nco_t;
  st[4 * channels + c] = s.prev_pe;
}

// One step over the pilot phase theta (cycles): 1-pole loop filter,
// clipped PI controller, NCO, phase error pe = 2*pi*wrap(theta + t).
// Returns the NCO phase t; the carry rotates to (prev_pe, lpf_pe, integ,
// t, pe).
__device__ __forceinline__ float pll_step(PllState& s, const PllConsts& k,
                                          float theta) {
  const float lpf_pe = k.b0 * (s.prev_pe + s.lpf_x1) - k.a1 * s.lpf_y1;
  s.integ = clip1(s.integ + k.ki_ts * s.prev_pe);
  const float pi_err = lpf_pe * k.kp + s.integ;
  const float control = clip1(pi_err);
  const float t = wrap_cycles(s.nco_t + k.ts * (k.f_center + control * k.f_gain));
  const float pe = kTwoPi * wrap_cycles(theta + t);
  s.lpf_x1 = s.prev_pe;
  s.lpf_y1 = lpf_pe;
  s.nco_t = t;
  s.prev_pe = pe;
  return t;
}

}  // namespace fmt
