// Polyphase FFT channelizer (critically sampled DFT filterbank) on Hopper.
//
// Replaces fm_radio_tpu/kernels/channelizer_pallas.py::_chan_kernel_t and
// ::_chan_kernel_t_packed (core _chan_core_t): W wideband captures, each
// split into M station channels.  It computes the math of the exact float32
// oracle parallel/channelizer.py::_channelize_xla_p, per capture w:
//
//   x_pad = [state | x]               (state: the last (K-1)*M samples)
//   frames[j, p] = x_pad[j*M + p]
//   z_p[n] = sum_{r=0..K-1} w[r, p] * frames[n + r, p],  w = taps[::-1]
//   y_re[k, n] = (sum_p zr*cos) - (sum_p zi*sin)
//   y_im[k, n] = (sum_p zr*sin) + (sum_p zi*cos)
//
// with cos/sin[p, k] = cos/sin(-2 pi p k / M) from a float32 table made on
// the host.  Every sum runs in that order (r, then p from 0) and the file is
// built with -fmad=false, so the kernel equals the plain version
// (kernels/channelizer.py::channelize_plain) bit for bit.  This is the TPU
// kernel's splits=3 (near-exact) mode as exact float32; its fused int8 and
// bf16 matrix modes (splits 1 and 2) are csrc/channelizer_wgmma.cu.
//
// Input: packed u8 IQ words [W, T] (w = I*256 + Q, unpacked here exactly as
// utils/transfer.py::unpack_iq_words) or (re, im) float32 planes [W, T].
// Output: unscaled float32 (y_re, y_im) [W, M, T/M]; or int8 [2, W, M, T/M]
// of clip(rint(y / M) - 1, -128, 127) (the demod's u8 - 128 convention);
// or, at M = 32, phase-split int8 [2, 4, W*M, T/(4M)] with plane p holding
// frames n = 4u + p (the K12 phase-split kernel's input).
//
// Design (simple first): grid (frame tiles, captures), 256 threads; a tile
// is kTileSamples wide samples (n_t = kTileSamples / M frames).  A block
//   1. stages its n_t + K - 1 frames of re and im in shared memory (the
//      K - 1 halo frames re-read from global memory or from the carried
//      state, so blocks need no order),
//   2. computes z for (n, p), one output per thread at a time, into
//      registers, then over the staging buffer as [p][slot] (row stride
//      n_t + 1, so neither the writes along p nor the reads along slot meet
//      a bank conflict),
//   3. computes the DFT, one (k, slot) per thread at a time: neighbouring
//      threads take neighbouring slots of one channel k, so the twiddle
//      loads are uniform across the warp and the stores coalesce.  In the
//      phase-split mode slot s is frame 4*(s % (n_t/4)) + s / (n_t/4), so
//      neighbouring threads still store neighbouring bytes of one plane.
// A second small launch writes the new carried state.
//
// What bounds it, as measured at the wideband cell (W = 64, M = 32, K = 16,
// 4,194,304 packed words per capture; torch.profiler and CUDA events;
// NVIDIA H100 80GB HBM3, power limit 700.00 W): 10.4 ms per launch, i.e.
// ~8 TFLOP/s of float32 work and ~150 GB/s of traffic, far from either
// peak.  Its time follows M (6.8 ms at M = 16, 128 captures), so the direct
// DFT's instruction stream bounds it: per output and phase two shared-memory
// loads, two twiddle loads and eight unfused float32 operations, in a loop
// over a runtime M.  The DFT runs on the CUDA cores, not the tensor cores.

#include "chan_common.cuh"

namespace fmt {

constexpr int kChanThreads = 256;
constexpr int kTileSamples = 4096;  // n_t * M
constexpr int kPerThread = kTileSamples / kChanThreads;

template <bool kPacked, int kOut>
__global__ void __launch_bounds__(kChanThreads)
chan_kernel(const float* __restrict__ x0, const float* __restrict__ x1,
            const float* __restrict__ sr, const float* __restrict__ si,
            const float* __restrict__ w_rev, const float* __restrict__ cos_t,
            const float* __restrict__ sin_t, int m, int k_taps,
            int64_t t_len, float* __restrict__ y_re,
            float* __restrict__ y_im, int8_t* __restrict__ y8) {
  extern __shared__ float smem[];
  const int n_t = kTileSamples / m;
  const int ns = (n_t + k_taps - 1) * m;  // staged samples per plane
  const int zs = n_t + 1;                 // z row stride
  float* xs_re = smem;
  float* xs_im = smem + ns;
  const int w = blockIdx.y;
  const int64_t f0 = (int64_t)blockIdx.x * n_t;  // first output frame
  const int n_state = (k_taps - 1) * m;
  const float* xw0 = x0 + (int64_t)w * t_len;
  const float* xw1 = kPacked ? nullptr : x1 + (int64_t)w * t_len;
  const float* srw = sr + (int64_t)w * n_state;
  const float* siw = si + (int64_t)w * n_state;

  // 1. stage x_pad[f0*M, (f0 + n_t + K - 1)*M)
  for (int i = threadIdx.x; i < ns; i += kChanThreads) {
    float re, im;
    chan_sample<kPacked>(xw0, xw1, srw, siw, f0 * m + i, n_state, re, im);
    xs_re[i] = re;
    xs_im[i] = im;
  }
  __syncthreads();

  // 2. phase filter into registers, then over the staging buffer
  float zr[kPerThread], zi[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int i = threadIdx.x + u * kChanThreads;
    const int n = i / m, p = i % m;
    float ar = 0.0f, ai = 0.0f;
    for (int r = 0; r < k_taps; ++r) {
      const float wv = __ldg(w_rev + r * m + p);
      ar = ar + xs_re[(n + r) * m + p] * wv;
      ai = ai + xs_im[(n + r) * m + p] * wv;
    }
    zr[u] = ar;
    zi[u] = ai;
  }
  __syncthreads();
  float* z_re = smem;
  float* z_im = smem + m * zs;
  const int q4 = n_t / 4;
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int i = threadIdx.x + u * kChanThreads;
    const int n = i / m, p = i % m;
    const int slot = kOut == kOutI8PS ? (n % 4) * q4 + n / 4 : n;
    z_re[p * zs + slot] = zr[u];
    z_im[p * zs + slot] = zi[u];
  }
  __syncthreads();

  // 3. DFT across phases and the channel-major store
  const int channels = gridDim.y * m;  // C = W * M
  const int64_t n_frames = t_len / m;
  const float inv_m = 1.0f / (float)m;
#pragma unroll 1
  for (int u = 0; u < kPerThread; ++u) {
    const int i = threadIdx.x + u * kChanThreads;
    const int k = i / n_t, slot = i % n_t;
    float a = 0.0f, b = 0.0f, c = 0.0f, d = 0.0f;
    for (int p = 0; p < m; ++p) {
      const float vr = z_re[p * zs + slot], vi = z_im[p * zs + slot];
      const float cs = __ldg(cos_t + p * m + k), sn = __ldg(sin_t + p * m + k);
      a = a + vr * cs;
      b = b + vi * sn;
      c = c + vr * sn;
      d = d + vi * cs;
    }
    const float yr = a - b, yi = c + d;
    const int64_t row = (int64_t)w * m + k;  // global channel
    if (kOut == kOutI8PS) {
      const int ph = slot / q4;
      const int64_t col = f0 / 4 + slot % q4;
      const int64_t n4 = n_frames / 4;
      y8[((int64_t)ph * channels + row) * n4 + col] = chan_q8(yr, inv_m);
      y8[((int64_t)(4 + ph) * channels + row) * n4 + col] = chan_q8(yi, inv_m);
    } else if (kOut == kOutI8) {
      const int64_t at = row * n_frames + f0 + slot;
      y8[at] = chan_q8(yr, inv_m);
      y8[(int64_t)channels * n_frames + at] = chan_q8(yi, inv_m);
    } else {
      const int64_t at = row * n_frames + f0 + slot;
      y_re[at] = yr;
      y_im[at] = yi;
    }
  }
}

template <bool kPacked, int kOut>
int chan_launch(const float* x0, const float* x1, const float* sr,
                const float* si, const float* w_rev, const float* cos_t,
                const float* sin_t, int m, int k_taps, int n_captures,
                int64_t t_len, float* y_re, float* y_im, int8_t* y8,
                float* sr_out, float* si_out, cudaStream_t stream) {
  const int n_t = kTileSamples / m;
  const size_t stage = (size_t)2 * (n_t + k_taps - 1) * m;
  const size_t zbuf = (size_t)2 * m * (n_t + 1);
  const size_t smem = (stage > zbuf ? stage : zbuf) * sizeof(float);
  const dim3 grid((unsigned)(t_len / kTileSamples), (unsigned)n_captures);
  chan_kernel<kPacked, kOut><<<grid, kChanThreads, smem, stream>>>(
      x0, x1, sr, si, w_rev, cos_t, sin_t, m, k_taps, t_len, y_re, y_im, y8);
  FMT_CHECK_LAUNCH();
  const int n_state = (k_taps - 1) * m;
  if (n_state > 0) {
    chan_state_kernel<kPacked>
        <<<blocks_for((int64_t)n_captures * n_state), kThreads, 0, stream>>>(
            x0, x1, sr, si, n_state, n_captures, t_len, sr_out, si_out);
    FMT_CHECK_LAUNCH();
  }
  return 0;
}

template <bool kPacked>
int chan_dispatch(int out, const float* x0, const float* x1, const float* sr,
                  const float* si, const float* w_rev, const float* cos_t,
                  const float* sin_t, int m, int k_taps, int n_captures,
                  int64_t t_len, float* y_re, float* y_im, int8_t* y8,
                  float* sr_out, float* si_out, cudaStream_t stream) {
  switch (out) {
    case kOutF32:
      return chan_launch<kPacked, kOutF32>(x0, x1, sr, si, w_rev, cos_t, sin_t,
                                           m, k_taps, n_captures, t_len, y_re,
                                           y_im, y8, sr_out, si_out, stream);
    case kOutI8:
      return chan_launch<kPacked, kOutI8>(x0, x1, sr, si, w_rev, cos_t, sin_t,
                                          m, k_taps, n_captures, t_len, y_re,
                                          y_im, y8, sr_out, si_out, stream);
    default:
      return chan_launch<kPacked, kOutI8PS>(x0, x1, sr, si, w_rev, cos_t,
                                            sin_t, m, k_taps, n_captures,
                                            t_len, y_re, y_im, y8, sr_out,
                                            si_out, stream);
  }
}

}  // namespace fmt

using namespace fmt;

// All pointers are device pointers to contiguous tensors.  Returns the first
// cudaError_t of the launches (0 = all launched).
// packed != 0: x0 = words [W, T], x1 unused; else x0, x1 = re, im [W, T].
// sr, si [W, (K-1)*M] carried state in, sr_out, si_out the same shape out
// (distinct buffers); w_rev [K*M] reversed taps; cos_t, sin_t [M*M] with
// entry p*M + k.  out 0: y_re, y_im [W, M, T/M] float32; out 1: y8
// [2, W, M, T/M]; out 2 (M = 32): y8 [2, 4, W*M, T/(4M)].
// Limits (the wrapper checks them too): M a power of two in [2, 128],
// 1 <= K <= 17, T a multiple of 4096.
extern "C" int fmt_channelize(const float* x0, const float* x1, int packed,
                              const float* sr, const float* si,
                              const float* w_rev, const float* cos_t,
                              const float* sin_t, int m, int k_taps,
                              int n_captures, int64_t t_len, int out,
                              float* y_re, float* y_im, int8_t* y8,
                              float* sr_out, float* si_out,
                              cudaStream_t stream) {
  if (m < 2 || m > 128 || (m & (m - 1)) != 0 || k_taps < 1 || k_taps > 17 ||
      t_len <= 0 || t_len % kTileSamples != 0 || n_captures <= 0 ||
      n_captures > 65535 || out < kOutF32 || out > kOutI8PS ||
      (out == kOutI8PS && m != 32)) {
    return (int)cudaErrorInvalidValue;
  }
  if (packed) {
    return chan_dispatch<true>(out, x0, x1, sr, si, w_rev, cos_t, sin_t, m,
                               k_taps, n_captures, t_len, y_re, y_im, y8,
                               sr_out, si_out, stream);
  }
  return chan_dispatch<false>(out, x0, x1, sr, si, w_rev, cos_t, sin_t, m,
                              k_taps, n_captures, t_len, y_re, y_im, y8,
                              sr_out, si_out, stream);
}
