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
// Design (the H100 redesign).  Before it, a CTA computed one (output,
// phase) per thread at a time over a runtime M: per multiply-add two
// shared-memory loads and, in the DFT, two __ldg twiddle loads, so the
// load/store unit and not the float pipes set the pace (10.498 ms at the
// wideband cell below, ~8 TFLOP/s; NVIDIA H100 80GB HBM3, 700.00 W).  Now:
// - M is a template parameter: one instantiation per power of two in
//   [2, 128], chosen by a switch, so every loop over phases and channels
//   has compile-time bounds and offsets.
// - Persistent CTAs (as many as fit on the card, kChanThreads threads
//   each) walk the tiles of kTileSamples wide samples (n_t = 4096 / M
//   frames) of every capture; each stages the twiddles cos/sin [M, M] and
//   the taps [K, M] in shared memory once.
// - A tile's n_t + K - 1 frames of re and im are staged, every load of a
//   thread in flight before the first store, at chan_pos(i): sample i
//   plus M words a block of kZRun frames, so the filter's neighbouring
//   threads (phases of one block, or blocks of one phase) hit distinct
//   banks.
// - The phase filter is register-blocked along n: a thread takes kZRun =
//   16 frames of one phase and slides a window of 16 staged samples a
//   plane (the slot output 0 read at step r refilled with the sample
//   output 15 reads at step r + 1), so one shared load serves 16
//   multiply-adds.  The z values go over the staging buffer as [p][slot]
//   (row stride n_t + 4: a quarter-warp's float4 stores along p, and its
//   float4 loads along slot, meet no bank conflict); in the phase-split
//   mode slot s is frame 4 (s % (n_t/4)) + s / (n_t/4).
// - The DFT is register-blocked: a thread computes R = 4 channels x S = 4
//   slots (M = 2: 2 x 8), so each phase's float4 loads of its z slots and
//   of its channels' cos and sin (a broadcast: a quarter-warp shares its
//   channels) feed 8 R S = 128 float operations.  The outputs leave as
//   float4 (f32) or as four int8 in one 32-bit store (i8, i8ps).
// Every sum keeps its order (r from 0, then p from 0; y_re = a - b, y_im =
// c + d), so the kernel stays bit-equal to channelize_plain.
//
// The TPU kernel's own splits=3 form, bf16 hi + lo fused matrices on the
// tensor cores (channelizer_wgmma.cu with a lo table), was considered and
// not built: it would give up bit equality with channelize_plain and the
// 8-ulp oracle tests, its bf16 bound (about 2 x 1.042 ms at the cell) is
// barely under the 2.57 ms float32 issue floor below, and the bf16 mode
// already runs at 1.9x its own bound.
//
// What bounds it: the float32 operations.  At the wideband cell (W = 64,
// M = 32, K = 16, T = 4,194,304) it does 4K + 8M = 320 an input sample,
// 8.6e10 in all: 1.282 ms at 67 TFLOP/s, and 2.57 ms at the issue rate
// of one FMUL or FADD a lane a clock (128 an SM, -fmad=false keeps them
// apart; 132 SMs at 1.98 GHz).  Measured (NVIDIA H100 80GB HBM3, 700.00
// W): 4.165 ms at that cell (chip_smoke.py; 10.498 before), 2.981 at M =
// 16 (W = 128, out i8; ~6.8 before); by phase (probes/chan_phases.py) the
// DFT ~2.47 ms against its 2.05 issue floor, the filter ~0.70 against
// 0.51, the staging's global loads ~0.24 and the rest (the staging's and
// z's stores, the output stores, the barriers) ~0.55.  PERF.md section 6,
// row 10a, holds the final run's times.  A second small launch writes the
// new carried state.

#include "chan_common.cuh"

namespace fmt {

constexpr int kChanThreads = 256;
constexpr int kTileSamples = 4096;  // n_t * M
constexpr int kZRun = 16;           // frames a thread filters
constexpr int kChanStage = 8;       // staged loads a thread in flight

// the schedule of one M (tests/test_torch_chan_blocked.py models it)
template <int M>
struct ChanPlan {
  static constexpr int kFrames = kTileSamples / M;  // n_t
  static constexpr int kR = M >= 4 ? 4 : M;         // DFT channels a thread
  static constexpr int kS = 16 / kR;                // DFT slots a thread
  static constexpr int kQ = kS / 4;                 // its 4-slot groups
  static constexpr int kGroups = kFrames / kS;      // threads a channel group
  static constexpr int kZs = kFrames + 4;           // z row stride
  static_assert((M / kR) * kGroups == kChanThreads &&
                    (kFrames / kZRun) * M == kChanThreads,
                "one DFT block and one filter run a thread");
};

// staged sample i of a tile (frame i / M, phase i % M), skewed by M words
// a block of kZRun frames
__host__ __device__ constexpr int chan_pos(int i, int m) {
  return i + m * (i / (kZRun * m));
}

// a staged plane's floats, rounded up to a whole float4
__host__ __device__ constexpr int chan_plane(int m, int k_taps) {
  return (chan_pos((kTileSamples / m + k_taps - 1) * m - 1, m) + 1 + 3) / 4 *
         4;
}

// shared memory of one CTA: the staging buffer (reused for z), the
// twiddles and the taps, in floats
__host__ __device__ constexpr int chan_smem_floats(int m, int k_taps) {
  return (2 * chan_plane(m, k_taps) > 2 * m * (kTileSamples / m + 4)
              ? 2 * chan_plane(m, k_taps)
              : 2 * m * (kTileSamples / m + 4)) +
         2 * m * m + k_taps * m;
}

__device__ __forceinline__ uint32_t chan_q8x4(float a, float b, float c,
                                              float d, float inv_m) {
  return (uint32_t)(uint8_t)chan_q8(a, inv_m) |
         (uint32_t)(uint8_t)chan_q8(b, inv_m) << 8 |
         (uint32_t)(uint8_t)chan_q8(c, inv_m) << 16 |
         (uint32_t)(uint8_t)chan_q8(d, inv_m) << 24;
}

template <bool kPacked, int kOut, int M>
__global__ void __launch_bounds__(kChanThreads, 2)
chan_kernel(const float* __restrict__ x0, const float* __restrict__ x1,
            const float* __restrict__ sr, const float* __restrict__ si,
            const float* __restrict__ w_rev, const float* __restrict__ cos_t,
            const float* __restrict__ sin_t, int k_taps, int n_captures,
            int64_t t_len, float* __restrict__ y_re,
            float* __restrict__ y_im, int8_t* __restrict__ y8) {
  using P = ChanPlan<M>;
  constexpr int n_t = P::kFrames, kR = P::kR, kS = P::kS, kQ = P::kQ;
  constexpr int kG = P::kGroups, kZs = P::kZs;
  extern __shared__ __align__(16) float chan_sm[];
  const int plane = chan_plane(M, k_taps);
  const int buf = chan_smem_floats(M, k_taps) - 2 * M * M - k_taps * M;
  float* xs_re = chan_sm;
  float* xs_im = chan_sm + plane;
  float* z_re = chan_sm;
  float* z_im = chan_sm + M * kZs;
  float* s_cos = chan_sm + buf;
  float* s_sin = s_cos + M * M;
  float* s_w = s_sin + M * M;
  const int tid = threadIdx.x;
  for (int i = tid; i < M * M; i += kChanThreads) {
    s_cos[i] = FMT_AT(cos_t, i, M * M);
    s_sin[i] = FMT_AT(sin_t, i, M * M);
  }
  for (int i = tid; i < k_taps * M; i += kChanThreads)
    s_w[i] = FMT_AT(w_rev, i, k_taps * M);

  const int n_state = (k_taps - 1) * M;
  const int ns = (n_t + k_taps - 1) * M;  // staged samples a plane
  const int64_t tiles_per = t_len / kTileSamples;
  const int64_t n_tiles = (int64_t)n_captures * tiles_per;
  const int channels = n_captures * M;  // C = W * M
  const int64_t n_frames = t_len / M;
  const int64_t n_x = (int64_t)n_captures * t_len;
  const int64_t n_st = (int64_t)n_captures * n_state;
  const float inv_m = 1.0f / (float)M;
  // the filter's run: phase fp of frames kZRun fb ..; the DFT's block:
  // channels kR kg .., slot groups sg + q kG
  const int fp = tid % M, fb = tid / M;
  const int sg = tid % kG, kg = tid / kG;

  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int w = (int)(tile / tiles_per);
    const int64_t f0 = (tile % tiles_per) * n_t;  // first output frame
    const int64_t s0 = f0 * M;                    // x_pad sample of i = 0
    __syncthreads();  // the tables are in; the last tile's z reads done

    // 1. stage x_pad[s0, s0 + ns): all of a round's loads, then the stores
    for (int i0 = 0; i0 < ns; i0 += kChanStage * kChanThreads) {
      float a[kChanStage], b[kChanStage];
#pragma unroll
      for (int u = 0; u < kChanStage; ++u) {
        const int i = i0 + tid + u * kChanThreads;
        if (i < ns) {
          const int64_t s = s0 + i;
          if (s < n_state) {
            a[u] = FMT_AT(sr, (int64_t)w * n_state + s, n_st);
            b[u] = FMT_AT(si, (int64_t)w * n_state + s, n_st);
          } else {
            const int64_t t = (int64_t)w * t_len + s - n_state;
            a[u] = FMT_AT(x0, t, n_x);
            b[u] = kPacked ? 0.0f : FMT_AT(x1, t, n_x);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kChanStage; ++u) {
        const int i = i0 + tid + u * kChanThreads;
        if (i < ns) {
          float re = a[u], im = b[u];
          if (kPacked && s0 + i >= n_state) {  // chan_sample's unpack
            const float ihi = floorf(re * (1.0f / 256.0f));
            im = (re - ihi * 256.0f) - 127.0f;
            re = ihi - 127.0f;
          }
          xs_re[chan_pos(i, M)] = re;
          xs_im[chan_pos(i, M)] = im;
        }
      }
    }
    __syncthreads();

    // 2. the phase filter: frames kZRun fb + s (s < kZRun) of phase fp,
    // z = sum_r w[r, fp] x[frame + r, fp] from r = 0; slot j of the
    // window holds the frame whose s + r is j mod kZRun
    float zr[kZRun], zi[kZRun];
    {
      const int base = chan_pos(kZRun * fb * M, M) + fp;
      float vr[kZRun], vi[kZRun];
#pragma unroll
      for (int j = 0; j < kZRun; ++j) {
        vr[j] = xs_re[base + j * M];
        vi[j] = xs_im[base + j * M];
        zr[j] = 0.0f;
        zi[j] = 0.0f;
      }
#pragma unroll 1
      for (int rb = 0; rb < k_taps; rb += kZRun) {
        // frame kZRun fb + rb + f lies at xb + f M + M (f / kZRun)
        const int xb = base + rb * M + M * (rb / kZRun);
#pragma unroll
        for (int qq = 0; qq < kZRun; ++qq) {
          const int r = rb + qq;
          if (r < k_taps) {
            const float wv = s_w[r * M + fp];
#pragma unroll
            for (int s = 0; s < kZRun; ++s) {
              zr[s] = zr[s] + vr[(s + qq) % kZRun] * wv;
              zi[s] = zi[s] + vi[(s + qq) % kZRun] * wv;
            }
            if (r + 1 < k_taps) {
              vr[qq] = xs_re[xb + (qq + kZRun) * M + M];
              vi[qq] = xs_im[xb + (qq + kZRun) * M + M];
            }
          }
        }
      }
    }
    __syncthreads();
    // z over the staging buffer, [p][slot], as float4
#pragma unroll
    for (int c = 0; c < kZRun / 4; ++c) {
      int at;
      float4 vr4, vi4;
      if constexpr (kOut == kOutI8PS) {
        // frames kZRun fb + c + 4 e -> slots c n_t/4 + 4 fb + e
        at = fp * kZs + c * (n_t / 4) + 4 * fb;
        vr4 = make_float4(zr[c], zr[c + 4], zr[c + 8], zr[c + 12]);
        vi4 = make_float4(zi[c], zi[c + 4], zi[c + 8], zi[c + 12]);
      } else {
        at = fp * kZs + kZRun * fb + 4 * c;
        vr4 = make_float4(zr[4 * c], zr[4 * c + 1], zr[4 * c + 2],
                          zr[4 * c + 3]);
        vi4 = make_float4(zi[4 * c], zi[4 * c + 1], zi[4 * c + 2],
                          zi[4 * c + 3]);
      }
      *reinterpret_cast<float4*>(z_re + at) = vr4;
      *reinterpret_cast<float4*>(z_im + at) = vi4;
    }
    __syncthreads();

    // 3. the DFT: channels kR kg + i, slots 4 (sg + q kG) + j, summed over
    // p from 0 in the order of the plain version
    float a[kR][kS], b[kR][kS], c[kR][kS], d[kR][kS];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kS; ++j)
        a[i][j] = b[i][j] = c[i][j] = d[i][j] = 0.0f;
#pragma unroll 8
    for (int p = 0; p < M; ++p) {
      float vr[kS], vi[kS], cs[kR], sn[kR];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int at = p * kZs + 4 * (sg + q * kG);
        const float4 r4 = *reinterpret_cast<const float4*>(z_re + at);
        const float4 i4 = *reinterpret_cast<const float4*>(z_im + at);
        vr[4 * q] = r4.x, vr[4 * q + 1] = r4.y, vr[4 * q + 2] = r4.z,
                  vr[4 * q + 3] = r4.w;
        vi[4 * q] = i4.x, vi[4 * q + 1] = i4.y, vi[4 * q + 2] = i4.z,
                  vi[4 * q + 3] = i4.w;
      }
      if constexpr (kR == 4) {
        const float4 c4 =
            *reinterpret_cast<const float4*>(s_cos + p * M + kR * kg);
        const float4 s4 =
            *reinterpret_cast<const float4*>(s_sin + p * M + kR * kg);
        cs[0] = c4.x, cs[1] = c4.y, cs[2] = c4.z, cs[3] = c4.w;
        sn[0] = s4.x, sn[1] = s4.y, sn[2] = s4.z, sn[3] = s4.w;
      } else {
        const float2 c2 =
            *reinterpret_cast<const float2*>(s_cos + p * M + kR * kg);
        const float2 s2 =
            *reinterpret_cast<const float2*>(s_sin + p * M + kR * kg);
        cs[0] = c2.x, cs[1] = c2.y;
        sn[0] = s2.x, sn[1] = s2.y;
      }
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          a[i][j] = a[i][j] + vr[j] * cs[i];
          b[i][j] = b[i][j] + vi[j] * sn[i];
          c[i][j] = c[i][j] + vr[j] * sn[i];
          d[i][j] = d[i][j] + vi[j] * cs[i];
        }
    }
    // y_re = a - b, y_im = c + d; the channel-major stores
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int64_t row = (int64_t)w * M + kR * kg + i;  // global channel
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int slot = 4 * (sg + q * kG);
        float yr[4], yi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          yr[j] = a[i][4 * q + j] - b[i][4 * q + j];
          yi[j] = c[i][4 * q + j] + d[i][4 * q + j];
        }
        if constexpr (kOut == kOutI8PS) {
          const int ph = slot / (n_t / 4);
          const int64_t n4 = n_frames / 4;
          const int64_t col = f0 / 4 + slot % (n_t / 4);
          const int64_t n8 = (int64_t)8 * channels * n4;
          *reinterpret_cast<uint32_t*>(FMT_SPAN(
              y8, ((int64_t)ph * channels + row) * n4 + col, 4, n8)) =
              chan_q8x4(yr[0], yr[1], yr[2], yr[3], inv_m);
          *reinterpret_cast<uint32_t*>(FMT_SPAN(
              y8, ((int64_t)(4 + ph) * channels + row) * n4 + col, 4, n8)) =
              chan_q8x4(yi[0], yi[1], yi[2], yi[3], inv_m);
        } else if constexpr (kOut == kOutI8) {
          const int64_t at = row * n_frames + f0 + slot;
          const int64_t n8 = (int64_t)2 * channels * n_frames;
          *reinterpret_cast<uint32_t*>(FMT_SPAN(y8, at, 4, n8)) =
              chan_q8x4(yr[0], yr[1], yr[2], yr[3], inv_m);
          *reinterpret_cast<uint32_t*>(
              FMT_SPAN(y8, (int64_t)channels * n_frames + at, 4, n8)) =
              chan_q8x4(yi[0], yi[1], yi[2], yi[3], inv_m);
        } else {
          const int64_t at = row * n_frames + f0 + slot;
          const int64_t nf = (int64_t)channels * n_frames;
          *reinterpret_cast<float4*>(FMT_SPAN(y_re, at, 4, nf)) =
              make_float4(yr[0], yr[1], yr[2], yr[3]);
          *reinterpret_cast<float4*>(FMT_SPAN(y_im, at, 4, nf)) =
              make_float4(yi[0], yi[1], yi[2], yi[3]);
        }
      }
    }
  }
}

template <bool kPacked, int kOut, int M>
int chan_launch(const float* x0, const float* x1, const float* sr,
                const float* si, const float* w_rev, const float* cos_t,
                const float* sin_t, int k_taps, int n_captures,
                int64_t t_len, float* y_re, float* y_im, int8_t* y8,
                float* sr_out, float* si_out, cudaStream_t stream) {
  auto kernel = chan_kernel<kPacked, kOut, M>;
  const int smem = chan_smem_floats(M, k_taps) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kChanThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t n_tiles = (int64_t)n_captures * (t_len / kTileSamples);
  const int64_t fit = (int64_t)per_sm * sms;
  const unsigned grid = (unsigned)(n_tiles < fit ? n_tiles : fit);
  kernel<<<grid, kChanThreads, smem, stream>>>(x0, x1, sr, si, w_rev, cos_t,
                                               sin_t, k_taps, n_captures,
                                               t_len, y_re, y_im, y8);
  FMT_CHECK_LAUNCH();
  const int n_state = (k_taps - 1) * M;
  if (n_state > 0) {
    chan_state_kernel<kPacked>
        <<<blocks_for((int64_t)n_captures * n_state), kThreads, 0, stream>>>(
            x0, x1, sr, si, n_state, n_captures, t_len, sr_out, si_out);
    FMT_CHECK_LAUNCH();
  }
  return 0;
}

// the instantiation of M: out 0 and 1 at every M, out 2 (phase-split) at
// M = 32 only
template <bool kPacked, int kOut>
int chan_by_m(int m, const float* x0, const float* x1, const float* sr,
              const float* si, const float* w_rev, const float* cos_t,
              const float* sin_t, int k_taps, int n_captures, int64_t t_len,
              float* y_re, float* y_im, int8_t* y8, float* sr_out,
              float* si_out, cudaStream_t stream) {
#define FMT_CHAN_M(MM)                                                       \
  case MM:                                                                   \
    return chan_launch<kPacked, kOut, MM>(x0, x1, sr, si, w_rev, cos_t,      \
                                          sin_t, k_taps, n_captures, t_len,  \
                                          y_re, y_im, y8, sr_out, si_out,    \
                                          stream);
  if constexpr (kOut == kOutI8PS) {
    switch (m) { FMT_CHAN_M(32) }
    return (int)cudaErrorInvalidValue;
  } else {
    switch (m) {
      FMT_CHAN_M(2)
      FMT_CHAN_M(4)
      FMT_CHAN_M(8)
      FMT_CHAN_M(16)
      FMT_CHAN_M(32)
      FMT_CHAN_M(64)
      FMT_CHAN_M(128)
    }
    return (int)cudaErrorInvalidValue;
  }
#undef FMT_CHAN_M
}

template <bool kPacked>
int chan_dispatch(int out, const float* x0, const float* x1, const float* sr,
                  const float* si, const float* w_rev, const float* cos_t,
                  const float* sin_t, int m, int k_taps, int n_captures,
                  int64_t t_len, float* y_re, float* y_im, int8_t* y8,
                  float* sr_out, float* si_out, cudaStream_t stream) {
  switch (out) {
    case kOutF32:
      return chan_by_m<kPacked, kOutF32>(m, x0, x1, sr, si, w_rev, cos_t,
                                         sin_t, k_taps, n_captures, t_len,
                                         y_re, y_im, y8, sr_out, si_out,
                                         stream);
    case kOutI8:
      return chan_by_m<kPacked, kOutI8>(m, x0, x1, sr, si, w_rev, cos_t,
                                        sin_t, k_taps, n_captures, t_len,
                                        y_re, y_im, y8, sr_out, si_out,
                                        stream);
    default:
      return chan_by_m<kPacked, kOutI8PS>(m, x0, x1, sr, si, w_rev, cos_t,
                                          sin_t, k_taps, n_captures, t_len,
                                          y_re, y_im, y8, sr_out, si_out,
                                          stream);
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
