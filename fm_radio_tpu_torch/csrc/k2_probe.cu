// The K2 (mid end) engine probe on Hopper, and the block-parallel IIR.
//
// Replaces the Pallas kernel of tools/k2_probe.py (build :48, kernel :69,
// pallas_call :202; a TPU diagnostic, not a kernel of the receiver):
//   stream      re, im, theta copied from the two halves of each time tile
//               of fm_demod (k2_stream_kernel): the bytes alone
//   ds2         + the ds x2 FIR, written to all three outputs
//               (k2_ds2_kernel)
//   hilb        + the Hilbert FIR: re delayed, im filtered, theta = im
//               (k12_mid_ds2_kernel, then k2_hilb_kernel).  The TPU probe
//               reads re after it has carried the tile's tail into the
//               buffer's head (tools/k2_probe.py:117-118), so its re is
//               each tile of the ds x2 output rotated by the delay: re[u] =
//               fm_out[u - d] within the tile, the first d from the tile's
//               own last d.  The port reproduces that.
//   full        the production K2 (launch_midend of k12_stages.cuh, its
//               split route with de-emphasis: the tiled ds x2, the serial
//               de-emphasis, the tiled Hilbert, the peak IIR's recurrence
//               + power, the theta pass), on the probe's coefficients and
//               zero state
//   restruct:li[:stk]
//               the de-emphasis and the peak IIR as block-Toeplitz
//               recurrences (k2_deemph_block_kernel, k2_peak_block_kernel):
//               within a block of li outputs the zero-state response is a
//               causal FIR of length <= li, y[j] = sum_{i<=j} h[j-i] x[i]
//               (the TPU's lower-triangular Toeplitz T[i, j] = h[j - i],
//               midend_pallas.py::_iir_tile_mats :68, :83-84), plus the
//               carried inputs times the rows hm and the carried outputs
//               times the rows pm (h, hm, pm in shared memory: li + 2 r li
//               floats, <= 10 KB at li = 512; not the li x li matrix).
//               stk: re and im run on the same threads, one after the
//               other; without it on other lanes.  Design below.
//
// What the TPU kernel never writes (the ds x2 and Hilbert buffers' heads,
// the IIR state, the power accumulator at the first tile) reads as zeros:
// the carried state of a channel starts at zero, so every variant but
// stream is K2 on zero state.  Each block output sums its zero-state part
// from i = 0 up, then adds the carried terms in the TPU's order (x1 hm[0],
// x2 hm[1], y1 pm[0], y2 pm[1]); the power sums yr^2 + yi^2 (float32) in
// double for each j over the blocks in order, then over j in order.  The
// plain versions (probes/k2_probe.py) add in that order: the kernels equal
// them bit for bit.
//
// What bounds the two block kernels: the in-block sums, li/2 + 1/2
// multiply-adds an output on average for each of the three chains, which
// under -fmad=false issue as FMUL and FADD (chip_smoke.py::restruct_floor;
// the function's bytes are a fraction of that).  An earlier form walked
// a channel's blocks one at a time (one load, the sums, three barriers a
// block: latency, not work) and fed each multiply-add from two
// shared-memory loads.  So every block's sums of a unit are computed at
// once, eight outputs a thread from a window of h in registers, the next
// unit's loads in flight; only the carries step block by block, one
// thread a plane.  The times are in PERF.md.

#include "bulk_copy.cuh"
#include "k12_stages.cuh"

namespace fmt {

// out[c, ti*l + u] for the halves of tile ti of x [C, n] (l = t_blk / 2):
// re from the first half, im from the second, theta = re; float4 a thread
__global__ void k2_stream_kernel(const float4* __restrict__ x, int64_t nv,
                                 int l4, float4* __restrict__ re,
                                 float4* __restrict__ im,
                                 float4* __restrict__ th, int64_t total4) {
  const int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total4) return;
  const int64_t half4 = nv / 2;  // float4 per output row (nv per input row)
  const int64_t c = o / half4, u = o % half4;
  const int64_t ti = u / l4, k = u % l4;
  const int64_t src = c * nv + ti * 2 * l4 + k;
  const float4 a = x[src];
  re[o] = a;
  th[o] = a;
  im[o] = x[src + l4];
}

// ---- ds2 and hilb: the mid end's staged, register-blocked tiles -------------
//
// Both FIRs are the split route's kernels (k12_stages.cuh) with other
// stores: a CTA a (tile of kMidTile outputs, channel); k2_ds2_kernel
// stages the tile's fm_demod window (mid_stage_fmd, every load in flight
// before the first store to shared memory) and sums kDs2Outs outputs a
// thread (mid_ds2), stored to re, im and theta, two float4 stores a plane;
// k2_hilb_kernel stages the tile's fm_out and the 64-sample halo as
// k12_mid_hilb_kernel does and sums kHilbOuts outputs a thread
// (mid_hilb_runs), stored as im, theta = im and the rotated re, a float4
// store a plane.
// Each output is fir_point's float32 sum in its tap order, so both equal
// the plain versions bit for bit (-fmad=false).  The carried tails are
// zero (the probe's zero state).  An earlier form summed one output a
// thread over fir_point, a global load a tap: 1.218 ms (ds2) and, with
// fir_decimate_kernel before it, 2.817 (hilb) at C = 1,024 x B4 = 65,536,
// behind F.conv1d (PERF.md row 13e).  What bounds them: the bytes (ds2: x
// in, three planes out) beside the FMUL+FADD issue of 2 taps an output.

// The source of the rotated re of the run of kHilbOuts outputs from i (i
// % 4 == 0) in a tile of lt outputs: fm_out[i - dm] where i % lt >= dm,
// else fm_out[i + lt - dm], dm = d % lt (a tile of lt outputs rotated by
// d, as hilb_plain's torch.roll; lt % 8 == 0, so dm % 8 == 0 and a run
// never straddles the seam).  probes/k2_probe.py::re_src is its host copy.
__host__ __device__ inline int k2_re_src(int i, int lt, int d) {
  const int dm = d % lt;
  return i % lt >= dm ? i - dm : i + lt - dm;
}

// x [C, n4] fm_demod -> re, im, th [C, n4/2] (n4 % 16 == 0, 16-byte
// aligned); zeros [C, 128] the carried ds x2 tail
template <int NN2>
__global__ void __launch_bounds__(kDs2Threads, kDs2MinBlocks)
k2_ds2_kernel(const float* __restrict__ x, const float* __restrict__ w2_rev,
              const float* __restrict__ zeros, int n4, float* __restrict__ re,
              float* __restrict__ im, float* __restrict__ th) {
  static_assert(kDs2Outs == 8, "two float4 stores a run and plane");
  constexpr int H2 = NN2 - 2;
  constexpr int NU = 2 * kMidTile + NN2;  // every sample the runs read
  constexpr int NLOAD = (2 * kMidTile + H2 + kDs2Threads - 1) / kDs2Threads;
  __shared__ float s_u[mid_skew(NU) + 1];
  __shared__ float s_w2[NN2];
  const int n8 = n4 / 2;
  const int c = blockIdx.y;
  const int i0 = blockIdx.x * kMidTile;
  const int nt = min(kMidTile, n8 - i0);  // outputs of this tile
  for (int k = threadIdx.x; k < NN2; k += kDs2Threads)
    s_w2[k] = FMT_AT(w2_rev, k, NN2);
  mid_stage_fmd<false, float, H2, H2, NLOAD, kDs2Threads>(
      x + (int64_t)c * n4, nullptr, 1.0f, zeros, n4, c, 2 * i0 - H2,
      2 * nt + H2, false, nullptr, s_u, nullptr);
  const int64_t total = (int64_t)gridDim.y * n8;
  mid_ds2<NN2>(
      s_u, s_w2, nt, [&](int a0, const float (&acc)[kDs2Outs]) {
        const int64_t o = (int64_t)c * n8 + i0 + a0;
        const float4 lo = make_float4(acc[0], acc[1], acc[2], acc[3]);
        const float4 hi = make_float4(acc[4], acc[5], acc[6], acc[7]);
        auto put = [&](float* p) {
          float4* d = reinterpret_cast<float4*>(
              FMT_SPAN(p, o, kDs2Outs, total));
          d[0] = lo;
          d[1] = hi;
        };
        put(re);
        put(im);
        put(th);
      });
}

// fm_out [C, n8] -> im = the NH-tap FIR, theta = im, re = each tile of lt
// outputs rotated by the delay D = (NH - 1) / 2 (k2_re_src): from the
// staged window where the source lies in it, else from device memory (a
// tile of lt that does not end inside this CTA's tile: lt > kMidTile, or
// lt not dividing it).  n8 % 8 == 0, lt % 8 == 0, lt | n8; re, im, th
// 16-byte aligned; zeros [C, 128] the carried Hilbert tail.
template <int NH>
__global__ void __launch_bounds__(kMidThreads, kHilbMinBlocks)
k2_hilb_kernel(const float* __restrict__ fm_out,
               const float* __restrict__ wh_rev,
               const float* __restrict__ zeros, int n8, int lt,
               float* __restrict__ re, float* __restrict__ im,
               float* __restrict__ th) {
  static_assert(kHilbOuts == 4, "one float4 store a plane");
  static_assert(kMidThreads * kHilbOuts >= kMidTile, "one run a thread");
  constexpr int HH = NH - 1, D = (NH - 1) / 2;
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
  // k12_mid_hilb_kernel's staging (kept in its own body there: as a shared
  // device function it compiled to other instructions)
  const float* x = fm_out + (int64_t)c * n8;
  float raw[NLOAD];
#pragma unroll
  for (int k = 0; k < NLOAD; ++k) {
    const int a = threadIdx.x + k * kMidThreads;  // fm_out i0 - HH + a
    const int i = i0 - HH + a;
    raw[k] = a >= nf ? 0.0f
             : i >= 0 ? FMT_AT(x, i, n8)
                      : FMT_AT(zeros, (int64_t)c * HH + HH + i,
                               (int64_t)gridDim.y * HH);
  }
#pragma unroll
  for (int k = 0; k < NLOAD; ++k) {
    const int a = threadIdx.x + k * kMidThreads;
    if (a < nf) s_f[mid_skew(a)] = raw[k];
  }
  __syncthreads();
  const int64_t total = (int64_t)gridDim.y * n8;
  mid_hilb_runs<NH>(
      s_f, s_wh, nt, [&](int a0, const float (&acc)[kHilbOuts]) {
        const int i = i0 + a0;
        const int src = k2_re_src(i, lt, D);  // >= i - D >= i0 - HH
        float4 r;
        if (src + kHilbOuts <= i0 + nt) {  // in the staged window
          const int a = src - (i0 - HH);
          r = make_float4(s_f[mid_skew(a)], s_f[mid_skew(a + 1)],
                          s_f[mid_skew(a + 2)], s_f[mid_skew(a + 3)]);
        } else {
          r = *reinterpret_cast<const float4*>(FMT_SPAN(
              fm_out, (int64_t)c * n8 + src, kHilbOuts, total));
        }
        const int64_t o = (int64_t)c * n8 + i;
        const float4 v = make_float4(acc[0], acc[1], acc[2], acc[3]);
        *reinterpret_cast<float4*>(FMT_SPAN(im, o, kHilbOuts, total)) = v;
        *reinterpret_cast<float4*>(FMT_SPAN(th, o, kHilbOuts, total)) = v;
        *reinterpret_cast<float4*>(FMT_SPAN(re, o, kHilbOuts, total)) = r;
      });
}

// The shapes ds2 (mode 1) and hilb (mode 2) take: n4 % 16 == 0, the tiled
// kernels' orders (nn2 = 64, nh = 65), 16-byte aligned planes; hilb also
// t_blk % 16 == 0, t_blk | n4 and n4 / 2 >= nh - 1
// (probes/k2_probe.py::engine_check is the host copy)
inline bool k2_engine_takes(int mode, int n4, int t_blk, int nn2, int nh,
                            uintptr_t align) {
  if (n4 <= 0 || n4 % 16 || nn2 != kTiledNn2 || align % 16) return false;
  if (mode == 1) return true;
  return nh == kTiledNh && t_blk > 0 && t_blk % 16 == 0 && n4 % t_blk == 0 &&
         n4 / 2 >= nh - 1;
}

// the Hilbert launch: fm_out [C, n8] -> re, im, th (k2_hilb_kernel)
inline int launch_k2_hilb(const float* fm_out, const float* wh_rev,
                          const float* zeros, int channels, int n8, int lt,
                          float* re, float* im, float* th,
                          cudaStream_t stream) {
  const dim3 grid((unsigned)((n8 + kMidTile - 1) / kMidTile),
                  (unsigned)channels);
  k2_hilb_kernel<kTiledNh><<<grid, kMidThreads, 0, stream>>>(
      fm_out, wh_rev, zeros, n8, lt, re, im, th);
  FMT_CHECK_LAUNCH();
  return 0;
}

// ---- restruct: the block-parallel recurrences --------------------------------
//
// A CTA walks one channel in units of kBlkRows rows of li floats (a row is
// one block of one plane: a chain), two units in shared memory: the next
// one's cp.async loads are in flight while this one is summed.  The
// de-emphasis' unit is 32 blocks; the peak IIR's 16 blocks of re and the
// same 16 of im (lanes 0-15 re, 16-31 im: re and im on other threads), or
// with stk 32 blocks of re, then the same 32 of im (re and im on the same
// threads, one after the other).  A chunk is one unit (two with stk).
//
// Each warp takes one pair of ranges of kBlkR outputs, w and Q - 1 - w (Q =
// li / kBlkR), in all 32 rows at once: lane = row, so every lane of a warp
// runs the same loop length and every pair the same work.  A range's
// zero-state sums T[j] = sum_{i <= j} h[j - i] x[i] (i from 0 up) take
// kBlkR accumulators fed from a sliding window of h in registers: 8 steps
// cost two 16-byte loads of x (the lane's own row, rows skewed by the
// stride li + 4 so the 8 lanes of a phase hit other banks) and two
// broadcast loads of h for 128 FMUL + FADD.  Only the carries are serial:
// one thread a plane walks the unit's blocks in order and computes each
// block's last one (de-emphasis) or two (peak) outputs from the carries
// with the plain expression, leaving the carries that enter every block in
// shared memory; then every thread adds its block's carries to its sums in
// the same order and writes them into its row of the unit (its inputs are
// spent), and the rows go out 16 bytes a thread, a warp's stores
// contiguous (each lane storing its own block's outputs scattered them
// over 32 rows: with its sums removed the de-emphasis then took 0.175 ms
// at C = 1,024 x l = 32,768, twice its bytes' time, and 0.097 staged; an
// H100 80GB HBM3 at 700 W).  The peak kernel ends each chunk with theta
// (staged and stored so) and the float32 power, which the owner of each j
// adds in double over the chunk's blocks in order; at the end thread 0
// sums the li partial powers in order.

constexpr int kBlkR = 8;       // outputs a range
constexpr int kBlkRows = 32;   // rows a unit: one a lane
constexpr int kBlkPad = 4;     // row stride li + 4 floats
constexpr int kBlkChains = 64; // chains a chunk at most (stk: 2 x 32)

// kinds: 0 de-emphasis, 1 peak (re and im on other lanes), 2 peak stk
struct K2BlockLayout {
  int nb;       // blocks a chunk (each plane)
  int units;    // units a chunk
  int threads;  // li / 16 warps: a pair of ranges each
  int smem;     // bytes of dynamic shared memory
};

// the layout of restruct:li's kernels (kind as above); probes/k2_probe.py::
// block_layout is its host copy, held equal on the card
__host__ __device__ inline K2BlockLayout k2_block_layout(int li, int kind) {
  K2BlockLayout g;
  const int ord = kind == 0 ? 1 : 2;
  g.nb = kind == 1 ? kBlkRows / 2 : kBlkRows;
  g.units = kind == 2 ? 2 : 1;
  g.threads = 32 * (li / kBlkR / 2);
  // two units, h, hm [ord][li], pm [ord][li], the last sums and inputs
  // [chains][2] each and the carries [chains][4]
  g.smem = (2 * kBlkRows * (li + kBlkPad) + (1 + 2 * ord) * li +
            kBlkChains * 8) * 4;
  return g;
}

inline bool k2_block_li(int li) {
  return li == 64 || li == 128 || li == 256 || li == 512;
}

__device__ __forceinline__ void ld8(float (&v)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void st8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// 8 steps i .. i + 7 of a range at j0: lo = h[j0 - i - 8 .. j0 - i - 1],
// hi = h[j0 - i .. j0 - i + 7]; output r takes h[j0 + r - i - u] x[i + u]
__device__ __forceinline__ void sum8(float (&acc)[kBlkR],
                                     const float (&lo)[8],
                                     const float (&hi)[8], const float* x) {
  float xv[8];
  ld8(xv, x);
#pragma unroll
  for (int u = 0; u < 8; ++u) {
#pragma unroll
    for (int r = 0; r < kBlkR; ++r)
      acc[r] = acc[r] + (r >= u ? hi[r - u] : lo[8 + r - u]) * xv[u];
  }
}

// acc[r] = sum_{i <= j0 + r} h[j0 + r - i] x[i], from i = 0 up (x a row of
// the unit, h in shared memory; j0 a multiple of kBlkR, the same over the
// warp)
__device__ __forceinline__ void range_sums(float (&acc)[kBlkR],
                                           const float* __restrict__ x,
                                           const float* __restrict__ h,
                                           int j0) {
#pragma unroll
  for (int r = 0; r < kBlkR; ++r) acc[r] = 0.0f;
  float a[8], b[8];
  ld8(b, h + j0);
  int i = 0;
  for (; i + 16 <= j0; i += 16) {
    ld8(a, h + j0 - i - 8);
    sum8(acc, a, b, x + i);
    ld8(b, h + j0 - i - 16);
    sum8(acc, b, a, x + i + 8);
  }
  if (i < j0) {
    ld8(a, h + j0 - i - 8);
    sum8(acc, a, b, x + i);
  }
  // the triangle: x[j0 + u] into the outputs r >= u, with h[0 .. 7]
  float xt[8], ht[8];
  ld8(xt, x + j0);
  ld8(ht, h);
#pragma unroll
  for (int u = 0; u < 8; ++u) {
#pragma unroll
    for (int r = u; r < kBlkR; ++r) acc[r] = acc[r] + ht[r - u] * xt[u];
  }
}

// y = T + the carries, in the plain order: ((((T + x1 hm0[j]) [+ x2
// hm1[j]]) + y1 pm0[j]) [+ y2 pm1[j]]); hm and pm rows li apart
template <int kOrd>
__device__ __forceinline__ float carried(float t, float x1, float x2,
                                         float y1, float y2, const float* hm,
                                         const float* pm, int li, int j) {
  float y = t + x1 * hm[j];
  if (kOrd == 2) y = y + x2 * hm[li + j];
  y = y + y1 * pm[j];
  if (kOrd == 2) y = y + y2 * pm[li + j];
  return y;
}

// the same for a range's kBlkR outputs at j0, the rows read 8 at a time;
// c = the block's carries {x1, x2, y1, y2}
template <int kOrd>
__device__ __forceinline__ void add_carries(float (&t)[kBlkR], const float* c,
                                            const float* hm, const float* pm,
                                            int li, int j0) {
  const float x1 = c[0], x2 = c[1], y1 = c[2], y2 = c[3];
  float v[8];
  ld8(v, hm + j0);
#pragma unroll
  for (int r = 0; r < kBlkR; ++r) t[r] = t[r] + x1 * v[r];
  if (kOrd == 2) {
    ld8(v, hm + li + j0);
#pragma unroll
    for (int r = 0; r < kBlkR; ++r) t[r] = t[r] + x2 * v[r];
  }
  ld8(v, pm + j0);
#pragma unroll
  for (int r = 0; r < kBlkR; ++r) t[r] = t[r] + y1 * v[r];
  if (kOrd == 2) {
    ld8(v, pm + li + j0);
#pragma unroll
    for (int r = 0; r < kBlkR; ++r) t[r] = t[r] + y2 * v[r];
  }
}

// h, hm [ord][li], pm [ord][li] into shared memory (visible after the
// first unit's barrier)
__device__ __forceinline__ void stage_mats(float* s, const float* h,
                                           const float* hm, const float* pm,
                                           int li, int ord) {
  for (int e = threadIdx.x; e < li; e += blockDim.x) s[e] = h[e];
  for (int e = threadIdx.x; e < ord * li; e += blockDim.x) {
    s[li + e] = hm[e];
    s[li + ord * li + e] = pm[e];
  }
}

// a unit's rows into buf by cp.async (src(row): its global row, or
// nullptr past the last block), every thread 16 bytes at a time, in one
// commit group
template <int LI, class Src>
__device__ __forceinline__ void unit_load(float* buf, Src src) {
  constexpr int kV = LI / 4, kS = LI + kBlkPad;
  for (int v = threadIdx.x; v < kBlkRows * kV; v += blockDim.x) {
    const int row = v / kV, c4 = v % kV;
    const float* g = src(row);
    if (g != nullptr) cp_async16(buf + row * kS + 4 * c4, g + 4 * c4);
  }
  cp_async_commit();
}

// wait for this unit's rows (the only group in flight), then put the next
// unit's in flight
template <int LI, class Src>
__device__ __forceinline__ void unit_turn(float* next, bool more, Src src) {
  cp_async_wait_all();
  __syncthreads();
  if (more) unit_load<LI>(next, src);
}

// rows [0, nrows) of the unit (stride li + 4) to the contiguous global
// rows at g (li floats each), every thread 16 bytes at a time: a warp
// writes 512 contiguous bytes where each lane's own block would scatter
template <int LI>
__device__ __forceinline__ void unit_store(float* g, const float* rows,
                                           int nrows, float* g0,
                                           int64_t total) {
  constexpr int kV = LI / 4, kS = LI + kBlkPad;
  for (int v = threadIdx.x; v < nrows * kV; v += blockDim.x) {
    const int row = v / kV, c4 = v % kV;
    *reinterpret_cast<float4*>(
        FMT_SPAN(g0, g - g0 + (int64_t)row * LI + 4 * c4, 4, total)) =
        *reinterpret_cast<const float4*>(rows + row * kS + 4 * c4);
  }
}

// order-1 de-emphasis in place on x [C, n] (zero state), one CTA per
// channel, 2 LI threads; units of 32 blocks
template <int LI>
__global__ void __launch_bounds__(2 * LI)
    k2_deemph_block_kernel(float* __restrict__ x, int n,
                           const float* __restrict__ h,
                           const float* __restrict__ hm,
                           const float* __restrict__ pm) {
  constexpr int kS = LI + kBlkPad, kU = kBlkRows * kS, kQ = LI / kBlkR;
  extern __shared__ __align__(16) float k2_sm[];
  float* hs = k2_sm + 2 * kU;     // h [LI], hm [LI], pm [LI]
  float* tl = hs + 3 * LI;    // the last sum [chain][2]
  float* xl = tl + 2 * kBlkChains;   // the last inputs [chain][2]
  float* car = xl + 2 * kBlkChains;  // carries in [chain][4]
  stage_mats(hs, h, hm, pm, LI, 1);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t total = (int64_t)gridDim.x * n;
  float* row = x + (int64_t)blockIdx.x * n;  // the channel
  const int nblk = n / LI, units = (nblk + kBlkRows - 1) / kBlkRows;
  auto src = [&](int u) {
    return [=](int r) -> const float* {
      const int b = u * kBlkRows + r;
      return b < nblk ? FMT_SPAN(x, row - x + (int64_t)b * LI, LI, total)
                      : nullptr;
    };
  };
  float x1 = 0.0f, y1 = 0.0f;  // the walker's carries (thread 0)
  unit_load<LI>(k2_sm, src(0));
  for (int u = 0; u < units; ++u) {
    float* cur = k2_sm + (u & 1) * kU;  // the two units' rows
    unit_turn<LI>(k2_sm + ((u + 1) & 1) * kU, u + 1 < units, src(u + 1));
    const float* xr = cur + lane * kS;
    const int j0a = w * kBlkR, j0b = (kQ - 1 - w) * kBlkR;
    float ta[kBlkR], tb[kBlkR];
    range_sums(ta, xr, hs, j0a);
    range_sums(tb, xr, hs, j0b);
    if (w == 0) {  // range Q - 1 holds the block's last outputs
      tl[2 * lane] = tb[kBlkR - 1];
      xl[2 * lane] = xr[LI - 1];
    }
    __syncthreads();
    const int nbu = min(kBlkRows, nblk - u * kBlkRows);
    if (threadIdx.x == 0) {
      const float* hm0 = hs + LI;
      const float* pm0 = hs + 2 * LI;
#pragma unroll 4
      for (int b = 0; b < nbu; ++b) {
        car[4 * b] = x1;
        car[4 * b + 2] = y1;
        const float y = carried<1>(tl[2 * b], x1, 0.0f, y1, 0.0f, hm0, pm0,
                                   LI, LI - 1);
        x1 = xl[2 * b];
        y1 = y;
      }
    }
    __syncthreads();
    // each thread's outputs into its row of the unit (its inputs are
    // spent), then the unit's rows out in order
    const float* c = car + 4 * lane;
    add_carries<1>(ta, c, hs + LI, hs + 2 * LI, LI, j0a);
    add_carries<1>(tb, c, hs + LI, hs + 2 * LI, LI, j0b);
    st8(cur + lane * kS + j0a, ta);
    st8(cur + lane * kS + j0b, tb);
    __syncthreads();
    unit_store<LI>(row + (int64_t)u * kBlkRows * LI, cur, nbu, x, total);
  }
}

// order-2 peak IIR on re and im [C, n] (zero state): theta [C, n] =
// atan2(yi, yr) / 2pi and power [C]; one CTA per channel, 2 LI threads.
// kStk: units of 32 blocks, re then im, each thread both planes of its
// lane's block; else units of 16 blocks of both planes (lane / 16 the
// plane), re and im met by a shuffle
template <int LI, bool kStk>
__global__ void __launch_bounds__(2 * LI)
    k2_peak_block_kernel(const float* __restrict__ re,
                         const float* __restrict__ im, int n,
                         const float* __restrict__ h,
                         const float* __restrict__ hm,
                         const float* __restrict__ pm,
                         float* __restrict__ theta,
                         float* __restrict__ power) {
  constexpr int kS = LI + kBlkPad, kU = kBlkRows * kS, kQ = LI / kBlkR;
  constexpr int kNb = kStk ? kBlkRows : kBlkRows / 2;  // blocks a chunk
  constexpr int kUnits = kStk ? 2 : 1;                 // units a chunk
  extern __shared__ __align__(16) float k2_sm[];
  float* hs = k2_sm + 2 * kU;      // h [LI], hm [2][LI], pm [2][LI]
  const float* hmr = hs + LI;
  const float* pmr = hs + 3 * LI;
  float* tl = hs + 5 * LI;     // the last two sums [chain][2]
  float* xl = tl + 2 * kBlkChains;   // the last two inputs [chain][2]
  float* car = xl + 2 * kBlkChains;  // carries in [chain][4]
  stage_mats(hs, h, hm, pm, LI, 2);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t total = (int64_t)gridDim.x * n, base = (int64_t)blockIdx.x * n;
  const int nblk = n / LI, chunks = (nblk + kNb - 1) / kNb;
  const int units = chunks * kUnits;
  // unit u's row r: (plane, block) -> its global row
  auto src = [&](int u) {
    return [=](int r) -> const float* {
      const int k = u / kUnits;
      const int p = kStk ? u % kUnits : r / kNb;
      const int b = k * kNb + (kStk ? r : r % kNb);
      return b < nblk ? FMT_SPAN(p ? im : re, base + (int64_t)b * LI, LI,
                                 total)
                      : nullptr;
    };
  };
  const int j0a = w * kBlkR, j0b = (kQ - 1 - w) * kBlkR;
  float wc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // the walker's x1, x2, y1, y2
  double pw = 0.0;                          // thread t < LI: j = t
  unit_load<LI>(k2_sm, src(0));
  for (int k = 0; k < chunks; ++k) {
    // the chunk's sums: T [plane q][range a, b] (kStk: q = unit; else the
    // lane's own plane in q = 0)
    float t[kUnits][2][kBlkR];
    float* cur = nullptr;
#pragma unroll
    for (int q = 0; q < kUnits; ++q) {
      const int u = k * kUnits + q;
      cur = k2_sm + (u & 1) * kU;  // the two units' rows
      unit_turn<LI>(k2_sm + ((u + 1) & 1) * kU, u + 1 < units, src(u + 1));
      const float* xr = cur + lane * kS;
      range_sums(t[q][0], xr, hs, j0a);
      range_sums(t[q][1], xr, hs, j0b);
      if (w == 0) {  // range Q - 1: the block's last two outputs
        const int ch = q * kBlkRows + lane;
        tl[2 * ch] = t[q][1][kBlkR - 1];
        tl[2 * ch + 1] = t[q][1][kBlkR - 2];
        xl[2 * ch] = xr[LI - 1];
        xl[2 * ch + 1] = xr[LI - 2];
      }
    }
    __syncthreads();
    const int nbu = min(kNb, nblk - k * kNb);
    if (threadIdx.x < 2) {  // the walkers: one a plane, in lockstep
      const int p = threadIdx.x;
#pragma unroll 4
      for (int b = 0; b < nbu; ++b) {
        const int ch = kStk ? p * kBlkRows + b : p * kNb + b;
        float* c = car + 4 * ch;
        c[0] = wc[0];
        c[1] = wc[1];
        c[2] = wc[2];
        c[3] = wc[3];
        const float ya = carried<2>(tl[2 * ch], wc[0], wc[1], wc[2], wc[3],
                                    hmr, pmr, LI, LI - 1);
        const float yb = carried<2>(tl[2 * ch + 1], wc[0], wc[1], wc[2],
                                    wc[3], hmr, pmr, LI, LI - 2);
        wc[0] = xl[2 * ch];
        wc[1] = xl[2 * ch + 1];
        wc[2] = ya;
        wc[3] = yb;
      }
    }
    __syncthreads();
    // the outputs: yr, yi of (block, j) -> theta, and the power into the
    // current unit's rows (P [block][j]; every sum has read its inputs)
    const int b = kStk ? lane : lane % kNb;
    float* prow = cur + b * kS;
#pragma unroll
    for (int q = 0; q < kUnits; ++q) {
      const int ch = kStk ? q * kBlkRows + lane : lane;
      const float* c = car + 4 * ch;
      add_carries<2>(t[q][0], c, hmr, pmr, LI, j0a);
      add_carries<2>(t[q][1], c, hmr, pmr, LI, j0b);
    }
    // (yr, yi) for the ranges this lane finishes: kStk both ranges of
    // its block; else re lanes range a, im lanes range b, the other
    // plane's outputs by a shuffle with lane ^ 16
    float yr[kStk ? 2 : 1][kBlkR], yi[kStk ? 2 : 1][kBlkR];
    int j0s[2] = {j0a, j0b};
    if (kStk) {
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int r = 0; r < kBlkR; ++r) {
          yr[a][r] = t[0][a][r];
          yi[a][r] = t[kUnits - 1][a][r];
        }
    } else {
      const bool isim = lane >= kNb;
#pragma unroll
      for (int r = 0; r < kBlkR; ++r) {
        const float mine = isim ? t[0][1][r] : t[0][0][r];
        const float send = isim ? t[0][0][r] : t[0][1][r];
        const float got = __shfl_xor_sync(0xffffffffu, send, kNb);
        yr[0][r] = isim ? got : mine;
        yi[0][r] = isim ? mine : got;
      }
      j0s[0] = isim ? j0b : j0a;
    }
    // theta and the power into the unit's rows: P [block] in rows 0 ..
    // kNb - 1, theta [block] in rows kNb .. 2 kNb - 1 (kStk: theta after
    // the owners have read P)
    float th[kStk ? 2 : 1][kBlkR];
#pragma unroll
    for (int a = 0; a < (kStk ? 2 : 1); ++a) {
      float pp[kBlkR];
#pragma unroll
      for (int r = 0; r < kBlkR; ++r) {
        th[a][r] = atan2_poly(yi[a][r], yr[a][r]) * kInvTwoPi;
        pp[r] = yr[a][r] * yr[a][r] + yi[a][r] * yi[a][r];
      }
      st8(prow + j0s[a], pp);
      if (!kStk) st8(prow + kNb * kS + j0s[a], th[a]);
    }
    __syncthreads();
    if (threadIdx.x < LI) {
      for (int bb = 0; bb < nbu; ++bb)
        pw += (double)cur[bb * kS + threadIdx.x];
    }
    if (kStk) {
      __syncthreads();
#pragma unroll
      for (int a = 0; a < 2; ++a) st8(prow + j0s[a], th[a]);
    }
    __syncthreads();
    unit_store<LI>(theta + base + (int64_t)k * kNb * LI,
                   cur + (kStk ? 0 : kNb * kS), nbu, theta, total);
  }
  // the li partial powers, summed in order (in the unit not read last)
  __syncthreads();
  double* pws = reinterpret_cast<double*>(k2_sm + (units & 1) * kU);
  if (threadIdx.x < LI) pws[threadIdx.x] = pw;
  __syncthreads();
  if (threadIdx.x == 0) {
    double acc = 0.0;
    for (int j = 0; j < LI; ++j) acc += pws[j];
    power[blockIdx.x] = (float)acc;
  }
}

// the launches of one li (smem above 48 KB needs the attribute)
template <int LI>
int launch_blocks(float* fm_out, const float* re, const float* im, int l,
                  int channels, int stk, const float* h_de,
                  const float* hm_de, const float* pm_de, const float* h_pk,
                  const float* hm_pk, const float* pm_pk, float* theta,
                  float* power, int phase, cudaStream_t stream) {
  if (phase == 0) {
    const K2BlockLayout g = k2_block_layout(LI, 0);
    cudaError_t e = cudaFuncSetAttribute(
        k2_deemph_block_kernel<LI>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return (int)e;
    k2_deemph_block_kernel<LI><<<channels, g.threads, g.smem, stream>>>(
        fm_out, l, h_de, hm_de, pm_de);
    FMT_CHECK_LAUNCH();
    return 0;
  }
  const K2BlockLayout g = k2_block_layout(LI, stk ? 2 : 1);
  auto kern = stk ? k2_peak_block_kernel<LI, true>
                  : k2_peak_block_kernel<LI, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<channels, g.threads, g.smem, stream>>>(re, im, l, h_pk, hm_pk,
                                                pm_pk, theta, power);
  FMT_CHECK_LAUNCH();
  return 0;
}

int launch_blocks_li(int li, float* fm_out, const float* re, const float* im,
                     int l, int channels, int stk, const float* h_de,
                     const float* hm_de, const float* pm_de,
                     const float* h_pk, const float* hm_pk,
                     const float* pm_pk, float* theta, float* power,
                     int phase, cudaStream_t stream) {
#define FMT_K2_LI(L)                                                      \
  case L:                                                                 \
    return launch_blocks<L>(fm_out, re, im, l, channels, stk, h_de, hm_de, \
                            pm_de, h_pk, hm_pk, pm_pk, theta, power, phase, \
                            stream);
  switch (li) {
    FMT_K2_LI(64)
    FMT_K2_LI(128)
    FMT_K2_LI(256)
    FMT_K2_LI(512)
  }
#undef FMT_K2_LI
  return (int)cudaErrorInvalidValue;
}

}  // namespace fmt

using namespace fmt;

// mode 0 stream, 1 ds2, 2 hilb on x [C, n4] -> re, im, th [C, n4/2].
// stream: t_blk | n4, t_blk % 8 == 0; ds2 and hilb: k2_engine_takes (re,
// im, th and fm_out 16-byte aligned).  w2_rev [nn2], wh_rev [nh] reversed
// taps; zeros [C, 128] float32 zeros (every carried tail); fm_out [C,
// n4/2] scratch (hilb: ds x2 into it by the split route's
// k12_mid_ds2_kernel, whose new tail goes to th until the Hilbert launch
// writes it).  Anything else is refused (cudaErrorInvalidValue) before any
// launch.
extern "C" int fmt_k2_engine(const float* x, int mode, int channels, int n4,
                             int t_blk, const float* w2_rev, int nn2,
                             const float* wh_rev, int nh, const float* zeros,
                             float* fm_out, float* re, float* im, float* th,
                             cudaStream_t stream) {
  const int64_t total = (int64_t)channels * (n4 / 2);
  const uintptr_t align = (uintptr_t)re | (uintptr_t)im | (uintptr_t)th |
                          (uintptr_t)fm_out;
  if (mode < 0 || mode > 2 ||
      (mode == 0 && (n4 % 2 || t_blk <= 0 || n4 % t_blk || t_blk % 8)) ||
      (mode != 0 && !k2_engine_takes(mode, n4, t_blk, nn2, nh, align)))
    return (int)cudaErrorInvalidValue;
  const int n8 = n4 / 2;
  const dim3 grid((unsigned)((n8 + kMidTile - 1) / kMidTile),
                  (unsigned)channels);
  if (mode == 0) {
    k2_stream_kernel<<<blocks_for(total / 4), kThreads, 0, stream>>>(
        (const float4*)x, n4 / 4, t_blk / 8, (float4*)re, (float4*)im,
        (float4*)th, total / 4);
  } else if (mode == 1) {
    k2_ds2_kernel<kTiledNn2><<<grid, kDs2Threads, 0, stream>>>(
        x, w2_rev, zeros, n4, re, im, th);
  } else {
    const int e = launch_mid_ds2<false>(x, nullptr, 1.0f, w2_rev, nn2,
                                        zeros, channels, n4, fm_out, th,
                                        stream);
    if (e) return e;
    return launch_k2_hilb(fm_out, wh_rev, zeros, channels, n8, t_blk / 2, re,
                          im, th, stream);
  }
  FMT_CHECK_LAUNCH();
  return 0;
}

// hilb's Hilbert launch alone on a given fm_out [C, n8] (n8 = n4 / 2 of
// hilb's shape: k2_engine_takes(2, 2 n8, t_blk, ...)) -> re, im, th
// [C, n8]; zeros [C, 128].  Refused as fmt_k2_engine refuses.
extern "C" int fmt_k2_hilb(const float* fm_out, int channels, int n8,
                           int t_blk, const float* wh_rev, int nh,
                           const float* zeros, float* re, float* im,
                           float* th, cudaStream_t stream) {
  const uintptr_t align = (uintptr_t)fm_out | (uintptr_t)re |
                          (uintptr_t)im | (uintptr_t)th;
  if (!k2_engine_takes(2, 2 * n8, t_blk, kTiledNn2, nh, align))
    return (int)cudaErrorInvalidValue;
  return launch_k2_hilb(fm_out, wh_rev, zeros, channels, n8, t_blk / 2, re,
                        im, th, stream);
}

// full: the production mid end (launch_midend, de-emphasis on: at the
// tiled kernels' orders its split route) on zero state (zeros as
// above: the tails and the IIR states in).  de = {b0, b1, a1}, pk = {b0,
// b1, b2, a1, a2} (host arrays); de_out [C, 2], pk_out [C, 8] the states
// out (scratch); fm_out [C, n4/2] scratch, which the peak IIR's recurrence
// also takes as its yi once Hilbert has read it (the probe carries no
// state, so nothing reads fm_out's tail after); re, im, theta [C, n4/2],
// theta also the scratch of the new ds x2 tail until the recurrence
// writes it; power [C].
extern "C" int fmt_k2_full(const float* x, int channels, int n4,
                           const float* w2_rev, int nn2, const float* wh_rev,
                           int nh, const float* zeros, const float* de,
                           const float* pk, float* de_out, float* pk_out,
                           float* fm_out, float* re, float* im, float* theta,
                           float* power, cudaStream_t stream) {
  if (n4 % (2 * kBatch)) return (int)cudaErrorInvalidValue;
  return launch_midend(x, w2_rev, nn2, zeros, 1, de[0], de[1], de[2], zeros,
                       de_out, wh_rev, nh, zeros, pk[0], pk[1], pk[2], pk[3],
                       pk[4], zeros, pk_out, channels, n4, fm_out, re, im,
                       theta, nullptr, nullptr, nullptr, power, stream,
                       fm_out, theta);
}

// restruct: ds x2 (the split route's k12_mid_ds2_kernel) -> block
// de-emphasis in place -> Hilbert (k12_mid_hilb_kernel) -> block peak IIR.
// h_de [li], hm_de, pm_de [1, li]; h_pk [li], hm_pk, pm_pk [2, li]; l =
// n4/2, li one of 64, 128, 256, 512 (the kernels' instantiations) and li |
// l; the tiled kernels' orders (nn2 = 64, nh = 65); fm_out scratch, re, im,
// theta [C, l] on 16-byte boundaries (theta also takes the ds x2 kernel's
// new tail, which the probe does not carry, until the peak IIR writes it);
// power [C].  Anything else is refused (cudaErrorInvalidValue) before any
// launch.
extern "C" int fmt_k2_restruct(const float* x, int channels, int n4, int li,
                               int stk, const float* w2_rev, int nn2,
                               const float* wh_rev, int nh,
                               const float* zeros, const float* h_de,
                               const float* hm_de, const float* pm_de,
                               const float* h_pk, const float* hm_pk,
                               const float* pm_pk, float* fm_out, float* re,
                               float* im, float* theta, float* power,
                               cudaStream_t stream) {
  const int l = n4 / 2;
  const uintptr_t align = (uintptr_t)fm_out | (uintptr_t)re |
                          (uintptr_t)im | (uintptr_t)theta | (uintptr_t)h_de |
                          (uintptr_t)hm_de | (uintptr_t)pm_de |
                          (uintptr_t)h_pk | (uintptr_t)hm_pk | (uintptr_t)pm_pk;
  if (n4 % 16 || !k2_block_li(li) || l % li || align % 16 ||
      nn2 != kTiledNn2 || nh != kTiledNh || l < nh - 1)
    return (int)cudaErrorInvalidValue;
  int e = launch_mid_ds2<false>(x, nullptr, 1.0f, w2_rev, nn2, zeros,
                                channels, n4, fm_out, theta, stream);
  if (e) return e;
  e = launch_blocks_li(li, fm_out, re, im, l, channels, stk, h_de, hm_de,
                       pm_de, h_pk, hm_pk, pm_pk, theta, power, 0, stream);
  if (e) return e;
  e = launch_mid_hilb(fm_out, wh_rev, nh, zeros, channels, l, re, im,
                      nullptr, nullptr, stream);
  if (e) return e;
  return launch_blocks_li(li, fm_out, re, im, l, channels, stk, h_de, hm_de,
                          pm_de, h_pk, hm_pk, pm_pk, theta, power, 1, stream);
}

// restruct's layout for li and kind (0 de-emphasis, 1 peak, 2 peak stk):
// out = {blocks a chunk, units a chunk, threads, shared-memory bytes}
extern "C" int fmt_k2_block_layout(int li, int kind, int* out) {
  if (!k2_block_li(li) || kind < 0 || kind > 2)
    return (int)cudaErrorInvalidValue;
  const K2BlockLayout g = k2_block_layout(li, kind);
  out[0] = g.nb;
  out[1] = g.units;
  out[2] = g.threads;
  out[3] = g.smem;
  return 0;
}
