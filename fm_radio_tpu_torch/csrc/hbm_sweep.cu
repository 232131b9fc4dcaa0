// Device-memory streaming probes on Hopper: the copy and read rates this
// card reaches, which chip_smoke.py divides every kernel's bytes by.
//
// Replaces the three Pallas kernels of tools/hbm_sweep.py (not kernels of
// the receiver; the TPU's bandwidth diagnostic):
//   hbm_grid_copy_kernel  pallas_copy (:61, _copy_kernel :57): a grid copy,
//                         one CTA per [bm, bn] block of x [R, N] float32,
//                         16-byte loads and stores, the block shape swept.
//   hbm_dma_copy_kernel   dma_copy (:133, _dma_copy_kernel :75): a copy
//                         staged through shared memory with one or two
//                         buffers.  Hopper's bulk asynchronous copy
//                         (cp.async.bulk, global -> shared completing on an
//                         mbarrier, shared -> global in a bulk group) moves
//                         each chunk; lane 0 of each warp issues them
//                         (several issuers a CTA, each with its own
//                         buffers, one CTA an SM: dma_plan), and the
//                         issuers walk the chunks in a stride.  One
//                         buffer: a chunk's load waits until the previous
//                         store has read the buffer, as the TPU kernel's
//                         nbuf = 1; two: the next chunk's load is in
//                         flight while this one is stored.  A store is
//                         waited for only until it has read its buffer
//                         (its write stays in flight), and loads and
//                         stores evict first from L2.  The TPU kernel's
//                         chunks are 1-4 MB of VMEM; here a chunk is what
//                         shared memory holds (16-128 KiB).  The sweep
//                         also times its loads alone and its stores
//                         alone (`half`).
//   hbm_read_kernel       pallas_read (:159, _read_kernel :149): a
//                         read-only sum of x [R, 1024] into [1, 128].  The
//                         TPU kernel keeps lanes 0-127 of each block's
//                         column sums, and its block copies read every byte
//                         anyway; here a load whose value went unused would
//                         be dropped by the compiler, so every column c is
//                         summed into lane c % 128.  The order is fixed:
//                         each thread sums its column's rows of a row block
//                         in order, the eight columns of a lane are added in
//                         order, then the row blocks in order by a second
//                         kernel (no atomics), so it equals its plain
//                         version (probes/hbm_sweep.py) bit for bit.
//
// What bounds them: bytes only (no arithmetic but the read's one add per
// element).  Measured rates are in PERF.md.

#include "bulk_copy.cuh"

namespace fmt {

__global__ void hbm_grid_copy_kernel(const float4* __restrict__ x,
                                     float4* __restrict__ y, int n4, int bm,
                                     int bn4) {
  const int64_t row0 = (int64_t)blockIdx.y * bm;
  const int col0 = blockIdx.x * bn4;
  const int total = bm * bn4;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int64_t i = (row0 + e / bn4) * n4 + col0 + e % bn4;
    y[i] = x[i];
  }
}

// The staged copy's plan: each issuer is lane 0 of one warp, with nbuf
// buffers of `chunk` bytes of the CTA's shared memory; a CTA holds as many
// issuers as shared memory takes (kDmaIssuers at most), one CTA an SM,
// no more CTAs than the chunks need.  Issuer q of Q (q = CTA * per_cta +
// warp) copies chunks q, q + Q, q + 2Q, ...  The host copy is
// probes/hbm_sweep.py::dma_plan (and dma_walk for the chunks).
constexpr int kDmaIssuers = 32;
constexpr int kDmaSmem = 232448 - 2 * 8 * kDmaIssuers;  // beside the barriers

inline void dma_plan(int64_t n_chunks, int chunk, int nbuf, int sms,
                     int& ctas, int& per_cta) {
  per_cta = kDmaSmem / (nbuf * chunk);
  if (per_cta > kDmaIssuers) per_cta = kDmaIssuers;
  const int64_t want = per_cta > 0 ? (n_chunks + per_cta - 1) / per_cta : 0;
  ctas = (int)(want < sms ? want : sms);
}

// Each issuer: the first nbuf chunks' loads, then per chunk: wait for its
// load, store it (its own bulk group), and once that store has READ the
// buffer (wait_group.read: its write to device memory stays in flight)
// load the chunk nbuf rounds on into it.  One buffer: a chunk's load
// starts after the previous chunk's store has left the buffer; two: the
// next chunk's load is in flight while this one is stored.  Every load
// and store carries the L2 policy evict-first (each byte read once and
// written once); the writes are waited for once, at the end.  half 1
// runs the loads alone (nothing is stored), half 2 the stores alone (each
// chunk of y gets whatever the buffer holds): the copy's two halves, timed
// apart by the sweep.
__global__ void hbm_dma_copy_kernel(const char* __restrict__ x,
                                    char* __restrict__ y, int64_t n_chunks,
                                    int chunk, int nbuf, int half) {
  extern __shared__ __align__(128) unsigned char buf[];
  __shared__ __align__(8) uint64_t bars[kDmaIssuers][2];
  const int w = threadIdx.x >> 5;
  const int64_t q_all = (int64_t)gridDim.x * (blockDim.x >> 5);
  const int64_t first = (int64_t)blockIdx.x * (blockDim.x >> 5) + w;
  if ((threadIdx.x & 31) != 0 || first >= n_chunks) return;
  unsigned char* mine = buf + (size_t)w * nbuf * chunk;
  uint64_t* bar = bars[w];
  for (int s = 0; s < nbuf; ++s) mbar_init(&bar[s]);
  mbar_fence_init();
  const uint64_t pol = l2_evict_first();
  const bool load = half != 2, store = half != 1;
  for (int s = 0; s < nbuf && first + s * q_all < n_chunks; ++s)
    if (load)
      bulk_load_hint(mine + s * chunk, x + (first + s * q_all) * chunk, chunk,
                     &bar[s], pol);
  int64_t k = 0;
  for (int64_t i = first; i < n_chunks; i += q_all, ++k) {
    const int s = (int)(k % nbuf);
    if (load) mbar_wait(&bar[s], (uint32_t)(k / nbuf) & 1u);
    if (store) {
      fence_async_shared();
      bulk_s2g_hint(y + i * chunk, mine + s * chunk, chunk, pol);
      bulk_commit();
    }
    const int64_t next = i + nbuf * q_all;
    if (next < n_chunks) {
      if (store) bulk_wait_read<0>();
      if (load)
        bulk_load_hint(mine + s * chunk, x + next * chunk, chunk, &bar[s],
                       pol);
    }
  }
  bulk_wait_all();
}

// x [R, 1024]: CTA b sums rows b*bm .. b*bm + bm - 1; thread t holds the
// float4 of columns 4t .. 4t+3 (lanes 4(t % 32) ..), then threads t < 32
// add the eight float4 of their lanes (t, t + 32, ..., t + 224) in order
__global__ void hbm_read_kernel(const float4* __restrict__ x, int bm,
                                float* __restrict__ part) {
  __shared__ float4 s[256];
  const int t = threadIdx.x;
  const float4* p = x + (int64_t)blockIdx.x * bm * 256 + t;
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int r = 0; r < bm; ++r) {
    const float4 v = p[(int64_t)r * 256];
    a.x += v.x;
    a.y += v.y;
    a.z += v.z;
    a.w += v.w;
  }
  s[t] = a;
  __syncthreads();
  if (t < 32) {
    float4 l = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int k = 0; k < 8; ++k) {
      const float4 v = s[32 * k + t];
      l.x += v.x;
      l.y += v.y;
      l.z += v.z;
      l.w += v.w;
    }
    float* o = part + (int64_t)blockIdx.x * 128 + 4 * t;
    o[0] = l.x;
    o[1] = l.y;
    o[2] = l.z;
    o[3] = l.w;
  }
}

__global__ void hbm_read_finish_kernel(const float* __restrict__ part,
                                       int blocks, float* __restrict__ y) {
  const int l = threadIdx.x;
  float acc = 0.0f;
  for (int b = 0; b < blocks; ++b) acc += part[(int64_t)b * 128 + l];
  y[l] = acc;
}

}  // namespace fmt

using namespace fmt;

// x, y [rows, n] float32, 16-byte aligned; bm | rows, bn | n, bn % 4 == 0.
extern "C" int fmt_hbm_grid_copy(const float* x, float* y, int rows, int n,
                                 int bm, int bn, cudaStream_t stream) {
  if (bm <= 0 || bn <= 0 || rows % bm || n % bn || bn % 4 ||
      rows / bm > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n / bn, rows / bm);
  hbm_grid_copy_kernel<<<grid, kThreads, 0, stream>>>(
      (const float4*)x, (float4*)y, n / 4, bm, bn / 4);
  FMT_CHECK_LAUNCH();
  return 0;
}

// x, y of nbytes, 16-byte aligned; chunk | nbytes, chunk % 16 == 0,
// nbuf * chunk <= kDmaSmem; dma_plan's grid on the current device.  half
// 0 the copy, 1 its loads alone, 2 its stores alone.
extern "C" int fmt_hbm_dma_copy(const void* x, void* y, int64_t nbytes,
                                int chunk, int nbuf, int half,
                                cudaStream_t stream) {
  if (chunk <= 0 || chunk % 16 || nbytes <= 0 || nbytes % chunk ||
      (nbuf != 1 && nbuf != 2) || (int64_t)nbuf * chunk > kDmaSmem ||
      half < 0 || half > 2)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  int ctas, per_cta;
  dma_plan(nbytes / chunk, chunk, nbuf, sms, ctas, per_cta);
  const int smem = per_cta * nbuf * chunk;
  e = cudaFuncSetAttribute(hbm_dma_copy_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  hbm_dma_copy_kernel<<<ctas, 32 * per_cta, smem, stream>>>(
      (const char*)x, (char*)y, nbytes / chunk, chunk, nbuf, half);
  FMT_CHECK_LAUNCH();
  return 0;
}

// dma_plan for the host's copy to be held against: out = {ctas, per_cta}.
extern "C" int fmt_hbm_dma_plan(int64_t nbytes, int chunk, int nbuf, int sms,
                                int* out) {
  if (chunk <= 0 || nbytes % chunk || (nbuf != 1 && nbuf != 2))
    return (int)cudaErrorInvalidValue;
  dma_plan(nbytes / chunk, chunk, nbuf, sms, out[0], out[1]);
  return 0;
}

// x [rows, 1024] float32, 16-byte aligned; bm | rows; scratch part
// [rows / bm, 128]; y [128].
extern "C" int fmt_hbm_read(const float* x, int rows, int bm, float* part,
                            float* y, cudaStream_t stream) {
  if (bm <= 0 || rows % bm) return (int)cudaErrorInvalidValue;
  hbm_read_kernel<<<rows / bm, 256, 0, stream>>>((const float4*)x, bm, part);
  FMT_CHECK_LAUNCH();
  hbm_read_finish_kernel<<<1, 128, 0, stream>>>(part, rows / bm, y);
  FMT_CHECK_LAUNCH();
  return 0;
}
