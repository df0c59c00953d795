// Row gather and scatter on the flatten-once (K, rows, 1024) f32 layout:
// the data movers of the sparse-rows wire.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/row_gather.py:
// row_gather_pallas (pl.pallas_call at line 88) and row_scatter_pallas
// (pl.pallas_call at line 116).  With K workers and S selected rows each:
//
//   gather:  out[k, j] = x[k, idx[k, j]], lanes >= that row's count (from
//            the counts tiled over the workers, at row k*rows + idx[k, j])
//            written as +0.0, the kept lanes moved as they are (as bits:
//            -0.0, NaN payloads, infinities and subnormals included);
//   scatter: out[k, idx[k, j]] = 0.0 + vals[k, j] on an output the caller
//            has zero-filled (torch.zeros), as the Pallas kernel adds into
//            its zeros operand; a -0.0 lands as +0.0.  The indices of a
//            worker are distinct (the codec selects them so), which makes
//            the scatter a permutation write; the kernel does not check it,
//            as that would cost a host sync.
//
// An index outside [0, rows) gathers a zero row and scatters nothing (the
// plain version raises); the codec never produces one.  A gather may
// repeat an index.
//
// The Pallas kernels run one grid step per row of one worker, and the
// reference loops the worker dim in Python, one launch per worker.  Here
// one launch covers all K*S rows.
//
// Bound: memory.  At the main path's shape (the embedding table, K = 4,
// rows = 4096, S = 64), gather reads 256 rows of 4 KiB plus indices and
// counts and writes 256 rows (2.1 MB: 0.63 us at 3.35 TB/s); the scatter
// writes 256 rows into a 64 MiB output that the fill writes whole (68 MB:
// 20 us), so the fill is its cost.
//
// What holds the gather back at that shape is not bytes but a chain of
// dependent accesses: an index load, then the row load it addresses, then
// the store.  1 MiB fits in one wave of the card with far fewer bytes in
// flight than it takes to reach the memory's rate, so the time is the
// kernel's start, two memory round trips and the store drain.  The first
// design (one 256-thread block per gathered row, one float4 a thread) had
// that chain, lengthened by a 64-bit division ahead of the index load and
// a load of the counts pointer between the index and the row (its SASS);
// at a large S it held one float4 a thread in flight and launched K*S
// blocks.
//
// Design, gather: two kernels, chosen by the number of rows n = K*S
// against the grid the card holds at once (kBlocksPerSm * SMs, the SMs
// read once per device).
//   * n within it (the main path's 256): row_gather_kernel, one block per
//     row on a (slot, worker) grid, so the chain is the index load, one
//     multiply-add, the row load and its count beside it, and the store:
//     no division, no branch and no shared memory.  (The same path in a
//     kernel that also declared the staged path's 1 KiB of shared memory
//     took 0.16 us longer in the round on an H100.)
//   * more rows: row_gather_rows_kernel, a grid sized to the card, each
//     block an even share of the rows.  A block stages the sources of up
//     to 256 of its rows at once (thread i loads index i of the window, one
//     coalesced load, into shared memory); after that one barrier no row
//     load waits on an index load, and thread t issues the loads of float4 t
//     of kDepth rows before its first store.
// Both load the rows as streaming (evict-first): each is read once, and
// the payload they make is what the wire reads next.  A row whose count is
// >= 1024 (every row of the embedding table, and every row without counts)
// is stored as loaded, with no per-lane compare.  The rows move as 32-bit
// integers, so no floating-point operation touches a kept value.
//
// Design, scatter: one block of 256 threads per scattered row, one float4
// per thread: each row moves as 4 KiB of coalesced 16-byte accesses.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kLane = 1024;               // elements per row (LANE)
constexpr int kThreads = kLane / 4;       // one 16-byte vector of a row each
constexpr int kWindow = kThreads;         // rows whose sources are staged
constexpr int kDepth = 4;                 // rows in flight per thread
constexpr int kBlocksPerSm = 4;           // resident gather blocks per SM
constexpr int kMaxDevices = 64;

// float4 t of a row (lanes 4t..4t+3) with the lanes at or past `cnt` set to
// +0.0; `cnt` is compared as the float it is, as the plain version does.
__device__ __forceinline__ int4 keep_prefix(int4 v, int t, float cnt) {
  const int c = 4 * t;
  v.x = __int2float_rn(c + 0) < cnt ? v.x : 0;
  v.y = __int2float_rn(c + 1) < cnt ? v.y : 0;
  v.z = __int2float_rn(c + 2) < cnt ? v.z : 0;
  v.w = __int2float_rn(c + 3) < cnt ? v.w : 0;
  return v;
}

// Thread t's float4 of gathered rows out0 + u (u < nr <= kDepth) from the
// flat source rows q[u] (-1: a zero row): every load before any store.
__device__ __forceinline__ void move_rows(const int4* __restrict__ x,
                                          const float* __restrict__ counts,
                                          int4* __restrict__ out,
                                          const int (&q)[kDepth], int nr,
                                          long long out0, int t) {
  int4 v[kDepth];
  float cnt[kDepth];
#pragma unroll
  for (int u = 0; u < kDepth; ++u) {
    v[u] = make_int4(0, 0, 0, 0);
    cnt[u] = static_cast<float>(kLane);
    if (u < nr && q[u] >= 0) {
      if (counts) cnt[u] = __ldg(counts + q[u]);
      v[u] = __ldcs(x + static_cast<long long>(q[u]) * kThreads + t);
    }
  }
#pragma unroll
  for (int u = 0; u < kDepth; ++u)
    if (u < nr)
      out[(out0 + u) * kThreads + t] =
          cnt[u] >= static_cast<float>(kLane) ? v[u]
                                              : keep_prefix(v[u], t, cnt[u]);
}

// One row a block, when the grid covers the rows in one go (the main
// path's 256): block (slot, worker) = (blockIdx.x, blockIdx.y).  The index
// is a broadcast load; no division, no branch, no barrier and no shared
// memory stand between it and the row.  An index out of range reads the
// worker's row 0 and keeps none of it.
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const int4* __restrict__ x, const int* __restrict__ idx,
                  const float* __restrict__ counts, int4* __restrict__ out,
                  int rows, int s) {
  const int t = threadIdx.x;
  const int j = blockIdx.y * s + blockIdx.x;
  const int base = blockIdx.y * rows;
  const int r = __ldg(idx + j);
  const bool ok = static_cast<unsigned>(r) < static_cast<unsigned>(rows);
  const int q = base + (ok ? r : 0);
  float cnt = ok ? static_cast<float>(kLane) : 0.0f;
  if (counts && ok) cnt = __ldg(counts + q);
  const int4 v = __ldcs(x + static_cast<long long>(q) * kThreads + t);
  out[static_cast<long long>(j) * kThreads + t] =
      cnt >= static_cast<float>(kLane) ? v : keep_prefix(v, t, cnt);
}

// Several rows a block: block b gathers an even share [lo, hi) of the
// n = K*S rows, staging the sources of up to 256 of them at once.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
row_gather_rows_kernel(const int4* __restrict__ x,
                       const int* __restrict__ idx,
                       const float* __restrict__ counts,
                       int4* __restrict__ out, int rows, int s, int n) {
  __shared__ int src[kWindow];            // flat source row, -1: zero row
  const int t = threadIdx.x;
  const int lo = static_cast<int>(
      static_cast<long long>(n) * blockIdx.x / gridDim.x);
  const int hi = static_cast<int>(
      static_cast<long long>(n) * (blockIdx.x + 1) / gridDim.x);
  for (int w = lo; w < hi; w += kWindow) {
    const int m = min(kWindow, hi - w);
    if (t < m) {
      const int j = w + t;
      const int base = (j / s) * rows;      // worked out while idx loads
      const int r = __ldg(idx + j);
      src[t] = static_cast<unsigned>(r) < static_cast<unsigned>(rows)
                   ? base + r : -1;
    }
    __syncthreads();
    for (int i = 0; i < m; i += kDepth) {
      int q[kDepth];
#pragma unroll
      for (int u = 0; u < kDepth; ++u) q[u] = i + u < m ? src[i + u] : -1;
      move_rows(x, counts, out, q, min(kDepth, m - i), w + i, t);
    }
    __syncthreads();                      // src is rewritten next window
  }
}

__global__ void __launch_bounds__(kThreads)
row_scatter_kernel(const int* __restrict__ idx,
                   const float4* __restrict__ vals, float4* __restrict__ out,
                   long long rows, int s) {
  const long long j = blockIdx.x;
  const long long k = j / s;
  const int r = __ldg(idx + j);
  if (r < 0 || r >= rows) return;
  const int t = threadIdx.x;
  const float4 v = vals[j * kThreads + t];
  float4 y;
  y.x = __fadd_rn(0.0f, v.x);
  y.y = __fadd_rn(0.0f, v.y);
  y.z = __fadd_rn(0.0f, v.z);
  y.w = __fadd_rn(0.0f, v.w);
  out[(k * rows + r) * kThreads + t] = y;
}

int grid_for(long long k, long long rows, int s, unsigned* blocks) {
  if (k <= 0 || rows <= 0 || s <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k * s > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(k * s);
  return static_cast<int>(cudaSuccess);
}

// The current device's SM count, read from the device once.
int sm_count(int* sms) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (cached[dev] == 0) {
    int v = 0;
    err = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    cached[dev] = v;
  }
  *sms = cached[dev];
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// x: k x rows x 1024 f32; idx: k x s i32; counts: k*rows f32 (tiled over
// the workers), or null for full rows; out: k x s x 1024 f32.  Every
// pointer 16-byte aligned; k*rows and k*s at most INT_MAX.  Launches on
// `stream` and returns cudaGetLastError() (0 on success); never
// synchronises.
extern "C" int row_gather_f32(const void* x, const void* idx,
                              const void* counts, void* out, long long k,
                              long long rows, int s, void* stream) {
  unsigned n = 0;
  int err = grid_for(k, rows, s, &n);
  if (err != 0) return err;
  if (k * rows > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  err = sm_count(&sms);
  if (err != 0) return err;
  const auto* xv = static_cast<const int4*>(x);
  const auto* iv = static_cast<const int*>(idx);
  const auto* cv = static_cast<const float*>(counts);
  auto* ov = static_cast<int4*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned cap = static_cast<unsigned>(kBlocksPerSm * sms);
  if (n <= cap)
    row_gather_kernel<<<dim3(s, static_cast<unsigned>(k)), kThreads, 0, st>>>(
        xv, iv, cv, ov, static_cast<int>(rows), s);
  else
    row_gather_rows_kernel<<<cap, kThreads, 0, st>>>(
        xv, iv, cv, ov, static_cast<int>(rows), s, static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}

// idx: k x s i32, distinct per worker; vals: k x s x 1024 f32; out:
// k x rows x 1024 f32, zero-filled by the caller.
extern "C" int row_scatter_f32(const void* idx, const void* vals, void* out,
                               long long k, long long rows, int s,
                               void* stream) {
  unsigned blocks = 0;
  const int err = grid_for(k, rows, s, &blocks);
  if (err != 0) return err;
  row_scatter_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float4*>(vals),
      static_cast<float4*>(out), rows, s);
  return static_cast<int>(cudaGetLastError());
}
