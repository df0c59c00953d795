// Fused SGDM step on the flatten-once (rows, 1024) f32 layout.
//
// Replaces the Pallas TPU kernel src/repro/kernels/momentum.py,
// momentum_update (pl.pallas_call at line 56).  Per element:
//
//   g' = g + wd*x;   m' = mu*m + g';   d = m'  (Nesterov: d = g' + mu*m');
//   x' = x - lr*d
//
// Rounding: every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn), so nvcc cannot contract them into FMAs and the
// kernel is bit-exact against the plain PyTorch version
// (repro_torch/kernels/ref.py), which runs one rounded op per call.
//
// Bound: memory.  Each element reads x, m and g and writes x' and m'
// (20 bytes) for 6 flops (8 with Nesterov), far below the f32 balance
// point of an H100 (67 TFLOP/s over 3.35 TB/s, about 20 flops per byte).
// At the main path's shape, 8 workers x 512 rows x 1024, one call moves
// 80 MiB: 25 us at 3.35 TB/s.
//
// Design: one thread per 4 elements with 16-byte float4 loads and stores,
// neighbouring threads on neighbouring addresses; a grid-stride loop over
// at most 8 blocks of 256 threads per SM, with the ragged last sweep masked
// by the loop bound.  lr is read from a device pointer, so a learning-rate
// schedule needs no host sync and no new launch arguments per step.
//
// Two entries share that arithmetic (step4), so they round alike:
// momentum_update_f32 writes x' and m' to fresh buffers (every pointer
// __restrict__); momentum_update_leaves_f32 writes them over x and m, and
// reads g through a table of leaves.  The in-place kernel reads and writes
// x and m through one pointer each, without __restrict__ on them; each
// thread reads its float4 of x and m before it writes the same float4, and
// no two threads touch one element, so the result is the out-of-place one.
// It moves the same 20 bytes an element and saves the two output buffers,
// a copy of the params each, at full width.
//
// The leaf table.  x and m are (K, rows, 1024); g is the K workers'
// gradient as the leaves autograd left it, each one contiguous (K, size)
// tensor whose worker k starts `stride` elements after worker k-1's.  A
// table entry holds a leaf's pointer, worker stride, element count and its
// first kernel row (the KernelPlan's row_start).  Row r of worker k reads
// its g from the last leaf whose first row is <= r, at element
// (r - row_start) * 1024 + lane; lanes at or past the leaf's size, and rows
// before the first leaf, read 0.  That is what KernelPlan.flatten's zeroed
// matrix holds there (its padding of a leaf's last row and the alignment
// tail past used_rows), so the update is bit-exact against flattening g
// and launching on the matrix, and the flatten's zero fill and copies
// never run.  A plain (rows, 1024) matrix is the one-entry table that
// covers every row.
//
// Each block takes a whole row of 1024 (256 threads, a float4 each), so
// the leaf of a row is looked up once per block and row, uniform across
// the block; a block's rows grow by the grid size, so the lookup walks the
// table forward and starts again only where the worker changes.  The table
// is passed by value (__grid_constant__: read from the parameter bank,
// never copied to local memory), so no host-to-device copy precedes a
// launch, and a step takes one launch.  The table holds kMaxLeaves (64)
// leaves; the C entry refuses more, and the caller flattens such a tree.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

template <bool kNesterov>
__device__ __forceinline__ void sgdm(float x, float m, float g, float lr,
                                     float mu, float wd, float& x_out,
                                     float& m_out) {
  const float gw = __fadd_rn(g, __fmul_rn(wd, x));
  const float mn = __fadd_rn(__fmul_rn(mu, m), gw);
  const float d = kNesterov ? __fadd_rn(gw, __fmul_rn(mu, mn)) : mn;
  x_out = __fsub_rn(x, __fmul_rn(lr, d));
  m_out = mn;
}

template <bool kNesterov>
__device__ __forceinline__ void step4(const float4& xv, const float4& mv,
                                      const float4& gv, float lr, float mu,
                                      float wd, float4& xo, float4& mo) {
  sgdm<kNesterov>(xv.x, mv.x, gv.x, lr, mu, wd, xo.x, mo.x);
  sgdm<kNesterov>(xv.y, mv.y, gv.y, lr, mu, wd, xo.y, mo.y);
  sgdm<kNesterov>(xv.z, mv.z, gv.z, lr, mu, wd, xo.z, mo.z);
  sgdm<kNesterov>(xv.w, mv.w, gv.w, lr, mu, wd, xo.w, mo.w);
}

template <bool kNesterov>
__global__ void __launch_bounds__(kThreads)
momentum_kernel(const float4* __restrict__ x, const float4* __restrict__ m,
                const float4* __restrict__ g, const float* __restrict__ lr_ptr,
                float4* __restrict__ x_out, float4* __restrict__ m_out,
                long long n4, float mu, float wd) {
  const float lr = __ldg(lr_ptr);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n4; i += stride) {
    float4 xo, mo;
    step4<kNesterov>(x[i], m[i], g[i], lr, mu, wd, xo, mo);
    x_out[i] = xo;
    m_out[i] = mo;
  }
}

struct Leaf {
  const float4* g;      // worker 0's first float4 of the leaf
  long long stride4;    // float4s from one worker's slice to the next
  long long size4;      // float4s of the leaf a worker
  long long row_start;  // the leaf's first kernel row
};

constexpr int kMaxLeaves = 64;  // 2 KiB of the 4 KiB parameter space

struct LeafTable {
  Leaf leaf[kMaxLeaves];  // ascending row_start
  int n;
};

constexpr int kRow4 = 256;  // float4s in a kernel row of 1024
static_assert(kThreads == kRow4, "a block takes one row at a time");

// x and m are read and written in place: no __restrict__ on them.  The
// `workers` (rows, 1024) blocks of x and m, a block of threads a row.
template <bool kNesterov>
__global__ void __launch_bounds__(kThreads)
momentum_inplace_kernel(float4* x, float4* m,
                        const __grid_constant__ LeafTable table,
                        const float* __restrict__ lr_ptr, long long workers,
                        long long rows, float mu, float wd) {
  const float lr = __ldg(lr_ptr);
  long long k = blockIdx.x / rows;
  long long row = blockIdx.x % rows;
  int j = -1;  // the last leaf whose first row is <= row
  while (k < workers) {
    while (j + 1 < table.n && table.leaf[j + 1].row_start <= row) ++j;
    float4 gv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j >= 0) {
      const Leaf& leaf = table.leaf[j];
      const long long e4 = (row - leaf.row_start) * kRow4 + threadIdx.x;
      if (e4 < leaf.size4) gv = __ldg(leaf.g + k * leaf.stride4 + e4);
    }
    const long long i = (k * rows + row) * kRow4 + threadIdx.x;
    const float4 xv = x[i];
    const float4 mv = m[i];
    float4 xo, mo;
    step4<kNesterov>(xv, mv, gv, lr, mu, wd, xo, mo);
    x[i] = xo;
    m[i] = mo;
    row += gridDim.x;
    if (row >= rows) {  // past this worker's rows: on to the next
      k += row / rows;
      row %= rows;
      j = -1;
    }
  }
}

// The grid of both entries: one thread per float4, at most kBlocksPerSm
// blocks per SM.  Returns 0 or the CUDA error of the device query.
int grid_for(long long n4, unsigned* blocks_out) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (n4 + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  *blocks_out = static_cast<unsigned>(blocks);
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// x, m, g, x_out, m_out: n contiguous f32, 16-byte aligned, n % 4 == 0;
// lr: one f32 on the device.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int momentum_update_f32(const void* x, const void* m,
                                   const void* g, const void* lr,
                                   void* x_out, void* m_out, long long n,
                                   float mu, float wd, int nesterov,
                                   void* stream) {
  if (n % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = n / 4;
  if (n4 == 0) return static_cast<int>(cudaSuccess);
  unsigned blocks = 0;
  const int err = grid_for(n4, &blocks);
  if (err) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x4 = static_cast<const float4*>(x);
  const auto* m4 = static_cast<const float4*>(m);
  const auto* g4 = static_cast<const float4*>(g);
  const auto* lrp = static_cast<const float*>(lr);
  auto* xo4 = static_cast<float4*>(x_out);
  auto* mo4 = static_cast<float4*>(m_out);
  if (nesterov) {
    momentum_kernel<true><<<blocks, kThreads, 0, s>>>(x4, m4, g4, lrp, xo4,
                                                      mo4, n4, mu, wd);
  } else {
    momentum_kernel<false><<<blocks, kThreads, 0, s>>>(x4, m4, g4, lrp, xo4,
                                                       mo4, n4, mu, wd);
  }
  return static_cast<int>(cudaGetLastError());
}

// The update written over x and m, `workers` (rows, 1024) f32 blocks each
// (contiguous, 16-byte aligned), with g read from n <= kMaxLeaves leaves:
// leaf j at g[j] (16-byte aligned), its workers stride[j] elements apart,
// size[j] elements a worker, from kernel row row_start[j] (ascending;
// strides and sizes multiples of 4).  One launch on `stream`; returns
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int momentum_update_leaves_f32(
    void* x, void* m, const void* lr, long long workers, long long rows,
    const void* const* g, const long long* stride, const long long* size,
    const long long* row_start, int n, float mu, float wd, int nesterov,
    void* stream) {
  if (workers < 1 || rows < 0 || n < 1 || n > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  LeafTable table;
  table.n = n;
  for (int j = 0; j < n; ++j) {
    if (reinterpret_cast<unsigned long long>(g[j]) % 16 || stride[j] % 4 ||
        size[j] % 4 || size[j] < 0 || row_start[j] < 0 ||
        row_start[j] >= rows || (j && row_start[j] < row_start[j - 1]))
      return static_cast<int>(cudaErrorInvalidValue);
    table.leaf[j] = Leaf{static_cast<const float4*>(g[j]), stride[j] / 4,
                         size[j] / 4, row_start[j]};
  }
  unsigned blocks = 0;
  const int err = grid_for(workers * rows * kRow4, &blocks);
  if (err) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* x4 = static_cast<float4*>(x);
  auto* m4 = static_cast<float4*>(m);
  const auto* lrp = static_cast<const float*>(lr);
  if (nesterov) {
    momentum_inplace_kernel<true><<<blocks, kThreads, 0, s>>>(
        x4, m4, table, lrp, workers, rows, mu, wd);
  } else {
    momentum_inplace_kernel<false><<<blocks, kThreads, 0, s>>>(
        x4, m4, table, lrp, workers, rows, mu, wd);
  }
  return static_cast<int>(cudaGetLastError());
}
