// Row gather and scatter on the flatten-once (K, rows, 1024) f32 layout:
// the data movers of the sparse-rows wire.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/row_gather.py:
// row_gather_pallas (pl.pallas_call at line 88) and row_scatter_pallas
// (pl.pallas_call at line 116).  With K workers and S selected rows each:
//
//   gather:  out[k, j] = x[k, idx[k, j]], lanes >= that row's count (from
//            the counts tiled over the workers, at row k*rows + idx[k, j])
//            written as +0.0, the kept lanes moved as they are;
//   scatter: out[k, idx[k, j]] = 0.0 + vals[k, j] on an output the caller
//            has zero-filled (torch.zeros), as the Pallas kernel adds into
//            its zeros operand; a -0.0 lands as +0.0.  The indices of a
//            worker are distinct (the codec selects them so), which makes
//            the scatter a permutation write; the kernel does not check it,
//            as that would cost a host sync.
//
// An index outside [0, rows) gathers a zero row and scatters nothing (the
// plain version raises); the codec never produces one.
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
// Design: one block of 256 threads per gathered or scattered row, one
// float4 per thread: each row moves as 4 KiB of coalesced 16-byte accesses.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kLane = 1024;               // elements per row (LANE)
constexpr int kThreads = kLane / 4;       // one float4 per thread

__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const float4* __restrict__ x, const int* __restrict__ idx,
                  const float* __restrict__ counts, float4* __restrict__ out,
                  long long rows, int s) {
  const long long j = blockIdx.x;          // k*s + slot
  const long long k = j / s;
  const int r = __ldg(idx + j);
  const int t = threadIdx.x;
  float4 y = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (r >= 0 && r < rows) {
    const long long src = k * rows + r;
    const float cnt = counts ? __ldg(counts + src) : static_cast<float>(kLane);
    const float4 v = x[src * kThreads + t];
    const int c = 4 * t;
    y.x = __int2float_rn(c + 0) < cnt ? v.x : 0.0f;
    y.y = __int2float_rn(c + 1) < cnt ? v.y : 0.0f;
    y.z = __int2float_rn(c + 2) < cnt ? v.z : 0.0f;
    y.w = __int2float_rn(c + 3) < cnt ? v.w : 0.0f;
  }
  out[j * kThreads + t] = y;
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

}  // namespace

// x: k x rows x 1024 f32; idx: k x s i32; counts: k*rows f32 (tiled over
// the workers), or null for full rows; out: k x s x 1024 f32.  Every
// pointer 16-byte aligned.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int row_gather_f32(const void* x, const void* idx,
                              const void* counts, void* out, long long k,
                              long long rows, int s, void* stream) {
  unsigned blocks = 0;
  const int err = grid_for(k, rows, s, &blocks);
  if (err != 0) return err;
  row_gather_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const int*>(idx),
      static_cast<const float*>(counts), static_cast<float4*>(out), rows, s);
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
