// Blockwise magnitude top-k on the flatten-once (rows, 1024) f32 layout.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/topk_select.py:
// topk_select_pallas (pl.pallas_call at line 95) and topk_scatter_pallas
// (pl.pallas_call at line 117).  Per row of 1024 elements and W slots:
//
//   select:  slot j holds (column, value) of the j-th largest |x| of the row,
//            ties to the lowest column, while j < k_active =
//            ceil(f32(fraction) * count) (the product rounded in f32, as
//            the reference's jnp.float32(fraction) * cnt), and (0, 0.0)
//            after.  The value is x as read, so a selected -0.0 stays -0.0
//            (the reference's take_along_axis oracle and the plain version
//            do the same; the Pallas kernel sums the row and gets +0.0);
//   scatter: out = +0.0 everywhere, then out[idx_j] += val_j in slot order
//            (__fadd_rn), so (0, 0.0) placeholders add nothing and a -0.0
//            value lands as +0.0.
//
// Bound: memory.  At the main path's shape, 8 workers x 512 rows of 1024 at
// fraction 0.1 (W = 103), select reads 16 MiB of x and 16 KiB of counts and
// writes 4096 x 103 x 8 B of slots (20.17 MB: 6.0 us at 3.35 TB/s); scatter
// moves 20.15 MB the other way.  The select is far from that bound: it runs
// k_active rounds of a warp-wide 64-bit max, a serial chain of
// shuffles per slot, like the Pallas kernel's W unrolled rounds.  A
// selection that is not iterative (a radix select on the |x| bits) is a
// later redesign.
//
// Design, select: one warp per row, eight rows per block of 256 threads.  A
// lane loads float4 number lane + 32*c of its row for the eight chunks c
// (each warp load is 512 contiguous bytes) and keeps the 32 elements as
// 64-bit keys  (|x| bits << 32) | ((1024 - column) << 1) | sign bit,  so the
// larger key is the larger |x| and, at equal |x|, the lower column; every
// key is > 0 and a retired element's key is 0.  Each lane caches the
// maximum of its own keys.  A round takes the warp maximum with a
// __shfl_xor_sync butterfly; every lane decodes the column and the value
// (|x| bits with the sign bit put back) from it; the owning lane retires the
// element and recomputes its cached maximum.  Lane j % 32 keeps slot j in a
// register and the warp stores 32 slots at a time.  Rows with k_active = 0
// (alignment padding, count 0) only write placeholders.
//
// Design, scatter: one warp per row, the row accumulated in 4 KiB of
// shared memory.  Column c belongs to lane c % 32, which zeroes it, adds
// into it and stores it, so no two lanes touch one address and the warp
// needs no barrier; each warp store is 32 consecutive floats.  The warp
// reads 32 slots at a time and broadcasts each with __shfl_sync, in slot
// order.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kLane = 1024;               // elements per row (LANE)
constexpr int kVecs = kLane / 4;          // float4 per row
constexpr int kChunks = kVecs / 32;       // float4 per lane per row
constexpr int kPerLane = 4 * kChunks;     // elements per lane per row
constexpr int kMaxWidth = 128;            // MAX_WIDTH of the wrapper
constexpr int kRowsPerBlock = 8;          // one warp per row
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long warp_row() {
  return static_cast<long long>(blockIdx.x) * kRowsPerBlock +
         (threadIdx.x >> 5);
}

__device__ __forceinline__ unsigned long long make_key(float v, int col) {
  const uint32_t b = __float_as_uint(v);
  return (static_cast<unsigned long long>(b & 0x7fffffffu) << 32) |
         (static_cast<unsigned long long>(kLane - col) << 1) | (b >> 31);
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a,
                                                     unsigned long long b) {
  return a > b ? a : b;
}

__global__ void __launch_bounds__(kThreads)
topk_select_kernel(const float4* __restrict__ x,
                   const float* __restrict__ counts, int* __restrict__ idx,
                   float* __restrict__ vals, long long rows, int width,
                   float fraction) {
  const long long row = warp_row();
  if (row >= rows) return;                 // whole warps leave together
  const int lane = threadIdx.x & 31;
  const float count = counts ? __ldg(counts + row) : static_cast<float>(kLane);
  int k = static_cast<int>(ceilf(__fmul_rn(fraction, count)));
  k = k < 0 ? 0 : (k > width ? width : k);
  int* irow = idx + row * width;
  float* vrow = vals + row * width;

  if (k > 0) {
    const float4* xr = x + row * kVecs;
    unsigned long long key[kPerLane];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const float4 v = xr[lane + 32 * c];
      const int col = 4 * (lane + 32 * c);
      key[4 * c + 0] = make_key(v.x, col + 0);
      key[4 * c + 1] = make_key(v.y, col + 1);
      key[4 * c + 2] = make_key(v.z, col + 2);
      key[4 * c + 3] = make_key(v.w, col + 3);
    }
    unsigned long long local = 0;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) local = umax64(local, key[i]);

    int my_idx = 0;
    float my_val = 0.0f;
    for (int j = 0; j < k; ++j) {
      unsigned long long m = local;
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        m = umax64(m, __shfl_xor_sync(kFull, m, off));
      const int col = kLane - static_cast<int>((m >> 1) & 0x7ffu);
      const uint32_t bits = static_cast<uint32_t>(m >> 32) |
                            (static_cast<uint32_t>(m & 1u) << 31);
      if (lane == ((col & 127) >> 2)) {    // the owner retires it
        local = 0;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          key[i] = key[i] == m ? 0ull : key[i];
          local = umax64(local, key[i]);
        }
      }
      if (lane == (j & 31)) {
        my_idx = col;
        my_val = __uint_as_float(bits);
      }
      if ((j & 31) == 31 || j == k - 1) {
        const int base = j & ~31;
        if (lane <= (j & 31)) {
          irow[base + lane] = my_idx;
          vrow[base + lane] = my_val;
        }
      }
    }
  }
  for (int j = k + lane; j < width; j += 32) {   // placeholders
    irow[j] = 0;
    vrow[j] = 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
topk_scatter_kernel(const int* __restrict__ idx,
                    const float* __restrict__ vals, float* __restrict__ out,
                    long long rows, int width) {
  __shared__ float acc[kRowsPerBlock][kLane];
  const long long row = warp_row();
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float* s = acc[threadIdx.x >> 5];
  for (int c = lane; c < kLane; c += 32) s[c] = 0.0f;
  const int* irow = idx + row * width;
  const float* vrow = vals + row * width;
  for (int base = 0; base < width; base += 32) {
    const int j = base + lane;
    const int my_idx = j < width ? irow[j] : 0;
    const float my_val = j < width ? vrow[j] : 0.0f;
    const int n = width - base < 32 ? width - base : 32;
    for (int t = 0; t < n; ++t) {
      const int c = __shfl_sync(kFull, my_idx, t);
      const float v = __shfl_sync(kFull, my_val, t);
      // a column outside the row is dropped (the plain version raises)
      if (static_cast<unsigned>(c) < static_cast<unsigned>(kLane) &&
          (c & 31) == lane)
        s[c] = __fadd_rn(s[c], v);
    }
  }
  float* orow = out + row * kLane;
  for (int c = lane; c < kLane; c += 32) orow[c] = s[c];
}

int grid_for(long long rows, int width, unsigned* blocks) {
  if (rows <= 0 || width < 1 || width > kMaxWidth)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long b = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (b > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(b);
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// x: rows x 1024 f32; counts: rows f32, or null for full rows; idx, vals:
// rows x width i32 and f32, 1 <= width <= 128.  Every pointer 16-byte
// aligned.  Launches on `stream` and returns cudaGetLastError() (0 on
// success); never synchronises.
extern "C" int topk_select_f32(const void* x, const void* counts, void* idx,
                               void* vals, long long rows, int width,
                               float fraction, void* stream) {
  unsigned blocks = 0;
  const int err = grid_for(rows, width, &blocks);
  if (err != 0) return err;
  topk_select_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const float*>(counts),
      static_cast<int*>(idx), static_cast<float*>(vals), rows, width,
      fraction);
  return static_cast<int>(cudaGetLastError());
}

// idx, vals: rows x width i32 and f32; out: rows x 1024 f32.
extern "C" int topk_scatter_f32(const void* idx, const void* vals, void* out,
                                long long rows, int width, void* stream) {
  unsigned blocks = 0;
  const int err = grid_for(rows, width, &blocks);
  if (err != 0) return err;
  topk_scatter_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(vals),
      static_cast<float*>(out), rows, width);
  return static_cast<int>(cudaGetLastError());
}
