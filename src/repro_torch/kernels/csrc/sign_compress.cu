// Blockwise scaled sign on the flatten-once (rows, 1024) f32 layout.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/sign_compress.py:
// sign_pack_pallas (pl.pallas_call at line 81) and sign_unpack_pallas
// (pl.pallas_call at line 102).  Per row of 1024 elements:
//
//   pack:    scale = (sum of |x|) / max(count, 1);   bit = (x >= 0), with
//            element 8b+j at bit j of byte b (LSB first), so -0.0 and the
//            zero padding pack as 1;
//   unpack:  y = (2*bit - 1) * scale  (a zero scale decodes to +-0).
//
// Rounding: the |x| sum is the fixed balanced binary tree of
// repro_torch/kernels/ref.py:tree_sum (neighbours, then neighbouring
// pairs, ...).  A lane holds one float4 of each 128-element chunk and adds
// (a0 + a1) + (a2 + a3); a butterfly of __shfl_xor_sync at offsets 1, 2,
// 4, 8 and 16 then adds neighbouring lanes, neighbouring pairs of lanes and
// so on (f32 addition commutes, so lane t adding lane t^k forms the same
// tree node on both lanes); the eight chunk sums are combined pairwise.
// Every add is __fadd_rn and the divide is __fdiv_rn (the reference
// divides; it does not multiply by a reciprocal), so the kernel is
// bit-exact against the plain version, which runs the same tree one
// rounded op per call.
//
// Bound: memory.  At the main path's shape, 8 workers x 512 rows of 1024,
// pack reads 16 MiB of x and 16 KiB of counts and writes 512 KiB of bits
// and 16 KiB of scales (17.3 MB: 5.2 us at 3.35 TB/s); unpack moves the
// same bytes the other way.  A few operations per element, far below the
// f32 balance point.
//
// Design: one warp per row, eight rows per block of 256 threads.  A lane
// loads float4 number lane + 32*c of its row for the eight chunks c up
// front, so each warp load is 512 contiguous bytes.  Bits: a lane's four
// signs form a nibble; shifted to its place in a 32-bit word and
// OR-combined over each group of eight lanes, they give one word per
// group, stored by the group's first lane.  Unpack reads the row's 128
// bytes as one 32-bit word per lane and hands each lane the word it needs
// with __shfl_sync; each lane stores one float4 per chunk.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kLane = 1024;               // elements per row (LANE)
constexpr int kVecs = kLane / 4;          // float4 per row
constexpr int kChunks = kVecs / 32;       // float4 per lane per row
constexpr int kWords = kLane / 32;        // 32-bit words of bits per row
constexpr int kRowsPerBlock = 8;          // one warp per row
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long warp_row() {
  return static_cast<long long>(blockIdx.x) * kRowsPerBlock +
         (threadIdx.x >> 5);
}

__device__ __forceinline__ float abs_sum4(float4 v) {
  return __fadd_rn(__fadd_rn(fabsf(v.x), fabsf(v.y)),
                   __fadd_rn(fabsf(v.z), fabsf(v.w)));
}

__device__ __forceinline__ uint32_t sign_nibble(float4 v) {
  return (v.x >= 0.0f ? 1u : 0u) | (v.y >= 0.0f ? 2u : 0u) |
         (v.z >= 0.0f ? 4u : 0u) | (v.w >= 0.0f ? 8u : 0u);
}

__global__ void __launch_bounds__(kThreads)
sign_pack_kernel(const float4* __restrict__ x,
                 const float* __restrict__ counts,
                 uint32_t* __restrict__ packed, float* __restrict__ scales,
                 long long rows) {
  const long long row = warp_row();
  if (row >= rows) return;                 // whole warps leave together
  const int lane = threadIdx.x & 31;
  const float4* xr = x + row * kVecs;
  float4 v[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) v[c] = xr[lane + 32 * c];

  float part[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    float s = abs_sum4(v[c]);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
      s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
    part[c] = s;                           // sum of chunk c, on every lane
  }
#pragma unroll
  for (int n = kChunks / 2; n >= 1; n >>= 1) {
#pragma unroll
    for (int c = 0; c < n; ++c)
      part[c] = __fadd_rn(part[2 * c], part[2 * c + 1]);
  }
  if (lane == 0)
    scales[row] = __fdiv_rn(part[0], fmaxf(__ldg(counts + row), 1.0f));

  const int shift = 4 * (lane & 7);
  uint32_t* pr = packed + row * kWords;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    uint32_t word = sign_nibble(v[c]) << shift;
    word |= __shfl_xor_sync(kFull, word, 1);
    word |= __shfl_xor_sync(kFull, word, 2);
    word |= __shfl_xor_sync(kFull, word, 4);
    if ((lane & 7) == 0) pr[4 * c + (lane >> 3)] = word;
  }
}

__global__ void __launch_bounds__(kThreads)
sign_unpack_kernel(const uint32_t* __restrict__ packed,
                   const float* __restrict__ scales,
                   float4* __restrict__ out, long long rows) {
  const long long row = warp_row();
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const uint32_t mine = packed[row * kWords + lane];
  const float scale = __ldg(scales + row);
  const int shift = 4 * (lane & 7);
  float4* orow = out + row * kVecs;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const uint32_t nib =
        __shfl_sync(kFull, mine, 4 * c + (lane >> 3)) >> shift;
    float4 y;
    y.x = __fmul_rn((nib & 1u) ? 1.0f : -1.0f, scale);
    y.y = __fmul_rn((nib & 2u) ? 1.0f : -1.0f, scale);
    y.z = __fmul_rn((nib & 4u) ? 1.0f : -1.0f, scale);
    y.w = __fmul_rn((nib & 8u) ? 1.0f : -1.0f, scale);
    orow[lane + 32 * c] = y;
  }
}

int grid_for(long long rows, unsigned* blocks) {
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long b = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (b > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(b);
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// x: rows x 1024 f32; counts, scales: rows f32; packed: rows x 128 bytes.
// Every pointer 16-byte aligned.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int sign_pack_f32(const void* x, const void* counts, void* packed,
                             void* scales, long long rows, void* stream) {
  unsigned blocks = 0;
  const int err = grid_for(rows, &blocks);
  if (err != 0) return err;
  sign_pack_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const float*>(counts),
      static_cast<uint32_t*>(packed), static_cast<float*>(scales), rows);
  return static_cast<int>(cudaGetLastError());
}

// packed: rows x 128 bytes; scales: rows f32; out: rows x 1024 f32.
extern "C" int sign_unpack_f32(const void* packed, const void* scales,
                               void* out, long long rows, void* stream) {
  unsigned blocks = 0;
  const int err = grid_for(rows, &blocks);
  if (err != 0) return err;
  sign_unpack_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), static_cast<const float*>(scales),
      static_cast<float4*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}
