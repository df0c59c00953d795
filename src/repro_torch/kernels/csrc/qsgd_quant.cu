// Blockwise QSGD quantization on the flatten-once (rows, 1024) f32 layout.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/qsgd_quant.py:
// qsgd_quant_pallas (pl.pallas_call at line 86) and qsgd_dequant_pallas
// (pl.pallas_call at line 109).  Per row of 1024 elements, with s the
// number of levels and BITS in {2, 4, 8} the field width:
//
//   quant:    norm = max |x|;  qscale = s / max(norm, 1e-30);
//             u = rint(x * qscale) + s  in [0, 2s], round half to even;
//             8/BITS fields per byte, element i of a group at bit BITS*i;
//   dequant:  y = (u - s) * (inv_s * norm), then +0 where norm <= 0, with
//             inv_s the f32 reciprocal of s that the caller computes on the
//             host as the reference does (np.float32(1) / np.float32(s)).
//
// Rounding: qscale is one IEEE division per row (__fdiv_rn) and every
// other product and sum is __fmul_rn/__fadd_rn/__fsub_rn, which nvcc does
// not contract into FMAs; rintf rounds half to even, as torch.round and
// jnp.round do.  The max is exact in any order.  So the kernel is
// bit-exact against the plain version, and both against the reference.
//
// Bound: memory.  At the main path's shape, 8 workers x 512 rows of 1024,
// quant reads 16 MiB of x and writes 1024*BITS/8 bytes and one norm per
// row (4-bit: 2 MiB + 16 KiB, 18.9 MB in all, 5.6 us at 3.35 TB/s);
// dequant moves the same bytes the other way.
//
// Design: one warp per row, eight rows per block of 256 threads, as in
// sign_compress.cu.  A lane holds float4 number lane + 32*c of its row for
// the eight chunks c; its four elements are contiguous, so their fields
// form one 8-, 16- or 32-bit word (BITS = 2, 4, 8) at word index
// row*256 + lane + 32*c of the packed matrix: one coalesced store (or
// load, in dequant) per lane per chunk.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kLane = 1024;               // elements per row (LANE)
constexpr int kVecs = kLane / 4;          // float4 per row
constexpr int kChunks = kVecs / 32;       // float4 per lane per row
constexpr int kRowsPerBlock = 8;          // one warp per row
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr unsigned kFull = 0xffffffffu;

// the packed word holding four contiguous fields of BITS bits
template <int BITS> struct Word;
template <> struct Word<2> { using T = uint8_t; };
template <> struct Word<4> { using T = uint16_t; };
template <> struct Word<8> { using T = uint32_t; };

__device__ __forceinline__ long long warp_row() {
  return static_cast<long long>(blockIdx.x) * kRowsPerBlock +
         (threadIdx.x >> 5);
}

__device__ __forceinline__ uint32_t level(float x, float qscale, float s) {
  return static_cast<uint32_t>(__fadd_rn(rintf(__fmul_rn(x, qscale)), s));
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
qsgd_quant_kernel(const float4* __restrict__ x,
                  typename Word<BITS>::T* __restrict__ packed,
                  float* __restrict__ norms, long long rows, float s) {
  const long long row = warp_row();
  if (row >= rows) return;                 // whole warps leave together
  const int lane = threadIdx.x & 31;
  const float4* xr = x + row * kVecs;
  float4 v[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) v[c] = xr[lane + 32 * c];

  float norm = 0.0f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    norm = fmaxf(norm, fmaxf(fmaxf(fabsf(v[c].x), fabsf(v[c].y)),
                             fmaxf(fabsf(v[c].z), fabsf(v[c].w))));
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    norm = fmaxf(norm, __shfl_xor_sync(kFull, norm, off));
  if (lane == 0) norms[row] = norm;
  const float qscale = __fdiv_rn(s, fmaxf(norm, 1e-30f));

  typename Word<BITS>::T* pr = packed + row * kVecs;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const uint32_t word = level(v[c].x, qscale, s) |
                          (level(v[c].y, qscale, s) << BITS) |
                          (level(v[c].z, qscale, s) << (2 * BITS)) |
                          (level(v[c].w, qscale, s) << (3 * BITS));
    pr[lane + 32 * c] = static_cast<typename Word<BITS>::T>(word);
  }
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
qsgd_dequant_kernel(const typename Word<BITS>::T* __restrict__ packed,
                    const float* __restrict__ norms,
                    float4* __restrict__ out, long long rows, float s,
                    float inv_s) {
  const long long row = warp_row();
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const float norm = __ldg(norms + row);
  const float scale = __fmul_rn(inv_s, norm);
  const bool live = norm > 0.0f;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  const typename Word<BITS>::T* pr = packed + row * kVecs;
  float4* orow = out + row * kVecs;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const uint32_t word = pr[lane + 32 * c];
    float y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float u = static_cast<float>((word >> (BITS * i)) & kMask);
      y[i] = live ? __fmul_rn(__fsub_rn(u, s), scale) : 0.0f;
    }
    orow[lane + 32 * c] = make_float4(y[0], y[1], y[2], y[3]);
  }
}

int grid_for(long long rows, unsigned* blocks) {
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long b = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (b > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(b);
  return static_cast<int>(cudaSuccess);
}

template <int BITS>
void quant(const void* x, void* packed, void* norms, long long rows,
           float s, unsigned blocks, cudaStream_t stream) {
  qsgd_quant_kernel<BITS><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float4*>(x),
      static_cast<typename Word<BITS>::T*>(packed),
      static_cast<float*>(norms), rows, s);
}

template <int BITS>
void dequant(const void* packed, const void* norms, void* out,
             long long rows, float s, float inv_s, unsigned blocks,
             cudaStream_t stream) {
  qsgd_dequant_kernel<BITS><<<blocks, kThreads, 0, stream>>>(
      static_cast<const typename Word<BITS>::T*>(packed),
      static_cast<const float*>(norms), static_cast<float4*>(out), rows, s,
      inv_s);
}

}  // namespace

// x: rows x 1024 f32; packed: rows x 1024*bits/8 bytes; norms: rows f32.
// Every pointer 16-byte aligned; bits in {2, 4, 8} with 2*levels + 1 <=
// 2^bits.  Launches on `stream` and returns cudaGetLastError() (0 on
// success); never synchronises.
extern "C" int qsgd_quant_f32(const void* x, void* packed, void* norms,
                              long long rows, float levels, int bits,
                              void* stream) {
  unsigned blocks = 0;
  const int err = grid_for(rows, &blocks);
  if (err != 0) return err;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: quant<2>(x, packed, norms, rows, levels, blocks, st); break;
    case 4: quant<4>(x, packed, norms, rows, levels, blocks, st); break;
    case 8: quant<8>(x, packed, norms, rows, levels, blocks, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// packed: rows x 1024*bits/8 bytes; norms: rows f32; out: rows x 1024 f32.
extern "C" int qsgd_dequant_f32(const void* packed, const void* norms,
                                void* out, long long rows, float levels,
                                float inv_levels, int bits, void* stream) {
  unsigned blocks = 0;
  const int err = grid_for(rows, &blocks);
  if (err != 0) return err;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2:
      dequant<2>(packed, norms, out, rows, levels, inv_levels, blocks, st);
      break;
    case 4:
      dequant<4>(packed, norms, out, rows, levels, inv_levels, blocks, st);
      break;
    case 8:
      dequant<8>(packed, norms, out, rows, levels, inv_levels, blocks, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
