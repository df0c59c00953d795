// Fused gossip mix on the flatten-once (rows, 1024) f32 layout:
//
//   y = w0*x0 + w1*x1 + ... + w(n-1)*x(n-1),   1 <= n <= kMaxInputs
//
// Replaces the Pallas TPU kernel src/repro/kernels/gossip_mix.py,
// gossip_mix (pl.pallas_call at line 43).  The sum runs left to right from
// w0*x0 with no leading zero term, as the Pallas body does, and every
// product and sum is rounded on its own (__fmul_rn, __fadd_rn): no FMA
// contraction, so the kernel is bit-exact against the plain PyTorch
// version (repro_torch/kernels/ref.py).
//
// Bound: memory.  Each element reads n inputs and writes one output,
// 4(n+1) bytes for 2n-1 flops.  On the main path (a ring of 8 workers:
// self view plus two neighbour views, weights 1/3) one call moves
// 4 x 16 MiB = 64 MiB: 20 us at 3.35 TB/s.
//
// Design: the n input pointers and weights travel by value in one struct
// of kernel parameters, with one instantiation per n up to kMaxInputs.
// More inputs (the exponential graph's 9 at K = 16) are chained by the
// wrapper (kernels/gossip_mix.py): each later launch takes the partial sum
// as its first input with weight 1.0, and __fmul_rn(1.0f, a) is exact, so
// the chain rounds as one left-to-right sum; each chained launch moves 8
// bytes more an element (the partial sum written, then read again).  One
// thread per 4 elements with float4 loads and stores, a grid-stride loop
// over at most 8 blocks of 256 threads per SM, the ragged last sweep
// masked by the loop bound.  The neighbour views are materialised by the
// caller (torch.roll of the worker grid); reading them in place through
// shifted addressing is left for a later change.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxInputs = 8;

struct MixInputs {
  const float4* x[kMaxInputs];
  float w[kMaxInputs];
};

// One instantiation per input count: all n loads of an element are issued
// before the first is used, and the parameter struct is indexed statically
// (no local-memory copy of it).
template <int kN>
__global__ void __launch_bounds__(kThreads)
gossip_mix_kernel(const MixInputs in, float4* __restrict__ out,
                  long long n4) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n4; i += stride) {
    float4 v[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) v[j] = in.x[j][i];
    const float w0 = in.w[0];
    float4 acc = make_float4(__fmul_rn(w0, v[0].x), __fmul_rn(w0, v[0].y),
                             __fmul_rn(w0, v[0].z), __fmul_rn(w0, v[0].w));
#pragma unroll
    for (int j = 1; j < kN; ++j) {
      const float w = in.w[j];
      acc.x = __fadd_rn(acc.x, __fmul_rn(w, v[j].x));
      acc.y = __fadd_rn(acc.y, __fmul_rn(w, v[j].y));
      acc.z = __fadd_rn(acc.z, __fmul_rn(w, v[j].z));
      acc.w = __fadd_rn(acc.w, __fmul_rn(w, v[j].w));
    }
    out[i] = acc;
  }
}

template <int kN>
void launch(const MixInputs& in, float4* out, long long n4,
            unsigned blocks, cudaStream_t stream) {
  gossip_mix_kernel<kN><<<blocks, kThreads, 0, stream>>>(in, out, n4);
}

}  // namespace

// xs: n pointers to n_elems contiguous f32 each, 16-byte aligned,
// n_elems % 4 == 0; ws: n host weights; out: n_elems f32 that aliases no
// input.  Launches on `stream` and returns cudaGetLastError() (0 on
// success); never synchronises.
extern "C" int gossip_mix_f32(const void* const* xs, const float* ws, int n,
                              void* out, long long n_elems, void* stream) {
  if (n < 1 || n > kMaxInputs || n_elems % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n4 = n_elems / 4;
  if (n4 == 0) return static_cast<int>(cudaSuccess);
  MixInputs in = {};
  for (int j = 0; j < n; ++j) {
    in.x[j] = static_cast<const float4*>(xs[j]);
    in.w[j] = ws[j];
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (n4 + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  const auto b = static_cast<unsigned>(blocks);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float4*>(out);
  switch (n) {
    case 1: launch<1>(in, o, n4, b, s); break;
    case 2: launch<2>(in, o, n4, b, s); break;
    case 3: launch<3>(in, o, n4, b, s); break;
    case 4: launch<4>(in, o, n4, b, s); break;
    case 5: launch<5>(in, o, n4, b, s); break;
    case 6: launch<6>(in, o, n4, b, s); break;
    case 7: launch<7>(in, o, n4, b, s); break;
    default: launch<8>(in, o, n4, b, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
