// Fused gossip mix on the flatten-once (K, rows, 1024) f32 layout:
//
//   y[k, r, :] = sum_j w_j * v_j[k, r, :],   1 <= n <= kMaxInputs
//   v_j[k, r]  = x_j[src_j(k), r]  if r < lim_j,  else +0.0
//
// Replaces the Pallas TPU kernel src/repro/kernels/gossip_mix.py,
// gossip_mix (pl.pallas_call at line 43), and the view copies its caller
// made around it: the neighbour views of a shift graph are read in place.
// src_j is the worker-grid shift of one topology axis (the inverse of
// torch.roll): with the grid row-major and the axis of `size` workers whose
// stride is `inner`, worker k reads the worker whose index on that axis is
// (i + shift_j) mod size, i = (k / inner) mod size.  Shift 0 is the
// identity: the self view, the partial sum of a chained launch, and every
// input of a mix of distinct matrices (K = 1, all rows folded).  lim_j is
// the wire extent for a neighbour view and `rows` otherwise; a row past it
// is +0.0 and still takes part in the sum, as the zero rows of the padded
// copy did.  The sum runs left to right from w_0 * v_0 with no leading
// zero term, every product and sum rounded on its own (__fmul_rn,
// __fadd_rn): no FMA contraction, so the kernel is bit-exact against the
// plain PyTorch version (repro_torch/kernels/ref.py), signs of zero too.
//
// Bound: memory.  Each distinct input element is read once and each
// output written once: on the main path (a ring of 8 workers, three views
// of one (8, 512, 1024) matrix) 16 MiB in and 16 MiB out, 10 us at
// 3.35 TB/s, though the views reach 2.2x those bytes.
//
// Two designs, chosen per launch from the input:
//  - tile: only when every view reads one matrix.  A persistent block
//    stages one row segment of all K workers (16 KiB) into shared memory
//    with 16-byte cp.async, double-buffered so the copies of the next tile
//    overlap the sums and stores of this one, and mixes every worker's
//    output from the staged rows, through a per-block table of each view's
//    source offset: each input byte leaves HBM once and crosses L2 once,
//    whatever the number of views.  Taken wherever it fits and n > 1.
//  - stream: one 256-thread block per row of one worker, one float4 a
//    thread, all loads of up to kChunk views issued before the first
//    product.  Shifted views: a 2-D grid, workers fastest, so the blocks
//    that read worker k's row r through their shifted views run next to
//    each other and the repeats are served from L2.  Distinct matrices: a
//    1-D grid over the rows, no index arithmetic beyond the row.  The
//    output is stored evict-first (__stcs): on the H100, at n = 2 on
//    (4096, 1024), that took 0.45 us off a launch in MT's round and 3 %
//    off a launch on cold inputs.  Taken for distinct matrices, one view,
//    or a grid too wide for the tile; and for shifted views of two
//    matrices (the bf16 wire: the self view reads the f32 matrix, the
//    neighbour views its bf16 round trip), since each view reads its own x.
// The n input descriptors travel by value as one __grid_constant__
// parameter struct sized to n; the SM count is queried once per device.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;         // one 1024-lane row as float4s
constexpr int kRow4 = 256;            // float4s per row
constexpr int kMaxInputs = 32;
constexpr int kChunk = 8;             // views whose loads are in flight at once
constexpr int kStage4 = 1024;         // float4s of one tile stage (16 KiB)
constexpr int kOutputs = kStage4 / kThreads;   // tile outputs a thread
constexpr int kMaxTable = 4096;       // views x workers in the tile's table
// Tile blocks a SM in the persistent grid: each holds at most 48 KiB of
// shared memory and 256 threads, so 4 are resident at once; a larger grid
// leaves each block fewer tiles to overlap in its double buffer.
constexpr int kTileBlocksPerSm = 4;
constexpr int kMaxDevices = 64;
constexpr int kMaxGridY = 65535;

// One input.  Layout shared with the ctypes structure in gossip_mix.py.
struct View {
  const float4* x;   // (K, rows, 1024) f32
  float w;
  int shift;         // in [0, size)
  long long lim;     // rows below lim are read, the rest are +0.0; <= rows
};
static_assert(sizeof(View) == 24, "View layout is shared with ctypes");

template <int kCap>
struct Mix {
  View v[kCap];
  long long rows;    // rows per worker
  int n;
  int k;             // workers
  int inner;         // stride of the shifted axis in the worker grid
  int size;          // workers along the shifted axis
};

__device__ __forceinline__ float4 axpy(float4 acc, float w, float4 v) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(w, v.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(w, v.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(w, v.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(w, v.w));
  return acc;
}

__device__ __forceinline__ float4 scale(float w, float4 v) {
  return make_float4(__fmul_rn(w, v.x), __fmul_rn(w, v.y),
                     __fmul_rn(w, v.z), __fmul_rn(w, v.w));
}

// The worker that worker k, at index i on the shifted axis, reads.
__device__ __forceinline__ int source(int k, int i, int shift, int size,
                                      int inner) {
  const int s = i + shift < size ? i + shift : i + shift - size;
  return k + (s - i) * inner;
}

// kN > 0: exactly kN views (kN <= kChunk); kN == 0: any p.n, in chunks of
// kChunk.  With kShift the grid is (K, rows) and block (x, y) mixes row y
// of worker x, else it is (rows) over one folded worker; a grid smaller
// than the rows loops over them.
template <int kN, bool kShift, int kCap>
__global__ void __launch_bounds__(kThreads)
gossip_mix_kernel(const __grid_constant__ Mix<kCap> p,
                  float4* __restrict__ out) {
  constexpr int kC = kN > 0 ? kN : kChunk;
  const int n = kN > 0 ? kN : p.n;
  const int t = threadIdx.x;
  const int k = kShift ? static_cast<int>(blockIdx.x) : 0;
  const int i = kShift ? (k / p.inner) % p.size : 0;
  const long long first = kShift ? blockIdx.y : blockIdx.x;
  const long long step = kShift ? gridDim.y : gridDim.x;
  for (long long r = first; r < p.rows; r += step) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = 0; j0 < n; j0 += kC) {
      float4 v[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int j = j0 + c;
        if (kN > 0 || j < n) {
          const View& vw = p.v[j];
          const long long src =
              kShift ? source(k, i, vw.shift, p.size, p.inner) : 0;
          v[c] = r < vw.lim ? __ldg(vw.x + (src * p.rows + r) * kRow4 + t)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int j = j0 + c;
        if (kN > 0 || j < n) {
          const float w = p.v[j].w;
          acc = j == 0 ? scale(w, v[c]) : axpy(acc, w, v[c]);
        }
      }
    }
    __stcs(out + (static_cast<long long>(k) * p.rows + r) * kRow4 + t, acc);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Every view reads p.v[0].x.  Tile t is row t / chunks, float4 lanes
// [lanes4 * (t mod chunks), +lanes4) of every worker; lanes4 = 2^log_lanes4
// and K * lanes4 <= kStage4.  Dynamic shared memory: two stages of
// K * lanes4 float4s, then the n x K table of each view's source offset in
// a stage.
template <int kCap>
__global__ void __launch_bounds__(kThreads)
gossip_mix_tile_kernel(const __grid_constant__ Mix<kCap> p,
                       float4* __restrict__ out, int log_lanes4,
                       long long tiles) {
  extern __shared__ __align__(16) float4 smem[];
  const int t = threadIdx.x;
  const int lanes4 = 1 << log_lanes4;
  const int per = p.k << log_lanes4;            // float4s of one stage
  const int chunks = kRow4 >> log_lanes4;
  int* const offset = reinterpret_cast<int*>(smem + 2 * per);
  const float4* x = p.v[0].x;
  for (int e = t; e < p.n * p.k; e += kThreads) {
    const int j = e / p.k;
    const int k = e - j * p.k;
    offset[e] = source(k, (k / p.inner) % p.size, p.v[j].shift, p.size,
                       p.inner) << log_lanes4;
  }
  auto load = [&](long long tile, float4* st) {
    const long long r = tile / chunks;
    const int c0 = static_cast<int>(tile % chunks) << log_lanes4;
#pragma unroll 4
    for (int e = t; e < per; e += kThreads) {
      const int w = e >> log_lanes4;
      cp_async16(&st[e], x + (static_cast<long long>(w) * p.rows + r) *
                                 kRow4 + c0 + (e & (lanes4 - 1)));
    }
  };
  long long tile = blockIdx.x;
  if (tile < tiles) load(tile, smem);
  cp_async_commit();
  for (int s = 0; tile < tiles; tile += gridDim.x, s ^= 1) {
    if (tile + gridDim.x < tiles) {
      load(tile + gridDim.x, smem + (s ^ 1) * per);
    }
    cp_async_commit();          // possibly empty: keeps wait_group 1 exact
    cp_async_wait_one();
    __syncthreads();            // this tile's copies (and the table) landed
    const float4* st = smem + s * per;
    const long long r = tile / chunks;
    const int c0 = static_cast<int>(tile % chunks) << log_lanes4;
    // each thread's up to kOutputs outputs, mixed view by view so their
    // shared-memory reads are independent
    float4 acc[kOutputs];
    int at[kOutputs];
#pragma unroll
    for (int q = 0; q < kOutputs; ++q) {
      acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      at[q] = t + q * kThreads;
    }
    for (int j = 0; j < p.n; ++j) {
      const View& vw = p.v[j];
      const bool cut = r >= vw.lim;
      const int* row = offset + j * p.k;
#pragma unroll
      for (int q = 0; q < kOutputs; ++q) {
        if (at[q] < per) {
          const int k = at[q] >> log_lanes4;
          const float4 v = cut ? make_float4(0.f, 0.f, 0.f, 0.f)
                               : st[row[k] + (at[q] & (lanes4 - 1))];
          acc[q] = j == 0 ? scale(vw.w, v) : axpy(acc[q], vw.w, v);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kOutputs; ++q) {
      if (at[q] < per) {
        const int k = at[q] >> log_lanes4;
        out[(static_cast<long long>(k) * p.rows + r) * kRow4 + c0 +
            (at[q] & (lanes4 - 1))] = acc[q];
      }
    }
    __syncthreads();            // stage s is free for the tile after next
  }
}

// The SM count of each device, asked of the runtime once.
int g_sms[kMaxDevices];

cudaError_t device_sms(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_sms[device] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  *sms = g_sms[device];
  return cudaSuccess;
}

int floor_log2(int v) {
  int l = 0;
  while ((2 << l) <= v) ++l;
  return l;
}

template <int kCap>
Mix<kCap> pack(const View* vs, int n, int k, long long rows, int inner,
               int size) {
  Mix<kCap> p = {};
  for (int j = 0; j < n; ++j) p.v[j] = vs[j];
  p.rows = rows;
  p.n = n;
  p.k = k;
  p.inner = inner;
  p.size = size;
  return p;
}

template <int kCap>
cudaError_t launch_tile(const View* vs, int n, int k, long long rows,
                        int inner, int size, float4* out, cudaStream_t s) {
  const Mix<kCap> p = pack<kCap>(vs, n, k, rows, inner, size);
  int log_lanes4 = floor_log2(kStage4 / k);
  if (log_lanes4 > 8) log_lanes4 = 8;            // a whole row
  const int smem = 2 * (k << log_lanes4) * 16 + n * k * 4;
  int sms = 0;
  const cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return err;
  const long long tiles = rows * (kRow4 >> log_lanes4);
  long long grid = static_cast<long long>(sms) * kTileBlocksPerSm;
  if (grid > tiles) grid = tiles;
  gossip_mix_tile_kernel<kCap><<<static_cast<unsigned>(grid), kThreads, smem,
                                 s>>>(p, out, log_lanes4, tiles);
  return cudaGetLastError();
}

// One instance per exact n <= kChunk (kN), the rest in chunks (kN = 0);
// the parameter block holds kN views, or kMaxInputs.
template <int kN, bool kShift>
void launch_n(const View* vs, int n, int k, long long rows, int inner,
              int size, float4* out, dim3 grid, cudaStream_t s) {
  constexpr int kCap = kN > 0 ? kN : kMaxInputs;
  const Mix<kCap> p = pack<kCap>(vs, n, k, rows, inner, size);
  gossip_mix_kernel<kN, kShift, kCap><<<grid, kThreads, 0, s>>>(p, out);
}

template <bool kShift>
void launch_stream(const View* vs, int n, int k, long long rows, int inner,
                   int size, float4* out, dim3 grid, cudaStream_t s) {
#define GOSSIP_MIX_N(N)                                                   \
  launch_n<N, kShift>(vs, n, k, rows, inner, size, out, grid, s)
  switch (n) {
    case 1: GOSSIP_MIX_N(1); break;
    case 2: GOSSIP_MIX_N(2); break;
    case 3: GOSSIP_MIX_N(3); break;
    case 4: GOSSIP_MIX_N(4); break;
    case 5: GOSSIP_MIX_N(5); break;
    case 6: GOSSIP_MIX_N(6); break;
    case 7: GOSSIP_MIX_N(7); break;
    case 8: GOSSIP_MIX_N(8); break;
    default: GOSSIP_MIX_N(0); break;
  }
#undef GOSSIP_MIX_N
}

}  // namespace

// views: n descriptors (each x a (k, rows, 1024) f32 tensor, 16-byte
// aligned; shift in [0, size); 0 <= lim <= rows); the worker grid's
// shifted axis has `size` workers at stride `inner` (inner * size divides
// k); out: (k, rows, 1024) f32 that aliases no input.  The tile design is
// taken where one matrix is behind every view, n > 1, k <= kStage4 and
// n * k <= kMaxTable, unless `force_stream` is nonzero (to time the
// stream design on the same views); else the stream design.  Launches on
// `stream` and returns cudaGetLastError() (0 on success); never
// synchronises.
extern "C" int gossip_mix_f32(const void* views, int n, int k,
                              long long rows, int inner, int size,
                              int force_stream, void* out, void* stream) {
  if (n < 1 || n > kMaxInputs || k < 1 || rows < 0 || inner < 1 ||
      size < 1 || k % (inner * size) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const View* given = static_cast<const View*>(views);
  View vs[kMaxInputs];
  bool one_matrix = true, shift = false;
  for (int j = 0; j < n; ++j) {
    vs[j] = given[j];
    if (vs[j].shift < 0 || vs[j].shift >= size || vs[j].lim < 0 ||
        vs[j].lim > rows) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    one_matrix = one_matrix && vs[j].x == vs[0].x;
    shift = shift || vs[j].shift != 0 || vs[j].lim < rows;
  }
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float4*>(out);
  if (!force_stream && n > 1 && one_matrix && k <= kStage4 &&
      n * k <= kMaxTable) {
    const cudaError_t err =
        n <= 4 ? launch_tile<4>(vs, n, k, rows, inner, size, o, s)
        : n <= 8 ? launch_tile<8>(vs, n, k, rows, inner, size, o, s)
        : n <= 16 ? launch_tile<16>(vs, n, k, rows, inner, size, o, s)
                  : launch_tile<kMaxInputs>(vs, n, k, rows, inner, size, o, s);
    return static_cast<int>(err);
  }
  // Views that each worker reads from another worker, or cut per worker,
  // take a 2-D grid (workers, rows); otherwise the k workers' rows are
  // folded into one and the grid is 1-D over them.
  if (!shift) {
    rows *= k;
    k = inner = size = 1;
    for (int j = 0; j < n; ++j) vs[j].lim = rows;
  }
  long long gy = rows;
  if (gy > (shift ? kMaxGridY : 0x7fffffffLL)) {
    gy = shift ? kMaxGridY : 0x7fffffffLL;
  }
  if (shift) {
    launch_stream<true>(vs, n, k, rows, inner, size, o,
                        dim3(k, static_cast<unsigned>(gy)), s);
  } else {
    launch_stream<false>(vs, n, k, rows, inner, size, o,
                         dim3(static_cast<unsigned>(gy)), s);
  }
  return static_cast<int>(cudaGetLastError());
}
