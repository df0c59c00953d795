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
//            (rounded to nearest, subnormals flushed as the card's
//            scatter_add flushes them), so (0, 0.0) placeholders add
//            nothing and a -0.0 value lands as +0.0.
//
// Bound: memory.  At the main path's shape, 8 workers x 512 rows of 1024 at
// fraction 0.1 (W = 103), select reads the x of the 2480 rows with a
// nonzero count (the other 1616 are placeholders only) and 16 KiB of counts
// and writes 4096 x 103 x 8 B of slots (13.55 MB: 4.0 us at 3.35 TB/s);
// scatter reads every slot and writes every row (20.15 MB: 6.0 us).
//
// What the first design lost to.  The Pallas kernel unrolls W rounds of
// (row max, lowest-index argmax, mask out), which a TPU's vector unit does
// on a whole row at once.  Its first CUDA port (one warp per row, 32 keys
// a lane) kept the W rounds: each was a 5-step 64-bit shuffle butterfly
// and a 32-key retire by one lane, a serial chain of about 1,900 cycles,
// 103 times per row; at 93 registers a thread only 2 blocks fit an SM.  It
// took 0.220 ms on an H100, slower than torch.topk.
//
// Design, select: a radix select, whose work per row does not depend on
// W.  One block of 64 threads (two warps) per row; thread t loads float4s
// t, t+64, t+128 and t+192 of the row (each warp load is 512 contiguous
// bytes) and keeps the 16 elements as bits in registers.  A row with
// k_active = 0 (alignment padding, count 0) only writes its placeholders.
//   1. The key of an element is u = its |x| bits (31 bits; the order of
//      u is the order of |x|, NaN above inf as a bit pattern).  Four passes
//      over digits of 7, 8, 8 and 8 bits, from the top, narrow the prefix
//      of T, the k-th largest key: each pass counts the keys that match the
//      prefix so far into a 256-bin shared histogram of their next digit
//      (one histogram per pass, all four zeroed behind one barrier, so a
//      pass costs one barrier), then both warps scan the bins from the top
//      on their own (a shuffle scan over 8 bins a lane) and find the digit
//      where the count reaches the k still to take.  The passes stop early
//      once the bin of T holds exactly the keys still to take.
//      The first digit holds the top of the exponent, where nearly every
//      key of a row falls into a few bins, and a row of equal |x| falls
//      into one bin on every pass.  On the H100, plain shared atomicAdds
//      were faster here than adds aggregated per warp, by __match_any_sync
//      or by a ballot loop, on random rows and on rows of equal |x| alike.
//   2. Winners: every key above the prefix of T, and of the keys equal to
//      it the `need` lowest columns (the reference's tie rule), found by a
//      block-wide exclusive count in column order (ballot and __popc per
//      warp and chunk, then the per-(chunk, warp) totals); the same count
//      places the winners at distinct shared slots, strict winners first,
//      then the ties in column order.
//   3. Order: each winner is written to shared memory as the unique 64-bit
//      key  (u << 32) | ((1024 - column) << 1) | sign bit  (larger key =
//      larger |x|, then lower column), and ranked by counting the keys
//      above it (a thread ranks winners t and t+64); ties of equal |x| are
//      already in rank order and skip the count.  Column and value are
//      decoded from the key, so a selected -0.0 stays -0.0.  The block then
//      stores slot j, or (0, 0.0) for j >= k, with coalesced stores.
//   Shared memory: 4 KiB of histograms, 1 KiB of keys, 1 KiB of sorted
//   slots, 6.2 KiB a block.  Launch bounds of 12 blocks an SM leave ptxas
//   80 registers a thread and no spills (16 blocks, at 64 registers, spill
//   a word and run no faster); ptxas -v's counts are in PERF.md.
//
// Design, scatter: one block of 128 threads per row (W <= 128: one slot a
// thread).  The row is zeroed in 4 KiB of shared memory, one float4 store
// per 128 columns a thread.  The add is the card's scatter_add's: a float
// atomicAdd on global memory flushes subnormal inputs and results to zero
// of the same sign (so does XLA on the CPU; the TPU has no subnormals).  A
// slot whose value is +-0.0 or subnormal is skipped: under round-to-nearest
// a sum that starts at +0.0 is never -0.0, y + (+-0) = y for y != 0 and
// +0 + (+-0) = +0, so such a slot changes no bit of a column that no other
// live slot names.  That removes the W - k placeholders (all at column 0)
// and every slot of a dead row.  Each live slot writes 0.0 + val into its
// column with an atomicCAS from +0.0; a failed CAS means a second live
// slot named the column, and then the row is zeroed again and one thread
// adds every slot in slot order (the select never emits such a pair, but
// the scatter's contract holds for any input).  A column outside the row
// is dropped (the plain version raises).  The row is stored as one float4
// per 128 columns a thread.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kLane = 1024;               // elements per row (LANE)
constexpr int kVecs = kLane / 4;          // float4 per row
constexpr int kMaxWidth = 128;            // MAX_WIDTH of the wrapper
constexpr int kSelThreads = 64;           // select: two warps per row
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kChunks = kVecs / kSelThreads;  // float4 a thread
constexpr int kBins = 256;
constexpr int kPasses = 4;                // digits of bits 30-24, 23-16, 15-8, 7-0
constexpr int kScatThreads = kMaxWidth;   // scatter: one slot a thread
constexpr unsigned kFull = 0xffffffffu;
static_assert(kPasses * kBins == 4 * kChunks * kSelThreads,
              "the histograms are zeroed with one int4 per chunk a thread");

struct SelectShared {
  int hist[kPasses][kBins];
  // per (chunk, warp), in column order: keys above T's prefix, keys equal
  int above[kChunks][kSelWarps];
  int ties[kChunks][kSelWarps];
  unsigned long long keys[kMaxWidth];     // the winners, unordered
  int out_idx[kMaxWidth];                 // the winners, in slot order
  float out_val[kMaxWidth];
};

__device__ __forceinline__ unsigned long long make_key(uint32_t bits,
                                                       int col) {
  return (static_cast<unsigned long long>(bits & 0x7fffffffu) << 32) |
         (static_cast<unsigned long long>(kLane - col) << 1) | (bits >> 31);
}

__device__ __forceinline__ int key_column(unsigned long long key) {
  return kLane - static_cast<int>((key >> 1) & 0x7ffu);
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  return __uint_as_float(static_cast<uint32_t>(key >> 32) |
                         (static_cast<uint32_t>(key & 1u) << 31));
}

__global__ void __launch_bounds__(kSelThreads, 12)
topk_select_kernel(const float4* __restrict__ x,
                   const float* __restrict__ counts, int* __restrict__ idx,
                   float* __restrict__ vals, int width, float fraction) {
  __shared__ SelectShared sh;
  const long long row = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float count = counts ? __ldg(counts + row) : static_cast<float>(kLane);
  int k = static_cast<int>(ceilf(__fmul_rn(fraction, count)));
  k = k < 0 ? 0 : (k > width ? width : k);
  int* irow = idx + row * width;
  float* vrow = vals + row * width;
  if (k == 0) {                            // the whole block leaves together
    for (int j = t; j < width; j += kSelThreads) {
      irow[j] = 0;
      vrow[j] = 0.0f;
    }
    return;
  }

  // Element 4c + i of this thread is column 4 * (64c + t) + i.
  uint32_t b[4 * kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const float4 v = __ldg(x + row * kVecs + kSelThreads * c + t);
    b[4 * c + 0] = __float_as_uint(v.x);
    b[4 * c + 1] = __float_as_uint(v.y);
    b[4 * c + 2] = __float_as_uint(v.z);
    b[4 * c + 3] = __float_as_uint(v.w);
  }
  // kPasses * kBins ints: four int4 a thread
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    reinterpret_cast<int4*>(&sh.hist[0][0])[kSelThreads * c + t] =
        make_int4(0, 0, 0, 0);
  __syncthreads();

  // T's bits at and above `shift` are `prefix`; `need` keys are still to
  // take among the keys that match it.
  uint32_t prefix = 0;
  int shift = 31, need = k;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int low = 24 - 8 * p;            // the digit is bits [low, shift)
    int* h = sh.hist[p];
#pragma unroll
    for (int e = 0; e < 4 * kChunks; ++e) {
      const uint32_t u = b[e] & 0x7fffffffu;
      if (p == 0 || (u >> shift) == prefix)
        atomicAdd(h + ((u >> low) & 0xffu), 1);
    }
    __syncthreads();
    // Lane l holds bins 255-8l down to 248-8l; each warp scans on its own.
    const int4 hi = reinterpret_cast<const int4*>(h)[63 - 2 * lane];
    const int4 lo = reinterpret_cast<const int4*>(h)[62 - 2 * lane];
    const int c8[8] = {hi.w, hi.z, hi.y, hi.x, lo.w, lo.z, lo.y, lo.x};
    int sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) sum += c8[j];
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    // The first lane whose bins reach `need` holds T's digit: the first of
    // its bins where the running count does.
    const int src = __ffs(__ballot_sync(kFull, incl >= need)) - 1;
    int run = incl - sum;
    int digit = 255 - 8 * lane, before = run, cnt = c8[0];
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      run += c8[j];
      if (run < need) {
        digit = 254 - 8 * lane - j;
        before = run;
        cnt = c8[j + 1];
      }
    }
    digit = __shfl_sync(kFull, digit, src);
    before = __shfl_sync(kFull, before, src);
    cnt = __shfl_sync(kFull, cnt, src);
    prefix = (prefix << (shift - low)) | static_cast<uint32_t>(digit);
    shift = low;
    need -= before;
    if (cnt == need) break;                // uniform: every warp read h
  }

  // Winners: k - need keys above the prefix, and the `need` lowest
  // columns of the keys equal to it.  Columns run chunk by chunk, then
  // warp, lane and element: count in that order.
  const unsigned lt = (1u << lane) - 1u;
  int lane_gt[kChunks], lane_eq[kChunks];  // keys of lower lanes, per chunk
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    int pg = 0, pe = 0, tg = 0, te = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t d = (b[4 * c + i] & 0x7fffffffu) >> shift;
      const unsigned bg = __ballot_sync(kFull, d > prefix);
      const unsigned be = __ballot_sync(kFull, d == prefix);
      pg += __popc(bg & lt);
      pe += __popc(be & lt);
      tg += __popc(bg);
      te += __popc(be);
    }
    lane_gt[c] = pg;
    lane_eq[c] = pe;
    if (lane == 0) {
      sh.above[c][warp] = tg;
      sh.ties[c][warp] = te;
    }
  }
  __syncthreads();
  const int strict = k - need;
  int base_gt = 0, base_eq = 0;            // keys of lower (chunk, warp)s
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    int pos_gt = base_gt + lane_gt[c], pos_eq = base_eq + lane_eq[c];
#pragma unroll
    for (int w = 0; w < kSelWarps; ++w) {
      if (w < warp) {
        pos_gt += sh.above[c][w];
        pos_eq += sh.ties[c][w];
      }
      base_gt += sh.above[c][w];
      base_eq += sh.ties[c][w];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t bits = b[4 * c + i];
      const uint32_t d = (bits & 0x7fffffffu) >> shift;
      const int col = 4 * (kSelThreads * c + t) + i;
      if (d > prefix) {
        sh.keys[pos_gt++] = make_key(bits, col);
      } else if (d == prefix) {
        if (pos_eq < need) sh.keys[strict + pos_eq] = make_key(bits, col);
        ++pos_eq;
      }
    }
  }
  __syncthreads();

  // Rank winners t and t + 64 by the keys above them; keys are unique, so
  // the ranks are a permutation of 0..k-1.  After all four passes the ties
  // are equal |x|, below every strict winner and placed in column order,
  // which is their order: winner j >= strict then has rank j, and only the
  // strict winners are compared.  After an early stop the bin of T holds
  // keys that differ in their low bits, and every winner is compared.
  const int ranked = shift == 0 ? strict : k;
  const unsigned long long k0 = t < k ? sh.keys[t] : 0ull;
  const unsigned long long k1 =
      t + kSelThreads < k ? sh.keys[t + kSelThreads] : 0ull;
  int r0 = t, r1 = t + kSelThreads;
  if (t < ranked || t + kSelThreads < ranked) {
    int c0 = 0, c1 = 0;
#pragma unroll 4
    for (int m = 0; m < ranked; ++m) {
      const unsigned long long km = sh.keys[m];
      c0 += km > k0 ? 1 : 0;
      c1 += km > k1 ? 1 : 0;
    }
    if (t < ranked) r0 = c0;
    if (t + kSelThreads < ranked) r1 = c1;
  }
  if (t < k) {
    sh.out_idx[r0] = key_column(k0);
    sh.out_val[r0] = key_value(k0);
  }
  if (t + kSelThreads < k) {
    sh.out_idx[r1] = key_column(k1);
    sh.out_val[r1] = key_value(k1);
  }
  __syncthreads();
  for (int j = t; j < width; j += kSelThreads) {
    irow[j] = j < k ? sh.out_idx[j] : 0;
    vrow[j] = j < k ? sh.out_val[j] : 0.0f;
  }
}

// The add of the plain version on the card: a float atomicAdd on global
// memory (scatter_add) rounds to nearest and flushes subnormal inputs and
// results to zero of the same sign, as XLA on the CPU and the TPU do.
__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// A slot in the row whose value is normal, inf or NaN.  Any other slot
// adds a zero after the flush, which changes no bit of the column when no
// other live slot names it.
__device__ __forceinline__ bool live_slot(int c, float v) {
  return static_cast<unsigned>(c) < static_cast<unsigned>(kLane) &&
         (__float_as_uint(v) & 0x7f800000u) != 0u;
}

__global__ void __launch_bounds__(kScatThreads)
topk_scatter_kernel(const int* __restrict__ idx,
                    const float* __restrict__ vals, float4* __restrict__ out,
                    int width) {
  __shared__ float4 acc4[kVecs];
  __shared__ int dup;
  float* acc = reinterpret_cast<float*>(acc4);
  const long long row = blockIdx.x;
  const int t = threadIdx.x;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  acc4[t] = zero;
  acc4[t + kScatThreads] = zero;
  if (t == 0) dup = 0;
  const int* irow = idx + row * width;
  const float* vrow = vals + row * width;
  int c = 0;
  float v = 0.0f;
  if (t < width) {
    c = __ldg(irow + t);
    v = __ldg(vrow + t);
  }
  __syncthreads();
  if (live_slot(c, v)) {                   // v normal: nothing to flush
    const int old = atomicCAS(reinterpret_cast<int*>(acc) + c, 0,
                              __float_as_int(__fadd_rn(0.0f, v)));
    if (old != 0) dup = 1;                 // the column is taken: a repeat
  }
  __syncthreads();
  if (dup) {                               // uniform: sum in slot order
    acc4[t] = zero;
    acc4[t + kScatThreads] = zero;
    __syncthreads();
    if (t == 0) {
      for (int s = 0; s < width; ++s) {
        const int cs = __ldg(irow + s);
        const float vs = __ldg(vrow + s);
        if (static_cast<unsigned>(cs) < static_cast<unsigned>(kLane))
          acc[cs] = add_ftz(acc[cs], vs);
      }
    }
    __syncthreads();
  }
  float4* orow = out + row * kVecs;
  orow[t] = acc4[t];
  orow[t + kScatThreads] = acc4[t + kScatThreads];
}

int grid_for(long long rows, int width, unsigned* blocks) {
  if (rows <= 0 || rows > INT_MAX || width < 1 || width > kMaxWidth)
    return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(rows);   // one block per row
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
  topk_select_kernel<<<blocks, kSelThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const float*>(counts),
      static_cast<int*>(idx), static_cast<float*>(vals), width, fraction);
  return static_cast<int>(cudaGetLastError());
}

// idx, vals: rows x width i32 and f32; out: rows x 1024 f32.
extern "C" int topk_scatter_f32(const void* idx, const void* vals, void* out,
                                long long rows, int width, void* stream) {
  unsigned blocks = 0;
  const int err = grid_for(rows, width, &blocks);
  if (err != 0) return err;
  topk_scatter_kernel<<<blocks, kScatThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(vals),
      static_cast<float4*>(out), width);
  return static_cast<int>(cudaGetLastError());
}
