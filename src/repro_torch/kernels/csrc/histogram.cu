// Per-node gradient/hessian/count histograms on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/histogram.py::_kernel
// (called through histogram).  Computes, for bins (n, d) uint8 or int32,
// channels gh (n, CH) f32 and node-local ids pos (n,) int32:
//
//   out[node, f, b, c] = sum over rows r with pos[r] == node and
//                        bins[r, f] == b of gh[r, c]
//
// as (n_nodes, d, n_bins, CH) f32.  Rows with pos outside [0, n_nodes), and
// cells whose bin lies outside [0, n_bins), contribute nothing.
//
// The TPU kernel contracts a one-hot (node, bin) matrix with gh on the MXU.
// On Hopper a one-hot tensor-core product would run in TF32 or BF16 and
// break the fp32 contract, so this is a privatised histogram instead:
//
//   * one block per (feature, row range, node chunk); the block keeps its
//     chunk's (nodes, n_bins, CH) cells in dynamic shared memory, adds its
//     rows with shared-memory atomics (two native 32-bit adds a value, not
//     the compare-and-swap loop a 64-bit one compiles to), then adds each
//     non-zero cell to a global accumulator with one global atomic;
//   * determinism: float atomics sum in an order that changes from run to
//     run, and split choice is an argmax over gains that one ulp can flip.
//     So every value is accumulated as int64 fixed point, x * 2^s rounded
//     to nearest, where s is chosen per channel from max|gh[:, c]| and n so
//     that no sum can pass 2^62 (scale_exponent below).  Integer addition
//     is exact and order-free: the same inputs give the same bits on every
//     run, whatever the grid.  A third pass converts the sums to f32 once.
//     The quantum 2^-s is 2^-39 for |g| < 1 at n = 2^22, far below fp32's
//     own summation error; counts (a channel of ones) are exact integers.
//     A non-finite channel value makes that whole channel NaN.
//   * the wrapper passes bins in any layout by their strides; the trainer
//     keeps them column-major (feature by feature) as uint8, so a warp
//     reads 32 consecutive bytes of its feature's column.
//
// What bounds it on this card: bytes.  Per call the bins are read once per
// node chunk (n * d bytes as uint8: 1 GiB at n = 2^22, d = 256), gh and pos
// once from device memory (16 B a row) and the output written once; the
// adds, n * d * CH, are ~0.05 ms of fp32 rate at that size.  The design
// reads each bin byte once per node chunk, coalesced; gh and pos are read
// again by each feature's blocks, from L2, where the blocks of one row
// range run together.  Faster is later work: several features per block
// (one gh/pos read for many bins), cp.async/TMA staging of the columns.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxChannels = 8;
constexpr int kTargetBlocks = 132 * 4;      // row ranges are split to reach this
constexpr int kMinRowsPerBlock = 2048;
constexpr int kSmemBudget = 96 * 1024;      // node chunk's cells: two blocks per SM
constexpr int kSmemMax = 232448;            // 227 KB, a block's most on sm_90

// Exponent s of the fixed-point scale 2^s of a channel whose largest
// magnitude is amax, over n rows: |x| <= amax < 2^e gives
// |round(x 2^s)| <= 2^(e+s), and n < 2^k rows keep every sum below
// 2^(e+k+s) = 2^62.
__device__ __forceinline__ int scale_exponent(float amax, int n) {
  int e = 0;
  frexpf(amax, &e);  // amax = m 2^e with m in [0.5, 1); 0 gives e = 0
  const int k = 32 - __clz(n);
  return 62 - e - k;
}

// max |gh[:, c]| per channel, as the bits of a non-negative float (their
// unsigned order is the values' order; NaN sorts above inf).  amax_bits
// must be zeroed.
__global__ void __launch_bounds__(kThreads) channel_amax_kernel(
    const float* __restrict__ gh, int n, int CH, unsigned int* __restrict__ amax_bits) {
  unsigned int m[kMaxChannels];
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) m[c] = 0u;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; r < n;
       r += static_cast<int64_t>(gridDim.x) * blockDim.x) {
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
      if (c < CH) m[c] = max(m[c], __float_as_uint(fabsf(gh[r * CH + c])));
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) {
    if (c >= CH) break;
    unsigned int v = m[c];
    for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
    if ((threadIdx.x & 31) == 0 && v != 0u) atomicMax(amax_bits + c, v);
  }
}

template <typename BinT>
__global__ void __launch_bounds__(kThreads) histogram_kernel(
    const BinT* __restrict__ bins, int64_t row_stride, int64_t feat_stride,
    const float* __restrict__ gh, const int32_t* __restrict__ pos,
    const unsigned int* __restrict__ amax_bits,
    unsigned long long* __restrict__ acc,
    int n, int d, int CH, int n_nodes, int n_bins, int node_chunk, int rows_per_block) {
  // each cell's int64 sum in two words: s_lo the low 32 bits, s_hi the high
  // ones.  Hopper has no native 64-bit shared-memory atomic add (it compiles
  // to a compare-and-swap loop); two native 32-bit adds, with the carry out
  // of the low word read from the value atomicAdd returns, sum exactly.
  extern __shared__ unsigned int s_words[];
  const int f = blockIdx.x;
  const int row_begin = blockIdx.y * rows_per_block;
  const int row_end = min(n, row_begin + rows_per_block);
  const int node_base = blockIdx.z * node_chunk;
  const int chunk = min(node_chunk, n_nodes - node_base);
  const int cells = chunk * n_bins * CH;
  unsigned int* s_lo = s_words;
  int* s_hi = reinterpret_cast<int*>(s_words + cells);

  for (int i = threadIdx.x; i < 2 * cells; i += blockDim.x) s_words[i] = 0u;
  double scale[kMaxChannels];
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) {
    scale[c] = 0.0;
    if (c < CH) {
      const float a = __uint_as_float(amax_bits[c]);
      if (isfinite(a)) scale[c] = ldexp(1.0, scale_exponent(a, n));
    }
  }
  __syncthreads();

  const BinT* col = bins + static_cast<int64_t>(f) * feat_stride;
  for (int r = row_begin + threadIdx.x; r < row_end; r += blockDim.x) {
    const int p = pos[r] - node_base;  // pos outside [0, n_nodes) lands outside [0, chunk)
    if (p < 0 || p >= chunk) continue;
    const int b = static_cast<int>(col[static_cast<int64_t>(r) * row_stride]);
    if (b < 0 || b >= n_bins) continue;
    const int cell = (p * n_bins + b) * CH;
    const float* x = gh + static_cast<int64_t>(r) * CH;
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
      if (c < CH && scale[c] != 0.0) {
        const long long q = __double2ll_rn(static_cast<double>(x[c]) * scale[c]);
        if (q == 0) continue;
        const unsigned int lo = static_cast<unsigned int>(q);
        int hi = static_cast<int>(q >> 32);  // q = hi * 2^32 + lo
        const unsigned int old = atomicAdd(s_lo + cell + c, lo);
        if (old + lo < old) hi += 1;  // the low word wrapped: carry it
        if (hi != 0) atomicAdd(s_hi + cell + c, hi);
      }
    }
  }
  __syncthreads();

  // the high words wrap in 32-bit arithmetic, the combined value in 64-bit:
  // both read back exactly, since every true sum stays inside +-2^62
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const unsigned long long v =
        (static_cast<unsigned long long>(static_cast<long long>(s_hi[i])) << 32) + s_lo[i];
    if (v == 0ull) continue;
    const int c = i % CH;
    const int cell = i / CH;
    const int b = cell % n_bins;
    const int p = cell / n_bins;
    const int64_t o = ((static_cast<int64_t>(node_base + p) * d + f) * n_bins + b) * CH + c;
    atomicAdd(acc + o, v);
  }
}

__global__ void __launch_bounds__(kThreads) to_float_kernel(
    const unsigned long long* __restrict__ acc, const unsigned int* __restrict__ amax_bits,
    float* __restrict__ out, int64_t total, int CH, int n) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % CH);
    const float a = __uint_as_float(amax_bits[c]);
    out[i] = isfinite(a)
                 ? static_cast<float>(ldexp(static_cast<double>(static_cast<long long>(acc[i])),
                                            -scale_exponent(a, n)))
                 : __int_as_float(0x7fffffff);
  }
}

template <typename BinT>
cudaError_t launch_accumulate(const void* bins, int64_t row_stride, int64_t feat_stride,
                              const float* gh, const int32_t* pos,
                              const unsigned int* amax_bits, unsigned long long* acc,
                              int n, int d, int CH, int n_nodes, int n_bins,
                              cudaStream_t s) {
  const int64_t node_bytes = static_cast<int64_t>(n_bins) * CH * 8;
  if (node_bytes > kSmemMax) return cudaErrorInvalidValue;
  int node_chunk = static_cast<int>(kSmemBudget / node_bytes);
  
  node_chunk = std::max(1, std::min(n_nodes, node_chunk));
  const int n_chunks = (n_nodes + node_chunk - 1) / node_chunk;
  const size_t smem = static_cast<size_t>(node_chunk) * node_bytes;
  const int64_t fd_blocks = static_cast<int64_t>(d) * n_chunks;
  int64_t splits = (kTargetBlocks + fd_blocks - 1) / fd_blocks;
  splits = std::max<int64_t>(1, std::min<int64_t>(splits, (n + kMinRowsPerBlock - 1) / kMinRowsPerBlock));
  const int rows_per_block = static_cast<int>((n + splits - 1) / splits);
  splits = (n + rows_per_block - 1) / rows_per_block;
  cudaError_t err = cudaFuncSetAttribute(histogram_kernel<BinT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(d, static_cast<unsigned int>(splits), n_chunks);
  histogram_kernel<BinT><<<grid, kThreads, smem, s>>>(
      static_cast<const BinT*>(bins), row_stride, feat_stride, gh, pos, amax_bits, acc,
      n, d, CH, n_nodes, n_bins, node_chunk, rows_per_block);
  return cudaGetLastError();
}

}  // namespace

// Launches three kernels on `stream` (channel maxima, accumulation,
// conversion), does not synchronise and allocates nothing.  `amax_bits`
// (CH uint32) and `acc` (n_nodes * d * n_bins * CH int64) must be zeroed;
// `out` has the same element count as `acc`.  bins element (r, f) is at
// r * row_stride + f * feat_stride.  Returns cudaGetLastError() after the
// launches (0 when all were accepted).
extern "C" int toad_histogram(
    const void* bins, int bins_u8, long long row_stride, long long feat_stride,
    const void* gh, const void* pos, void* amax_bits, void* acc, void* out,
    int n, int d, int CH, int n_nodes, int n_bins, void* stream) {
  if (n <= 0 || d <= 0 || CH <= 0 || CH > kMaxChannels || n_nodes <= 0 || n_bins <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gh);
  const int32_t* p = static_cast<const int32_t*>(pos);
  unsigned int* amax = static_cast<unsigned int*>(amax_bits);
  unsigned long long* a = static_cast<unsigned long long*>(acc);

  const int amax_blocks = static_cast<int>(std::min<int64_t>((n + kThreads - 1) / kThreads, 132 * 4));
  channel_amax_kernel<<<amax_blocks, kThreads, 0, s>>>(g, n, CH, amax);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = bins_u8 ? launch_accumulate<uint8_t>(bins, row_stride, feat_stride, g, p, amax, a,
                                             n, d, CH, n_nodes, n_bins, s)
                : launch_accumulate<int32_t>(bins, row_stride, feat_stride, g, p, amax, a,
                                             n, d, CH, n_nodes, n_bins, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t total = static_cast<int64_t>(n_nodes) * d * n_bins * CH;
  const int conv_blocks = static_cast<int>(std::min<int64_t>((total + kThreads - 1) / kThreads, 132 * 16));
  to_float_kernel<<<conv_blocks, kThreads, 0, s>>>(a, amax, static_cast<float*>(out), total, CH, n);
  return static_cast<int>(cudaGetLastError());
}
