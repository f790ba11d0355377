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
// break the fp32 contract, so this is a privatised histogram instead, summed
// in int64 fixed point:
//
//   * determinism: float atomics sum in an order that changes from run to
//     run, and split choice is an argmax over gains that one ulp can flip.
//     So every value is accumulated as int64 fixed point, x * 2^s rounded
//     to nearest, where s is chosen per channel from max|gh[:, c]| over the
//     rows that count and from n, the rows passed, so that no sum can pass
//     2^62 (scale_exponent below).  Integer addition is exact and
//     order-free: the same inputs give the same bits on every run, whatever
//     the grid or the order the rows are visited in.  The quantum 2^-s is
//     2^-39 for |g| < 1 at n = 2^22, far below fp32's own summation error;
//     counts (a channel of ones) are exact integers.  A non-finite channel
//     value makes that whole channel NaN.  Shared-memory sums take two
//     native 32-bit atomics a value (Hopper's 64-bit shared add is a
//     compare-and-swap loop), the carry out of the low word read from the
//     value atomicAdd returns.
//
// What bounds it on this card: bytes.  The bins of the rows that count are
// read once (n * d bytes as uint8: 1 GiB at n = 2^22, d = 256), gh and pos
// once (16 B a row) and the output written once; the adds, n * d * CH, are
// ~0.05 ms of fp32 rate at that size.
//
// Design, five launches a call:
//
//   1. hist_count_kernel: rows per node and the channel maxima over the
//      rows that count (pos in range), one pass over pos and gh;
//   2. hist_plan_kernel (one block): exclusive scans of the counts (each
//      node's first slot) and of ceil(count / T) (each node's first tile of
//      T rows);
//   3. hist_scatter_kernel: a counting sort of the kept rows by node, the
//      row ids and their channels written to the node's slots (a block
//      reserves a node's slots with one atomic, then deals them out in
//      shared memory).  Rows outside [0, n_nodes) are left out, so a
//      sibling-subtraction call that passes pos = -1 for its right rows
//      reads only the left ones;
//   4. histogram_kernel: grid (feature groups of F <= 32 features) x (tile
//      slots).  A block finds its tile's node by a binary search over the
//      tile starts and keeps that node's cells in shared memory (192 KB at
//      256 bins x 3 channels x 32 features: one block of 1,024 threads an
//      SM).  Each thread adds whole rows: it reads a row's id and channels,
//      quantises them once for the block's features, reads the row's 32
//      uint8 bins of the block in two 16-byte loads (the trainer's
//      row-major layout; other layouts and int32 bins load bin by bin), and
//      adds the 32 features in an order rotated by its lane.  The cells are
//      laid out (bin, channel, feature), so at every step the 32 lanes of a
//      warp add to 32 different features: 32 banks whatever the bins, and a
//      feature whose rows crowd into a few bins costs no more than any
//      other.  Non-zero cells go to an int64 accumulator with one global
//      atomic each;
//   4'. hist_one_bin_kernel, in place of 2-4 for a one-bin call (the
//      trainer's leaf statistics: d = 1, 256 nodes): no sort, each row's
//      channels straight into its node's cells;
//   5. to_float_kernel: the int64 sums to f32, once.
//
// What holds it above its bound: the shared-memory atomics.  A (row,
// feature) pair takes five (the low and high words of g and h, the high
// word of the count), issued at the rate a warp's conflict-free 32-bit
// shared atomicAdd goes out; Hopper's 64-bit shared atomicAdd is a
// compare-and-swap loop, and slower.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 512;
constexpr int kHistThreads = 1024;  // the accumulation: one block an SM
constexpr int kMaxChannels = 8;
constexpr int kMaxFeatures = 32;    // features a block: a lane each
constexpr int kPrepBlocks = 132 * 4;
constexpr int kSmemNodes = 4096;   // nodes the sort counts in shared memory
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

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

// Rows [begin, end) of a prep block: warp-aligned, so that every lane of a
// warp runs the same loop turns (the warp votes below need all 32).
struct RowRange {
  int64_t begin, end;
  __device__ RowRange(int n, int chunk)
      : begin(static_cast<int64_t>(blockIdx.x) * chunk),
        end(min(static_cast<int64_t>(n), static_cast<int64_t>(blockIdx.x + 1) * chunk)) {}
};

// 1. rows per node (counts must be zeroed) and max |gh[:, c]| over the rows
// that count, as the bits of a non-negative float (their unsigned order is
// the values' order; NaN sorts above inf; amax_bits must be zeroed).
__global__ void __launch_bounds__(kThreads) hist_count_kernel(
    const float* __restrict__ gh, const int32_t* __restrict__ pos, int n, int CH,
    int n_nodes, int chunk, int32_t* __restrict__ counts,
    unsigned int* __restrict__ amax_bits) {
  extern __shared__ int s_cnt[];
  const bool in_smem = n_nodes <= kSmemNodes;
  if (in_smem) {
    for (int i = threadIdx.x; i < n_nodes; i += kThreads) s_cnt[i] = 0;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  unsigned int m[kMaxChannels];
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) m[c] = 0u;
  const RowRange rr(n, chunk);
  for (int64_t r0 = rr.begin + (threadIdx.x & ~31); r0 < rr.end; r0 += kThreads) {
    const int64_t r = r0 + lane;
    const int p = r < rr.end ? pos[r] : -1;
    const bool keep = p >= 0 && p < n_nodes;
    if (keep) {
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) {
        if (c < CH) m[c] = max(m[c], __float_as_uint(fabsf(gh[r * CH + c])));
      }
    }
    const unsigned active = __ballot_sync(kFull, keep);
    if (keep) {
      const unsigned peers = __match_any_sync(active, p);
      if (lane == __ffs(peers) - 1) atomicAdd((in_smem ? s_cnt : counts) + p, __popc(peers));
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) {
    if (c >= CH) break;
    unsigned int v = m[c];
    for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(kFull, v, off));
    if (lane == 0 && v != 0u) atomicMax(amax_bits + c, v);
  }
  if (in_smem) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_nodes; i += kThreads) {
      if (s_cnt[i] != 0) atomicAdd(counts + i, s_cnt[i]);
    }
  }
}

// Exclusive scan of one value a thread over a block of kScanThreads;
// `total` receives the block's sum.
__device__ int block_exclusive_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  int x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s_warp[w] = x;
  __syncthreads();
  if (w == 0) {
    int t = s_warp[lane];  // kScanThreads / 32 == 32 warps
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, t, off);
      if (lane >= off) t += y;
    }
    s_warp[lane] = t;
  }
  __syncthreads();
  const int before = (w > 0 ? s_warp[w - 1] : 0) + x - v;
  total = s_warp[31];
  __syncthreads();
  return before;
}

// 2. node_start[i] = rows of nodes before i, tile_start[i] = tiles of T rows
// of nodes before i (both with the total at [n_nodes]); cursor = node_start.
__global__ void __launch_bounds__(kScanThreads) hist_plan_kernel(
    const int32_t* __restrict__ counts, int n_nodes, int T, int32_t* __restrict__ node_start,
    int32_t* __restrict__ tile_start, int32_t* __restrict__ cursor) {
  __shared__ int s_rows[32];
  __shared__ int s_tiles[32];
  int carry_rows = 0;
  int carry_tiles = 0;
  for (int b = 0; b < n_nodes; b += kScanThreads) {
    const int i = b + threadIdx.x;
    const int c = i < n_nodes ? counts[i] : 0;
    const int tiles = static_cast<int>((static_cast<int64_t>(c) + T - 1) / T);
    int rows_total = 0;
    int tiles_total = 0;
    const int rows_before = block_exclusive_scan(c, s_rows, rows_total);
    const int tiles_before = block_exclusive_scan(tiles, s_tiles, tiles_total);
    if (i < n_nodes) {
      node_start[i] = carry_rows + rows_before;
      cursor[i] = carry_rows + rows_before;
      tile_start[i] = carry_tiles + tiles_before;
    }
    carry_rows += rows_total;
    carry_tiles += tiles_total;
  }
  if (threadIdx.x == 0) {
    node_start[n_nodes] = carry_rows;
    tile_start[n_nodes] = carry_tiles;
  }
}

// 3. counting sort: the kept rows' ids and channels into their node's slots
// (in no fixed order inside a node: the sums do not depend on it).
__global__ void __launch_bounds__(kThreads) hist_scatter_kernel(
    const float* __restrict__ gh, const int32_t* __restrict__ pos, int n, int CH,
    int n_nodes, int chunk, int32_t* __restrict__ cursor, int32_t* __restrict__ rowid,
    float* __restrict__ sgh) {
  extern __shared__ int s_mem[];
  const bool in_smem = n_nodes <= kSmemNodes;
  int* s_cnt = s_mem;
  int* s_cur = s_mem + n_nodes;
  const int lane = threadIdx.x & 31;
  const RowRange rr(n, chunk);
  if (in_smem) {  // this block's rows per node, then one reservation a node
    for (int i = threadIdx.x; i < n_nodes; i += kThreads) s_cnt[i] = 0;
    __syncthreads();
    for (int64_t r0 = rr.begin + (threadIdx.x & ~31); r0 < rr.end; r0 += kThreads) {
      const int64_t r = r0 + lane;
      const int p = r < rr.end ? pos[r] : -1;
      const bool keep = p >= 0 && p < n_nodes;
      const unsigned active = __ballot_sync(kFull, keep);
      if (keep) {
        const unsigned peers = __match_any_sync(active, p);
        if (lane == __ffs(peers) - 1) atomicAdd(s_cnt + p, __popc(peers));
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n_nodes; i += kThreads) {
      s_cur[i] = s_cnt[i] != 0 ? atomicAdd(cursor + i, s_cnt[i]) : 0;
    }
    __syncthreads();
  }
  for (int64_t r0 = rr.begin + (threadIdx.x & ~31); r0 < rr.end; r0 += kThreads) {
    const int64_t r = r0 + lane;
    const int p = r < rr.end ? pos[r] : -1;
    const bool keep = p >= 0 && p < n_nodes;
    const unsigned active = __ballot_sync(kFull, keep);
    if (keep) {
      const unsigned peers = __match_any_sync(active, p);
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd((in_smem ? s_cur : cursor) + p, __popc(peers));
      base = __shfl_sync(peers, base, leader);
      const int slot = base + __popc(peers & ((1u << lane) - 1u));
      rowid[slot] = static_cast<int32_t>(r);
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) {
        if (c < CH) sgh[static_cast<int64_t>(slot) * CH + c] = gh[r * CH + c];
      }
    }
  }
}

// A row's channels as fixed point, split into the low 32 bits and the rest.
template <int MAXCH>
struct Fixed {
  unsigned int lo[MAXCH];
  int hi[MAXCH];
  __device__ __forceinline__ void set(const float* g, int CH, const double* scale) {
#pragma unroll
    for (int c = 0; c < MAXCH; ++c) {
      long long q = 0;
      if (c < CH && scale[c] != 0.0) q = __double2ll_rn(static_cast<double>(g[c]) * scale[c]);
      lo[c] = static_cast<unsigned int>(q);
      hi[c] = static_cast<int>(q >> 32);  // q = hi * 2^32 + lo
    }
  }
};

// cell += hi * 2^32 + lo, exactly: the carry out of the low word is read
// from the value atomicAdd returns.  The high words wrap in 32-bit
// arithmetic and the combined value in 64-bit: both read back exactly,
// since every true sum stays inside +-2^62.
__device__ __forceinline__ void add_fixed(unsigned int* s_lo, int* s_hi, int cell,
                                          unsigned int lo, int hi) {
  if (lo != 0u) {
    const unsigned int old = atomicAdd(s_lo + cell, lo);
    if (old + lo < old) hi += 1;
  }
  if (hi != 0) atomicAdd(s_hi + cell, hi);
}

// The 32 bytes w[0..7] rotated by `by` bytes (0..31): byte m of the result
// is byte (m + by) mod 32 of w.  A three-stage barrel shift of words, then
// one funnel shift a word: no indexed registers (they would go to local
// memory).
__device__ __forceinline__ void rotate_bytes(const unsigned int (&w)[8], int by,
                                             unsigned int (&out)[8]) {
  unsigned int t[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) t[k] = (by & 4) ? w[(k + 1) & 7] : w[k];
  unsigned int u[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) u[k] = (by & 8) ? t[(k + 2) & 7] : t[k];
#pragma unroll
  for (int k = 0; k < 8; ++k) t[k] = (by & 16) ? u[(k + 4) & 7] : u[k];
  const int sh = (by & 3) * 8;
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = __funnelshift_r(t[k], t[(k + 1) & 7], sh);
}

// 4. one block = one tile of one node's rows x F features (F a power of two
// <= 32).  Shared memory holds the cells as (bin, channel, feature).  Each
// thread takes whole rows: it reads a row's id and channels, quantises them
// once, and adds the row's F features in an order rotated by its lane
// (lane l starts at feature l mod F).  So at F = 32 the 32 lanes of a warp
// add to 32 different features at each step: 32 banks whatever the bins,
// and no two lanes on one cell however skewed a feature is.
template <typename BinT, int MAXCH>
__global__ void __launch_bounds__(kHistThreads, 1) histogram_kernel(
    const BinT* __restrict__ bins, int64_t row_stride, int64_t feat_stride,
    const float* __restrict__ sgh, const int32_t* __restrict__ rowid,
    const int32_t* __restrict__ node_start, const int32_t* __restrict__ tile_start,
    const unsigned int* __restrict__ amax_bits, unsigned long long* __restrict__ acc,
    int n, int d, int CH, int n_nodes, int n_bins, int F, int T) {
  extern __shared__ unsigned int s_words[];
  const int f0 = blockIdx.x * F;
  const int nf = min(F, d - f0);
  const int cells = n_bins * CH * F;
  unsigned int* s_lo = s_words;
  int* s_hi = reinterpret_cast<int*>(s_words + cells);
  double scale[MAXCH];
#pragma unroll
  for (int c = 0; c < MAXCH; ++c) {
    scale[c] = 0.0;
    if (c < CH) {
      const float a = __uint_as_float(amax_bits[c]);
      if (isfinite(a)) scale[c] = ldexp(1.0, scale_exponent(a, n));
    }
  }
  const int lane = threadIdx.x & 31;
  const int rot = lane % F;
  // a row's 32 uint8 bins of this block in two 16-byte loads
  const bool wide = sizeof(BinT) == 1 && F == kMaxFeatures && nf == F && feat_stride == 1 &&
                    row_stride % 16 == 0 && reinterpret_cast<uintptr_t>(bins) % 16 == 0;
  const int total = tile_start[n_nodes];

  for (int t = blockIdx.y; t < total; t += gridDim.y) {
    int j = 0;  // the last node whose first tile is <= t
    for (int hi = n_nodes; hi - j > 1;) {
      const int mid = (j + hi) >> 1;
      if (tile_start[mid] <= t) j = mid; else hi = mid;
    }
    const int rb = node_start[j] + (t - tile_start[j]) * T;
    const int re = min(node_start[j + 1], rb + T);
    const int64_t out_base = (static_cast<int64_t>(j) * d + f0) * n_bins * CH;

    for (int i = threadIdx.x; i < 2 * cells; i += kHistThreads) s_words[i] = 0u;
    __syncthreads();
    for (int i = rb + threadIdx.x; i < re; i += kHistThreads) {
      const int64_t r = rowid[i];
      Fixed<MAXCH> q;
      q.set(sgh + static_cast<int64_t>(i) * CH, CH, scale);
      if (wide) {
        const uint4* p = reinterpret_cast<const uint4*>(
            reinterpret_cast<const uint8_t*>(bins) + r * row_stride + f0);
        const uint4 a = __ldg(p);
        const uint4 b = __ldg(p + 1);
        const unsigned int w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        unsigned int rw[8];
        rotate_bytes(w, lane, rw);
#pragma unroll
        for (int m = 0; m < kMaxFeatures; ++m) {  // feature (lane + m) mod 32
          const int bin = (rw[m >> 2] >> ((m & 3) * 8)) & 0xff;
          if (bin >= n_bins) continue;
          const int cell = bin * CH * kMaxFeatures + ((lane + m) & (kMaxFeatures - 1));
#pragma unroll
          for (int c = 0; c < MAXCH; ++c) {
            if (c < CH) add_fixed(s_lo, s_hi, cell + c * kMaxFeatures, q.lo[c], q.hi[c]);
          }
        }
      } else {
        const BinT* row = bins + r * row_stride + static_cast<int64_t>(f0) * feat_stride;
        for (int m = 0; m < F; ++m) {
          const int f = (rot + m) & (F - 1);
          if (f >= nf) continue;
          const int bin = static_cast<int>(row[static_cast<int64_t>(f) * feat_stride]);
          if (bin < 0 || bin >= n_bins) continue;
#pragma unroll
          for (int c = 0; c < MAXCH; ++c) {
            if (c < CH) add_fixed(s_lo, s_hi, (bin * CH + c) * F + f, q.lo[c], q.hi[c]);
          }
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += kHistThreads) {
      const unsigned long long v =
          (static_cast<unsigned long long>(static_cast<long long>(s_hi[i])) << 32) + s_lo[i];
      if (v == 0ull) continue;
      const int cell = i / F;  // bin * CH + channel
      const int f = i - cell * F;
      atomicAdd(acc + out_base + static_cast<int64_t>(f) * n_bins * CH + cell, v);
    }
    __syncthreads();
  }
}

// 4'. a one-bin call (the trainer's leaf statistics: d = 1, 256 nodes):
// every kept row adds its channels to cell (node, f, 0) of each feature f
// whose bin is 0, so no sort is needed.  A block adds its rows to all the
// cells in shared memory when they fit (6 KB for the leaf call), else
// straight to the int64 accumulator.
__global__ void __launch_bounds__(kThreads) hist_one_bin_kernel(
    const void* __restrict__ bins, int bins_u8, int64_t row_stride, int64_t feat_stride,
    const float* __restrict__ gh, const int32_t* __restrict__ pos,
    const unsigned int* __restrict__ amax_bits, unsigned long long* __restrict__ acc,
    int n, int d, int CH, int n_nodes, int chunk, int in_smem) {
  extern __shared__ unsigned int s_words[];
  const int cells = n_nodes * d * CH;
  unsigned int* s_lo = s_words;
  int* s_hi = reinterpret_cast<int*>(s_words + cells);
  if (in_smem) {
    for (int i = threadIdx.x; i < 2 * cells; i += kThreads) s_words[i] = 0u;
    __syncthreads();
  }
  double scale[kMaxChannels];
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) {
    scale[c] = 0.0;
    if (c < CH) {
      const float a = __uint_as_float(amax_bits[c]);
      if (isfinite(a)) scale[c] = ldexp(1.0, scale_exponent(a, n));
    }
  }
  const RowRange rr(n, chunk);
  for (int64_t r = rr.begin + threadIdx.x; r < rr.end; r += kThreads) {
    const int p = pos[r];
    if (p < 0 || p >= n_nodes) continue;
    Fixed<kMaxChannels> q;
    q.set(gh + r * CH, CH, scale);
    for (int f = 0; f < d; ++f) {
      const int64_t at = r * row_stride + f * feat_stride;
      const int bin = bins_u8 ? static_cast<const uint8_t*>(bins)[at]
                              : static_cast<const int32_t*>(bins)[at];
      if (bin != 0) continue;
      const int cell = (p * d + f) * CH;
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) {
        if (c >= CH) break;
        if (in_smem) {
          add_fixed(s_lo, s_hi, cell + c, q.lo[c], q.hi[c]);
        } else {
          const unsigned long long v =
              (static_cast<unsigned long long>(static_cast<long long>(q.hi[c])) << 32) + q.lo[c];
          if (v != 0ull) atomicAdd(acc + cell + c, v);
        }
      }
    }
  }
  if (in_smem) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += kThreads) {
      const unsigned long long v =
          (static_cast<unsigned long long>(static_cast<long long>(s_hi[i])) << 32) + s_lo[i];
      if (v != 0ull) atomicAdd(acc + i, v);
    }
  }
}

// 5. the int64 sums to f32
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

template <typename BinT, int MAXCH>
cudaError_t launch_accumulate(const void* bins, int64_t row_stride, int64_t feat_stride,
                              const float* sgh, const int32_t* rowid, const int32_t* node_start,
                              const int32_t* tile_start, const unsigned int* amax,
                              unsigned long long* acc, int n, int d, int CH, int n_nodes,
                              int n_bins, int F, int T, int tiles, cudaStream_t s) {
  const int smem = 2 * n_bins * CH * F * static_cast<int>(sizeof(unsigned int));
  const cudaError_t err = cudaFuncSetAttribute(
      histogram_kernel<BinT, MAXCH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned int>((d + F - 1) / F), static_cast<unsigned int>(tiles));
  histogram_kernel<BinT, MAXCH><<<grid, kHistThreads, smem, s>>>(
      static_cast<const BinT*>(bins), row_stride, feat_stride, sgh, rowid, node_start,
      tile_start, amax, acc, n, d, CH, n_nodes, n_bins, F, T);
  return cudaGetLastError();
}

}  // namespace

// Launches five kernels on `stream` (count, plan, scatter, accumulate,
// convert), does not synchronise and allocates nothing.  Scratch, from the
// wrapper: `ints` holds CH + 4 * n_nodes + 2 int32 (amax bits, counts,
// cursor, node_start, tile_start), the first CH + n_nodes zeroed; `rowid`
// n int32; `sgh` n * CH float; `acc` n_nodes * d * n_bins * CH int64,
// zeroed; `out` as many floats.  bins element (r, f) is at r * row_stride +
// f * feat_stride.  The launch plan (F features a block, T rows a tile,
// `tiles` tile slots) is the wrapper's (kernels/histogram.py::launch_plan);
// this entry refuses only what the kernels cannot run safely (CH past
// their registers, F not a power of two up to a lane each, T or tiles
// below 1).  A grid or shared-memory size past the card's limits fails at
// the launch.  Returns cudaGetLastError() after the launches (0 when all
// were accepted).
extern "C" int toad_histogram(
    const void* bins, int bins_u8, long long row_stride, long long feat_stride,
    const void* gh, const void* pos, void* ints, void* rowid, void* sgh, void* acc, void* out,
    int n, int d, int CH, int n_nodes, int n_bins, int F, int T, int tiles, void* stream) {
  if (n <= 0 || d <= 0 || CH <= 0 || CH > kMaxChannels || n_nodes <= 0 || n_bins <= 0 ||
      F < 1 || F > kMaxFeatures || (F & (F - 1)) != 0 || T < 1 || tiles < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gh);
  const int32_t* p = static_cast<const int32_t*>(pos);
  unsigned int* amax = static_cast<unsigned int*>(ints);
  int32_t* counts = static_cast<int32_t*>(ints) + CH;
  int32_t* cursor = counts + n_nodes;
  int32_t* node_start = cursor + n_nodes;
  int32_t* tile_start = node_start + n_nodes + 1;
  int32_t* ids = static_cast<int32_t*>(rowid);
  float* sg = static_cast<float*>(sgh);
  unsigned long long* a = static_cast<unsigned long long*>(acc);

  const int64_t want = std::min<int64_t>(kPrepBlocks, (n + kThreads - 1) / kThreads);
  const int chunk = static_cast<int>(((n + want - 1) / want + 31) / 32 * 32);
  const int blocks = (n + chunk - 1) / chunk;
  const bool nodes_in_smem = n_nodes <= kSmemNodes;
  hist_count_kernel<<<blocks, kThreads, nodes_in_smem ? n_nodes * sizeof(int) : 0, s>>>(
      g, p, n, CH, n_nodes, chunk, counts, amax);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_bins == 1) {
    const int64_t one_bin_smem = 8LL * n_nodes * d * CH;
    const bool cells_in_smem = one_bin_smem <= 48 * 1024;
    hist_one_bin_kernel<<<blocks, kThreads, cells_in_smem ? one_bin_smem : 0, s>>>(
        bins, bins_u8, row_stride, feat_stride, g, p, amax, a, n, d, CH, n_nodes, chunk,
        cells_in_smem);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
  hist_plan_kernel<<<1, kScanThreads, 0, s>>>(counts, n_nodes, T, node_start, tile_start, cursor);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  hist_scatter_kernel<<<blocks, kThreads, nodes_in_smem ? 2 * n_nodes * sizeof(int) : 0, s>>>(
      g, p, n, CH, n_nodes, chunk, cursor, ids, sg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (bins_u8) {
    err = CH <= 3 ? launch_accumulate<uint8_t, 3>(bins, row_stride, feat_stride, sg, ids,
                                                  node_start, tile_start, amax, a, n, d, CH,
                                                  n_nodes, n_bins, F, T, tiles, s)
                  : launch_accumulate<uint8_t, kMaxChannels>(
                        bins, row_stride, feat_stride, sg, ids, node_start, tile_start,
                        amax, a, n, d, CH, n_nodes, n_bins, F, T, tiles, s);
  } else {
    err = CH <= 3 ? launch_accumulate<int32_t, 3>(bins, row_stride, feat_stride, sg, ids,
                                                  node_start, tile_start, amax, a, n, d, CH,
                                                  n_nodes, n_bins, F, T, tiles, s)
                  : launch_accumulate<int32_t, kMaxChannels>(
                        bins, row_stride, feat_stride, sg, ids, node_start, tile_start,
                        amax, a, n, d, CH, n_nodes, n_bins, F, T, tiles, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  }

  const int64_t total = static_cast<int64_t>(n_nodes) * d * n_bins * CH;
  const int conv_blocks = static_cast<int>(std::min<int64_t>((total + kThreads - 1) / kThreads, 132 * 16));
  to_float_kernel<<<conv_blocks, kThreads, 0, s>>>(a, amax, static_cast<float*>(out), total, CH, n);
  return static_cast<int>(cudaGetLastError());
}
