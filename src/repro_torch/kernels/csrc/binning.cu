// Quantile binning (bucketize) of raw features on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/binning.py::_kernel
// (called through binning).  Computes (n, d) f32 raw inputs x and (d, E)
// f32 edge rows, each sorted (non-decreasing, +inf padding at the tail) ->
// (n, d) int32 bins:
//
//   out[r, f] = #{e : edges[f, e] < x[r, f]}     (x not NaN)
//   out[r, f] = E                                (x NaN)
//
// The Pallas kernel counts x > e over every edge (a broadcast compare the
// TPU's vector unit does for free).  On a sorted row that count is the
// lower bound of x, which a search finds in k = ceil(log2(E + 1)) steps:
// 8 for E = 255.  An +inf edge is never below any x, so padding never
// counts.  NaN compares false everywhere: it is set to E, the bin
// apply_bins (jnp/torch searchsorted) gives it, which is what fit and
// predict_raw use.  The JAX package's Pallas kernel itself returns 0 for
// NaN; the port follows apply_bins.  Built without fast math: the compares
// must stay IEEE.
//
// What bounds it on this card: bytes.  Each x read once and each bin
// written once, n * d * (4 + 4) B, plus the edge table once, d * E * 4 B
// (8,590,195,712 B at n = 2^22, d = 256, E = 255: 2.564 ms at 3.35 TB/s);
// the k compares an element are far below the card's compare rate.
//
// Design:
//
//   * grid (row tiles of rows_per_block rows) x (feature chunks of F
//     features, F a power of two <= 32); 256 threads a block, at most 64
//     registers a thread, so 4 blocks (half the SM's warps) stay resident;
//   * each thread takes U units of VEC consecutive features of U rows
//     (VEC = 4: one 16-byte float4 load a unit, U = 4, 16 searches; VEC =
//     1: U = 8 scalar loads) and starts every load before any search; the
//     searches then advance together, one step of all of them at a time,
//     and the bins are stored as one int4 a unit.  VEC = 4 needs d % 4 ==
//     0 and a 16-byte aligned x (the wrapper checks both); VEC = 1 takes
//     every other case (d = 6, a slice x[1:] with d odd);
//   * two lanes share a row (VEC = 4: 8 features, one 32-byte sector) and
//     a warp covers 16 rows, so each load and store instruction moves whole
//     sectors;
//   * each staged edge row is an implicit binary search tree in
//     breadth-first (Eytzinger) order: node i at depth h, i - 2^h = o,
//     holds the edge of sorted rank (2o + 1) 2^(k-1-h) - 1, +inf past E.
//     The search is branchless, exactly k steps: i = 2i + (node[i] < x),
//     and the count is i - 2^k.  Step h reads one of 2^h neighbouring
//     words, so the lanes of one row's search read distinct banks at the
//     first steps, where a sorted row read at its midpoints puts all of
//     them on one bank (a simulation over normal data and quantile edges
//     counts ~15 bank wavefronts for 8 steps here against ~34 for the
//     sorted layout).  Rows are staged at an odd stride, 2^k + 1 words, so
//     two features' same node fall on different banks;
//   * staging stays within the 48 KB of dynamic shared memory a launch
//     takes without opting in (F = 32 at E = 255: 32,896 B); edge rows
//     with 2^k + 1 > 3,072 words (E >= 2,048) are not staged: the search
//     then runs over the sorted rows in global memory (L2), with the same
//     k steps and a bounds check in place of the padding.
//   * no atomics, no scratch: every output element is written once.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Sorted rank of breadth-first node i (1 <= i < 2^k) of a complete tree of
// depth k.
__device__ __forceinline__ int eytzinger_rank(int i, int k) {
  const int h = 31 - __clz(i);
  const int o = i - (1 << h);
  return ((2 * o + 1) << (k - 1 - h)) - 1;
}

template <int VEC>
struct Unit;
template <>
struct Unit<4> {
  using X = float4;
  using B = int4;
};
template <>
struct Unit<1> {
  using X = float;
  using B = int;
};

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}
__device__ __forceinline__ float lane_of(float v, int) { return v; }

template <int VEC, bool kStaged>
__global__ void __launch_bounds__(kThreads, 4) binning_kernel(
    const float* __restrict__ x, const float* __restrict__ edges,
    int32_t* __restrict__ out, long long n, int d, int E, int F, int k,
    int rows_per_block) {
  constexpr int U = VEC == 4 ? 4 : 8;  // units a thread has in flight
  using XT = typename Unit<VEC>::X;
  using BT = typename Unit<VEC>::B;
  extern __shared__ float s_tree[];

  const int f0 = blockIdx.y * F;
  const int nf = min(F, d - f0);
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r_end = min(n, r0 + rows_per_block);
  const int K2 = 1 << k;
  const int stride = K2 + 1;

  if constexpr (kStaged) {
    // node 0 is unused; node i of feature f at s_tree[f * stride + i]
    const int total = F << k;
    for (int idx = threadIdx.x; idx < total; idx += kThreads) {
      const int f = idx >> k;
      const int i = idx & (K2 - 1);
      if (i == 0) continue;
      const int rank = eytzinger_rank(i, k);
      s_tree[f * stride + i] = (f < nf && rank < E)
                                   ? edges[static_cast<long long>(f0 + f) * E + rank]
                                   : INFINITY;
    }
    __syncthreads();
  }

  // lane layout: Q units a row; L lanes share a row (a 32-byte sector), G
  // groups of L units across a chunk, the warps spread over G x RG
  const int Q = F / VEC;
  const int L = min(Q, 8 / VEC);
  const int G = Q / L;
  const int RG = kWarps / G;
  const int rows_per_warp = 32 / L;
  const int rows_per_pass = RG * rows_per_warp;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int unit = (w % G) * L + lane % L;
  const int fu = unit * VEC;  // first feature of the unit, in the chunk
  if (fu >= nf) return;       // no __syncthreads() below
  const int row_in_pass = (w / G) * rows_per_warp + lane / L;

  for (long long base = r0 + row_in_pass; base < r_end;
       base += static_cast<long long>(U) * rows_per_pass) {
    XT v[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = base + static_cast<long long>(u) * rows_per_pass;
      ok[u] = r < r_end;
      if (ok[u]) {
        v[u] = __ldg(reinterpret_cast<const XT*>(x + r * d + f0 + fu));
      } else {
        v[u] = XT();
      }
    }
    int pos[U][VEC];
    if constexpr (kStaged) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < VEC; ++j) pos[u][j] = 1;
      for (int s = 0; s < k; ++s) {
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float* tree = s_tree + (fu + j) * stride;
            pos[u][j] = 2 * pos[u][j] + (tree[pos[u][j]] < lane_of(v[u], j));
          }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < VEC; ++j) pos[u][j] -= K2;
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < VEC; ++j) pos[u][j] = 0;
      for (int s = k - 1; s >= 0; --s) {
        const int half = 1 << s;
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float* row = edges + static_cast<long long>(f0 + fu + j) * E;
            const int at = pos[u][j] + half - 1;  // sorted lower bound
            if (at < E && __ldg(row + at) < lane_of(v[u], j)) pos[u][j] += half;
          }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      const long long r = base + static_cast<long long>(u) * rows_per_pass;
      int b[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xv = lane_of(v[u], j);
        b[j] = (xv != xv) ? E : pos[u][j];
      }
      BT packed;
      if constexpr (VEC == 4) {
        packed = make_int4(b[0], b[1], b[2], b[3]);
      } else {
        packed = b[0];
      }
      __stcs(reinterpret_cast<BT*>(out + r * d + f0 + fu), packed);
    }
  }
}

template <int VEC, bool kStaged>
cudaError_t launch(const float* x, const float* e, int32_t* o, long long n, int d, int E,
                   int F, int k, int rows, dim3 grid, size_t smem, cudaStream_t s) {
  binning_kernel<VEC, kStaged><<<grid, kThreads, smem, s>>>(x, e, o, n, d, E, F, k, rows);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`, does not synchronise and allocates nothing; returns
// the first CUDA error of the launch (0 when it was accepted).  The launch
// plan (vec, F, k, staged, rows_per_block) is the wrapper's
// (kernels/binning.py::launch_plan); this entry refuses only a plan the
// kernel cannot run safely: vec 4 without d % 4 == 0 and a 16-byte aligned
// x, F not a power of two in [vec, 32] (the lane layout), 2^k < E + 1.  A
// grid or staging size past the card's limits fails at the launch.  The
// caller guarantees n >= 1, d >= 1 and E >= 1.
extern "C" int toad_binning(const void* x, const void* edges, void* out, long long n,
                            int d, int E, int vec, int F, int k, int staged,
                            int rows_per_block, void* stream) {
  const bool safe = (vec == 1 || (vec == 4 && d % 4 == 0 &&
                                  reinterpret_cast<uintptr_t>(x) % 16 == 0)) &&
                    F >= vec && F <= 32 && (F & (F - 1)) == 0 && k >= 1 && k <= 30 &&
                    (1LL << k) >= static_cast<long long>(E) + 1 && rows_per_block >= 1;
  if (!safe) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = staged ? sizeof(float) * static_cast<size_t>(F) * ((1u << k) + 1) : 0;
  const dim3 grid(static_cast<unsigned>((n + rows_per_block - 1) / rows_per_block),
                  static_cast<unsigned>((d + F - 1) / F));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* ep = static_cast<const float*>(edges);
  int32_t* op = static_cast<int32_t*>(out);
  if (vec == 4) {
    return static_cast<int>(staged ? launch<4, true>(xp, ep, op, n, d, E, F, k, rows_per_block, grid, smem, s)
                                   : launch<4, false>(xp, ep, op, n, d, E, F, k, rows_per_block, grid, smem, s));
  }
  return static_cast<int>(staged ? launch<1, true>(xp, ep, op, n, d, E, F, k, rows_per_block, grid, smem, s)
                                 : launch<1, false>(xp, ep, op, n, d, E, F, k, rows_per_block, grid, smem, s));
}
