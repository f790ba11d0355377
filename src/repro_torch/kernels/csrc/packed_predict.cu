// Packed ToaD inference on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/predict.py::_kernel
// (called through packed_predict).  Computes (n, d) f32 raw inputs ->
// (n, C) f32 scores:
//
//   out[r, c] = base[c] + sum over trees t with t % C == c, in index order,
//               of leaf_values[leaf_ref[t, leaf(t, r) - I]]
//
// where leaf(t, r) is reached by max_depth pointer-less steps over the
// uint32 node words, word = tix | ref << tidx_bits:
//   go left iff ref == n_fu (unsplit) or x[r, used_features[ref]] <=
//   thr_table[thr_offsets[ref] + tix];  idx = 2 * idx + 1 + right.
// NaN compares false, so it routes right (built without fast math).
//
// Design (simple and right first):
//   * one thread per row, 256-thread blocks, a grid of ceil(n / 256);
//   * the small tables (used_features, thr_offsets, thr_table, leaf_values)
//     are staged in dynamic shared memory when they fit under 48 KB, else
//     read from global memory;
//   * node words and leaf references (T * (2I + 1) * 4 bytes, 523 KB at
//     256 trees of depth 8: more than a block's 227 KB of shared memory,
//     far less than the 50 MB L2) are read from global memory with __ldg
//     and served by L2;
//   * each thread owns its row: one register accumulator per class column,
//     no atomics.  Trees are visited class by class, t = c, c + C, ...:
//     each column receives exactly its own trees in increasing index
//     order, so every score is summed in the plain version's order and
//     agrees with it to the bit (for C == 1 this is plain index order).
//   * gather indices are clamped into their tables, as JAX gathers clamp,
//     so a malformed model can not read out of bounds.
//
// What bounds it on this card: per row, T * D dependent loads of a node
// word and of x (a gather, uncoalesced across the warp) plus T leaf loads,
// all latency-bound L2/global traffic.  The bytes floor is the x entries the
// rows' paths compare, read once (at most n * |F_U| * 4: only used features
// are read) + scores written once (n * C * 4) + the visited words and leaf
// references and the small tables once, over 3.35 TB/s.  Both variants
// below run on the card: chip_smoke.py drives the global-memory one with a
// 16,384-value leaf table.  Closing the gap is later work: column-major x
// for coalesced root-level reads, tree blocks staged in shared memory with
// cp.async/TMA, and several rows per thread to hide the load latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kStageLimitBytes = 48 * 1024;

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) packed_predict_kernel(
    const float* __restrict__ x,
    const uint32_t* __restrict__ words,
    const int32_t* __restrict__ leaf_ref,
    const float* __restrict__ leaf_values,
    const float* __restrict__ thr_table,
    const int32_t* __restrict__ thr_offsets,
    const int32_t* __restrict__ used_features,
    const float* __restrict__ base,
    float* __restrict__ out,
    int n, int d, int T, int I, int C, int n_fu, int n_thr, int n_leaf_values,
    int max_depth, int tidx_bits) {
  const int32_t* uf = used_features;
  const int32_t* off = thr_offsets;
  const float* thr = thr_table;
  const float* lv = leaf_values;
  if constexpr (kStaged) {
    extern __shared__ int32_t smem[];
    int32_t* s_uf = smem;
    int32_t* s_off = s_uf + n_fu;
    float* s_thr = reinterpret_cast<float*>(s_off + n_fu + 1);
    float* s_lv = s_thr + n_thr;
    for (int i = threadIdx.x; i < n_fu; i += blockDim.x) s_uf[i] = used_features[i];
    for (int i = threadIdx.x; i <= n_fu; i += blockDim.x) s_off[i] = thr_offsets[i];
    for (int i = threadIdx.x; i < n_thr; i += blockDim.x) s_thr[i] = thr_table[i];
    for (int i = threadIdx.x; i < n_leaf_values; i += blockDim.x) s_lv[i] = leaf_values[i];
    __syncthreads();
    uf = s_uf;
    off = s_off;
    thr = s_thr;
    lv = s_lv;
  }

  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const float* xr = x + row * d;
  const int L = I + 1;
  const uint32_t tmask = (1u << tidx_bits) - 1u;

  for (int c = 0; c < C; ++c) {
    float acc = base[c];
    for (int t = c; t < T; t += C) {
      const uint32_t* wt = words + static_cast<int64_t>(t) * I;
      int idx = 0;
      for (int s = 0; s < max_depth; ++s) {
        const uint32_t w = __ldg(wt + idx);
        const uint32_t ref = w >> tidx_bits;
        int right = 0;
        if (ref < static_cast<uint32_t>(n_fu)) {
          const int k = min(max(off[ref] + static_cast<int>(w & tmask), 0), n_thr - 1);
          const float xv = __ldg(xr + uf[ref]);
          right = !(xv <= thr[k]);
        }
        idx = 2 * idx + 1 + right;
      }
      int lr = __ldg(leaf_ref + static_cast<int64_t>(t) * L + (idx - I));
      lr = min(max(lr, 0), n_leaf_values - 1);
      acc += lv[lr];
    }
    out[row * C + c] = acc;
  }
}

}  // namespace

// Launches on `stream`, does not synchronise and allocates nothing; returns
// cudaGetLastError() right after the launch (0 when it was accepted).
extern "C" int toad_packed_predict(
    const void* x, const void* words, const void* leaf_ref,
    const void* leaf_values, const void* thr_table, const void* thr_offsets,
    const void* used_features, const void* base, void* out,
    int n, int d, int T, int I, int C, int n_fu, int n_thr, int n_leaf_values,
    int max_depth, int tidx_bits, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads);
  const size_t staged = sizeof(int32_t) * (2 * static_cast<size_t>(n_fu) + 1) +
                        sizeof(float) * (static_cast<size_t>(n_thr) + n_leaf_values);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TOAD_ARGS                                                              \
  static_cast<const float*>(x), static_cast<const uint32_t*>(words),          \
      static_cast<const int32_t*>(leaf_ref),                                  \
      static_cast<const float*>(leaf_values),                                 \
      static_cast<const float*>(thr_table),                                   \
      static_cast<const int32_t*>(thr_offsets),                               \
      static_cast<const int32_t*>(used_features),                             \
      static_cast<const float*>(base), static_cast<float*>(out), n, d, T, I,  \
      C, n_fu, n_thr, n_leaf_values, max_depth, tidx_bits
  if (staged <= kStageLimitBytes) {
    packed_predict_kernel<true><<<grid, kThreads, staged, s>>>(TOAD_ARGS);
  } else {
    packed_predict_kernel<false><<<grid, kThreads, 0, s>>>(TOAD_ARGS);
  }
#undef TOAD_ARGS
  return static_cast<int>(cudaGetLastError());
}
