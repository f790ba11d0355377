// Early-exit packed ToaD inference on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/predict.py::_kernel_ee
// (called through _packed_predict_ee_call and packed_predict_early_exit).
// Computes, for (n, d) f32 raw inputs, (n, C) f32 scores and an (n,) i32
// exit prefix:
//
//   trees are taken in blocks of tree_block (a multiple of C); block b sums
//   its trees into a zeroed C-wide accumulator, tree k of the block into
//   column k % C in order, then adds the accumulator to the row's scores
//   (the Pallas kernel's order: acc.at[:, k % C].add(v); out += acc).
//   After block b a row whose scores are decision-final against
//   rem_blocks[b] (the rule below) records exit = min((b+1)·tree_block, T)
//   and stops; a row that never does records T + 1.
//
// The traversal is packed_predict.cu's: go left iff ref == n_fu (unsplit)
// or x[r, used_features[ref]] <= thr_table[thr_offsets[ref] + tix]; NaN
// compares false, so it routes right (built without fast math).
//
// The decision (src/repro_torch/gbdt/early_exit.py::decision_final_mask,
// evaluated there in float32 on tensors) is written with __fadd_rn /
// __fsub_rn / __fmul_rn in its left-to-right order, so nvcc cannot contract
// a multiply and an add into one FMA, which would round differently and
// move exits at near-ties:
//   C == 1: g = slack[0] + guard * (1 + |s|);  final iff s - r > g  or
//           s + r <= -g  (r = rem[0]);
//   C > 1:  final iff some j has, for every c != j, with
//           need = ((rem[j] + rem[c]) + slack[j]) + guard * ((1 + |s_j|) + |s_c|),
//           s_j - s_c > need for c < j and s_j - s_c >= need for c > j.
// A margin equal to the bound does not exit; a +inf bound row (below
// min_trees) makes every comparison false.
//
// Design (simple and right first):
//   * one thread per row, 256-thread blocks; the small tables staged in
//     shared memory under 48 KB, as in packed_predict.cu, words and leaf
//     references read from L2 with __ldg;
//   * a thread whose row has exited stops walking trees, so a warp retires
//     when all of its rows have; an exited row keeps its sums at its exit
//     boundary, so every output is deterministic and independent of the
//     thread block (the Pallas kernel keeps adding to exited rows while
//     their tile lives; the contract for exited rows is their label);
//   * C == 1 keeps the score in a register; C > 1 keeps the row's scores in
//     its own row of `out` (global memory, L1-resident), each class column
//     summed over its trees of the block in order, any C.
//
// What bounds it on this card: as packed_predict.cu, per-row dependent
// loads (latency-bound L2 traffic), now only over the trees each row
// evaluates.  Bytes floor: the x entries and words/leaf references the rows'
// evaluated paths touch, the tables, scores and exit written once, over
// 3.35 TB/s.  Closing the gap (cp.async/TMA staging of tree blocks, several
// rows per thread) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kStageLimitBytes = 48 * 1024;

struct Tables {
  const int32_t* uf;
  const int32_t* off;
  const float* thr;
  const float* lv;
};

__device__ __forceinline__ float tree_leaf(
    const Tables& tb, const float* __restrict__ xr,
    const uint32_t* __restrict__ words, const int32_t* __restrict__ leaf_ref,
    int t, int I, int n_fu, int n_thr, int n_leaf_values, int max_depth,
    int tidx_bits) {
  const uint32_t tmask = (1u << tidx_bits) - 1u;
  const uint32_t* wt = words + static_cast<int64_t>(t) * I;
  int idx = 0;
  for (int s = 0; s < max_depth; ++s) {
    const uint32_t w = __ldg(wt + idx);
    const uint32_t ref = w >> tidx_bits;
    int right = 0;
    if (ref < static_cast<uint32_t>(n_fu)) {
      const int k = min(max(tb.off[ref] + static_cast<int>(w & tmask), 0), n_thr - 1);
      const float xv = __ldg(xr + tb.uf[ref]);
      right = !(xv <= tb.thr[k]);
    }
    idx = 2 * idx + 1 + right;
  }
  int lr = __ldg(leaf_ref + static_cast<int64_t>(t) * (I + 1) + (idx - I));
  lr = min(max(lr, 0), n_leaf_values - 1);
  return tb.lv[lr];
}

__device__ __forceinline__ bool final_binary(float s, float r, float slack0, float guard) {
  const float g = __fadd_rn(slack0, __fmul_rn(guard, __fadd_rn(1.0f, fabsf(s))));
  return (__fsub_rn(s, r) > g) || (__fadd_rn(s, r) <= -g);
}

__device__ __forceinline__ bool final_multiclass(
    const float* s, const float* __restrict__ rem, const float* __restrict__ slack,
    int C, float guard) {
  for (int j = 0; j < C; ++j) {
    const float sj = s[j];
    bool cond = true;
    for (int c = 0; c < C && cond; ++c) {
      if (c == j) continue;
      const float sc = s[c];
      const float need = __fadd_rn(
          __fadd_rn(__fadd_rn(__ldg(rem + j), __ldg(rem + c)), __ldg(slack + j)),
          __fmul_rn(guard, __fadd_rn(__fadd_rn(1.0f, fabsf(sj)), fabsf(sc))));
      const float diff = __fsub_rn(sj, sc);
      cond = (c < j) ? (diff > need) : (diff >= need);
    }
    if (cond) return true;
  }
  return false;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) packed_predict_ee_kernel(
    const float* __restrict__ x,
    const uint32_t* __restrict__ words,
    const int32_t* __restrict__ leaf_ref,
    const float* __restrict__ leaf_values,
    const float* __restrict__ thr_table,
    const int32_t* __restrict__ thr_offsets,
    const int32_t* __restrict__ used_features,
    const float* __restrict__ base,
    const float* __restrict__ rem_blocks,
    const float* __restrict__ slack,
    float* __restrict__ out,
    int32_t* __restrict__ exit_out,
    int n, int d, int T, int I, int C, int n_fu, int n_thr, int n_leaf_values,
    int max_depth, int tidx_bits, int tree_block, float guard) {
  Tables tb{used_features, thr_offsets, thr_table, leaf_values};
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
    tb = Tables{s_uf, s_off, s_thr, s_lv};
  }

  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const float* xr = x + row * d;
  float* srow = out + row * C;
  const int n_tblocks = (T + tree_block - 1) / tree_block;
  int exit_at = T + 1;
#define TOAD_LEAF(t) \
  tree_leaf(tb, xr, words, leaf_ref, (t), I, n_fu, n_thr, n_leaf_values, max_depth, tidx_bits)

  if (C == 1) {
    float s = base[0];
    const float slack0 = __ldg(slack);
    for (int b = 0; b < n_tblocks; ++b) {
      const int start = b * tree_block;
      const int stop = min(start + tree_block, T);
      float acc = 0.0f;
      for (int t = start; t < stop; ++t) acc = __fadd_rn(acc, TOAD_LEAF(t));
      s = __fadd_rn(s, acc);
      if (final_binary(s, __ldg(rem_blocks + b), slack0, guard)) {
        exit_at = stop;
        break;
      }
    }
    srow[0] = s;
  } else {
    for (int c = 0; c < C; ++c) srow[c] = base[c];
    for (int b = 0; b < n_tblocks; ++b) {
      const int start = b * tree_block;
      const int stop = min(start + tree_block, T);
      for (int c = 0; c < C; ++c) {
        float acc = 0.0f;
        for (int t = start + c; t < stop; t += C) acc = __fadd_rn(acc, TOAD_LEAF(t));
        srow[c] = __fadd_rn(srow[c], acc);
      }
      if (final_multiclass(srow, rem_blocks + static_cast<int64_t>(b) * C, slack, C, guard)) {
        exit_at = stop;
        break;
      }
    }
  }
#undef TOAD_LEAF
  exit_out[row] = exit_at;
}

}  // namespace

// Launches on `stream`, does not synchronise and allocates nothing; returns
// cudaGetLastError() right after the launch (0 when it was accepted).
extern "C" int toad_packed_predict_ee(
    const void* x, const void* words, const void* leaf_ref,
    const void* leaf_values, const void* thr_table, const void* thr_offsets,
    const void* used_features, const void* base, const void* rem_blocks,
    const void* slack, void* out, void* exit_out,
    int n, int d, int T, int I, int C, int n_fu, int n_thr, int n_leaf_values,
    int max_depth, int tidx_bits, int tree_block, float guard, void* stream) {
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
      static_cast<const float*>(base), static_cast<const float*>(rem_blocks), \
      static_cast<const float*>(slack), static_cast<float*>(out),             \
      static_cast<int32_t*>(exit_out), n, d, T, I, C, n_fu, n_thr,            \
      n_leaf_values, max_depth, tidx_bits, tree_block, guard
  if (staged <= kStageLimitBytes) {
    packed_predict_ee_kernel<true><<<grid, kThreads, staged, s>>>(TOAD_ARGS);
  } else {
    packed_predict_ee_kernel<false><<<grid, kThreads, 0, s>>>(TOAD_ARGS);
  }
#undef TOAD_ARGS
  return static_cast<int>(cudaGetLastError());
}
