// Packed ToaD inference on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/predict.py::_kernel
// (called through packed_predict).  Computes (n, d) f32 raw inputs ->
// (n, C) f32 scores in the Pallas kernel's block order:
//
//   trees are taken in blocks of tree_block (8 rounded up to a multiple of
//   C); block b sums its trees into a zeroed C-wide accumulator, tree k of
//   the block into column k % C in order, and the accumulator is added to
//   the score, which starts from base: out = ((base + blk_0) + blk_1) + ...
//
// where a tree's leaf is reached by max_depth pointer-less steps over its
// uint32 node words, word = tix | ref << tidx_bits (packed_walk.cuh).
//
// What bounds it on this card: not bytes.  The bytes the rows' paths need
// (x entries compared, words and leaf references visited, the tables, the
// scores) take ~0.015 ms at 262,144 rows of the full-width model; the work is
// n * T * max_depth data-dependent steps (537 M at that size), each a chain
// of loads.  One thread a row through every tree, each step three dependent
// loads from L2 or device memory, takes about ten times longer on the H100
// (PERF.md).  This design (packed_walk.cuh) decodes the model once a call so
// that a step is two loads (the node, then the row's x, conflict-free),
// keeps both in shared memory, spreads (row, tree) pairs over the lanes with
// kWalks walks in flight a thread, and so is bound by shared-memory and issue
// throughput on data-dependent steps and by the thread block's
// per-tree-block synchronisation.
//
// Two grids, chosen by the host's plan (predict.py::launch_plan) by shape:
//   * unsplit: a block owns its row tile across all tree blocks and keeps
//     the running scores in shared memory, each (row, class) pair always
//     added by the same thread;
//   * split, where the row tiles alone would leave the card idle (the
//     256-row serve bucket gives 8 tiles of 32 rows): gridDim.y groups of
//     tree blocks; a block writes each tree block's accumulator to
//     scratch[b][row][c] (allocated by the wrapper), and a last launch adds
//     base and the partials in order b = 0, 1, ...: the same bits.

#include "packed_walk.cuh"

namespace {

using namespace toad;

struct Plan {
  int rows, tree_block, n_tblocks, per_group;
};

template <bool kX, bool kTrees>
__global__ void __launch_bounds__(kThreads) packed_predict_kernel(const Args a, const Decoded m,
                                                                  const Plan p, const Layout lay,
                                                                  float* __restrict__ scratch) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int R = p.rows;
  const int tb = p.tree_block;
  const int C = a.C;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * R;
  const int64_t left = a.n - row0;
  const int nrows = static_cast<int>(left < R ? left : R);
  const int b0 = blockIdx.y * p.per_group;
  const int b1 = min(b0 + p.per_group, p.n_tblocks);
  if constexpr (kTrees) issue_tree_block(a, m, lay, smem, tb, b0, 0);  // under the x staging
  float* xs = reinterpret_cast<float*>(smem + lay.x);
  if constexpr (kX) stage_x(a, xs, row0, nrows, R);
  float* vals = reinterpret_cast<float*>(smem + lay.vals);
  float* scores = reinterpret_cast<float*>(smem + lay.scores);

  for (int b = b0; b < b1; ++b) {
    const TreeBlock blk =
        take_tree_block<kTrees>(a, m, lay, smem, tb, b, (b - b0) & 1, b + 1 < b1 ? b + 1 : -1);
    const int cnt = min(tb, a.T - b * tb);
    walk<kX, kTrees>(a, xs, blk, cnt, nullptr, nrows, row0, R, vals);
    __syncthreads();
    // the block's sums, tree k into column k % C in tree order
    for (int q = threadIdx.x; q < nrows * C; q += kThreads) {
      const int r = q / C;
      const int c = q - r * C;
      float acc = 0.0f;
      for (int k = c; k < cnt; k += C) acc = __fadd_rn(acc, vals[k * R + r]);
      if (scratch != nullptr) {
        scratch[static_cast<int64_t>(b) * a.n * C + row0 * C + q] = acc;
      } else {
        scores[q] = __fadd_rn(b == 0 ? __ldg(a.base + c) : scores[q], acc);
      }
    }
  }
  if (scratch == nullptr) {  // each pair's own thread wrote its score
    for (int q = threadIdx.x; q < nrows * C; q += kThreads) a.out[row0 * C + q] = scores[q];
  }
}

// out[i] = ((base + partial_0) + partial_1) + ... over the n * C scores.
__global__ void __launch_bounds__(kThreads) packed_predict_finish_kernel(
    const float* __restrict__ scratch, const float* __restrict__ base, float* __restrict__ out,
    int64_t nC, int C, int n_tblocks) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= nC) return;
  float s = __ldg(base + i % C);
  for (int b = 0; b < n_tblocks; ++b) s = __fadd_rn(s, __ldg(scratch + b * nC + i));
  out[i] = s;
}

template <bool kX, bool kTrees>
cudaError_t launch(const Args& a, const Decoded& m, const Plan& p, const Layout& lay,
                   float* scratch, dim3 grid, cudaStream_t s) {
  auto kernel = packed_predict_kernel<kX, kTrees>;
  const size_t smem = sizeof(uint32_t) * lay.words;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(a, m, p, lay, scratch);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const Args&, const Decoded&, const Plan&, const Layout&, float*,
                               dim3, cudaStream_t);

}  // namespace

// Launches on `stream`, does not synchronise and allocates nothing: the
// decode of the model into `decoded` (10 * T * (I + 1) bytes), the walk, and
// for a split grid the in-order sum.  The plan (rows a block, tree blocks a
// group, the stage bits) comes from predict.py::launch_plan; `scratch` holds
// n_tblocks * n * C floats when the tree blocks are split over groups > 1,
// else it is null.  Returns the first CUDA error of the call (0 when every
// launch was accepted).
extern "C" int toad_packed_predict(
    const void* x, const void* words, const void* leaf_ref,
    const void* leaf_values, const void* thr_table, const void* thr_offsets,
    const void* used_features, const void* base, void* out, void* scratch, void* decoded,
    int n, int d, int T, int I, int C, int n_fu, int n_thr, int n_leaf_values,
    int max_depth, int tidx_bits, int tree_block, int rows, int groups, int per_group,
    int stage, void* stream) {
  const Args a{static_cast<const float*>(x), static_cast<const uint32_t*>(words),
               static_cast<const int32_t*>(leaf_ref), static_cast<const float*>(leaf_values),
               static_cast<const float*>(thr_table), static_cast<const int32_t*>(thr_offsets),
               static_cast<const int32_t*>(used_features), static_cast<const float*>(base),
               static_cast<float*>(out), n, d, T, I, C, n_fu, n_thr, n_leaf_values, max_depth,
               tidx_bits};
  const int n_tblocks = (T + tree_block - 1) / tree_block;
  const Plan p{rows, tree_block, n_tblocks, per_group};
  const Layout lay = make_layout(stage, rows, tree_block, I, C, n_fu, 0);
  // what the kernel cannot run safely; the launch itself refuses too much
  // shared memory
  if (rows % 32 != 0 || rows > 128 || per_group < 1 ||
      static_cast<int64_t>(groups) * per_group < n_tblocks ||
      (groups > 1) != (scratch != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static constexpr Launch kVariants[4] = {launch<false, false>, launch<true, false>,
                                          launch<false, true>, launch<true, true>};
  const Decoded m = decoded_at(decoded, T, I);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_decode(a, m, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* sc = static_cast<float*>(scratch);
  err = kVariants[stage & (kStageX | kStageTrees)](a, m, p, lay, sc,
                                                   dim3((n + rows - 1) / rows, groups), s);
  if (err != cudaSuccess || sc == nullptr) return static_cast<int>(err);
  const int64_t nC = static_cast<int64_t>(n) * C;
  packed_predict_finish_kernel<<<static_cast<unsigned>((nC + kThreads - 1) / kThreads), kThreads, 0,
                                 s>>>(sc, a.base, a.out, nC, C, n_tblocks);
  return static_cast<int>(cudaGetLastError());
}
