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
// The traversal is packed_predict.cu's (packed_walk.cuh): the model decoded
// once a call, the tile's used x and each decoded tree block in shared
// memory as the shape allows (the next block in flight by cp.async), lanes
// on (row, tree-of-the-block) pairs, kWalks walks in flight a thread.

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
// Design: the exit after block b depends on the whole prefix, so a block
// owns its row tile across all tree blocks (never split over the grid).  It
// keeps a list of its live rows in shared memory; the walk's lanes take
// (live row, tree) pairs, so after each tree block the list is compacted
// (in row order, by warp ballots) and no lane idles on a row that has
// exited.  One owner thread a live row forms its block sums in tree order,
// adds them to its scores (kept in shared memory) and decides; an exited row keeps
// its sums at its exit boundary, so every output is deterministic and
// independent of the thread block (the Pallas kernel keeps adding to exited
// rows while their tile lives; the contract for exited rows is their
// label).  rem_blocks (n_tblocks, C) and slack are staged in shared memory.
//
// What bounds it on this card: as packed_predict.cu, shared-memory and issue
// throughput on data-dependent steps, now only over the trees each row
// evaluates; the bytes floor (the x entries and words/leaf references the
// rows' evaluated paths touch, the tables, scores and exit written once) is
// far below.

#include "packed_walk.cuh"

namespace {

using namespace toad;

struct Plan {
  int rows, tree_block, n_tblocks;
};

struct Exit {
  const float* rem_blocks;
  const float* slack;
  int32_t* exit_out;
  float guard;
};

__device__ __forceinline__ bool final_binary(float s, float r, float slack0, float guard) {
  const float g = __fadd_rn(slack0, __fmul_rn(guard, __fadd_rn(1.0f, fabsf(s))));
  return (__fsub_rn(s, r) > g) || (__fadd_rn(s, r) <= -g);
}

__device__ __forceinline__ bool final_multiclass(const float* s, const float* rem,
                                                 const float* slack, int C, float guard) {
  for (int j = 0; j < C; ++j) {
    const float sj = s[j];
    bool cond = true;
    for (int c = 0; c < C && cond; ++c) {
      if (c == j) continue;
      const float sc = s[c];
      const float need = __fadd_rn(
          __fadd_rn(__fadd_rn(rem[j], rem[c]), slack[j]),
          __fmul_rn(guard, __fadd_rn(__fadd_rn(1.0f, fabsf(sj)), fabsf(sc))));
      const float diff = __fsub_rn(sj, sc);
      cond = (c < j) ? (diff > need) : (diff >= need);
    }
    if (cond) return true;
  }
  return false;
}

template <bool kX, bool kTrees>
__global__ void __launch_bounds__(kThreads) packed_predict_ee_kernel(const Args a,
                                                                     const Decoded m,
                                                                     const Exit e, const Plan p,
                                                                     const Layout lay) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int R = p.rows;
  const int tb = p.tree_block;
  const int C = a.C;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * R;
  const int64_t left = a.n - row0;
  const int nrows = static_cast<int>(left < R ? left : R);
  if constexpr (kTrees) issue_tree_block(a, m, lay, smem, tb, 0, 0);  // under the staging below
  float* xs = reinterpret_cast<float*>(smem + lay.x);
  if constexpr (kX) stage_x(a, xs, row0, nrows, R);
  float* vals = reinterpret_cast<float*>(smem + lay.vals);
  float* scores = reinterpret_cast<float*>(smem + lay.scores);  // [R][C]
  int32_t* live = reinterpret_cast<int32_t*>(smem + lay.extra);  // [2][R]
  int32_t* wcount = live + 2 * R;                                // [kWarps]
  float* rem = reinterpret_cast<float*>(wcount + kWarps);  // [n_tblocks][C]
  float* slack = rem + p.n_tblocks * C;                      // [C]
  for (int i = tid; i < p.n_tblocks * C; i += kThreads) rem[i] = __ldg(e.rem_blocks + i);
  for (int i = tid; i < C; i += kThreads) slack[i] = __ldg(e.slack + i);
  for (int i = tid; i < nrows; i += kThreads) live[i] = i;
  for (int q = tid; q < nrows * C; q += kThreads) scores[q] = __ldg(a.base + q % C);

  int nlive = nrows;
  int cur = 0;
  for (int b = 0; b < p.n_tblocks && nlive > 0; ++b) {
    const TreeBlock blk =
        take_tree_block<kTrees>(a, m, lay, smem, tb, b, b & 1, b + 1 < p.n_tblocks ? b + 1 : -1);
    const int start = b * tb;
    const int cnt = min(tb, a.T - start);
    walk<kX, kTrees>(a, xs, blk, cnt, live + cur * R, nlive, row0, R, vals);
    __syncthreads();
    bool keep = false;
    int r = 0;
    if (tid < nlive) {  // rows <= 128 < kThreads: one owner a live row
      r = live[cur * R + tid];
      float* srow = scores + r * C;
      for (int c = 0; c < C; ++c) {
        float acc = 0.0f;
        for (int k = c; k < cnt; k += C) acc = __fadd_rn(acc, vals[k * R + tid]);
        srow[c] = __fadd_rn(srow[c], acc);
      }
      const bool fin = C == 1 ? final_binary(srow[0], rem[b], slack[0], e.guard)
                              : final_multiclass(srow, rem + b * C, slack, C, e.guard);
      if (fin) e.exit_out[row0 + r] = min(start + tb, a.T);
      keep = !fin;
    }
    // compact the live rows, in row order, into the other list
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) wcount[warp] = __popc(mask);
    __syncthreads();
    int before = 0;
    nlive = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcount[w];
      before += w < warp ? c : 0;
      nlive += c;
    }
    if (keep) live[(cur ^ 1) * R + before + __popc(mask & ((1u << lane) - 1u))] = r;
    cur ^= 1;
  }
  cp_async_wait<0>();  // a tile whose rows all exited leaves no copy in flight
  __syncthreads();
  for (int i = tid; i < nlive; i += kThreads) e.exit_out[row0 + live[cur * R + i]] = a.T + 1;
  for (int q = tid; q < nrows * C; q += kThreads) a.out[row0 * C + q] = scores[q];
}

template <bool kX, bool kTrees>
cudaError_t launch(const Args& a, const Decoded& m, const Exit& e, const Plan& p,
                   const Layout& lay, dim3 grid, cudaStream_t s) {
  auto kernel = packed_predict_ee_kernel<kX, kTrees>;
  const size_t smem = sizeof(uint32_t) * lay.words;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(a, m, e, p, lay);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const Args&, const Decoded&, const Exit&, const Plan&,
                               const Layout&, dim3, cudaStream_t);

}  // namespace

// Launches on `stream`, does not synchronise and allocates nothing: the
// decode of the model into `decoded` (10 * T * (I + 1) bytes), then the walk.
// The plan (rows a block, the stage bits) comes from predict.py::launch_plan.
// Returns the first CUDA error of the call (0 when every launch was accepted).
extern "C" int toad_packed_predict_ee(
    const void* x, const void* words, const void* leaf_ref,
    const void* leaf_values, const void* thr_table, const void* thr_offsets,
    const void* used_features, const void* base, const void* rem_blocks,
    const void* slack, void* out, void* exit_out, void* decoded,
    int n, int d, int T, int I, int C, int n_fu, int n_thr, int n_leaf_values,
    int max_depth, int tidx_bits, int tree_block, int rows, int stage, float guard,
    void* stream) {
  const Args a{static_cast<const float*>(x), static_cast<const uint32_t*>(words),
               static_cast<const int32_t*>(leaf_ref), static_cast<const float*>(leaf_values),
               static_cast<const float*>(thr_table), static_cast<const int32_t*>(thr_offsets),
               static_cast<const int32_t*>(used_features), static_cast<const float*>(base),
               static_cast<float*>(out), n, d, T, I, C, n_fu, n_thr, n_leaf_values, max_depth,
               tidx_bits};
  const Exit e{static_cast<const float*>(rem_blocks), static_cast<const float*>(slack),
               static_cast<int32_t*>(exit_out), guard};
  const int n_tblocks = (T + tree_block - 1) / tree_block;
  const Plan p{rows, tree_block, n_tblocks};
  // the live lists, the warps' counts, rem_blocks and slack
  const int extra = 2 * rows + kWarps + n_tblocks * C + C;
  const Layout lay = make_layout(stage, rows, tree_block, I, C, n_fu, extra);
  // what the kernel cannot run safely (one owner thread a row); the launch
  // itself refuses too much shared memory
  if (rows % 32 != 0 || rows > 128) return static_cast<int>(cudaErrorInvalidValue);
  static constexpr Launch kVariants[4] = {launch<false, false>, launch<true, false>,
                                          launch<false, true>, launch<true, true>};
  const Decoded m = decoded_at(decoded, T, I);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_decode(a, m, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(kVariants[stage & (kStageX | kStageTrees)](
      a, m, e, p, lay, dim3((n + rows - 1) / rows), s));
}
