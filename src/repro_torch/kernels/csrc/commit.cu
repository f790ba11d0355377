// The greedy node-by-node split commit of one tree level on Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package commits a level's nodes in a
// jax.lax.fori_loop over nodes (src/repro/gbdt/trainer.py, `commit`, :186),
// which XLA runs as one loop on the TPU.  The port's eager loop
// (kernels/commit.py, commit_level_ref) queues ~35 small operations a node
// from Python, ~9,000 a depth-8 tree, and the host's dispatch of them paced
// the fit.  This kernel is that loop, one launch a level.
//
// For node j = 0, 1, ... of the level, in order (node j + 1 sees the
// features and thresholds node j paid for, the paper's greedy semantics),
// with each float32 operation rounded as the plain loop's PyTorch
// operations round on the card, and none contracted into an FMA:
//
//   pen[f, e]  = pen_f * !used_feat[f] + pen_t * !used_thr[f, e]
//   split_cost = (cegb * totC[j]) * (1 / n_rows)   (PyTorch's CUDA division
//                by a host scalar multiplies by the scalar's reciprocal)
//   eff[f, e]  = valid[j, f, e] ? (gain[j, f, e] - pen[f, e]) - split_cost
//                               : -inf
//   best, i    = the maximum over the flattened (f, e) in torch.max's order:
//                a NaN first, then the larger value, ties to the lower index
//   ok         = best > 0 && !dead[j]                  (NaN > 0 is false)
//   if ok: node base_idx + j takes t_feat = i / E, t_thr = i % E,
//          t_split = true, t_gain = gain[j, i] (the raw gain, not eff);
//          used_feat[f] and used_thr[f, e] are set; n_splits += 1.
//
// What bounds it: the nodes are serial, so the work of a level is one
// pass over gain and valid, 5 B a candidate: 326 KB a node at 256 features
// x 255 edges, 83 MB a depth-8 tree, 25 us at 3.35 TB/s.  No walk of the
// nodes in turn comes near that: each node pays a reduction over the
// level's candidates and a barrier before the next may start.  The design
// keeps both short:
//
//   * one cluster of kCluster = 8 blocks of 1,024 threads walks the level,
//     the candidates of a node dealt over all 8,192 threads (two quads a
//     thread at 256 x 255); one block alone took 3.85 ms a tree, 8 blocks
//     1.20, 16 (a non-portable cluster) 1.03 on an H100;
//   * every block keeps its own copy of the used sets on chip for the whole
//     level, one byte a flag in shared memory (65.8 KB at 256 x 255),
//     copied in once and out once (by block 0), and makes the same commits
//     to it.  A level whose sets pass kSmemBudget keeps them in device
//     memory, where the blocks share one copy and write the same flags to
//     it (the same code through generic pointers), so no shape the loop
//     takes is refused;
//   * four candidates a load where d * E is a multiple of 4 (one 16-byte
//     load of gains, one 4-byte load of valid flags, one of threshold
//     flags), the feature from one division a quad;
//   * each thread keeps its (eff, index, raw gain) best; a block reduces
//     them by warp shuffles, then through shared memory in warp 0, into a
//     slot of its shared memory; after one cluster barrier warp 0 of every
//     block reads the 8 slots (distributed shared memory) and reaches the
//     same winner.  torch.max's order is total, so the reduction's shape
//     cannot change the answer;
//   * a node costs two block barriers and one cluster barrier; the slots
//     alternate between nodes, so a block may start node j + 1 while
//     another still reads node j's slots.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // blocks of the one cluster (the portable most)
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// bytes of shared memory the used sets may take (one a flag; the feature
// flags padded to 16); above it they stay in device memory
constexpr long long kSmemBudget = 200 * 1024;

struct Args {
  const float* gain;     // (n_nodes, d, E)
  const uint8_t* valid;  // (n_nodes, d, E) bool
  const float* totC;     // (n_nodes,)
  const uint8_t* dead;   // (n_nodes,) bool
  const float* pen_f;    // 0-d
  const float* pen_t;    // 0-d
  uint8_t* used_feat;    // (d,) bool, updated in place
  uint8_t* used_thr;     // (d, E) bool, updated in place
  int32_t* t_feat;       // (I,)
  int32_t* t_thr;        // (I,)
  uint8_t* t_split;      // (I,) bool
  float* t_gain;         // (I,)
  int32_t* n_splits;     // 0-d
  double cegb;
  long long n_rows, d, E;
  int n_nodes, base_idx;
};

template <typename Idx>
struct Best {
  float val;
  float raw;
  Idx idx;
};

// (a, ia) comes before (b, ib) in torch.max's order.
template <typename Idx>
__device__ __forceinline__ bool before(float a, Idx ia, float b, Idx ib) {
  if (isnan(a)) return !isnan(b) || ia < ib;
  if (isnan(b)) return false;
  return a > b || (a == b && ia < ib);
}

// Candidate i of the node: its penalised gain, kept if it comes first.
template <typename Idx>
__device__ __forceinline__ void consider(Best<Idx>& b, Idx i, float g, bool valid, bool feat_used,
                                         bool thr_used, float pf, float pt, float cost) {
  const float pen = __fadd_rn(__fmul_rn(pf, feat_used ? 0.0f : 1.0f),
                              __fmul_rn(pt, thr_used ? 0.0f : 1.0f));
  const float eff = valid ? __fsub_rn(__fsub_rn(g, pen), cost) : -INFINITY;
  if (before(eff, i, b.val, b.idx)) b = Best<Idx>{eff, g, i};
}

template <typename Idx>
__device__ __forceinline__ void warp_reduce(Best<Idx>& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(kFull, b.val, off);
    const float r = __shfl_xor_sync(kFull, b.raw, off);
    const Idx i = __shfl_xor_sync(kFull, b.idx, off);
    if (before(v, i, b.val, b.idx)) b = Best<Idx>{v, r, i};
  }
}

// dst[0, n) = src[0, n) by the block's threads, 16 bytes a load where both
// lie on 16 bytes
template <typename Idx>
__device__ __forceinline__ void copy_bytes(uint8_t* dst, const uint8_t* src, Idx n) {
  Idx done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) % 16 == 0) {
    for (Idx k = threadIdx.x; k < n / 16; k += kThreads) {
      reinterpret_cast<uint4*>(dst)[k] = reinterpret_cast<const uint4*>(src)[k];
    }
    done = n / 16 * 16;
  }
  for (Idx k = done + threadIdx.x; k < n; k += kThreads) dst[k] = src[k];
}

// Idx: a candidate's index within a node (int while d * E fits in it).
// One cluster of kCluster blocks walks the level; block r takes the quads
// (or candidates) r * kThreads + tid, r * kThreads + tid + kCluster * kThreads, ...
template <typename Idx>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    commit_level_kernel(Args a, bool sets_in_smem, bool quads) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Best<Idx> s_best[kWarps];
  __shared__ Best<Idx> s_slot[2];  // the block's best of node j in slot j % 2
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const Idx first = static_cast<Idx>(rank) * kThreads + tid;
  constexpr Idx kStride = static_cast<Idx>(kCluster) * kThreads;
  const Idx E = static_cast<Idx>(a.E);
  const Idx DE = static_cast<Idx>(a.d) * E;
  const Idx feat_bytes = (static_cast<Idx>(a.d) + 15) / 16 * 16;
  // each block keeps its own copy of the used sets in shared memory and
  // makes the same commits to it; in device memory the blocks share one
  // copy and write the same flags to it
  uint8_t* uf = a.used_feat;
  uint8_t* ut = a.used_thr;
  if (sets_in_smem) {
    copy_bytes(smem, a.used_feat, static_cast<Idx>(a.d));
    copy_bytes(smem + feat_bytes, a.used_thr, DE);
    uf = smem;
    ut = smem + feat_bytes;
    __syncthreads();
  }
  const float pf = *a.pen_f;
  const float pt = *a.pen_t;
  const float cegb = __double2float_rn(a.cegb);
  const float inv_rows = __frcp_rn(__ll2float_rn(a.n_rows));
  // no candidate yet: the largest Idx, so that any candidate ties before it
  constexpr Idx kNone = static_cast<Idx>(~0ull >> (65 - 8 * sizeof(Idx)));
  int commits = 0;  // thread 0 of block 0 only

  for (int j = 0; j < a.n_nodes; ++j) {
    const float cost = __fmul_rn(__fmul_rn(cegb, a.totC[j]), inv_rows);
    const float* g = a.gain + static_cast<long long>(j) * a.d * a.E;
    const uint8_t* v = a.valid + static_cast<long long>(j) * a.d * a.E;
    Best<Idx> b{-INFINITY, 0.0f, kNone};
    if (quads) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
      const uint32_t* v4 = reinterpret_cast<const uint32_t*>(v);
      const uint32_t* t4 = reinterpret_cast<const uint32_t*>(ut);
#pragma unroll 2
      for (Idx q = first; q < DE / 4; q += kStride) {
        const float4 gq = __ldg(g4 + q);
        const uint32_t vq = __ldg(v4 + q);
        const uint32_t tq = t4[q];
        const float gs[4] = {gq.x, gq.y, gq.z, gq.w};
        Idx i = 4 * q;
        Idx f = i / E;
        Idx e = i - f * E;
#pragma unroll
        for (int k = 0; k < 4; ++k, ++i) {
          consider(b, i, gs[k], ((vq >> (8 * k)) & 0xffu) != 0, uf[f] != 0,
                   ((tq >> (8 * k)) & 0xffu) != 0, pf, pt, cost);
          if (++e == E) {
            e = 0;
            ++f;
          }
        }
      }
    } else {
      for (Idx i = first; i < DE; i += kStride) {
        consider(b, i, __ldg(g + i), __ldg(v + i) != 0, uf[i / E] != 0, ut[i] != 0, pf, pt,
                 cost);
      }
    }
    warp_reduce(b);
    if (lane == 0) s_best[warp] = b;
    __syncthreads();
    if (warp == 0) {
      b = s_best[lane];
      warp_reduce(b);
      if (lane == 0) s_slot[j & 1] = b;
    }
    // every block's best of node j is visible to the cluster; a slot is
    // written again at node j + 2, after every block passed node j + 1's
    // barrier, so after its reads of node j
    cluster.sync();
    if (warp == 0) {
      b = Best<Idx>{-INFINITY, 0.0f, kNone};
      if (lane < kCluster) b = *cluster.map_shared_rank(&s_slot[j & 1], lane);
      warp_reduce(b);
      if (lane == 0 && b.val > 0.0f && !a.dead[j]) {
        const Idx f = b.idx / E;
        uf[f] = 1;
        ut[b.idx] = 1;
        if (rank == 0) {
          const int node = a.base_idx + j;
          a.t_feat[node] = static_cast<int32_t>(f);
          a.t_thr[node] = static_cast<int32_t>(b.idx - f * E);
          a.t_split[node] = 1;
          a.t_gain[node] = b.raw;
          ++commits;
        }
      }
    }
    __syncthreads();
  }

  if (sets_in_smem && rank == 0) {
    copy_bytes(a.used_feat, uf, static_cast<Idx>(a.d));
    copy_bytes(a.used_thr, ut, DE);
  }
  if (rank == 0 && tid == 0) *a.n_splits += commits;
  cluster.sync();  // no block leaves while another may read its slots
}

template <typename Idx>
cudaError_t launch(const Args& a, bool sets_in_smem, bool quads, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        commit_level_kernel<Idx>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  commit_level_kernel<Idx><<<kCluster, kThreads, smem, s>>>(a, sets_in_smem, quads);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to == 0; }

}  // namespace

extern "C" int toad_commit_level(
    const void* gain, const void* valid, const void* totC, const void* dead, const void* pen_f,
    const void* pen_t, double cegb, long long n_rows, void* used_feat, void* used_thr,
    void* t_feat, void* t_thr, void* t_split, void* t_gain, void* n_splits, int n_nodes,
    long long d, long long E, int base_idx, void* stream) {
  if (n_nodes < 0 || d <= 0 || E <= 0 || base_idx < 0 || d > LLONG_MAX / E) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_nodes == 0) return static_cast<int>(cudaSuccess);
  const Args a{static_cast<const float*>(gain), static_cast<const uint8_t*>(valid),
               static_cast<const float*>(totC), static_cast<const uint8_t*>(dead),
               static_cast<const float*>(pen_f), static_cast<const float*>(pen_t),
               static_cast<uint8_t*>(used_feat), static_cast<uint8_t*>(used_thr),
               static_cast<int32_t*>(t_feat), static_cast<int32_t*>(t_thr),
               static_cast<uint8_t*>(t_split), static_cast<float*>(t_gain),
               static_cast<int32_t*>(n_splits), cegb, n_rows, d, E, n_nodes, base_idx};
  const long long DE = d * E;
  const long long feat_bytes = (d + 15) / 16 * 16;
  const bool sets_in_smem = feat_bytes + DE <= kSmemBudget;
  const size_t smem = sets_in_smem ? static_cast<size_t>(feat_bytes + DE) : 0;
  const bool quads = DE % 4 == 0 && aligned(gain, 16) && aligned(valid, 4) &&
                     (sets_in_smem || aligned(used_thr, 4));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = DE < INT_MAX ? launch<int>(a, sets_in_smem, quads, smem, s)
                                       : launch<long long>(a, sets_in_smem, quads, smem, s);
  return static_cast<int>(err);
}
