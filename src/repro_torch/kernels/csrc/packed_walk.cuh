// The tree walk shared by packed_predict.cu (B1) and packed_predict_ee.cu (B3).
//
// A call is two or three launches.  decode_model_kernel first writes the
// model, decoded, into a buffer the wrapper allocates (T rows of L = I + 1
// entries, a tree's nodes then one unused entry):
//
//   node_thr[t][i]  the node's threshold, thr_table[thr_offsets[ref] + tix]
//                   (+inf for an unsplit node);
//   node_ref[t][i]  its feature slot ref < n_fu (uint16), n_fu when unsplit;
//   leaf_val[t][j]  leaf_values[leaf_ref[t][j]].
//
// so a step of the walk is two loads, the node and then the row's x, where
// the packed words take three dependent ones (word, thr_offsets, threshold).
// Every thread block walks every tree of its grid row; decoding once a call
// rather than once a thread block and tree block is what makes the decoded
// form pay.
//
// A thread block owns a tile of `rows` rows (32, 64 or 128).  It stages in
// dynamic shared memory what the shape lets it (the host's plan,
// src/repro_torch/kernels/predict.py::launch_plan, sets the `stage` bits):
//
//   * kStageX: the tile's x gathered to the used features, feature-major,
//     xs[j][r] = x[row r, used_features[j]], and a last column xs[n_fu][r] =
//     -inf, against which an unsplit node's +inf sends every row left.  A
//     lane walks row slot g * 32 + lane, so its read of xs[ref][r] falls in
//     bank `lane` whatever feature it compares: no bank conflict;
//   * kStageTrees: tree blocks (tree_block trees, the Pallas kernel's unit of
//     work) of the decoded model, double-buffered with cp.async: block b + 1
//     is in flight while block b is walked.  stage_async places each copy
//     at its source's phase modulo 16 bytes (a buffer has 3 words of slack),
//     4-byte copies around a body of 16-byte ones, so a block may start at
//     any 4-byte offset (as the packed words' blocks do, (T, I) with I odd,
//     whenever tree_block % 4 != 0, C = 3 for one; the decoded rows of even
//     length L start off 16 bytes only for depth 1).
//
// What the shape does not let a block stage it reads from global memory
// (L1/L2), through the template arguments: chosen by shape alone.
//
// The walk spreads (row, tree) pairs over the lanes: a task is one tree of
// the block for a group of 32 row slots, a lane a slot.  All lanes of a warp
// walk the same tree, so the first five levels' nodes are at most 32
// neighbouring entries (the root a broadcast).  Warp w takes tasks w, w + 8,
// ..., kWalks at once: each thread keeps kWalks independent walks in flight,
// so shared-memory latency overlaps.  Go left iff x <= threshold; NaN
// compares false, so it routes right (built without fast math).  Gather
// indices are clamped into their tables, as JAX gathers clamp.  A walk
// leaves its leaf value in vals[k][slot]; the kernel then sums each row's
// values in tree order (never by a shuffle tree, which would reorder them).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace toad {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWalks = 4;  // walks a thread keeps in flight

// the plan's stage bits
constexpr int kStageX = 1;
constexpr int kStageTrees = 2;

struct Args {
  const float* x;
  const uint32_t* words;
  const int32_t* leaf_ref;
  const float* leaf_values;
  const float* thr_table;
  const int32_t* thr_offsets;
  const int32_t* used_features;
  const float* base;
  float* out;
  int n, d, T, I, C, n_fu, n_thr, n_lv, max_depth, tidx_bits;
};

// The decoded model, in the buffer the wrapper allocates: 10 bytes an entry.
struct Decoded {
  float* node_thr;     // (T, L)
  float* leaf_val;     // (T, L)
  uint16_t* node_ref;  // (T, L)
};

__host__ __device__ inline int64_t decoded_entries(int T, int I) {
  return static_cast<int64_t>(T) * (I + 1);
}

__host__ inline Decoded decoded_at(void* buf, int T, int I) {
  const int64_t e = decoded_entries(T, I);
  float* f = static_cast<float*>(buf);
  return Decoded{f, f + e, reinterpret_cast<uint16_t*>(f + 2 * e)};
}

// One thread an entry (t, i) of the (T, L) tables.
__global__ void __launch_bounds__(kThreads) decode_model_kernel(const Args a, const Decoded m) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= decoded_entries(a.T, a.I)) return;
  const int64_t t = e >> a.max_depth;
  const int i = static_cast<int>(e - (t << a.max_depth));
  float thr = INFINITY;  // unsplit (or the unused last entry): left
  uint32_t slot = static_cast<uint32_t>(a.n_fu);
  if (i < a.I) {
    const uint32_t w = __ldg(a.words + t * a.I + i);
    const uint32_t ref = w >> a.tidx_bits;
    if (ref < static_cast<uint32_t>(a.n_fu)) {
      const int k = min(max(__ldg(a.thr_offsets + ref) +
                                static_cast<int>(w & ((1u << a.tidx_bits) - 1u)), 0),
                        a.n_thr - 1);
      thr = __ldg(a.thr_table + k);
      slot = ref;
    }
  }
  m.node_thr[e] = thr;
  m.node_ref[e] = static_cast<uint16_t>(slot);
  m.leaf_val[e] = __ldg(a.leaf_values + min(max(__ldg(a.leaf_ref + e), 0), a.n_lv - 1));
}

// Launches the decode of the model into `m` on stream s.
inline cudaError_t launch_decode(const Args& a, const Decoded& m, cudaStream_t s) {
  const int64_t e = decoded_entries(a.T, a.I);
  decode_model_kernel<<<static_cast<unsigned>((e + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      a, m);
  return cudaGetLastError();
}

// word offsets into dynamic shared memory; every region starts 16-byte aligned
struct Layout {
  int x, trees, tree_stride, leaf_in_tree, ref_in_tree, vals, scores, extra, words;
};

__host__ __device__ inline int round4(int w) { return (w + 3) & ~3; }

// The same sizes as predict.py::_smem_words: keep the two in step.
__host__ inline Layout make_layout(int stage, int rows, int tree_block, int I, int C, int n_fu,
                                   int extra_words) {
  Layout s{};
  int o = 0;
  if (stage & kStageX) {
    s.x = o;
    o += round4((n_fu + 1) * rows);
  }
  const int entries = tree_block * (I + 1);
  s.leaf_in_tree = round4(entries + 3);
  s.ref_in_tree = 2 * s.leaf_in_tree;
  s.tree_stride = s.ref_in_tree + round4(entries / 2 + 3);
  if (stage & kStageTrees) {
    s.trees = o;
    o += 2 * s.tree_stride;
  }
  s.vals = o;
  o += round4(tree_block * rows);
  s.scores = o;
  o += round4(rows * C);
  s.extra = o;
  o += round4(extra_words);
  s.words = o;
  return s;
}

// ---- cp.async ----------------------------------------------------------------

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The word of a 16-byte-aligned buffer at which a copy of `src` lands: the
// source's phase modulo 16 bytes, so 16-byte copies are aligned at both ends.
__device__ __forceinline__ uint32_t* at_phase(uint32_t* buf, const void* src) {
  return buf + ((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

// `count` 4-byte words from global `src` into at_phase(buf, src), by the
// whole block.
__device__ __forceinline__ void stage_async(uint32_t* buf, const void* src_, int count) {
  const uint32_t* src = static_cast<const uint32_t*>(src_);
  uint32_t* dst = at_phase(buf, src);
  const int head =
      min(count, static_cast<int>((4 - ((reinterpret_cast<uintptr_t>(src) >> 2) & 3)) & 3));
  const int body = (count - head) >> 2;
  for (int i = threadIdx.x; i < head; i += kThreads) cp_async4(dst + i, src + i);
  for (int i = threadIdx.x; i < body; i += kThreads)
    cp_async16(dst + head + 4 * i, src + head + 4 * i);
  for (int i = head + 4 * body + threadIdx.x; i < count; i += kThreads) cp_async4(dst + i, src + i);
}

// Tree block b of the decoded model: shared-memory copies or global memory.
struct TreeBlock {
  const float* thr;
  const uint16_t* ref;
  const float* leaves;
};

__device__ __forceinline__ TreeBlock global_tree_block(const Decoded& m, int L, int tree_block,
                                                       int b) {
  const int64_t e = static_cast<int64_t>(b) * tree_block * L;
  return TreeBlock{m.node_thr + e, m.node_ref + e, m.leaf_val + e};
}

// Starts the copy of tree block b into buffer buf (one commit group).
__device__ __forceinline__ void issue_tree_block(const Args& a, const Decoded& m, const Layout& lay,
                                                 uint32_t* smem, int tree_block, int b, int buf) {
  const int L = a.I + 1;
  const int entries = min(tree_block, a.T - b * tree_block) * L;  // L even: whole words of ref
  const TreeBlock g = global_tree_block(m, L, tree_block, b);
  uint32_t* base = smem + lay.trees + buf * lay.tree_stride;
  stage_async(base, g.thr, entries);
  stage_async(base + lay.leaf_in_tree, g.leaves, entries);
  stage_async(base + lay.ref_in_tree, g.ref, entries / 2);
  cp_async_commit();
}

__device__ __forceinline__ TreeBlock staged_tree_block(const Args& a, const Decoded& m,
                                                       const Layout& lay, uint32_t* smem,
                                                       int tree_block, int b, int buf) {
  const TreeBlock g = global_tree_block(m, a.I + 1, tree_block, b);
  uint32_t* base = smem + lay.trees + buf * lay.tree_stride;
  return TreeBlock{reinterpret_cast<const float*>(at_phase(base, g.thr)),
                   reinterpret_cast<const uint16_t*>(at_phase(base + lay.ref_in_tree, g.ref)),
                   reinterpret_cast<const float*>(at_phase(base + lay.leaf_in_tree, g.leaves))};
}

// Waits for tree block b (staged: first issuing the copy of block `next`,
// -1 for none, into the other buffer) and synchronises the thread block.
template <bool kTrees>
__device__ __forceinline__ TreeBlock take_tree_block(const Args& a, const Decoded& m,
                                                     const Layout& lay, uint32_t* smem,
                                                     int tree_block, int b, int buf, int next) {
  if constexpr (kTrees) {
    if (next >= 0) {
      issue_tree_block(a, m, lay, smem, tree_block, next, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // block b staged; the last walk and sums are done
    return staged_tree_block(a, m, lay, smem, tree_block, b, buf);
  } else {
    __syncthreads();  // the last walk and sums are done
    return global_tree_block(m, a.I + 1, tree_block, b);
  }
}

// xs[j][r] = x[row0 + r, used_features[j]], xs[n_fu][r] = -inf: a warp a
// feature, lanes along the rows (rows past the tile's last read 0).
__device__ __forceinline__ void stage_x(const Args& a, float* xs, int64_t row0, int nrows,
                                        int rows) {
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j <= a.n_fu; j += kWarps) {
    float* dst = xs + j * rows;
    if (j == a.n_fu) {
      for (int r = lane; r < rows; r += 32) dst[r] = -INFINITY;
      continue;
    }
    const float* col = a.x + row0 * a.d + __ldg(a.used_features + j);
#pragma unroll 4
    for (int r = lane; r < rows; r += 32)
      dst[r] = r < nrows ? __ldg(col + static_cast<int64_t>(r) * a.d) : 0.0f;
  }
}

template <bool kShared, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// ---- the walk --------------------------------------------------------------------

// Walks the cnt trees of tree block `blk` for the `nslots` row slots of the
// tile and leaves vals[k * rows + slot] = the leaf value tree k of the block
// gives the slot's row.  A slot is tile row `slot`, or slot_row[slot] when
// the kernel keeps a list of live rows.  Slots past nslots read the last
// slot's row and write nothing.
template <bool kX, bool kTrees>
__device__ __forceinline__ void walk(const Args& a, const float* xs, const TreeBlock& blk,
                                     int cnt, const int32_t* slot_row, int nslots, int64_t row0,
                                     int rows, float* vals) {
  const int lane = threadIdx.x & 31;
  const int groups = (nslots + 31) >> 5;
  const int ntasks = cnt * groups;
  const int I = a.I;
  const int L = I + 1;
  const uint32_t n_fu = static_cast<uint32_t>(a.n_fu);
  for (int first = threadIdx.x >> 5; first < ntasks; first += kWarps * kWalks) {
    int k[kWalks], slot[kWalks], r[kWalks], idx[kWalks];
    bool ok[kWalks];
#pragma unroll
    for (int j = 0; j < kWalks; ++j) {
      const int t = first + j * kWarps;
      ok[j] = t < ntasks;  // the same for the whole warp
      k[j] = ok[j] ? t / groups : 0;
      slot[j] = (t - k[j] * groups) * 32 + lane;
      const int s = min(slot[j], nslots - 1);
      r[j] = slot_row ? slot_row[s] : s;
      idx[j] = 0;
    }
    for (int s = 0; s < a.max_depth; ++s) {
#pragma unroll
      for (int j = 0; j < kWalks; ++j) {
        if (!ok[j]) continue;
        const int node = k[j] * L + idx[j];
        const float thr = ld<kTrees>(blk.thr + node);
        const uint32_t ref = ld<kTrees>(blk.ref + node);
        float xv;
        if constexpr (kX) {
          xv = xs[ref * rows + r[j]];
        } else {
          xv = ref < n_fu ? __ldg(a.x + (row0 + r[j]) * a.d + __ldg(a.used_features + ref))
                          : -INFINITY;
        }
        idx[j] = 2 * idx[j] + 1 + !(xv <= thr);
      }
    }
#pragma unroll
    for (int j = 0; j < kWalks; ++j) {
      if (!ok[j]) continue;
      const float v = ld<kTrees>(blk.leaves + k[j] * L + (idx[j] - I));
      if (slot[j] < nslots) vals[k[j] * rows + slot[j]] = v;
    }
  }
}

}  // namespace toad
