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
// lower bound of x, which a binary search finds in ceil(log2(E + 1))
// steps: 8 for E = 255.  An +inf edge is never below any x, so padding
// never counts.  NaN compares false everywhere, so the search would give
// 0: it is set to E, the bin apply_bins (jnp/torch searchsorted) gives it,
// which is what fit and predict_raw use.  The JAX package's Pallas kernel
// itself returns 0 for NaN; the port follows apply_bins.  Built without
// fast math: the compares must stay IEEE.
//
// Design (simple and right first):
//   * grid (row tiles of kRows rows) x (feature chunks of up to
//     kFeatures features); 256 threads a block;
//   * each block stages its chunk's edge rows in dynamic shared memory
//     (64 features x 255 edges x 4 B = 65,280 B at full width), read once
//     per block from L2; where a chunk's rows do not fit under
//     kStageLimitBytes the search reads them from global memory instead;
//   * the block's (row, feature) elements are numbered row-major and dealt
//     to threads in turn, the feature fastest, so neighbouring threads load
//     neighbouring x and store neighbouring bins (coalesced);
//   * no atomics, no scratch: every output element is written once.
//
// What bounds it on this card: bytes.  Each x read once and each bin
// written once, n * d * (4 + 4) B, plus the edge table once, d * E * 4 B
// (8,590,195,712 B at n = 2^22, d = 256, E = 255: 2.564 ms at 3.35 TB/s);
// the ~8 compares an element are far below the card's compare rate.  The
// edge staging adds d * E * 4 B of L2 reads per row tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFeatures = 64;    // features a block bins (one staged chunk)
constexpr int kRows = 2048;      // rows a block bins
constexpr size_t kStageLimitBytes = 96 * 1024;

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) binning_kernel(
    const float* __restrict__ x, const float* __restrict__ edges,
    int32_t* __restrict__ out, long long n, int d, int E, int fb) {
  const int f0 = blockIdx.y * fb;
  const int nf = min(fb, d - f0);
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const int nr = static_cast<int>(min(static_cast<long long>(kRows), n - r0));
  const float* e = edges + static_cast<long long>(f0) * E;
  if constexpr (kStaged) {
    extern __shared__ float s_edges[];
    const int total = nf * E;
    for (int i = threadIdx.x; i < total; i += blockDim.x) s_edges[i] = e[i];
    __syncthreads();
    e = s_edges;
  }
  const int count = nr * nf;
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    const int r = k / nf;
    const int f = k - r * nf;
    const long long at = (r0 + r) * d + f0 + f;
    const float v = x[at];
    const float* row = e + f * E;
    int lo = 0;
    int hi = E;
    while (lo < hi) {  // lower bound: the first edge not below v
      const int mid = (lo + hi) >> 1;
      if (row[mid] < v) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    out[at] = (v != v) ? E : lo;
  }
}

}  // namespace

// Launches on `stream`, does not synchronise and allocates nothing; returns
// the first CUDA error of the launch (0 when it was accepted).  The caller
// guarantees n >= 1, d >= 1 and E >= 1.
extern "C" int toad_binning(const void* x, const void* edges, void* out,
                            long long n, int d, int E, void* stream) {
  const int fb = d < kFeatures ? d : kFeatures;
  const dim3 grid(static_cast<unsigned>((n + kRows - 1) / kRows),
                  static_cast<unsigned>((d + fb - 1) / fb));
  const size_t staged = sizeof(float) * static_cast<size_t>(fb) * E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* ep = static_cast<const float*>(edges);
  int32_t* op = static_cast<int32_t*>(out);
  if (staged <= kStageLimitBytes) {
    const cudaError_t set = cudaFuncSetAttribute(
        binning_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(staged));
    if (set != cudaSuccess) return static_cast<int>(set);
    binning_kernel<true><<<grid, kThreads, staged, s>>>(xp, ep, op, n, d, E, fb);
  } else {
    binning_kernel<false><<<grid, kThreads, 0, s>>>(xp, ep, op, n, d, E, fb);
  }
  return static_cast<int>(cudaGetLastError());
}
