// K2: exact kNN ids in (distance, index) order, their fp32 distances, and
// optionally the int8 0/1 indicator, for Hopper.
//
// Replaces the TPU kernel epcnet_tpu/ops/knn.py::_knn_kernel (knn.py:151-207),
// launched at knn.py:287 through knn_pallas (:300) / knn(impl="pallas")
// (:486), and with the indicator through knn_with_adjacency_pallas(with_idx=
// True) (:478).
//
// What it computes, per cloud b and query row i (N points, 1 <= k <= N):
//   ids[b, i, r]   = the rank-r winner (ascending fp32 distance, then
//                    ascending index; self included), int32;
//   dists[b, i, r] = its squared distance, bit-equal to the plain version;
//   adj[b, i, j]   = 1 for the k winners, 0 elsewhere (int8), when asked.
//
// Bound on this card: the distance arithmetic, 8 fp32 instructions a pair
// (no FMA: -fmad=false keeps them bit-equal) at 132 SMs x 128 lanes x
// 1.98 GHz = 33.4e12 a second: 1.03 ms a cloud at N=65536, 4.11 ms at
// N=131072. The ids and distances written are N*k*8 bytes (10.5 MB at
// N=65536, 3 us).
//
// Two kernels; knn_ids_launch picks one by k, the one place the rule lives:
//   k <= knn_tile::kMaxK (32; the model's k is 20): knn_tile.cuh's tiled
//     core (its shorter list for k <= knn_tile::kShortK). A block's merged
//     lists lie in shared memory as [rows][k], which is the layout of the
//     block's stretch of ids and dists, so every thread stores a contiguous,
//     coalesced run. The indicator rows are zeroed with 16-byte stores, then
//     the k ones of each row are set.
//   k > kMaxK: knn_core.cuh's warp-per-row value rounds (the round r yields
//     rank r; lane r % 32 keeps it and the warp stores 32 ranks at once).
// Every index into an output is 64-bit.

#include "knn_core.cuh"
#include "knn_tile.cuh"

namespace {

using namespace knn_core;
namespace kt = knn_tile;

template <int S, int L>
__global__ void __launch_bounds__(kt::kThreads, 2)
    knn_ids_tiled_kernel(const float* __restrict__ x, int n, int k,
                         int32_t* __restrict__ ids, float* __restrict__ dists,
                         int8_t* __restrict__ adj) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kt::rows_per_block(S);
  float* od;
  int* oj;
  kt::select_rows<S, L>(x + static_cast<size_t>(b) * n * 3, n, k, row0, smem, od, oj);

  const int rows = min(kt::rows_per_block(S), n - row0);
  const size_t e0 = (static_cast<size_t>(b) * n + row0) * k;
  for (int e = threadIdx.x; e < rows * k; e += kt::kThreads) {
    ids[e0 + e] = oj[e];
    if (dists != nullptr) dists[e0 + e] = od[e];
  }
  if (adj != nullptr) {
    int8_t* a = adj + (static_cast<size_t>(b) * n + row0) * n;
    kt::zero_bytes(a, static_cast<size_t>(rows) * n, threadIdx.x, kt::kThreads);
    __syncthreads();  // the zeros land before the ones
    for (int e = threadIdx.x; e < rows * k; e += kt::kThreads)
      a[static_cast<size_t>(e / k) * n + oj[e]] = 1;
  }
}

template <int S, int L>
cudaError_t launch_tiled(const float* x, int b, int n, int k, int32_t* ids, float* dists,
                         int8_t* adj, cudaStream_t stream) {
  const size_t smem = kt::smem_bytes(S, k);
  cudaError_t err = cudaFuncSetAttribute(
      knn_ids_tiled_kernel<S, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kt::rows_per_block(S) - 1) / kt::rows_per_block(S), b);
  knn_ids_tiled_kernel<S, L><<<grid, kt::kThreads, smem, stream>>>(x, n, k, ids, dists, adj);
  return cudaGetLastError();
}

template <bool kSmem, bool kAdj>
__global__ void knn_ids_rounds_kernel(const float* __restrict__ x, int n, int k,
                                      int32_t* __restrict__ ids, float* __restrict__ dists,
                                      int8_t* __restrict__ adj, size_t mask_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int row = blockIdx.x * warps + warp;
  const int words = (n + 31) >> 5;

  uint32_t* mask = reinterpret_cast<uint32_t*>(smem) + warp * (words + 1);
  const int stride = kSmem ? pad_stride(n) : 0;
  const float* xs = stage_xyz<kSmem>(x + static_cast<size_t>(b) * n * 3, n,
                                     reinterpret_cast<float*>(smem + mask_bytes), stride);
  __syncthreads();  // the only block-wide barrier: rows past N leave after it
  if (row >= n) return;

  if constexpr (kAdj) clear_mask(mask, words, lane);
  const size_t r0 = static_cast<size_t>(b) * n + row;
  int32_t* irow = ids + r0 * k;
  float* drow = dists == nullptr ? nullptr : dists + r0 * k;
  int my_j = 0;
  float my_d = 0.f;
  select_k<kSmem>(xs, stride, n, k, row, lane, [&](int r, float wd, int wj) {
    if constexpr (kAdj) {
      if (lane == 0) mask[wj >> 5] |= 1u << (wj & 31);
    }
    if (lane == (r & 31)) {
      my_j = wj;
      my_d = wd;
    }
    if ((r & 31) == 31 || r == k - 1) {  // ranks [r & ~31, r] are held
      const int rank = (r & ~31) + lane;
      if (rank <= r) {
        irow[rank] = my_j;
        if (drow != nullptr) drow[rank] = my_d;
      }
    }
  });
  if constexpr (kAdj) {
    __syncwarp();  // lane 0's mask writes are visible to the whole warp
    write_dense_row(mask, n, adj + r0 * n, lane);
  }
}

template <bool kSmem, bool kAdj>
cudaError_t launch_rounds(const float* x, int b, int n, int k, int32_t* ids, float* dists,
                          int8_t* adj, const Plan& plan, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      knn_ids_rounds_kernel<kSmem, kAdj>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(plan.smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + plan.warps - 1) / plan.warps, b);
  knn_ids_rounds_kernel<kSmem, kAdj><<<grid, plan.warps * 32, plan.smem, stream>>>(
      x, n, k, ids, dists, adj, plan.mask_bytes);
  return cudaGetLastError();
}

}  // namespace

// x: [B, N, 3] fp32 contiguous, 1 <= k <= N; ids: [B, N, k] int32; dists:
// [B, N, k] fp32 or NULL; adj: [B, N, N] int8 or NULL for no indicator.
// k <= knn_tile::kMaxK runs the tiled core, a larger k the value rounds;
// *tiled (if not NULL) is set to 1 for the former, 0 for the latter.
//
// split is the tiled core's S, the threads a row (1, 2, 4 or 8), or 0 for
// knn_tile::choose_split's; an S with k > kMaxK is refused. The wrappers
// pass 0. A forced S is what lets chip_smoke.py hold every instantiation
// against the plain version and time each S beside the rule's choice, the
// standing evidence for choose_split.
//
// Launches on `stream`, does not synchronise. Returns the launch's
// cudaError_t (0 = ok).
extern "C" int knn_ids_launch(const float* x, int b, int n, int k, int32_t* ids,
                              float* dists, int8_t* adj, int split, int* tiled,
                              void* stream) {
  if (b < 1 || b > 65535 || n < 1 || k < 1 || k > n) return cudaErrorInvalidValue;
  const bool use_tiled = k <= kt::kMaxK;
  if (tiled != nullptr) *tiled = use_tiled;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!use_tiled) {
    Plan plan;
    const size_t mask_words = adj ? static_cast<size_t>((n + 31) / 32) + 1 : 0;
    if (split != 0 || !make_plan(n, mask_words, &plan)) return cudaErrorInvalidValue;
    if (adj) {
      if (plan.in_smem) return launch_rounds<true, true>(x, b, n, k, ids, dists, adj, plan, s);
      return launch_rounds<false, true>(x, b, n, k, ids, dists, adj, plan, s);
    }
    if (plan.in_smem) return launch_rounds<true, false>(x, b, n, k, ids, dists, adj, plan, s);
    return launch_rounds<false, false>(x, b, n, k, ids, dists, adj, plan, s);
  }
  return kt::dispatch(split, b, n, k, [&](auto sp, auto len) {
    return launch_tiled<decltype(sp)::value, decltype(len)::value>(x, b, n, k, ids, dists,
                                                                  adj, s);
  });
}
