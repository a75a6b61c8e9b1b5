// K2: exact kNN ids in (distance, index) order, their fp32 distances, and
// optionally the int8 0/1 indicator, for Hopper.
//
// Replaces the TPU kernel epcnet_tpu/ops/knn.py::_knn_kernel (knn.py:151-207),
// launched at knn.py:287 through knn_pallas (:300) / knn(impl="pallas")
// (:486), and with the indicator through knn_with_adjacency_pallas(with_idx=
// True) (:478).
//
// What it computes, per cloud b and query row i (N points, 1 <= k <= N):
//   ids[b, i, r]   = the rank-r winner of knn_core.cuh (ascending fp32
//                    distance, then ascending index; self included), int32;
//   dists[b, i, r] = its squared distance, bit-equal to the plain version;
//   adj[b, i, j]   = 1 for the k winners, 0 elsewhere (int8), when asked.
//
// Bound on this card: the distance arithmetic, 8 fp32 operations per pair —
// 0.51 ms per cloud at N=65536 and 2.05 ms at N=131072 at 67 TFLOP/s; the
// ids and distances written are N*k*8 bytes (10.5 MB at N=65536, 3 us).
//
// Design (simple and exact first): the selection core's round r already
// yields rank r, so lane r % 32 keeps the winner in a register and the warp
// writes each 32 ranks with one coalesced store. Without the indicator no
// bitmask exists: shared memory holds xyz alone, and at N above about 18,900
// (every launch of the gather route) xyz is read from global memory. With
// the indicator each warp keeps K1's bitmask (16 KB at N=131072, so the plan
// halves the warps to fit) and writes the row as K1 does. Every index into
// an output is 64-bit.

#include "knn_core.cuh"

namespace {

using namespace knn_core;

template <bool kSmem, bool kAdj>
__global__ void knn_ids_kernel(const float* __restrict__ x, int n, int k,
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
cudaError_t launch(const float* x, int b, int n, int k, int32_t* ids, float* dists,
                   int8_t* adj, const Plan& plan, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      knn_ids_kernel<kSmem, kAdj>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(plan.smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + plan.warps - 1) / plan.warps, b);
  knn_ids_kernel<kSmem, kAdj><<<grid, plan.warps * 32, plan.smem, stream>>>(
      x, n, k, ids, dists, adj, plan.mask_bytes);
  return cudaGetLastError();
}

}  // namespace

// x: [B, N, 3] fp32 contiguous; ids: [B, N, k] int32; dists: [B, N, k] fp32
// or NULL; adj: [B, N, N] int8 or NULL for no indicator. Launches on
// `stream`, does not synchronise. Returns the launch's cudaError_t (0 = ok).
extern "C" int knn_ids_launch(const float* x, int b, int n, int k, int32_t* ids,
                              float* dists, int8_t* adj, void* stream) {
  Plan plan;
  const size_t mask_words = adj ? static_cast<size_t>((n + 31) / 32) + 1 : 0;
  if (b < 1 || b > 65535 || n < 1 || k < 1 || k > n || !make_plan(n, mask_words, &plan))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (adj) {
    if (plan.in_smem) return launch<true, true>(x, b, n, k, ids, dists, adj, plan, s);
    return launch<false, true>(x, b, n, k, ids, dists, adj, plan, s);
  }
  if (plan.in_smem) return launch<true, false>(x, b, n, k, ids, dists, adj, plan, s);
  return launch<false, false>(x, b, n, k, ids, dists, adj, plan, s);
}
