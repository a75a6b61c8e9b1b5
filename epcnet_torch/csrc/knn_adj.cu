// K1 and K3: exact kNN 0/1 indicator adjacency + layer-0 proxy point, for
// Hopper.
//
// Replaces the TPU kernel epcnet_tpu/ops/knn.py::_knn_adj_only_kernel:
//   K1  dense form, launched at epcnet_tpu/ops/knn.py:255 (and :247 without
//       the proxy, K1'): adj [B, N, N] int8;
//   K3  pack=True form (knn.py:119-129): the same indicator as int32 bit
//       planes [B, N, N/32], bit j of word w = column j*W + w (W = N/32), the
//       layout of epcnet_tpu/ops/adjacency.py; plane 31 is the sign bit.
//
// What it computes, per cloud b and query row i (N points, 1 <= k <= N):
//   adj[b, i, j] = 1 for the k winners of knn_core.cuh (the k smallest
//             (d[i, j], j), self included, ties to the lowest index);
//   proxy[b, i, c] = (sum over the k winners, in ascending j, of x[b, j, c]
//             rounded to the compute dtype, summed in fp32) * float(1/k),
//             cast to the compute dtype (bf16 or fp32).
//
// Bound on this card. K1: the indicator write is N^2 bytes per cloud — 16.8 MB
// at N=4096, about 5.0 us per cloud at 3.35 TB/s; the distance arithmetic
// (8 fp32 operations per pair) is 2.0 us per cloud at 67 TFLOP/s. K3: the
// plane write is N^2/8 bytes per cloud, so the arithmetic bounds it — 0.13 ms
// per cloud at N=32768 (the planes are 134 MB, 40 us).
//
// Design (simple and exact first; nothing here works toward that bound yet):
// the selection core of knn_core.cuh marks each winner in a per-warp bitmask
// in shared memory; the row is then written from the bitmask (K1: 16-byte
// stores of 0/1 bytes; K3: each lane gathers the 32 plane bits of its words),
// and the proxy walks the bitmask in ascending column order. At N above about
// 18,500 xyz is read from global memory. Faster designs (a per-lane register
// top-k, a threshold select, fewer global bytes) are later work.

#include "knn_core.cuh"

namespace {

using namespace knn_core;

template <bool kSmem, bool kPack>
__global__ void knn_adj_kernel(const float* __restrict__ x, int n, int k,
                               void* __restrict__ adj, void* proxy, int proxy_bf16,
                               float inv_k, size_t mask_bytes) {
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

  clear_mask(mask, words, lane);
  select_k<kSmem>(xs, stride, n, k, row, lane, [&](int, float, int wj) {
    if (lane == 0) mask[wj >> 5] |= 1u << (wj & 31);
  });
  __syncwarp();  // lane 0's mask writes are visible to the whole warp

  const size_t r = static_cast<size_t>(b) * n + row;
  if constexpr (kPack) {
    const int w_words = n >> 5;
    write_packed_row(mask, w_words, static_cast<uint32_t*>(adj) + r * w_words, lane);
  } else {
    write_dense_row(mask, n, static_cast<int8_t*>(adj) + r * n, lane);
  }
  if (proxy != nullptr)
    write_proxy<kSmem>(mask, words, xs, stride, lane, proxy, r * 3, proxy_bf16, inv_k);
}

template <bool kSmem, bool kPack>
cudaError_t launch(const float* x, int b, int n, int k, void* adj, void* proxy,
                   int proxy_bf16, float inv_k, const Plan& plan, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      knn_adj_kernel<kSmem, kPack>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(plan.smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + plan.warps - 1) / plan.warps, b);
  knn_adj_kernel<kSmem, kPack><<<grid, plan.warps * 32, plan.smem, stream>>>(
      x, n, k, adj, proxy, proxy_bf16, inv_k, plan.mask_bytes);
  return cudaGetLastError();
}

}  // namespace

// x: [B, N, 3] fp32 contiguous; adj: [B, N, N] int8 (pack = 0, K1) or
// [B, N, N/32] int32 (pack = 1, K3; N % 32 == 0); proxy: [B, N, 3] in bf16
// (proxy_bf16 = 1) or fp32, or NULL for the indicator alone. Launches on
// `stream`, does not synchronise. Returns the launch's cudaError_t (0 = ok).
extern "C" int knn_adj_launch(const float* x, int b, int n, int k, void* adj,
                              void* proxy, int proxy_bf16, float inv_k, int pack,
                              void* stream) {
  Plan plan;
  if (b < 1 || b > 65535 || n < 1 || k < 1 || k > n || (pack && n % 32 != 0) ||
      !make_plan(n, static_cast<size_t>((n + 31) / 32) + 1, &plan))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pack) {
    if (plan.in_smem)
      return launch<true, true>(x, b, n, k, adj, proxy, proxy_bf16, inv_k, plan, s);
    return launch<false, true>(x, b, n, k, adj, proxy, proxy_bf16, inv_k, plan, s);
  }
  if (plan.in_smem)
    return launch<true, false>(x, b, n, k, adj, proxy, proxy_bf16, inv_k, plan, s);
  return launch<false, false>(x, b, n, k, adj, proxy, proxy_bf16, inv_k, plan, s);
}
