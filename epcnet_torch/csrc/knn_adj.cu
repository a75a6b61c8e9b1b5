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
//   adj[b, i, j] = 1 for the k winners (the k smallest (d[i, j], j), self
//             included, ties to the lowest index);
//   proxy[b, i, c] = (sum over the k winners, in ascending j, of x[b, j, c]
//             rounded to the compute dtype, summed in fp32) * float(1/k),
//             cast to the compute dtype (bf16 or fp32).
//
// Bound on this card (fp32 at 33.4e12 non-fused instructions a second: 132
// SMs x 128 lanes x 1.98 GHz; -fmad=false keeps distances bit-equal, so no
// FMA counts double). K1: the indicator write is N^2 bytes per cloud — 16.8
// MB at N=4096, about 5.0 us per cloud at 3.35 TB/s; the distance arithmetic
// (8 fp32 instructions a pair) is 4.0 us per cloud. K3: the plane write is
// N^2/8 bytes per cloud, so the arithmetic bounds it — 0.26 ms per cloud at
// N=32768 (the planes are 134 MB, 40 us).
//
// For k <= knn_tile::kMaxK (32; the model's k is 20) K1, K1' and K3 run on
// knn_tile.cuh's tiled core, which leaves a block's rows' k winners in
// shared memory; the epilogue differs by form:
//   K1: the block's rows are contiguous, rows x N bytes: it zeroes them with
//       16-byte stores, then, after a barrier, each winner stores its byte 1.
//   K3: the block zeroes its rows' planes the same way; then each winner ORs
//       the plane bits of every winner of its row that falls in its word (two
//       winners can share a word) and stores the word, so a shared word is
//       written whole, with the same value, by each of its winners.
// The proxy (write_proxy_rows, one helper for both forms) walks each row's k
// winners in ascending column order (k passes over k), reading their
// coordinates from the input, and sums as the value rounds' write_proxy
// does, so every proxy of the three paths is bit-equal.
//
// For k > kMaxK, K1 and K3 run knn_core.cuh's warp-per-row value rounds,
// which mark each winner in a per-warp bitmask in shared memory; the row is
// then written from the bitmask (K1: 16-byte stores of 0/1 bytes; K3: each
// lane gathers the 32 plane bits of its words), and the proxy walks the
// bitmask in ascending column order. At N above about 18,500 xyz is read
// from global memory.

#include "knn_core.cuh"
#include "knn_tile.cuh"

namespace {

using namespace knn_core;
namespace kt = knn_tile;

// The proxy of the block's rows row0 .. row0 + rows - 1 of cloud b from their
// k winners oj [rows][k]: each row's winners in ascending column order,
// coordinates rounded to the compute dtype, summed in fp32, times inv_k.
__device__ __forceinline__ void write_proxy_rows(const float* __restrict__ xb, const int* oj,
                                                 int rows, int k, void* proxy, size_t r0,
                                                 int proxy_bf16, float inv_k) {
  for (int r = threadIdx.x; r < rows; r += kt::kThreads) {
    const int* rj = oj + r * k;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    int last = -1;
    for (int t = 0; t < k; ++t) {  // the winners in ascending column order
      int j = INT_MAX;
      for (int i = 0; i < k; ++i)
        if (rj[i] > last && rj[i] < j) j = rj[i];
      last = j;
      s0 = __fadd_rn(s0, to_compute(__ldg(xb + 3 * j), proxy_bf16));
      s1 = __fadd_rn(s1, to_compute(__ldg(xb + 3 * j + 1), proxy_bf16));
      s2 = __fadd_rn(s2, to_compute(__ldg(xb + 3 * j + 2), proxy_bf16));
    }
    store_proxy(proxy, (r0 + r) * 3, proxy_bf16, inv_k, s0, s1, s2);
  }
}

// K1 / K1' on the tiled core: adj [B, N, N] int8.
template <int S, int L>
__global__ void __launch_bounds__(kt::kThreads, 2)
    knn_dense_tiled_kernel(const float* __restrict__ x, int n, int k, void* adj,
                           void* proxy, int proxy_bf16, float inv_k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kt::rows_per_block(S);
  const float* xb = x + static_cast<size_t>(b) * n * 3;
  float* od;
  int* oj;
  kt::select_rows<S, L>(xb, n, k, row0, smem, od, oj);

  const int rows = min(kt::rows_per_block(S), n - row0);
  const size_t r0 = static_cast<size_t>(b) * n + row0;
  int8_t* a = static_cast<int8_t*>(adj) + r0 * n;
  kt::zero_bytes(a, static_cast<size_t>(rows) * n, threadIdx.x, kt::kThreads);
  __syncthreads();  // the zeros land before the ones
  for (int e = threadIdx.x; e < rows * k; e += kt::kThreads)
    a[static_cast<size_t>(e / k) * n + oj[e]] = 1;
  if (proxy != nullptr) write_proxy_rows(xb, oj, rows, k, proxy, r0, proxy_bf16, inv_k);
}

// K3 on the tiled core: adj [B, N, N/32] int32 bit planes.
template <int S, int L>
__global__ void __launch_bounds__(kt::kThreads, 2)
    knn_packed_tiled_kernel(const float* __restrict__ x, int n, int k, void* adj,
                            void* proxy, int proxy_bf16, float inv_k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kt::rows_per_block(S);
  const float* xb = x + static_cast<size_t>(b) * n * 3;
  float* od;
  int* oj;
  kt::select_rows<S, L>(xb, n, k, row0, smem, od, oj);

  const int rows = min(kt::rows_per_block(S), n - row0);
  const int w_words = n >> 5;
  int* key = reinterpret_cast<int*>(od);  // each winner's word * 32 + plane
  for (int e = threadIdx.x; e < rows * k; e += kt::kThreads) {
    const int plane = oj[e] / w_words;
    key[e] = (oj[e] - plane * w_words) * 32 + plane;
  }
  const size_t r0 = static_cast<size_t>(b) * n + row0;
  uint32_t* p = static_cast<uint32_t*>(adj) + r0 * w_words;
  kt::zero_bytes(p, static_cast<size_t>(rows) * w_words * 4, threadIdx.x, kt::kThreads);
  __syncthreads();  // the keys are in place and the zeros land before the words
  for (int e = threadIdx.x; e < rows * k; e += kt::kThreads) {
    const int* rk = key + (e / k) * k;
    const int w = key[e] >> 5;
    uint32_t word = 0u;
    for (int i = 0; i < k; ++i)
      if ((rk[i] >> 5) == w) word |= 1u << (rk[i] & 31);
    p[static_cast<size_t>(e / k) * w_words + w] = word;
  }
  if (proxy != nullptr) write_proxy_rows(xb, oj, rows, k, proxy, r0, proxy_bf16, inv_k);
}

template <class Kernel>
cudaError_t launch_tiled(Kernel kernel, int s, const float* x, int b, int n, int k, void* adj,
                         void* proxy, int proxy_bf16, float inv_k, cudaStream_t stream) {
  const size_t smem = kt::smem_bytes(s, k);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kt::rows_per_block(s) - 1) / kt::rows_per_block(s), b);
  kernel<<<grid, kt::kThreads, smem, stream>>>(x, n, k, adj, proxy, proxy_bf16, inv_k);
  return cudaGetLastError();
}

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

// x: [B, N, 3] fp32 contiguous, 1 <= k <= N; adj: [B, N, N] int8 (pack = 0,
// K1) or [B, N, N/32] int32 (pack = 1, K3; N % 32 == 0); proxy: [B, N, 3] in
// bf16 (proxy_bf16 = 1) or fp32, or NULL for the indicator alone.
//
// The core is picked here, the one place the rule lives: k <= knn_tile::kMaxK
// runs the tiled core (on its shorter list for k <= knn_tile::kShortK), a
// larger k the value rounds; *tiled (if not NULL) is set to 1 for the
// former, 0 for the latter. split is the tiled core's S, the threads a row
// (1, 2, 4 or 8), or 0 for knn_tile::choose_split's; an S where the value
// rounds run is refused. The wrappers pass 0; a forced S lets chip_smoke.py
// check every instantiation and time each S beside the rule's choice (the
// evidence for choose_split).
//
// Launches on `stream`, does not synchronise. Returns the launch's
// cudaError_t (0 = ok).
extern "C" int knn_adj_launch(const float* x, int b, int n, int k, void* adj,
                              void* proxy, int proxy_bf16, float inv_k, int pack,
                              int split, int* tiled, void* stream) {
  if (b < 1 || b > 65535 || n < 1 || k < 1 || k > n || (pack && n % 32 != 0))
    return cudaErrorInvalidValue;
  const bool use_tiled = k <= kt::kMaxK;
  if (tiled != nullptr) *tiled = use_tiled;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_tiled) {
    return kt::dispatch(split, b, n, k, [&](auto sp, auto len) {
      constexpr int S = decltype(sp)::value, L = decltype(len)::value;
      if (pack)
        return launch_tiled(knn_packed_tiled_kernel<S, L>, S, x, b, n, k, adj, proxy,
                            proxy_bf16, inv_k, s);
      return launch_tiled(knn_dense_tiled_kernel<S, L>, S, x, b, n, k, adj, proxy,
                          proxy_bf16, inv_k, s);
    });
  }
  Plan plan;
  if (split != 0 || !make_plan(n, static_cast<size_t>((n + 31) / 32) + 1, &plan))
    return cudaErrorInvalidValue;
  if (pack) {
    if (plan.in_smem)
      return launch<true, true>(x, b, n, k, adj, proxy, proxy_bf16, inv_k, plan, s);
    return launch<false, true>(x, b, n, k, adj, proxy, proxy_bf16, inv_k, plan, s);
  }
  if (plan.in_smem)
    return launch<true, false>(x, b, n, k, adj, proxy, proxy_bf16, inv_k, plan, s);
  return launch<false, false>(x, b, n, k, adj, proxy, proxy_bf16, inv_k, plan, s);
}
