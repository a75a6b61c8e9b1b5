// K6: the kNN 0/1 indicator adjacency with a software-pipelined distance
// row, for the K6-against-K1 comparison of the kNN trace
// (epcnet_torch/scripts/knn_trace.py), for Hopper.
//
// Replaces the TPU kernel scripts/hw_knn_trace.py::_kern_pipelined
// (launched at :195): K1 with two distance-slab scratch buffers, tile t's
// slab computed while tile t-1's selection runs from the other buffer.
//
// What it computes, per cloud b and query row i (N points, 1 <= k <= N):
//   adj[b, i, j] = K1's indicator (knn_adj.cu): 1 for the k smallest
//             (d[i, j], j), self included, ties to the lowest index, as int8;
//   proxy[b, i, c] = (sum over the k winners, nearest first, of x[b, j, c]
//             rounded to bf16, summed in fp32) * float(1/k), stored in fp32.
//             This is the TPU variant's proxy (an fp32 product of bf16
//             operands), not K1's bf16 proxy.
//
// Bound on this card: bytes, as K1's. The indicator is N^2 bytes a cloud:
// 16.8 MB at N=4096, about 5.0 us at 3.35 TB/s; the distance arithmetic
// (8 fp32 instructions a pair, no FMA) is 4.0 us at 33.4e12 a second.
//
// Design: what the TPU variant tried, overlapping the production of
// distances with the selection that consumes them, carried over to a block
// instead of the TPU's sequential grid. Warps come in pairs, a producer and
// a consumer; each pair owns two distance-row buffers in shared memory and
// one named barrier (bar.sync 1 + pair, 64 threads). The pair walks its
// rows, first = block * pairs + pair, then every gridDim.x * pairs rows. In
// step t the producer writes row t+1's distances into one buffer while the
// consumer selects row t from the other; then both meet at the barrier, so
// a buffer is rewritten only after its row was consumed. The consumer runs
// the core's selection (knn_core.cuh: each lane's best (d, j), k warp
// arg-min rounds, the winning lane refilled by a cooperative rescan) on the
// stored row instead of recomputing distances, marks a bitmask, writes the
// indicator row from it (knn_core's write_dense_row) and sums the proxy as
// the winners come. Rows are stored with one pad slot per 32 columns
// (pad_idx), so the scan and the refill are free of bank conflicts. xyz is
// in shared memory when it fits beside one pair's buffers, else read from
// global memory. The cost of the design is occupancy: a pair holds 8 N
// bytes of shared memory (34 KB at N=4096), so an SM runs a few pairs where
// K1 runs 48 warps, and only half of the warps select. N is limited by one
// pair's buffers: about 27,700 (the wrapper raises beyond). knn_core.cuh is
// not changed: the bf16-operand proxy with an fp32 store lives here.

#include "knn_core.cuh"

namespace {

using namespace knn_core;

constexpr int kMaxPairs = 8;  // 16 warps; named barriers 1..8

// Bytes of one pair: two padded fp32 distance rows, then the consumer's
// bitmask (words + 1 words), each 16-byte aligned.
inline size_t pair_bytes(int n) {
  return align16(2 * static_cast<size_t>(pad_stride(n)) * 4) +
         align16((static_cast<size_t>((n + 31) / 32) + 1) * 4);
}

struct PipePlan {
  int pairs;
  bool in_smem;
  size_t pair_bytes;
  size_t smem;
};

// Pairs per block and where xyz lives: xyz in shared memory when it fits
// beside one pair, then as many pairs (<= 8) as still fit. Block layout: the
// pairs, then the padded SoA xyz.
inline bool pipe_plan(int n, PipePlan* p) {
  const size_t coords = 3 * static_cast<size_t>(pad_stride(n)) * 4;
  p->pair_bytes = pair_bytes(n);
  p->in_smem = p->pair_bytes + coords <= kMaxSmem;
  const size_t room = p->in_smem ? kMaxSmem - coords : kMaxSmem;
  const size_t fit = room / p->pair_bytes;
  p->pairs = static_cast<int>(fit < kMaxPairs ? fit : kMaxPairs);
  p->smem = p->pairs * p->pair_bytes + (p->in_smem ? coords : 0);
  return p->pairs >= 1;
}

__device__ __forceinline__ void pair_sync(int bar) {
  asm volatile("bar.sync %0, 64;" ::"r"(bar) : "memory");
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The producer: row `row`'s distances into dst at pad_idx(j).
template <bool kSmem>
__device__ __forceinline__ void produce(const float* xs, int stride, int n, int row,
                                        float* dst, int lane) {
  const float qx = coord<kSmem>(xs, stride, 0, row);
  const float qy = coord<kSmem>(xs, stride, 1, row);
  const float qz = coord<kSmem>(xs, stride, 2, row);
  for (int j = lane; j < n; j += 32) dst[pad_idx(j)] = sqdist<kSmem>(xs, stride, qx, qy, qz, j);
}

// The consumer: the k winners of the stored row `dr`, then the indicator row
// and the proxy.
template <bool kSmem>
__device__ __forceinline__ void consume(const float* xs, int stride, int n, int k,
                                        const float* dr, uint32_t* mask, int lane,
                                        int8_t* adj_row, float* proxy_row, float inv_k) {
  clear_mask(mask, (n + 31) >> 5, lane);
  float cd = __int_as_float(0x7f800000);  // +inf
  int cj = INT_MAX;
  for (int j = lane; j < n; j += 32) {
    const float d = dr[pad_idx(j)];
    if (lex_less(d, j, cd, cj)) {
      cd = d;
      cj = j;
    }
  }
  __syncwarp();  // the mask is cleared before lane 0 marks it

  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int r = 0; r < k; ++r) {
    float wd = cd;
    int wj = cj;
    warp_argmin(wd, wj);  // every lane holds the winner; wj < n as r < k <= n
    if (lane == 0) {
      mask[wj >> 5] |= 1u << (wj & 31);
      s0 = __fadd_rn(s0, bf16_round(coord<kSmem>(xs, stride, 0, wj)));
      s1 = __fadd_rn(s1, bf16_round(coord<kSmem>(xs, stride, 1, wj)));
      s2 = __fadd_rn(s2, bf16_round(coord<kSmem>(xs, stride, 2, wj)));
    }
    const int owner = wj & 31;
    float nd = __int_as_float(0x7f800000);
    int nj = INT_MAX;
    for (int j = owner + 32 * lane; j < n; j += 32 * 32) {
      const float d = dr[pad_idx(j)];
      if (lex_less(wd, wj, d, j) && lex_less(d, j, nd, nj)) {
        nd = d;
        nj = j;
      }
    }
    warp_argmin(nd, nj);
    if (lane == owner) {
      cd = nd;
      cj = nj;
    }
  }
  __syncwarp();  // lane 0's mask writes are visible to the whole warp
  write_dense_row(mask, n, adj_row, lane);
  if (lane == 0) {
    proxy_row[0] = __fmul_rn(s0, inv_k);
    proxy_row[1] = __fmul_rn(s1, inv_k);
    proxy_row[2] = __fmul_rn(s2, inv_k);
  }
}

template <bool kSmem>
__global__ void __launch_bounds__(kMaxPairs * 64)
    knn_pipelined_kernel(const float* __restrict__ x, int n, int k, int8_t* __restrict__ adj,
                         float* __restrict__ proxy, float inv_k, size_t pair_bytes_) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pairs = blockDim.x >> 6;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pair = warp >> 1;
  const int b = blockIdx.y;
  const int ps = pad_stride(n);

  unsigned char* mine = smem + pair * pair_bytes_;
  float* bufs = reinterpret_cast<float*>(mine);  // buffer s at bufs + s * ps
  uint32_t* mask = reinterpret_cast<uint32_t*>(mine + align16(2 * static_cast<size_t>(ps) * 4));
  const int stride = kSmem ? ps : 0;
  const float* xs = stage_xyz<kSmem>(x + static_cast<size_t>(b) * n * 3, n,
                                     reinterpret_cast<float*>(smem + pairs * pair_bytes_),
                                     stride);
  __syncthreads();  // the only block-wide barrier

  const int first = blockIdx.x * pairs + pair;
  const int step = gridDim.x * pairs;
  if (first >= n) return;  // both warps of the pair leave together
  const int rows = (n - 1 - first) / step + 1;
  const int bar = 1 + pair;

  if ((warp & 1) == 0) {  // producer: rows + 1 barriers, as the consumer
    produce<kSmem>(xs, stride, n, first, bufs, lane);
    pair_sync(bar);
    for (int t = 0; t < rows; ++t) {
      if (t + 1 < rows)
        produce<kSmem>(xs, stride, n, first + (t + 1) * step, bufs + ((t + 1) & 1) * ps, lane);
      pair_sync(bar);
    }
  } else {
    pair_sync(bar);
    for (int t = 0; t < rows; ++t) {
      const size_t r = static_cast<size_t>(b) * n + first + t * step;
      consume<kSmem>(xs, stride, n, k, bufs + (t & 1) * ps, mask, lane, adj + r * n,
                     proxy + r * 3, inv_k);
      pair_sync(bar);
    }
  }
}

template <bool kSmem>
cudaError_t launch(const float* x, int b, int n, int k, int8_t* adj, float* proxy,
                   float inv_k, const PipePlan& plan, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(knn_pipelined_kernel<kSmem>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(plan.smem));
  if (err != cudaSuccess) return err;
  const int threads = plan.pairs * 64;
  // one wave: as many blocks a cloud as the card holds at once, each pair
  // then walks its share of the rows through the pipeline
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, knn_pipelined_kernel<kSmem>, threads, plan.smem)) != cudaSuccess)
    return err;
  const int row_blocks = (n + plan.pairs - 1) / plan.pairs;
  int blocks = sms * (per_sm > 0 ? per_sm : 1) / b;
  if (blocks < 1) blocks = 1;
  if (blocks > row_blocks) blocks = row_blocks;
  knn_pipelined_kernel<kSmem><<<dim3(blocks, b), threads, plan.smem, stream>>>(
      x, n, k, adj, proxy, inv_k, plan.pair_bytes);
  return cudaGetLastError();
}

}  // namespace

// x: [B, N, 3] fp32 contiguous; adj: [B, N, N] int8; proxy: [B, N, 3] fp32.
// inv_k = float(1/k). Launches on `stream`, does not synchronise. Returns
// the launch's cudaError_t (0 = ok); cudaErrorInvalidValue when one pair's
// buffers do not fit in a block's shared memory.
extern "C" int knn_pipelined_launch(const float* x, int b, int n, int k, int8_t* adj,
                                    float* proxy, float inv_k, void* stream) {
  PipePlan plan;
  if (b < 1 || b > 65535 || n < 1 || k < 1 || k > n || !pipe_plan(n, &plan))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan.in_smem) return launch<true>(x, b, n, k, adj, proxy, inv_k, plan, s);
  return launch<false>(x, b, n, k, adj, proxy, inv_k, plan, s);
}

// 1 when one warp pair's buffers fit in a block's shared memory for a cloud
// of N points, as knn_pipelined_launch plans it; else 0.
extern "C" int knn_pipelined_fits(int n) {
  PipePlan plan;
  return n >= 1 && pipe_plan(n, &plan) ? 1 : 0;
}
