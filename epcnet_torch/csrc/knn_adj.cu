// K1: exact kNN 0/1 indicator adjacency + layer-0 proxy point, for Hopper.
//
// Replaces the TPU kernel epcnet_tpu/ops/knn.py::_knn_adj_only_kernel in its
// dense form (with or without the proxy output), launched at
// epcnet_tpu/ops/knn.py:255 (and :247 without the proxy).
//
// What it computes, per cloud b and query row i (N points, 1 <= k <= N):
//   d[i, j] = ((0 + dx*dx) + dy*dy) + dz*dz in fp32, each product and sum
//             rounded on its own (no FMA), in coordinate order: bit-equal to
//             epcnet_torch/ops/pairwise.py and the JAX pairwise_sqdist;
//   adj[b, i, j] = 1 for the k smallest (d[i, j], j) in lexicographic order
//             (self included, ties to the lowest index), 0 elsewhere; int8;
//   proxy[b, i, c] = (sum over the k winners, in ascending j, of x[b, j, c]
//             rounded to the compute dtype, summed in fp32) * float(1/k),
//             cast to the compute dtype (bf16 or fp32).
//
// Bound on this card: the indicator write is N^2 bytes per cloud — 16.8 MB at
// N=4096, about 5.0 us per cloud at 3.35 TB/s, 40 us at B=8. The distance
// arithmetic (8 fp32 operations per pair, 1.07 GFLOP at B=8) is 16 us at
// 67 TFLOP/s, under the byte bound.
//
// Design (simple and exact first; nothing here works toward that bound yet):
//   - one warp owns one query row; a block holds up to 16 warps (rows) of one
//     cloud and stages the cloud's xyz into shared memory as padded SoA (one
//     pad slot per 32 columns), or reads it from global memory when it does
//     not fit (N above about 18,500);
//   - lane L owns the columns j = L (mod 32) and keeps its best candidate
//     (d, j) above the last winner. Each of the k rounds takes the warp-wide
//     lexicographic minimum (the winner), marks it in a per-warp bitmask in
//     shared memory, and refills only the winning lane's candidate by a
//     cooperative rescan of that lane's columns (N/1024 per lane). Distances
//     are recomputed, never stored, so any N and any k <= N work and ragged
//     edges need no padding points;
//   - the row of the indicator is written from the bitmask with 16-byte
//     stores (byte stores at an unaligned head and tail);
//   - the proxy walks the bitmask in ascending column order.
// Faster designs (a per-lane register top-k, a threshold select, fewer
// global bytes) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 16;
constexpr size_t kMaxSmem = 227 * 1024;  // per block, opt-in (sm_90)

__host__ __device__ inline int pad_idx(int j) { return j + (j >> 5); }
__host__ __device__ inline int pad_stride(int n) {
  // room for pad_idx(n - 1), rounded to 4 floats
  return ((n + (n + 31) / 32) + 3) & ~3;
}
__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

__device__ __forceinline__ bool lex_less(float d1, int j1, float d2, int j2) {
  return d1 < d2 || (d1 == d2 && j1 < j2);
}

__device__ __forceinline__ void warp_argmin(float& d, int& j) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(kFull, d, off);
    const int oj = __shfl_xor_sync(kFull, j, off);
    if (lex_less(od, oj, d, j)) {
      d = od;
      j = oj;
    }
  }
}

// Coordinate c of point j: padded SoA in shared memory, or the [N, 3] input.
template <bool kSmem>
__device__ __forceinline__ float coord(const float* xs, int stride, int c, int j) {
  if constexpr (kSmem) return xs[c * stride + pad_idx(j)];
  else return __ldg(xs + 3 * j + c);
}

template <bool kSmem>
__device__ __forceinline__ float sqdist(const float* xs, int stride, float qx,
                                        float qy, float qz, int j) {
  const float dx = __fsub_rn(qx, coord<kSmem>(xs, stride, 0, j));
  const float dy = __fsub_rn(qy, coord<kSmem>(xs, stride, 1, j));
  const float dz = __fsub_rn(qz, coord<kSmem>(xs, stride, 2, j));
  float d = __fmul_rn(dx, dx);
  d = __fadd_rn(d, __fmul_rn(dy, dy));
  return __fadd_rn(d, __fmul_rn(dz, dz));
}

__device__ __forceinline__ unsigned expand4(unsigned nib) {
  // 4 bits -> 4 bytes of 0/1, bit 0 in the lowest byte (lowest address)
  return (nib & 1u) | ((nib >> 1) & 1u) << 8 | ((nib >> 2) & 1u) << 16 |
         ((nib >> 3) & 1u) << 24;
}

__device__ __forceinline__ int8_t mask_bit(const uint32_t* mask, int j) {
  return static_cast<int8_t>((mask[j >> 5] >> (j & 31)) & 1u);
}

template <bool kSmem>
__global__ void knn_adj_kernel(const float* __restrict__ x, int n, int k,
                               int8_t* __restrict__ adj, void* proxy,
                               int proxy_bf16, float inv_k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int row = blockIdx.x * warps + warp;
  const int words = (n + 31) >> 5;

  uint32_t* mask = reinterpret_cast<uint32_t*>(smem) + warp * (words + 1);
  const float* xg = x + static_cast<size_t>(b) * n * 3;
  const float* xs = xg;
  int stride = 0;
  if constexpr (kSmem) {
    stride = pad_stride(n);
    float* s = reinterpret_cast<float*>(
        smem + align16(static_cast<size_t>(warps) * (words + 1) * 4));
    for (int t = threadIdx.x; t < 3 * n; t += blockDim.x) {
      const int j = t / 3, c = t - 3 * j;
      s[c * stride + pad_idx(j)] = xg[t];
    }
    xs = s;
  }
  __syncthreads();  // the only block-wide barrier: rows past N leave after it
  if (row >= n) return;

  for (int w = lane; w <= words; w += 32) mask[w] = 0u;
  const float qx = coord<kSmem>(xs, stride, 0, row);
  const float qy = coord<kSmem>(xs, stride, 1, row);
  const float qz = coord<kSmem>(xs, stride, 2, row);

  // each lane's best (d, j) over its columns j = lane (mod 32)
  float cd = __int_as_float(0x7f800000);  // +inf
  int cj = INT_MAX;
  for (int j = lane; j < n; j += 32) {
    const float d = sqdist<kSmem>(xs, stride, qx, qy, qz, j);
    if (lex_less(d, j, cd, cj)) {
      cd = d;
      cj = j;
    }
  }
  __syncwarp();

  for (int r = 0; r < k; ++r) {
    float wd = cd;
    int wj = cj;
    warp_argmin(wd, wj);  // every lane holds the winner; wj < n as r < k <= n
    if (lane == 0) mask[wj >> 5] |= 1u << (wj & 31);
    // refill the winning lane: the next (d, j) of its columns above the winner
    const int owner = wj & 31;
    float nd = __int_as_float(0x7f800000);
    int nj = INT_MAX;
    for (int j = owner + 32 * lane; j < n; j += 32 * 32) {
      const float d = sqdist<kSmem>(xs, stride, qx, qy, qz, j);
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

  // indicator row: byte stores up to 16-byte alignment, then uint4 stores
  int8_t* out = adj + (static_cast<size_t>(b) * n + row) * n;
  int head = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(out) & 15)) & 15);
  if (head > n) head = n;
  for (int j = lane; j < head; j += 32) out[j] = mask_bit(mask, j);
  const int chunks = (n - head) >> 4;
  uint4* vout = reinterpret_cast<uint4*>(out + head);
  for (int c = lane; c < chunks; c += 32) {
    const int j0 = head + 16 * c;
    const uint64_t two = (static_cast<uint64_t>(mask[(j0 >> 5) + 1]) << 32) |
                         mask[j0 >> 5];
    const unsigned bits = static_cast<unsigned>(two >> (j0 & 31)) & 0xffffu;
    uint4 v;
    v.x = expand4(bits & 0xfu);
    v.y = expand4((bits >> 4) & 0xfu);
    v.z = expand4((bits >> 8) & 0xfu);
    v.w = expand4((bits >> 12) & 0xfu);
    vout[c] = v;
  }
  for (int j = head + 16 * chunks + lane; j < n; j += 32) out[j] = mask_bit(mask, j);

  if (proxy == nullptr) return;
  // proxy: the winners in ascending column order; every lane runs the same
  // (warp-uniform) walk, lane 0 writes
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int w0 = 0; w0 < words; w0 += 32) {
    const uint32_t mine = (w0 + lane < words) ? mask[w0 + lane] : 0u;
    uint32_t nonzero = __ballot_sync(kFull, mine != 0u);
    while (nonzero) {
      const int src = __ffs(nonzero) - 1;
      nonzero &= nonzero - 1;
      uint32_t bits = __shfl_sync(kFull, mine, src);
      while (bits) {
        const int j = (w0 + src) * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        float v0 = coord<kSmem>(xs, stride, 0, j);
        float v1 = coord<kSmem>(xs, stride, 1, j);
        float v2 = coord<kSmem>(xs, stride, 2, j);
        if (proxy_bf16) {
          v0 = __bfloat162float(__float2bfloat16_rn(v0));
          v1 = __bfloat162float(__float2bfloat16_rn(v1));
          v2 = __bfloat162float(__float2bfloat16_rn(v2));
        }
        s0 = __fadd_rn(s0, v0);
        s1 = __fadd_rn(s1, v1);
        s2 = __fadd_rn(s2, v2);
      }
    }
  }
  if (lane == 0) {
    const size_t o = (static_cast<size_t>(b) * n + row) * 3;
    const float p0 = __fmul_rn(s0, inv_k), p1 = __fmul_rn(s1, inv_k),
                p2 = __fmul_rn(s2, inv_k);
    if (proxy_bf16) {
      __nv_bfloat16* pb = static_cast<__nv_bfloat16*>(proxy) + o;
      pb[0] = __float2bfloat16_rn(p0);
      pb[1] = __float2bfloat16_rn(p1);
      pb[2] = __float2bfloat16_rn(p2);
    } else {
      float* pf = static_cast<float*>(proxy) + o;
      pf[0] = p0;
      pf[1] = p1;
      pf[2] = p2;
    }
  }
}

// Rows per block and where xyz lives, from N: xyz in shared memory when it
// fits beside one warp's bitmask, then as many warps (<= 16) as still fit.
struct Plan {
  int warps;
  bool in_smem;
  size_t smem;
};

bool make_plan(int n, Plan* p) {
  const size_t words = static_cast<size_t>((n + 31) / 32) + 1;
  const size_t coords = 3 * static_cast<size_t>(pad_stride(n)) * 4;
  p->in_smem = align16(words * 4) + coords <= kMaxSmem;
  const size_t room = p->in_smem ? kMaxSmem - coords : kMaxSmem;
  p->warps = kMaxWarps;
  while (p->warps > 1 && align16(p->warps * words * 4) > room) p->warps >>= 1;
  p->smem = align16(p->warps * words * 4) + (p->in_smem ? coords : 0);
  return align16(p->warps * words * 4) <= room;
}

template <bool kSmem>
cudaError_t launch(const float* x, int b, int n, int k, int8_t* adj, void* proxy,
                   int proxy_bf16, float inv_k, const Plan& plan,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      knn_adj_kernel<kSmem>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(plan.smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + plan.warps - 1) / plan.warps, b);
  knn_adj_kernel<kSmem><<<grid, plan.warps * 32, plan.smem, stream>>>(
      x, n, k, adj, proxy, proxy_bf16, inv_k);
  return cudaGetLastError();
}

}  // namespace

// x: [B, N, 3] fp32 contiguous; adj: [B, N, N] int8; proxy: [B, N, 3] in bf16
// (proxy_bf16 = 1) or fp32, or NULL for the indicator alone. Launches on
// `stream`, does not synchronise. Returns the launch's cudaError_t (0 = ok).
extern "C" int knn_adj_launch(const float* x, int b, int n, int k, int8_t* adj,
                              void* proxy, int proxy_bf16, float inv_k,
                              void* stream) {
  Plan plan;
  if (b < 1 || b > 65535 || n < 1 || k < 1 || k > n || !make_plan(n, &plan))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan.in_smem)
    return launch<true>(x, b, n, k, adj, proxy, proxy_bf16, inv_k, plan, s);
  return launch<false>(x, b, n, k, adj, proxy, proxy_bf16, inv_k, plan, s);
}
