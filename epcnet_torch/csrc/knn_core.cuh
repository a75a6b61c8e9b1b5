// The warp-per-row selection core (the value rounds) of K1, K2, K3 and K5
// for k above knn_tile.cuh's register list (kMaxK), and the helpers of K6's
// warp pairs; at k <= kMaxK (the model's k = 20) they run on knn_tile.cuh,
// which gives the same winners in the same order.
//
// Per cloud b and query row i (N points, 1 <= k <= N):
//   d[i, j] = ((0 + dx*dx) + dy*dy) + dz*dz in fp32, each product and sum
//             rounded on its own (no FMA), in coordinate order: bit-equal to
//             epcnet_torch/ops/pairwise.py and the JAX pairwise_sqdist;
//   the k winners are the k smallest (d[i, j], j) in lexicographic order
//   (self included, ties to the lowest index), found in that order.
//
// One warp owns one query row. Lane L owns the columns j = L (mod 32) and
// keeps its best candidate (d, j) above the last winner. Each of the k rounds
// takes the warp-wide lexicographic minimum (the winner of rank r), hands it
// to the caller, and refills only the winning lane's candidate by a
// cooperative rescan of that lane's columns (N/1024 per lane). Distances are
// recomputed, never stored, so any N and any k <= N work and ragged edges
// need no padding points. xyz is read from shared memory as padded SoA (one
// pad slot per 32 columns keeps both access patterns free of bank conflicts)
// where it fits, else from the [N, 3] input in global memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace knn_core {

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

// Stage cloud xg [N, 3] into shared memory at s as padded SoA (kSmem) and
// return where to read xyz from. The caller follows with __syncthreads().
template <bool kSmem>
__device__ __forceinline__ const float* stage_xyz(const float* xg, int n, float* s,
                                                  int stride) {
  if constexpr (kSmem) {
    for (int t = threadIdx.x; t < 3 * n; t += blockDim.x) {
      const int j = t / 3, c = t - 3 * j;
      s[c * stride + pad_idx(j)] = xg[t];
    }
    return s;
  }
  return xg;
}

// The k rounds for query row `row`. on_win(r, d, j) runs on every lane of the
// warp with the rank-r winner (warp-uniform arguments).
template <bool kSmem, class OnWin>
__device__ __forceinline__ void select_k(const float* xs, int stride, int n, int k,
                                         int row, int lane, OnWin&& on_win) {
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
    on_win(r, wd, wj);
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
}

// The winners' bitmask (bit j & 31 of mask[j >> 5]; words + 1 words, the last
// one zero) in shared memory, one per warp.
__device__ __forceinline__ void clear_mask(uint32_t* mask, int words, int lane) {
  for (int w = lane; w <= words; w += 32) mask[w] = 0u;
}

__device__ __forceinline__ unsigned expand4(unsigned nib) {
  // 4 bits -> 4 bytes of 0/1, bit 0 in the lowest byte (lowest address)
  return (nib & 1u) | ((nib >> 1) & 1u) << 8 | ((nib >> 2) & 1u) << 16 |
         ((nib >> 3) & 1u) << 24;
}

__device__ __forceinline__ int8_t mask_bit(const uint32_t* mask, int j) {
  return static_cast<int8_t>((mask[j >> 5] >> (j & 31)) & 1u);
}

// One row of the int8 0/1 indicator from the bitmask: byte stores up to
// 16-byte alignment, then uint4 stores.
__device__ __forceinline__ void write_dense_row(const uint32_t* mask, int n,
                                                int8_t* out, int lane) {
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
}

// One row of the bit planes (N = 32 W): bit j of word w is column j*W + w.
// Lane L builds the words w = L (mod 32); plane 31 is the int32 sign bit.
__device__ __forceinline__ void write_packed_row(const uint32_t* mask, int w_words,
                                                 uint32_t* out, int lane) {
  for (int w = lane; w < w_words; w += 32) {
    uint32_t word = 0u;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = j * w_words + w;
      word |= ((mask[c >> 5] >> (c & 31)) & 1u) << j;
    }
    out[w] = word;
  }
}

// A coordinate rounded to the compute dtype (bf16 or fp32), as a float.
__device__ __forceinline__ float to_compute(float v, int proxy_bf16) {
  return proxy_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// proxy[o .. o + 2] = (s0, s1, s2) * inv_k, cast to the compute dtype.
__device__ __forceinline__ void store_proxy(void* proxy, size_t o, int proxy_bf16,
                                            float inv_k, float s0, float s1, float s2) {
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

// The layer-0 proxy of one row: the winners in ascending column order, each
// coordinate rounded to the compute dtype, summed in fp32, times float(1/k),
// cast to the compute dtype. Every lane runs the same (warp-uniform) walk;
// lane 0 writes proxy[o .. o + 2].
template <bool kSmem>
__device__ __forceinline__ void write_proxy(const uint32_t* mask, int words,
                                            const float* xs, int stride, int lane,
                                            void* proxy, size_t o, int proxy_bf16,
                                            float inv_k) {
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
        s0 = __fadd_rn(s0, to_compute(coord<kSmem>(xs, stride, 0, j), proxy_bf16));
        s1 = __fadd_rn(s1, to_compute(coord<kSmem>(xs, stride, 1, j), proxy_bf16));
        s2 = __fadd_rn(s2, to_compute(coord<kSmem>(xs, stride, 2, j), proxy_bf16));
      }
    }
  }
  if (lane == 0) store_proxy(proxy, o, proxy_bf16, inv_k, s0, s1, s2);
}

// Rows per block and where xyz lives, from N and the 32-bit words of bitmask
// each warp keeps (0 for none): xyz in shared memory when it fits beside one
// warp's bitmask, then as many warps (<= 16) as still fit. Block layout: the
// warps' bitmasks, then (16-byte aligned) the padded SoA xyz.
struct Plan {
  int warps;
  bool in_smem;
  size_t mask_bytes;  // all warps' bitmasks, 16-byte aligned
  size_t smem;
};

inline bool make_plan(int n, size_t mask_words, Plan* p) {
  const size_t coords = 3 * static_cast<size_t>(pad_stride(n)) * 4;
  p->in_smem = align16(mask_words * 4) + coords <= kMaxSmem;
  const size_t room = p->in_smem ? kMaxSmem - coords : kMaxSmem;
  p->warps = kMaxWarps;
  while (p->warps > 1 && align16(p->warps * mask_words * 4) > room) p->warps >>= 1;
  p->mask_bytes = align16(p->warps * mask_words * 4);
  p->smem = p->mask_bytes + (p->in_smem ? coords : 0);
  return p->mask_bytes <= room;
}

}  // namespace knn_core
