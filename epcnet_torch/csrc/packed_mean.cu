// K4: neighbour mean through the bit-packed adjacency, for Hopper.
//
// Replaces the TPU kernel epcnet_tpu/ops/adjacency.py::_packed_mean_kernel
// (adjacency.py:129-143), launched at adjacency.py:154 through
// packed_neighbor_mean (:170).
//
// What it computes, per cloud b and row i, with W words per row and
// N = 32 W columns (bit j of word w is column c = j*W + w):
//   out[b, i, :] = (sum over the set bits c of row i, in ascending c, of
//                   F[b, c, :], summed in fp32) * float(1/k),
//                  cast to the output dtype.
// F is read in the compute dtype (bf16 or fp32); the mask is 0/1, so each
// product of the TPU's unpack-then-matmul is the feature itself and the sum
// of the set rows is the same function. It handles any number of set bits
// per row (the mask need not hold k of them).
//
// Bound on this card: the bytes — the planes (N/8 bytes per row) plus F and
// the output; at B=2, N=32768, C=64 bf16 that is 268 MB + 8.4 MB + 8.4 MB,
// 85 us at 3.35 TB/s. The adds (popcount * C per row) are far below it.
//
// Design: one warp a row, and a walk that touches only what is set. A kNN
// row holds k = 20 set bits in at most 20 of its W = 1024 words (N = 32768),
// so a walk over every word and plane spends its time on instructions and
// their latency, not on bytes.
//  1. The row's W plane words are read once, wide: 16-byte streaming loads,
//     kU a lane in flight (a 1024-word row in one round), into registers.
//  2. The non-zero words are compacted: three ballots on each lane's count
//     and a popcount prefix give each its slot in the warp's list of
//     (w, word) in shared memory, in ascending w (a kNN row gives at most k
//     entries), and the OR of all words says which planes hold a bit at all.
//  3. The set planes j are walked in ascending order over the list only: a
//     ballot per 32 entries a plane (the first 32 held one a lane), then its
//     set bits in ascending w, so the columns come in ascending
//     c = j*W + w. That is at most 32 ballots a kNN row where a walk of every
//     word takes 1024; a dense row has up to W entries and costs what that
//     walk costs, so one path serves every mask.
//  4. The F rows are gathered ahead of the adds: the walk's columns collect
//     in batches of kBatch (16 at C=64; shared memory); each lane loads its
//     kCpl adjacent channels of every column of a batch (at C=64 bf16 a
//     column is one 128-byte line, 4 bytes a lane) before the batch's adds
//     run in walk order. F (4 MB a cloud at N=32768, C=64) stays in L2.
// Each add is rounded on its own, in ascending c, so any two walks over the
// same columns in that order give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // rows a block; fewer where the lists do not fit
constexpr int kU = 8;      // 16-byte plane loads a lane in flight
constexpr int kSpan = 32 * 4 * kU;  // words a round of loads
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A lane's kCpl adjacent channels of one F row, loaded as one piece.
template <typename T, int kCpl>
struct alignas(sizeof(T) * kCpl < 16 ? sizeof(T) * kCpl : 16) Chunk {
  T v[kCpl];
};

// Columns a batch: 16, or fewer where a lane's channels of them would pass
// 128 bytes (at least 4). Each column in flight holds its value and its
// address in registers; 32 columns cost a third of the warps an SM holds
// and were slower.
template <typename T, int kCpl>
__host__ __device__ constexpr int batch_cols() {
  return 128 / static_cast<int>(sizeof(T) * kCpl) > 16   ? 16
         : 128 / static_cast<int>(sizeof(T) * kCpl) < 4 ? 4
                                                         : 128 / static_cast<int>(sizeof(T) * kCpl);
}

// The warps' batches of columns, 8-byte aligned (the lists follow).
template <int kBatch>
__host__ __device__ constexpr size_t cols_bytes(int warps) {
  return (static_cast<size_t>(warps) * (kBatch + 32) * 4 + 7) & ~static_cast<size_t>(7);
}

// Words w .. w + 3 of a row, zero past W; one 16-byte load where the row is
// 16-byte aligned and W % 4 == 0 (vec).
__device__ __forceinline__ uint4 load_words(const uint32_t* __restrict__ prow, int w,
                                            int w_words, int vec) {
  if (vec) return w < w_words ? __ldcs(reinterpret_cast<const uint4*>(prow + w)) : uint4{};
  uint4 q;
  q.x = w < w_words ? __ldcs(prow + w) : 0u;
  q.y = w + 1 < w_words ? __ldcs(prow + w + 1) : 0u;
  q.z = w + 2 < w_words ? __ldcs(prow + w + 2) : 0u;
  q.w = w + 3 < w_words ? __ldcs(prow + w + 3) : 0u;
  return q;
}

// Add F rows cols[0 .. filled - 1] of the batch, in that order, to acc: all
// loads first, then the adds, eight columns a step. vec: the lane's
// channels are one aligned Chunk (C % kCpl == 0); else each is loaded on its
// own, clamped into the row (channels past C are summed but never stored).
template <typename TIn, int kCpl, int kBatch>
__device__ __forceinline__ void gather_add(float (&acc)[kCpl], const int* cols, int filled,
                                           const TIn* __restrict__ fb, int c, int ch0,
                                           int vec) {
  __syncwarp();  // the batch's columns are in shared memory
  if (ch0 < c) {
    Chunk<TIn, kCpl> v[kBatch];
#pragma unroll
    for (int g = 0; g < kBatch; g += 8) {
      if (g < filled) {
#pragma unroll
        for (int t = g; t < (g + 8 < kBatch ? g + 8 : kBatch); ++t) {
          if (t < filled) {
            const TIn* src = fb + static_cast<size_t>(cols[t]) * c + ch0;
            if (vec) {
              v[t] = *reinterpret_cast<const Chunk<TIn, kCpl>*>(src);
            } else {
#pragma unroll
              for (int i = 0; i < kCpl; ++i) v[t].v[i] = src[min(i, c - 1 - ch0)];
            }
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kBatch; g += 8) {
      if (g < filled) {
#pragma unroll
        for (int t = g; t < (g + 8 < kBatch ? g + 8 : kBatch); ++t) {
          if (t < filled) {
#pragma unroll
            for (int i = 0; i < kCpl; ++i) acc[i] = __fadd_rn(acc[i], to_float(v[t].v[i]));
          }
        }
      }
    }
  }
  __syncwarp();  // every lane has read the columns before they are overwritten
}

// grid (ceil(nrows / warps), B, ceil(C / (32 kCpl))); block z owns the
// channels [32 kCpl z, 32 kCpl (z + 1)), lane L the kCpl from 32 kCpl z +
// kCpl L. Shared memory: each warp's batch, kBatch + 32 columns (a ballot's
// columns may overrun a batch), then each warp's list, W (w, word) pairs.
template <typename TIn, typename TOut, int kCpl>
__global__ void __launch_bounds__(kWarps * 32)
    packed_mean_kernel(const uint32_t* __restrict__ planes, const TIn* __restrict__ f,
                       TOut* __restrict__ out, int nrows, int w_words, int c, float inv_k,
                       int vec_words, int vec_f) {
  constexpr int kBatch = batch_cols<TIn, kCpl>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int row = blockIdx.x * warps + warp;
  if (row >= nrows) return;  // no block-wide barrier follows

  int* cols = reinterpret_cast<int*>(smem) + warp * (kBatch + 32);
  uint2* list = reinterpret_cast<uint2*>(smem + cols_bytes<kBatch>(warps)) +
                static_cast<size_t>(warp) * w_words;
  const unsigned below_me = (1u << lane) - 1u;

  // 1-2. the row's non-zero words, in ascending w
  const uint32_t* prow = planes + (static_cast<size_t>(b) * nrows + row) * w_words;
  int m = 0;              // entries in the list (warp-uniform)
  uint32_t present = 0u;  // OR of this lane's words
  for (int w0 = 0; w0 < w_words; w0 += kSpan) {
    uint4 q[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      q[u] = load_words(prow, w0 + 4 * (32 * u + lane), w_words, vec_words);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const uint32_t wd[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
      const int cnt = (wd[0] != 0u) + (wd[1] != 0u) + (wd[2] != 0u) + (wd[3] != 0u);
      const unsigned b0 = __ballot_sync(kFull, cnt & 1), b1 = __ballot_sync(kFull, cnt & 2),
                     b2 = __ballot_sync(kFull, cnt & 4);
      if ((b0 | b1 | b2) == 0u) continue;  // warp-uniform
      int slot = m + __popc(b0 & below_me) + 2 * __popc(b1 & below_me) +
                 4 * __popc(b2 & below_me);
      const int w = w0 + 4 * (32 * u + lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (wd[i] != 0u) {
          list[slot++] = make_uint2(static_cast<unsigned>(w + i), wd[i]);
          present |= wd[i];
        }
      }
      m += __popc(b0) + 2 * __popc(b1) + 4 * __popc(b2);
    }
  }
  present = __reduce_or_sync(kFull, present);
  __syncwarp();  // the list is written

  // 3-4. the set planes over the list, a batch at a time
  const TIn* fb = f + static_cast<size_t>(b) * 32 * w_words * c;
  const int ch0 = blockIdx.z * 32 * kCpl + lane * kCpl;
  float acc[kCpl];
#pragma unroll
  for (int i = 0; i < kCpl; ++i) acc[i] = 0.f;
  const uint2 mine = lane < m ? list[lane] : make_uint2(0u, 0u);
  int filled = 0;  // columns in the batch (warp-uniform)
  while (present) {
    const int j = __ffs(present) - 1;
    present &= present - 1;
    for (int m0 = 0; m0 < m; m0 += 32) {
      const uint2 e =
          m0 == 0 ? mine : (m0 + lane < m ? list[m0 + lane] : make_uint2(0u, 0u));
      const unsigned bits = __ballot_sync(kFull, (e.y >> j) & 1u);
      if ((bits >> lane) & 1u)
        cols[filled + __popc(bits & below_me)] = j * w_words + static_cast<int>(e.x);
      filled += __popc(bits);
      while (filled >= kBatch) {  // a full batch; the overrun moves to the front
        gather_add<TIn, kCpl, kBatch>(acc, cols, kBatch, fb, c, ch0, vec_f);
        filled -= kBatch;
        const int moved = lane < filled ? cols[kBatch + lane] : 0;
        __syncwarp();
        if (lane < filled) cols[lane] = moved;
      }
    }
  }
  gather_add<TIn, kCpl, kBatch>(acc, cols, filled, fb, c, ch0, vec_f);

  if (ch0 < c) {
    TOut* orow = out + (static_cast<size_t>(b) * nrows + row) * c + ch0;
#pragma unroll
    for (int i = 0; i < kCpl; ++i)
      if (ch0 + i < c) orow[i] = from_float<TOut>(__fmul_rn(acc[i], inv_k));
  }
}

template <typename TIn, typename TOut, int kCpl>
cudaError_t launch(const void* planes, const void* f, void* out, int b, int nrows,
                   int w_words, int c, float inv_k, cudaStream_t stream) {
  constexpr int kBatch = batch_cols<TIn, kCpl>();
  auto smem_for = [&](int warps) {
    return cols_bytes<kBatch>(warps) + static_cast<size_t>(warps) * w_words * 8;
  };
  int warps = kWarps;
  while (warps > 1 && smem_for(warps) > kMaxSmem) warps >>= 1;
  const size_t smem = smem_for(warps);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(packed_mean_kernel<TIn, TOut, kCpl>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int vec_words = w_words % 4 == 0 && reinterpret_cast<uintptr_t>(planes) % 16 == 0;
  const int vec_f =
      c % kCpl == 0 && reinterpret_cast<uintptr_t>(f) % alignof(Chunk<TIn, kCpl>) == 0;
  const dim3 grid((nrows + warps - 1) / warps, b, (c + 32 * kCpl - 1) / (32 * kCpl));
  packed_mean_kernel<TIn, TOut, kCpl><<<grid, warps * 32, smem, stream>>>(
      static_cast<const uint32_t*>(planes), static_cast<const TIn*>(f),
      static_cast<TOut*>(out), nrows, w_words, c, inv_k, vec_words, vec_f);
  return cudaGetLastError();
}

template <typename TIn, typename TOut>
cudaError_t by_width(const void* planes, const void* f, void* out, int b, int nrows,
                     int w_words, int c, float inv_k, cudaStream_t s) {
  if (c <= 32) return launch<TIn, TOut, 1>(planes, f, out, b, nrows, w_words, c, inv_k, s);
  if (c <= 64) return launch<TIn, TOut, 2>(planes, f, out, b, nrows, w_words, c, inv_k, s);
  if (c <= 128) return launch<TIn, TOut, 4>(planes, f, out, b, nrows, w_words, c, inv_k, s);
  return launch<TIn, TOut, 8>(planes, f, out, b, nrows, w_words, c, inv_k, s);
}

}  // namespace

// planes: [B, Nr, W] int32 bit planes; f: [B, 32 W, C] in bf16 (in_bf16 = 1)
// or fp32; out: [B, Nr, C] in bf16 (out_bf16 = 1) or fp32; all contiguous.
// W up to about 29,000 (a warp's list of W pairs fits in shared memory).
// Launches on `stream`, does not synchronise. Returns the launch's
// cudaError_t (0 = ok).
extern "C" int packed_mean_launch(const void* planes, const void* f, void* out, int b,
                                  int nrows, int w_words, int c, int in_bf16,
                                  int out_bf16, float inv_k, void* stream) {
  if (b < 1 || b > 65535 || nrows < 1 || w_words < 1 || c < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (in_bf16 && out_bf16) return by_width<bf16, bf16>(planes, f, out, b, nrows, w_words, c, inv_k, s);
  if (in_bf16) return by_width<bf16, float>(planes, f, out, b, nrows, w_words, c, inv_k, s);
  if (out_bf16) return by_width<float, bf16>(planes, f, out, b, nrows, w_words, c, inv_k, s);
  return by_width<float, float>(planes, f, out, b, nrows, w_words, c, inv_k, s);
}
