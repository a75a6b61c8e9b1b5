// K7: neighbour mean straight from the dense int8 indicator, for Hopper.
//
// Replaces no TPU kernel. On the TPU the dense route's mean is one XLA dot,
// epcnet_tpu/ops/adjacency.py::neighbor_mean (adjacency.py:245-255), with
// the int8 -> bf16 convert of the indicator fused into it. On the card that
// dot was two library calls over the whole [B, N, N] indicator: a cast to
// bf16 (reading N^2 bytes, writing 2 N^2) and a bf16 GEMM that reads the
// 2 N^2 bytes again for each of layers 1-3, doing N/k times the sums the
// mean needs. This kernel reads K1's int8 indicator once a layer.
//
// What it computes, per cloud b and row i of an indicator with N columns:
//   out[b, i, :] = (sum over the non-zero bytes a of row i, in ascending
//                   column j, of float(a) * float(F[b, j, :]), in fp32)
//                  * float(1/k), cast to the output dtype.
// A byte counts with its value (a kNN indicator holds 0/1; a count of 2
// adds the row twice), as the cast-then-GEMM does: a bf16 feature times a
// byte is exact in fp32, so only the order of the fp32 sum differs from it.
// Any N, any number of set bytes a row (an empty row gives 0).
//
// Bound on this card: the bytes, the indicator (N bytes a row) plus F and
// the output; at B=32, N=4096, C=64 bf16 that is 537 MB + 2 x 16.8 MB,
// 0.17 ms at 3.35 TB/s. The adds (k C a row) are far below it.
//
// Design: K4's (packed_mean.cu), on byte rows. One warp a row; a kNN row
// holds k = 20 set bytes in at most 20 of its 256 16-byte chunks (N=4096),
// so the work is kept to what is set.
//  1. The row is read once, wide: 16-byte streaming loads (__ldcs; the
//     indicator is read once), kU a lane in flight, so a 4096-byte row is
//     two rounds. The loads are of aligned 16-byte chunks; a chunk that
//     straddles the row's ends is read a byte at a time, so a row of any N
//     at any address is read without touching its neighbours.
//  2. The non-zero chunks are compacted: a ballot a load and a popcount
//     prefix give each its slot in the warp's list of (chunk, index) in
//     shared memory, in ascending index.
//  3. A lane a listed chunk finds its non-zero bytes (a bit trick, no
//     per-byte loop), a warp scan of their counts gives each lane its place,
//     and the lane appends (column, byte) entries to the warp's second
//     list: in ascending column.
//  4. Whenever kBatch entries are listed, their F rows are gathered (each
//     lane its kCpl adjacent channels of every column, loaded before the
//     adds) and added in list order; a batch of bytes of 1 adds without
//     the product. F is 32 KB - 1 MB a cloud, so it stays in L2.
// Each add is rounded on its own (-fmad=false), in ascending column.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;        // rows a block
constexpr int kU = 4;            // 16-byte loads a lane in flight
constexpr int kSpan = 32 * kU;   // chunks a round: 2048 bytes
constexpr int kGroup = 32 * 16;  // most entries 32 listed chunks add

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

// Columns a batch: 8, or fewer where a lane's channels of them would pass
// 128 bytes (at least 4). K4 takes up to 16; here the registers of 16 cost
// more warps than the loads in flight gained (on an H100 at 700 W: 0.31
// against 0.26 ms at B=32, N=4096, C=64; 0.24 against 0.22 at C=16).
template <typename T, int kCpl>
__host__ __device__ constexpr int batch_cols() {
  return 128 / static_cast<int>(sizeof(T) * kCpl) > 8   ? 8
         : 128 / static_cast<int>(sizeof(T) * kCpl) < 4 ? 4
                                                         : 128 / static_cast<int>(sizeof(T) * kCpl);
}

// The top bit of each non-zero byte of w.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  return (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
}

// Chunk j of a row whose first byte lies `off` bytes past a 16-byte
// boundary `base`: the bytes of columns 16 j - off .. 16 j - off + 15,
// zero outside [0, n).
__device__ __forceinline__ uint4 load_chunk(const int8_t* __restrict__ base, int j, int off,
                                            int n) {
  const int col0 = 16 * j - off;
  if (col0 >= 0 && col0 + 16 <= n)
    return __ldcs(reinterpret_cast<const uint4*>(base) + j);
  if (col0 >= n || col0 + 16 <= 0) return uint4{};
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const int col = col0 + t;
    if (col >= 0 && col < n)
      w[t >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldcs(base + 16 * j + t)))
                   << (8 * (t & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Add F rows of entries list[0 .. filled - 1], in that order, to acc: all
// loads first, then the adds. An entry is column << 8 | byte. vec: the
// lane's channels are one aligned Chunk (C % kCpl == 0); else each is
// loaded on its own, clamped into the row (channels past C are summed but
// never stored).
template <typename TIn, int kCpl, int kBatch>
__device__ __forceinline__ void gather_add(float (&acc)[kCpl], const int* list, int filled,
                                           const TIn* __restrict__ fb, int c, int ch0,
                                           int vec) {
  __syncwarp();  // the entries are in shared memory
  if (ch0 < c) {
    Chunk<TIn, kCpl> v[kBatch];
    int e[kBatch];
    bool ones = true;  // every byte of the batch is 1 (warp-uniform)
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      if (t < filled) {
        e[t] = list[t];
        ones = ones && (e[t] & 0xff) == 1;
        const TIn* src = fb + static_cast<size_t>(e[t] >> 8) * c + ch0;
        if (vec) {
          v[t] = *reinterpret_cast<const Chunk<TIn, kCpl>*>(src);
        } else {
#pragma unroll
          for (int i = 0; i < kCpl; ++i) v[t].v[i] = src[min(i, c - 1 - ch0)];
        }
      }
    }
    if (ones) {  // a times 1 is exact: the product is left out
#pragma unroll
      for (int t = 0; t < kBatch; ++t)
        if (t < filled) {
#pragma unroll
          for (int i = 0; i < kCpl; ++i) acc[i] = __fadd_rn(acc[i], to_float(v[t].v[i]));
        }
    } else {
#pragma unroll
      for (int t = 0; t < kBatch; ++t)
        if (t < filled) {
          const float a = static_cast<float>(static_cast<int8_t>(e[t] & 0xff));
#pragma unroll
          for (int i = 0; i < kCpl; ++i)
            acc[i] = __fadd_rn(acc[i], __fmul_rn(a, to_float(v[t].v[i])));
        }
    }
  }
  __syncwarp();  // every lane has read the entries before they are overwritten
}

// grid (ceil(nrows / kWarps), B, ceil(C / (32 kCpl))); block z owns the
// channels [32 kCpl z, 32 kCpl (z + 1)), lane L the kCpl from 32 kCpl z +
// kCpl L. Shared memory a warp: the round's non-zero chunks and their
// indices, and the entries, kBatch - 1 left over plus what 32 chunks add.
template <typename TIn, typename TOut, int kCpl>
__global__ void __launch_bounds__(kWarps * 32)
    indicator_mean_kernel(const int8_t* __restrict__ ind, const TIn* __restrict__ f,
                          TOut* __restrict__ out, int nrows, int n, int c, float inv_k,
                          int vec_f) {
  constexpr int kBatch = batch_cols<TIn, kCpl>();
  __shared__ uint4 chunk_lists[kWarps][kSpan];
  __shared__ int index_lists[kWarps][kSpan];
  __shared__ int entry_lists[kWarps][kBatch + kGroup];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= nrows) return;  // no block-wide barrier follows

  uint4* chunk_list = chunk_lists[warp];
  int* index_list = index_lists[warp];
  int* list = entry_lists[warp];
  const unsigned below_me = (1u << lane) - 1u;
  const int8_t* prow = ind + (static_cast<size_t>(b) * nrows + row) * n;
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(prow) & 15u);
  const int8_t* base = prow - off;  // 16-byte aligned
  const int chunks = (off + n + 15) >> 4;
  const bool whole = off == 0 && (n & 15) == 0;  // no chunk straddles the row's ends

  const TIn* fb = f + static_cast<size_t>(b) * n * c;
  const int ch0 = blockIdx.z * 32 * kCpl + lane * kCpl;
  float acc[kCpl];
#pragma unroll
  for (int i = 0; i < kCpl; ++i) acc[i] = 0.f;

  int filled = 0;  // entries in the list (warp-uniform)
  for (int j0 = 0; j0 < chunks; j0 += kSpan) {
    // 1-2. the round's loads, all in flight; its non-zero chunks listed
    int m = 0;  // chunks listed (warp-uniform)
    {
      uint4 q[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int j = j0 + 32 * u + lane;
        if (whole)
          q[u] = j < chunks ? __ldcs(reinterpret_cast<const uint4*>(base) + j) : uint4{};
        else
          q[u] = j < chunks ? load_chunk(base, j, off, n) : uint4{};
      }
      __syncwarp();  // the last round's lists are read
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const bool nz = (q[u].x | q[u].y | q[u].z | q[u].w) != 0u;
        const unsigned set = __ballot_sync(kFull, nz);
        if (nz) {
          const int s = m + __popc(set & below_me);
          chunk_list[s] = q[u];
          index_list[s] = j0 + 32 * u + lane;
        }
        m += __popc(set);
      }
    }
    __syncwarp();
    // 3-4. a lane a listed chunk: its entries, then the full batches
    for (int m0 = 0; m0 < m; m0 += 32) {
      const bool mine = m0 + lane < m;
      const uint4 q = mine ? chunk_list[m0 + lane] : uint4{};
      const uint32_t wd[4] = {q.x, q.y, q.z, q.w};
      uint32_t nzb[4];
      int cnt = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        nzb[i] = nonzero_bytes(wd[i]);
        cnt += __popc(nzb[i]);
      }
      int incl = cnt;  // inclusive scan of the counts over the lanes
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += v;
      }
      if (cnt) {
        int slot = filled + incl - cnt;
        const int col0 = 16 * index_list[m0 + lane] - off;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          for (uint32_t bits = nzb[i]; bits; bits &= bits - 1u) {
            const int sh = (__ffs(bits) - 1) & ~7;  // the byte's lowest bit
            list[slot++] = ((col0 + 4 * i + (sh >> 3)) << 8) | ((wd[i] >> sh) & 0xffu);
          }
        }
      }
      filled += __shfl_sync(kFull, incl, 31);
      int done = 0;
      while (filled - done >= kBatch) {
        gather_add<TIn, kCpl, kBatch>(acc, list + done, kBatch, fb, c, ch0, vec_f);
        done += kBatch;
      }
      if (done) {  // fewer than kBatch <= 32 entries left: to the front
        filled -= done;
        const int e = lane < filled ? list[done + lane] : 0;
        __syncwarp();
        if (lane < filled) list[lane] = e;
      }
      __syncwarp();
    }
  }
  gather_add<TIn, kCpl, kBatch>(acc, list, filled, fb, c, ch0, vec_f);

  if (ch0 < c) {
    TOut* orow = out + (static_cast<size_t>(b) * nrows + row) * c + ch0;
#pragma unroll
    for (int i = 0; i < kCpl; ++i)
      if (ch0 + i < c) orow[i] = from_float<TOut>(__fmul_rn(acc[i], inv_k));
  }
}

template <typename TIn, typename TOut, int kCpl>
cudaError_t launch(const void* ind, const void* f, void* out, int b, int nrows, int n, int c,
                   float inv_k, cudaStream_t stream) {
  const int vec_f =
      c % kCpl == 0 && reinterpret_cast<uintptr_t>(f) % alignof(Chunk<TIn, kCpl>) == 0;
  const dim3 grid((nrows + kWarps - 1) / kWarps, b, (c + 32 * kCpl - 1) / (32 * kCpl));
  indicator_mean_kernel<TIn, TOut, kCpl><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const int8_t*>(ind), static_cast<const TIn*>(f), static_cast<TOut*>(out),
      nrows, n, c, inv_k, vec_f);
  return cudaGetLastError();
}

template <typename TIn, typename TOut>
cudaError_t by_width(const void* ind, const void* f, void* out, int b, int nrows, int n, int c,
                     float inv_k, cudaStream_t s) {
  if (c <= 32) return launch<TIn, TOut, 1>(ind, f, out, b, nrows, n, c, inv_k, s);
  if (c <= 64) return launch<TIn, TOut, 2>(ind, f, out, b, nrows, n, c, inv_k, s);
  if (c <= 128) return launch<TIn, TOut, 4>(ind, f, out, b, nrows, n, c, inv_k, s);
  return launch<TIn, TOut, 8>(ind, f, out, b, nrows, n, c, inv_k, s);
}

}  // namespace

// ind: [B, Nr, N] int8; f: [B, N, C] in bf16 (in_bf16 = 1) or fp32; out:
// [B, Nr, C] in bf16 (out_bf16 = 1) or fp32; all contiguous. N below 2^23
// (an entry holds the column in 23 bits). Launches on `stream`, does not
// synchronise. Returns the launch's cudaError_t (0 = ok).
extern "C" int indicator_mean_launch(const void* ind, const void* f, void* out, int b,
                                     int nrows, int n, int c, int in_bf16, int out_bf16,
                                     float inv_k, void* stream) {
  if (b < 1 || b > 65535 || nrows < 1 || n < 1 || n >= (1 << 23) || c < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (in_bf16 && out_bf16) return by_width<bf16, bf16>(ind, f, out, b, nrows, n, c, inv_k, s);
  if (in_bf16) return by_width<bf16, float>(ind, f, out, b, nrows, n, c, inv_k, s);
  if (out_bf16) return by_width<float, bf16>(ind, f, out, b, nrows, n, c, inv_k, s);
  return by_width<float, float>(ind, f, out, b, nrows, n, c, inv_k, s);
}
