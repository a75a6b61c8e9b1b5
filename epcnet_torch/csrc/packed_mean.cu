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
// Design (simple and exact first): one warp per row stages the row's W words
// in shared memory, walks plane j = 0..31 and, in each, the words in
// ascending order, a ballot at a time; for each set bit it adds row c of F,
// each lane owning C/32 channels (coalesced reads). That is popcount * C adds
// instead of 2 N C multiply-adds per row, and the planes are read once. The
// walk tests all N bits of the row; skipping empty words is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
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

// grid (ceil(nrows / warps), B, ceil(C / (32 kCpl))); block z owns the
// channels [32 kCpl z, 32 kCpl (z + 1)), lane L the channels L + 32 i.
template <typename TIn, typename TOut, int kCpl>
__global__ void packed_mean_kernel(const uint32_t* __restrict__ planes,
                                   const TIn* __restrict__ f, TOut* __restrict__ out,
                                   int nrows, int w_words, int c, float inv_k) {
  extern __shared__ __align__(16) uint32_t s_words[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int row = blockIdx.x * warps + warp;
  const int ch0 = blockIdx.z * 32 * kCpl + lane;
  if (row >= nrows) return;  // no block-wide barrier follows

  uint32_t* sw = s_words + static_cast<size_t>(warp) * w_words;
  const uint32_t* prow = planes + (static_cast<size_t>(b) * nrows + row) * w_words;
  for (int i = lane; i < w_words; i += 32) sw[i] = prow[i];
  __syncwarp();

  const TIn* fb = f + static_cast<size_t>(b) * 32 * w_words * c;
  float acc[kCpl];
#pragma unroll
  for (int i = 0; i < kCpl; ++i) acc[i] = 0.f;
  for (int j = 0; j < 32; ++j) {
    for (int w0 = 0; w0 < w_words; w0 += 32) {
      const uint32_t word = (w0 + lane < w_words) ? sw[w0 + lane] : 0u;
      uint32_t bits = __ballot_sync(kFull, (word >> j) & 1u);
      while (bits) {
        const int src = __ffs(bits) - 1;
        bits &= bits - 1;
        const TIn* frow = fb + (static_cast<size_t>(j) * w_words + w0 + src) * c;
#pragma unroll
        for (int i = 0; i < kCpl; ++i) {
          const int ch = ch0 + 32 * i;
          if (ch < c) acc[i] = __fadd_rn(acc[i], to_float(frow[ch]));
        }
      }
    }
  }
  TOut* orow = out + (static_cast<size_t>(b) * nrows + row) * c;
#pragma unroll
  for (int i = 0; i < kCpl; ++i) {
    const int ch = ch0 + 32 * i;
    if (ch < c) orow[ch] = from_float<TOut>(__fmul_rn(acc[i], inv_k));
  }
}

template <typename TIn, typename TOut, int kCpl>
cudaError_t launch(const void* planes, const void* f, void* out, int b, int nrows,
                   int w_words, int c, float inv_k, cudaStream_t stream) {
  int warps = kWarps;
  while (warps > 1 && static_cast<size_t>(warps) * w_words * 4 > kMaxSmem) warps >>= 1;
  const size_t smem = static_cast<size_t>(warps) * w_words * 4;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(packed_mean_kernel<TIn, TOut, kCpl>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((nrows + warps - 1) / warps, b, (c + 32 * kCpl - 1) / (32 * kCpl));
  packed_mean_kernel<TIn, TOut, kCpl><<<grid, warps * 32, smem, stream>>>(
      static_cast<const uint32_t*>(planes), static_cast<const TIn*>(f),
      static_cast<TOut*>(out), nrows, w_words, c, inv_k);
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
