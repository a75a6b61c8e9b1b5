// K8: exact-score kNN ids in feature space, for Hopper.
//
// Replaces no TPU kernel: the JAX package has no DGCNN, and every kNN kernel
// it has works on xyz. DGCNN-VLAD (models/dgcnn.py) builds its graph again
// at each EdgeConv layer over that layer's input; layers 1-3 take this
// kernel on the previous layer's bf16 features (D = 64, 64, 128 at the
// published widths).
//
// What it computes, per cloud b and query row i (N points of D bf16
// features, D a multiple of 16 up to 256, 1 <= k <= min(N, 32)):
//   s[i, j] = ||f_j||^2 - 2 <f_i, f_j>, the norms in fp32 from the same
//             bf16 values, the inner products with exact bf16 products
//             summed in fp32 (the tensor cores' order), 2 <.,.> exact and the
//             difference rounded once;
//   ids[b, i, r] = the rank-r winner: the k smallest (s[i, j], j) in
//             lexicographic order, self included (its s is -||f_i||^2, the
//             least any j can have in exact arithmetic), ties to the lowest
//             index; int32.
// The row's own ||f_i||^2 is left out of s: it moves every column alike.
//
// Bound on this card: the products, 2 D bf16 operations a pair on the
// tensor cores (989e12 a second), plus the fp32 subtraction a pair; at
// B=32, N=4096 that is 0.078 ms at D=64 and 0.147 ms at D=128. The bytes
// (the features once, the ids once) are 33-50 MB, 0.01-0.015 ms. The
// selection, a shared-memory read and a compare a pair on the CUDA cores,
// sits between the two.
//
// Design. A block of knn_tile::kThreads threads owns kRows query rows,
// kS = 4 threads a row (thread `part` takes the columns part (mod kS) of
// each tile), the tiled core's layout. The query rows' features stay in
// shared memory; the cloud's features stream through it in tiles of kCols
// points, double-buffered with 16-byte cp.async, with their norms (a first,
// small kernel computes every norm once). For each tile the 8 warps compute
// the [kRows, kCols] inner products with bf16 WMMA (16x16x16, fp32
// accumulate), two 16x16 blocks a warp, into a padded fp32 tile of shared
// memory; then each thread turns its columns into scores and feeds them to
// the tiled core's selection (knn_tile.cuh: a threshold compare, a queue
// per thread, warp-wide flushes into sorted register lists). Each thread
// visits its columns in ascending j, so its list keeps the (s, j) order;
// the kS lists of a row are merged by lex_less. The feature tile's rows
// are padded by 8 bf16 and the score tile's by 4 floats, so the WMMA loads
// and the selection's reads (8 rows x 4 parts a warp) are free of bank
// conflicts.
// Every index into an output is 64-bit.

#include <cuda_bf16.h>
#include <mma.h>

#include "knn_tile.cuh"

namespace {

using namespace nvcuda;
namespace kt = knn_tile;

constexpr int kRows = 64;                  // query rows a block
constexpr int kCols = 64;                  // candidates a tile
constexpr int kS = kt::kThreads / kRows;   // threads a row
constexpr int kScoreLd = kCols + 4;        // floats a row of the score tile
constexpr int kPad = 8;                    // bf16 after each feature row
constexpr int kMaxD = 256;

static_assert(kS * kRows == kt::kThreads, "a row's threads");
static_assert(kCols % (kt::kGroup * kS) == 0, "whole groups a tile");
static_assert(kt::kThreads / 32 == (kRows / 16) * (kCols / 16) / 2, "two blocks a warp");

constexpr size_t kScoreBytes = static_cast<size_t>(kRows) * kScoreLd * 4;
constexpr size_t kNormBytes = 2 * kCols * 4;

// Shared memory while scanning: the queues, the score tile, two tiles of
// norms, the query rows and two candidate tiles.
__host__ __device__ inline size_t scan_bytes(int d) {
  return kt::kQueueBytes + kScoreBytes + kNormBytes +
         static_cast<size_t>(3 * kCols) * (d + kPad) * 2;
}
// After the scan the threads' lists [kThreads][k] alias it from 0; the
// merged lists [kRows][k] follow whichever is larger.
__host__ __device__ inline size_t merged_offset(int d, int k) {
  const size_t a = scan_bytes(d), b = kt::lists_bytes(k);
  return a > b ? a : b;
}
__host__ __device__ inline size_t smem_bytes(int d, int k) {
  return merged_offset(d, k) + static_cast<size_t>(kRows) * k * 8;
}

// A 16-byte copy to shared memory; src_bytes 0 writes zeros and reads
// nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

// Start copying rows first .. first + count - 1 of fb [n, d] into dst, a
// row every ld bf16; rows past n become zeros.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* fb,
                                           int first, int count, int n, int d, int ld) {
  const int chunks = d / 8;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < count * chunks; c += kt::kThreads) {
    const int r = c / chunks, q = c - r * chunks;
    const bool live = first + r < n;
    const __nv_bfloat16* src = fb + static_cast<size_t>(live ? first + r : 0) * d + q * 8;
    cp_async16(dst + r * ld + q * 8, src, live ? 16 : 0);
  }
}

// Candidate tile t (its features and norms) into buffer t & 1.
__device__ __forceinline__ void stage_tile(__nv_bfloat16* ct, float* nrm,
                                           const __nv_bfloat16* fb, const float* nb, int t,
                                           int n, int d, int ld) {
  const int first = t * kCols, buf = t & 1;
  stage_rows(ct + static_cast<size_t>(buf) * kCols * ld, fb, first, kCols, n, d, ld);
  if (threadIdx.x < kCols && first + threadIdx.x < n)
    kt::cp_async4(nrm + buf * kCols + threadIdx.x, nb + first + threadIdx.x);
  kt::cp_async_commit();
}

// norms[r] = sum over c of f[r, c]^2 in fp32 from the bf16 values, each
// product and sum rounded on its own: lane l sums its 8 channels l*8 ..
// in order, then the warp adds the lanes' sums in a fixed tree. One warp a
// row; d <= 256 is at most one 16-byte chunk a lane.
__global__ void knn_features_norms_kernel(const __nv_bfloat16* __restrict__ f, long long rows,
                                          int d, float* __restrict__ norms) {
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;
  float acc = 0.f;
  if (lane * 8 < d) {
    const uint4 v = *reinterpret_cast<const uint4*>(f + static_cast<size_t>(warp) * d + lane * 8);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float x = __bfloat162float(h[c]);
      acc = __fadd_rn(acc, __fmul_rn(x, x));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(knn_core::kFull, acc, off));
  if (lane == 0) norms[warp] = acc;
}

template <int L>
__global__ void __launch_bounds__(kt::kThreads, 2)
    knn_features_tiled_kernel(const __nv_bfloat16* __restrict__ f,
                              const float* __restrict__ norms, int n, int d, int k,
                              int32_t* __restrict__ ids) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int r_local = tid / kS, part = tid % kS;
  const int ld = d + kPad;
  float* qd = reinterpret_cast<float*>(smem);
  int* qj = reinterpret_cast<int*>(smem + kt::kQueueBytes / 2);
  float* sc = reinterpret_cast<float*>(smem + kt::kQueueBytes);
  float* nrm = reinterpret_cast<float*>(smem + kt::kQueueBytes + kScoreBytes);
  __nv_bfloat16* qt =
      reinterpret_cast<__nv_bfloat16*>(smem + kt::kQueueBytes + kScoreBytes + kNormBytes);
  __nv_bfloat16* ct = qt + kRows * ld;
  const __nv_bfloat16* fb = f + static_cast<size_t>(b) * n * d;
  const float* nb = norms + static_cast<size_t>(b) * n;

  // the block's query rows, then tile 0 (one commit group each)
  stage_rows(qt, fb, row0, kRows, n, d, ld);
  kt::cp_async_commit();
  stage_tile(ct, nrm, fb, nb, 0, n, d, ld);

  kt::Sel<L> s;
  s.cap = __int_as_float(0x7f800000);
  kt::reset(s, k);
  // this warp's two 16x16 blocks of the score tile: row block wr, column
  // blocks wc and wc + 1
  const int wr = warp >> 1, wc = (warp & 1) * 2;
  const int n_tiles = (n + kCols - 1) / kCols;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      stage_tile(ct, nrm, fb, nb, t + 1, n, d, ld);
      kt::cp_async_wait<1>();  // this thread's copies of tile t (and the rows) landed
    } else {
      kt::cp_async_wait<0>();
    }
    __syncthreads();  // everyone's copies of tile t have landed
    {
      const __nv_bfloat16* cb = ct + static_cast<size_t>(t & 1) * kCols * ld;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc0, acc1;
      wmma::fill_fragment(acc0, 0.f);
      wmma::fill_fragment(acc1, 0.f);
      for (int kk = 0; kk < d; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b0, b1;
        wmma::load_matrix_sync(a, qt + wr * 16 * ld + kk, ld);
        wmma::load_matrix_sync(b0, cb + wc * 16 * ld + kk, ld);
        wmma::load_matrix_sync(b1, cb + (wc + 1) * 16 * ld + kk, ld);
        wmma::mma_sync(acc0, a, b0, acc0);
        wmma::mma_sync(acc1, a, b1, acc1);
      }
      wmma::store_matrix_sync(sc + wr * 16 * kScoreLd + wc * 16, acc0, kScoreLd,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(sc + wr * 16 * kScoreLd + (wc + 1) * 16, acc1, kScoreLd,
                              wmma::mem_row_major);
    }
    __syncthreads();  // the score tile is whole
    const int base = t * kCols;
    const int cnt = n - base < kCols ? n - base : kCols;
    const float* nt = nrm + (t & 1) * kCols;
    const float* srow = sc + r_local * kScoreLd;
#pragma unroll
    for (int m0 = 0; m0 < kCols; m0 += kt::kGroup * kS) {
      float dd[kt::kGroup];
#pragma unroll
      for (int u = 0; u < kt::kGroup; ++u) {
        const int m = m0 + u * kS + part;
        dd[u] = m < cnt ? __fsub_rn(nt[m], __fmul_rn(2.f, srow[m]))
                        : __int_as_float(0x7f800000);
      }
      kt::queue_group<kS, L>(s, qd, qj, dd, base + m0 + part);
    }
    __syncthreads();  // tile t and the scores are read: the next stage refills them
  }
  kt::flush(s, qd, qj);
  __syncthreads();  // every queue is drained: the lists overwrite them

  float* ls_d = reinterpret_cast<float*>(smem);
  int* ls_j = reinterpret_cast<int*>(smem + static_cast<size_t>(kt::kThreads) * k * 4);
  kt::store_list(s, k, ls_d, ls_j);
  __syncthreads();
  float* od = reinterpret_cast<float*>(smem + merged_offset(d, k));
  int* oj = reinterpret_cast<int*>(od + kRows * k);
  if (part == 0 && row0 + r_local < n) kt::merge_lists<kS>(ls_d, ls_j, k, od, oj);
  __syncthreads();

  const int rows = min(kRows, n - row0);
  const size_t e0 = (static_cast<size_t>(b) * n + row0) * k;
  for (int e = tid; e < rows * k; e += kt::kThreads) ids[e0 + e] = oj[e];
}

template <int L>
cudaError_t launch_tiled(const __nv_bfloat16* f, const float* norms, int b, int n, int d,
                         int k, int32_t* ids, cudaStream_t stream) {
  const size_t smem = smem_bytes(d, k);
  cudaError_t err = cudaFuncSetAttribute(knn_features_tiled_kernel<L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kRows - 1) / kRows, b);
  knn_features_tiled_kernel<L><<<grid, kt::kThreads, smem, stream>>>(f, norms, n, d, k, ids);
  return cudaGetLastError();
}

}  // namespace

// f: [B, N, D] bf16 contiguous, D % 16 == 0 and 16 <= D <= 256;
// 1 <= k <= min(N, knn_tile::kMaxK); norms: [B, N] fp32 scratch, written
// here; ids: [B, N, k] int32. Launches the norms kernel, then the tiled
// kernel (the register list of kShortK slots for k <= kShortK, else
// kMaxK), on `stream`; does not synchronise. Returns the first failing
// launch's cudaError_t (0 = ok).
extern "C" int knn_features_launch(const void* f, int b, int n, int d, int k, float* norms,
                                   int32_t* ids, void* stream) {
  if (b < 1 || b > 65535 || n < 1 || k < 1 || k > n || k > kt::kMaxK || d < 16 ||
      d > kMaxD || d % 16 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* fh = static_cast<const __nv_bfloat16*>(f);
  const long long rows = static_cast<long long>(b) * n;
  constexpr int kNormThreads = 256;
  const long long blocks = (rows * 32 + kNormThreads - 1) / kNormThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  knn_features_norms_kernel<<<static_cast<unsigned>(blocks), kNormThreads, 0, s>>>(
      fh, rows, d, norms);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (k <= kt::kShortK) return launch_tiled<kt::kShortK>(fh, norms, b, n, d, k, ids, s);
  return launch_tiled<kt::kMaxK>(fh, norms, b, n, d, k, ids, s);
}
