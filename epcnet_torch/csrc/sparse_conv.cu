// K11: a sparse voxel convolution over a kernel map (gather-GEMM), for Hopper.
//
// Replaces no TPU kernel: the JAX package has no sparse convolution. It is
// MinkLoc3Dv2's convolution (models/minkloc.py, ops/sparse.py), which
// MinkowskiEngine computes with its own CUDA kernels; no PyTorch call
// gathers rows by an offset table and multiplies each by its offset's
// weight.
//
// What it computes. A kernel map is a table nbr [rows_out, K] int32: the
// input row of output row u at offset o, or -1 where that voxel does not
// exist. With W [K, Cin, Cout] bf16,
//   out[u] = sum over the offsets o with nbr[u, o] >= 0 of x[nbr[u, o]] W_o,
// bf16 operands, fp32 sums, the result rounded once to bf16. No bias.
//
// Bound on this card: the gathers. A 3^3 map at MinkLoc3Dv2's widths has
// 2 Cin Cout operations a pair (2 * 27 * 64 * 64 = 0.22 MFLOP a row if all
// 27 neighbours existed), far below the tensor cores' 295 operations a
// byte; each pair reads a Cin-wide bf16 row (128-256 bytes) that the map
// picks. Counted as the work needs it (each input row, weight and output
// row once: bench_h100/counts_sparse.py), the convolutions are bound by
// their bytes; the gathers re-read rows from L2, where a stride's features
// (1-15 MB at B=32) stay.
//
// Design (the tiled kernel, Cin a multiple of 32): a block owns 64 output
// rows and all Cout columns. It loads its 64 x K slice of the table into
// shared memory once and lists the offsets that any of its rows has (a
// ballot), so offsets no row of the tile has cost nothing (on the sparse
// voxels at stride 2 most of a 3^3 kernel is empty). It then walks
// (live offset, 32-channel chunk) steps through a 3-stage cp.async ring:
// each step gathers 64 rows x 32 channels of x (one 16-byte copy a thread;
// a missing input is zero-filled by the copy's source size 0) and the
// 32 x Cout slice of W_o, and 8 warps multiply them with bf16 WMMA
// (mma.sync) into fp32 fragments, a warp on a 32 x Cout/4 (or 16 x 16)
// part of the tile. The epilogue rounds each fragment to bf16 through a
// 1 KB per-warp staging tile, 16-byte stores. Sums run over the offsets in
// ascending order, and within one in the tensor cores' order: within an
// fp32 rounding of ops/sparse.py::sparse_conv_plain (card test: within one
// bf16 ulp).
//
// The one-input-channel kernel (conv0: Cin 1, 5^3 = 125 offsets): a warp a
// row, each lane two output channels of every 64; the lanes read 32 of the
// row's offsets at a time, a ballot lists the present ones, and the warp
// adds x * W_o for each in ascending order, each product and sum rounded on
// its own (-fmad=false): bit-equal to the plain version's offset-ordered
// index_add.
//
// Compiled for MinkLoc3Dv2's shapes only (ops/sparse.py::K11_SHAPES).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;       // 8 warps
constexpr int kRows = 64;           // output rows a block
constexpr int kChunk = 32;          // input channels a step
constexpr int kStages = 3;          // the cp.async ring
constexpr int kMaxOffsets = 32;     // K of the tiled kernel
constexpr int kLdA = kChunk + 8;    // padded rows of the staged tiles (bf16)
constexpr int kC1Rows = 8;          // rows a block of the one-channel kernel
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int CIN, int COUT>
struct Tile {
  static constexpr int kLdB = COUT + 8;
  static constexpr int kA = kRows * kLdA;    // bf16 a stage
  static constexpr int kB = kChunk * kLdB;   // bf16 a stage
  static constexpr int kChunks = CIN / kChunk;
  static constexpr int kWarpsN = COUT / 16 < 4 ? COUT / 16 : 4;
  static constexpr int kWarpsM = 8 / kWarpsN;
  static constexpr int kFM = kRows / 16 / kWarpsM;  // fragments a warp, down
  static constexpr int kFN = COUT / 16 / kWarpsN;   // and across
  static constexpr size_t kSmem =
      static_cast<size_t>(kStages) * (kA + kB) * 2   // the ring
      + kRows * kMaxOffsets * 4                       // the tile's table
      + 8 * 256 * 4;                                  // the epilogue's staging
  static_assert(CIN % kChunk == 0 && COUT % 16 == 0 && kRows % (16 * kWarpsM) == 0, "shape");
};

// x: [rows_in, CIN] bf16; nbr: [rows_out, k] int32 (k <= kMaxOffsets), ids
// in [0, rows_in) or -1; w: [k, CIN, COUT] bf16; out: [rows_out, COUT] bf16.
template <int CIN, int COUT>
__global__ void __launch_bounds__(kThreads)
    sparse_conv_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ nbr,
                       const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ out,
                       int rows_out, int k) {
  using T = Tile<CIN, COUT>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sb = sa + kStages * T::kA;
  int* sn = reinterpret_cast<int*>(sb + kStages * T::kB);
  float* se = reinterpret_cast<float*>(sn + kRows * kMaxOffsets);
  __shared__ int s_off[kMaxOffsets];
  __shared__ int s_live;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows), rows_out - row0));

  // the tile's slice of the table, contiguous in nbr
  for (int e = tid; e < kRows * k; e += kThreads) {
    const int r = e / k, o = e - r * k;
    sn[r * kMaxOffsets + o] = r < rows ? __ldcs(nbr + row0 * k + e) : -1;
  }
  __syncthreads();
  if (warp == 0) {  // the offsets any row of the tile has, in ascending order
    bool any = false;
    if (lane < k) {
      for (int r = 0; r < kRows; ++r) any |= sn[r * kMaxOffsets + lane] >= 0;
    }
    const unsigned live = __ballot_sync(kFull, any);
    if (any) s_off[__popc(live & ((1u << lane) - 1u))] = lane;
    if (lane == 0) s_live = __popc(live);
  }
  __syncthreads();
  const int steps = s_live * T::kChunks;

  auto load = [&](int t, int stage) {
    const int o = s_off[t / T::kChunks], c0 = (t % T::kChunks) * kChunk;
    {  // 64 rows x 32 channels of x: one 16-byte copy a thread
      const int r = tid / 4, v = tid % 4;
      const int src = sn[r * kMaxOffsets + o];
      const __nv_bfloat16* g =
          src >= 0 ? x + static_cast<long long>(src) * CIN + c0 + v * 8 : x;
      cp_async16(sa + stage * T::kA + r * kLdA + v * 8, g, src >= 0);
    }
    const __nv_bfloat16* wb = w + (static_cast<long long>(o) * CIN + c0) * COUT;
    constexpr int kVecB = kChunk * COUT / 8;  // 32 rows x COUT of W_o
    for (int e = tid; e < kVecB; e += kThreads) {
      const int r = e / (COUT / 8), v = e % (COUT / 8);
      cp_async16(sb + stage * T::kB + r * T::kLdB + v * 8, wb + r * COUT + v * 8, true);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::kFM][T::kFN];
#pragma unroll
  for (int i = 0; i < T::kFM; ++i)
#pragma unroll
    for (int j = 0; j < T::kFN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();  // step t's copies (this thread's) are in
    __syncthreads();               // everyone's are, and step t - 1 is read
    if (t + kStages - 1 < steps) load(t + kStages - 1, (t + kStages - 1) % kStages);
    cp_async_commit();
    const __nv_bfloat16* as = sa + (t % kStages) * T::kA;
    const __nv_bfloat16* bs = sb + (t % kStages) * T::kB;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[T::kFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[T::kFN];
#pragma unroll
      for (int i = 0; i < T::kFM; ++i)
        wmma::load_matrix_sync(a[i], as + (wm * T::kFM + i) * 16 * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < T::kFN; ++j)
        wmma::load_matrix_sync(b[j], bs + kk * T::kLdB + (wn * T::kFN + j) * 16, T::kLdB);
#pragma unroll
      for (int i = 0; i < T::kFM; ++i)
#pragma unroll
        for (int j = 0; j < T::kFN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  float* stage = se + warp * 256;
  const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < T::kFM; ++i) {
#pragma unroll
    for (int j = 0; j < T::kFN; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long row = row0 + (wm * T::kFM + i) * 16 + r;
      if (row < rows_out) {
        const float* v = stage + r * 16 + c;
        union {
          __nv_bfloat162 h[4];
          uint4 u;
        } pk;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pk.h[e] = __float22bfloat162_rn(make_float2(v[2 * e], v[2 * e + 1]));
        *reinterpret_cast<uint4*>(out + row * COUT + (wn * T::kFN + j) * 16 + c) = pk.u;
      }
      __syncwarp();
    }
  }
}

// The one-input-channel convolution: x [rows_in] bf16, nbr [rows_out, k]
// (any k), w [k, 1, COUT] bf16, out [rows_out, COUT] bf16; a warp a row.
template <int COUT>
__global__ void __launch_bounds__(kC1Rows * 32)
    sparse_conv_c1_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ nbr,
                          const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ out,
                          int rows_out, int k) {
  constexpr int V = COUT / 64;  // bf16 pairs a lane
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kC1Rows + threadIdx.x / 32;
  if (row >= rows_out) return;  // the whole warp: the ballots stay uniform
  float acc[V][2];
#pragma unroll
  for (int q = 0; q < V; ++q) acc[q][0] = acc[q][1] = 0.f;
  for (int o0 = 0; o0 < k; o0 += 32) {
    const int o = o0 + lane;
    const int id = o < k ? __ldcs(nbr + row * k + o) : -1;
    const float xv = id >= 0 ? __bfloat162float(x[id]) : 0.f;
    unsigned m = __ballot_sync(kFull, id >= 0);
    while (m) {
      const int j = __ffs(m) - 1;
      m &= m - 1;
      const float v = __shfl_sync(kFull, xv, j);
      const __nv_bfloat162* wr =
          reinterpret_cast<const __nv_bfloat162*>(w + static_cast<long long>(o0 + j) * COUT);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float2 wf = __bfloat1622float2(__ldg(wr + lane + 32 * q));
        acc[q][0] = __fadd_rn(acc[q][0], __fmul_rn(v, wf.x));
        acc[q][1] = __fadd_rn(acc[q][1], __fmul_rn(v, wf.y));
      }
    }
  }
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(out + row * COUT);
#pragma unroll
  for (int q = 0; q < V; ++q)
    o2[lane + 32 * q] = __float22bfloat162_rn(make_float2(acc[q][0], acc[q][1]));
}

template <int CIN, int COUT>
int launch_tiled(const __nv_bfloat16* x, const int* nbr, const __nv_bfloat16* w,
                 __nv_bfloat16* out, int rows_out, int k, cudaStream_t s) {
  using T = Tile<CIN, COUT>;
  // the shared-memory attribute is set once a device, so that a launch
  // inside a CUDA graph's capture makes no such call
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(sparse_conv_kernel<CIN, COUT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(T::kSmem));
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const long long blocks = (static_cast<long long>(rows_out) + kRows - 1) / kRows;
  sparse_conv_kernel<CIN, COUT><<<static_cast<unsigned>(blocks), kThreads, T::kSmem, s>>>(
      x, nbr, w, out, rows_out, k);
  return cudaGetLastError();
}

template <int COUT>
int launch_c1(const __nv_bfloat16* x, const int* nbr, const __nv_bfloat16* w,
              __nv_bfloat16* out, int rows_out, int k, cudaStream_t s) {
  const long long blocks = (static_cast<long long>(rows_out) + kC1Rows - 1) / kC1Rows;
  sparse_conv_c1_kernel<COUT><<<static_cast<unsigned>(blocks), kC1Rows * 32, 0, s>>>(
      x, nbr, w, out, rows_out, k);
  return cudaGetLastError();
}

}  // namespace

// x: [rows_in, cin] bf16, contiguous, 16-byte aligned; nbr: [rows_out, k]
// int32, contiguous, each entry -1 or in [0, rows_in); w: [k, cin, cout]
// bf16, contiguous; out: [rows_out, cout] bf16. (cin, cout) is (1, 64), any
// k >= 1, or one of MinkLoc3Dv2's (32, 32), (64, 32), (64, 64), (64, 128),
// (128, 64), (128, 128), (256, 256) with 1 <= k <= 32. Launches on
// `stream`, does not synchronise. Returns the launch's cudaError_t (0 = ok;
// rows_out = 0 launches nothing).
extern "C" int sparse_conv_launch(const void* x, const void* nbr, const void* w, void* out,
                                  int rows_out, int k, int cin, int cout, void* stream) {
  if (rows_out < 0 || k < 1 || (cin > 1 && k > kMaxOffsets)) return cudaErrorInvalidValue;
  if (rows_out == 0) return cudaSuccess;
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const int* np = static_cast<const int*>(nbr);
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(w);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K11_CASE(CI, CO) \
  if (cin == CI && cout == CO) return launch_tiled<CI, CO>(xp, np, wp, op, rows_out, k, s);
  if (cin == 1 && cout == 64) return launch_c1<64>(xp, np, wp, op, rows_out, k, s);
  K11_CASE(32, 32)
  K11_CASE(64, 32)
  K11_CASE(64, 64)
  K11_CASE(64, 128)
  K11_CASE(128, 64)
  K11_CASE(128, 128)
  K11_CASE(256, 256)
#undef K11_CASE
  return cudaErrorInvalidValue;
}
