// K5: the phase prefix of the kNN selection, for the phase ablation of the
// kNN trace (epcnet_torch/scripts/knn_trace.py), for Hopper.
//
// Replaces the TPU kernel scripts/hw_knn_trace.py::_kern_phase (launched at
// :104): K1 stopped after its distance slab and r value rounds, optionally
// followed by the threshold count.
//
// What it computes, per cloud b and query row i (N points, rounds r >= 1):
//   d[i, j] as in knn_core.cuh (fp32, bit-equal to ops/pairwise.py);
//   m = the r-th smallest DISTINCT value of d[i, :], or +inf when the row
//       has fewer than r distinct values: what r rounds of "take the minimum,
//       then mask every d <= minimum" give;
//   out[b, i] = m, or with thresh m + 1e-20 * cnt (product and sum each
//       rounded once in fp32), cnt = #{j : d[i, j] <= m}.
// The TPU kernel broadcasts out over 128 lanes, a Mosaic layout artifact;
// the output here is [B, N] fp32.
//
// Bound on this card: operations. One pass over the row is 8 fp32
// instructions a pair (3 subtractions, 3 products, 2 sums; no FMA, so that
// they stay bit-equal): 4.0 us a cloud at N=4096 and 0.26 ms at N=32768, at
// 33.4e12 fp32 instructions a second. The output is 4 bytes a row.
//
// Design: the phase prefix of the core K1-K3 run, so that the phases time
// what K1 does at the same B and N. The C entry picks the core by r, as
// knn_adj_launch picks K1's by k.
//
// r <= knn_tile::kMaxK (32): knn_tile.cuh's tiled core, its block, tiles,
// cp.async double buffering, own-tile cap, threshold register, warp-wide
// queue flushes and threads a row (S, from launch_split) as they are, with a
// list of distinct values in place of the (d, j) list. Each thread keeps the
// r smallest distinct distances of its columns, sorted, in L registers (L =
// kShortK or kMaxK, the first L - r slots fixed at -inf, so no index is
// dynamic) and, with thresh (a template parameter, so that phase B carries
// no counts), the number of its columns at each. A queued d that equals a
// slot raises its count; one below the last slot is inserted with a shift
// (count 1). A column is queued when d <= the threshold, not d <, since a
// value equal to the current r-th must still be counted. The own tile's
// r-th distinct value caps the scan: one thread's columns are a subset of
// the row, so their r-th distinct value is >= the row's. The S lists of a
// row merge by value, equal values from different threads being one value
// whose counts add; out is the merged r-th value (+inf past the merged
// values), cnt the sum of the merged counts. Rounds = 1 on the 24-slot list
// carries 23 fixed slots through every insertion: phase A includes them.
//
// The scan loop, flush and tile skeleton below are K5's own copies of
// knn_tile.cuh's scan_tile and select_rows, not instantiations of them. The
// list differs in every step those functions fix: values without columns,
// admission by <= where the (d, j) list admits by < (so padding columns are
// NaN, which no compare passes, where that list pads with +inf), a flush
// that counts equal values, and a merge by value that adds counts. Templating select_rows on such a list
// policy would recompile the K1-K3 instantiations that the model runs; the
// copy keeps their code, registers and times as they were.
//
// r > 32 (any r, also past N): the warp-per-row value rounds of
// knn_core.cuh, the first design. One warp owns one row; lane L keeps the
// smallest distance of its columns j = L (mod 32) that lies above the last
// winner; a round takes the warp minimum and refills every lane that held
// it by the core's cooperative rescan; the threshold is one more pass. xyz
// is in shared memory where make_plan puts it (N up to about 18,700) and is
// read from global memory beyond.

#include "knn_core.cuh"
#include "knn_tile.cuh"

namespace {

using namespace knn_core;
namespace kt = knn_tile;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// ---- r <= kt::kMaxK: the tiled core ----------------------------------------

// A thread's distinct values: ld ascending (-inf in the L - r fixed slots,
// +inf where fewer than r were seen), lc the columns at each (kThresh),
// the threshold a column must be at or below to be queued, the cap, and the
// queue (slot i of thread t at qd[i * kThreads + t]).
template <int L, bool kThresh>
struct Distinct {
  float ld[L];
  int lc[L];
  float thr, cap;
  int qn;
};

template <int L, bool kThresh>
__device__ __forceinline__ void reset(Distinct<L, kThresh>& s, int r) {
#pragma unroll
  for (int i = 0; i < L; ++i) {
    s.ld[i] = i < L - r ? -inf() : inf();
    if constexpr (kThresh) s.lc[i] = 0;
  }
  s.thr = s.cap;
  s.qn = 0;
}

// d into the list: counted where a slot holds it, else inserted (count 1)
// when below the last slot. The caller checked d <= ld[L - 1].
template <int L, bool kThresh>
__device__ __forceinline__ void add(Distinct<L, kThresh>& s, float d) {
  bool dup = false;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const bool eq = s.ld[i] == d;
    dup |= eq;
    if constexpr (kThresh) s.lc[i] += eq;
  }
  if (dup) return;
#pragma unroll
  for (int i = L - 1; i > 0; --i) {
    const bool shift = d < s.ld[i - 1];
    const bool put = !shift && d < s.ld[i];
    s.ld[i] = shift ? s.ld[i - 1] : (put ? d : s.ld[i]);
    if constexpr (kThresh) s.lc[i] = shift ? s.lc[i - 1] : (put ? 1 : s.lc[i]);
  }
  if (d < s.ld[0]) {
    s.ld[0] = d;
    if constexpr (kThresh) s.lc[0] = 1;
  }
}

template <int L, bool kThresh>
__device__ __forceinline__ void flush(Distinct<L, kThresh>& s, const float* qd) {
  for (int i = 0; i < s.qn; ++i) {
    const float d = qd[i * kt::kThreads + threadIdx.x];
    if (d <= s.ld[L - 1]) add(s, d);
  }
  s.qn = 0;
  s.thr = fminf(s.ld[L - 1], s.cap);
}

// kt::scan_tile with values alone and d <= thr; columns past cnt are NaN,
// which no compare passes and fminf skips.
template <int S, int L, bool kThresh, bool kWhole>
__device__ __forceinline__ void scan_tile(Distinct<L, kThresh>& s, float* qd, const float* tile,
                                          int cnt, int part, float qx, float qy, float qz) {
  const int end = kWhole ? kt::kTile : cnt;
  for (int m0 = 0; m0 < end; m0 += kt::kGroup * S) {
    float d[kt::kGroup];
#pragma unroll
    for (int u = 0; u < kt::kGroup; ++u) {
      const int m = m0 + u * S + part;
      d[u] = (kWhole || m < cnt)
                 ? kt::sqdist_tile(qx, qy, qz, tile, kWhole ? m : min(m, cnt - 1))
                 : __int_as_float(0x7fffffff);
    }
    float dmin[kt::kGroup / 2];
#pragma unroll
    for (int u = 0; u < kt::kGroup / 2; ++u) dmin[u] = fminf(d[2 * u], d[2 * u + 1]);
#pragma unroll
    for (int w = kt::kGroup / 4; w > 0; w >>= 1)
#pragma unroll
      for (int u = 0; u < w; ++u) dmin[u] = fminf(dmin[2 * u], dmin[2 * u + 1]);
    if (dmin[0] <= s.thr) {
#pragma unroll
      for (int u = 0; u < kt::kGroup; ++u) {
        if (d[u] <= s.thr) {
          qd[s.qn * kt::kThreads + threadIdx.x] = d[u];
          ++s.qn;
        }
      }
    }
    if (__any_sync(kFull, s.qn > kt::kQueue - kt::kGroup)) flush(s, qd);
  }
}

template <int S, int L, bool kThresh>
__device__ __forceinline__ void scan_any(Distinct<L, kThresh>& s, float* qd, const float* tile,
                                         int base, int n, int part, float qx, float qy,
                                         float qz) {
  const int cnt = n - base < kt::kTile ? n - base : kt::kTile;
  if (cnt == kt::kTile) scan_tile<S, L, kThresh, true>(s, qd, tile, cnt, part, qx, qy, qz);
  else scan_tile<S, L, kThresh, false>(s, qd, tile, cnt, part, qx, qy, qz);
}

// Shared memory: the two tiles and the queues; for S > 1 aliased after the
// scan by the threads' lists [kThreads][r] (values, then counts).
__host__ __device__ inline size_t tiled_smem_bytes(int s, int r, bool thresh) {
  const size_t scan = kt::kTilesBytes + static_cast<size_t>(kt::kQueue) * kt::kThreads * 4;
  const size_t lists = s > 1 ? align16(static_cast<size_t>(kt::kThreads) * r * (thresh ? 8 : 4))
                             : 0;
  return scan > lists ? scan : lists;
}

template <int S, int L, bool kThresh>
__global__ void __launch_bounds__(kt::kThreads, 2)
    knn_phase_tiled_kernel(const float* __restrict__ x, int n, int rounds,
                           float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tiles = reinterpret_cast<float*>(smem);
  float* qd = reinterpret_cast<float*>(smem + kt::kTilesBytes);
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kt::rows_per_block(S);
  const float* xb = x + static_cast<size_t>(b) * n * 3;
  const int tid = threadIdx.x;
  const int row = row0 + tid / S, part = tid % S;
  const bool live = row < n;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = __ldg(xb + 3 * row);
    qy = __ldg(xb + 3 * row + 1);
    qz = __ldg(xb + 3 * row + 2);
  }
  Distinct<L, kThresh> s;
  s.cap = inf();
  reset(s, rounds);

  // the scan of kt::select_rows: the own tile's cap, then every tile
  const int n_tiles = (n + kt::kTile - 1) / kt::kTile;
  if (n_tiles > 1) {
    const int own = row0 / kt::kTile * kt::kTile;
    kt::stage_tile(tiles, xb + 3 * static_cast<size_t>(own),
                   n - own < kt::kTile ? n - own : kt::kTile);
    kt::cp_async_wait<0>();
    __syncthreads();
    scan_any<S, L, kThresh>(s, qd, tiles, own, n, part, qx, qy, qz);
    flush(s, qd);
    s.cap = s.ld[L - 1];
    reset(s, rounds);
    __syncthreads();
  }
  kt::stage_tile(tiles, xb, n < kt::kTile ? n : kt::kTile);
  for (int t = 0; t < n_tiles; ++t) {
    const int base = t * kt::kTile;
    if (t + 1 < n_tiles) {
      const int next = base + kt::kTile;
      kt::stage_tile(tiles + ((t + 1) & 1) * 3 * kt::kTile, xb + 3 * static_cast<size_t>(next),
                     n - next < kt::kTile ? n - next : kt::kTile);
      kt::cp_async_wait<1>();
    } else {
      kt::cp_async_wait<0>();
    }
    __syncthreads();
    scan_any<S, L, kThresh>(s, qd, tiles + (t & 1) * 3 * kt::kTile, base, n, part, qx, qy, qz);
    __syncthreads();
  }
  flush(s, qd);

  // the row's r-th distinct value m, and with kThresh the columns at or below it
  float m;
  int cnt = 0;
  if constexpr (S == 1) {
    m = s.ld[L - 1];
    if constexpr (kThresh) {
#pragma unroll
      for (int i = 0; i < L; ++i) cnt += s.lc[i];  // the fixed slots count 0
    }
  } else {
    __syncthreads();  // every queue is drained: the lists overwrite them
    const int off = L - rounds;
    float* ls_d = reinterpret_cast<float*>(smem);
    int* ls_c = reinterpret_cast<int*>(ls_d + kt::kThreads * rounds);
#pragma unroll
    for (int i = 0; i < L; ++i) {
      if (i >= off) {
        ls_d[tid * rounds + i - off] = s.ld[i];
        if constexpr (kThresh) ls_c[tid * rounds + i - off] = s.lc[i];
      }
    }
    __syncthreads();
    m = inf();
    if (part == 0 && live) {  // the S lists of the row, merged by value
      int head[S];
      float hv[S];
#pragma unroll
      for (int p = 0; p < S; ++p) {
        head[p] = 0;
        hv[p] = ls_d[(tid + p) * rounds];
      }
      for (int t = 0; t < rounds; ++t) {
        float v = hv[0];
#pragma unroll
        for (int p = 1; p < S; ++p) v = fminf(v, hv[p]);
        m = v;
        if (v == inf()) break;  // fewer than r distinct values: m is +inf
#pragma unroll
        for (int p = 0; p < S; ++p) {
          if (hv[p] == v) {
            const int e = (tid + p) * rounds + head[p];
            if constexpr (kThresh) cnt += ls_c[e];
            ++head[p];
            hv[p] = head[p] < rounds ? ls_d[e + 1] : inf();
          }
        }
      }
    }
  }
  if (live && part == 0)
    out[static_cast<size_t>(b) * n + row] =
        kThresh ? __fadd_rn(m, __fmul_rn(1e-20f, static_cast<float>(cnt))) : m;
}

template <class Kernel>
cudaError_t launch_tiled(Kernel kernel, int s, const float* x, int b, int n, int rounds,
                         bool thresh, float* out, cudaStream_t stream) {
  const size_t smem = tiled_smem_bytes(s, rounds, thresh);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kt::rows_per_block(s) - 1) / kt::rows_per_block(s), b);
  kernel<<<grid, kt::kThreads, smem, stream>>>(x, n, rounds, out);
  return cudaGetLastError();
}

// ---- r > kt::kMaxK: the value rounds ---------------------------------------

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <bool kSmem>
__global__ void knn_phase_kernel(const float* __restrict__ x, int n, int rounds,
                                 int thresh, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int row = blockIdx.x * warps + warp;

  const int stride = kSmem ? pad_stride(n) : 0;
  const float* xs = stage_xyz<kSmem>(x + static_cast<size_t>(b) * n * 3, n,
                                     reinterpret_cast<float*>(smem), stride);
  __syncthreads();  // the only block-wide barrier: rows past N leave after it
  if (row >= n) return;
  const float qx = coord<kSmem>(xs, stride, 0, row);
  const float qy = coord<kSmem>(xs, stride, 1, row);
  const float qz = coord<kSmem>(xs, stride, 2, row);

  // each lane's smallest distance over its columns j = lane (mod 32)
  float cd = inf();
  for (int j = lane; j < n; j += 32) cd = fminf(cd, sqdist<kSmem>(xs, stride, qx, qy, qz, j));

  float m = inf();
  for (int r = 0; r < rounds; ++r) {
    m = warp_min(cd);
    if (m == inf()) break;  // fewer than `rounds` distinct values: m is +inf
    // refill every lane that held the winning value, one cooperative rescan each
    unsigned lost = __ballot_sync(kFull, cd == m);
    while (lost) {
      const int owner = __ffs(lost) - 1;
      lost &= lost - 1;
      float nd = inf();
      for (int j = owner + 32 * lane; j < n; j += 32 * 32) {
        const float d = sqdist<kSmem>(xs, stride, qx, qy, qz, j);
        if (d > m && d < nd) nd = d;
      }
      nd = warp_min(nd);
      if (lane == owner) cd = nd;
    }
  }

  float res = m;
  if (thresh) {
    int cnt = 0;
    for (int j = lane; j < n; j += 32) cnt += sqdist<kSmem>(xs, stride, qx, qy, qz, j) <= m;
    cnt = warp_sum(cnt);
    res = __fadd_rn(m, __fmul_rn(1e-20f, static_cast<float>(cnt)));
  }
  if (lane == 0) out[static_cast<size_t>(b) * n + row] = res;
}

template <bool kSmem>
cudaError_t launch_rounds(const float* x, int b, int n, int rounds, int thresh, float* out,
                          const Plan& plan, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(knn_phase_kernel<kSmem>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(plan.smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + plan.warps - 1) / plan.warps, b);
  knn_phase_kernel<kSmem><<<grid, plan.warps * 32, plan.smem, stream>>>(x, n, rounds,
                                                                         thresh, out);
  return cudaGetLastError();
}

}  // namespace

// x: [B, N, 3] fp32 contiguous; out: [B, N] fp32. rounds >= 1 (any value,
// also above N); thresh 0 or 1.
//
// The core is picked here, the one place the rule lives: rounds <=
// knn_tile::kMaxK runs the tiled core (on its shorter list for rounds <=
// knn_tile::kShortK), more rounds the value rounds; *tiled (if not NULL) is
// set to 1 for the former, 0 for the latter. split is the tiled core's S,
// the threads a row (1, 2, 4 or 8), or 0 for knn_tile::choose_split's, as
// K1 takes it; an S where the value rounds run is refused.
//
// Launches on `stream`, does not synchronise. Returns the launch's
// cudaError_t (0 = ok).
extern "C" int knn_phase_launch(const float* x, int b, int n, int rounds, int thresh,
                                float* out, int split, int* tiled, void* stream) {
  if (b < 1 || b > 65535 || n < 1 || rounds < 1) return cudaErrorInvalidValue;
  const bool use_tiled = rounds <= kt::kMaxK;
  if (tiled != nullptr) *tiled = use_tiled;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_tiled) {
    return kt::dispatch(split, b, n, rounds, [&](auto sp, auto len) {
      constexpr int S = decltype(sp)::value, L = decltype(len)::value;
      if (thresh)
        return launch_tiled(knn_phase_tiled_kernel<S, L, true>, S, x, b, n, rounds, true, out, s);
      return launch_tiled(knn_phase_tiled_kernel<S, L, false>, S, x, b, n, rounds, false, out, s);
    });
  }
  Plan plan;
  if (split != 0 || !make_plan(n, 0, &plan)) return cudaErrorInvalidValue;
  if (plan.in_smem) return launch_rounds<true>(x, b, n, rounds, thresh != 0, out, plan, s);
  return launch_rounds<false>(x, b, n, rounds, thresh != 0, out, plan, s);
}

// Where the value rounds (rounds > 32) keep xyz for a cloud of N points: 1
// in shared memory, 0 read from global memory, -1 when they would refuse N.
extern "C" int knn_phase_xyz_in_smem(int n) {
  Plan plan;
  if (n < 1 || !make_plan(n, 0, &plan)) return -1;
  return plan.in_smem ? 1 : 0;
}
