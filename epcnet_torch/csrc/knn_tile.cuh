// The tiled selection core of K1, K2 and K3 (knn_adj.cu, knn_ids.cu):
// exact (distance, index) kNN for k <= kMaxK, built for Hopper. K5
// (knn_phase.cu) runs its phase prefix and K6 (knn_pipelined.cu) its
// selection fed by a producer warp, from the parts below.
//
// Per cloud b and query row i (N points, 1 <= k <= min(N, kMaxK)), the same
// result as knn_core.cuh's select_k:
//   d[i, j] = ((dx*dx) + dy*dy) + dz*dz in fp32, each product and sum rounded
//             on its own (no FMA), in coordinate order: bit-equal to
//             epcnet_torch/ops/pairwise.py;
//   the k winners are the k smallest (d[i, j], j) in lexicographic order
//   (self included, ties to the lowest index), ranked in that order.
//
// Design. A block of kThreads threads owns kThreads / S query rows; S
// consecutive threads share a row, thread `part` taking the columns
// j = part (mod S) of each tile. The cloud streams through shared memory in
// tiles of kTile points, double-buffered with cp.async: 4-byte copies
// transpose each tile into three planes (x, y, z), so a warp's S threads that
// differ read S neighbouring floats (a broadcast to the rest, no bank
// conflict), and at S = 1 the compiler fuses a group's four neighbouring x
// into one LDS.128 (one padded float4 a point, one LDS.128 a point, was
// slower on the H100). L2 traffic is 12 N bytes a block instead of 12 N
// bytes a row.
//
// Each thread keeps its running top-k, sorted, in two register arrays of the
// compile-time size L (kMaxK, or kShortK where k allows: each insertion
// shifts L slots): the first L - k slots hold (-inf, -1) and never move, so
// the k-th entry is always slot L - 1 and no index is dynamic.
// A column is rejected by one compare with a threshold register; one that
// passes goes into the thread's queue in shared memory (kQueue slots), and
// every kGroup columns, when some lane's queue could overflow, the warp
// drains all its queues together into the sorted lists (an unrolled,
// predicated shift per entry). Insertions thus cost the warp once per
// flush, not once per lane that passes. A thread visits its columns in
// ascending j, so "strictly below the k-th, after every entry of equal d"
// keeps its list in (d, j) order.
//
// Before the scan, when the cloud spans more than one tile, each thread
// selects over the block's own tile (the one holding its first row) and
// keeps that list's k-th distance as a cap: no winner is farther, so the
// scan passes only d <= cap. In a cloud stored in scan order (lidar rings,
// a sorted axis) the cap is near the final k-th distance and most columns
// fail the compare; in a random order it saves the first k ln(1024/k)
// insertions. The S lists of a row are then merged through shared memory
// with lex_less. The caller's epilogue writes from the merged lists, which
// lie in shared memory as [rows][k] (d, j), rank order.

#pragma once

#include <type_traits>

#include "knn_core.cuh"

namespace knn_tile {

using knn_core::lex_less;

constexpr int kThreads = 256;  // a block
constexpr int kTile = 1024;    // points a tile (12 KB as three planes)
constexpr int kMaxK = 32;      // the register list's size: k <= kMaxK
constexpr int kShortK = 24;    // the shorter list, for k <= kShortK
constexpr int kQueue = 16;     // queued candidates a thread
constexpr int kGroup = 8;      // columns a thread between flush checks

constexpr size_t kTilesBytes = 2 * 3 * kTile * 4;  // two tiles
constexpr size_t kQueueBytes = static_cast<size_t>(kQueue) * kThreads * 8;

__host__ __device__ constexpr int rows_per_block(int s) { return kThreads / s; }

// Dynamic shared memory: the two tiles and the queues, aliased after the
// scan by the threads' lists [kThreads][k], then the merged lists [rows][k]
// when S > 1.
__host__ __device__ inline size_t lists_bytes(int k) {
  return knn_core::align16(static_cast<size_t>(kThreads) * k * 8);
}
__host__ __device__ inline size_t merged_offset(int k) {
  return kTilesBytes + kQueueBytes > lists_bytes(k) ? kTilesBytes + kQueueBytes
                                                    : lists_bytes(k);
}
__host__ __device__ inline size_t smem_bytes(int s, int k) {
  return merged_offset(k) + (s > 1 ? static_cast<size_t>(rows_per_block(s)) * k * 8 : 0);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Start copying `cnt` points ([cnt, 3] floats at src) into the planes of a
// tile: coordinate c of point p at dst[c * kTile + p].
__device__ __forceinline__ void stage_tile(float* dst, const float* src, int cnt) {
  for (int f = threadIdx.x; f < 3 * cnt; f += kThreads) {
    const int p = f / 3;
    cp_async4(dst + (f - 3 * p) * kTile + p, src + f);
  }
  cp_async_commit();
}

// d between the query and point m of a tile, as knn_core::sqdist.
__device__ __forceinline__ float sqdist_tile(float qx, float qy, float qz, const float* tile,
                                             int m) {
  const float dx = __fsub_rn(qx, tile[m]);
  const float dy = __fsub_rn(qy, tile[kTile + m]);
  const float dz = __fsub_rn(qz, tile[2 * kTile + m]);
  float d = __fmul_rn(dx, dx);
  d = __fadd_rn(d, __fmul_rn(dy, dy));
  return __fadd_rn(d, __fmul_rn(dz, dz));
}

// Put (d, j) into the sorted list; the caller checked d < ld[L - 1].
template <int L>
__device__ __forceinline__ void insert(float (&ld)[L], int (&lj)[L], float d, int j) {
#pragma unroll
  for (int i = L - 1; i > 0; --i) {
    const bool shift = d < ld[i - 1];
    const bool put = !shift && d < ld[i];
    ld[i] = shift ? ld[i - 1] : (put ? d : ld[i]);
    lj[i] = shift ? lj[i - 1] : (put ? j : lj[i]);
  }
  if (d < ld[0]) {
    ld[0] = d;
    lj[0] = j;
  }
}

// A thread's selection state: the sorted list, the threshold a column must
// be below to be queued, the cap (+inf, or just above the own tile's k-th
// distance), and the queue (slot i of thread t at qd[i * kThreads + t]).
template <int L>
struct Sel {
  float ld[L];
  int lj[L];
  float thr, cap;
  int qn;
};

template <int L>
__device__ __forceinline__ void reset(Sel<L>& s, int k) {
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const bool fixed = i < L - k;
    s.ld[i] = fixed ? -__int_as_float(0x7f800000) : __int_as_float(0x7f800000);
    s.lj[i] = fixed ? -1 : INT_MAX;
  }
  s.thr = s.cap;
  s.qn = 0;
}

// Insert this thread's queue, in order, into its list.
template <int L>
__device__ __forceinline__ void flush(Sel<L>& s, const float* qd, const int* qj) {
  for (int i = 0; i < s.qn; ++i) {
    const float d = qd[i * kThreads + threadIdx.x];
    if (d < s.ld[L - 1]) insert(s.ld, s.lj, d, qj[i * kThreads + threadIdx.x]);
  }
  s.qn = 0;
  s.thr = fminf(s.ld[L - 1], s.cap);
}

// Queue the group's distances d[u], of columns j0 + u * S, that pass the
// threshold; then, when some lane's queue could overflow (a warp vote:
// every lane of the warp calls it as often), flush the warp's queues. One
// compare of the group's least distance rejects a whole group.
template <int S, int L>
__device__ __forceinline__ void queue_group(Sel<L>& s, float* qd, int* qj,
                                            const float (&d)[kGroup], int j0) {
  float dmin[kGroup / 2];
#pragma unroll
  for (int u = 0; u < kGroup / 2; ++u) dmin[u] = fminf(d[2 * u], d[2 * u + 1]);
#pragma unroll
  for (int w = kGroup / 4; w > 0; w >>= 1)
#pragma unroll
    for (int u = 0; u < w; ++u) dmin[u] = fminf(dmin[2 * u], dmin[2 * u + 1]);
  if (dmin[0] < s.thr) {
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (d[u] < s.thr) {
        qd[s.qn * kThreads + threadIdx.x] = d[u];
        qj[s.qn * kThreads + threadIdx.x] = j0 + u * S;
        ++s.qn;
      }
    }
  }
  if (__any_sync(knn_core::kFull, s.qn > kQueue - kGroup)) flush(s, qd, qj);
}

// Queue this thread's columns base + m (m = part, part + S, ... < cnt) of
// the tile that pass the threshold; kWhole: cnt == kTile.
template <int S, int L, bool kWhole>
__device__ __forceinline__ void scan_tile(Sel<L>& s, float* qd, int* qj, const float* tile,
                                          int base, int cnt, int part, float qx, float qy,
                                          float qz) {
  const int end = kWhole ? kTile : cnt;
  for (int m0 = 0; m0 < end; m0 += kGroup * S) {
    // the group's loads and distances first: the queue's stores could
    // alias the tile for the compiler and would hold the next load back
    float d[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int m = m0 + u * S + part;
      d[u] = (kWhole || m < cnt)
                 ? sqdist_tile(qx, qy, qz, tile, kWhole ? m : min(m, cnt - 1))
                 : __int_as_float(0x7f800000);
    }
    queue_group<S, L>(s, qd, qj, d, base + m0 + part);
  }
}

template <int S, int L>
__device__ __forceinline__ void scan_any(Sel<L>& s, float* qd, int* qj, const float* tile,
                                         int base, int n, int part, float qx, float qy,
                                         float qz) {
  const int cnt = n - base < kTile ? n - base : kTile;
  if (cnt == kTile) scan_tile<S, L, true>(s, qd, qj, tile, base, cnt, part, qx, qy, qz);
  else scan_tile<S, L, false>(s, qd, qj, tile, base, cnt, part, qx, qy, qz);
}

// This thread's k real slots into ls_d / ls_j, [kThreads][k].
template <int L>
__device__ __forceinline__ void store_list(const Sel<L>& s, int k, float* ls_d, int* ls_j) {
  const int off = L - k;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    if (i >= off) {
      ls_d[threadIdx.x * k + i - off] = s.ld[i];
      ls_j[threadIdx.x * k + i - off] = s.lj[i];
    }
  }
}

// The S lists ls_d / ls_j of the row whose first thread is threadIdx.x,
// merged by lex_less into row threadIdx.x / S of od / oj, [rows][k].
template <int S>
__device__ __forceinline__ void merge_lists(const float* ls_d, const int* ls_j, int k,
                                            float* od, int* oj) {
  const int tid = threadIdx.x;
  const int r_local = tid / S;
  int head[S];
#pragma unroll
  for (int p = 0; p < S; ++p) head[p] = 0;
  for (int r = 0; r < k; ++r) {
    float bd = __int_as_float(0x7f800000);
    int bj = INT_MAX, bp = 0;
#pragma unroll
    for (int p = 0; p < S; ++p) {
      if (head[p] < k) {
        const int e = (tid + p) * k + head[p];
        if (lex_less(ls_d[e], ls_j[e], bd, bj)) {
          bd = ls_d[e];
          bj = ls_j[e];
          bp = p;
        }
      }
    }
#pragma unroll
    for (int p = 0; p < S; ++p) head[p] += p == bp;
    od[r_local * k + r] = bd;
    oj[r_local * k + r] = bj;
  }
}

// The k winners of rows row0 .. row0 + kThreads / S - 1 of cloud xb [n, 3]
// (rows past n are computed for the warp votes and then dropped), on lists
// of L >= k slots. Every thread of the block calls it. On return (after a
// barrier) od/oj point at the merged lists in shared memory, [rows][k],
// rank order.
template <int S, int L>
__device__ __forceinline__ void select_rows(const float* __restrict__ xb, int n, int k,
                                            int row0, unsigned char* smem, float*& od,
                                            int*& oj) {
  float* tiles = reinterpret_cast<float*>(smem);
  float* qd = reinterpret_cast<float*>(smem + kTilesBytes);
  int* qj = reinterpret_cast<int*>(smem + kTilesBytes + kQueueBytes / 2);
  const int tid = threadIdx.x;
  const int row = row0 + tid / S, part = tid % S;
  const bool live = row < n;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = __ldg(xb + 3 * row);
    qy = __ldg(xb + 3 * row + 1);
    qz = __ldg(xb + 3 * row + 2);
  }
  Sel<L> s;
  s.cap = __int_as_float(0x7f800000);
  reset(s, k);

  const int n_tiles = (n + kTile - 1) / kTile;
  if (n_tiles > 1) {  // the cap, from the block's own tile
    const int own = row0 / kTile * kTile;
    stage_tile(tiles, xb + 3 * static_cast<size_t>(own), n - own < kTile ? n - own : kTile);
    cp_async_wait<0>();
    __syncthreads();
    scan_any<S, L>(s, qd, qj, tiles, own, n, part, qx, qy, qz);
    flush(s, qd, qj);
    s.cap = nextafterf(s.ld[L - 1], __int_as_float(0x7f800000));
    reset(s, k);
    __syncthreads();  // the own tile is read: tile 0 goes into its buffer
  }
  stage_tile(tiles, xb, n < kTile ? n : kTile);
  for (int t = 0; t < n_tiles; ++t) {
    const int base = t * kTile;
    if (t + 1 < n_tiles) {
      const int next = base + kTile;
      stage_tile(tiles + ((t + 1) & 1) * 3 * kTile, xb + 3 * static_cast<size_t>(next),
                 n - next < kTile ? n - next : kTile);
      cp_async_wait<1>();  // this thread's copies of tile t have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // everyone's copies of tile t have landed
    scan_any<S, L>(s, qd, qj, tiles + (t & 1) * 3 * kTile, base, n, part, qx, qy, qz);
    __syncthreads();  // tile t is read: the next iteration refills its buffer
  }
  flush(s, qd, qj);
  __syncthreads();  // every queue is drained: the lists overwrite them

  // each thread's list, its k real slots: [kThreads][k]
  float* ls_d = reinterpret_cast<float*>(smem);
  int* ls_j = reinterpret_cast<int*>(smem + static_cast<size_t>(kThreads) * k * 4);
  store_list(s, k, ls_d, ls_j);
  __syncthreads();
  if constexpr (S == 1) {
    od = ls_d;
    oj = ls_j;
  } else {
    // the S lists of a row, merged by its first thread
    od = reinterpret_cast<float*>(smem + merged_offset(k));
    oj = reinterpret_cast<int*>(od + rows_per_block(S) * k);
    if (part == 0 && live) merge_lists<S>(ls_d, ls_j, k, od, oj);
    __syncthreads();
  }
}

// Zero `bytes` bytes at p with `threads` threads, this one `first` of
// them: byte stores up to 16-byte alignment, then uint4 stores, then the
// tail.
__device__ __forceinline__ void zero_bytes(void* p, size_t bytes, int first, int threads) {
  unsigned char* c = static_cast<unsigned char*>(p);
  size_t head = (16 - (reinterpret_cast<uintptr_t>(c) & 15)) & 15;
  if (head > bytes) head = bytes;
  for (size_t i = first; i < head; i += threads) c[i] = 0;
  const size_t chunks = (bytes - head) >> 4;
  uint4* v = reinterpret_cast<uint4*>(c + head);
  for (size_t i = first; i < chunks; i += threads) v[i] = make_uint4(0u, 0u, 0u, 0u);
  for (size_t i = head + 16 * chunks + first; i < bytes; i += threads) c[i] = 0;
}

// A row's S from the launch size: the largest S in {1, 2, 4, 8} that keeps
// the blocks within one an SM. Below one block an SM, spreading a row over
// more threads fills idle SMs; past it, the extra lists to merge cost more
// than the occupancy buys (the S sweep of chip_smoke.py, PERF.md).
inline int choose_split(int b, int n, int sms) {
  auto blocks = [&](int s) {
    return static_cast<long long>(b) * ((n + rows_per_block(s) - 1) / rows_per_block(s));
  };
  int s = 1;
  while (s < 8 && blocks(2 * s) <= sms) s *= 2;
  return s;
}

// S for a launch: `split` where the caller forces one, else choose_split's
// on the current device.
inline int launch_split(int split, int b, int n) {
  if (split != 0) return split;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return choose_split(b, n, sms);
}

// launch(S, L) with S from launch_split and the list size L that k needs:
// kShortK for k <= kShortK, else kMaxK (each an integral_constant), for the
// C entries, which hold the rest of the rule. An S not in {1, 2, 4, 8} is
// refused.
template <class Launch>
inline cudaError_t dispatch(int split, int b, int n, int k, Launch&& launch) {
  auto by_list = [&](auto s) {
    if (k <= kShortK) return launch(s, std::integral_constant<int, kShortK>());
    return launch(s, std::integral_constant<int, kMaxK>());
  };
  switch (launch_split(split, b, n)) {
    case 1: return by_list(std::integral_constant<int, 1>());
    case 2: return by_list(std::integral_constant<int, 2>());
    case 4: return by_list(std::integral_constant<int, 4>());
    case 8: return by_list(std::integral_constant<int, 8>());
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace knn_tile
