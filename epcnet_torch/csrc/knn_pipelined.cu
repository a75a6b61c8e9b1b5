// K6: the kNN 0/1 indicator adjacency with the cloud produced ahead of the
// selection that consumes it, for the K6-against-K1 comparison of the kNN
// trace (epcnet_torch/scripts/knn_trace.py), for Hopper.
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
// Design: what the TPU variant tried, overlapping the production of the
// selection's input with the selection, in Hopper's form. The C entry picks
// the kernel by k, as knn_adj_launch picks K1's core.
//
// k <= knn_tile::kMaxK (32): K1's tiled selection (knn_tile.cuh; the same
// S from launch_split, lists, queue, cap and merge) fed by a producer warp.
// A block is the 256 consumer threads of K1's block (threadIdx 0-255, so
// the queue's indexing is K1's) and one producer warp (256-287). The
// producer copies each tile of the cloud, the own-tile cap's tile first,
// with a 1-D bulk copy (cp.async.bulk, the TMA) into a ring of kStages
// stages, each with a "full" mbarrier (arrive.expect_tx) and an "empty" one
// that each consumer warp arrives on when it has scanned the stage. A tile
// stays in the input's [cnt, 3] layout: at S = 1 a warp reads one point (a
// broadcast), and reads a whole-tile group as six 16-byte loads where the
// cloud is 16-byte aligned; at S > 1 the S points of a warp's reads are 3
// floats apart, in distinct banks. Bulk copies need 16-byte-aligned
// addresses and sizes: the misaligned head and tail of a tile (at most 3
// floats each; when N % 4 != 0 or the cloud does not start on 16 bytes) are
// loaded by producer lanes, whose arrivals the full barrier counts. The
// consumers never wait at a block barrier while they scan. Once the loads
// are issued, the producer zeroes the block's indicator rows (rows x N
// bytes) with 16-byte stores while the consumers select: K1 zeroes after
// its selection. After a barrier of all 288 threads the consumers store
// each winner's byte, as knn_dense_tiled_kernel does, and sum the proxy in
// rank order from the merged lists.
//
// k > 32: the first design's warp pairs (below), kept for that range, with their N
// limit. Warps come in pairs, a producer and a consumer; each pair owns two
// distance-row buffers in shared memory and one named barrier (bar.sync
// 1 + pair, 64 threads). The pair walks its rows, first = block * pairs +
// pair, then every gridDim.x * pairs rows. In step t the producer writes row
// t+1's distances into one buffer while the consumer selects row t from the
// other; then both meet at the barrier. The consumer runs the value rounds
// of knn_core.cuh on the stored row, marks a bitmask, writes the indicator
// row from it (write_dense_row) and sums the proxy as the winners come. Rows
// are stored with one pad slot per 32 columns (pad_idx). xyz is in shared
// memory when it fits beside one pair's buffers, else read from global
// memory. A pair holds 8 N bytes of shared memory, so N is limited to about
// 27,700 (knn_pipelined_fits).

#include "knn_core.cuh"
#include "knn_tile.cuh"

namespace {

using namespace knn_core;
namespace kt = knn_tile;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---- k <= kt::kMaxK: the tiled core fed by a producer warp ------------------

constexpr int kStages = 4;
constexpr int kConsumerWarps = kt::kThreads / 32;
constexpr int kBlock = kt::kThreads + 32;  // the consumers, then the producer warp
// a stage: a tile's [cnt, 3] floats, starting `a` floats in (the cloud's
// misalignment, 0-3), so that the bulk-copied part lands on 16 bytes
constexpr int kStageFloats = 3 * kt::kTile + 4;
constexpr size_t kBarBytes = 2 * kStages * 8;  // the full barriers, then the empty ones
constexpr size_t kScanBytes = kStages * kStageFloats * 4 + kt::kQueueBytes;
// named barriers (0 is __syncthreads)
constexpr int kBarConsumers = 1;
constexpr int kBarAll = 2;

// Shared memory: the barriers, then the ring and the queues, aliased after
// the scan by the threads' lists [kThreads][k]; then the merged lists
// [rows][k] when S > 1.
__host__ __device__ inline size_t merged_offset(int k) {
  return kBarBytes + (kScanBytes > kt::lists_bytes(k) ? kScanBytes : kt::lists_bytes(k));
}
__host__ __device__ inline size_t tiled_smem_bytes(int s, int k) {
  return merged_offset(k) + (s > 1 ? static_cast<size_t>(kt::rows_per_block(s)) * k * 8 : 0);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The producer warp's part of load i: tile `base` of cloud xb ([n, 3]) into
// its stage. Lane 0 arms the full barrier with the bulk part's bytes and
// issues the copy; lanes 1-6 load the misaligned head and tail floats; the
// other lanes only arrive (the barrier counts 32 arrivals a phase).
__device__ __forceinline__ void produce(float* stage, const float* xb, int n, int base,
                                        uint64_t* full, int lane) {
  const float* src = xb + 3 * static_cast<size_t>(base);
  const int nf = 3 * (n - base < kt::kTile ? n - base : kt::kTile);
  const int a = static_cast<int>(reinterpret_cast<uintptr_t>(src) >> 2) & 3;
  float* dst = stage + a;
  const int head = min((4 - a) & 3, nf);
  const int body = (nf - head) & ~3;
  const int tail = nf - head - body;
  if (lane == 0) {
    // the stage's last readers and writers (the consumers' loads, the head
    // and tail lanes' stores) come before the copy's writes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive_tx(full, static_cast<uint32_t>(body) * 4);
    if (body > 0)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];" ::"r"(smem_u32(dst + head)),
          "l"(src + head), "r"(body * 4), "r"(smem_u32(full))
          : "memory");
  } else {
    const int e = lane - 1;
    if (e < head) dst[e] = __ldg(src + e);
    else if (e < head + tail) dst[body + e] = __ldg(src + body + e);
    mbar_arrive(full);
  }
}

// d between the query and the point (px, py, pz), in kt::sqdist_tile's
// order of operations.
__device__ __forceinline__ float dist3(float qx, float qy, float qz, float px, float py,
                                       float pz) {
  const float dx = __fsub_rn(qx, px);
  const float dy = __fsub_rn(qy, py);
  const float dz = __fsub_rn(qz, pz);
  float d = __fmul_rn(dx, dx);
  d = __fadd_rn(d, __fmul_rn(dy, dy));
  return __fadd_rn(d, __fmul_rn(dz, dz));
}

// kt::scan_tile on a [cnt, 3] tile; kVec (S = 1, a whole tile, 16-byte
// aligned): a group's 8 points as six float4 loads.
template <int S, int L, bool kWhole, bool kVec>
__device__ __forceinline__ void scan_tile(kt::Sel<L>& s, float* qd, int* qj, const float* tile,
                                          int base, int cnt, int part, float qx, float qy,
                                          float qz) {
  const int end = kWhole ? kt::kTile : cnt;
  for (int m0 = 0; m0 < end; m0 += kt::kGroup * S) {
    float d[kt::kGroup];
    if constexpr (kVec) {
      static_assert(S == 1 && kWhole && kt::kGroup == 8, "six float4 hold 8 points");
      const float4* v = reinterpret_cast<const float4*>(tile + 3 * m0);
      float c[3 * kt::kGroup];
#pragma unroll
      for (int w = 0; w < 6; ++w) {
        const float4 f = v[w];
        c[4 * w] = f.x;
        c[4 * w + 1] = f.y;
        c[4 * w + 2] = f.z;
        c[4 * w + 3] = f.w;
      }
#pragma unroll
      for (int u = 0; u < kt::kGroup; ++u)
        d[u] = dist3(qx, qy, qz, c[3 * u], c[3 * u + 1], c[3 * u + 2]);
    } else {
#pragma unroll
      for (int u = 0; u < kt::kGroup; ++u) {
        const int m = m0 + u * S + part;
        const int p = 3 * (kWhole ? m : min(m, cnt - 1));
        d[u] = (kWhole || m < cnt) ? dist3(qx, qy, qz, tile[p], tile[p + 1], tile[p + 2])
                                   : __int_as_float(0x7f800000);
      }
    }
    kt::queue_group<S, L>(s, qd, qj, d, base + m0 + part);
  }
}

template <int S, int L>
__device__ __forceinline__ void scan_any(kt::Sel<L>& s, float* qd, int* qj, const float* tile,
                                         bool aligned, int base, int n, int part, float qx,
                                         float qy, float qz) {
  const int cnt = n - base < kt::kTile ? n - base : kt::kTile;
  if (cnt != kt::kTile)
    scan_tile<S, L, false, false>(s, qd, qj, tile, base, cnt, part, qx, qy, qz);
  else if (S == 1 && aligned)
    scan_tile<S, L, true, S == 1>(s, qd, qj, tile, base, cnt, part, qx, qy, qz);
  else
    scan_tile<S, L, true, false>(s, qd, qj, tile, base, cnt, part, qx, qy, qz);
}

template <int S, int L>
__global__ void __launch_bounds__(kBlock, L == kt::kShortK ? 2 : 1)
    knn_pipelined_tiled_kernel(const float* __restrict__ x, int n, int k,
                               int8_t* __restrict__ adj, float* __restrict__ proxy,
                               float inv_k) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  float* ring = reinterpret_cast<float*>(smem + kBarBytes);
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kt::rows_per_block(S);
  const int rows = min(kt::rows_per_block(S), n - row0);
  const float* xb = x + static_cast<size_t>(b) * n * 3;
  const size_t r0 = static_cast<size_t>(b) * n + row0;
  int8_t* a_rows = adj + r0 * n;
  const int n_tiles = (n + kt::kTile - 1) / kt::kTile;
  const int own = row0 / kt::kTile * kt::kTile;  // the own tile, loaded first when n_tiles > 1

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + st, 32);
      mbar_init(empty + st, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the only block-wide barrier before the end

  if (threadIdx.x >= kt::kThreads) {
    // the producer: every load, then the block's indicator rows zeroed
    const int lane = threadIdx.x & 31;
    int i = 0;
    auto load = [&](int base) {
      const int st = i % kStages, use = i / kStages;
      if (use > 0) mbar_wait(empty + st, (use - 1) & 1);
      produce(ring + st * kStageFloats, xb, n, base, full + st, lane);
      ++i;
    };
    if (n_tiles > 1) load(own);
    for (int t = 0; t < n_tiles; ++t) load(t * kt::kTile);
    kt::zero_bytes(a_rows, static_cast<size_t>(rows) * n, lane, 32);
    bar_sync(kBarAll, kBlock);  // the zeros land before the ones
    return;
  }

  // the consumers: K1's selection on the stages as they arrive
  float* qd = reinterpret_cast<float*>(smem + kBarBytes + kStages * kStageFloats * 4);
  int* qj = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(qd) + kt::kQueueBytes / 2);
  const int tid = threadIdx.x;
  const int row = row0 + tid / S, part = tid % S;
  const bool live = row < n;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = __ldg(xb + 3 * row);
    qy = __ldg(xb + 3 * row + 1);
    qz = __ldg(xb + 3 * row + 2);
  }
  // every tile of the cloud starts `a` floats past 16 bytes (3 kTile floats apart)
  const int a = static_cast<int>(reinterpret_cast<uintptr_t>(xb) >> 2) & 3;
  kt::Sel<L> s;
  s.cap = __int_as_float(0x7f800000);
  kt::reset(s, k);
  int i = 0;
  auto consume = [&](int base) {
    const int st = i % kStages, use = i / kStages;
    mbar_wait(full + st, use & 1);
    scan_any<S, L>(s, qd, qj, ring + st * kStageFloats + a, a == 0, base, n, part, qx, qy, qz);
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(empty + st);
    ++i;
  };
  if (n_tiles > 1) {  // the cap, from the block's own tile
    consume(own);
    kt::flush(s, qd, qj);
    s.cap = nextafterf(s.ld[L - 1], __int_as_float(0x7f800000));
    kt::reset(s, k);
  }
  for (int t = 0; t < n_tiles; ++t) consume(t * kt::kTile);
  kt::flush(s, qd, qj);
  bar_sync(kBarConsumers, kt::kThreads);  // every stage is read: the lists overwrite the ring

  float* ls_d = ring;
  int* ls_j = reinterpret_cast<int*>(ring + kt::kThreads * k);
  kt::store_list(s, k, ls_d, ls_j);
  bar_sync(kBarConsumers, kt::kThreads);
  float* od = ls_d;
  int* oj = ls_j;
  if constexpr (S > 1) {
    od = reinterpret_cast<float*>(smem + merged_offset(k));
    oj = reinterpret_cast<int*>(od + kt::rows_per_block(S) * k);
    if (part == 0 && live) kt::merge_lists<S>(ls_d, ls_j, k, od, oj);
    bar_sync(kBarConsumers, kt::kThreads);
  }
  // the proxy: each row's winners in rank order
  for (int r = tid; r < rows; r += kt::kThreads) {
    const int* rj = oj + r * k;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int t = 0; t < k; ++t) {
      const float* p = xb + 3 * rj[t];
      s0 = __fadd_rn(s0, bf16_round(__ldg(p)));
      s1 = __fadd_rn(s1, bf16_round(__ldg(p + 1)));
      s2 = __fadd_rn(s2, bf16_round(__ldg(p + 2)));
    }
    float* pr = proxy + (r0 + r) * 3;
    pr[0] = __fmul_rn(s0, inv_k);
    pr[1] = __fmul_rn(s1, inv_k);
    pr[2] = __fmul_rn(s2, inv_k);
  }
  bar_sync(kBarAll, kBlock);  // the producer's zeros have landed
  for (int e = tid; e < rows * k; e += kt::kThreads)
    a_rows[static_cast<size_t>(e / k) * n + oj[e]] = 1;
}

template <int S, int L>
cudaError_t launch_tiled(const float* x, int b, int n, int k, int8_t* adj, float* proxy,
                         float inv_k, cudaStream_t stream) {
  const size_t smem = tiled_smem_bytes(S, k);
  cudaError_t err = cudaFuncSetAttribute(knn_pipelined_tiled_kernel<S, L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kt::rows_per_block(S) - 1) / kt::rows_per_block(S), b);
  knn_pipelined_tiled_kernel<S, L><<<grid, kBlock, smem, stream>>>(x, n, k, adj, proxy, inv_k);
  return cudaGetLastError();
}

// ---- k > kt::kMaxK: the warp pairs -----------------------------------------

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

// The producer: row `row`'s distances into dst at pad_idx(j).
template <bool kSmem>
__device__ __forceinline__ void produce_row(const float* xs, int stride, int n, int row,
                                            float* dst, int lane) {
  const float qx = coord<kSmem>(xs, stride, 0, row);
  const float qy = coord<kSmem>(xs, stride, 1, row);
  const float qz = coord<kSmem>(xs, stride, 2, row);
  for (int j = lane; j < n; j += 32) dst[pad_idx(j)] = sqdist<kSmem>(xs, stride, qx, qy, qz, j);
}

// The consumer: the k winners of the stored row `dr`, then the indicator row
// and the proxy.
template <bool kSmem>
__device__ __forceinline__ void consume_row(const float* xs, int stride, int n, int k,
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
    produce_row<kSmem>(xs, stride, n, first, bufs, lane);
    pair_sync(bar);
    for (int t = 0; t < rows; ++t) {
      if (t + 1 < rows)
        produce_row<kSmem>(xs, stride, n, first + (t + 1) * step, bufs + ((t + 1) & 1) * ps,
                           lane);
      pair_sync(bar);
    }
  } else {
    pair_sync(bar);
    for (int t = 0; t < rows; ++t) {
      const size_t r = static_cast<size_t>(b) * n + first + t * step;
      consume_row<kSmem>(xs, stride, n, k, bufs + (t & 1) * ps, mask, lane, adj + r * n,
                         proxy + r * 3, inv_k);
      pair_sync(bar);
    }
  }
}

template <bool kSmem>
cudaError_t launch_pairs(const float* x, int b, int n, int k, int8_t* adj, float* proxy,
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

// x: [B, N, 3] fp32 contiguous, 1 <= k <= N; adj: [B, N, N] int8; proxy:
// [B, N, 3] fp32; inv_k = float(1/k).
//
// The kernel is picked here, the one place the rule lives: k <=
// knn_tile::kMaxK runs the tiled core fed by the producer warp (on its
// shorter list for k <= knn_tile::kShortK), a larger k the warp pairs;
// *tiled (if not NULL) is set to 1 for the former, 0 for the latter. split
// is the tiled core's S, the threads a row (1, 2, 4 or 8), or 0 for
// knn_tile::choose_split's, as K1 takes it; an S where the warp pairs run is
// refused, and so is an N whose pair buffers do not fit (knn_pipelined_fits).
//
// Launches on `stream`, does not synchronise. Returns the launch's
// cudaError_t (0 = ok).
extern "C" int knn_pipelined_launch(const float* x, int b, int n, int k, int8_t* adj,
                                    float* proxy, float inv_k, int split, int* tiled,
                                    void* stream) {
  if (b < 1 || b > 65535 || n < 1 || k < 1 || k > n) return cudaErrorInvalidValue;
  const bool use_tiled = k <= kt::kMaxK;
  if (tiled != nullptr) *tiled = use_tiled;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_tiled) {
    return kt::dispatch(split, b, n, k, [&](auto sp, auto len) {
      return launch_tiled<decltype(sp)::value, decltype(len)::value>(x, b, n, k, adj, proxy,
                                                                     inv_k, s);
    });
  }
  PipePlan plan;
  if (split != 0 || !pipe_plan(n, &plan)) return cudaErrorInvalidValue;
  if (plan.in_smem) return launch_pairs<true>(x, b, n, k, adj, proxy, inv_k, plan, s);
  return launch_pairs<false>(x, b, n, k, adj, proxy, inv_k, plan, s);
}

// 1 when knn_pipelined_launch takes a cloud of N points at this k: always
// for k <= knn_tile::kMaxK; for a larger k when one warp pair's buffers fit
// in a block's shared memory (N up to about 27,700). Else 0.
extern "C" int knn_pipelined_fits(int n, int k) {
  if (n < 1 || k < 1) return 0;
  if (k <= kt::kMaxK) return 1;
  PipePlan plan;
  return pipe_plan(n, &plan) ? 1 : 0;
}
