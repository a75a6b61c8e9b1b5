// K10: DGCNN's EdgeConv in eval from per-point products, for Hopper.
//
// Replaces no TPU kernel: the JAX package has no DGCNN. It takes the place
// of the published eval EdgeConv on the card (models/dgcnn.py), which built
// the [B, N, k, 2C] edges [x_j - x_i, x_i] (a gather, a subtraction and a
// concat, each a pass over k-wide tensors), ran the Dense over B·N·k rows,
// then BN + LeakyReLU (K9) and a max over k on them: ~13 of its 14 ms a
// batch at B=32, N=4096, k=20 went into making, moving and reducing edges.
//
// What it computes. With W = [W1 | W2] split over its input columns,
// W [x_j - x_i, x_i] = W1 x_j + (W2 - W1) x_i. In eval BN is a fixed
// affine map per channel, increasing where its scale is >= 0 and decreasing
// where it is < 0 (rsqrt(var + eps) > 0), and the LeakyReLU is increasing,
// so the max over j passes inside both. For point i and channel c:
//   out[i, c] = act(bn_c((M[i, c] - Y1[i, c]) + Y2[i, c])),
//   M[i, c] = max over the k ids j of Y1[j, c] where scale[c] >= 0,
//             min over them where scale[c] < 0,
// where Y = [Y1, Y2] = x @ [W1; W2]^T is the caller's [P, 2 Cout] fp32
// product over the points (cuBLAS). The max and min are exact; the
// subtraction and the sum are fp32, each rounded on its own; then
// bn_act.cuh's epilogue (BN's order of operations, the round to bf16, the
// activation). Every step is monotone in M, so this is also the max (min)
// over j of the same rounded function of Y1[j]. ops/edge_max.py::
// edge_max_plain repeats this order of operations; the output is bit-equal
// to it (finite inputs).
//
// Bound on this card: the bytes. Y read once (P x 2 Cout fp32), the ids
// (P x k int32), the output (P x Cout bf16): at B=32, N=4096, k=20, Cout 64
// that is 94 MB (0.028 ms at 3.35 TB/s), 128: 178 MB (0.053 ms), 256: 346 MB
// (0.103 ms); 0.21 ms over DGCNN's four layers. The gathers read k rows of
// Y1 a point again (5.4 GB over the four layers); they come from L2 while a
// cloud's Y1 (1-4 MB) stays there.
//
// Design: a group of L = min(32, Cout / 4) lanes a point (a warp takes two
// points at Cout 64), each lane on V = Cout / (4 L) 16-byte fp32 vectors of
// the row. The group's lanes load the point's k <= 32 ids once, coalesced,
// and __shfl_sync hands each id to the whole group; kU neighbour rows are
// in flight a lane before any is reduced. Each lane reads its channels'
// BN scales before the loop and keeps one running value a channel: the max
// where the scale is >= 0, the min where it is < 0. Blocks take consecutive
// points, so the blocks in flight work on one or two clouds, whose Y1 rows
// stay in the 50 MB L2 while their neighbours gather them. Each lane writes
// its 4 bf16 outputs a vector as one 8-byte store. DGCNN's widths (Cout 64,
// 128, 256) and its LeakyReLU slope (0.2) are the only ones compiled.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bn_act.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kMaxK = 32;  // ids a point
constexpr int kU = 4;      // neighbour rows a lane in flight
constexpr float kSlope = 0.2f;  // DGCNN's LeakyReLU (ops/edge_max.py::LEAKY_SLOPE)

__device__ __forceinline__ void unpack(const float4 q, float (&v)[4]) {
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// y: [points, 2 Cout] fp32 rows, Y1 then Y2; ids: [points, k] int32, each
// in [0, n) of its own cloud (clouds of n consecutive points); out: [points,
// Cout] bf16 as 8-byte vectors.
template <int L, int V>
__global__ void __launch_bounds__(kThreads)
    edge_max_kernel(const float* __restrict__ y, const int* __restrict__ ids,
                    const float* __restrict__ mean, const float* __restrict__ inv,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    uint2* __restrict__ out, long long points, int n, int k) {
  constexpr int kVec = L * V;   // 16-byte vectors in Cout fp32
  constexpr int kRow = 8 * kVec;  // floats a row of y: 2 Cout
  constexpr int kR = kMaxK / L;   // ids a lane holds
  const int lane = threadIdx.x & 31;
  const int g = lane / L, l = lane % L;
  const long long p =
      (static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32) * (32 / L) + g;
  const bool live = p < points;

  int id[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int j = l + L * r;
    id[r] = live && j < k ? __ldcs(ids + p * k + j) : 0;
  }
  const float* cloud = y + (live ? p / n * n : 0) * kRow;

  // each channel's BN scale, and its running max (scale >= 0) or min (< 0)
  float s[V][4], top[V][4];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    unpack(__ldg(reinterpret_cast<const float4*>(scale) + l + L * v), s[v]);
#pragma unroll
    for (int e = 0; e < 4; ++e) top[v][e] = s[v][e] >= 0.f ? -INFINITY : INFINITY;
  }
#pragma unroll
  for (int j0 = 0; j0 < kMaxK; j0 += kU) {
    if (j0 >= k) break;  // k is the warp's: the shuffles below stay uniform
    float4 q[kU][V];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = j0 + u;
      const int src = __shfl_sync(kFull, id[j / L], g * L + j % L);
      if (live && j < k) {
        const float4* row =
            reinterpret_cast<const float4*>(cloud + static_cast<long long>(src) * kRow);
#pragma unroll
        for (int v = 0; v < V; ++v) q[u][v] = __ldg(row + l + L * v);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (!live || j0 + u >= k) continue;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float x[4];
        unpack(q[u][v], x);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          top[v][e] = s[v][e] >= 0.f ? fmaxf(top[v][e], x[e]) : fminf(top[v][e], x[e]);
      }
    }
  }
  if (!live) return;

  const float4* own = reinterpret_cast<const float4*>(y + p * kRow);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c4 = l + L * v;  // the lane's vector: channels 4 c4 .. 4 c4 + 3
    float y1[4], y2[4], m[4], iv[4], b[4];
    unpack(__ldg(own + c4), y1);
    unpack(__ldcs(own + kVec + c4), y2);
    unpack(__ldg(reinterpret_cast<const float4*>(mean) + c4), m);
    unpack(__ldg(reinterpret_cast<const float4*>(inv) + c4), iv);
    unpack(__ldg(reinterpret_cast<const float4*>(bias) + c4), b);
    uint32_t h[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[e] = bn_act_f32<true>(__fadd_rn(__fsub_rn(top[v][e], y1[e]), y2[e]), m[e], iv[e],
                              s[v][e], b[e], kSlope);
    }
    out[p * kVec + c4] = make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
  }
}

template <int L, int V>
int launch_shape(const float* y, const int* ids, const float* mean, const float* inv,
                 const float* scale, const float* bias, uint2* out, long long points, int n,
                 int k, cudaStream_t s) {
  constexpr long long per_block = (kThreads / 32) * (32 / L);
  const long long blocks = (points + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  edge_max_kernel<L, V><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      y, ids, mean, inv, scale, bias, out, points, n, k);
  return cudaGetLastError();
}

}  // namespace

// y: [points, 2 cout] fp32, contiguous, 16-byte aligned; ids: [points, k]
// int32, contiguous, each in [0, n) of its cloud (points a multiple of n);
// mean, inv, scale, bias: [cout] fp32, 16-byte aligned; out: [points, cout]
// bf16, 8-byte aligned. cout in {64, 128, 256}; 1 <= k <= min(32, n); the
// activation is LeakyReLU 0.2. Launches on `stream`, does not synchronise.
// Returns the launch's cudaError_t (0 = ok; points = 0 launches nothing).
extern "C" int edge_max_launch(const void* y, const void* ids, const void* mean,
                               const void* inv, const void* scale, const void* bias, void* out,
                               int points, int n, int k, int cout, void* stream) {
  if (points < 0 || n < 1 || points % n || k < 1 || k > kMaxK || k > n)
    return cudaErrorInvalidValue;
  if (points == 0) return cudaSuccess;
  const float* yf = static_cast<const float*>(y);
  const int* ip = static_cast<const int*>(ids);
  const float *m = static_cast<const float*>(mean), *iv = static_cast<const float*>(inv),
              *sc = static_cast<const float*>(scale), *b = static_cast<const float*>(bias);
  uint2* o = static_cast<uint2*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 64:
      return launch_shape<16, 1>(yf, ip, m, iv, sc, b, o, points, n, k, s);
    case 128:
      return launch_shape<32, 1>(yf, ip, m, iv, sc, b, o, points, n, k, s);
    case 256:
      return launch_shape<32, 2>(yf, ip, m, iv, sc, b, o, points, n, k, s);
    default:
      return cudaErrorInvalidValue;
  }
}
