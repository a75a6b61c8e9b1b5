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
// Design: the phase prefix of the port's own selection core (knn_core.cuh),
// not of the TPU kernel, so that the phases time what K1-K3 do on this
// card. One warp owns one row; lane L keeps the smallest distance of its
// columns j = L (mod 32) that lies above the last winner. A round takes the
// warp minimum, a value; every lane whose candidate equals it is refilled to
// the next value of its columns strictly above it, by the cooperative rescan
// of the core (N/1024 columns a lane). The threshold is one more pass over
// the row. The core's helpers are reused as they are (sqdist, stage_xyz,
// make_plan with no bitmask); nothing in knn_core.cuh changes, so K1-K4
// build exactly as before. xyz is in shared memory where make_plan puts it
// (N up to about 18,700) and is read from global memory beyond, so the one
// kernel times both regimes of K1-K3.

#include "knn_core.cuh"

namespace {

using namespace knn_core;

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
  const float inf = __int_as_float(0x7f800000);

  const int stride = kSmem ? pad_stride(n) : 0;
  const float* xs = stage_xyz<kSmem>(x + static_cast<size_t>(b) * n * 3, n,
                                     reinterpret_cast<float*>(smem), stride);
  __syncthreads();  // the only block-wide barrier: rows past N leave after it
  if (row >= n) return;
  const float qx = coord<kSmem>(xs, stride, 0, row);
  const float qy = coord<kSmem>(xs, stride, 1, row);
  const float qz = coord<kSmem>(xs, stride, 2, row);

  // each lane's smallest distance over its columns j = lane (mod 32)
  float cd = inf;
  for (int j = lane; j < n; j += 32) cd = fminf(cd, sqdist<kSmem>(xs, stride, qx, qy, qz, j));

  float m = inf;
  for (int r = 0; r < rounds; ++r) {
    m = warp_min(cd);
    if (m == inf) break;  // fewer than `rounds` distinct values: m is +inf
    // refill every lane that held the winning value, one cooperative rescan each
    unsigned lost = __ballot_sync(kFull, cd == m);
    while (lost) {
      const int owner = __ffs(lost) - 1;
      lost &= lost - 1;
      float nd = inf;
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
cudaError_t launch(const float* x, int b, int n, int rounds, int thresh, float* out,
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
// also above N); thresh 0 or 1. Launches on `stream`, does not synchronise.
// Returns the launch's cudaError_t (0 = ok).
extern "C" int knn_phase_launch(const float* x, int b, int n, int rounds, int thresh,
                                float* out, void* stream) {
  Plan plan;
  if (b < 1 || b > 65535 || n < 1 || rounds < 1 || !make_plan(n, 0, &plan))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan.in_smem) return launch<true>(x, b, n, rounds, thresh != 0, out, plan, s);
  return launch<false>(x, b, n, rounds, thresh != 0, out, plan, s);
}

// Where knn_phase_launch keeps xyz for a cloud of N points: 1 in shared
// memory, 0 read from global memory, -1 when it would refuse N.
extern "C" int knn_phase_xyz_in_smem(int n) {
  Plan plan;
  if (n < 1 || !make_plan(n, 0, &plan)) return -1;
  return plan.in_smem ? 1 : 0;
}
