// K9: eval-mode BatchNorm and the activation after it in one pass, for Hopper.
//
// Replaces no TPU kernel. On the TPU, XLA fuses BN's affine map and the
// ReLU / LeakyReLU after it into the epilogue of the Dense's dot
// (epcnet_tpu/models/layers.py). On the card the same function was a chain
// of ATen's elementwise kernels (models/layers.py::DynamicBatchNorm in eval,
// then F.relu or F.leaky_relu): the bf16 Dense output widened to fp32, the
// subtraction, the two products and the sum each a pass over fp32, the cast
// back, the activation; about 48 bytes of traffic an element where the
// function needs 4.
//
// What it computes, for each element x of a row-major bf16 [rows, C] and its
// channel c: bn_act.cuh's epilogue, the chain's order of fp32 operations,
// each rounded on its own, so the output is bit-equal to the chain's.
//
// Bound on this card: the bytes, one bf16 read and one bf16 write an element
// (the [C] vectors stay in registers); [131072, 1024] is 537 MB, 0.160 ms at
// 3.35 TB/s; [2621440, 256] 2.68 GB, 0.801 ms. Eight fp32 operations an
// element are far below it.
//
// Design: a grid-stride loop over the 16-byte vectors of 8 bf16 (C % 8 == 0,
// so a vector never straddles a row). The launch makes the number of threads
// a multiple of C / 8, so each thread meets the same 8 channels at every
// stride and loads their 32 parameters into registers once; neighbouring
// threads read neighbouring vectors. kU streaming loads (__ldcs: the input
// is read once) are in flight a thread before any is computed; the grid is 8
// blocks of 256 threads an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn_act.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kU = 4;            // 16-byte vectors a thread in flight
constexpr int kBlocksPerSm = 8;  // 2048 threads an SM

__device__ __forceinline__ void load8(const float* __restrict__ p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// One element: its bf16 bits in, the activated bf16 bits out.
template <bool kLeaky>
__device__ __forceinline__ uint32_t bn_act1(uint32_t bits, float m, float inv, float s,
                                            float b, float slope) {
  return bn_act_f32<kLeaky>(__uint_as_float(bits << 16), m, inv, s, b, slope);
}

// Eight elements of channels c0 .. c0 + 7, packed two to a word.
template <bool kLeaky>
__device__ __forceinline__ uint4 bn_act8(uint4 q, const float (&m)[8], const float (&inv)[8],
                                         const float (&s)[8], const float (&b)[8],
                                         float slope) {
  uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 2 * i;
    const uint32_t lo = bn_act1<kLeaky>(w[i] & 0xffffu, m[c], inv[c], s[c], b[c], slope);
    const uint32_t hi = bn_act1<kLeaky>(w[i] >> 16, m[c + 1], inv[c + 1], s[c + 1],
                                        b[c + 1], slope);
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// grid * kThreads is a multiple of groups = C / 8, so vector v's channels
// start at 8 (v mod groups) for every v a thread visits.
template <bool kLeaky>
__global__ void __launch_bounds__(kThreads)
    bn_act_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                  const float* __restrict__ mean, const float* __restrict__ inv,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  long long nvec, int groups, float slope) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long v0 = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (v0 >= nvec) return;
  const int c0 = static_cast<int>(v0 % groups) * 8;
  float m[8], iv[8], s[8], b[8];
  load8(mean + c0, m);
  load8(inv + c0, iv);
  load8(scale + c0, s);
  load8(bias + c0, b);
  for (long long v = v0; v < nvec; v += kU * stride) {
    uint4 q[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (v + u * stride < nvec) q[u] = __ldcs(x + v + u * stride);
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (v + u * stride < nvec) out[v + u * stride] = bn_act8<kLeaky>(q[u], m, iv, s, b, slope);
  }
}

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

}  // namespace

// x, out: [rows, c] bf16, contiguous, 16-byte aligned, not overlapping;
// mean, inv, scale, bias: [c] fp32, 16-byte aligned; c a multiple of 8.
// leaky = 0: ReLU; else LeakyReLU with `slope`. Launches on `stream`, does
// not synchronise. Returns the launch's cudaError_t (0 = ok; rows = 0
// launches nothing).
extern "C" int bn_act_launch(const void* x, const void* mean, const void* inv,
                             const void* scale, const void* bias, void* out, int rows, int c,
                             int leaky, float slope, void* stream) {
  if (rows < 0 || c < 8 || c % 8) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const int groups = c / 8;
  const long long nvec = static_cast<long long>(rows) * groups;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // enough blocks to fill the card, no more than the vectors need, rounded
  // up so that the threads are a multiple of groups
  long long blocks = (nvec + kThreads - 1) / kThreads;
  if (blocks > static_cast<long long>(sms) * kBlocksPerSm)
    blocks = static_cast<long long>(sms) * kBlocksPerSm;
  const int unit = groups / gcd(groups, kThreads);
  blocks = (blocks + unit - 1) / unit * unit;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* xv = static_cast<const uint4*>(x);
  uint4* ov = static_cast<uint4*>(out);
  const float *m = static_cast<const float*>(mean), *iv = static_cast<const float*>(inv),
              *sc = static_cast<const float*>(scale), *b = static_cast<const float*>(bias);
  if (leaky)
    bn_act_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        xv, ov, m, iv, sc, b, nvec, groups, slope);
  else
    bn_act_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        xv, ov, m, iv, sc, b, nvec, groups, slope);
  return cudaGetLastError();
}
