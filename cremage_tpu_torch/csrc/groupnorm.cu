// Fused GroupNorm(+SiLU) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel cremage_tpu/ops/groupnorm.py (_gn_kernel /
// _gn_pallas, reached through group_norm_silu from models/layers.py
// GroupNorm): per (batch, group) fp32 one-pass moments with the variance
// clamped at 0, then a per-channel affine and an optional SiLU, computed in
// fp32 and rounded once to bf16, the main path's only activation type.
//
// What bounds it on an H100: memory. It does a few operations per element
// and must read x and write y; the least it can move is one read and one
// write of the activation. The TPU design held one whole batch row in VMEM
// and finished in one pass; on Hopper a block has at most 227 KB of shared
// memory while a (batch, group) slab on the main path reaches 2.1 M
// elements (VAE 512^2 x 8 channels), so the statistics are a split
// reduction over many blocks:
//   1. gn_stats: each block sums (x, x^2) in fp32 over one chunk of one
//      slab and writes a partial;
//   2. gn_apply: each block first combines its slab's partials into mean
//      and rstd (the chunk count is small), then normalizes its chunk with
//      one fused read of x and one write of y.
// x is thus read twice (once for the statistics, once for the epilogue);
// the second read of a chunk often hits the 50 MB L2 for the UNet's
// smaller activations. NCHW keeps each slab contiguous, so both passes use
// 16-byte vector loads and every 8-element vector lies in one channel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kThreads = 256;

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Sum of (a, b) over the block; the result is valid in every thread.
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 part[kThreads / 32];
  __shared__ float2 total;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    a = lane < kThreads / 32 ? part[lane].x : 0.f;
    b = lane < kThreads / 32 ? part[lane].y : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      b += __shfl_xor_sync(0xffffffffu, b, off);
    }
    if (lane == 0) total = make_float2(a, b);
  }
  __syncthreads();
  return total;
}

// grid (n_chunks, N * G): partial (sum, sum of squares) of one chunk.
__global__ void __launch_bounds__(kThreads)
    gn_stats(const bf16* __restrict__ x, float2* __restrict__ partial,
             int64_t slab, int64_t chunk) {
  const int64_t begin = blockIdx.x * chunk;
  const int64_t end = begin + chunk < slab ? begin + chunk : slab;
  const bf16* xs = x + blockIdx.y * slab;
  float s = 0.f, ss = 0.f;
  for (int64_t i = begin + threadIdx.x * 8; i < end; i += kThreads * 8) {
    float v[8];
    load8(xs + i, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s += v[j];
      ss += v[j] * v[j];
    }
  }
  const float2 tot = block_sum2(s, ss);
  if (threadIdx.x == 0) partial[blockIdx.y * gridDim.x + blockIdx.x] = tot;
}

// grid (n_chunks, N * G): combine the slab's partials, normalize one chunk.
__global__ void __launch_bounds__(kThreads)
    gn_apply(const bf16* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, bf16* __restrict__ y,
             const float2* __restrict__ partial, int64_t slab, int64_t chunk,
             int C, int G, int64_t HW, float eps, int silu) {
  const int n_chunks = gridDim.x;
  const float2* ps = partial + blockIdx.y * n_chunks;
  float s = 0.f, ss = 0.f;
  for (int i = threadIdx.x; i < n_chunks; i += kThreads) {
    s += ps[i].x;
    ss += ps[i].y;
  }
  const float2 tot = block_sum2(s, ss);
  const float count = (float)slab;
  const float mean = tot.x / count;
  const float var = fmaxf(tot.y / count - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);

  const int cbase = (blockIdx.y % G) * (C / G);
  const int64_t begin = blockIdx.x * chunk;
  const int64_t end = begin + chunk < slab ? begin + chunk : slab;
  const int64_t off = (int64_t)blockIdx.y * slab;
  for (int64_t i = begin + threadIdx.x * 8; i < end; i += kThreads * 8) {
    const int c = cbase + (int)(i / HW);
    const float sc = rstd * w[c];
    const float sh = bias[c] - mean * sc;
    float v[8];
    load8(x + off + i, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float r = v[j] * sc + sh;
      if (silu) r = r * (1.f / (1.f + expf(-r)));
      v[j] = r;
    }
    store8(y + off + i, v);
  }
}

}  // namespace

// x, y: contiguous NCHW bf16; w, b: fp32 (C,); partial: fp32 scratch of
// N * G * n_chunks * 2; HW % 8 == 0 and chunk % 8 == 0,
// n_chunks * chunk >= (C / G) * HW. Returns a cudaError_t.
extern "C" int cremage_group_norm_silu_bf16(const void* x, const void* w,
                                            const void* b, void* y,
                                            void* partial, int N, int C,
                                            int64_t HW, int G, int n_chunks,
                                            int64_t chunk, float eps, int silu,
                                            void* stream) {
  if (C % G != 0 || HW % 8 != 0 || chunk % 8 != 0 || n_chunks < 1 ||
      N * G > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t slab = (int64_t)(C / G) * HW;
  const dim3 grid(n_chunks, N * G);
  gn_stats<<<grid, kThreads, 0, s>>>(static_cast<const bf16*>(x),
                                     static_cast<float2*>(partial), slab, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gn_apply<<<grid, kThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<bf16*>(y),
      static_cast<const float2*>(partial), slab, chunk, C, G, HW, eps, silu);
  return (int)cudaGetLastError();
}
