// Flash attention forward (inference) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel cremage_tpu/ops/flash_attention.py
// (_flash_kernel / _flash_bhnd, reached through flash_attention and
// flash_attention_or_fallback): non-causal, unmasked
// softmax(q k^T * scale) v over (B, N, H, D) bf16 tensors, with an online
// softmax whose running max, denominator and output accumulator are fp32,
// and P rounded to bf16 before the PV product, as the TPU kernel does.
//
// What bounds it on an H100: at the main path's self-attention shapes
// (Nq = Nk = 4096 or 1024) the work is 4*Nq*Nk*d flops per (batch, head)
// against 2*(Nq + 2*Nk + Nq)*d bytes, so it is bound by tensor-core
// operations, not by memory. The design keeps the Nq x Nk score matrix out
// of device memory entirely: each block owns 64 query rows of one
// (batch, head) and sweeps the keys in tiles of 64 held in shared memory;
// S and P live in registers (mma.sync m16n8k16 fragments), and the
// accumulator layout of S is reused directly as the A operand of the PV
// product. The 77-key cross-attention and the ragged tails (Nk = 77, 64,
// 256 are not all tile multiples) are masked in registers.
//
// Head dims: d is padded to a multiple of 16 in shared memory only
// (zero-filled loads), never in device memory, so d = 40 runs as 48 and
// d = 80, 160 run as they are. d = 512 (the VAE mid-block) does not fit a
// register accumulator: the grid's z dimension splits the output columns
// into chunks of 128, and each chunk's block recomputes S over the full d.
//
// A simple first version: no TMA, no wgmma, no warp specialisation and no
// double buffering of the key tiles. Those are for the PRs that make it
// fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = kWarps * 16;  // query rows per block, 16 per warp
constexpr int kBK = 64;           // keys per shared-memory tile
constexpr int kVS = kBK + 8;      // row stride of the transposed V tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row-major) * b (16x8, column-major); fp32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  float c0 = d[0], c1 = d[1], c2 = d[2], c3 = d[3];
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c0), "f"(c1), "f"(c2), "f"(c3));
}

// rows x DP tile from device memory (row stride `gs` elements, d valid
// columns, `valid` valid rows) into shared memory, zero-filling the rest.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int64_t gs,
                                          int valid, int d) {
  constexpr int kVec = DP / 8;
  for (int i = threadIdx.x; i < ROWS * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid && c < d) v = *reinterpret_cast<const uint4*>(g + r * gs + c);
    *reinterpret_cast<uint4*>(s + r * (DP + 8) + c) = v;
  }
}

// V columns [c0, c0 + DV) of kBK keys, stored transposed: sVt[col][key].
template <int DV>
__device__ __forceinline__ void load_vt(bf16* s, const bf16* g, int64_t gs,
                                        int valid, int d, int c0) {
  constexpr int kVec = DV / 8;
  for (int i = threadIdx.x; i < kBK * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid && c0 + c < d)
      v = *reinterpret_cast<const uint4*>(g + r * gs + c0 + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) s[(c + j) * kVS + r] = e[j];
  }
}

template <int DP, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, int H, int Nq,
              int Nk, int D, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kQS = DP + 8;  // row stride of the q and k tiles
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kBQ * kQS;
  bf16* sVt = sK + kBK * kQS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group / column pair
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int c0 = blockIdx.z * DV;
  const int64_t rs = (int64_t)H * D;  // token stride in (B, N, H, D)
  const bf16* qg = q + ((int64_t)b * Nq + q0) * rs + (int64_t)h * D;
  const bf16* kg = k + (int64_t)b * Nk * rs + (int64_t)h * D;
  const bf16* vg = v + (int64_t)b * Nk * rs + (int64_t)h * D;
  bf16* og = o + ((int64_t)b * Nq + q0) * rs + (int64_t)h * D;

  load_tile<DP, kBQ>(sQ, qg, rs, min(kBQ, Nq - q0), D);

  float acc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max of rows g and g + 8 (log2 units)
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums
  const bf16* qw = sQ + (warp * 16 + g) * kQS + 2 * t;

  for (int k0 = 0; k0 < Nk; k0 += kBK) {
    const int kv = min(kBK, Nk - k0);
    __syncthreads();  // the previous tile is consumed; sQ is written
    load_tile<DP, kBK>(sK, kg + k0 * rs, rs, kv, D);
    load_vt<DV>(sVt, vg + k0 * rs, rs, kv, D, c0);
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    for (int kk = 0; kk < DP / 16; ++kk) {
      const bf16* qa = qw + kk * 16;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * kQS), ld32(qa + 8),
                             ld32(qa + 8 * kQS + 8)};
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        const bf16* kb = sK + (n * 8 + g) * kQS + kk * 16 + 2 * t;
        mma16816(s[n], a, ld32(kb), ld32(kb + 8));
      }
    }

    // scale into log2 units, mask the ragged key tail, row max over the quad
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = n * 8 + 2 * t + j < kv;
        s[n][j] = ok ? s[n][j] * scale_log2 : kNegInf;
        s[n][2 + j] = ok ? s[n][2 + j] * scale_log2 : kNegInf;
        mx0 = fmaxf(mx0, s[n][j]);
        mx1 = fmaxf(mx1, s[n][2 + j]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P = exp(S - m): fp32 for the row sums, bf16 A fragments for PV. The
    // accumulator of S tiles 2j and 2j+1 is exactly the A fragment of keys
    // [16j, 16j + 16).
    uint32_t pa[kBK / 16][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      const float p0 = exp2f(s[n][0] - mn0), p1 = exp2f(s[n][1] - mn0);
      const float p2 = exp2f(s[n][2] - mn1), p3 = exp2f(s[n][3] - mn1);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pa[n / 2][(n % 2) * 2 + 0] = pack_bf16(p0, p1);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        const bf16* vb = sVt + (n * 8 + g) * kVS + kk * 16 + 2 * t;
        mma16816(acc[n], pa[kk], ld32(vb), ld32(vb + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    const int col = c0 + n * 8 + 2 * t;
    if (col >= D) continue;
    if (q0 + r0 < Nq)
      *reinterpret_cast<uint32_t*>(og + r0 * rs + col) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (q0 + r1 < Nq)
      *reinterpret_cast<uint32_t*>(og + r1 * rs + col) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

template <int DP, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Nq, int Nk, int D, float scale, cudaStream_t stream) {
  const int smem = (kBQ * (DP + 8) + kBK * (DP + 8) + DV * kVS) * (int)sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<DP, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Nq + kBQ - 1) / kBQ, B * H, (D + DV - 1) / DV);
  flash_fwd<DP, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, Nq, Nk, D,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous, 16-byte aligned (B, N, H, D) bf16 (the tiles are
// loaded 8 elements at a time); D % 8 == 0 and round_up(D, 16)
// in {48, 80, 160, 512} (SD1.5's d = 40, 80, 160 and the VAE's 512).
// Returns a cudaError_t.
extern "C" int cremage_flash_attention_bf16(const void* q, const void* k,
                                            const void* v, void* o, int B,
                                            int H, int Nq, int Nk, int D,
                                            float scale, void* stream) {
  if (D % 8 != 0 || Nq < 1 || Nk < 1 || B * H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16 * 16) {
    case 48: return launch<48, 48>(q, k, v, o, B, H, Nq, Nk, D, scale, s);
    case 80: return launch<80, 80>(q, k, v, o, B, H, Nq, Nk, D, scale, s);
    case 160: return launch<160, 160>(q, k, v, o, B, H, Nq, Nk, D, scale, s);
    case 512: return launch<512, 128>(q, k, v, o, B, H, Nq, Nk, D, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
