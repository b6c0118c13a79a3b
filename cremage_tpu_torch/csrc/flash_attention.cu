// Flash attention forward (inference) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel cremage_tpu/ops/flash_attention.py
// (_flash_kernel / _flash_bhnd, reached through flash_attention and
// flash_attention_or_fallback): non-causal, unmasked
// softmax(q k^T * scale) v over (B, N, H, D) bf16 tensors, with an online
// softmax whose running max, denominator and output accumulator are fp32,
// and P rounded to bf16 (unnormalised) before the PV product; the output is
// rounded once.
//
// What bounds it on an H100: at the main path's self-attention shapes
// (Nq = Nk = 4096 or 1024) the work is 4*Nq*Nk*d flops per (batch, head)
// against 2*(2*Nq + 2*Nk)*d bytes, so tensor-core operations bound it; at
// d = 40 the softmax's exp2 (one per score, 16 a clock per SM) is nearly as
// long. The 77-key cross-attentions are bound by bytes (q read, o written).
//
// Design (warp-specialised, persistent: one block per SM walks work items,
// each the BQ q rows of one (batch, head), gridDim.x apart):
// - A producer warpgroup, one lane of which issues TMA loads: each item's q
//   (double-buffered where it fits, so the next item's q loads during this
//   one), then K and V tiles of BK keys through a ring of STAGES
//   shared-memory stages, each with a full/empty mbarrier pair, so loads
//   overlap the consumers' math and the stages run on across items. It
//   hands its registers to the consumers (setmaxnreg).
// - Tensor maps are 4-D over the model's own (B, N, H, D) layout, so q, k
//   and v are read where the projections left them. A tile is cut into
//   boxes of 16 head-dim columns (32 bytes, 32-byte swizzle): box c holds
//   columns [16c, 16c + 16) of every row, rows 32 bytes apart. One box is
//   one k16 step of Q K^T and one 16-column atom of V. TMA's out-of-bounds
//   zero fill pads d to a multiple of 16 (d = 40 runs as 48: 1.2x the
//   operations, no extra bytes) and fills the ragged key and query tails.
// - Two or three consumer warpgroups of 64 q rows each (three at dp <= 96:
//   more warps hide more of the wgmma and softmax latency, which bounds the
//   small head dims more than the tensor or exp2 rates; two at d = 160 and
//   512, whose O needs 240 registers a thread).
// - S = Q K^T is wgmma (m64 x BK x k16) with Q and K read from shared
//   memory by descriptors; the online softmax runs in registers on wgmma's
//   accumulator layout (exp2, scale folded into log2 units, row max over
//   the quad). Keys >= Nk are masked to -1e30 there: zero-filled keys would
//   otherwise score 0.
// - P is packed to bf16 in registers and fed as wgmma's register A operand
//   for O += P V, with V read MN-major (the transpose bit), so V is never
//   transposed by hand and P never touches shared memory.
// - O is normalised in registers, staged in the warpgroup's rows of the q
//   buffer and written by TMA stores: a few wide writes per warpgroup in
//   place of per-thread 4-byte stores into the strided (B, N, H, D) rows.
// - d = 512 (the VAE mid-block): a 64 x 512 fp32 O does not fit one
//   warpgroup's registers. Both warpgroups take the same 64 q rows and each
//   owns 256 output columns; each computes S itself (2x the Q K^T work, not
//   the 4x of four column chunks), with 32-key tiles to fit shared memory.
// - The key tile is chosen per call (ops/flash_attention.py plan_flash): one
//   80-key tile up to 80 keys (the 77-key cross-attention runs no rescale),
//   otherwise 128.
// - Head dims: 40 (as 48), 80 and 160 in the UNet, 512 in the VAE, 64 in
//   the image safety checker's CLIP ViT-L/14 tower (257 tokens: two full
//   128-key tiles and a ragged one of 1 key; 257 q rows over 192-row items
//   leave a second item of 65 rows) and SDXL, and 128 in FLUX's joint
//   attention (24 heads over 4352 tokens at 1024^2: 2 warpgroups of 64 q
//   rows, O and S 64 fp32 registers each, q double-buffered beside a
//   2-stage ring of 32 KB K and V tiles, 193 KB in all), 88 (as 96) in
//   Hunyuan-DiT's self- and cross-attention (16 heads: 6 boxes, the last
//   half out of bounds; three warpgroups, whose O (48), S (64) and P (32)
//   fit 160 registers without spills and which ran 1.3x faster than two;
//   q double-buffered beside a 3-stage ring of 24 KB tiles, 217 KB) and
//   256 in its attention pool
//   (one query row, the mean token, over 257 keys in 8 heads: split over
//   two warpgroups as d = 512, each owning 128 output columns of the same
//   64 q rows, 64-key tiles; the q box's rows past Nq read as zeros and
//   the store skips them).
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kBox = 16;             // head-dim columns per TMA box / k16 step
constexpr int kRowBytes = kBox * 2;  // one box row: 32 bytes, the swizzle span
constexpr int kAlign = 1024;         // slack to align the tiles
constexpr int kBarBytes = 128;       // mbarriers after the tiles
constexpr int kSmemLimit = 232448;   // shared memory a block can use
// registers per thread of the producer warpgroup after the split
// (setmaxnreg); it gives the rest to the consumers, whose fp32 O (up to 128
// registers at d = 512) and S tiles need them
constexpr int kProducerRegs = 24;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// One instantiation's launch plan. ops/flash_attention.py plan_flash
// computes the same numbers and the entry point checks that they agree.
template <int DP_, int BK_, int SPLIT_, int NWG_>
struct Plan {
  static constexpr int DP = DP_;       // head dim padded to a multiple of 16
  static constexpr int BK = BK_;       // keys per tile
  static constexpr int SPLIT = SPLIT_; // warpgroups sharing one set of q rows
  static constexpr int NWG = NWG_;     // consumer warpgroups
  static constexpr int BQ = 64 * NWG / SPLIT;  // q rows per block
  static constexpr int DV = DP / SPLIT;        // output columns per warpgroup
  static constexpr int NB = DP / kBox;         // boxes per row
  static constexpr int Q_BYTES = NB * BQ * kRowBytes;
  static constexpr int KV_BYTES = NB * BK * kRowBytes;  // one K or V tile
  static constexpr int smem(int q_bufs, int stages) {
    return kAlign + q_bufs * Q_BYTES + stages * 2 * KV_BYTES + kBarBytes;
  }
  // two q buffers (the next work item's q loads during this one) where
  // they fit beside a 2-stage ring, then 3 ring stages where they fit
  static constexpr int QBUFS = smem(2, 2) <= kSmemLimit ? 2 : 1;
  static constexpr int STAGES = smem(QBUFS, 3) <= kSmemLimit ? 3 : 2;
  static constexpr int SMEM = smem(QBUFS, STAGES);
  static constexpr int THREADS = (NWG + 1) * 128;  // + the producer warpgroup
  // registers per consumer thread (setmaxnreg): what the producer leaves
  static constexpr int CONSUMER_REGS = NWG == 2 ? 240 : 160;
  static_assert(128 * (kProducerRegs + NWG * CONSUMER_REGS) <= 65536, "registers");
  static_assert(DP % kBox == 0 && BK % 16 == 0 && BK <= 256, "tile shape");
  static_assert(SMEM <= kSmemLimit, "shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box {16 columns, 1 head, rows, 1 batch} at (c0, h, n, b) into dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int h, int n, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(h), "r"(n), "r"(b)
      : "memory");
}

// One box {16 columns, 1 head, rows, 1 batch} from src to (c0, h, n, b);
// rows and columns out of bounds are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0,
                                          int h, int n, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(h), "r"(n), "r"(b)
      : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// Barrier `id` over `threads` threads (id 0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor of a 32-byte-swizzled operand. K-major
// (Q, K): sbo = 8 rows = 256 bytes, lbo unused (16). MN-major (V): lbo =
// the stride between 16-column boxes, sbo = 8 keys = 256 bytes.
__device__ __forceinline__ uint64_t desc32(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (3ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving register reads and writes across the
// asynchronous wgmma boundaries.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S = Q K^T for one warpgroup's 64 q rows (sQw) and one key tile (sK), issued
// as one wgmma group.
template <class P>
__device__ __forceinline__ void issue_qk(float (&sc)[P::BK / 2], uint32_t sQw, uint32_t sK) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < P::NB; ++kk)
    wgmma_ss(sc, desc32(sQw + kk * P::BQ * kRowBytes, 16, 256),
             desc32(sK + kk * P::BK * kRowBytes, 16, 256), kk);
  wg_commit();
}

// O += P V for one key tile; sV points at this warpgroup's first V box.
template <class P>
__device__ __forceinline__ void issue_pv(float (&acc)[P::DV / 2],
                                         uint32_t (&pa)[P::BK / 16][4], uint32_t sV) {
  pin(acc);
  pin(pa);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < P::BK / 16; ++kk)
    wgmma_rs(acc, pa[kk], desc32(sV + kk * 16 * kRowBytes, P::BK * kRowBytes, 256));
  wg_commit();
}

// Online softmax of one tile's S (kv valid keys): updates the running max
// m and the row sums l, returns the rescale factors al of the old O, and
// packs P = exp2(s * scale_log2 - m) into bf16 A fragments. S's n8 blocks
// 2kk and 2kk + 1 are the A fragment of keys [16kk, 16kk + 16).
//
// m is round(s_max * scale_log2). Up to |m| < kFmaLimit the scale folds
// into one FMA a score, exp2(fma(s, c, -m)), and the max's own exponent is
// the rounding residual of s_max * c: at most half an ulp of kFmaLimit, a
// 3.4e-4 relative error in its P, below P's bf16 rounding. Beyond it
// (inputs of |q|, |k| ~ 20-100 and more, by d and the keys' alignment) the
// residual grows, to overflow exp2 near 2^31, so the tile takes the scores
// scaled first, round(s * c) - m, whose max is exactly 0 (rounding is
// monotone, so m is the largest of the rounded scores); the intrinsics
// keep the product from contracting into the subtraction.
constexpr float kFmaLimit = 16384.f;

template <class P>
__device__ __forceinline__ void softmax(float (&sc)[P::BK / 2], uint32_t (&pa)[P::BK / 16][4],
                                        int kv, int t4, float scale_log2, float& m0,
                                        float& m1, float& l0, float& l1, float& al0,
                                        float& al1) {
  if (kv < P::BK) {  // mask keys >= Nk: zero-filled rows would score 0
#pragma unroll
    for (int j = 0; j < P::BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (j * 8 + 2 * t4 + e >= kv) sc[4 * j + e] = sc[4 * j + 2 + e] = kNegInf;
  }
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < P::BK / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  const float mn0 = fmaxf(m0, __fmul_rn(quad_max(mx0), scale_log2));
  const float mn1 = fmaxf(m1, __fmul_rn(quad_max(mx1), scale_log2));
  al0 = exp2_approx(m0 - mn0);
  al1 = exp2_approx(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
  if (fabsf(mn0) < kFmaLimit && fabsf(mn1) < kFmaLimit) {
#pragma unroll
    for (int j = 0; j < P::BK / 8; ++j) {
      const float p0 = exp2_approx(fmaf(sc[4 * j], scale_log2, -mn0));
      const float p1 = exp2_approx(fmaf(sc[4 * j + 1], scale_log2, -mn0));
      const float p2 = exp2_approx(fmaf(sc[4 * j + 2], scale_log2, -mn1));
      const float p3 = exp2_approx(fmaf(sc[4 * j + 3], scale_log2, -mn1));
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
  } else {
#pragma unroll
    for (int j = 0; j < P::BK / 8; ++j) {
      const float p0 = exp2_approx(__fmul_rn(sc[4 * j], scale_log2) - mn0);
      const float p1 = exp2_approx(__fmul_rn(sc[4 * j + 1], scale_log2) - mn0);
      const float p2 = exp2_approx(__fmul_rn(sc[4 * j + 2], scale_log2) - mn1);
      const float p3 = exp2_approx(__fmul_rn(sc[4 * j + 3], scale_log2) - mn1);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
  }
  l0 = l0 * al0 + rs0;
  l1 = l1 * al1 + rs1;
}

template <class P>
__global__ void __launch_bounds__(P::THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap to, int BH, int H, int Nq,
                    int Nk, float scale_log2) {
  extern __shared__ unsigned char smem[];
  const uint32_t sQ0 = (smem_u32(smem) + kAlign - 1) & ~uint32_t(kAlign - 1);
  const uint32_t sKV = sQ0 + P::QBUFS * P::Q_BYTES;  // stage s: K, then V
  const uint32_t q_full0 = sKV + P::STAGES * 2 * P::KV_BYTES;
  const uint32_t q_empty0 = q_full0 + 8 * P::QBUFS;
  const uint32_t full0 = q_empty0 + 8 * P::QBUFS, empty0 = full0 + 8 * P::STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q_blocks = (Nq + P::BQ - 1) / P::BQ;
  const int n_items = q_blocks * BH;  // work items: (batch-head, q block)
  const int n_tiles = (Nk + P::BK - 1) / P::BK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < P::QBUFS; ++i) {
      mbar_init(q_full0 + 8 * i, 1);
      mbar_init(q_empty0 + 8 * i, P::NWG);  // one thread per warpgroup
    }
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, P::NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= P::NWG * 4) {  // the producer warpgroup: one lane issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == P::NWG * 4 && lane == 0) {
      int n = 0;  // K/V tiles loaded so far, over all work items
      for (int w = blockIdx.x, i = 0; w < n_items; w += gridDim.x, ++i) {
        const int bh = w / q_blocks, q0 = (w % q_blocks) * P::BQ;
        const int b = bh / H, h = bh % H;
        // round r of a buffer or stage waits for the consumers' release of
        // round r - 1 (the first round passes at once)
        const int qb = i % P::QBUFS;
        const uint32_t q_full = q_full0 + 8 * qb, sQ = sQ0 + qb * P::Q_BYTES;
        mbar_wait(q_empty0 + 8 * qb, ((i / P::QBUFS) & 1) ^ 1);
        mbar_expect_tx(q_full, P::Q_BYTES);
        for (int c = 0; c < P::NB; ++c)
          tma_load(sQ + c * P::BQ * kRowBytes, &tq, q_full, c * kBox, h, q0, b);
        for (int t = 0; t < n_tiles; ++t, ++n) {
          const int s = n % P::STAGES;
          mbar_wait(empty0 + 8 * s, ((n / P::STAGES) & 1) ^ 1);
          mbar_expect_tx(full0 + 8 * s, 2 * P::KV_BYTES);
          const uint32_t sK = sKV + s * 2 * P::KV_BYTES, sV = sK + P::KV_BYTES;
          for (int c = 0; c < P::NB; ++c) {
            tma_load(sK + c * P::BK * kRowBytes, &tk, full0 + 8 * s, c * kBox, h,
                     t * P::BK, b);
            tma_load(sV + c * P::BK * kRowBytes, &tv, full0 + 8 * s, c * kBox, h,
                     t * P::BK, b);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg, warp wl of it; lane = (row group g, pair t4)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(P::CONSUMER_REGS));
  const int wg = warp / 4, wl = warp % 4, g = lane / 4, t4 = lane % 4;
  const int row0 = P::SPLIT == 1 ? wg * 64 : 0;    // first q row of this warpgroup
  const int col0 = P::SPLIT == 1 ? 0 : wg * P::DV;  // first output column

  int n = 0;  // K/V tiles consumed so far, over all work items
  for (int w = blockIdx.x, i = 0; w < n_items; w += gridDim.x, ++i) {
    const int bh = w / q_blocks, q0 = (w % q_blocks) * P::BQ;
    const int b = bh / H, h = bh % H;
    const int qb = i % P::QBUFS;
    // this warpgroup's rows of q buffer qb: box c at + c * BQ rows
    const uint32_t sQw = sQ0 + qb * P::Q_BYTES + row0 * kRowBytes;

    float acc[P::DV / 2];
#pragma unroll
    for (int j = 0; j < P::DV / 2; ++j) acc[j] = 0.f;
    float m0 = kNegInf, m1 = kNegInf;  // running max of rows g, g + 8 (log2 units)
    float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums
    mbar_wait(q_full0 + 8 * qb, (i / P::QBUFS) & 1);
    for (int t = 0; t < n_tiles; ++t, ++n) {
      const int s = n % P::STAGES;
      mbar_wait(full0 + 8 * s, (n / P::STAGES) & 1);
      const uint32_t sK = sKV + s * 2 * P::KV_BYTES;
      float sc[P::BK / 2];
      issue_qk<P>(sc, sQw, sK);
      wg_wait<0>();
      pin(sc);
      uint32_t pa[P::BK / 16][4];
      float al0, al1;
      softmax<P>(sc, pa, Nk - t * P::BK, t4, scale_log2, m0, m1, l0, l1, al0, al1);
#pragma unroll
      for (int j = 0; j < P::DV / 8; ++j) {
        acc[4 * j] *= al0;
        acc[4 * j + 1] *= al0;
        acc[4 * j + 2] *= al1;
        acc[4 * j + 3] *= al1;
      }
      issue_pv<P>(acc, pa, sK + P::KV_BYTES + (col0 / kBox) * P::BK * kRowBytes);
      wg_wait<0>();
      pin(acc);
      mbar_arrive(empty0 + 8 * s);  // this thread is done with stage s
    }

    // O, normalised, goes through this warpgroup's part of the q buffer (its
    // last Q K^T is done) and out by TMA stores, which skip the ragged rows
    // and the padded columns: far fewer, wider writes than per-thread
    // stores into the strided (B, N, H, D) rows.
    const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
    if (P::SPLIT > 1) named_sync(1, P::NWG * 128);  // all done with the shared rows
    const int c0 = col0 / kBox;
#pragma unroll
    for (int j = 0; j < P::DV / 8; ++j) {
      const uint32_t at = sQw + ((c0 + j / 2) * P::BQ + wl * 16 + g) * kRowBytes +
                          ((j % 2) * 8 + 2 * t4) * 2;
      st_shared(at, pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0));
      st_shared(at + 8 * kRowBytes, pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the TMA unit
    named_sync(2 + wg, 128);
    if (threadIdx.x % 128 == 0) {
      for (int c = c0; c < c0 + P::DV / kBox; ++c)
        tma_store(&to, sQw + c * P::BQ * kRowBytes, c * kBox, h, q0 + row0, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      mbar_arrive(q_empty0 + 8 * qb);  // this warpgroup is done with q buffer qb
    }
  }
  if (threadIdx.x % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                     12000, cudaEnableDefault, &found);
#else
    cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
               : nullptr;
  }();
  return fn;
}

// A (B, N, H, D) bf16 tensor as a 4-D map (dims {D, H, N, B}), moved in
// boxes of {16 columns, 1 head, rows, 1 batch}.
bool make_map(CUtensorMap* map, const void* ptr, int B, int N, int H, int D, int rows,
              CUtensorMapSwizzle swizzle) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * D, 2ull * H * D, 2ull * N * H * D};
  const cuuint32_t box[4] = {kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, H, Nq, Nk, D;
  float scale;
  int bq, stages, smem;
  cudaStream_t stream;
};

template <class P>
int launch(const Args& a) {
  if (a.bq != P::BQ || a.stages != P::STAGES || a.smem != P::SMEM)
    return (int)cudaErrorInvalidValue;  // the wrapper's plan disagrees
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  // q, k, v 32-byte-swizzled for wgmma; o from plain 32-byte rows, 64 a
  // warpgroup
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, a.q, a.B, a.Nq, a.H, a.D, P::BQ, sw) ||
      !make_map(&tk, a.k, a.B, a.Nk, a.H, a.D, P::BK, sw) ||
      !make_map(&tv, a.v, a.B, a.Nk, a.H, a.D, P::BK, sw) ||
      !make_map(&to, a.o, a.B, a.Nq, a.H, a.D, 64, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  // persistent blocks, one per SM, each walking work items gridDim.x apart
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const long items = (long)((a.Nq + P::BQ - 1) / P::BQ) * a.B * a.H;
  const int grid = (int)(items < sms ? items : sms);
  if (grid < 1) return (int)cudaErrorInvalidValue;
  flash_fwd_wgmma<P><<<grid, P::THREADS, P::SMEM, a.stream>>>(
      tq, tk, tv, to, a.B * a.H, a.H, a.Nq, a.Nk, a.scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous, 16-byte aligned (B, N, H, D) bf16; D % 8 == 0 and
// dp = round_up(D, 16). (dp, bk, split, bq) pick the instantiation; stages
// and smem are the wrapper's plan (ops/flash_attention.py plan_flash), which
// must match it. Returns a cudaError_t.
extern "C" int cremage_flash_attention_bf16(const void* q, const void* k, const void* v,
                                            void* o, int B, int H, int Nq, int Nk, int D,
                                            float scale, int dp, int bk, int bq, int stages,
                                            int split, int smem, void* stream) {
  if (D % 8 != 0 || (D + 15) / 16 * 16 != dp || Nq < 1 || Nk < 1 || B * H > 65535 ||
      !(scale > 0.f))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, B, H, Nq, Nk, D, scale, bq, stages, smem,
               static_cast<cudaStream_t>(stream)};
  // (dp, bk, split, consumer warpgroups) name the instantiation
  const int nwg = bq * split / 64;
  const int key = ((dp * 1000 + bk) * 10 + split) * 10 + nwg;
  switch (key) {
    case 48080'13: return launch<Plan<48, 80, 1, 3>>(a);
    case 48128'13: return launch<Plan<48, 128, 1, 3>>(a);
    case 64080'13: return launch<Plan<64, 80, 1, 3>>(a);
    case 64128'13: return launch<Plan<64, 128, 1, 3>>(a);
    case 80080'13: return launch<Plan<80, 80, 1, 3>>(a);
    case 80128'13: return launch<Plan<80, 128, 1, 3>>(a);
    case 96080'13: return launch<Plan<96, 80, 1, 3>>(a);
    case 96128'13: return launch<Plan<96, 128, 1, 3>>(a);
    case 128080'12: return launch<Plan<128, 80, 1, 2>>(a);
    case 128128'12: return launch<Plan<128, 128, 1, 2>>(a);
    case 160080'12: return launch<Plan<160, 80, 1, 2>>(a);
    case 160128'12: return launch<Plan<160, 128, 1, 2>>(a);
    case 256064'22: return launch<Plan<256, 64, 2, 2>>(a);
    case 512032'22: return launch<Plan<512, 32, 2, 2>>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
