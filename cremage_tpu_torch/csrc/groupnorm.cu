// Fused GroupNorm(+SiLU) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel cremage_tpu/ops/groupnorm.py (_gn_kernel /
// _gn_pallas, reached through group_norm_silu from models/layers.py
// GroupNorm): per (batch, group) fp32 one-pass moments with the variance
// clamped at 0, then a per-channel affine and an optional SiLU, computed in
// fp32 and rounded once to bf16, the main path's only activation type.
//
// What bounds it on an H100: memory. It does a few operations per element,
// so the least it can take is one read of x and one write of y at the
// card's 3.35 TB/s. In NCHW a (batch, group) slab is contiguous, and on the
// main path slabs run from 5 KB (UNet 8x8) to 240 KB (UNet) and 4 MB (VAE).
//
// gn_cluster, the one-pass route: one thread-block cluster of k CTAs
// (k in 1, 2, 4, 8, 16; 16 is a non-portable size) per slab, each CTA
// holding one piece of it in shared memory, so x is read from device
// memory once:
//   1. one thread issues 1-D bulk copies (cp.async.bulk, no tensor map) of
//      the piece's sub-chunks, each completing on its own mbarrier, so the
//      sums start on the first sub-chunk while later ones land;
//   2. each CTA sums (x, x^2) in fp32 over its piece and leaves the pair in
//      its shared memory; after a cluster barrier every CTA reads the k
//      pairs through DSMEM (mapa + ld.shared::cluster), adds them and
//      forms mean, clamped variance and rstd itself;
//   3. the epilogue normalizes the piece from shared memory with 16-byte
//      vector loads: scale and shift are computed once per channel plane
//      into a table, and each thread steps its channel index forward
//      without a division. SiLU is r * sigmoid(r) with sigmoid(r) =
//      1/2 + tanh(r / 2) / 2 from tanh.approx: one multi-function-unit op
//      per element where ex2.approx + rcp.approx take two, and at one CTA
//      per SM those ops, not memory, set the epilogue's pace. The absolute
//      error of sigmoid stays near 2^-12, so an output moves by at most
//      |r| * 2^-12 (below half a bf16 ulp for |r| >= 1/8). Results go out
//      by 16-byte vector stores, which measured faster on every main-path
//      shape than writing back in place and copying out by
//      cp.async.bulk.global.shared::cta.
//   A second cluster barrier, arrived at once the pairs are read and
//   waited on at exit, keeps each CTA's shared memory alive while its peers
//   may still read its pair. A cluster of one is launched without the
//   cluster attribute and skips both barriers.
// The wrapper's plan (ops/groupnorm.py plan_groupnorm) picks k: the
// smallest cluster whose pieces fit the per-CTA target, else 16 where the
// pieces still fit a CTA's shared memory. The target was measured on the
// card (cremage_tpu_torch/utils/groupnorm_sweep.py, PERF.md section 6).
//
// gn_stats + gn_apply, the two-pass route, for slabs beyond a 16-CTA
// cluster (on the main path only the VAE's (4, 256, 512, 512), 4 MB):
// partial moments per chunk into a scratch tensor, then each block
// recombines its slab's partials and runs the same epilogue from device
// memory. x is read twice there.
//
// Any H*W. Each kernel has two instantiations. kAligned (H*W % 8 == 0,
// every shape of SD1.5 at 512^2, 768^2 and 1024^2): slabs and pieces start
// on 16-byte boundaries and no 8-vector crosses a channel plane, so the
// code above runs as it is. Otherwise (576^2, 640^2, 896^2, SDXL's
// 832x1216, whose lowest UNet level is 26x38) a slab can start off a
// 16-byte boundary and a vector can hold the end of one plane and the
// start of the next. Each piece or chunk is then taken in the aligned
// coordinates of x: a head of fewer than 8 elements up to the first
// 16-byte boundary and a tail after the last one are read and written one
// element at a time, the body between them moves as before (bulk copies,
// 16-byte vectors), and the epilogue finds each element's channel plane
// as it steps through the vector. The general code alone, in three
// variants, ran the aligned shapes 3-18 % slower on an H100 (the epilogue's
// pace is set by its instructions; PERF.md section 6), so they keep theirs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kThreads = 256;
constexpr int kMaxSub = 8;          // sub-chunks (mbarriers) per piece
constexpr int kSmemLimit = 232448;  // shared memory one block can use

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

// Wait for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The float2 at p's offset in the shared memory of cluster CTA `rank`.
__device__ __forceinline__ float2 ld_cluster(const float2* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(remote)
               : "memory");
  return v;
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  return raw;
}

// (sum, sum of squares) of 8 values added into (s, ss)
__device__ __forceinline__ void add_moments(const uint4& raw, float& s, float& ss) {
  float v[8];
  unpack8(raw, v);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s += v[j];
    ss = fmaf(v[j], v[j], ss);
  }
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

// (mean, rstd) from the slab's sums: one-pass moments, variance clamped at 0
__device__ __forceinline__ float2 moments(float2 tot, float count, float eps) {
  const float mean = tot.x / count;
  const float var = fmaxf(tot.y / count - mean * mean, 0.f);
  return make_float2(mean, rsqrtf(var + eps));
}

// Where slab elements [begin, end) lie: channel planes c_first .. of HW.
struct Span {
  int begin, end, c_first, n_ch;
  __device__ Span(int begin_, int end_, int HW)
      : begin(begin_), end(end_), c_first(begin_ / HW),
        n_ch((end_ - 1) / HW - begin_ / HW + 1) {}
};

// table[t] = (w, b) of the span's channel planes; read before the
// statistics are known, so the loads overlap the sums.
__device__ __forceinline__ void load_table(float2* table, const Span& sp, int cbase,
                                           const float* w, const float* bias) {
  for (int t = threadIdx.x; t < sp.n_ch; t += kThreads)
    table[t] = make_float2(w[cbase + t], bias[cbase + t]);
}

// table[t] = (scale, shift) from (w, b) and st = (mean, rstd); each thread
// rewrites the entries it loaded.
__device__ __forceinline__ void finish_table(float2* table, const Span& sp, float2 st) {
  for (int t = threadIdx.x; t < sp.n_ch; t += kThreads) {
    const float sc = st.y * table[t].x;
    table[t] = make_float2(sc, table[t].y - st.x * sc);
  }
}

__device__ __forceinline__ float affine_silu(float v, float2 t, bool silu) {
  const float r = fmaf(v, t.x, t.y);
  return silu ? r * fmaf(0.5f, tanh_approx(0.5f * r), 0.5f) : r;
}

// y = x * scale + shift (+ SiLU) over src[lo, hi) (offsets from sp.begin, a
// multiple of 8 apart), written to dst at the same offsets. Each thread
// steps through its 8-vectors kThreads * 8 apart and carries its channel
// plane forward, so no vector pays a division. H*W % 8 == 0.
__device__ __forceinline__ void normalize(const bf16* src, bf16* dst, const Span& sp,
                                          const float2* table, int lo, int hi, int HW,
                                          bool silu) {
  constexpr int kStep = kThreads * 8;
  int i = lo + (int)threadIdx.x * 8;
  if (i >= hi) return;
  int c = (sp.begin + i) / HW - sp.c_first;
  int off = (sp.begin + i) % HW;
  const int dc = kStep / HW, doff = kStep % HW;
  for (; i < hi; i += kStep) {
    const float2 t = table[c];
    float v[8];
    unpack8(*reinterpret_cast<const uint4*>(src + i), v);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = affine_silu(v[j], t, silu);
    *reinterpret_cast<uint4*>(dst + i) = pack8(v);
    off += doff;
    c += dc;
    if (off >= HW) {
      off -= HW;
      ++c;
    }
  }
}

// Where a piece or chunk of sp.end - sp.begin elements lies in the aligned
// coordinates of x: src/dst index j holds slab element sp.begin - a + j, so
// the piece is [a, a + len) with a < 8 and index 0 on a 16-byte boundary;
// [bh, bt) is its 16-byte-aligned body, [a, bh) its head and [bt, a + len)
// its tail, each shorter than 8.
struct Aligned {
  int a, len, bh, bt;
  __device__ Aligned(int64_t first, int len_)
      : a((int)(first & 7)), len(len_), bh(min((a + 7) & ~7, a + len_)),
        bt(max((a + len_) & ~7, bh)) {}
};

// The epilogue of any H*W: as normalize, over the piece [al.a, al.a +
// al.len) of src/dst in aligned coordinates. A vector inside the piece
// loads and stores 16 bytes and finds each element's channel plane as it
// steps; the head and tail vectors go element by element.
__device__ __forceinline__ void normalize_any(const bf16* src, bf16* dst, const Span& sp,
                                              const Aligned& al, const float2* table,
                                              int HW, bool silu) {
  const int first = sp.begin - al.a;  // slab offset of index 0 (may be < 0)
  const int end = al.a + al.len;
  for (int v0 = (int)threadIdx.x * 8; v0 < end; v0 += kThreads * 8) {
    if (v0 >= al.a && v0 + 8 <= end) {
      const int i = first + v0;
      int c = i / HW - sp.c_first, off = i % HW;
      float v[8];
      unpack8(*reinterpret_cast<const uint4*>(src + v0), v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = affine_silu(v[j], table[c], silu);
        if (++off == HW) {
          off = 0;
          ++c;
        }
      }
      *reinterpret_cast<uint4*>(dst + v0) = pack8(v);
    } else {
      for (int j = max(v0, al.a); j < min(v0 + 8, end); ++j) {
        const float2 t = table[(first + j) / HW - sp.c_first];
        dst[j] = __float2bfloat16_rn(affine_silu(__bfloat162float(src[j]), t, silu));
      }
    }
  }
}

// (sum, sum of squares) of the head and tail elements of `al` in src,
// added into (s, ss); each is read by one thread, which also copies it to
// keep[j] when keep is given.
__device__ __forceinline__ void add_edges(const bf16* src, const Aligned& al, float& s,
                                          float& ss, bf16* keep) {
  const int t = threadIdx.x, n_head = al.bh - al.a;
  const int j = t < n_head ? al.a + t : al.bt + (t - n_head);
  if (t < n_head + (al.a + al.len - al.bt)) {
    const bf16 raw = src[j];
    const float v = __bfloat162float(raw);
    s += v;
    ss = fmaf(v, v, ss);
    if (keep) keep[j] = raw;
  }
}

// grid (k, N * G), cluster (k, 1, 1): CTA r of a cluster holds slab
// elements [r * piece, min((r + 1) * piece, slab)) of slab blockIdx.y in
// dynamic shared memory (aligned coordinates unless kAligned: piece + 16
// elements), followed by its channel table.
template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
    gn_cluster(const bf16* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, bf16* __restrict__ y, int C, int G,
               int HW, int piece, int sub, float eps, int silu) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxSub];
  __shared__ float2 partial;  // this CTA's (sum, sum of squares), read by peers
  __shared__ float2 stats;    // (mean, rstd)

  const int cg = C / G;
  const int slab = cg * HW;
  const int k = gridDim.x;
  const int begin = blockIdx.x * piece;
  const int len = min(piece, slab - begin);
  const Span sp(begin, begin + len, HW);
  const int cbase = (blockIdx.y % G) * cg + sp.c_first;
  const int64_t first = (int64_t)blockIdx.y * slab + begin;
  // kAligned: the piece is all body; else its aligned coordinates
  const Aligned al = kAligned ? Aligned(0, len) : Aligned(first, len);
  const int64_t base = first - al.a;
  bf16* buf = reinterpret_cast<bf16*>(smem);
  float2* table =
      reinterpret_cast<float2*>(smem + (size_t)(kAligned ? piece : piece + 16) * 2);
  const int body = al.bt - al.bh;
  const int n_sub = (body + sub - 1) / sub;

  if (threadIdx.x == 0) {
    for (int s = 0; s < n_sub; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < n_sub; ++s) {
      const int at = al.bh + s * sub;
      const uint32_t bytes = 2u * (uint32_t)min(sub, al.bt - at);
      mbar_expect_tx(smem_u32(&full[s]), bytes);
      bulk_load(smem_u32(buf + at), x + base + at, bytes, smem_u32(&full[s]));
    }
  }
  load_table(table, sp, cbase, w, bias);

  float s = 0.f, ss = 0.f;
  if (!kAligned) add_edges(x + base, al, s, ss, buf);
  for (int q = 0; q < n_sub; ++q) {
    mbar_wait(smem_u32(&full[q]), 0);
    const int hi = min(al.bh + (q + 1) * sub, al.bt);
    for (int i = al.bh + q * sub + (int)threadIdx.x * 8; i < hi; i += kThreads * 8)
      add_moments(*reinterpret_cast<const uint4*>(buf + i), s, ss);
  }
  const float2 mine = block_sum2(s, ss);
  if (k > 1) {  // a cluster of one (launched without one) skips the barriers
    if (threadIdx.x == 0) partial = mine;
    cluster_arrive();  // every CTA's pair is written and visible to the cluster
    cluster_wait();
  }
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float2 p = make_float2(0.f, 0.f);
    if (lane < k) p = k > 1 ? ld_cluster(&partial, lane) : mine;
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {  // k <= 16: lanes 0..15 hold the pairs
      p.x += __shfl_xor_sync(0xffffffffu, p.x, off);
      p.y += __shfl_xor_sync(0xffffffffu, p.y, off);
    }
    if (lane == 0) stats = moments(p, (float)slab, eps);
  }
  __syncthreads();
  if (k > 1) cluster_arrive();  // done reading the peers' pairs
  finish_table(table, sp, stats);
  __syncthreads();
  if (kAligned)
    normalize(buf, y + base, sp, table, 0, len, HW, silu != 0);
  else
    normalize_any(buf, y + base, sp, al, table, HW, silu != 0);
  if (k > 1) cluster_wait();  // no peer reads this CTA's pair any more
}

// grid (n_chunks, N * G): partial (sum, sum of squares) of one chunk.
template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
    gn_stats(const bf16* __restrict__ x, float2* __restrict__ partial, int slab,
             int chunk) {
  const int begin = blockIdx.x * chunk;
  const int len = min(begin + chunk, slab) - begin;
  const int64_t first = (int64_t)blockIdx.y * slab + begin;
  const Aligned al = kAligned ? Aligned(0, len) : Aligned(first, len);
  const bf16* xs = x + (first - al.a);
  float s = 0.f, ss = 0.f;
  if (!kAligned) add_edges(xs, al, s, ss, nullptr);
  for (int i = al.bh + (int)threadIdx.x * 8; i < al.bt; i += kThreads * 8)
    add_moments(*reinterpret_cast<const uint4*>(xs + i), s, ss);
  const float2 tot = block_sum2(s, ss);
  if (threadIdx.x == 0) partial[blockIdx.y * gridDim.x + blockIdx.x] = tot;
}

// grid (n_chunks, N * G): combine the slab's partials, normalize one chunk.
template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
    gn_apply(const bf16* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, bf16* __restrict__ y,
             const float2* __restrict__ partial, int C, int G, int HW, int chunk,
             float eps, int silu) {
  extern __shared__ float2 table[];
  const int cg = C / G;
  const int slab = cg * HW;
  const int begin = blockIdx.x * chunk;
  const Span sp(begin, min(begin + chunk, slab), HW);
  load_table(table, sp, (blockIdx.y % G) * cg + sp.c_first, w, bias);
  const float2* ps = partial + blockIdx.y * gridDim.x;
  float s = 0.f, ss = 0.f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) {
    s += ps[i].x;
    ss += ps[i].y;
  }
  finish_table(table, sp, moments(block_sum2(s, ss), (float)slab, eps));
  __syncthreads();
  const int64_t first = (int64_t)blockIdx.y * slab + begin;
  if (kAligned) {
    normalize(x + first, y + first, sp, table, 0, sp.end - begin, HW, silu != 0);
  } else {
    const Aligned al(first, sp.end - begin);
    normalize_any(x + first - al.a, y + first - al.a, sp, al, table, HW, silu != 0);
  }
}

// Checks shared by both routes: x is (N, C, HW), slabs below 2^31
// elements, N * G within the grid's y limit.
bool valid_shape(int N, int C, int64_t HW, int G) {
  return G > 0 && C % G == 0 && HW > 0 && N > 0 &&
         (int64_t)N * G <= 65535 && (int64_t)(C / G) * HW < (1ll << 31);
}

// Once per instantiation: dynamic shared memory up to the block's limit,
// and clusters of 16 (a non-portable size).
template <bool kAligned>
cudaError_t cluster_attributes() {
  static const cudaError_t err = [] {
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, gn_cluster<kAligned>);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(gn_cluster<kAligned>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit - (int)fa.sharedSizeBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(gn_cluster<kAligned>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  return err;
}

cudaLaunchConfig_t cluster_config(int k, int slabs, int smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k, slabs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = k;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool valid_cluster(int k) { return k == 1 || k == 2 || k == 4 || k == 8 || k == 16; }

}  // namespace

// One pass: x, y contiguous NCHW bf16 (16-byte aligned); w, b fp32 (C,).
// (cluster, piece, sub, smem) is the wrapper's plan (ops/groupnorm.py
// plan_groupnorm): `cluster` CTAs of `piece` elements (a multiple of 8)
// cover each slab, every one non-empty; each piece loads in sub-chunks of
// `sub` elements; smem holds the piece (16 elements more when HW % 8 != 0)
// and C / G table entries. Returns a cudaError_t.
extern "C" int cremage_gn_cluster_bf16(const void* x, const void* w, const void* b,
                                       void* y, int N, int C, int64_t HW, int G,
                                       int cluster, int piece, int sub, int smem,
                                       float eps, int silu, void* stream) {
  if (!valid_shape(N, C, HW, G) || !valid_cluster(cluster) || piece <= 0 ||
      piece % 8 != 0 || sub <= 0 || sub % 8 != 0 || (piece + sub - 1) / sub > kMaxSub)
    return (int)cudaErrorInvalidValue;
  const bool aligned = HW % 8 == 0;
  const int64_t slab = (int64_t)(C / G) * HW;
  if ((int64_t)(cluster - 1) * piece >= slab || (int64_t)cluster * piece < slab ||
      (int64_t)smem < 2ll * (piece + (aligned ? 0 : 16)) + 8ll * (C / G))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = aligned ? cluster_attributes<true>() : cluster_attributes<false>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(cluster, N * G, smem, static_cast<cudaStream_t>(stream), &attr);
  if (cluster == 1) cfg.numAttrs = 0;  // a plain launch
  e = cudaLaunchKernelEx(&cfg, aligned ? gn_cluster<true> : gn_cluster<false>,
                         static_cast<const bf16*>(x), static_cast<const float*>(w),
                         static_cast<const float*>(b), static_cast<bf16*>(y), C, G,
                         (int)HW, piece, sub, eps, silu);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` CTAs with `smem` bytes of dynamic shared
// memory each can be resident at once (cudaOccupancyMaxActiveClusters) for
// the instantiation of H*W % 8 == 0 (`aligned`) or the other, into
// *active. Returns a cudaError_t.
extern "C" int cremage_gn_cluster_occupancy(int cluster, int smem, int aligned,
                                            int* active) {
  if (!valid_cluster(cluster) || smem < 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = aligned ? cluster_attributes<true>() : cluster_attributes<false>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, 1, smem, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(
      active, aligned ? gn_cluster<true> : gn_cluster<false>, &cfg);
}

// Two passes: as above; partial is fp32 scratch of N * G * n_chunks * 2;
// chunk % 8 == 0 and n_chunks chunks cover each slab, none empty. Returns a
// cudaError_t.
extern "C" int cremage_gn_two_pass_bf16(const void* x, const void* w, const void* b,
                                        void* y, void* partial, int N, int C,
                                        int64_t HW, int G, int n_chunks, int chunk,
                                        float eps, int silu, void* stream) {
  if (!valid_shape(N, C, HW, G) || chunk <= 0 || chunk % 8 != 0 || n_chunks < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t slab = (int64_t)(C / G) * HW;
  if ((int64_t)(n_chunks - 1) * chunk >= slab || (int64_t)n_chunks * chunk < slab)
    return (int)cudaErrorInvalidValue;
  const bool aligned = HW % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_chunks, N * G);
  (aligned ? gn_stats<true> : gn_stats<false>)<<<grid, kThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<float2*>(partial), (int)slab, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t table = sizeof(float2) * (C / G);
  (aligned ? gn_apply<true> : gn_apply<false>)<<<grid, kThreads, table, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<bf16*>(y),
      static_cast<const float2*>(partial), C, G, (int)HW, chunk, eps, silu);
  return (int)cudaGetLastError();
}
