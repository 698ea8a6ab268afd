// Blockwise (flash) causal GQA attention, fp32 or bf16 in, fp32 inside:
//   out[b,i,h] = softmax_j(scale * q[b,i,h] . k[b,j,h/g]) v[b,j,h/g]
// q (B,Sq,Hq,D), k/v (B,Sk,Hk,D) with any (batch, sequence, head)
// strides and a unit stride along D; g = Hq / Hk; scale = D**-0.5.  Key j
// is visible to query i iff j < Sk and, when causal, j <= q_offset + i.
// Masked scores are -1e30; the output is acc / max(l, 1e-30) in q's type.
// When the caller gives an `lse` buffer (B, Hq, Sq) fp32, every form also
// writes each row's log-sum-exp, lse = m + log(max(l, 1e-30)) in natural
// units of the scaled scores -- the one that normalised o, which the
// backward (flash_attention_bwd.cu) uses to recompute P = exp(s - lse).
// A null `lse` writes nothing, so serving is unchanged bit for bit.
//
// Replaces repro/kernels/attention.py::flash_attention_pallas (body
// _flash_kernel), whose grid (B, Hq, q block, kv block) carried the
// running max m, normalizer l and accumulator in VMEM scratch across the
// SEQUENTIAL kv axis and skipped kv blocks past the diagonal.  CUDA blocks
// run in no order, so the kv axis becomes a loop inside a CTA, m, l and
// acc in registers.  No atomics anywhere: every output is a fixed
// sequence of operations, so reruns are bit-identical.
//
// The order argument.  m starts at -1e30 and a CTA walks its keys from
// the lowest up.  A row's first kv block holds key 0, which every row
// sees (the wrapper refuses a causal q_offset < 0), so no row adds
// exp(0) terms for a block it cannot see.  The split form's later splits
// break this, so its masked keys add p = 0 explicitly and a partial that
// sees no key is weighed by exp(-1e30 - M) = 0 in the combine.
//
// Three forms; kernels/attention.py::plan picks one per call from the
// shapes.  "Rows" are the (query, head of the GQA group) pairs of one kv
// head, Sq * g.
//
// 1. tile (fp32, head_dim 16 / 32 / 80, and bf16 rows that fill no 64-row
//    tile; 80's 160-byte bf16 rows fit none of the TMA swizzle widths of
//    form 2): one CTA per (b, h, 16 query rows), 4 rows per warp; per kv
//    block of 32 keys the K and V rows are staged in shared memory as
//    fp32 (K rows padded to D + 1 floats, conflict-free), lane j scores
//    key j, a butterfly max / sum gives every lane the same m and l, and
//    lane t owns dims t, t + 32, ... of acc.  fp32 SIMT FMAs: TF32 would
//    leave the fp32 class, and in fp32 this form already beats SDPA.
//    Bound: operations (4 D flops per visible pair).
//
// 2. wgmma (bf16 prefill, head_dim 64 / 128 / 256): a CTA owns (b, kv
//    head, 64 rows) -- the g query heads of a group share every K/V tile,
//    so K/V cross device memory once per group and row tile.  Warps 0-3
//    are one consumer warpgroup, warp 4 the producer: one thread issues
//    TMA loads of 64-key K and V tiles (128-byte swizzle, 64-column
//    panels) into a ring of 2 stages under full / empty mbarriers; the
//    tensor map comes from cuTensorMapEncodeTiled reached through
//    cudaGetDriverEntryPoint, so the library needs no -lcuda (these
//    helpers, the wgmma products and the hi/lo split are hopper.cuh's,
//    shared with the backward's wgmma form).  Rows past
//    Sk arrive as zeros and are masked.  The consumers load q into the
//    same swizzled layout by hand and issue
//      S = Q K^T   wgmma m64n64k16, A and B K-major from shared memory;
//    S is scaled by D**-0.5 log2(e) in fp32 after the product (the bf16
//    products are exact in fp32), masked where a tile is not visible
//    whole, and the online softmax runs in base 2 (exp2f) on the
//    accumulator fragment (each row lives in one quad: two shuffles).
//      O += P V    wgmma m64nDk16, P from registers, V MN-major (the
//                  transpose bit) from shared memory.
//    Numerics, the trap: the reference keeps P in fp32, and one bf16 P
//    would leave the one-bf16-ulp class the kernel is held to.  So P is
//    split, p_hi = bf16(p), p_lo = bf16(p - p_hi), and both products go
//    into the same fp32 accumulator: p_hi + p_lo keeps ~16 mantissa bits
//    (relative error near 2^-17) for 1.5x the MMA work, and the bound
//    stays far below the kernel's time.  The accumulator fragment of S
//    is the A-operand fragment of P, element for element, so the repack
//    is a conversion in registers.  Bound: operations.  160 threads: two
//    CTAs share an SM at D <= 128 (at most 204 registers a thread), one
//    at D = 256 (255), so the producer needs no setmaxnreg to hand its
//    registers over, and the other CTA's softmax fills the tensor cores'
//    idle time.  The causal block skip is kept, and the row tiles with
//    the most kv blocks start first.
//
// 3. split (rows <= 8: the engine's decode, Sq = 1; fp32 and bf16): a
//    thread-block cluster of `splits` CTAs per (b, kv head), each over a
//    slice of whole 64-key tiles of the live cache, with 16-byte
//    cp.async loads (double-buffered where two stages fit) and the fp32
//    SIMT math of form 1 for all rows of its kv head; each of its two
//    warps takes 32 keys of a tile.  The (split, warp) partials (m, l,
//    acc) go to shared memory, and after a cluster barrier each row is
//    combined from distributed shared memory in the fixed order (split,
//    warp) -- one launch, no scratch, no atomics, nothing encoded on the
//    host: a decode step's time is the host's.  Bound: bytes (the live
//    cache read once).
#include <cooperative_groups.h>
#include <cuda.h>           // CUtensorMap and its enums; no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

enum Form { FORM_TILE = 0, FORM_WGMMA = 1, FORM_SPLIT = 2 };

struct AttnArgs {
  int64_t B, Sq, Sk, Hq, Hk, q_offset;
  int causal;
  float scale;
  int64_t q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
  float* lse;   // (B, Hq, Sq) row log-sum-exps, or null
};

// Row (b, h, i)'s log-sum-exp, from its max m and normaliser l in natural
// units.
__device__ __forceinline__ void store_lse(const AttnArgs& a, int64_t b,
                                          int64_t h, int64_t i, float m,
                                          float l) {
  a.lse[(b * a.Hq + h) * a.Sq + i] = m + logf(fmaxf(l, 1e-30f));
}

// 16 bytes of T along D as fp32.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  __device__ __forceinline__ static float store(float x) { return x; }
  __device__ __forceinline__ static float to_float(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  // Round to nearest even, as torch's .to(torch.bfloat16).
  __device__ __forceinline__ static __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);
  }
  __device__ __forceinline__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
};

__device__ __forceinline__ int64_t min64(int64_t x, int64_t y) {
  return x < y ? x : y;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// A butterfly: each step adds a commuted pair, so every lane ends with
// the same bits.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// Form 1: tile.

constexpr int kWarps = 4;
constexpr int kRows = 4;                  // query rows per warp
constexpr int kBlockQ = kWarps * kRows;   // query rows per CTA
constexpr int kBlockK = 32;               // keys per kv block: one per lane
constexpr int kThreads = kWarps * 32;

template <int D>
constexpr size_t tile_smem_bytes() {
  return sizeof(float) * (kBlockQ * D + kBlockK * (D + 1) + kBlockK * D);
}
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_tile_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v, T* __restrict__ o,
                                AttnArgs a) {
  constexpr int N = Vec<T>::N;
  constexpr int VPR = D / N;              // 16-byte vectors per row
  constexpr int KS = D + 1;               // padded K row
  constexpr int ACC = (D + 31) / 32;      // output dims per lane
  extern __shared__ float smem[];
  float* qs = smem;                       // [kBlockQ][D], scaled q
  float* ks = qs + kBlockQ * D;           // [kBlockK][KS]
  float* vs = ks + kBlockK * KS;          // [kBlockK][D]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t q0 = (int64_t)blockIdx.x * kBlockQ;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t hk = h / (a.Hq / a.Hk);
  const T* qp = q + b * a.q_b + h * a.q_h;
  const T* kp = k + b * a.k_b + hk * a.k_h;
  const T* vp = v + b * a.v_b + hk * a.v_h;

  for (int i = threadIdx.x; i < kBlockQ * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * N;
    float buf[N];
    if (q0 + r < a.Sq) {
      Vec<T>::load(qp + (q0 + r) * a.q_s + c, buf);
#pragma unroll
      for (int e = 0; e < N; ++e) buf[e] *= a.scale;
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) buf[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) qs[r * D + c + e] = buf[e];
  }

  const int64_t q_last = min64(a.Sq, q0 + kBlockQ) - 1;
  const int64_t kv_end =
      a.causal ? min64(a.Sk, a.q_offset + q_last + 1) : a.Sk;
  const int64_t row0 = q0 + warp * kRows;
  const bool warp_live = row0 < a.Sq;
  const float* qw = qs + warp * kRows * D;

  float m[kRows], l[kRows], acc[kRows][ACC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[r][i] = 0.0f;
  }
  __syncthreads();

  for (int64_t kv0 = 0; kv0 < kv_end; kv0 += kBlockK) {
    for (int i = threadIdx.x; i < kBlockK * VPR; i += kThreads) {
      const int j = i / VPR, c = (i % VPR) * N;
      float kb[N], vb[N];
      if (kv0 + j < a.Sk) {
        Vec<T>::load(kp + (kv0 + j) * a.k_s + c, kb);
        Vec<T>::load(vp + (kv0 + j) * a.v_s + c, vb);
      } else {   // past Sk: masked, and zeros keep p * v finite
#pragma unroll
        for (int e = 0; e < N; ++e) kb[e] = vb[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < N; ++e) {
        ks[j * KS + c + e] = kb[e];
        vs[j * D + c + e] = vb[e];
      }
    }
    __syncthreads();

    if (warp_live) {
      float s[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = 0.0f;
      const float* krow = ks + lane * KS;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float k0 = krow[d], k1 = krow[d + 1], k2 = krow[d + 2],
                    k3 = krow[d + 3];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 qv = *reinterpret_cast<const float4*>(qw + r * D + d);
          s[r] = fmaf(qv.x, k0, s[r]);
          s[r] = fmaf(qv.y, k1, s[r]);
          s[r] = fmaf(qv.z, k2, s[r]);
          s[r] = fmaf(qv.w, k3, s[r]);
        }
      }
      const int64_t key = kv0 + lane;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bool live = key < a.Sk &&
                          (!a.causal || key <= a.q_offset + row0 + r);
        const float sr = live ? s[r] : kNegInf;
        const float m_new = fmaxf(m[r], warp_max(sr));
        const float p = expf(sr - m_new);
        const float corr = expf(m[r] - m_new);
        l[r] = l[r] * corr + warp_sum(p);
        m[r] = m_new;
#pragma unroll
        for (int i = 0; i < ACC; ++i) acc[r][i] *= corr;
        s[r] = p;
      }
#pragma unroll 4
      for (int j = 0; j < kBlockK; ++j) {
        float pj[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) pj[r] = __shfl_sync(kFull, s[r], j);
        const float* vrow = vs + j * D;
#pragma unroll
        for (int i = 0; i < ACC; ++i) {
          const int d = lane + 32 * i;
          if (d < D) {
            const float vv = vrow[d];
#pragma unroll
            for (int r = 0; r < kRows; ++r)
              acc[r][i] = fmaf(pj[r], vv, acc[r][i]);
          }
        }
      }
    }
    __syncthreads();
  }

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t row = row0 + r;
    if (row >= a.Sq) break;
    const float l_safe = fmaxf(l[r], 1e-30f);
    if (a.lse != nullptr && lane == 0) store_lse(a, b, h, row, m[r], l[r]);
    T* orow = o + b * a.o_b + row * a.o_s + h * a.o_h;
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int d = lane + 32 * i;
      if (d < D) orow[d] = Vec<T>::store(acc[r][i] / l_safe);
    }
  }
}


// ---------------------------------------------------------------------------
// Form 3: split.

constexpr int kSplitWarps = 2;
constexpr int kSplitThreads = kSplitWarps * 32;
constexpr int kSplitTile = kSplitWarps * 32;   // keys per kv tile
constexpr int kMaxSplits = 8;                  // the portable cluster size
constexpr size_t kSplitStagesBudget = 160 * 1024;

template <typename T, int D, int R>
struct SplitLayout {
  static constexpr int KP = D + 16 / (int)sizeof(T);  // padded K row
  static constexpr size_t kStage = sizeof(T) * kSplitTile * (KP + D);
  static constexpr int kStages = 2 * kStage <= kSplitStagesBudget ? 2 : 1;
  static constexpr size_t kQ = sizeof(float) * R * D;
  static constexpr size_t kParts = sizeof(float) * kSplitWarps * R * (D + 2);
  static constexpr size_t kSmem = kQ + kStages * kStage + kParts;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// R: the rows a CTA can hold (2 or 8); the rows of this call, Sq * g,
// are at most R.  Grid (splits, B * Hk), cluster (splits, 1, 1).
template <typename T, int D, int R>
__global__ void __launch_bounds__(kSplitThreads)
    flash_attention_split_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v, T* __restrict__ o,
                                 AttnArgs a, int splits) {
  using L = SplitLayout<T, D, R>;
  constexpr int N = Vec<T>::N;
  constexpr int VPR = D / N;              // 16-byte vectors per row
  constexpr int ACC = (D + 31) / 32;      // output dims per lane
  extern __shared__ __align__(16) unsigned char split_smem[];
  float* qs = reinterpret_cast<float*>(split_smem);               // [R][D]
  T* stages = reinterpret_cast<T*>(split_smem + L::kQ);
  float* part_m = reinterpret_cast<float*>(split_smem + L::kQ +
                                           L::kStages * L::kStage);
  float* part_l = part_m + kSplitWarps * R;                     // [2][R]
  float* part_acc = part_l + kSplitWarps * R;                   // [2][R][D]

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t b = blockIdx.y / a.Hk, hk = blockIdx.y % a.Hk;
  const int64_t g = a.Hq / a.Hk;
  const int rows = (int)(a.Sq * g);
  const T* kp = k + b * a.k_b + hk * a.k_h;
  const T* vp = v + b * a.v_b + hk * a.v_h;

  // Row r is query r / g of head hk * g + r % g.
  for (int i = threadIdx.x; i < R * VPR; i += kSplitThreads) {
    const int r = i / VPR, c = (i % VPR) * N;
    float buf[N];
    if (r < rows) {
      Vec<T>::load(q + b * a.q_b + (r / g) * a.q_s + (hk * g + r % g) * a.q_h
                       + c, buf);
#pragma unroll
      for (int e = 0; e < N; ++e) buf[e] *= a.scale;
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) buf[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) qs[r * D + c + e] = buf[e];
  }

  const int64_t kv_end = a.causal ? min64(a.Sk, a.q_offset + a.Sq) : a.Sk;
  const int64_t tiles = (a.Sk + kSplitTile - 1) / kSplitTile;
  const int64_t chunk = (tiles + splits - 1) / splits * kSplitTile;
  const int64_t k_begin = split * chunk;
  const int64_t k_stop = min64(k_begin + chunk, kv_end);
  const int n_tiles = k_stop > k_begin
                          ? (int)((k_stop - k_begin + kSplitTile - 1) /
                                  kSplitTile)
                          : 0;

  auto load_tile = [&](int t, int stage) {
    const int64_t kv0 = k_begin + (int64_t)t * kSplitTile;
    T* ks = stages + stage * (L::kStage / sizeof(T));
    T* vs = ks + kSplitTile * L::KP;
    for (int i = threadIdx.x; i < kSplitTile * VPR; i += kSplitThreads) {
      const int j = i / VPR, c = (i % VPR) * N;
      const bool valid = kv0 + j < k_stop;
      const int64_t key = valid ? kv0 + j : 0;
      cp_async16(ks + j * L::KP + c, kp + key * a.k_s + c, valid);
      cp_async16(vs + j * D + c, vp + key * a.v_s + c, valid);
    }
    cp_async_commit();
  };

  float m[R], l[R], acc[R][ACC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[r][i] = 0.0f;
  }

  if (n_tiles > 0) load_tile(0, 0);
  for (int t = 0; t < n_tiles; ++t) {
    if (L::kStages == 2 && t + 1 < n_tiles) {
      load_tile(t + 1, (t + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = stages + (L::kStages == 2 ? (t & 1) : 0) *
                               (L::kStage / sizeof(T)) +
                  warp * 32 * L::KP;
    const T* vs = stages + (L::kStages == 2 ? (t & 1) : 0) *
                               (L::kStage / sizeof(T)) +
                  kSplitTile * L::KP + warp * 32 * D;
    const int64_t key = k_begin + (int64_t)t * kSplitTile + warp * 32 + lane;

    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.0f;
    const T* krow = ks + lane * L::KP;
#pragma unroll 2
    for (int d = 0; d < D; d += N) {
      float kv[N];
      Vec<T>::load(krow + d, kv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int e = 0; e < N; e += 4) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qs + r * D + d + e);
          s[r] = fmaf(qv.x, kv[e], s[r]);
          s[r] = fmaf(qv.y, kv[e + 1], s[r]);
          s[r] = fmaf(qv.z, kv[e + 2], s[r]);
          s[r] = fmaf(qv.w, kv[e + 3], s[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool live = r < rows && key < k_stop &&
                        (!a.causal || key <= a.q_offset + r / g);
      const float sr = live ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float p = live ? expf(sr - m_new) : 0.0f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[r][i] *= corr;
      s[r] = p;
    }
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      float pj[R];
#pragma unroll
      for (int r = 0; r < R; ++r) pj[r] = __shfl_sync(kFull, s[r], j);
      const T* vrow = vs + j * D;
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          const float vv = Vec<T>::to_float(vrow[d]);
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][i] = fmaf(pj[r], vv, acc[r][i]);
        }
      }
    }
    __syncthreads();
    if (L::kStages == 1 && t + 1 < n_tiles) load_tile(t + 1, 0);
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      part_m[warp * R + r] = m[r];
      part_l[warp * R + r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int d = lane + 32 * i;
      if (d < D) part_acc[(warp * R + r) * D + d] = acc[r][i];
    }
  }
  cluster.sync();

  // Warp w of split s combines rows s * 2 + w, + 2 * splits, ... over
  // every (split, warp) partial, in that order.
  for (int r = split * kSplitWarps + warp; r < rows;
       r += splits * kSplitWarps) {
    float M = kNegInf;
    for (int s = 0; s < splits; ++s) {
      const float* pm = cluster.map_shared_rank(part_m, s);
#pragma unroll
      for (int w = 0; w < kSplitWarps; ++w) M = fmaxf(M, pm[w * R + r]);
    }
    float lsum = 0.0f, out[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) out[i] = 0.0f;
    for (int s = 0; s < splits; ++s) {
      const float* pm = cluster.map_shared_rank(part_m, s);
      const float* pl = cluster.map_shared_rank(part_l, s);
      const float* pa = cluster.map_shared_rank(part_acc, s);
#pragma unroll
      for (int w = 0; w < kSplitWarps; ++w) {
        const float wgt = expf(pm[w * R + r] - M);
        lsum = fmaf(wgt, pl[w * R + r], lsum);
#pragma unroll
        for (int i = 0; i < ACC; ++i) {
          const int d = lane + 32 * i;
          if (d < D) out[i] = fmaf(wgt, pa[(w * R + r) * D + d], out[i]);
        }
      }
    }
    const float l_safe = fmaxf(lsum, 1e-30f);
    if (a.lse != nullptr && lane == 0)
      store_lse(a, b, hk * g + r % g, r / g, M, lsum);
    T* orow = o + b * a.o_b + (r / g) * a.o_s + (hk * g + r % g) * a.o_h;
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int d = lane + 32 * i;
      if (d < D) orow[d] = Vec<T>::store(out[i] / l_safe);
    }
  }
  // No CTA leaves while another may still read its shared memory.
  cluster.sync();
}

// ---------------------------------------------------------------------------
// Form 2: wgmma.

constexpr int kWgKeys = 64;                     // keys per kv tile

// One consumer warpgroup (64 rows) and one producer warp per CTA, a ring
// of 2 K/V stages; two CTAs share an SM at D <= 128.  (Two consumer
// warpgroups of 64 rows sharing each K/V tile, with 2 or 4 stages, halve
// the K/V traffic but measured no faster on the H100: PERF.md.)
template <int D>
struct WgLayout {
  static constexpr int kStages = 2;
  static constexpr int kConsumers = 128;
  static constexpr int kThreads = kConsumers + 32;
  static constexpr int kRows = 64;                     // rows per CTA
  static constexpr int kTile = D / 64 * kPanelBytes;   // Q, K or V tile
  static constexpr int kStage = 2 * kTile;             // K, then V
  static constexpr int kBars = kTile + kStages * kStage;
  // 1024 bytes of slack to align the swizzled panels.
  static constexpr size_t kSmem = 1024 + kBars + 2 * kStages * 8;
};

// Grid (row tiles, Hk, B); row r of tile t is query (64 t + r) / g of
// head hk * g + (64 t + r) % g.
template <int D>
__global__ void __launch_bounds__(WgLayout<D>::kThreads, D <= 128 ? 2 : 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v,
                                 const __nv_bfloat16* __restrict__ q,
                                 __nv_bfloat16* __restrict__ o, AttnArgs a) {
  using L = WgLayout<D>;
  constexpr int NACC = D / 2;   // O accumulator registers per thread
  extern __shared__ __align__(128) unsigned char wg_smem[];
  unsigned char* base =
      wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  unsigned char* qs = base;
  unsigned char* kv = base + L::kTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + L::kStages;

  // The tiles with the most kv blocks start first.
  const int64_t tile = gridDim.x - 1 - blockIdx.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int64_t g = a.Hq / a.Hk;
  const int64_t rows = a.Sq * g;
  const int64_t row0 = tile * L::kRows;
  const int64_t i_last = min64(a.Sq - 1, (row0 + L::kRows - 1) / g);
  const int64_t kv_end =
      a.causal ? min64(a.Sk, a.q_offset + i_last + 1) : a.Sk;
  const int n_tiles = (int)((kv_end + kWgKeys - 1) / kWgKeys);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], L::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= L::kConsumers) {
    // The producer: one thread keeps the ring of K/V stages full.
    if (threadIdx.x == L::kConsumers) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % L::kStages;
        if (t >= L::kStages)
          mbar_wait(&empty[s], ((t / L::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::kStage);
        unsigned char* ks = kv + s * L::kStage;
#pragma unroll
        for (int p = 0; p < D / 64; ++p) {
          tma_load(ks + p * kPanelBytes, &tm_k, &full[s], 64 * p, hk,
                   t * kWgKeys, b);
          tma_load(ks + L::kTile + p * kPanelBytes, &tm_v, &full[s], 64 * p,
                   hk, t * kWgKeys, b);
        }
      }
    }
    return;
  }

  // The consumer warpgroup.  q rows into the swizzled panels: chunk c of
  // row r (16 bytes) lands at chunk c ^ (r % 8), as TMA lays out K and V.
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int idx = tid; idx < 64 * (D / 8); idx += 128) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const int64_t row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows)
      val = *reinterpret_cast<const uint4*>(
          q + b * a.q_b + (row / g) * a.q_s + (hk * g + row % g) * a.q_h + c);
    *reinterpret_cast<uint4*>(qs + (c / 64) * kPanelBytes + r * 128 +
                              ((((c % 64) / 8) ^ (r & 7)) * 16)) = val;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, 128;\n" ::: "memory");

  // This thread's fragment rows: ra and ra + 8; its columns: cq, cq + 1
  // of every 8.
  const int ra = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  int64_t qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qpos[h] = a.q_offset + (row0 + ra + 8 * h) / g;
  const float scale2 = a.scale * 1.4426950408889634f;   // log2(e)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
  float S[32];
  uint32_t hi[16], lo[16];

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % L::kStages;
    mbar_wait(&full[s], (t / L::kStages) & 1);
    const unsigned char* ks = kv + s * L::kStage;
    const unsigned char* vs = ks + L::kTile;

    // S = Q K^T.
#pragma unroll
    for (int i = 0; i < 32; ++i) S[i] = 0.0f;
    pin<32>(S);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
      wgmma_ss_n64(S, smem_desc(qs + off, 16, 1024),
                   smem_desc(ks + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    pin<32>(S);

    // Scale, mask and the online softmax, in base 2: s2 = s * scale *
    // log2(e), p = 2^(s2 - m2).  S[i] is row ra + 8 ((i / 2) % 2), key
    // kv0 + 8 (i / 4) + cq + i % 2.  A tile every row of the CTA sees
    // whole needs no mask; elsewhere row h sees the keys below
    // lim[h].  A masked score is -1e30, and its p = 2^(-1e30 - m2) is 0:
    // m2 is finite from the first tile on, which holds key 0.
    const int64_t kv0 = (int64_t)t * kWgKeys;
    float mx[2] = {m[0], m[1]};
    if (kv0 + kWgKeys <= a.Sk &&
        (!a.causal || kv0 + kWgKeys - 1 <= a.q_offset + row0 / g)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        S[i] *= scale2;
        mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], S[i]);
      }
    } else {
      int lim[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t end = a.causal ? min64(a.Sk, qpos[h] + 1) : a.Sk;
        lim[h] = (int)min64(kWgKeys, end > kv0 ? end - kv0 : 0);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i / 2) & 1;
        S[i] = 8 * (i / 4) + cq + (i & 1) < lim[h] ? S[i] * scale2 : kNegInf;
        mx[h] = fmaxf(mx[h], S[i]);
      }
    }
    float corr[2], rsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      corr[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i / 2) & 1;
      S[i] = exp2f(S[i] - m[h]);
      rsum[h] += S[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rsum[h] += __shfl_xor_sync(kFull, rsum[h], 1);
      rsum[h] += __shfl_xor_sync(kFull, rsum[h], 2);
      l[h] = l[h] * corr[h] + rsum[h];
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] *= corr[(i / 2) & 1];

    // P as two bf16 A operands: the S fragment of keys 16 kk .. 16 kk + 15
    // is the A fragment of that k16 step, element for element.
#pragma unroll
    for (int i = 0; i < 16; ++i)
      split_pair(S[2 * i], S[2 * i + 1], hi[i], lo[i]);
    pin<16>(hi);
    pin<16>(lo);
    pin<NACC>(acc);

    // O += P_hi V + P_lo V.
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(acc, hi + 4 * kk,
                  smem_desc(vs + kk * 2048, kPanelBytes, 1024));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(acc, lo + 4 * kk,
                  smem_desc(vs + kk * 2048, kPanelBytes, 1024));
    wg_commit();
    wg_wait_all();
    pin<NACC>(acc);
    pin<16>(hi);
    pin<16>(lo);
    mbar_arrive(&empty[s]);
  }

  // acc[4 j + 2 h + e] is row ra + 8 h, column 8 j + cq + e.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t row = row0 + ra + 8 * h;
    if (row >= rows) continue;
    const float l_safe = fmaxf(l[h], 1e-30f);
    // m is in base-2 units (s * scale * log2(e)); l sums the same p that
    // normalised acc -- the hi/lo split of P touched neither.  The four
    // lanes of a quad hold the same row's m and l.
    if (a.lse != nullptr && (lane & 3) == 0)
      store_lse(a, b, hk * g + row % g, row / g,
                m[h] * 0.6931471805599453f, l[h]);
    __nv_bfloat16* orow =
        o + b * a.o_b + (row / g) * a.o_s + (hk * g + row % g) * a.o_h + cq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] / l_safe,
                                acc[4 * j + 2 * h + 1] / l_safe);
  }
}

// ---------------------------------------------------------------------------
// Launches.
template <typename T, int D>
cudaError_t launch_tile(const void* q, const void* k, const void* v, void* o,
                        const AttnArgs& a, cudaStream_t stream) {
  constexpr size_t smem = tile_smem_bytes<D>();
  auto kern = flash_attention_tile_kernel<T, D>;
  static std::atomic<uint64_t> done{0};
  cudaError_t err = allow_smem(kern, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.Sq + kBlockQ - 1) / kBlockQ),
                  (unsigned)a.Hq, (unsigned)a.B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), a);
  return cudaGetLastError();
}

template <typename T, int D, int R>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         void* o, const AttnArgs& a, int splits,
                         cudaStream_t stream) {
  constexpr size_t smem = SplitLayout<T, D, R>::kSmem;
  auto kern = flash_attention_split_kernel<T, D, R>;
  static std::atomic<uint64_t> done{0};
  cudaError_t err = allow_smem(kern, smem, done);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)splits, (unsigned)(a.B * a.Hk), 1);
  cfg.blockDim = dim3(kSplitThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(q),
                           static_cast<const T*>(k),
                           static_cast<const T*>(v), static_cast<T*>(o), a,
                           splits);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// K or V (B, Sk, Hk, D) as 64-key panels (hopper.cuh::tile_map); reads
// past Sk fill zeros.
cudaError_t kv_map(CUtensorMap* map, const void* base, const AttnArgs& a,
                   int64_t D, int64_t s_b, int64_t s_s, int64_t s_h) {
  return tile_map(map, base, D, a.Hk, a.Sk, a.B, s_b, s_s, s_h);
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, const AttnArgs& a, cudaStream_t stream) {
  CUtensorMap tm_k, tm_v;
  cudaError_t err = kv_map(&tm_k, k, a, D, a.k_b, a.k_s, a.k_h);
  if (err == cudaSuccess) err = kv_map(&tm_v, v, a, D, a.v_b, a.v_s, a.v_h);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = WgLayout<D>::kSmem;
  auto kern = flash_attention_wgmma_kernel<D>;
  static std::atomic<uint64_t> done{0};
  err = allow_smem(kern, smem, done);
  if (err != cudaSuccess) return err;
  const int64_t rows = a.Sq * (a.Hq / a.Hk);
  const dim3 grid((unsigned)((rows + WgLayout<D>::kRows - 1) /
                             WgLayout<D>::kRows),
                  (unsigned)a.Hk, (unsigned)a.B);
  kern<<<grid, WgLayout<D>::kThreads, smem, stream>>>(
      tm_k, tm_v, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(o), a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_split_rows(const void* q, const void* k, const void* v,
                              void* o, const AttnArgs& a, int splits,
                              cudaStream_t stream) {
  return a.Sq * (a.Hq / a.Hk) <= 2
             ? launch_split<T, D, 2>(q, k, v, o, a, splits, stream)
             : launch_split<T, D, 8>(q, k, v, o, a, splits, stream);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             int64_t D, const AttnArgs& a, int64_t form, int64_t splits,
             void* stream) {
  if (a.B > 65535 || a.Hq > 65535 || a.Hk < 1 || a.Hq % a.Hk != 0 ||
      a.Sk < 1 || (a.causal && a.q_offset < 0))
    return (int)cudaErrorInvalidValue;
  if (a.B == 0 || a.Sq == 0 || a.Hq == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == FORM_SPLIT) {
    if (a.Sq * (a.Hq / a.Hk) > 8 || splits < 1 || splits > kMaxSplits ||
        a.B * a.Hk > 65535)
      return (int)cudaErrorInvalidValue;
    const int n = (int)splits;
    switch (D) {
      case 16: return (int)launch_split_rows<T, 16>(q, k, v, o, a, n, st);
      case 32: return (int)launch_split_rows<T, 32>(q, k, v, o, a, n, st);
      case 64: return (int)launch_split_rows<T, 64>(q, k, v, o, a, n, st);
      case 80: return (int)launch_split_rows<T, 80>(q, k, v, o, a, n, st);
      case 128: return (int)launch_split_rows<T, 128>(q, k, v, o, a, n, st);
      case 256: return (int)launch_split_rows<T, 256>(q, k, v, o, a, n, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (form == FORM_WGMMA) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      switch (D) {
        case 64: return (int)launch_wgmma<64>(q, k, v, o, a, st);
        case 128: return (int)launch_wgmma<128>(q, k, v, o, a, st);
        case 256: return (int)launch_wgmma<256>(q, k, v, o, a, st);
        default: break;
      }
    }
    return (int)cudaErrorInvalidValue;
  }
  if (form != FORM_TILE) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return (int)launch_tile<T, 16>(q, k, v, o, a, st);
    case 32: return (int)launch_tile<T, 32>(q, k, v, o, a, st);
    case 64: return (int)launch_tile<T, 64>(q, k, v, o, a, st);
    case 80: return (int)launch_tile<T, 80>(q, k, v, o, a, st);
    case 128: return (int)launch_tile<T, 128>(q, k, v, o, a, st);
    case 256: return (int)launch_tile<T, 256>(q, k, v, o, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

AttnArgs make_args(void* lse, int64_t B, int64_t Sq, int64_t Sk, int64_t Hq,
                   int64_t Hk, int64_t causal, int64_t q_offset, float scale,
                   int64_t q_b, int64_t q_s, int64_t q_h, int64_t k_b,
                   int64_t k_s, int64_t k_h, int64_t v_b, int64_t v_s,
                   int64_t v_h, int64_t o_b, int64_t o_s, int64_t o_h) {
  return AttnArgs{B,   Sq,  Sk,  Hq,  Hk,  q_offset, (int)causal, scale,
                  q_b, q_s, q_h, k_b, k_s, k_h,      v_b,         v_s,
                  v_h, o_b, o_s, o_h, static_cast<float*>(lse)};
}

}  // namespace

// q (B,Sq,Hq,D), k/v (B,Sk,Hk,D) -> o (B,Sq,Hq,D), fp32; strides in
// elements, unit along D, 16-byte aligned.  `lse` is null or a contiguous
// fp32 (B,Hq,Sq) buffer for the rows' log-sum-exps.  `form` is 0 tile,
// 1 wgmma (bf16 only), 2 split (with `splits` CTAs per (b, kv head),
// 1..8).  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape or form it does not take).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   int64_t B, int64_t Sq, int64_t Sk,
                                   int64_t Hq,
                                   int64_t Hk, int64_t D, int64_t causal,
                                   int64_t q_offset, float scale,
                                   int64_t q_b, int64_t q_s, int64_t q_h,
                                   int64_t k_b, int64_t k_s, int64_t k_h,
                                   int64_t v_b, int64_t v_s, int64_t v_h,
                                   int64_t o_b, int64_t o_s, int64_t o_h,
                                   int64_t form, int64_t splits,
                                   void* stream) {
  const AttnArgs a = make_args(lse, B, Sq, Sk, Hq, Hk, causal, q_offset,
                               scale, q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s,
                               v_h, o_b, o_s, o_h);
  return dispatch<float>(q, k, v, o, D, a, form, splits, stream);
}

// The same with bf16 q, k, v and o.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, void* lse,
                                    int64_t B, int64_t Sq, int64_t Sk,
                                    int64_t Hq,
                                    int64_t Hk, int64_t D, int64_t causal,
                                    int64_t q_offset, float scale,
                                    int64_t q_b, int64_t q_s, int64_t q_h,
                                    int64_t k_b, int64_t k_s, int64_t k_h,
                                    int64_t v_b, int64_t v_s, int64_t v_h,
                                    int64_t o_b, int64_t o_s, int64_t o_h,
                                    int64_t form, int64_t splits,
                                    void* stream) {
  const AttnArgs a = make_args(lse, B, Sq, Sk, Hq, Hk, causal, q_offset,
                               scale, q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s,
                               v_h, o_b, o_s, o_h);
  return dispatch<__nv_bfloat16>(q, k, v, o, D, a, form, splits, stream);
}
