// The backward of blockwise causal GQA attention (flash_attention.cu): from
// q (B,Sq,Hq,D), k/v (B,Sk,Hk,D), the forward's output o and row
// log-sum-exps lse (B,Hq,Sq), and the cotangent dO of o, it computes
//   P    = exp(scale q.k - lse)            (0 where key j is not visible)
//   dV_j = sum_{i, heads of j's group} P_ij dO_i
//   dP   = dO . v,   delta_i = dO_i . o_i,   dS = P (dP - delta)
//   dQ_i = scale sum_j dS_ij k_j,   dK_j = scale sum_{i, heads} dS_ij q_i
// in fp32, and stores dq, dk, dv in q's type (fp32 or bf16).  Key j is
// visible to query i iff j < Sk and, when causal, j <= q_offset + i; rows
// past Sq and keys past Sk contribute nothing.
//
// Replaces jax.grad of repro/models/layers.py::flash_attention (`:108`):
// repro differentiates its pure-JAX recurrence with XLA's autodiff, and has
// no Pallas kernel for this; the TPU forward kernel (B.7) has none either.
//
// Three launches per call, no atomics: CUDA blocks run in no order, so no
// sum carries over between them, and every output is written once by one
// CTA after a fixed sequence of operations -- reruns are bit-identical.
//   (a) delta[b,h,i] = sum_d dO o, one warp per row (butterfly sum);
//   (b) dk, dv: one CTA per (b, kv head, block of keys).  It walks the
//       g query heads of the group and, for each, the query blocks that
//       can see its keys (causal: from the block holding query
//       k0 - q_offset), accumulating dK and dV in registers, and stores
//       once.  The GQA sum over heads is that loop, in head order;
//   (c) dq: one CTA per (b, q head, block of queries), over the key
//       blocks up to its last query's diagonal, in order.
// P and dS are recomputed in both (b) and (c), the price of no atomics.
// Bound: operations, 10 D per visible pair (S, dP, dV, dK, dQ at 2 D
// each) at 989 TFLOP/s in bf16 on the tensor cores, 67 in fp32.
// kernels/attention.py::backward_plan picks one of two forms per call.
//
// 1. wgmma (bf16 at head_dim 64, 80 and 128): the tensor cores.  Warps
//    0-3 are one consumer warpgroup, warp 4 the producer; every operand
//    tile (64 rows of D bf16, 64-column panels, 128-byte swizzle) comes in
//    by TMA under mbarriers, from one 4-d tensor map per operand
//    (hopper.cuh::tile_map; rows past Sq or Sk arrive as zeros).  At
//    head_dim 80 a tile is two panels, the second holding columns 64-79
//    and TMA's zeros past them: the score products take 5 k16 steps (4 in
//    panel 0, 1 in panel 1) and the m64n80k16 products run their last 16
//    columns on into panel 1, so no tensor-core work falls on the
//    padding.
//    (b) keeps its K and V tiles (64 keys) resident and streams the Q and
//    dO tiles of 64 queries through a ring of 2 stages (full / empty
//    mbarriers), head by head and block by block; the producer warp also
//    writes each tile's lse (times log2 e) and delta into the stage.  It
//    works in the transposed orientation, so that each accumulator
//    fragment is already the next product's A operand (register for
//    register, as the forward's S is its P):
//      S^T  = K Q^T    wgmma m64n64k16, both K-major from shared memory;
//      dP^T = V dO^T   the same, issued behind S^T and waited on after P;
//      P^T  = exp2(S^T scale log2 e - lse log2 e), 0 where not visible;
//      dS^T = P^T (dP^T - delta)   (lse, delta by column, from shared);
//      dV  += P^T dO,  dK += dS^T Q   wgmma m64nDk16, A from registers,
//           B MN-major from shared memory (the transpose bit, as the
//           forward's V).
//    A query past Sq gets lse = +inf, so its P is 0 without a mask; the
//    causal mask is a per-row column limit.  (c) keeps its Q and dO tiles
//    resident and streams K and V tiles: S = Q K^T, dP = dO V^T, P, dS,
//    dQ += dS K (B = K, MN-major).
//    Numerics: S and dP are sums of exact bf16 products in fp32.  P and
//    dS are fp32, and one bf16 operand would leave the one-bf16-ulp class
//    the kernel is held to, so each is split as the forward splits P,
//    hi = bf16(x), lo = bf16(x - hi), both products into one fp32
//    accumulator (~16 bits kept).  That makes 20 D tensor-core operations
//    per visible pair -- (b) S 2 D, dP 2 D, dV 4 D, dK 4 D; (c) S 2 D,
//    dP 2 D, dQ 4 D -- twice the bound's 10 D: a floor of 0.695 ms at the
//    training shape (B 2, S 4096, Hq 16 / Hk 8, D 128, causal) against
//    the bound's 0.3475.  Registers: (b) holds dK and dV (D / 2 fp32 a
//    thread each) beside S^T and dP^T (32 each), about 192 values at D
//    128, so one CTA an SM there, two at D 64, and one at D 80: 211
//    registers there, and bounded to two CTAs 168 with 232 bytes of
//    spills, 9-13 % slower (`scripts/attention_bwd_occupancy.py`); (c)
//    holds dQ, S and dP, two CTAs an SM.  Causal work is a triangle:
//    (b)'s lowest key blocks and (c)'s highest query blocks have the most
//    tiles, and start first.
//
// 2. simt (fp32 -- "fp32 means fp32": TF32 would leave its class -- and
//    head_dim 16, 32 and 256: 16 and 32 are narrower than form 1's
//    64-column panels, and at 256 one warpgroup's dK and dV alone would
//    take 256 registers a thread): fp32 FMAs on shared-memory tiles
//    (K, V, Q scaled, dO, rows padded to D + 1 floats so that the 16
//    threads of a half-warp reading 16 rows hit 16 banks), 256 threads
//    as a 16 x 16 grid, each owning a (rows / 16) x (cols / 16) register
//    tile of every product: 14 D operations per visible pair, far from
//    its bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;     // a 16 x 16 grid of threads
constexpr int kSide = 16;

struct BwdArgs {
  int64_t B, Sq, Sk, Hq, Hk, q_offset;
  int causal;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
// Round to nearest even, as torch's .to(torch.bfloat16).
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ int64_t min64(int64_t x, int64_t y) {
  return x < y ? x : y;
}
__device__ __forceinline__ int64_t max64(int64_t x, int64_t y) {
  return x > y ? x : y;
}

// A butterfly: every lane ends with the same bits.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// (a) delta.  Rows in q's memory order (b, i, h): row r's D values are
// contiguous at r * D.

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                          float* __restrict__ delta, int64_t rows, int64_t Sq,
                          int64_t Hq, int D) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* op = o + row * D;
  const T* dp = dout + row * D;
  float s = 0.0f;
  for (int d = lane; d < D; d += 32) s = fmaf(to_f(dp[d]), to_f(op[d]), s);
  s = warp_sum(s);
  if (lane == 0) {
    const int64_t h = row % Hq, i = (row / Hq) % Sq, b = row / (Hq * Sq);
    delta[(b * Hq + h) * Sq + i] = s;
  }
}

// ---------------------------------------------------------------------------
// Form 2, simt: shared tiles and the products both its (b) and (c) run.

template <int D, int BQ, int BK>
struct Tiles {
  static constexpr int DP = D + 1;        // padded row of a D-wide tile
  static constexpr int PP = BK + 1;       // padded row of a (BQ, BK) tile
  static constexpr int RQ = BQ / kSide;   // query rows per thread
  static constexpr int RK = BK / kSide;   // keys per thread
  static constexpr int CD = D / kSide;    // dims per thread
  // Q (scaled), dO, K, V; P and dS; lse and delta.
  static constexpr size_t kFloats =
      (size_t)(2 * BQ + 2 * BK) * DP + 2 * BQ * PP + 2 * BQ;
  static constexpr size_t kSmem = sizeof(float) * kFloats;
};

// rows [r0, r0 + R) of a (B, S, H, D) tensor at head h, as fp32 (times
// `mul`) into a padded [R][D + 1] tile; rows past S are zeros.
template <typename T, int D, int R>
__device__ __forceinline__ void load_rows(float* tile, const T* base,
                                          int64_t r0, int64_t S,
                                          int64_t row_stride, float mul) {
  constexpr int DP = D + 1;
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    tile[r * DP + d] =
        r0 + r < S ? to_f(base[(r0 + r) * row_stride + d]) * mul : 0.0f;
  }
}

// For the (BQ x BK) block of queries [q0, q0 + BQ) and keys [k0, k0 + BK)
// of one head: P and dS into shared memory, P[i][j] = exp(s_ij - lse_i)
// where visible and 0 elsewhere, dS = P (dP - delta_i).  Thread (ty, tx)
// owns rows ty + 16 r and keys tx + 16 c.
template <int D, int BQ, int BK>
__device__ __forceinline__ void p_and_ds(const float* qs, const float* dos,
                                         const float* ks, const float* vs,
                                         const float* lse_s,
                                         const float* delta_s, float* ps,
                                         float* dss, int64_t q0, int64_t k0,
                                         const BwdArgs& a) {
  using L = Tiles<D, BQ, BK>;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  float s[L::RQ][L::RK], dp[L::RQ][L::RK];
#pragma unroll
  for (int r = 0; r < L::RQ; ++r)
#pragma unroll
    for (int c = 0; c < L::RK; ++c) s[r][c] = dp[r][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[L::RQ], ov[L::RQ], kv[L::RK], vv[L::RK];
#pragma unroll
    for (int r = 0; r < L::RQ; ++r) {
      qv[r] = qs[(ty + kSide * r) * L::DP + d];
      ov[r] = dos[(ty + kSide * r) * L::DP + d];
    }
#pragma unroll
    for (int c = 0; c < L::RK; ++c) {
      kv[c] = ks[(tx + kSide * c) * L::DP + d];
      vv[c] = vs[(tx + kSide * c) * L::DP + d];
    }
#pragma unroll
    for (int r = 0; r < L::RQ; ++r)
#pragma unroll
      for (int c = 0; c < L::RK; ++c) {
        s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
        dp[r][c] = fmaf(ov[r], vv[c], dp[r][c]);
      }
  }
#pragma unroll
  for (int r = 0; r < L::RQ; ++r) {
    const int i = ty + kSide * r;
    const int64_t qi = q0 + i;
#pragma unroll
    for (int c = 0; c < L::RK; ++c) {
      const int j = tx + kSide * c;
      const int64_t kj = k0 + j;
      const bool live = qi < a.Sq && kj < a.Sk &&
                        (!a.causal || kj <= a.q_offset + qi);
      const float p = live ? expf(s[r][c] - lse_s[i]) : 0.0f;
      ps[i * L::PP + j] = p;
      dss[i * L::PP + j] = p * (dp[r][c] - delta_s[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// simt (b) dk, dv.  Grid (key blocks, Hk, B).

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, BwdArgs a) {
  using L = Tiles<D, BQ, BK>;
  extern __shared__ float smem[];
  float* qs = smem;                    // [BQ][DP], q * scale
  float* dos = qs + BQ * L::DP;        // [BQ][DP]
  float* ks = dos + BQ * L::DP;        // [BK][DP]
  float* vs = ks + BK * L::DP;         // [BK][DP]
  float* ps = vs + BK * L::DP;         // [BQ][PP]
  float* dss = ps + BQ * L::PP;        // [BQ][PP]
  float* lse_s = dss + BQ * L::PP;     // [BQ]
  float* delta_s = lse_s + BQ;         // [BQ]

  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const int64_t k0 = (int64_t)blockIdx.x * BK;
  const int64_t hk = blockIdx.y, b = blockIdx.z;
  const int64_t g = a.Hq / a.Hk;
  const int64_t kv_row = a.Hk * D, q_row = a.Hq * D;
  load_rows<T, D, BK>(ks, k + (b * a.Sk * a.Hk + hk) * D, k0, a.Sk, kv_row,
                      1.0f);
  load_rows<T, D, BK>(vs, v + (b * a.Sk * a.Hk + hk) * D, k0, a.Sk, kv_row,
                      1.0f);

  float acc_k[L::RK][L::CD], acc_v[L::RK][L::CD];
#pragma unroll
  for (int r = 0; r < L::RK; ++r)
#pragma unroll
    for (int c = 0; c < L::CD; ++c) acc_k[r][c] = acc_v[r][c] = 0.0f;

  // The first query block with a query that sees key k0.
  const int64_t q_first =
      a.causal ? max64(0, k0 - a.q_offset) / BQ * BQ : 0;
  for (int64_t hh = 0; hh < g; ++hh) {
    const int64_t h = hk * g + hh;
    const T* qh = q + (b * a.Sq * a.Hq + h) * D;
    const T* doh = dout + (b * a.Sq * a.Hq + h) * D;
    const float* lse_h = lse + (b * a.Hq + h) * a.Sq;
    const float* delta_h = delta + (b * a.Hq + h) * a.Sq;
    for (int64_t q0 = q_first; q0 < a.Sq; q0 += BQ) {
      __syncthreads();   // the previous block's tiles are read
      load_rows<T, D, BQ>(qs, qh, q0, a.Sq, q_row, a.scale);
      load_rows<T, D, BQ>(dos, doh, q0, a.Sq, q_row, 1.0f);
      for (int i = threadIdx.x; i < BQ; i += kThreads) {
        lse_s[i] = q0 + i < a.Sq ? lse_h[q0 + i] : 0.0f;
        delta_s[i] = q0 + i < a.Sq ? delta_h[q0 + i] : 0.0f;
      }
      __syncthreads();
      p_and_ds<D, BQ, BK>(qs, dos, ks, vs, lse_s, delta_s, ps, dss, q0, k0,
                          a);
      __syncthreads();
      // dV[j][d] += P[i][j] dO[i][d], dK[j][d] += dS[i][j] (q scale)[i][d]:
      // thread (ty, tx) owns keys ty + 16 r and dims tx + 16 c.
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        float pv[L::RK], sv[L::RK];
#pragma unroll
        for (int r = 0; r < L::RK; ++r) {
          pv[r] = ps[i * L::PP + ty + kSide * r];
          sv[r] = dss[i * L::PP + ty + kSide * r];
        }
#pragma unroll
        for (int c = 0; c < L::CD; ++c) {
          const float ov = dos[i * L::DP + tx + kSide * c];
          const float qv = qs[i * L::DP + tx + kSide * c];
#pragma unroll
          for (int r = 0; r < L::RK; ++r) {
            acc_v[r][c] = fmaf(pv[r], ov, acc_v[r][c]);
            acc_k[r][c] = fmaf(sv[r], qv, acc_k[r][c]);
          }
        }
      }
    }
  }

  // Keys no query sees keep dK = dV = 0.
#pragma unroll
  for (int r = 0; r < L::RK; ++r) {
    const int64_t kj = k0 + ty + kSide * r;
    if (kj >= a.Sk) continue;
    T* dkr = dk + ((b * a.Sk + kj) * a.Hk + hk) * D;
    T* dvr = dv + ((b * a.Sk + kj) * a.Hk + hk) * D;
#pragma unroll
    for (int c = 0; c < L::CD; ++c) {
      dkr[tx + kSide * c] = from_f<T>(acc_k[r][c]);
      dvr[tx + kSide * c] = from_f<T>(acc_v[r][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// simt (c) dq.  Grid (query blocks, Hq, B).

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       BwdArgs a) {
  using L = Tiles<D, BQ, BK>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BQ * L::DP;
  float* ks = dos + BQ * L::DP;
  float* vs = ks + BK * L::DP;
  float* ps = vs + BK * L::DP;
  float* dss = ps + BQ * L::PP;
  float* lse_s = dss + BQ * L::PP;
  float* delta_s = lse_s + BQ;

  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const int64_t q0 = (int64_t)blockIdx.x * BQ;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t hk = h / (a.Hq / a.Hk);
  const int64_t kv_row = a.Hk * D, q_row = a.Hq * D;
  load_rows<T, D, BQ>(qs, q + (b * a.Sq * a.Hq + h) * D, q0, a.Sq, q_row,
                      a.scale);
  load_rows<T, D, BQ>(dos, dout + (b * a.Sq * a.Hq + h) * D, q0, a.Sq, q_row,
                      1.0f);
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    const int64_t row = (b * a.Hq + h) * a.Sq + q0 + i;
    lse_s[i] = q0 + i < a.Sq ? lse[row] : 0.0f;
    delta_s[i] = q0 + i < a.Sq ? delta[row] : 0.0f;
  }

  float acc[L::RQ][L::CD];
#pragma unroll
  for (int r = 0; r < L::RQ; ++r)
#pragma unroll
    for (int c = 0; c < L::CD; ++c) acc[r][c] = 0.0f;

  // Past the last query's diagonal no key is visible.
  const int64_t q_last = min64(a.Sq, q0 + BQ) - 1;
  const int64_t kv_end =
      a.causal ? min64(a.Sk, a.q_offset + q_last + 1) : a.Sk;
  const T* kh = k + (b * a.Sk * a.Hk + hk) * D;
  const T* vh = v + (b * a.Sk * a.Hk + hk) * D;
  for (int64_t k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();   // the previous block's tiles are read
    load_rows<T, D, BK>(ks, kh, k0, a.Sk, kv_row, 1.0f);
    load_rows<T, D, BK>(vs, vh, k0, a.Sk, kv_row, 1.0f);
    __syncthreads();
    p_and_ds<D, BQ, BK>(qs, dos, ks, vs, lse_s, delta_s, ps, dss, q0, k0, a);
    __syncthreads();
    // dQ[i][d] += dS[i][j] K[j][d]: thread (ty, tx) owns rows ty + 16 r
    // and dims tx + 16 c.
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float sv[L::RQ];
#pragma unroll
      for (int r = 0; r < L::RQ; ++r)
        sv[r] = dss[(ty + kSide * r) * L::PP + j];
#pragma unroll
      for (int c = 0; c < L::CD; ++c) {
        const float kv = ks[j * L::DP + tx + kSide * c];
#pragma unroll
        for (int r = 0; r < L::RQ; ++r) acc[r][c] = fmaf(sv[r], kv, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < L::RQ; ++r) {
    const int64_t qi = q0 + ty + kSide * r;
    if (qi >= a.Sq) continue;
    T* dqr = dq + ((b * a.Sq + qi) * a.Hq + h) * D;
#pragma unroll
    for (int c = 0; c < L::CD; ++c)
      dqr[tx + kSide * c] = from_f<T>(acc[r][c] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// Form 1: wgmma (bf16, head_dim 64, 80 and 128).

constexpr float kLog2e = 1.4426950408889634f;

enum BwdForm { BWD_SIMT = 0, BWD_WGMMA = 1 };

// One consumer warpgroup and one producer warp; tiles of 64 rows.  (b):
// the resident pair is K and V, a stage holds Q, dO and the tile's 64
// lse (times log2 e) and 64 delta; (c): the resident pair is Q and dO, a
// stage K and V (its stats unused).
template <int D>
struct BwdLayout {
  static constexpr int kStages = 2;
  static constexpr int kConsumers = 128;
  static constexpr int kThreads = kConsumers + 32;
  static constexpr int kTile = panels<D>() * kPanelBytes;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kStats = 2 * kTile + kStages * kStage;
  static constexpr int kBars = kStats + kStages * 128 * (int)sizeof(float);
  // 1024 bytes of slack to align the swizzled panels; full, empty and
  // the resident pair's barrier.
  static constexpr size_t kSmem = 1024 + kBars + (2 * kStages + 1) * 8;
};

__device__ __forceinline__ int clamp64(int64_t x) {
  return (int)(x < 0 ? 0 : x > 64 ? 64 : x);
}

// acc (64 x D) += A . B over 64 rows of B (four k16 steps), A the hi and
// then the lo fragments, B a tile's panels MN-major (N = D columns, the
// next panel LBO away).
template <int D>
__device__ __forceinline__ void wgmma_hi_lo(float* acc, const uint32_t* hi,
                                            const uint32_t* lo,
                                            const unsigned char* tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<D>(acc, hi + 4 * kk, smem_desc(tile + kk * 2048, kPanelBytes,
                                             1024));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<D>(acc, lo + 4 * kk, smem_desc(tile + kk * 2048, kPanelBytes,
                                             1024));
}

// Issues c (64 x 64, fp32) = A . B^T over D, A and B tiles K-major, as
// one commit group.
template <int D>
__device__ __forceinline__ void wgmma_scores(float* c, const unsigned char* a,
                                             const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
    wgmma_ss_n64(c, smem_desc(a + off, 16, 1024), smem_desc(b + off, 16, 1024),
                 kk > 0);
  }
  wg_commit();
}

// Arms `bar` for two tiles and loads them: rows [row, row + 64) of head h
// of batch b from maps m0 and m1, to dst and dst + one tile.
template <int D>
__device__ __forceinline__ void load_pair(unsigned char* dst,
                                          const CUtensorMap* m0,
                                          const CUtensorMap* m1,
                                          uint64_t* bar, int h, int64_t row,
                                          int b) {
  mbar_expect_tx(bar, 2 * BwdLayout<D>::kTile);
#pragma unroll
  for (int p = 0; p < panels<D>(); ++p) {
    tma_load(dst + p * kPanelBytes, m0, bar, 64 * p, h, (int)row, b);
    tma_load(dst + BwdLayout<D>::kTile + p * kPanelBytes, m1, bar, 64 * p,
             h, (int)row, b);
  }
}

// (b) dk, dv.  Grid (B * Hk, key blocks).
template <int D>
__global__ void __launch_bounds__(BwdLayout<D>::kThreads, D <= 64 ? 2 : 1)
    attn_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, BwdArgs a) {
  using L = BwdLayout<D>;
  constexpr int NACC = D / 2;   // dK or dV registers per thread
  extern __shared__ __align__(128) unsigned char bwd_smem[];
  unsigned char* base =
      bwd_smem + ((1024 - (smem_u32(bwd_smem) & 1023)) & 1023);
  unsigned char* ks = base;                    // resident K, then V
  unsigned char* vs = base + L::kTile;
  unsigned char* ring = base + 2 * L::kTile;   // stage s: Q, then dO
  float* stats = reinterpret_cast<float*>(base + L::kStats);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* resident = empty + L::kStages;

  // Key blocks in y: under a causal mask the lowest see the most query
  // blocks, and the blocks of a launch start in (x, y) order.
  const int64_t k0 = (int64_t)blockIdx.y * 64;
  const int hk = (int)(blockIdx.x % a.Hk), b = (int)(blockIdx.x / a.Hk);
  const int64_t g = a.Hq / a.Hk;
  const int64_t q_first =
      a.causal ? max64(0, k0 - a.q_offset) / 64 * 64 : 0;
  const int per_head =
      q_first < a.Sq ? (int)((a.Sq - q_first + 63) / 64) : 0;
  const int n_tiles = (int)g * per_head;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 32);             // the producer warp's lanes
      mbar_init(&empty[s], L::kConsumers);
    }
    mbar_init(resident, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= L::kConsumers) {
    // The producer warp: lane 0 issues the TMA loads; every lane writes
    // its share of the stage's lse and delta and then arrives, so the
    // phase completes once all of them and the tiles have landed.
    const int lane = threadIdx.x - L::kConsumers;
    if (lane == 0) load_pair<D>(ks, &tm_k, &tm_v, resident, hk, k0, b);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % L::kStages;
      const int h = hk * (int)g + t / per_head;
      const int64_t q0 = q_first + (int64_t)(t % per_head) * 64;
      if (t >= L::kStages) mbar_wait(&empty[s], ((t / L::kStages) & 1) ^ 1);
      float* st = stats + s * 128;
      const int64_t row = ((int64_t)b * a.Hq + h) * a.Sq;
      for (int i = lane; i < 64; i += 32) {
        const bool in = q0 + i < a.Sq;
        st[i] = in ? lse[row + q0 + i] * kLog2e : INFINITY;
        st[64 + i] = in ? delta[row + q0 + i] : 0.0f;
      }
      if (lane == 0)
        load_pair<D>(ring + s * L::kStage, &tm_q, &tm_do, &full[s], h, q0,
                     b);
      else
        mbar_arrive(&full[s]);
    }
    return;
  }

  // The consumer warpgroup.  Fragment rows (keys) k0 + ra + 8 h, columns
  // (queries) q0 + 8 j + cq + e: S[4 j + 2 h + e], as every accumulator.
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ra = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  const float scale2 = a.scale * kLog2e;
  float dK[NACC], dV[NACC], S[32], dP[32];
  uint32_t hp[16], lp[16], hs[16], ls[16];
#pragma unroll
  for (int i = 0; i < NACC; ++i) dK[i] = dV[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) S[i] = dP[i] = 0.0f;
  mbar_wait(resident, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % L::kStages;
    const int64_t q0 = q_first + (int64_t)(t % per_head) * 64;
    mbar_wait(&full[s], (t / L::kStages) & 1);
    const unsigned char* qt = ring + s * L::kStage;
    const unsigned char* dot = qt + L::kTile;
    const float* st = stats + s * 128;

    // S^T = K Q^T and dP^T = V dO^T, two commit groups.
    pin<32>(S);
    pin<32>(dP);
    wg_fence();
    wgmma_scores<D>(S, ks, qt);
    wgmma_scores<D>(dP, vs, dot);

    // Row h sees the columns from lim[h] on: none for a key past Sk (its
    // row is never stored), under a causal mask those with
    // q0 + c >= key - q_offset.  A query past Sq has lse = +inf: P = 0.
    int lim[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t key = k0 + ra + 8 * h;
      lim[h] = key >= a.Sk ? 64
               : a.causal  ? clamp64(key - a.q_offset - q0)
                           : 0;
    }
    wg_wait<1>();
    pin<32>(S);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * j + cq);
#pragma unroll
      for (int i = 4 * j; i < 4 * j + 4; ++i) {
        const int c = 8 * j + cq + (i & 1);
        const float p = exp2f(S[i] * scale2 - ((i & 1) ? l2.y : l2.x));
        S[i] = c >= lim[(i / 2) & 1] ? p : 0.0f;
      }
    }
    wg_wait<0>();
    pin<32>(dP);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 =
          *reinterpret_cast<const float2*>(st + 64 + 8 * j + cq);
#pragma unroll
      for (int i = 4 * j; i < 4 * j + 4; ++i)
        dP[i] = S[i] * (dP[i] - ((i & 1) ? d2.y : d2.x));
    }
    // P^T and dS^T as A operands: columns 16 kk .. 16 kk + 15 of the
    // fragment are the A fragment of k16 step kk.
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      split_pair(S[2 * i], S[2 * i + 1], hp[i], lp[i]);
      split_pair(dP[2 * i], dP[2 * i + 1], hs[i], ls[i]);
    }
    pin<16>(hp);
    pin<16>(lp);
    pin<16>(hs);
    pin<16>(ls);
    pin<NACC>(dV);
    pin<NACC>(dK);

    // dV += P^T dO, dK += dS^T Q.
    wg_fence();
    wgmma_hi_lo<D>(dV, hp, lp, dot);
    wgmma_hi_lo<D>(dK, hs, ls, qt);
    wg_commit();
    wg_wait<0>();
    pin<NACC>(dV);
    pin<NACC>(dK);
    pin<16>(hp);
    pin<16>(lp);
    pin<16>(hs);
    pin<16>(ls);
    mbar_arrive(&empty[s]);
  }

  // Keys no query sees keep dK = dV = 0.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t key = k0 + ra + 8 * h;
    if (key >= a.Sk) continue;
    const int64_t off = ((b * a.Sk + key) * a.Hk + hk) * D + cq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
          __floats2bfloat162_rn(dK[4 * j + 2 * h] * a.scale,
                                dK[4 * j + 2 * h + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
          __floats2bfloat162_rn(dV[4 * j + 2 * h], dV[4 * j + 2 * h + 1]);
    }
  }
}

// (c) dq.  Grid (B * Hq, query blocks).
template <int D>
__global__ void __launch_bounds__(BwdLayout<D>::kThreads, 2)
    attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, BwdArgs a) {
  using L = BwdLayout<D>;
  constexpr int NACC = D / 2;   // dQ registers per thread
  extern __shared__ __align__(128) unsigned char bwd_smem[];
  unsigned char* base =
      bwd_smem + ((1024 - (smem_u32(bwd_smem) & 1023)) & 1023);
  unsigned char* qs = base;                    // resident Q, then dO
  unsigned char* dos = base + L::kTile;
  unsigned char* ring = base + 2 * L::kTile;   // stage s: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* resident = empty + L::kStages;

  // Query blocks in y, the highest (the most key blocks) first.
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * 64;
  const int h = (int)(blockIdx.x % a.Hq), b = (int)(blockIdx.x / a.Hq);
  const int hk = h / (int)(a.Hq / a.Hk);
  const int64_t q_last = min64(a.Sq, q0 + 64) - 1;
  const int64_t kv_end =
      a.causal ? min64(a.Sk, a.q_offset + q_last + 1) : a.Sk;
  const int n_tiles = (int)((kv_end + 63) / 64);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], L::kConsumers);
    }
    mbar_init(resident, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= L::kConsumers) {
    // The producer: one thread keeps the ring of K/V stages full.
    if (threadIdx.x == L::kConsumers) {
      load_pair<D>(qs, &tm_q, &tm_do, resident, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % L::kStages;
        if (t >= L::kStages)
          mbar_wait(&empty[s], ((t / L::kStages) & 1) ^ 1);
        load_pair<D>(ring + s * L::kStage, &tm_k, &tm_v, &full[s], hk,
                     (int64_t)t * 64, b);
      }
    }
    return;
  }

  // Fragment rows (queries) q0 + ra + 8 h, columns (keys) k0 + 8 j + cq
  // + e.  A row past Sq gets lse = +inf: P = 0.
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ra = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  const float scale2 = a.scale * kLog2e;
  float lse2[2], dlt[2];
  int64_t vis_end[2];   // row h sees the keys below vis_end[h]
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t i = q0 + ra + 8 * hh;
    const int64_t row = ((int64_t)b * a.Hq + h) * a.Sq + i;
    lse2[hh] = i < a.Sq ? lse[row] * kLog2e : INFINITY;
    dlt[hh] = i < a.Sq ? delta[row] : 0.0f;
    vis_end[hh] = a.causal ? min64(a.Sk, a.q_offset + i + 1) : a.Sk;
  }
  float dQ[NACC], S[32], dP[32];
  uint32_t hs[16], ls[16];
#pragma unroll
  for (int i = 0; i < NACC; ++i) dQ[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) S[i] = dP[i] = 0.0f;
  mbar_wait(resident, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % L::kStages;
    const int64_t k0 = (int64_t)t * 64;
    mbar_wait(&full[s], (t / L::kStages) & 1);
    const unsigned char* kt = ring + s * L::kStage;
    const unsigned char* vt = kt + L::kTile;

    // S = Q K^T and dP = dO V^T, two commit groups.
    pin<32>(S);
    pin<32>(dP);
    wg_fence();
    wgmma_scores<D>(S, qs, kt);
    wgmma_scores<D>(dP, dos, vt);
    const int lim[2] = {clamp64(vis_end[0] - k0), clamp64(vis_end[1] - k0)};
    wg_wait<1>();
    pin<32>(S);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i / 2) & 1;
      const float p = exp2f(S[i] * scale2 - lse2[hh]);
      S[i] = 8 * (i / 4) + cq + (i & 1) < lim[hh] ? p : 0.0f;
    }
    wg_wait<0>();
    pin<32>(dP);
#pragma unroll
    for (int i = 0; i < 32; ++i) dP[i] = S[i] * (dP[i] - dlt[(i / 2) & 1]);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      split_pair(dP[2 * i], dP[2 * i + 1], hs[i], ls[i]);
    pin<16>(hs);
    pin<16>(ls);
    pin<NACC>(dQ);

    // dQ += dS K.
    wg_fence();
    wgmma_hi_lo<D>(dQ, hs, ls, kt);
    wg_commit();
    wg_wait<0>();
    pin<NACC>(dQ);
    pin<16>(hs);
    pin<16>(ls);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t i = q0 + ra + 8 * hh;
    if (i >= a.Sq) continue;
    __nv_bfloat16* dqr = dq + (((int64_t)b * a.Sq + i) * a.Hq + h) * D + cq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dqr + 8 * j) =
          __floats2bfloat162_rn(dQ[4 * j + 2 * hh] * a.scale,
                                dQ[4 * j + 2 * hh + 1] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// Launches.

template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, void* delta,
                         int D, const BwdArgs& a, cudaStream_t stream) {
  const int64_t rows = a.B * a.Sq * a.Hq;
  attn_bwd_delta_kernel<T>
      <<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads,
         0, stream>>>(static_cast<const T*>(o), static_cast<const T*>(dout),
                      static_cast<float*>(delta), rows, a.Sq, a.Hq, D);
  return cudaGetLastError();
}

// Every operand contiguous: (B, S, H, D) with strides (S H D, H D, D).
template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const void* lse,
                         void* delta, void* dq, void* dk, void* dv,
                         const BwdArgs& a, cudaStream_t stream) {
  using L = BwdLayout<D>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  const int64_t qs = a.Hq * D, ks = a.Hk * D;
  cudaError_t err =
      tile_map(&tm_q, q, D, a.Hq, a.Sq, a.B, a.Sq * qs, qs, D);
  if (err == cudaSuccess)
    err = tile_map(&tm_do, dout, D, a.Hq, a.Sq, a.B, a.Sq * qs, qs, D);
  if (err == cudaSuccess)
    err = tile_map(&tm_k, k, D, a.Hk, a.Sk, a.B, a.Sk * ks, ks, D);
  if (err == cudaSuccess)
    err = tile_map(&tm_v, v, D, a.Hk, a.Sk, a.B, a.Sk * ks, ks, D);
  if (err != cudaSuccess) return err;
  err = launch_delta<__nv_bfloat16>(o, dout, delta, D, a, stream);
  if (err != cudaSuccess) return err;

  auto kv_kern = attn_bwd_dkdv_wgmma_kernel<D>;
  static std::atomic<uint64_t> kv_done{0};
  err = allow_smem(kv_kern, L::kSmem, kv_done);
  if (err != cudaSuccess) return err;
  kv_kern<<<dim3((unsigned)(a.B * a.Hk), (unsigned)((a.Sk + 63) / 64)),
            L::kThreads, L::kSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto q_kern = attn_bwd_dq_wgmma_kernel<D>;
  static std::atomic<uint64_t> q_done{0};
  err = allow_smem(q_kern, L::kSmem, q_done);
  if (err != cudaSuccess) return err;
  q_kern<<<dim3((unsigned)(a.B * a.Hq), (unsigned)((a.Sq + 63) / 64)),
           L::kThreads, L::kSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), a);
  return cudaGetLastError();
}

// simt: blocks of 64 queries and 64 keys; 32 at head_dim 256, where four
// 64-row tiles of D + 1 floats would not fit in shared memory.
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* delta, void* dq, void* dk, void* dv,
                   const BwdArgs& a, cudaStream_t stream) {
  constexpr int BQ = D <= 128 ? 64 : 32, BK = BQ;
  constexpr size_t smem = Tiles<D, BQ, BK>::kSmem;
  cudaError_t err = launch_delta<T>(o, dout, delta, D, a, stream);
  if (err != cudaSuccess) return err;

  auto kv_kern = attn_bwd_dkdv_kernel<T, D, BQ, BK>;
  static std::atomic<uint64_t> kv_done{0};
  err = allow_smem(kv_kern, smem, kv_done);
  if (err != cudaSuccess) return err;
  const dim3 kv_grid((unsigned)((a.Sk + BK - 1) / BK), (unsigned)a.Hk,
                     (unsigned)a.B);
  kv_kern<<<kv_grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto q_kern = attn_bwd_dq_kernel<T, D, BQ, BK>;
  static std::atomic<uint64_t> q_done{0};
  err = allow_smem(q_kern, smem, q_done);
  if (err != cudaSuccess) return err;
  const dim3 q_grid((unsigned)((a.Sq + BQ - 1) / BQ), (unsigned)a.Hq,
                    (unsigned)a.B);
  q_kern<<<q_grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), a);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* delta, void* dq,
             void* dk, void* dv, int64_t D, const BwdArgs& a, int64_t form,
             void* stream) {
  if (a.B > 65535 || a.Hq > 65535 || a.Hk < 1 || a.Hq % a.Hk != 0 ||
      a.Sk < 1 || (a.causal && a.q_offset < 0))
    return (int)cudaErrorInvalidValue;
  if (a.B == 0 || a.Sq == 0 || a.Hq == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == BWD_WGMMA) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if ((a.Sq + 63) / 64 > 65535 || (a.Sk + 63) / 64 > 65535)
        return (int)cudaErrorInvalidValue;
      switch (D) {
        case 64:
          return (int)launch_wgmma<64>(q, k, v, o, dout, lse, delta, dq, dk,
                                       dv, a, st);
        case 80:
          return (int)launch_wgmma<80>(q, k, v, o, dout, lse, delta, dq, dk,
                                       dv, a, st);
        case 128:
          return (int)launch_wgmma<128>(q, k, v, o, dout, lse, delta, dq, dk,
                                        dv, a, st);
        default:
          break;
      }
    }
    return (int)cudaErrorInvalidValue;
  }
  if (form != BWD_SIMT) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16:
      return (int)launch<T, 16>(q, k, v, o, dout, lse, delta, dq, dk, dv, a,
                                st);
    case 32:
      return (int)launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, a,
                                st);
    case 64:
      return (int)launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, a,
                                st);
    case 80:
      return (int)launch<T, 80>(q, k, v, o, dout, lse, delta, dq, dk, dv, a,
                                st);
    case 128:
      return (int)launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, a,
                                 st);
    case 256:
      return (int)launch<T, 256>(q, k, v, o, dout, lse, delta, dq, dk, dv, a,
                                 st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq (B,Sq,Hq,D); k, v, dk, dv (B,Sk,Hk,D), all contiguous, in
// fp32; lse (B,Hq,Sq) fp32 from the forward; delta a (B,Hq,Sq) fp32
// scratch the call fills.  `form` is 0 simt, 1 wgmma (bf16 at head_dim
// 64, 80 and 128 only).  Three launches on `stream`; returns the first failing
// launch's error (cudaErrorInvalidValue for a shape or form it does not
// take), else cudaSuccess.
extern "C" int flash_attention_bwd_f32(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dout, const void* lse,
                                       void* delta, void* dq, void* dk,
                                       void* dv, int64_t B, int64_t Sq,
                                       int64_t Sk, int64_t Hq, int64_t Hk,
                                       int64_t D, int64_t causal,
                                       int64_t q_offset, float scale,
                                       int64_t form, void* stream) {
  const BwdArgs a{B, Sq, Sk, Hq, Hk, q_offset, (int)causal, scale};
  return dispatch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, D, a,
                         form, stream);
}

// The same with bf16 q, k, v, o, dout, dq, dk and dv.
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, const void* lse,
                                        void* delta, void* dq, void* dk,
                                        void* dv, int64_t B, int64_t Sq,
                                        int64_t Sk, int64_t Hq, int64_t Hk,
                                        int64_t D, int64_t causal,
                                        int64_t q_offset, float scale,
                                        int64_t form, void* stream) {
  const BwdArgs a{B, Sq, Sk, Hq, Hk, q_offset, (int)causal, scale};
  return dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, D,
                                 a, form, stream);
}
