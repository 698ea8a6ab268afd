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
//   (b) dk, dv: one CTA per (b, kv head, block of BK keys).  It walks the
//       g query heads of the group and, for each, the query blocks that
//       can see its keys (causal: from the block holding query
//       k0 - q_offset), accumulating dK and dV in registers, and stores
//       once.  The GQA sum over heads is that loop, in head order;
//   (c) dq: one CTA per (b, q head, block of BQ queries), over the key
//       blocks up to its last query's diagonal.
// P and dS are recomputed in both (b) and (c): 14 D operations per visible
// pair against the 10 D of the algorithm, the price of no atomics.
//
// SIMT form: fp32 FMAs on shared-memory tiles (K, V, Q scaled, dO, rows
// padded to D + 1 floats so that the 16 threads of a half-warp reading 16
// rows hit 16 banks), 256 threads as a 16 x 16 grid, each owning a
// (rows / 16) x (cols / 16) register tile of every product.  Bound:
// operations (10 D per visible pair at 67 TFLOP/s in fp32, 989 in bf16
// on the tensor cores a later form will use); this form is far from it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"

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
// Shared tiles and the products both (b) and (c) run.

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
// (b) dk, dv.  Grid (key blocks, Hk, B).

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
// (c) dq.  Grid (query blocks, Hq, B).

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
// Launches.

// The dynamic shared-memory limit is a per-device attribute of the
// function: set it once per device.
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(done.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    done.fetch_or(bit, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

// Blocks of 64 queries and 64 keys; 32 at head_dim 256, where four 64-row
// tiles of D + 1 floats would not fit in shared memory.
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* delta, void* dq, void* dk, void* dv,
                   const BwdArgs& a, cudaStream_t stream) {
  constexpr int BQ = D <= 128 ? 64 : 32, BK = BQ;
  constexpr size_t smem = Tiles<D, BQ, BK>::kSmem;
  const int64_t rows = a.B * a.Sq * a.Hq;
  attn_bwd_delta_kernel<T>
      <<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads,
         0, stream>>>(static_cast<const T*>(o), static_cast<const T*>(dout),
                      static_cast<float*>(delta), rows, a.Sq, a.Hq, D);
  cudaError_t err = cudaGetLastError();
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
             void* dk, void* dv, int64_t D, const BwdArgs& a, void* stream) {
  if (a.B > 65535 || a.Hq > 65535 || a.Hk < 1 || a.Hq % a.Hk != 0 ||
      a.Sk < 1 || (a.causal && a.q_offset < 0))
    return (int)cudaErrorInvalidValue;
  if (a.B == 0 || a.Sq == 0 || a.Hq == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
// scratch the call fills.  Three launches on `stream`; returns the first
// failing launch's error (cudaErrorInvalidValue for a shape it does not
// take), else cudaSuccess.
extern "C" int flash_attention_bwd_f32(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dout, const void* lse,
                                       void* delta, void* dq, void* dk,
                                       void* dv, int64_t B, int64_t Sq,
                                       int64_t Sk, int64_t Hq, int64_t Hk,
                                       int64_t D, int64_t causal,
                                       int64_t q_offset, float scale,
                                       void* stream) {
  const BwdArgs a{B, Sq, Sk, Hq, Hk, q_offset, (int)causal, scale};
  return dispatch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, D, a,
                         stream);
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
                                        void* stream) {
  const BwdArgs a{B, Sq, Sk, Hq, Hk, q_offset, (int)causal, scale};
  return dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, D,
                                 a, stream);
}
