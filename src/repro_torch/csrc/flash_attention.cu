// Blockwise (flash) causal GQA attention, fp32 or bf16 in, fp32 inside:
//   out[b,i,h] = softmax_j(scale * q[b,i,h] . k[b,j,h/g]) v[b,j,h/g]
// q (B,Sq,Hq,D), k/v (B,Sk,Hk,D) with any (batch, sequence, head)
// strides and a unit stride along D; g = Hq / Hk; scale = D**-0.5 on q in
// fp32.  Key j is visible to query i iff j < Sk and, when causal,
// j <= q_offset + i.  Masked scores are -1e30; the output is
// acc / max(l, 1e-30) in q's type.
//
// Replaces repro/kernels/attention.py::flash_attention_pallas (body
// _flash_kernel), whose grid (B, Hq, q block, kv block) carried the
// running max m, normalizer l and accumulator in VMEM scratch across the
// SEQUENTIAL kv axis and skipped kv blocks past the diagonal.
//
// Design.  CUDA blocks run in no order, so the kv axis becomes a loop:
// one CTA owns (b, h, 16 query rows) and walks the kv blocks from block 0
// upward, with m, l and acc in registers.  The order matters: m starts at
// -1e30, and block 0 holds a live key for every query row (key 0; the
// wrapper refuses a causal q_offset < 0), so no row ever adds exp(0)
// terms for a block it cannot see.  The loop stops at
// min(Sk, q_offset + last row + 1): the causal block skip, with no loop
// over masked blocks.  Ragged edges are predicates on the loads (zeros
// past Sk, masked) and on the stores: nothing is padded or copied.  A
// decode step passes the live prefix of its KV cache as a strided view.
// No atomics: each output is one warp's fixed sequence of operations, so
// reruns are bit-identical.
//
// Each warp holds 4 query rows.  Per kv block of 32 keys, the K and V
// rows are staged in shared memory as fp32 (K rows padded to D + 1
// floats, so lane j reading key j at a fixed d hits bank (j + d) % 32);
// lane j computes the scores of key j against the warp's 4 rows, a
// butterfly max / sum gives every lane the same m and l, and for
// acc += p v lane t owns dims t, t + 32, ...  All arithmetic is fp32
// SIMT FMAs: rounding p to bf16 for a tensor-core MMA would leave the
// fp32 tolerance class.
//
// Bound.  Decode (Sq = 1) reads the whole live cache once per query head
// and does 4 D flops per key: bytes.  Prefill does 4 D flops per visible
// (query, key) pair over q, k and v read once: operations.  This simple
// form uses no tensor cores, stages each K/V block once per 16 query rows
// (prefill re-reads K/V through L2 Sq / 16 times) and, at Sq = 1, keeps
// one warp of four busy; tensor cores (wgmma, TMA), K/V tiles shared by
// the query heads of a GQA group and a split-kv decode are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 4;                  // query rows per warp
constexpr int kBlockQ = kWarps * kRows;   // query rows per CTA
constexpr int kBlockK = 32;               // keys per kv block: one per lane
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct AttnArgs {
  int64_t B, Sq, Sk, Hq, Hk, q_offset;
  int causal;
  float scale;
  int64_t q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
};

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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockQ * D + kBlockK * (D + 1) + kBlockK * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
    T* orow = o + b * a.o_b + row * a.o_s + h * a.o_h;
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int d = lane + 32 * i;
      if (d < D) orow[d] = Vec<T>::store(acc[r][i] / l_safe);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const AttnArgs& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_attention_kernel<T, D>;
  // The shared-memory limit is a per-device attribute of the function:
  // set it once per device, not at every launch (a decode step launches
  // once per layer, and its time is the host's).
  static std::atomic<uint64_t> limit_set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(limit_set.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    limit_set.fetch_or(bit, std::memory_order_relaxed);
  }
  const dim3 grid((unsigned)((a.Sq + kBlockQ - 1) / kBlockQ),
                  (unsigned)a.Hq, (unsigned)a.B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), a);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             int64_t D, const AttnArgs& a, void* stream) {
  if (a.B > 65535 || a.Hq > 65535 || a.Hk < 1 || a.Hq % a.Hk != 0 ||
      a.Sk < 1 || (a.causal && a.q_offset < 0))
    return (int)cudaErrorInvalidValue;
  if (a.B == 0 || a.Sq == 0 || a.Hq == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)launch<T, 16>(q, k, v, o, a, st);
    case 32: return (int)launch<T, 32>(q, k, v, o, a, st);
    case 64: return (int)launch<T, 64>(q, k, v, o, a, st);
    case 128: return (int)launch<T, 128>(q, k, v, o, a, st);
    case 256: return (int)launch<T, 256>(q, k, v, o, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

AttnArgs make_args(int64_t B, int64_t Sq, int64_t Sk, int64_t Hq, int64_t Hk,
                   int64_t causal, int64_t q_offset, float scale,
                   int64_t q_b, int64_t q_s, int64_t q_h, int64_t k_b,
                   int64_t k_s, int64_t k_h, int64_t v_b, int64_t v_s,
                   int64_t v_h, int64_t o_b, int64_t o_s, int64_t o_h) {
  return AttnArgs{B,   Sq,  Sk,  Hq,  Hk,  q_offset, (int)causal, scale,
                  q_b, q_s, q_h, k_b, k_s, k_h,      v_b,         v_s,
                  v_h, o_b, o_s, o_h};
}

}  // namespace

// q (B,Sq,Hq,D), k/v (B,Sk,Hk,D) -> o (B,Sq,Hq,D), fp32; strides in
// elements, unit along D, 16-byte aligned.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a shape it does not take).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int64_t B,
                                   int64_t Sq, int64_t Sk, int64_t Hq,
                                   int64_t Hk, int64_t D, int64_t causal,
                                   int64_t q_offset, float scale,
                                   int64_t q_b, int64_t q_s, int64_t q_h,
                                   int64_t k_b, int64_t k_s, int64_t k_h,
                                   int64_t v_b, int64_t v_s, int64_t v_h,
                                   int64_t o_b, int64_t o_s, int64_t o_h,
                                   void* stream) {
  const AttnArgs a = make_args(B, Sq, Sk, Hq, Hk, causal, q_offset, scale,
                               q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h,
                               o_b, o_s, o_h);
  return dispatch<float>(q, k, v, o, D, a, stream);
}

// The same with bf16 q, k, v and o.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int64_t B,
                                    int64_t Sq, int64_t Sk, int64_t Hq,
                                    int64_t Hk, int64_t D, int64_t causal,
                                    int64_t q_offset, float scale,
                                    int64_t q_b, int64_t q_s, int64_t q_h,
                                    int64_t k_b, int64_t k_s, int64_t k_h,
                                    int64_t v_b, int64_t v_s, int64_t v_h,
                                    int64_t o_b, int64_t o_s, int64_t o_h,
                                    void* stream) {
  const AttnArgs a = make_args(B, Sq, Sk, Hq, Hk, causal, q_offset, scale,
                               q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h,
                               o_b, o_s, o_h);
  return dispatch<__nv_bfloat16>(q, k, v, o, D, a, stream);
}
