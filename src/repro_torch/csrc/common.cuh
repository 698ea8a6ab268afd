// Shared by the kernels of this directory: the C entry that names a CUDA
// error for the Python wrappers, a divider by a launch's fixed divisor,
// the conv kernels' element types (fp32 or bf16 in device memory, always
// fp32 in registers), and the elementwise tail fused into every conv
// kernel, y = act(scale * acc + bias), in the order of
// repro_torch.core.spec.Epilogue.apply -- scale, then bias, then the
// activation -- applied to the fp32 accumulator in registers before the
// one store of each output element.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// An operand element widened to fp32 (exact for bf16), and an fp32 value
// stored as an output element: bf16 rounds once, to nearest even, as
// torch's .to(torch.bfloat16) does.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

enum EpilogueAct { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY_RELU = 2, ACT_TANH = 3 };

// E is the bias's element type, the launch's operand type.
template <class E>
struct EpilogueArgsT {
  const E* bias;      // per output channel, or nullptr
  int act;            // EpilogueAct
  float slope;        // leaky_relu negative slope
  int has_scale;
  float scale;
};
using EpilogueArgs = EpilogueArgsT<float>;

template <class E>
__device__ __forceinline__ float apply_epilogue(float v, int c,
                                                const EpilogueArgsT<E>& ep) {
  if (ep.has_scale) v *= ep.scale;
  if (ep.bias != nullptr) v += to_f32(ep.bias[c]);
  switch (ep.act) {
    // `v < 0 ? 0 : v` rather than fmaxf: a NaN stays NaN, as in
    // torch.clamp_min, so the serving engine's NaN guard still sees it.
    case ACT_RELU: v = v < 0.0f ? 0.0f : v; break;
    case ACT_LEAKY_RELU: v = v > 0.0f ? v : ep.slope * v; break;
    case ACT_TANH: v = tanhf(v); break;
    default: break;
  }
  return v;
}

template <class E = float>
static inline EpilogueArgsT<E> make_epilogue(const void* bias, int act,
                                             float slope, int has_scale,
                                             float scale) {
  EpilogueArgsT<E> ep;
  ep.bias = static_cast<const E*>(bias);
  ep.act = act;
  ep.slope = slope;
  ep.has_scale = has_scale;
  ep.scale = scale;
  return ep;
}

// n / d for 0 <= n < 2^31 and a divisor d >= 1 fixed for a launch: one
// multiply-high and a shift (the round-up method; exact on that range).
struct FastDiv {
  int d;
  unsigned mul;
  int shift;
};

__host__ __device__ inline FastDiv make_fastdiv(int d) {
  FastDiv f;
  f.d = d;
  f.mul = 0;
  f.shift = 0;
  if (d > 1) {
    int l = 0;
    while ((1u << l) < (unsigned)d) ++l;  // ceil(log2 d)
    f.mul = (unsigned)(((1ull << (31 + l)) + (unsigned)d - 1) / (unsigned)d);
    f.shift = l - 1;
  }
  return f;
}

__device__ __forceinline__ int fast_div(int n, const FastDiv& f) {
  return f.d == 1 ? n : (int)(__umulhi((unsigned)n, f.mul) >> f.shift);
}

// Each shared library carries its own copy: the wrappers name a failed
// launch's error without linking the CUDA runtime into Python.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
