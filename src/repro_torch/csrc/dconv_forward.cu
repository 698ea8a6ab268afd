// Zero-free direct / dilated (atrous) forward convolution, fp32.
//
// Replaces repro/kernels/dconv_forward.py::dconv_forward_pallas (body
// _df_kernel):
//   y[b,i,j,co] = ep( sum_{kx,ky,ci} x[b, i*S+kx*D-P, j*S+ky*D-P, ci]
//                                    * W[kx,ky,ci,co] )
// over the K*K real taps only: the D-dilated filter is never formed.
//
// Design.  One thread per output element (b, i, j, co), co fastest, so a
// warp's W loads and y stores are contiguous and its x loads are
// broadcasts of a few pixels.  The Pallas kernel's sequential
// (Cin-tile, tap) grid axes, which accumulated into a stationary VMEM
// block, become the thread's own tap and channel loops into one fp32
// register; the epilogue is applied in that register before the single
// store.  Padding is a bounds predicate on the x load, so neither the
// host pad nor pad_to_tap_windows exists.  No atomics, no shared memory.
//
// Bound.  On the slice's ASPP branches (3x3, Cin=3, Cout=16) the kernel
// does 27 MACs per output element and writes 16 floats per pixel read:
// the bound is the output bytes (memory), not the arithmetic.
#include <cuda_runtime.h>

#include "common.cuh"
#include "conv_body.cuh"

// The element body (tap and channel loops, padding predicate) is
// conv_body.cuh::direct_conv_element, shared with the ddy role of
// tconv_backward.cu.
__global__ void dconv_forward_kernel(const float* __restrict__ x,
                                     const float* __restrict__ w,
                                     float* __restrict__ y, ConvGeom g,
                                     EpilogueArgs ep) {
  const long long total = (long long)g.B * g.Oh * g.Ow * g.Cout;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  y[idx] = apply_epilogue(direct_conv_element(Plain{x}, w, g, idx),
                          (int)(idx % g.Cout), ep);
}

// x (B,Nh,Nw,Cin), w (Kh,Kw,Cin,Cout), bias (Cout,) or null ->
// y (B,Oh,Ow,Cout); all fp32, contiguous, on the device of `stream`.
// Returns cudaGetLastError() after the launch.
extern "C" int dconv_forward_f32(const void* x, const void* w,
                                 const void* bias, void* y, int B, int Nh,
                                 int Nw, int Cin, int Kh, int Kw, int Cout,
                                 int Oh, int Ow, int sh, int sw, int ph,
                                 int pw, int dh, int dw, int act,
                                 float slope, int has_scale, float scale,
                                 void* stream) {
  const ConvGeom g = make_geom(B, Nh, Nw, Cin, Oh, Ow, Cout, Kh, Kw, sh, sw,
                               ph, pw, dh, dw);
  const long long total = (long long)B * Oh * Ow * Cout;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0) {
    dconv_forward_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
        (const float*)x, (const float*)w, (float*)y, g,
        make_epilogue(bias, act, slope, has_scale, scale));
  }
  return (int)cudaGetLastError();
}
