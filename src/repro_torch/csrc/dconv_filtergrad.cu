// Zero-free filter gradient of a direct / dilated conv, fp32:
//   dW[kx,ky,ci,co] = sum_{b,i,j} x[b, i*S+kx*D-P, j*S+ky*D-P, ci]
//                                 * dy[b,i,j,co]
// over the K*K real taps only (the D-dilated filter never exists).
//
// Replaces repro/kernels/dconv_filtergrad.py::dconv_filter_grad_pallas
// (body _fg_kernel), which accumulated over its sequential (b, spatial
// slab, tap) grid axes into a (T, ci_t, co_t) block stationary in VMEM.
//
// Design.  This is the dW role of conv_backward.cu and tconv_backward.cu
// launched alone, with no cotangent mask: every CTA runs
// conv_body.cuh::filter_grad_tile for 32 output channels of one
// (tap, ci).  The sequential grid axes become one fixed loop per warp
// over (b, i, j) and a fixed shared-memory tree over the 8 warps, so the
// sum needs no atomics and gives the same bits on every run.  Padding is
// a bounds predicate on the x load: no padded copy of x exists.
//
// Bound.  At the training path's shapes the bytes (x, dy, dW) are a few
// MB and the useful MACs tens of millions: microseconds.  This simple form
// re-reads dy through L2 once per (tap, ci), and at the first layers
// (Cin = 3) launches only K*K*3 CTAs for its 16384-term sums, so latency
// and occupancy limit it.
#include <cuda_runtime.h>

#include "common.cuh"
#include "conv_body.cuh"

__global__ void __launch_bounds__(kRoleThreads) dconv_filter_grad_kernel(
    const float* __restrict__ x, const float* __restrict__ dy,
    float* __restrict__ dw, ConvGeom g) {
  filter_grad_tile(Plain{x}, Plain{dy}, dw, g, blockIdx.x);
}

// x (B,Nh,Nw,Cin), dy (B,Oh,Ow,Cout) -> dw (Kh,Kw,Cin,Cout); all fp32,
// contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int dconv_filter_grad_f32(const void* x, const void* dy, void* dw,
                                     int B, int Nh, int Nw, int Cin, int Oh,
                                     int Ow, int Cout, int Kh, int Kw,
                                     int sh, int sw, int ph, int pw,
                                     int dil_h, int dil_w, void* stream) {
  const ConvGeom g = make_geom(B, Nh, Nw, Cin, Oh, Ow, Cout, Kh, Kw, sh, sw,
                               ph, pw, dil_h, dil_w);
  const long long blocks =
      (long long)Kh * Kw * Cin * ((Cout + kLanes - 1) / kLanes);
  if (blocks > 0) {
    dconv_filter_grad_kernel<<<(unsigned)blocks, kRoleThreads, 0,
                               (cudaStream_t)stream>>>(
        (const float*)x, (const float*)dy, (float*)dw, g);
  }
  return (int)cudaGetLastError();
}
