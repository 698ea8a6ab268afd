// Fused dual-gradient backward of a transposed conv, fp32: ddy, dW and
// (with a bias) db from ONE launch.
//
// Replaces repro/kernels/dconv_backward.py::tconv_backward_pallas (body
// _ct_bwd_kernel).  For the forward z = ep(tconv(dy, W)) (a generator
// layer) with cotangent g of z:
//   gm  = g * act'(z)                   (masked, unscaled)
//   ddy = conv(scale * gm, W)           the direct conv of the cotangent
//   dW[kx,ky,ci,co] = sum_{b,i,j} scale * gm[b, i*S+kx*D-P, j*S+ky*D-P, ci]
//                                 * dy[b,i,j,co]
//   db  = sum_{b,h,w} gm[b,h,w,:]       over the tconv's OUTPUT channels
//                                       (Cin), no scale
// The cotangent sits in the INPUT role of both products.
//
// Design.  One grid of CTA roles, as in conv_backward.cu:
//   [0, n_dw)            dW: conv_body.cuh::filter_grad_tile with the
//                        masked g as its x operand;
//   [n_dw, n_db + n_dw)  db: channel_sum_tile over g's (b, h, w);
//   the rest             ddy: one element per thread,
//                        conv_body.cuh::direct_conv_element
//                        (dconv_forward.cu's body) over the masked g.
// The Pallas kernel shared one tap gather of the VMEM-resident g between
// both matmuls; here both roles read g through the `Masked` reader, which
// forms g * act'(z) * scale at each load, so no masked copy reaches
// device memory.  dW and db sum in a fixed loop and a fixed tree: no
// atomics, the same bits on every run.
//
// Bound.  At the generator's shapes (B = 64, K = 4, S = 2; Cout 128 / 64
// / 32) the bytes are a few MB and the useful MACs a few hundred million:
// bounds of microseconds.  dW re-reads dy through L2 once per (tap, ci)
// and each thread runs one dependent fp32 FMA chain, so latency limits
// this simple form.
#include <cuda_runtime.h>

#include "common.cuh"
#include "conv_body.cuh"

__global__ void __launch_bounds__(kRoleThreads) tconv_backward_kernel(
    Masked gs, Masked gm, const float* __restrict__ dy,
    const float* __restrict__ w, float* __restrict__ ddy,
    float* __restrict__ dw, float* __restrict__ db, ConvGeom g, int n_dw,
    int n_db) {
  int blk = blockIdx.x;
  if (blk < n_dw) {
    filter_grad_tile(gs, Plain{dy}, dw, g, blk);
    return;
  }
  blk -= n_dw;
  if (blk < n_db) {
    channel_sum_tile(gm, db, g.B * g.Nh * g.Nw, g.Cin, blk);
    return;
  }
  blk -= n_db;
  const long long idx = (long long)blk * blockDim.x + threadIdx.x;
  if (idx >= (long long)g.B * g.Oh * g.Ow * g.Cout) return;
  ddy[idx] = direct_conv_element(gs, w, g, idx);
}

// g and z (B,Nh,Nw,Cin), dy (B,Oh,Ow,Cout), w (Kh,Kw,Cin,Cout) ->
// ddy (B,Oh,Ow,Cout), dw (Kh,Kw,Cin,Cout), db (Cin,); all fp32,
// contiguous.  z == nullptr means no activation; db == nullptr means no
// bias.  Returns cudaGetLastError() after the launch.
extern "C" int tconv_backward_f32(
    const void* g, const void* z, const void* dy, const void* w, void* ddy,
    void* dw, void* db, int B, int Nh, int Nw, int Cin, int Oh, int Ow,
    int Cout, int Kh, int Kw, int sh, int sw, int ph, int pw, int dil_h,
    int dil_w, int act, float slope, int has_scale, float scale,
    void* stream) {
  const ConvGeom geom = make_geom(B, Nh, Nw, Cin, Oh, Ow, Cout, Kh, Kw, sh,
                                  sw, ph, pw, dil_h, dil_w);
  const Masked gs = make_masked(g, z, act, slope, has_scale ? scale : 1.0f);
  const Masked gm = make_masked(g, z, act, slope, 1.0f);
  const long long n_dw =
      (long long)Kh * Kw * Cin * ((Cout + kLanes - 1) / kLanes);
  const long long n_db = db != nullptr ? (Cin + kLanes - 1) / kLanes : 0;
  const long long n_ddy = ((long long)B * Oh * Ow * Cout + kRoleThreads - 1)
                          / kRoleThreads;
  const long long blocks = n_dw + n_db + n_ddy;
  if (blocks > 0) {
    tconv_backward_kernel<<<(unsigned)blocks, kRoleThreads, 0,
                            (cudaStream_t)stream>>>(
        gs, gm, (const float*)dy, (const float*)w, (float*)ddy, (float*)dw,
        (float*)db, geom, (int)n_dw, (int)n_db);
  }
  return (int)cudaGetLastError();
}
