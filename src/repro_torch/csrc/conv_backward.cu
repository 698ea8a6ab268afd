// Fused dual-gradient backward of a direct / dilated conv, fp32: dx, dW
// and (with a bias) db from ONE launch.
//
// Replaces repro/kernels/dconv_backward.py::conv_backward_pallas (body
// _bwd_kernel).  For the forward y = ep(conv(x, W)) with cotangent dy:
//   m  = dy * act'(y)                   (the masked, unscaled cotangent)
//   dx = tconv(scale * m, W)            zero-free, by residue class
//   dW[kx,ky,ci,co] = sum_{b,i,j} x[b, i*S+kx*D-P, j*S+ky*D-P, ci]
//                                 * scale * m[b,i,j,co]
//   db = sum_{b,i,j} m[b,i,j,:]         (no scale, as in repro)
// act' comes from the forward OUTPUT y: relu y > 0, leaky_relu
// where(y > 0, 1, slope), tanh 1 - y^2.
//
// Design.  The Pallas grid kept dW and db stationary in VMEM across its
// sequential (b, phase, co, tap) axes.  CUDA blocks run in no order, so
// this is one grid of CTA roles, chosen by blockIdx.x ranges:
//   [0, n_dw)            dW: conv_body.cuh::filter_grad_tile, 32 output
//                        channels of one (tap, ci) per CTA, the sum over
//                        (b, i, j) split over 8 warps in a fixed loop and
//                        added by a fixed shared-memory tree;
//   [n_dw, n_dw + n_db)  db: channel_sum_tile, the same reduction shape;
//   the rest             dx: one element per thread,
//                        conv_body.cuh::phase_element (tconv_phase.cu's
//                        body), each CTA inside one residue class.
// The long reduction CTAs come first, so the many short dx CTAs fill the
// SMs around them.  The mask is applied as dy is loaded (the `Masked`
// reader), never stored: dy and y are read, m is not written.  No
// atomics anywhere, so the same inputs give the same bits.
//
// Bound.  At the training path's shapes (B = 64, K = 4 or 3, S = 2) the
// unique bytes (x, dy, y, dx) and the useful MACs of the two products
// give bounds of a few microseconds each; this simple form re-reads dy
// through L2 once per (tap, ci) for dW and runs one dependent fp32 FMA
// chain per thread, so latency, not either bound, limits it.
#include <cuda_runtime.h>

#include "common.cuh"
#include "conv_body.cuh"

__global__ void __launch_bounds__(kRoleThreads) conv_backward_kernel(
    Masked cot, Masked mask_only, const float* __restrict__ x,
    const float* __restrict__ w, float* __restrict__ dx,
    float* __restrict__ dw, float* __restrict__ db, ConvGeom gx,
    ConvGeom gdx, PhaseGeom t, int n_dw, int n_db, int dx_tiles) {
  int blk = blockIdx.x;
  if (blk < n_dw) {
    filter_grad_tile(Plain{x}, cot, dw, gx, blk);
    return;
  }
  blk -= n_dw;
  if (blk < n_db) {
    channel_sum_tile(mask_only, db, gx.B * gx.Oh * gx.Ow, gx.Cout, blk);
    return;
  }
  blk -= n_db;
  const int classes = gdx.sh * gdx.sw;
  const int tile = blk % dx_tiles;
  const int cls = (blk / dx_tiles) % classes;
  const int b = blk / (dx_tiles * classes);
  const long long e = (long long)tile * blockDim.x + threadIdx.x;
  if (e >= (long long)t.Mh * t.Mw * gdx.Cin) return;
  long long out;
  int ci;
  float acc;
  if (phase_element(cot, w, gdx, t, b, cls / gdx.sw, cls % gdx.sw, e, &out,
                    &ci, &acc))
    dx[out] = acc;
}

// x (B,Nh_x,Nw_x,Cin), dy and y (B,Oh,Ow,Cout), w (Kh,Kw,Cin,Cout) ->
// dx (B,Nh,Nw,Cin), dw (Kh,Kw,Cin,Cout), db (Cout,); all fp32,
// contiguous.  y == nullptr means no activation; db == nullptr means no
// bias (its role is not launched).  (Nh, Nw) is the dx frame, n_out; the
// tap-phase bookkeeping comes from ConvSpec on the host.  Returns
// cudaGetLastError() after the launch.
extern "C" int conv_backward_f32(
    const void* x, const void* dy, const void* y, const void* w, void* dx,
    void* dw, void* db, int B, int Nh_x, int Nw_x, int Cin, int Oh, int Ow,
    int Cout, int Kh, int Kw, int Nh, int Nw, int sh, int sw, int ph, int pw,
    int dil_h, int dil_w, int per_h, int per_w, int step_h, int step_w,
    int KP, int KQ, int TPh, int TPw, int act, float slope, int has_scale,
    float scale, void* stream) {
  const ConvGeom gx = make_geom(B, Nh_x, Nw_x, Cin, Oh, Ow, Cout, Kh, Kw, sh,
                                sw, ph, pw, dil_h, dil_w);
  const ConvGeom gdx = make_geom(B, Nh, Nw, Cin, Oh, Ow, Cout, Kh, Kw, sh,
                                 sw, ph, pw, dil_h, dil_w);
  const PhaseGeom t = make_phase_geom(gdx, per_h, per_w, step_h, step_w, KP,
                                      KQ, TPh, TPw);
  const float s = has_scale ? scale : 1.0f;
  const Masked cot = make_masked(dy, y, act, slope, s);
  const Masked mask_only = make_masked(dy, y, act, slope, 1.0f);
  const long long n_dw =
      (long long)Kh * Kw * Cin * ((Cout + kLanes - 1) / kLanes);
  const long long n_db = db != nullptr ? (Cout + kLanes - 1) / kLanes : 0;
  const long long per_class = (long long)t.Mh * t.Mw * Cin;
  const long long dx_tiles = (per_class + kRoleThreads - 1) / kRoleThreads;
  const long long blocks = n_dw + n_db + (long long)B * sh * sw * dx_tiles;
  if (blocks > 0) {
    conv_backward_kernel<<<(unsigned)blocks, kRoleThreads, 0,
                           (cudaStream_t)stream>>>(
        cot, mask_only, (const float*)x, (const float*)w, (float*)dx,
        (float*)dw, (float*)db, gx, gdx, t, (int)n_dw, (int)n_db,
        (int)dx_tiles);
  }
  return (int)cudaGetLastError();
}
