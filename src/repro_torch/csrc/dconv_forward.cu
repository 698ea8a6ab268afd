// Zero-free direct / dilated (atrous) forward convolution, fp32 or bf16
// (dconv_forward_f32 / dconv_forward_bf16: bf16 operands and output, fp32
// sums, one rounding at the store -- conv_body.cuh's element types).
//
// Replaces repro/kernels/dconv_forward.py::dconv_forward_pallas (body
// _df_kernel):
//   y[b,i,j,co] = ep( sum_{kx,ky,ci} x[b, i*S+kx*D-P, j*S+ky*D-P, ci]
//                                    * W[kx,ky,ci,co] )
// over the K*K real taps only: the D-dilated filter is never formed.
//
// Design.  The ddy role of the tiled implicit-GEMM engine
// (conv_body.cuh::ddy_tile), launched alone with a plain input: a GEMM
// of the (B*Oh*Ow) output positions x Cout over k = (tap, ci), in tiles
// the plan (kernels/dconv_backward.py::plan) picks, with 4 x 4 register
// micro-tiles, fed by a 3-stage cp.async ring of 16-deep slabs -- x
// gathered along ci per tap, W read along Cout.  Padding and dilation are
// the gather's bounds predicate (cp.async's zero fill), so neither the
// host pad nor pad_to_tap_windows exists.  The Pallas kernel's
// sequential (Cin-tile, tap) grid axes, which accumulated into a
// stationary VMEM block, become the tile's reduction axis; when the tiles
// alone would not fill the card the plan splits it over several CTAs
// whose partial tiles the last of them adds in split order (no atomics:
// the same bits on every run).  The epilogue act(scale * v + bias[co]) is
// applied in the tile's store, to the final sum.
//
// Bound.  On the slice's ASPP branches (3x3, Cin=3, Cout=16, B = 4 at
// 128x128) each output does 27 MACs and the kernel writes 16 floats per
// pixel read: the output bytes (memory) bound it.  On the training
// layers (B = 64, K = 3 or 4, Cout 32-128) the useful arithmetic does.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "conv_body.cuh"

template <class E>
struct FwdArgs {
  PlainT<E> x;
  const E* w;
  E* y;
  ConvGeom g;
  GeomDiv fd;
  RoleGrid grid;
  FusedEpilogueT<E> ep;
};

template <class T, class E>
__global__ void __launch_bounds__(kGemmThreads)
    dconv_forward_kernel(const FwdArgs<E> a) {
  extern __shared__ __align__(16) float smem[];
  int tile;
  Split sp;
  role_of<1, T::BM * T::BN>(a.grid, &tile, &sp);
  ddy_tile<T>(a.x, a.w, a.y, a.g, a.fd, tile, sp, smem, a.ep);
}

#define FWD_PARAMS                                                           \
  const void *x, const void *w, const void *bias, void *y, int B, int Nh,  \
      int Nw, int Cin, int Kh, int Kw, int Cout, int Oh, int Ow, int sh,   \
      int sw, int ph, int pw, int dh, int dw, int act, float slope,        \
      int has_scale, float scale, int tile, int splits, void *ws,          \
      int64_t ws_floats, void *tickets, int n_tickets, void *stream
#define FWD_ARGS                                                             \
  x, w, bias, y, B, Nh, Nw, Cin, Kh, Kw, Cout, Oh, Ow, sh, sw, ph, pw, dh,  \
      dw, act, slope, has_scale, scale, tile, splits, ws, ws_floats,        \
      tickets, n_tickets, stream

template <class E>
static int dconv_forward(FWD_PARAMS) {
  FwdArgs<E> a;
  a.g = make_geom(B, Nh, Nw, Cin, Oh, Ow, Cout, Kh, Kw, sh, sw, ph, pw, dh,
                  dw);
  a.fd = make_geom_div(a.g);
  const long long positions = (long long)B * Oh * Ow;
  if (!forward_tile_ok(tile) || Cin < 1 || Cout < 1 ||
      !fits_int((long long)B * Nh * Nw * Cin) ||
      !fits_int(positions * Cout) ||
      !fits_int((long long)Kh * Kw * Cin * Cout))
    return (int)cudaErrorInvalidValue;
  a.x = PlainT<E>{static_cast<const E*>(x)};
  a.w = static_cast<const E*>(w);
  a.y = static_cast<E*>(y);
  a.ep = FusedEpilogueT<E>{
      make_epilogue<E>(bias, act, slope, has_scale, scale)};
  int bm, bn;
  tile_extent(tile, &bm, &bn);
  const long long tiles = (positions + bm - 1) / bm * ((Cout + bn - 1) / bn);
  if (!gather_grid(&a.grid, tiles, bm * bn, splits, ws, ws_floats, tickets,
                   n_tickets))
    return (int)cudaErrorInvalidValue;
  const long long blocks = role_grid_blocks(a.grid);
  if (blocks == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_forward_tile(tile, [&](auto td) {
    using T = decltype(td);
    return launch_roles<dconv_forward_kernel<T, E>>(
        blocks, ddy_smem_floats<T, PlainT<E>>(), a, s);
  });
}

// x (B,Nh,Nw,Cin), w (Kh,Kw,Cin,Cout), bias (Cout,) or null ->
// y (B,Oh,Ow,Cout); all fp32 (_f32) or all bf16 (_bf16), contiguous, on
// the device of `stream`.  The tile (id) and splits come from the plan,
// with a workspace of ws_floats floats and n_tickets ints that are 0
// (and are 0 again after the launch).  Returns the launch's CUDA error
// (cudaErrorInvalidValue for a plan, a workspace or a size it cannot
// take).
extern "C" int dconv_forward_f32(FWD_PARAMS) {
  return dconv_forward<float>(FWD_ARGS);
}

extern "C" int dconv_forward_bf16(FWD_PARAMS) {
  return dconv_forward<__nv_bfloat16>(FWD_ARGS);
}
