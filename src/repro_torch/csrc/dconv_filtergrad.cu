// Zero-free filter gradient of a direct / dilated conv, fp32 or bf16
// (dconv_filter_grad_f32 / dconv_filter_grad_bf16: bf16 operands and dW,
// fp32 sums, one rounding at the store -- conv_body.cuh's element types):
//   dW[kx,ky,ci,co] = sum_{b,i,j} x[b, i*S+kx*D-P, j*S+ky*D-P, ci]
//                                 * dy[b,i,j,co]
// over the K*K real taps only (the D-dilated filter never exists).
//
// Replaces repro/kernels/dconv_filtergrad.py::dconv_filter_grad_pallas
// (body _fg_kernel), which accumulated over its sequential (b, spatial
// slab, tap) grid axes into a (T, ci_t, co_t) block stationary in VMEM.
//
// Design.  This is the dW role of conv_backward.cu and tconv_backward.cu
// launched alone, with no cotangent mask: `dw_splits` CTAs per tile of
// the implicit GEMM (Kh*Kw*Cin) x Cout over the B*Oh*Ow positions run
// conv_body.cuh::dw_tile.  The sequential grid axes become consecutive
// position chunks, one per CTA, whose partial tiles the last of them adds
// in split order (split_finish): no atomics on dW, the same bits on every
// run.  Padding is a bounds predicate on the x load: no padded copy of x
// exists.
//
// Bound.  At the training path's shapes the bytes (x, dy, dW) are a few
// MB and the useful MACs tens of millions: microseconds.  The tile reuses
// each x and dy element from shared memory BN and BM times; at Cin = 3
// the whole gradient is one tile, its positions split over 64 CTAs.
#include <cuda_runtime.h>

#include "common.cuh"
#include "conv_body.cuh"

template <class E>
struct FgArgs {
  const E* x;
  const E* dy;
  E* dw;
  ConvGeom g;
  GeomDiv fd;
  RoleGrid grid;
};

template <class TW, class E>
__global__ void __launch_bounds__(kGemmThreads)
    dconv_filter_grad_kernel(const FgArgs<E> a) {
  extern __shared__ __align__(16) float smem[];
  int tile;
  Split sp;
  role_of<TW::BM * TW::BN, 0>(a.grid, &tile, &sp);
  dw_tile<TW>(PlainT<E>{a.x}, PlainT<E>{a.dy}, a.dw, a.g, a.fd, tile, sp,
              smem);
}

#define FG_PARAMS                                                            \
  const void *x, const void *dy, void *dw, int B, int Nh, int Nw, int Cin, \
      int Oh, int Ow, int Cout, int Kh, int Kw, int sh, int sw, int ph,    \
      int pw, int dil_h, int dil_w, int dw_tile, int dw_splits, int chunk, \
      void *ws, int64_t ws_floats, void *tickets, int n_tickets,           \
      void *stream
#define FG_ARGS                                                              \
  x, dy, dw, B, Nh, Nw, Cin, Oh, Ow, Cout, Kh, Kw, sh, sw, ph, pw, dil_h,   \
      dil_w, dw_tile, dw_splits, chunk, ws, ws_floats, tickets, n_tickets,  \
      stream

template <class E>
static int dconv_filter_grad(FG_PARAMS) {
  FgArgs<E> a;
  a.g = make_geom(B, Nh, Nw, Cin, Oh, Ow, Cout, Kh, Kw, sh, sw, ph, pw,
                  dil_h, dil_w);
  a.fd = make_geom_div(a.g);
  const long long positions = (long long)B * Oh * Ow;
  if (!dw_tile_ok(dw_tile) || Cin < 1 || Cout < 1 ||
      !fits_int((long long)B * Nh * Nw * Cin) ||
      !fits_int(positions * Cout) ||
      !fits_int((long long)Kh * Kw * Cin * Cout))
    return (int)cudaErrorInvalidValue;
  a.x = static_cast<const E*>(x);
  a.dy = static_cast<const E*>(dy);
  a.dw = static_cast<E*>(dw);
  int bm, bn;
  tile_extent(dw_tile, &bm, &bn);
  const long long n_dw =
      (long long)((Kh * Kw * Cin + bm - 1) / bm) * ((Cout + bn - 1) / bn);
  RoleGrid& grid = a.grid;
  grid.n_dw = (int)n_dw;
  grid.n_db = grid.n_dx = 0;
  grid.dw_splits = dw_splits;
  grid.splits = 1;
  grid.ws = static_cast<float*>(ws);
  grid.tickets = static_cast<int*>(tickets);
  const long long need = role_grid_workspace(&grid, bm * bn, 0);
  if (!plan_ok(grid, chunk, positions, ws_floats, need, n_tickets))
    return (int)cudaErrorInvalidValue;
  const long long blocks = role_grid_blocks(grid);
  if (blocks == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_dw_tile(dw_tile, [&](auto tw) {
    using TW = decltype(tw);
    return launch_roles<dconv_filter_grad_kernel<TW, E>>(
        blocks, dw_smem_floats<TW, PlainT<E>, PlainT<E>>(), a, s);
  });
}

// x (B,Nh,Nw,Cin), dy (B,Oh,Ow,Cout) -> dw (Kh,Kw,Cin,Cout); all fp32
// (_f32) or all bf16 (_bf16), contiguous.  dw_tile (a tile id),
// dw_splits and chunk come from the plan, with a workspace of ws_floats
// floats and n_tickets ints that are 0 (and are 0 again after the
// launch).  Returns the launch's CUDA error (cudaErrorInvalidValue for a
// plan, a workspace or a size it cannot take).
extern "C" int dconv_filter_grad_f32(FG_PARAMS) {
  return dconv_filter_grad<float>(FG_ARGS);
}

extern "C" int dconv_filter_grad_bf16(FG_PARAMS) {
  return dconv_filter_grad<__nv_bfloat16>(FG_ARGS);
}
