// Fused dual-gradient backward of a transposed conv, fp32 or bf16
// (tconv_backward_f32 / tconv_backward_bf16: bf16 operands and outputs,
// fp32 sums and mask, one rounding at each store -- conv_body.cuh's
// element types): ddy, dW and (with a bias) db from ONE launch.
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
//   dW   conv_body.cuh::dw_tile with the masked g as its x operand, each
//        tile's positions split over `dw_splits` CTAs;
//   db   channel_sum over g's (b, h, w), split the same way;
//   ddy  ddy_tile, one tile of the implicit GEMM (B*Oh*Ow) x Cout over
//        (tap, ci), its reduction split over `splits` CTAs when the tiles
//        alone would not fill the card.
// Split partials meet in a workspace and are added in split order by the
// last split of each tile (split_finish).
// The Pallas kernel shared one tap gather of the VMEM-resident g between
// both matmuls; here both roles read g through the `Masked` reader, which
// forms g * act'(z) * scale on its way to shared memory, so no masked copy
// reaches device memory.  No atomics: the same bits on every run.
//
// Bound.  At the generator's shapes (B = 64, K = 4, S = 2; Cout 128 / 64
// / 32) the bytes are a few MB and the useful MACs a few hundred million:
// bounds of 2-7 microseconds.  The tiles reuse each operand element TM or
// TN times from registers and BN or BM times from shared memory; the
// gathers' index arithmetic and the few tiles of t1 (M = 1024 positions)
// are what is left.
#include <cuda_runtime.h>

#include "common.cuh"
#include "conv_body.cuh"

template <class E>
struct CtArgs {
  MaskedT<E> gs;  // scale * g * act'(z)
  MaskedT<E> gm;  // g * act'(z)
  const E* dy;
  const E* w;
  E* ddy;
  E* dw;
  E* db;
  ConvGeom g;
  GeomDiv fd;
  RoleGrid grid;
};

template <class TD, class TW, class E>
__global__ void __launch_bounds__(kGemmThreads)
    tconv_backward_kernel(const CtArgs<E> a) {
  extern __shared__ __align__(16) float smem[];
  int tile;
  Split sp;
  const int role = role_of<TW::BM * TW::BN, TD::BM * TD::BN>(a.grid, &tile,
                                                             &sp);
  if (role == 0)
    dw_tile<TW>(a.gs, PlainT<E>{a.dy}, a.dw, a.g, a.fd, tile, sp, smem);
  else if (role == 1)
    channel_sum(a.gm, a.db, a.g.B * a.g.Nh * a.g.Nw, a.g.Cin, tile, sp,
                smem);
  else
    ddy_tile<TD>(a.gs, a.w, a.ddy, a.g, a.fd, tile, sp, smem);
}

#define CT_PARAMS                                                            \
  const void *g, const void *z, const void *dy, const void *w, void *ddy,  \
      void *dw, void *db, int B, int Nh, int Nw, int Cin, int Oh, int Ow,  \
      int Cout, int Kh, int Kw, int sh, int sw, int ph, int pw, int dil_h, \
      int dil_w, int act, float slope, int has_scale, float scale,         \
      int tile, int splits, int dw_tile, int dw_splits, int chunk,         \
      void *ws, int64_t ws_floats, void *tickets, int n_tickets,           \
      void *stream
#define CT_ARGS                                                              \
  g, z, dy, w, ddy, dw, db, B, Nh, Nw, Cin, Oh, Ow, Cout, Kh, Kw, sh, sw,   \
      ph, pw, dil_h, dil_w, act, slope, has_scale, scale, tile, splits,     \
      dw_tile, dw_splits, chunk, ws, ws_floats, tickets, n_tickets, stream

template <class E>
static int tconv_backward(CT_PARAMS) {
  CtArgs<E> a;
  a.g = make_geom(B, Nh, Nw, Cin, Oh, Ow, Cout, Kh, Kw, sh, sw, ph, pw,
                  dil_h, dil_w);
  a.fd = make_geom_div(a.g);
  const long long positions = (long long)B * Oh * Ow;
  if (!gather_tile_ok(tile) || !dw_tile_ok(dw_tile) || Cin < 1 || Cout < 1 ||
      !fits_int((long long)B * Nh * Nw * Cin) ||
      !fits_int(positions * Cout) ||
      !fits_int((long long)Kh * Kw * Cin * Cout))
    return (int)cudaErrorInvalidValue;
  a.gs = make_masked<E>(g, z, act, slope, has_scale ? scale : 1.0f);
  a.gm = make_masked<E>(g, z, act, slope, 1.0f);
  a.dy = static_cast<const E*>(dy);
  a.w = static_cast<const E*>(w);
  a.ddy = static_cast<E*>(ddy);
  a.dw = static_cast<E*>(dw);
  a.db = static_cast<E*>(db);
  int bm, bn;
  tile_extent(dw_tile, &bm, &bn);
  const long long n_dw =
      (long long)((Kh * Kw * Cin + bm - 1) / bm) * ((Cout + bn - 1) / bn);
  const int ct = Cin < kGemmThreads ? Cin : kGemmThreads;
  const long long n_db = db != nullptr ? (Cin + ct - 1) / ct : 0;
  tile_extent(tile, &bm, &bn);
  const long long n_dx = (positions + bm - 1) / bm * ((Cout + bn - 1) / bn);
  RoleGrid& grid = a.grid;
  grid.n_dw = (int)n_dw;
  grid.n_db = (int)n_db;
  grid.n_dx = (int)n_dx;
  grid.dw_splits = dw_splits;
  grid.splits = splits;
  grid.ws = static_cast<float*>(ws);
  grid.tickets = static_cast<int*>(tickets);
  int dw_bm, dw_bn;
  tile_extent(dw_tile, &dw_bm, &dw_bn);
  const long long need = role_grid_workspace(&grid, dw_bm * dw_bn, bm * bn);
  if (!plan_ok(grid, chunk, positions, ws_floats, need, n_tickets))
    return (int)cudaErrorInvalidValue;
  const long long blocks = role_grid_blocks(grid);
  if (blocks == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_tile(tile, [&](auto td) {
    return with_dw_tile(dw_tile, [&](auto tw) {
      using TD = decltype(td);
      using TW = decltype(tw);
      constexpr int floats = cmax(
          cmax(dw_smem_floats<TW, MaskedT<E>, PlainT<E>>(),
               ddy_smem_floats<TD, MaskedT<E>>()),
          kSumSmemFloats);
      return launch_roles<tconv_backward_kernel<TD, TW, E>>(blocks, floats,
                                                            a, s);
    });
  });
}

// g and z (B,Nh,Nw,Cin), dy (B,Oh,Ow,Cout), w (Kh,Kw,Cin,Cout) ->
// ddy (B,Oh,Ow,Cout), dw (Kh,Kw,Cin,Cout), db (Cin,); all fp32 (_f32)
// or all bf16 (_bf16), contiguous.  z == nullptr means no activation;
// db == nullptr means no bias.  The tiles (ids), splits and dW chunk
// come from the plan, with a workspace of ws_floats floats and n_tickets
// ints that are 0 (and are 0 again after the launch).  Returns the
// launch's CUDA error (cudaErrorInvalidValue for a plan, a workspace or
// a size it cannot take).
extern "C" int tconv_backward_f32(CT_PARAMS) {
  return tconv_backward<float>(CT_ARGS);
}

extern "C" int tconv_backward_bf16(CT_PARAMS) {
  return tconv_backward<__nv_bfloat16>(CT_ARGS);
}
