// Fused dual-gradient backward of a direct / dilated conv, fp32 or bf16
// (conv_backward_f32 / conv_backward_bf16: bf16 operands and outputs,
// fp32 sums and mask, one rounding at each store -- conv_body.cuh's
// element types): dx, dW and (with a bias) db from ONE launch.
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
// this is one grid of CTA roles (conv_body.cuh::RoleGrid):
//   dW  dw_tile, a tiled implicit GEMM (Kh*Kw*Cin) x Cout over the
//       B*Oh*Ow positions, each tile's positions split over `dw_splits`
//       CTAs;
//   db  channel_sum over the same positions, split the same way;
//   dx  dx_tile, one tile of a residue class's implicit GEMM (positions x
//       Cin over the class's taps x Cout), its reduction split over
//       `splits` CTAs when the tiles alone would not fill the card.
// The long reduction CTAs come first, so the many short dx tiles fill the
// SMs around them.  The splits of a tile write their partials to a
// workspace the wrapper allocates (torch.empty) and count themselves on
// an integer ticket; the last one adds the partials in split order and
// sets the ticket back to 0 (split_finish): no atomics on any output, the
// same inputs give the same bits.  The host's plan
// (kernels/dconv_backward.py::plan) picks each role's tile and splits.
// The mask is applied as dy is loaded (the `Masked` reader), on its way
// to shared memory, never stored: dy and y are read, m is not written.
//
// Non-overlapping convs (S = K, P = 0, D = 1 on both axes: patchify's
// S = K = 14, a 1x1 conv at S = 1) take the patch roles instead
// (conv_body.cuh: patch_dw_tile, patch_dx_tile), in a kernel of their
// own on the same RoleGrid, when the plan names tile 5 for both: dx is
// one GEMM m . W^T over (B*Oh*Ow) x (Kh*Kw*Cin), each row stored into
// dx's frame as Kh runs of Kw*Cin values, and dW one GEMM over the patch
// rows of x, on 128 x 128 tiles with 8 x 8 register micro-tiles, two
// CTAs an SM.  By residue class the dx role would run Kh*Kw one-tap
// classes of N = Cin columns, each reading the whole cotangent (196 at
// patchify).  A cotangent with no activation and no scale (patchify's)
// is read as it lies, not through the Masked reader.
//
// Bound.  At patchify's layer (B 8, 448x448, 3 -> 1024) the two
// products' 9.87e9 MACs bound the launch at 0.295 ms (fp32 FMA peak);
// the bytes at 0.023 ms.  The patch roles' 640 equal CTAs (320 dx tiles,
// 40 dW tiles split 8 ways) fill 2.4 waves of two CTAs an SM.  At the
// training path's shapes (B = 64, K = 4 or 3, S = 2) the unique bytes
// (x, dy, y, W, dx, dW) and the useful MACs of the two products give
// bounds of 2-7 microseconds.  The tiles reuse each
// operand element from registers TM or TN times and from shared memory
// BN or BM times; what is left is the gathers' index arithmetic, the
// re-reads of dy by the taps of one class (through L1 / L2), the split
// partials' round trip through L2, and, at Cin = 3, one dW tile whose
// 16384-position sum only the split spreads over the card.
#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"
#include "conv_body.cuh"

template <class E>
struct BwdArgs {
  MaskedT<E> cot;        // scale * dy * act'(y)
  MaskedT<E> mask_only;  // dy * act'(y)
  const E* x;
  const E* w;
  E* dx;
  E* dw;
  E* db;
  ConvGeom gx, gdx;  // the x frame and the dx frame (n_out)
  PhaseGeom t;
  GeomDiv fd;        // of gx; dx uses its Cout, which gdx shares
  RoleGrid grid;
};

template <class TD, class TW, class E>
__global__ void __launch_bounds__(kGemmThreads)
    conv_backward_kernel(const BwdArgs<E> a) {
  extern __shared__ __align__(16) float smem[];
  int tile;
  Split sp;
  const int role = role_of<TW::BM * TW::BN, TD::BM * TD::BN>(a.grid, &tile,
                                                             &sp);
  if (role == 0)
    dw_tile<TW>(PlainT<E>{a.x}, a.cot, a.dw, a.gx, a.fd, tile, sp, smem);
  else if (role == 1)
    channel_sum(a.mask_only, a.db, a.gx.B * a.gx.Oh * a.gx.Ow, a.gx.Cout,
                tile, sp, smem);
  else
    dx_tile<TD>(a.cot, a.w, a.dx, a.gdx, a.t, a.fd, tile, sp, smem);
}

// The patch roles' launch, two CTAs an SM.  A cotangent with no
// activation and no scale is read as it lies (kPlain: PlainT, one stage
// plane and no fix-up pass), else through the Masked reader: at
// patchify the Masked reader's second plane and fix-up pass take 21 %
// more time in fp32 and 13 % in bf16 (scripts/backward_roles.py).
template <class E, bool kPlain>
__global__ void __launch_bounds__(kGemmThreads, 2)
    conv_backward_patch_kernel(const BwdArgs<E> a) {
  extern __shared__ __align__(16) float smem[];
  using T = TilePatch;
  using C = std::conditional_t<kPlain, PlainT<E>, MaskedT<E>>;
  const C cot = [&] {
    if constexpr (kPlain) return PlainT<E>{a.cot.v};
    else return a.cot;
  }();
  int tile;
  Split sp;
  const int role = role_of<T::BM * T::BN, T::BM * T::BN>(a.grid, &tile, &sp);
  if (role == 0)
    patch_dw_tile<T>(PlainT<E>{a.x}, cot, a.dw, a.gx, a.fd, tile, sp, smem);
  else if (role == 1)
    channel_sum(a.mask_only, a.db, a.gx.B * a.gx.Oh * a.gx.Ow, a.gx.Cout,
                tile, sp, smem);
  else
    patch_dx_tile<T>(cot, a.w, a.dx, a.gdx, tile, sp, smem,
                     tile * sp.splits + sp.split, a.grid.n_dx * sp.splits);
}

#define BWD_PARAMS                                                           \
  const void *x, const void *dy, const void *y, const void *w, void *dx,   \
      void *dw, void *db, int B, int Nh_x, int Nw_x, int Cin, int Oh,      \
      int Ow, int Cout, int Kh, int Kw, int Nh, int Nw, int sh, int sw,    \
      int ph, int pw, int dil_h, int dil_w, int per_h, int per_w,          \
      int step_h, int step_w, int TPh, int TPw, int act, float slope,      \
      int has_scale, float scale, int tile, int splits, int dw_tile,       \
      int dw_splits, int chunk, void *ws, int64_t ws_floats,               \
      void *tickets, int n_tickets, void *stream
#define BWD_ARGS                                                             \
  x, dy, y, w, dx, dw, db, B, Nh_x, Nw_x, Cin, Oh, Ow, Cout, Kh, Kw, Nh,    \
      Nw, sh, sw, ph, pw, dil_h, dil_w, per_h, per_w, step_h, step_w, TPh,  \
      TPw, act, slope, has_scale, scale, tile, splits, dw_tile, dw_splits,  \
      chunk, ws, ws_floats, tickets, n_tickets, stream

template <class E>
static int conv_backward(BWD_PARAMS) {
  BwdArgs<E> a;
  a.gx = make_geom(B, Nh_x, Nw_x, Cin, Oh, Ow, Cout, Kh, Kw, sh, sw, ph, pw,
                   dil_h, dil_w);
  a.gdx = make_geom(B, Nh, Nw, Cin, Oh, Ow, Cout, Kh, Kw, sh, sw, ph, pw,
                    dil_h, dil_w);
  a.t = make_phase_geom(per_h, per_w, step_h, step_w, TPh, TPw);
  a.fd = make_geom_div(a.gx);
  const long long positions = (long long)B * Oh * Ow;
  // A patch plan names tile 5 for both roles, and only for a
  // non-overlapping conv whose patches lie in both frames.
  const bool patch = tile == kPatchTile;
  const bool tiles_ok = patch
      ? dw_tile == kPatchTile && non_overlapping(a.gx) &&
            Oh * Kh <= Nh && Ow * Kw <= Nw && Oh * Kh <= Nh_x &&
            Ow * Kw <= Nw_x
      : gather_tile_ok(tile) && dw_tile_ok(dw_tile);
  if (!tiles_ok || Cin < 1 || Cout < 1 ||
      !fits_int((long long)B * Nh_x * Nw_x * Cin) ||
      !fits_int((long long)B * Nh * Nw * Cin) ||
      !fits_int(positions * Cout) || !fits_int((long long)Kh * Kw * Cin * Cout))
    return (int)cudaErrorInvalidValue;
  a.cot = make_masked<E>(dy, y, act, slope, has_scale ? scale : 1.0f);
  a.mask_only = make_masked<E>(dy, y, act, slope, 1.0f);
  a.x = static_cast<const E*>(x);
  a.w = static_cast<const E*>(w);
  a.dx = static_cast<E*>(dx);
  a.dw = static_cast<E*>(dw);
  a.db = static_cast<E*>(db);
  int bm, bn;
  tile_extent(dw_tile, &bm, &bn);
  const long long n_dw =
      (patch ? (long long)patch_m_tiles(Kh, Kw * Cin, bm)
             : (long long)((Kh * Kw * Cin + bm - 1) / bm)) *
      ((Cout + bn - 1) / bn);
  const int ct = Cout < kGemmThreads ? Cout : kGemmThreads;
  const long long n_db = db != nullptr ? (Cout + ct - 1) / ct : 0;
  tile_extent(tile, &bm, &bn);
  const long long n_dx = patch ? patch_dx_tiles(a.gdx, bm, bn)
                               : dx_tile_count(a.gdx, a.t, bm, bn);
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
  if (patch && (y == nullptr || act == ACT_NONE) &&
      (!has_scale || scale == 1.0f))
    return (int)launch_roles<conv_backward_patch_kernel<E, true>>(
        blocks, patch_smem_floats<E, PlainT<E>>(), a, s);
  if (patch)
    return (int)launch_roles<conv_backward_patch_kernel<E, false>>(
        blocks, patch_smem_floats<E, MaskedT<E>>(), a, s);
  return (int)with_tile(tile, [&](auto td) {
    return with_dw_tile(dw_tile, [&](auto tw) {
      using TD = decltype(td);
      using TW = decltype(tw);
      constexpr int floats = cmax(
          cmax(dw_smem_floats<TW, PlainT<E>, MaskedT<E>>(),
               dx_smem_floats<TD, MaskedT<E>>()),
          kSumSmemFloats);
      return launch_roles<conv_backward_kernel<TD, TW, E>>(blocks, floats, a,
                                                           s);
    });
  });
}

// x (B,Nh_x,Nw_x,Cin), dy and y (B,Oh,Ow,Cout), w (Kh,Kw,Cin,Cout) ->
// dx (B,Nh,Nw,Cin), dw (Kh,Kw,Cin,Cout), db (Cout,); all fp32 (_f32) or
// all bf16 (_bf16), contiguous.  y == nullptr means no activation; db ==
// nullptr means no bias (its role is not launched).  (Nh, Nw) is the dx
// frame, n_out; the tap-phase bookkeeping comes from ConvSpec on the
// host; the tiles (ids: 5 for both, the patch roles of a non-overlapping
// conv), splits and dW chunk from the plan, with a
// workspace of ws_floats floats and n_tickets ints that are 0 (and are 0
// again after the launch).  Returns the launch's CUDA error
// (cudaErrorInvalidValue for a plan, a workspace or a size it cannot
// take).
extern "C" int conv_backward_f32(BWD_PARAMS) {
  return conv_backward<float>(BWD_ARGS);
}

extern "C" int conv_backward_bf16(BWD_PARAMS) {
  return conv_backward<__nv_bfloat16>(BWD_ARGS);
}
