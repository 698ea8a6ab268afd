// Zero-free transposed convolution by residue class (phase), any
// (stride S, dilation D), fp32 or bf16 (tconv_phase_f32 /
// tconv_phase_bf16: bf16 operands and output, fp32 sums, one rounding at
// the store -- conv_body.cuh's element types).
//
// Replaces repro/kernels/tconv_phase.py::tconv_fused_pallas (body
// _fused_tap_kernel, host helpers pack_phase_filters and
// assemble_phase_major).  It computes the input gradient of the forward
// conv with filter W (Kh,Kw,Cin,Cout):
//   dx[r - P] = ep( sum over taps kx with r = i*S + kx*D of dy[i] . W[kx]^T )
// Tap kx lands in output residue (kx*D) mod S; residues repeat with
// period S/gcd(S,D), so tap phase `a` (a < min(K, period)) holds taps
// kx = a + u*period, which land on phase rows m = i + (a*D)//S +
// u*(D/gcd).  Each residue class is therefore a stride-1 correlation of dy
// with that class's own taps, and no stride zero or dilation zero is ever
// multiplied.
//
// Design.  The dx role of the tiled implicit-GEMM engine
// (conv_body.cuh::dx_tile), launched alone: per residue class (p, q) a
// GEMM of the class's (B, Hc, Wc) rows x Cin over (tap slot, Cout), in
// the plan's tiles (128 x 32; 256 x 4 at Cin <= 4, 256 x 16 at Cin <=
// 16) with register micro-tiles, fed by a 3-stage cp.async ring of
// 16-deep slabs read along Cout (a warp's lanes read consecutive floats
// of dy and of W).  The
// Pallas kernel's sequential (Cout-tile, tap) grid axes become the
// reduction axis of the tile; when the tiles alone would not fill the
// card, the plan (kernels/dconv_backward.py::plan) splits it over several
// CTAs whose partial tiles are added in split order by the last of them
// (no atomics: the same bits on every run).  Each element is stored
// straight to its stride-residue position r = m*S + p in dx, already
// cropped by the padding, so assemble_phase_major's interleave and crop
// are folded into the store, and the epilogue act(scale * v + bias[ci])
// is applied there, to the final sum.  Positions no tap reaches --
// residues with no tap phase (period > K) and non-exact n_out tails
// beyond the full frame -- are rows of the GEMM like any other with an
// empty sum, so they store ep(0) = act(bias), the assembly's fill.
//
// Bound.  On the generator layers (K=4, S=2, Cout=128/64) each dx element
// does 4*Cout MACs; the unique bytes (dy, W, dx) are a few MB, so the
// useful arithmetic (2-5 microseconds at B = 64) bounds the launch.
// The tiles reuse each dy element 32 times and each W element 128 times
// from shared memory and 4 times from registers.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "conv_body.cuh"

template <class E>
struct PhaseArgs {
  PlainT<E> dy;
  const E* w;
  E* dx;
  ConvGeom g;   // the dx frame (n_out)
  PhaseGeom t;
  GeomDiv fd;
  RoleGrid grid;
  FusedEpilogueT<E> ep;
};

template <class T, class E>
__global__ void __launch_bounds__(kGemmThreads)
    tconv_phase_kernel(const PhaseArgs<E> a) {
  extern __shared__ __align__(16) float smem[];
  int tile;
  Split sp;
  role_of<1, T::BM * T::BN>(a.grid, &tile, &sp);
  dx_tile<T>(a.dy, a.w, a.dx, a.g, a.t, a.fd, tile, sp, smem, a.ep);
}

#define PHASE_PARAMS                                                         \
  const void *dy, const void *w, const void *bias, void *dx, int B, int Oh, \
      int Ow, int Cout, int Kh, int Kw, int Cin, int Nh, int Nw, int sh,   \
      int sw, int ph, int pw, int dh, int dw, int per_h, int per_w,        \
      int step_h, int step_w, int TPh, int TPw, int act, float slope,      \
      int has_scale, float scale, int tile, int splits, void *ws,          \
      int64_t ws_floats, void *tickets, int n_tickets, void *stream
#define PHASE_ARGS                                                           \
  dy, w, bias, dx, B, Oh, Ow, Cout, Kh, Kw, Cin, Nh, Nw, sh, sw, ph, pw,    \
      dh, dw, per_h, per_w, step_h, step_w, TPh, TPw, act, slope,           \
      has_scale, scale, tile, splits, ws, ws_floats, tickets, n_tickets,    \
      stream

template <class E>
static int tconv_phase(PHASE_PARAMS) {
  PhaseArgs<E> a;
  a.g = make_geom(B, Nh, Nw, Cin, Oh, Ow, Cout, Kh, Kw, sh, sw, ph, pw, dh,
                  dw);
  a.t = make_phase_geom(per_h, per_w, step_h, step_w, TPh, TPw);
  a.fd = make_geom_div(a.g);
  if (!forward_tile_ok(tile) || Cin < 1 || Cout < 1 ||
      !fits_int((long long)B * Nh * Nw * Cin) ||
      !fits_int((long long)B * Oh * Ow * Cout) ||
      !fits_int((long long)Kh * Kw * Cin * Cout))
    return (int)cudaErrorInvalidValue;
  a.dy = PlainT<E>{static_cast<const E*>(dy)};
  a.w = static_cast<const E*>(w);
  a.dx = static_cast<E*>(dx);
  a.ep = FusedEpilogueT<E>{
      make_epilogue<E>(bias, act, slope, has_scale, scale)};
  int bm, bn;
  tile_extent(tile, &bm, &bn);
  if (!gather_grid(&a.grid, dx_tile_count(a.g, a.t, bm, bn), bm * bn,
                   splits, ws, ws_floats, tickets, n_tickets))
    return (int)cudaErrorInvalidValue;
  const long long blocks = role_grid_blocks(a.grid);
  if (blocks == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_forward_tile(tile, [&](auto td) {
    using T = decltype(td);
    return launch_roles<tconv_phase_kernel<T, E>>(
        blocks, dx_smem_floats<T, PlainT<E>>(), a, s);
  });
}

// dy (B,Oh,Ow,Cout), w (Kh,Kw,Cin,Cout), bias (Cin,) or null ->
// dx (B,Nh,Nw,Cin); all fp32 (_f32) or all bf16 (_bf16), contiguous.
// The tap-phase bookkeeping (period, step, TPh/TPw) comes from ConvSpec
// on the host; the tile (id) and splits from the plan, with a workspace
// of ws_floats floats and n_tickets ints that are 0 (and are 0 again
// after the launch).  Returns the launch's CUDA error
// (cudaErrorInvalidValue for a plan, a workspace or a size it cannot
// take).
extern "C" int tconv_phase_f32(PHASE_PARAMS) {
  return tconv_phase<float>(PHASE_ARGS);
}

extern "C" int tconv_phase_bf16(PHASE_PARAMS) {
  return tconv_phase<__nv_bfloat16>(PHASE_ARGS);
}
