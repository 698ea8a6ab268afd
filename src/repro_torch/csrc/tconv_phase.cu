// Zero-free transposed convolution by residue class (phase), any
// (stride S, dilation D), fp32.
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
// Design.  Block (x, y, z) = (tile of the class's output plane x Cin,
// residue class (p, q) of the stride, batch row).  Each block owns ONE
// residue class, so every thread of the block runs the same tap loop: only
// that class's KP x KQ packed slots, with the slot -> tap map
// kx = a + (KP-1-uf)*period of pack_phase_filters (tconv_phase.py:221) and
// padding slots (kx >= K) skipped -- there are no predicated lanes.
// One thread per output element (m, n, ci), with an fp32 accumulator in a
// register over (slot, Cout); the Pallas kernel's sequential (Cout-tile,
// tap) grid axes become those loops.  Each element is stored straight to
// its stride-residue position r = m*S + p in dx, already cropped by the
// padding, so assemble_phase_major's interleave and crop are folded into
// the store.  Positions no tap reaches -- residues with no tap phase
// (period > K) and non-exact n_out tails beyond the full frame -- keep an
// empty sum and take ep(0) = act(bias), the assembly's fill.
//
// Bound.  On the generator layers (K=4, S=2, Cout=128/64) each output
// element does 4*Cout MACs from W rows read many times over through L1/L2:
// the arithmetic, not the unique bytes, bounds this simple form.
#include <cuda_runtime.h>

#include "common.cuh"
#include "conv_body.cuh"

// The element body (slot -> tap map, bounds, Cout loop) is
// conv_body.cuh::phase_element, shared with the dx role of
// conv_backward.cu.
__global__ void tconv_phase_kernel(const float* __restrict__ dy,
                                   const float* __restrict__ w,
                                   float* __restrict__ dx, ConvGeom g,
                                   PhaseGeom t, EpilogueArgs ep) {
  const int p = blockIdx.y / g.sw, q = blockIdx.y % g.sw;  // residue class
  const int b = blockIdx.z;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)t.Mh * t.Mw * g.Cin) return;
  long long out;
  int ci;
  float acc;
  if (phase_element(Plain{dy}, w, g, t, b, p, q, e, &out, &ci, &acc))
    dx[out] = apply_epilogue(acc, ci, ep);
}

// dy (B,Oh,Ow,Cout), w (Kh,Kw,Cin,Cout), bias (Cin,) or null ->
// dx (B,Nh,Nw,Cin); all fp32, contiguous.  The tap-phase bookkeeping
// (period, step, KP/KQ, TPh/TPw) comes from ConvSpec on the host.
// Returns cudaGetLastError() after the launch.
extern "C" int tconv_phase_f32(const void* dy, const void* w,
                               const void* bias, void* dx, int B, int Oh,
                               int Ow, int Cout, int Kh, int Kw, int Cin,
                               int Nh, int Nw, int sh, int sw, int ph,
                               int pw, int dh, int dw, int per_h, int per_w,
                               int step_h, int step_w, int KP, int KQ,
                               int TPh, int TPw, int act, float slope,
                               int has_scale, float scale, void* stream) {
  const ConvGeom g = make_geom(B, Nh, Nw, Cin, Oh, Ow, Cout, Kh, Kw, sh, sw,
                               ph, pw, dh, dw);
  const PhaseGeom t = make_phase_geom(g, per_h, per_w, step_h, step_w, KP,
                                      KQ, TPh, TPw);
  const long long per_class = (long long)t.Mh * t.Mw * Cin;
  const int threads = 256;
  const long long tiles = (per_class + threads - 1) / threads;
  if (tiles > 0 && B > 0) {
    dim3 grid((unsigned)tiles, (unsigned)(sh * sw), (unsigned)B);
    tconv_phase_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const float*)dy, (const float*)w, (float*)dx, g, t,
        make_epilogue(bias, act, slope, has_scale, scale));
  }
  return (int)cudaGetLastError();
}
