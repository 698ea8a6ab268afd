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

__global__ void tconv_phase_kernel(const float* __restrict__ dy,
                                   const float* __restrict__ w,
                                   float* __restrict__ dx, int Oh, int Ow,
                                   int Cout, int Kh, int Kw, int Cin, int Nh,
                                   int Nw, int sh, int sw, int ph, int pw,
                                   int dh, int dw, int per_h, int per_w,
                                   int step_h, int step_w, int KP, int KQ,
                                   int TPh, int TPw, int Mh, int Mw,
                                   EpilogueArgs ep) {
  const int p = blockIdx.y / sw, q = blockIdx.y % sw;  // residue class
  const int b = blockIdx.z;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)Mh * Mw * Cin) return;
  const int ci = (int)(e % Cin);
  const int n = (int)((e / Cin) % Mw);
  const int m = (int)(e / ((long long)Cin * Mw));
  const int y = m * sh + p - ph;  // dx position of phase element (m, n)
  const int x = n * sw + q - pw;
  if (y < 0 || y >= Nh || x < 0 || x >= Nw) return;

  // Tap phase whose residue is (p, q); -1 when no tap reaches it.
  int a = -1, c = -1;
  for (int t = 0; t < TPh; ++t)
    if ((t * dh) % sh == p) a = t;
  for (int t = 0; t < TPw; ++t)
    if ((t * dw) % sw == q) c = t;

  float acc = 0.0f;
  if (a >= 0 && c >= 0) {
    const int base_h = (a * dh) / sh, base_w = (c * dw) / sw;
    for (int uf = 0; uf < KP; ++uf) {
      const int u = KP - 1 - uf;  // flipped slot: tap kx = a + u*period
      const int kx = a + u * per_h;
      if (kx >= Kh) continue;     // padding slot of a ragged phase
      const int i = m - base_h - u * step_h;
      if (i < 0 || i >= Oh) continue;
      for (int vf = 0; vf < KQ; ++vf) {
        const int v = KQ - 1 - vf;
        const int ky = c + v * per_w;
        if (ky >= Kw) continue;
        const int j = n - base_w - v * step_w;
        if (j < 0 || j >= Ow) continue;
        const float* dyp = dy + (((long long)b * Oh + i) * Ow + j) * Cout;
        const float* wp = w + ((long long)(kx * Kw + ky) * Cin + ci) * Cout;
        for (int co = 0; co < Cout; ++co) acc = fmaf(dyp[co], wp[co], acc);
      }
    }
  }
  dx[(((long long)b * Nh + y) * Nw + x) * Cin + ci] =
      apply_epilogue(acc, ci, ep);
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
  // Phase-plane rows m with y = m*S + p - P < Nh, for the widest class.
  const int Mh = (Nh + ph + sh - 1) / sh;
  const int Mw = (Nw + pw + sw - 1) / sw;
  const long long per_class = (long long)Mh * Mw * Cin;
  const int threads = 256;
  const long long tiles = (per_class + threads - 1) / threads;
  if (tiles > 0 && B > 0) {
    dim3 grid((unsigned)tiles, (unsigned)(sh * sw), (unsigned)B);
    tconv_phase_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const float*)dy, (const float*)w, (float*)dx, Oh, Ow, Cout, Kh, Kw,
        Cin, Nh, Nw, sh, sw, ph, pw, dh, dw, per_h, per_w, step_h, step_w,
        KP, KQ, TPh, TPw, Mh, Mw,
        make_epilogue(bias, act, slope, has_scale, scale));
  }
  return (int)cudaGetLastError();
}
