// Predicated implicit-GEMM transposed convolution, any (stride S,
// dilation D), fp32.
//
// Replaces repro/kernels/implicit_gemm.py::tconv_implicit_gemm_pallas
// (body _ig_kernel).  Same function as tconv_phase.cu -- the input
// gradient of the forward conv with filter W (Kh,Kw,Cin,Cout) -- written
// as one flat GEMM over the full (Fh, Fw) transposed frame, all Kh*Kw
// taps, where lane (site r, tap kx) is in bound iff
//   h = r - kx*D,  h >= 0  and  h % S == 0  and  h / S < Oh
// (SNIPPETS.md Snippet 1's in_bound).  The TPU zero-interleaved dy in VMEM
// to realize this predicate; here it is an address predicate on the dy
// load, so dy is read as it lies and no zero is stored anywhere.  h >= 0
// is tested before dividing: C's `/` and `%` truncate toward zero, so
// h = -2 would pass `h % 2 == 0` and read row -1.
//
// Design.  One thread per output site (b, y, x, ci), ci fastest, looping
// over all Kh*Kw taps with the predicate and, for the taps in bound, over
// Cout into one fp32 register -- the Pallas kernel's sequential
// (Cout-tile, tap) grid axes.  The store is already cropped by the
// padding.  Sites beyond the full frame (non-exact n_out tails) are
// reached by no tap and take ep(0) = act(bias), as implicit_gemm.py:245-260
// fills them.
//
// Bound.  On the generator's last layer (K=4, S=2, Cin=3, Cout=32) the
// useful work is tiny (0.39 M MACs per image); neighbouring threads of a
// warp sit in different stride residues, so their tap predicates diverge
// and the warp walks the union of their tap sets: latency and divergence,
// not bytes or FLOPs, bound this form.
#include <cuda_runtime.h>

#include "common.cuh"

__global__ void tconv_implicit_gemm_kernel(
    const float* __restrict__ dy, const float* __restrict__ w,
    float* __restrict__ dx, int B, int Oh, int Ow, int Cout, int Kh, int Kw,
    int Cin, int Nh, int Nw, int sh, int sw, int ph, int pw, int dh, int dw,
    int Fh, int Fw, EpilogueArgs ep) {
  const long long total = (long long)B * Nh * Nw * Cin;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int ci = (int)(idx % Cin);
  long long t = idx / Cin;
  const int x = (int)(t % Nw);
  t /= Nw;
  const int y = (int)(t % Nh);
  const int b = (int)(t / Nh);
  const int r = y + ph, s = x + pw;  // site in the full (Fh, Fw) frame

  float acc = 0.0f;
  if (r < Fh && s < Fw) {
    for (int kx = 0; kx < Kh; ++kx) {
      const int h = r - kx * dh;
      if (h < 0 || h % sh != 0) continue;
      const int i = h / sh;
      if (i >= Oh) continue;
      for (int ky = 0; ky < Kw; ++ky) {
        const int g = s - ky * dw;
        if (g < 0 || g % sw != 0) continue;
        const int j = g / sw;
        if (j >= Ow) continue;
        const float* dyp = dy + (((long long)b * Oh + i) * Ow + j) * Cout;
        const float* wp = w + ((long long)(kx * Kw + ky) * Cin + ci) * Cout;
        for (int co = 0; co < Cout; ++co) acc = fmaf(dyp[co], wp[co], acc);
      }
    }
  }
  dx[idx] = apply_epilogue(acc, ci, ep);
}

// dy (B,Oh,Ow,Cout), w (Kh,Kw,Cin,Cout), bias (Cin,) or null ->
// dx (B,Nh,Nw,Cin); all fp32, contiguous.  Returns cudaGetLastError()
// after the launch.
extern "C" int tconv_implicit_gemm_f32(const void* dy, const void* w,
                                       const void* bias, void* dx, int B,
                                       int Oh, int Ow, int Cout, int Kh,
                                       int Kw, int Cin, int Nh, int Nw,
                                       int sh, int sw, int ph, int pw,
                                       int dh, int dw, int act, float slope,
                                       int has_scale, float scale,
                                       void* stream) {
  const int Fh = sh * (Oh - 1) + dh * (Kh - 1) + 1;
  const int Fw = sw * (Ow - 1) + dw * (Kw - 1) + 1;
  const long long total = (long long)B * Nh * Nw * Cin;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0) {
    tconv_implicit_gemm_kernel<<<(unsigned)blocks, threads, 0,
                                 (cudaStream_t)stream>>>(
        (const float*)dy, (const float*)w, (float*)dx, B, Oh, Ow, Cout, Kh,
        Kw, Cin, Nh, Nw, sh, sw, ph, pw, dh, dw, Fh, Fw,
        make_epilogue(bias, act, slope, has_scale, scale));
  }
  return (int)cudaGetLastError();
}
