// Device bodies shared by the conv kernels of this directory, so each
// piece of index arithmetic exists once:
//
//   direct_conv_element  one output of the direct / dilated conv
//                        (dconv_forward.cu; the ddy role of
//                        tconv_backward.cu),
//   phase_element        one output of the zero-free transposed conv by
//                        residue class (tconv_phase.cu; the dx role of
//                        conv_backward.cu),
//   filter_grad_tile     32 filter-gradient elements, one CTA
//                        (dconv_filtergrad.cu; the dW role of both fused
//                        backwards),
//   channel_sum_tile     32 bias-gradient channels, one CTA (the db role
//                        of both fused backwards).
//
// Operands are read through small reader structs: `Plain` reads a tensor
// as it lies; `Masked` forms v * act'(y) * scale at each load, so a
// masked cotangent is never written to device memory (the Pallas
// backwards kept it in VMEM the same way).
//
// The two reductions are deterministic: no atomics.  A CTA of
// kSlices x kLanes threads owns kLanes outputs; warp s sums its share of
// the positions (every kSlices-th row) in a fixed loop, and a
// shared-memory tree of fixed shape adds the kSlices partials.  The same
// inputs give the same bits.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

// Geometry of one direct conv x (B,Nh,Nw,Cin) * W (Kh,Kw,Cin,Cout) ->
// y (B,Oh,Ow,Cout); its transposed conv maps a (B,Oh,Ow,Cout) tensor back
// to the (B,Nh,Nw,Cin) frame.
struct ConvGeom {
  int B, Nh, Nw, Cin;
  int Oh, Ow, Cout;
  int Kh, Kw;
  int sh, sw, ph, pw, dh, dw;
};

// Tap-phase bookkeeping of the transposed conv (ConvSpec on the host):
// period S/gcd(S,D), step D/gcd(S,D), taps per phase KP x KQ, non-empty
// tap phases TPh x TPw, and the phase-plane extent Mh x Mw that covers
// the (Nh, Nw) frame.
struct PhaseGeom {
  int per_h, per_w, step_h, step_w, KP, KQ, TPh, TPw, Mh, Mw;
};

static inline ConvGeom make_geom(int B, int Nh, int Nw, int Cin, int Oh,
                                 int Ow, int Cout, int Kh, int Kw, int sh,
                                 int sw, int ph, int pw, int dh, int dw) {
  ConvGeom g;
  g.B = B; g.Nh = Nh; g.Nw = Nw; g.Cin = Cin;
  g.Oh = Oh; g.Ow = Ow; g.Cout = Cout;
  g.Kh = Kh; g.Kw = Kw;
  g.sh = sh; g.sw = sw; g.ph = ph; g.pw = pw; g.dh = dh; g.dw = dw;
  return g;
}

static inline PhaseGeom make_phase_geom(const ConvGeom& g, int per_h,
                                        int per_w, int step_h, int step_w,
                                        int KP, int KQ, int TPh, int TPw) {
  PhaseGeom t;
  t.per_h = per_h; t.per_w = per_w; t.step_h = step_h; t.step_w = step_w;
  t.KP = KP; t.KQ = KQ; t.TPh = TPh; t.TPw = TPw;
  // Phase-plane rows m with y = m*S + p - P < Nh, for the widest class.
  t.Mh = (g.Nh + g.ph + g.sh - 1) / g.sh;
  t.Mw = (g.Nw + g.pw + g.sw - 1) / g.sw;
  return t;
}

struct Plain {
  const float* v;
  __device__ __forceinline__ float operator()(long long i) const {
    return __ldg(v + i);
  }
};

// v * act'(y) * scale, in Epilogue.mask_cotangent's order, where act' is
// read from the activation OUTPUT y (Epilogue.grad_factor): relu
// y > 0 ? 1 : 0, leaky_relu y > 0 ? 1 : slope, tanh 1 - y^2.  The factor
// is formed with selects, not branches, so the loads of an unrolled loop
// stay independent and in flight together.  With no activation y points
// at v and the factor is y > 0 ? 1 : 1; scale 1 means none.
struct Masked {
  const float* v;
  const float* y;
  float below;   // act' where y <= 0 (relu 0, leaky_relu slope, none 1)
  int is_tanh;
  float scale;
  __device__ __forceinline__ float operator()(long long i) const {
    const float f = __ldg(v + i), out = __ldg(y + i);
    const float g = is_tanh ? 1.0f - out * out : (out > 0.0f ? 1.0f : below);
    return f * g * scale;
  }
};

static inline Masked make_masked(const void* v, const void* y, int act,
                                 float slope, float scale) {
  Masked m;
  const bool has_y = y != nullptr && act != ACT_NONE;
  m.v = static_cast<const float*>(v);
  m.y = static_cast<const float*>(has_y ? y : v);
  m.below = !has_y ? 1.0f : act == ACT_RELU ? 0.0f
            : act == ACT_LEAKY_RELU ? slope : 1.0f;
  m.is_tanh = has_y && act == ACT_TANH;
  m.scale = scale;
  return m;
}

// y[idx] of the direct conv before any epilogue, idx flat over
// (B, Oh, Ow, Cout), co fastest:
//   sum_{kx,ky,ci} x[b, i*S+kx*D-P, j*S+ky*D-P, ci] * W[kx,ky,ci,co]
// over the K*K real taps only (the D-dilated filter is never formed).
// Padding is a bounds predicate on the x load.
template <class X>
__device__ __forceinline__ float direct_conv_element(
    const X& x, const float* __restrict__ w, const ConvGeom& g,
    long long idx) {
  const int co = (int)(idx % g.Cout);
  long long t = idx / g.Cout;
  const int j = (int)(t % g.Ow);
  t /= g.Ow;
  const int i = (int)(t % g.Oh);
  const int b = (int)(t / g.Oh);
  float acc = 0.0f;
  for (int kx = 0; kx < g.Kh; ++kx) {
    const int h = i * g.sh + kx * g.dh - g.ph;
    if (h < 0 || h >= g.Nh) continue;  // padding row: contributes zero
    for (int ky = 0; ky < g.Kw; ++ky) {
      const int c = j * g.sw + ky * g.dw - g.pw;
      if (c < 0 || c >= g.Nw) continue;
      const long long xp = (((long long)b * g.Nh + h) * g.Nw + c) * g.Cin;
      const float* wp = w + (long long)(kx * g.Kw + ky) * g.Cin * g.Cout + co;
      for (int ci = 0; ci < g.Cin; ++ci)
        acc = fmaf(x(xp + ci), wp[(long long)ci * g.Cout], acc);
    }
  }
  return acc;
}

// Element e = (m, n, ci) of residue class (p, q) of batch row b of the
// transposed conv dx = tconv(dy, W), before any epilogue.  Returns false
// when the element lies outside the (Nh, Nw) frame; otherwise sets *out
// to its flat dx index, *ci_out to its channel and *acc_out to its sum.
//
// Tap kx lands in output residue (kx*D) mod S; residues repeat with period
// S/gcd(S,D), so tap phase `a` holds taps kx = a + u*period, which land
// on phase rows m = i + (a*D)//S + u*(D/gcd).  The slot -> tap map
// kx = a + (KP-1-uf)*period is pack_phase_filters' (padding slots,
// kx >= K, are skipped).  Residues no tap reaches keep an empty sum.
template <class DY>
__device__ __forceinline__ bool phase_element(
    const DY& dy, const float* __restrict__ w, const ConvGeom& g,
    const PhaseGeom& t, int b, int p, int q, long long e, long long* out,
    int* ci_out, float* acc_out) {
  const int ci = (int)(e % g.Cin);
  const int n = (int)((e / g.Cin) % t.Mw);
  const int m = (int)(e / ((long long)g.Cin * t.Mw));
  const int y = m * g.sh + p - g.ph;  // dx position of phase element (m, n)
  const int x = n * g.sw + q - g.pw;
  if (y < 0 || y >= g.Nh || x < 0 || x >= g.Nw) return false;

  // Tap phase whose residue is (p, q); -1 when no tap reaches it.
  int a = -1, c = -1;
  for (int s = 0; s < t.TPh; ++s)
    if ((s * g.dh) % g.sh == p) a = s;
  for (int s = 0; s < t.TPw; ++s)
    if ((s * g.dw) % g.sw == q) c = s;

  float acc = 0.0f;
  if (a >= 0 && c >= 0) {
    const int base_h = (a * g.dh) / g.sh, base_w = (c * g.dw) / g.sw;
    for (int uf = 0; uf < t.KP; ++uf) {
      const int u = t.KP - 1 - uf;  // flipped slot: tap kx = a + u*period
      const int kx = a + u * t.per_h;
      if (kx >= g.Kh) continue;     // padding slot of a ragged phase
      const int i = m - base_h - u * t.step_h;
      if (i < 0 || i >= g.Oh) continue;
      for (int vf = 0; vf < t.KQ; ++vf) {
        const int v = t.KQ - 1 - vf;
        const int ky = c + v * t.per_w;
        if (ky >= g.Kw) continue;
        const int j = n - base_w - v * t.step_w;
        if (j < 0 || j >= g.Ow) continue;
        const long long dyp = (((long long)b * g.Oh + i) * g.Ow + j) * g.Cout;
        const float* wp = w + ((long long)(kx * g.Kw + ky) * g.Cin + ci) * g.Cout;
        for (int co = 0; co < g.Cout; ++co)
          acc = fmaf(dy(dyp + co), wp[co], acc);
      }
    }
  }
  *out = (((long long)b * g.Nh + y) * g.Nw + x) * g.Cin + ci;
  *ci_out = ci;
  *acc_out = acc;
  return true;
}

constexpr int kLanes = 32;   // outputs of one reduction CTA, one per lane
constexpr int kSlices = 8;   // warps splitting each output's sum
constexpr int kRoleThreads = kLanes * kSlices;

// Adds the kSlices warps' partials lane by lane in a tree of fixed shape;
// every thread gets its lane's total.  Every thread of the CTA must call
// it, once.
__device__ __forceinline__ float slice_tree(float partial) {
  __shared__ float part[kSlices][kLanes];
  const int lane = threadIdx.x % kLanes, s = threadIdx.x / kLanes;
  part[s][lane] = partial;
  __syncthreads();
  for (int h = kSlices / 2; h > 0; h /= 2) {
    if (s < h) part[s][lane] += part[s + h][lane];
    __syncthreads();
  }
  return part[0][lane];
}

// dW[kx,ky,ci,co] = sum_{b,i,j} x[b, i*S+kx*D-P, j*S+ky*D-P, ci]
//                               * dy[b,i,j,co]
// for tile = ((kx*Kw + ky)*Cin + ci)*ceil(Cout/32) + co/32: lane l owns
// co = 32*(tile % ceil(Cout/32)) + l.  Warp s walks the output rows
// (b, i) = s, s + 8, ...; a row whose input row h lies in the padding is
// skipped whole, and within a row j runs over the columns whose input
// column is in the image, with no division in the loop, so the unrolled
// loads of several j are in flight together.  Each warp's dy loads are
// one contiguous 128-byte row, its x load one broadcast value.  x and dy
// are the (B,Nh,Nw,Cin) and (B,Oh,Ow,Cout) operands of g.
template <class X, class DY>
__device__ __forceinline__ void filter_grad_tile(
    const X& x, const DY& dy, float* __restrict__ dw, const ConvGeom& g,
    long long tile) {
  const int co_tiles = (g.Cout + kLanes - 1) / kLanes;
  const int co = (int)(tile % co_tiles) * kLanes + threadIdx.x % kLanes;
  long long t = tile / co_tiles;
  const int ci = (int)(t % g.Cin);
  t /= g.Cin;
  const int ky = (int)(t % g.Kw);
  const int kx = (int)(t / g.Kw);
  // Input column c = j*S + off; the j with 0 <= c < Nw are [jlo, jhi).
  const int off = ky * g.dw - g.pw;
  const int jlo = off >= 0 ? 0 : (g.sw - 1 - off) / g.sw;
  const int top = g.Nw - 1 - off;
  const int jhi = top < 0 ? 0 : min(g.Ow, top / g.sw + 1);
  float acc = 0.0f;
  if (co < g.Cout) {
    for (int bi = threadIdx.x / kLanes; bi < g.B * g.Oh; bi += kSlices) {
      const int h = (bi % g.Oh) * g.sh + kx * g.dh - g.ph;
      if (h < 0 || h >= g.Nh) continue;  // padding row: contributes zero
      const long long xrow =
          ((long long)(bi / g.Oh) * g.Nh + h) * g.Nw + off;
      const long long dyrow = (long long)bi * g.Ow;
#pragma unroll 4
      for (int j = jlo; j < jhi; ++j)
        acc = fmaf(x((xrow + (long long)j * g.sw) * g.Cin + ci),
                   dy((dyrow + j) * g.Cout + co), acc);
    }
  }
  acc = slice_tree(acc);
  if (threadIdx.x < kLanes && co < g.Cout)
    dw[((long long)(kx * g.Kw + ky) * g.Cin + ci) * g.Cout + co] = acc;
}

// out[c] = sum over the n rows of an (n, C) operand v, for the 32
// channels c = 32*tile + lane.
template <class V>
__device__ __forceinline__ void channel_sum_tile(const V& v,
                                                 float* __restrict__ out,
                                                 int n, int C, int tile) {
  const int c = tile * kLanes + threadIdx.x % kLanes;
  float acc = 0.0f;
  if (c < C) {
#pragma unroll 4
    for (int r = threadIdx.x / kLanes; r < n; r += kSlices)
      acc += v((long long)r * C + c);
  }
  acc = slice_tree(acc);
  if (threadIdx.x < kLanes && c < C) out[c] = acc;
}
