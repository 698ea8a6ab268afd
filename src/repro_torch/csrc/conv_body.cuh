// The tiled implicit-GEMM engine shared by every conv kernel of this
// directory but implicit_gemm.cu, so each piece of index arithmetic exists
// once.  Its roles:
//     dx_tile            a tile of dx = tconv(dy, W) in one residue class:
//                        conv_backward.cu's dx and tconv_phase.cu,
//     ddy_tile           a tile of conv(g, W): tconv_backward.cu's ddy and
//                        dconv_forward.cu,
//     dw_tile            a tile of dW (the backwards, dconv_filtergrad.cu),
//     channel_sum        the bias gradient,
//     patch_dx_tile,     conv_backward.cu's dx and dW of a non-overlapping
//     patch_dw_tile      conv (S = K, P = 0, D = 1): two GEMMs over the
//                        patch matrix,
//   each with its reduction split over several CTAs whose partials are
//   added in split order (split_finish).  The forwards apply their
//   epilogue in the gather role's store, to the final sum.
//
// Operands are read through small reader structs: `Plain` reads a tensor
// as it lies; `Masked` forms v * act'(y) * scale at each load, so a
// masked cotangent is never written to device memory (the Pallas
// backwards kept it in VMEM the same way).
//
// Element types.  Each reader, and so each role, is templated on the
// element type E of the launch's operands and outputs: float, or
// __nv_bfloat16 (every operand of one launch shares it, as in repro).
// Shared memory, the register micro-tiles and the split workspace stay
// fp32 whatever E is: a bf16 element is widened (exactly) as it enters
// its stage, every sum runs in fp32, and each output is rounded to E
// once, in its final store (store_f32) -- where repro's kernels cast
// their fp32 accumulators back to the operand dtype.  A bias is read
// through the epilogue in E.  A masked bf16 cotangent is formed in fp32
// from the widened v and y (act'(y) * v * scale, one fp32 value per
// element), not rounded to bf16 first as repro's dy * act'(y) is: the
// plain versions form it the same way, so kernel and plain version round
// once each from fp32 sums that differ only in order (one bf16 ulp),
// and both stay within repro's 5e-2.
//
// Every sum runs in a fixed order and no output is written by atomics, so
// the same inputs give the same bits.
#pragma once

#include <cstdint>
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
// period S/gcd(S,D), step D/gcd(S,D) and the non-empty tap phases
// TPh x TPw.
struct PhaseGeom {
  int per_h, per_w, step_h, step_w, TPh, TPw;
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

static inline PhaseGeom make_phase_geom(int per_h, int per_w, int step_h,
                                        int step_w, int TPh, int TPw) {
  PhaseGeom t;
  t.per_h = per_h; t.per_w = per_w; t.step_h = step_h; t.step_w = step_w;
  t.TPh = TPh; t.TPw = TPw;
  return t;
}

template <class E>
struct PlainT {
  using Elem = E;
  static constexpr bool kMasked = false;
  static constexpr int kPlanes = 1;   // stage planes (Slab::stage_floats)
  const E* v;
  __device__ __forceinline__ float operator()(long long i) const {
    return to_f32(__ldg(v + i));
  }
};
using Plain = PlainT<float>;

// v * act'(y) * scale, in Epilogue.mask_cotangent's order, where act' is
// read from the activation OUTPUT y (Epilogue.grad_factor): relu
// y > 0 ? 1 : 0, leaky_relu y > 0 ? 1 : slope, tanh 1 - y^2.  The factor
// is formed with selects, not branches, so the loads of an unrolled loop
// stay independent and in flight together.  With no activation y points
// at v and the factor is y > 0 ? 1 : 1; scale 1 means none.
// An fp32 masked operand stages y in a second plane beside v; a bf16
// one forms the product in registers before its stage (Stager).
template <class E>
struct MaskedT {
  using Elem = E;
  static constexpr bool kMasked = true;
  static constexpr int kPlanes = sizeof(E) == 4 ? 2 : 1;
  const E* v;
  const E* y;
  float below;   // act' where y <= 0 (relu 0, leaky_relu slope, none 1)
  int is_tanh;
  float scale;
  __device__ __forceinline__ float apply(float f, float out) const {
    const float g = is_tanh ? 1.0f - out * out : (out > 0.0f ? 1.0f : below);
    return f * g * scale;
  }
  __device__ __forceinline__ float operator()(long long i) const {
    return apply(to_f32(__ldg(v + i)), to_f32(__ldg(y + i)));
  }
};
using Masked = MaskedT<float>;

template <class E = float>
static inline MaskedT<E> make_masked(const void* v, const void* y, int act,
                                     float slope, float scale) {
  MaskedT<E> m;
  const bool has_y = y != nullptr && act != ACT_NONE;
  m.v = static_cast<const E*>(v);
  m.y = static_cast<const E*>(has_y ? y : v);
  m.below = !has_y ? 1.0f : act == ACT_RELU ? 0.0f
            : act == ACT_LEAKY_RELU ? slope : 1.0f;
  m.is_tanh = has_y && act == ACT_TANH;
  m.scale = scale;
  return m;
}

// ===========================================================================
// The tiled implicit-GEMM engine.
//
// A CTA of kGemmThreads threads computes one BM x BN fp32 tile of
// C = A . B over a range of the reduction axis k.  Each thread owns a
// TM x TN register micro-tile.  A and B pass through shared memory in
// kBK-deep slabs, in a ring of kStages stages filled by cp.async: the
// copies of slab s + kStages - 1 are in flight while slab s is
// multiplied, so their latency hides behind kStages - 1 slabs of FMAs.
// A masked operand copies both v and the forward output y and forms
// v * act'(y) * scale in place, element by element, once its stage has
// landed (each thread fixes the elements it copied), so the masked
// cotangent still never reaches device memory.  A loader fetches its
// elements along the operand's contiguous channel axis, so a warp's
// lanes read consecutive addresses; padding taps, ragged edges and k
// past the range are cp.async's zero fill, so the inner loop has no
// branch.  Each role is this engine with its own two loaders (the
// "gathers" of its implicit GEMM) and its own store.
//
// bf16 operands.  cp.async copies 4, 8 or 16 bytes, never the 2 of one
// bf16 element, and a stage holds fp32.  Of the two ways to stage bf16
// -- a predicated __ldg of each element, widened and stored to the
// stage; or cp.async of channel pairs where the channel count is even
// and the offset 4-byte aligned, with a scalar path for the rest --
// the engine takes the first (Stager<..., __nv_bfloat16>): one path for
// every geometry (Cin 3, Cin 130 / Cout 37, taps straddling a pair), no
// bf16 plane in shared memory and no second fix-up pass.  Its loads keep
// the ring's overlap all the same: the loads of slab s + kStages - 1 are
// issued into registers before slab s's FMAs (fetch) and widened, masked
// and stored to their stage after them (settle), the register
// double-buffering of pre-cp.async GEMMs.  It reads half the bytes of
// fp32 from device memory and does the same fp32 FMAs.

constexpr int kGemmThreads = 256;
constexpr int kBK = 16;         // reduction depth of one slab
constexpr int kStages = 3;      // slabs in the shared-memory ring
constexpr int kMaxSplits = 64;  // CTAs one tile's reduction may take

// The tile shapes a role may take, by the id the host's plan names
// (kernels/dconv_backward.py::TILES).  A thread's TM x TN micro-tile lies
// in P x P parts of (TM / P) x (TN / P), BM / P rows and BN / P columns
// apart, so that the lanes of a warp read consecutive 16-byte words of a
// slab row (P = 2 on the 128 x 128 tile; one part, the contiguous
// micro-tile, elsewhere).
template <int BM_, int BN_, int TM_, int TN_, int P_ = 1>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, P = P_;
  static constexpr int PM = TM / P, PN = TN / P;  // one part's extent
  static constexpr int TX = BN / TN;            // threads along n
  static constexpr int AS = BM + 4, BS = BN + 4;  // padded slab rows
  static_assert((BM / TM) * (BN / TN) == kGemmThreads,
                "one micro-tile per thread");
  static_assert(kGemmThreads % BM == 0 || BM % kGemmThreads == 0, "");
  static_assert(kGemmThreads % BN == 0, "");
  static_assert(TM % P == 0 && TN % P == 0, "whole parts");
  // The tile row of element i of the micro-tile of thread row ty, and the
  // tile column of element j of thread column tx.
  __device__ static int row(int ty, int i) {
    return (i / PM) * (BM / P) + ty * PM + i % PM;
  }
  __device__ static int col(int tx, int j) {
    return (j / PN) * (BN / P) + tx * PN + j % PN;
  }
};
using TileThin = Tile<256, 4, 4, 1>;     // 0: dx / ddy, N <= 4
using TileTall = Tile<128, 32, 4, 4>;    // 1: dx / ddy, the rest
using TileSquare = Tile<64, 64, 4, 4>;   // 2: dW, Cout > 32
using TileSmall = Tile<64, 32, 4, 2>;    // 3: dW, Cout <= 32
using TileHalf = Tile<256, 16, 4, 4>;    // 4: the forwards, 4 < N <= 16
using TilePatch = Tile<128, 128, 8, 8, 2>;  // 5: the patch roles

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  // src-size 0 fills the 4 bytes with zero.
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One kBK x X slab of an operand as thread t loads it: elements
// e = t + 256 q numbered along the operand's contiguous axis -- along k
// when KContig (e -> k = e % kBK, x = e / kBK), else along x
// (x = e % X, k = e / X).  Stored [k][x], rows padded to X + 4 floats.
// A thread's k (KContig) or x (not) is the same for all its elements.
template <int X, bool KContig>
struct Slab {
  static constexpr int kElems = X * kBK;
  static constexpr int kPer = (kElems + kGemmThreads - 1) / kGemmThreads;
  static constexpr int kPitch = X + 4;
  static_assert(KContig ? kGemmThreads % kBK == 0 : kGemmThreads % X == 0,
                "a thread's k (or x) must not change with q");
  __device__ static int e(int q) { return threadIdx.x + q * kGemmThreads; }
  __device__ static int k_of(int q) {
    return KContig ? e(q) % kBK : e(q) / X;
  }
  __device__ static int x_of(int q) {
    return KContig ? e(q) / kBK : e(q) % X;
  }
  __device__ static bool live(int q) { return e(q) < kElems; }
  __device__ static int at(int q) { return k_of(q) * kPitch + x_of(q); }
  // Floats of one stage of an operand read through R: v, and y after it
  // for an fp32 masked operand.
  template <class R>
  __host__ __device__ static constexpr int stage_floats() {
    return kBK * kPitch * R::kPlanes;
  }
};

// How a thread's elements of one operand reach a stage of Slab S through
// reader R, by R's element type.  put(s, q, ...) starts element q's copy
// into stage s (zeros when !valid); settle() finishes the copies after
// the current slab's FMAs; fixup(s) finishes them once stage s has
// landed, before the barrier that publishes it.
template <class S, class R, class E = typename R::Elem>
struct Stager {
  // fp32: cp.async straight into the stage (y into the second plane of a
  // masked operand), v * act'(y) * scale formed in place once landed.
  __device__ __forceinline__ void put(float* s, int q, const R& r,
                                      long long off, bool valid) {
    cp_async4(s + S::at(q), r.v + (valid ? off : 0), valid);
    if constexpr (R::kMasked)
      cp_async4(s + kBK * S::kPitch + S::at(q), r.y + (valid ? off : 0),
                valid);
  }
  __device__ __forceinline__ void settle(const R&) {}
  __device__ __forceinline__ void fixup(float* s, const R& r) const {
    if constexpr (R::kMasked) {
#pragma unroll
      for (int q = 0; q < S::kPer; ++q)
        if (S::live(q))
          s[S::at(q)] = r.apply(s[S::at(q)], s[kBK * S::kPitch + S::at(q)]);
    }
  }
};

template <class S, class R>
struct Stager<S, R, __nv_bfloat16> {
  // bf16: each element's bits into registers (a predicated 2-byte load),
  // then widened -- v * act'(y) * scale for a masked operand -- and
  // stored as fp32 to the stage.
  unsigned short v[S::kPer];
  unsigned short y[R::kMasked ? S::kPer : 1];
  float* dst;
  __device__ __forceinline__ static unsigned short bits(
      const __nv_bfloat16* p, long long off, bool valid) {
    return valid ? __ldg(reinterpret_cast<const unsigned short*>(p) + off)
                 : (unsigned short)0;
  }
  __device__ __forceinline__ static float widen(unsigned short b) {
    return __uint_as_float((unsigned)b << 16);
  }
  __device__ __forceinline__ void put(float* s, int q, const R& r,
                                      long long off, bool valid) {
    dst = s;
    v[q] = bits(r.v, off, valid);
    if constexpr (R::kMasked) y[q] = bits(r.y, off, valid);
  }
  __device__ __forceinline__ void settle(const R& r) {
#pragma unroll
    for (int q = 0; q < S::kPer; ++q) {
      if (!S::live(q)) continue;
      if constexpr (R::kMasked)
        dst[S::at(q)] = r.apply(widen(v[q]), widen(y[q]));
      else
        dst[S::at(q)] = widen(v[q]);
    }
  }
  __device__ __forceinline__ void fixup(float*, const R&) const {}
};

template <int N>
__device__ __forceinline__ void load_row(float* v, const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

// Shared-memory floats of the ring of a GEMM with loaders LA and LB.
template <class LA, class LB>
__host__ __device__ constexpr int ring_floats() {
  return kStages * (LA::kStage + LB::kStage);
}

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// acc = A[:, k_begin:k_end] . B[k_begin:k_end, :] for this CTA's tile, in
// the fixed order k = k_begin, k_begin + 1, ...  `la` / `lb` start the
// copies of a slab of A ([k][m]) and B ([k][n]) into a stage (`fetch`),
// finish them after the current slab's FMAs (`settle`, bf16) and finish
// a landed stage (`fixup`, fp32).  smem holds the ring (ring_floats).
// Every thread of the CTA calls it.
template <class T, class LA, class LB>
__device__ __forceinline__ void gemm_mainloop(LA& la, LB& lb, int k_begin,
                                              int k_end,
                                              float (&acc)[T::TM][T::TN],
                                              float* smem) {
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.0f;
  if (k_begin >= k_end) return;
  constexpr int kStage = LA::kStage + LB::kStage;
  const int slabs = (k_end - k_begin + kBK - 1) / kBK;
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slabs) {
      la.fetch(k_begin + s * kBK, k_end, smem + s * kStage);
      lb.fetch(k_begin + s * kBK, k_end, smem + s * kStage + LA::kStage);
      la.settle();
      lb.settle();
    }
    cp_async_commit();
  }
  for (int s = 0; s < slabs; ++s) {
    cp_async_wait<kStages - 2>();
    float* st = smem + (s % kStages) * kStage;
    la.fixup(st);
    lb.fixup(st + LA::kStage);
    __syncthreads();  // stage s is whole; every thread is past slab s - 1
    const int next = s + kStages - 1;
    if (next < slabs) {
      float* nx = smem + (next % kStages) * kStage;
      la.fetch(k_begin + next * kBK, k_end, nx);
      lb.fetch(k_begin + next * kBK, k_end, nx + LA::kStage);
    }
    cp_async_commit();
    const float* a = st + ty * T::PM;
    const float* b = st + LA::kStage + tx * T::PN;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[T::TM], bv[T::TN];
#pragma unroll
      for (int h = 0; h < T::P; ++h) {
        load_row<T::PM>(av + h * T::PM, a + kk * T::AS + h * (T::BM / T::P));
        load_row<T::PN>(bv + h * T::PN, b + kk * T::BS + h * (T::BN / T::P));
      }
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // Stage `next` was last read at slab s - 1, before this slab's
    // barrier; it is read again after slab next - 1's.
    if (next < slabs) {
      la.settle();
      lb.settle();
    }
  }
  cp_async_wait<0>();
}

// out(row, col, value) for every element of this thread's micro-tile,
// row and col local to the tile.
template <class T, class Out>
__device__ __forceinline__ void store_tile(const float (&acc)[T::TM][T::TN],
                                           const Out& out) {
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j)
      out(T::row(ty, i), T::col(tx, j), acc[i][j]);
}

// One CTA's share of a tile's reduction: split `split` of `splits`, over
// consecutive chunks of the reduction axis.  With more than one split the
// partials meet in `ws` (the tile's `splits` partials, in split order, in
// a workspace the wrapper allocates) and the tile counts its finished
// splits on `ticket`, an int the last split sets back to 0.
struct Split {
  int split, splits;
  float* ws;
  int* ticket;
};

// True in the CTA that finishes a tile's splits last.  Each split has
// written its partial to ws before it calls this; the integer ticket only
// elects the CTA that adds the partials, and orders nothing in the sum.
// Every thread of the CTA calls it.
__device__ __forceinline__ bool last_split(const Split& sp) {
  __shared__ int last;
  __threadfence();  // this split's partial is visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(sp.ticket, 1) == sp.splits - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();  // ... and the others' partials before they are read
  return true;
}

// out(row, col, value) for the tile's sum: directly with one split;
// else each split stores its partial tile (row-major BM x BN) to ws and
// the last one adds the `splits` partials of each element in split order
// 0, 1, ..., so the same inputs give the same bits whatever order the
// CTAs ran in.  With kVec4 (the patch roles) the last one reads four
// consecutive elements a thread (one 16-byte load a partial), so four
// sums and the loads of several partials are in flight at once.  The
// other roles keep one element a thread: at the nine main-path layers
// the vector form made every dW role faster but the dx role of the two
// 3-channel layers slower, and their launches with it
// (scripts/backward_roles.py).  Every thread of the CTA calls it.
template <class T, bool kVec4 = false, class Out>
__device__ __forceinline__ void split_finish(
    const float (&acc)[T::TM][T::TN], const Split& sp, const Out& out) {
  if (sp.splits == 1) {
    store_tile<T>(acc, out);
    return;
  }
  constexpr int kTile = T::BM * T::BN;
  float* mine = sp.ws + sp.split * kTile;
  store_tile<T>(acc, [&](int row, int col, float v) {
    __stcg(mine + row * T::BN + col, v);
  });
  if (!last_split(sp)) return;
  if constexpr (kVec4) {
    static_assert(kTile % (4 * kGemmThreads) == 0, "whole float4 a thread");
    for (int e = 4 * threadIdx.x; e < kTile; e += 4 * kGemmThreads) {
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
      for (int r = 0; r < sp.splits; ++r) {
        const float4 v =
            __ldcg(reinterpret_cast<const float4*>(sp.ws + r * kTile + e));
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      out(e / T::BN, e % T::BN, s.x);
      out((e + 1) / T::BN, (e + 1) % T::BN, s.y);
      out((e + 2) / T::BN, (e + 2) % T::BN, s.z);
      out((e + 3) / T::BN, (e + 3) % T::BN, s.w);
    }
  } else {
    for (int e = threadIdx.x; e < kTile; e += kGemmThreads) {
      float s = 0.0f;
      for (int r = 0; r < sp.splits; ++r) s += __ldcg(sp.ws + r * kTile + e);
      out(e / T::BN, e % T::BN, s);
    }
  }
  if (threadIdx.x == 0) *sp.ticket = 0;
}

// The k range of split sp of a reduction of length K: chunks of
// ceil(K / splits) rounded up to whole slabs.
__device__ __forceinline__ void split_range(int K, const Split& sp,
                                            int* k_begin, int* k_end) {
  const int chunk = ((K + sp.splits - 1) / sp.splits + kBK - 1) / kBK * kBK;
  *k_begin = min(K, sp.split * chunk);
  *k_end = min(K, *k_begin + chunk);
}

// -- the dW role --------------------------------------------------------------
//
// dW[kx,ky,ci,co] = sum_p X[b, i*S+kx*D-P, j*S+ky*D-P, ci] * DY[p, co]
// over the positions p = (b, i, j) of the (B, Oh, Ow) frame: a GEMM with
// M = Kh*Kw*Cin rows m = (kx*Kw + ky)*Cin + ci, N = Cout, and k = p.
// X is the (B, Nh, Nw, Cin) operand of g.

// A[p][m]: contiguous along m (ci), so a thread's m is fixed.
template <class T, class X>
struct DwA {
  using S = Slab<T::BM, false>;
  static constexpr int kStage = S::template stage_floats<X>();
  X x;
  ConvGeom g;
  FastDiv fd_ow, fd_oh;
  int ci, offh, offw;
  bool mlive;
  Stager<S, X> st;
  __device__ DwA(const X& x_, const ConvGeom& g_, FastDiv fd_cin,
                 FastDiv fd_kw, FastDiv ow, FastDiv oh, int m0)
      : x(x_), g(g_), fd_ow(ow), fd_oh(oh) {
    const int m = m0 + S::x_of(0);
    mlive = m < g.Kh * g.Kw * g.Cin;
    const int tap = fast_div(m, fd_cin);
    ci = m - tap * g.Cin;
    const int kx = fast_div(tap, fd_kw);
    offh = kx * g.dh - g.ph;
    offw = (tap - kx * g.Kw) * g.dw - g.pw;
  }
  __device__ __forceinline__ void fetch(int k0, int k_end, float* s) {
#pragma unroll
    for (int q = 0; q < S::kPer; ++q) {
      if (!S::live(q)) continue;
      const int p = k0 + S::k_of(q);
      const int bi = fast_div(p, fd_ow);
      const int b = fast_div(bi, fd_oh);
      const int h = (bi - b * g.Oh) * g.sh + offh;
      const int w = (p - bi * g.Ow) * g.sw + offw;
      const bool valid = mlive && p < k_end && h >= 0 && h < g.Nh &&
                         w >= 0 && w < g.Nw;
      st.put(s, q, x, ((b * g.Nh + h) * g.Nw + w) * g.Cin + ci, valid);
    }
  }
  __device__ __forceinline__ void settle() { st.settle(x); }
  __device__ __forceinline__ void fixup(float* s) const { st.fixup(s, x); }
};

// B[k][n] = V[k * N + n] of a (K, N) operand read along n: the dW
// role's dy (k = p, N = Cout) and the ddy role's W (k = (tap, ci)).
// With kStepped (the patch dW role) a thread keeps its first element's
// offset and the step to the next (its n is fixed and its k lie
// kGemmThreads / BN apart, Slab::k_of) in place of a 64-bit product an
// element: with the product the bf16 patch kernel's dW role, at 128
// registers a thread, took 1.8x as long.  The other roles keep the
// product: in their kernels the step slowed the tconv dW roles
// (scripts/backward_roles.py).
template <class T, class V, bool kStepped = false>
struct RowsB {
  using S = Slab<T::BN, false>;
  static constexpr int kStage = S::template stage_floats<V>();
  V v;
  int N, n, step;
  Stager<S, V> st;
  __device__ RowsB(const V& v_, int N_, int n0)
      : v(v_), N(N_), n(n0 + S::x_of(0)), step(kGemmThreads / T::BN * N_) {}
  __device__ __forceinline__ void fetch(int k0, int k_end, float* s) {
    const long long at = (long long)(k0 + S::k_of(0)) * N + n;
#pragma unroll
    for (int q = 0; q < S::kPer; ++q) {
      if (!S::live(q)) continue;
      const int k = k0 + S::k_of(q);
      const long long off =
          kStepped ? at + (long long)q * step : (long long)k * N + n;
      st.put(s, q, v, off, n < N && k < k_end);
    }
  }
  __device__ __forceinline__ void settle() { st.settle(v); }
  __device__ __forceinline__ void fixup(float* s) const { st.fixup(s, v); }
};

// Division constants of a launch's geometry, made on the host.
struct GeomDiv {
  FastDiv cin, cout, kw, ow, oh;
};

static inline GeomDiv make_geom_div(const ConvGeom& g) {
  GeomDiv d;
  d.cin = make_fastdiv(g.Cin);
  d.cout = make_fastdiv(g.Cout);
  d.kw = make_fastdiv(g.Kw);
  d.ow = make_fastdiv(g.Ow);
  d.oh = make_fastdiv(g.Oh);
  return d;
}

// One dW tile (`tile` over (M tiles, N tiles), n fastest); split sp sums
// the positions of its chunk (split_range over B*Oh*Ow).
template <class T, class X, class DY>
__device__ __forceinline__ void dw_tile(const X& x, const DY& dy,
                                        typename X::Elem* __restrict__ dw,
                                        const ConvGeom& g, const GeomDiv& fd,
                                        int tile, const Split& sp,
                                        float* smem) {
  const int n_tiles = (g.Cout + T::BN - 1) / T::BN;
  const int m0 = (tile / n_tiles) * T::BM, n0 = (tile % n_tiles) * T::BN;
  int k_begin, k_end;
  split_range(g.B * g.Oh * g.Ow, sp, &k_begin, &k_end);
  DwA<T, X> la(x, g, fd.cin, fd.kw, fd.ow, fd.oh, m0);
  RowsB<T, DY> lb(dy, g.Cout, n0);
  float acc[T::TM][T::TN];
  gemm_mainloop<T>(la, lb, k_begin, k_end, acc, smem);
  const int M = g.Kh * g.Kw * g.Cin;
  split_finish<T>(acc, sp, [&](int row, int col, float v) {
    const int m = m0 + row, n = n0 + col;
    if (m < M && n < g.Cout) store_f32(dw + m * g.Cout + n, v);
  });
}

// -- the bias gradient ---------------------------------------------------------
//
// out[c] = sum of v(r * C + c) over the rows r of an (n, C) operand, for
// the channels of tile `tile` (min(C, 256) channels per tile).  Split sp
// takes its chunk of rows; thread t takes channel t % ct and every
// (256 / ct)-th row of it in four fixed interleaved sums; the row slices
// are added in order in shared memory, and the splits' partials (256
// floats each in ws) in split order.
template <class V>
__device__ __forceinline__ void channel_sum(const V& v,
                                            typename V::Elem* __restrict__ out,
                                            int n,
                                            int C, int tile, const Split& sp,
                                            float* smem) {
  const int ct = min(C, kGemmThreads), per = kGemmThreads / ct;
  const int lane = threadIdx.x % ct, slice = threadIdx.x / ct;
  const int c = tile * ct + lane;
  const int chunk = (n + sp.splits - 1) / sp.splits;
  const int r_end = min(n, (sp.split + 1) * chunk);
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  if (slice < per && c < C) {
    int r = sp.split * chunk + slice;
    for (; r + 3 * per < r_end; r += 4 * per) {
      s0 += v(r * C + c);
      s1 += v((r + per) * C + c);
      s2 += v((r + 2 * per) * C + c);
      s3 += v((r + 3 * per) * C + c);
    }
    for (; r < r_end; r += per) s0 += v(r * C + c);
  }
  smem[threadIdx.x] = (s0 + s1) + (s2 + s3);
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x < ct)
    for (int q = 0; q < per; ++q) s += smem[q * ct + threadIdx.x];
  if (sp.splits == 1) {
    if (threadIdx.x < ct && c < C) store_f32(out + c, s);
    return;
  }
  if (threadIdx.x < ct)
    __stcg(sp.ws + sp.split * kGemmThreads + threadIdx.x, s);
  if (!last_split(sp)) return;
  if (threadIdx.x < ct && c < C) {
    float t = 0.0f;
    for (int r = 0; r < sp.splits; ++r)
      t += __ldcg(sp.ws + r * kGemmThreads + threadIdx.x);
    store_f32(out + c, t);
  }
  if (threadIdx.x == 0) *sp.ticket = 0;
}

// -- the gather roles' stores --------------------------------------------------
//
// ep(v, c) of a gather role's output element in channel c, applied where
// the tile is stored: to the final sum, after split_finish's split-order
// add, never to a partial.  The backwards store the sum as it is; the
// forwards fuse act(scale * v + bias[c]) (common.cuh).

struct NoEpilogue {
  __device__ __forceinline__ float operator()(float v, int) const {
    return v;
  }
};

template <class E>
struct FusedEpilogueT {
  EpilogueArgsT<E> args;
  __device__ __forceinline__ float operator()(float v, int c) const {
    return apply_epilogue(v, c, args);
  }
};

// -- the dx role: conv_backward's dx, tconv_phase ------------------------------
//
// dx = tconv(DY, W) in one residue class (p, q): the dx pixels
// (m*S + p - P, n*S + q - P) that lie in the frame, as a GEMM with rows
// m = (b, mh, mw) of the class, N = Cin, and k = (slot, co) over the
// class's taps (kx, ky) = (a + u*per_h, c + v*per_w), slot = u*nv + v.
// Tap (u, v) reads dy at (mh - base_h - u*step_h, mw - base_w -
// v*step_w).

// The class's taps and its rows of the dx frame.  a / c = -1 when no tap
// reaches the residue (K < S): its pixels get an empty sum.
struct PhaseClass {
  int a, c, nu, nv, base_h, base_w, mlo_h, mlo_w, Hc, Wc;
};

// Rows m of one axis with 0 <= m*S + p - P < N: [*lo, *lo + count).
__host__ __device__ inline int residue_rows(int N, int S, int P, int p,
                                            int* lo) {
  const int l = P - p > 0 ? (P - p + S - 1) / S : 0;
  const int top = N - 1 + P - p;
  const int h = top >= 0 ? top / S + 1 : 0;
  *lo = l;
  return h > l ? h - l : 0;
}

__host__ __device__ inline PhaseClass phase_class(const ConvGeom& g,
                                                  const PhaseGeom& t, int p,
                                                  int q) {
  PhaseClass c;
  c.a = c.c = -1;
  for (int s = 0; s < t.TPh; ++s)
    if ((s * g.dh) % g.sh == p) c.a = s;
  for (int s = 0; s < t.TPw; ++s)
    if ((s * g.dw) % g.sw == q) c.c = s;
  const bool taps = c.a >= 0 && c.c >= 0;
  c.nu = taps ? (g.Kh - c.a + t.per_h - 1) / t.per_h : 0;
  c.nv = taps ? (g.Kw - c.c + t.per_w - 1) / t.per_w : 0;
  c.base_h = taps ? c.a * g.dh / g.sh : 0;
  c.base_w = taps ? c.c * g.dw / g.sw : 0;
  c.Hc = residue_rows(g.Nh, g.sh, g.ph, p, &c.mlo_h);
  c.Wc = residue_rows(g.Nw, g.sw, g.pw, q, &c.mlo_w);
  return c;
}

// A[k][m] = DY at tap slot(k) of row m, read along co; the rows' (b,
// mh - base_h, mw - base_w) come from a table in shared memory.
template <class T, class DY>
struct DxA {
  using S = Slab<T::BM, true>;
  static constexpr int kStage = S::template stage_floats<DY>();
  DY dy;
  ConvGeom g;
  FastDiv fd_cout, fd_nv;
  int step_h, step_w;
  const int4* rows;
  Stager<S, DY> st;
  __device__ __forceinline__ void fetch(int k0, int k_end, float* s) {
    const int k = k0 + S::k_of(0);
    const int slot = fast_div(k, fd_cout);
    const int co = k - slot * g.Cout;
    const int u = fast_div(slot, fd_nv);
    const int di = u * step_h, dj = (slot - u * fd_nv.d) * step_w;
#pragma unroll
    for (int q = 0; q < S::kPer; ++q) {
      if (!S::live(q)) continue;
      const int4 rt = rows[S::x_of(q)];
      const int i = rt.y - di, j = rt.z - dj;
      st.put(s, q, dy, ((rt.x * g.Oh + i) * g.Ow + j) * g.Cout + co,
             k < k_end && rt.x >= 0 && i >= 0 && i < g.Oh && j >= 0 &&
                 j < g.Ow);
    }
  }
  __device__ __forceinline__ void settle() { st.settle(dy); }
  __device__ __forceinline__ void fixup(float* s) const { st.fixup(s, dy); }
};

// B[k][n] = W[kx, ky, n, co] of tap slot(k), read along co.
template <class T, class E>
struct DxB {
  using S = Slab<T::BN, true>;
  using W = PlainT<E>;
  static constexpr int kStage = S::template stage_floats<W>();
  W w;
  ConvGeom g;
  FastDiv fd_cout, fd_nv;
  int a, c, per_h, per_w, n0;
  Stager<S, W> st;
  __device__ __forceinline__ void fetch(int k0, int k_end, float* s) {
    const int k = k0 + S::k_of(0);
    const int slot = fast_div(k, fd_cout);
    const int co = k - slot * g.Cout;
    const int u = fast_div(slot, fd_nv);
    const int kx = a + u * per_h, ky = c + (slot - u * fd_nv.d) * per_w;
    const int base = (kx * g.Kw + ky) * g.Cin;
#pragma unroll
    for (int q = 0; q < S::kPer; ++q) {
      if (!S::live(q)) continue;
      const int n = n0 + S::x_of(q);
      st.put(s, q, w, (base + n) * g.Cout + co, k < k_end && n < g.Cin);
    }
  }
  __device__ __forceinline__ void settle() { st.settle(w); }
  __device__ __forceinline__ void fixup(float*) const {}
};


// dx tiles of class (p, q), n fastest: ceil(B*Hc*Wc / BM) * ceil(Cin / BN).
__host__ __device__ inline int dx_class_tiles(const ConvGeom& g,
                                              const PhaseClass& c, int BM,
                                              int BN) {
  return (g.B * c.Hc * c.Wc + BM - 1) / BM * ((g.Cin + BN - 1) / BN);
}

static inline long long dx_tile_count(const ConvGeom& g, const PhaseGeom& t,
                                      int BM, int BN) {
  long long n = 0;
  for (int cls = 0; cls < g.sh * g.sw; ++cls)
    n += dx_class_tiles(g, phase_class(g, t, cls / g.sw, cls % g.sw), BM, BN);
  return n;
}

// One tile of dx; `tile` counts over the classes in (p, q) order.  g is
// the dx frame (n_out).  Every row of a class is tiled, those that no
// tap or no dy position reaches too (residues a tap never lands in, K <
// S; an n_out tail past the full frame): their sum is empty, so they
// store ep(0), the fill of repro's assemble_phase_major.
template <class T, class DY, class Ep = NoEpilogue>
__device__ __forceinline__ void dx_tile(const DY& dy,
                                        const typename DY::Elem* __restrict__ w,
                                        typename DY::Elem* __restrict__ dx,
                                        const ConvGeom& g, const PhaseGeom& t,
                                        const GeomDiv& fd, int tile,
                                        const Split& sp, float* smem,
                                        const Ep& ep = Ep()) {
  int p = 0, q = 0;
  PhaseClass c;
  const int classes = g.sh * g.sw;
  int cls = 0;
  for (; cls < classes; ++cls) {
    p = cls / g.sw;
    q = cls % g.sw;
    c = phase_class(g, t, p, q);
    const int n = dx_class_tiles(g, c, T::BM, T::BN);
    if (tile < n) break;
    tile -= n;
  }
  if (cls == classes) return;
  const int n_tiles = (g.Cin + T::BN - 1) / T::BN;
  const int m0 = (tile / n_tiles) * T::BM, n0 = (tile % n_tiles) * T::BN;
  const int hw = c.Hc * c.Wc, M = g.B * hw;
  using E = typename DY::Elem;
  int4* rows =
      reinterpret_cast<int4*>(smem + ring_floats<DxA<T, DY>, DxB<T, E>>());
  for (int l = threadIdx.x; l < T::BM; l += kGemmThreads) {
    const int m = m0 + l;
    int4 rt = make_int4(-1, 0, 0, 0);
    if (m < M) {
      const int b = m / hw, rem = m - b * hw;
      const int mh = c.mlo_h + rem / c.Wc, mw = c.mlo_w + rem % c.Wc;
      rt = make_int4(b, mh - c.base_h, mw - c.base_w,
                     ((b * g.Nh + mh * g.sh + p - g.ph) * g.Nw + mw * g.sw +
                      q - g.pw) * g.Cin);
    }
    rows[l] = rt;
  }
  __syncthreads();
  const FastDiv fd_nv = make_fastdiv(c.nv > 0 ? c.nv : 1);
  DxA<T, DY> la{dy, g, fd.cout, fd_nv, t.step_h, t.step_w, rows};
  DxB<T, E> lb{PlainT<E>{w}, g, fd.cout, fd_nv, c.a, c.c, t.per_h, t.per_w,
               n0};
  float acc[T::TM][T::TN];
  int k_begin, k_end;
  split_range(c.nu * c.nv * g.Cout, sp, &k_begin, &k_end);
  gemm_mainloop<T>(la, lb, k_begin, k_end, acc, smem);
  split_finish<T>(acc, sp, [&](int row, int col, float v) {
    const int4 rt = rows[row];
    const int n = n0 + col;
    if (rt.x >= 0 && n < g.Cin) store_f32(dx + rt.w + n, ep(v, n));
  });
}

// -- the ddy role: tconv_backward's ddy, dconv_forward ---------------------------
//
// ddy[b,i,j,co] = sum_{kx,ky,ci} G[b, i*S+kx*D-P, j*S+ky*D-P, ci]
//                                * W[kx,ky,ci,co]
// over the K*K real taps (the D-dilated filter is never formed; padding is
// the loader's bounds predicate), as a GEMM with rows m = (b, i, j),
// N = Cout and k = (kx*Kw + ky)*Cin + ci (so B[k][n] = W[k*Cout + n]).
// G is the (B, Nh, Nw, Cin) operand of g.

// A[k][m] = G at tap(k) of row m, read along ci; the rows' (b, i*S - P,
// j*S - P) come from a table in shared memory.
template <class T, class G>
struct DdyA {
  using S = Slab<T::BM, true>;
  static constexpr int kStage = S::template stage_floats<G>();
  G x;
  ConvGeom g;
  FastDiv fd_cin, fd_kw;
  const int4* rows;
  Stager<S, G> st;
  __device__ __forceinline__ void fetch(int k0, int k_end, float* s) {
    const int k = k0 + S::k_of(0);
    const int tap = fast_div(k, fd_cin);
    const int ci = k - tap * g.Cin;
    const int kx = fast_div(tap, fd_kw);
    const int oh = kx * g.dh, ow = (tap - kx * g.Kw) * g.dw;
#pragma unroll
    for (int q = 0; q < S::kPer; ++q) {
      if (!S::live(q)) continue;
      const int4 rt = rows[S::x_of(q)];
      const int h = rt.y + oh, w = rt.z + ow;
      st.put(s, q, x, ((rt.x * g.Nh + h) * g.Nw + w) * g.Cin + ci,
             k < k_end && rt.x >= 0 && h >= 0 && h < g.Nh && w >= 0 &&
                 w < g.Nw);
    }
  }
  __device__ __forceinline__ void settle() { st.settle(x); }
  __device__ __forceinline__ void fixup(float* s) const { st.fixup(s, x); }
};

template <class T, class G, class Ep = NoEpilogue>
__device__ __forceinline__ void ddy_tile(const G& x,
                                         const typename G::Elem* __restrict__ w,
                                         typename G::Elem* __restrict__ ddy,
                                         const ConvGeom& g,
                                         const GeomDiv& fd, int tile,
                                         const Split& sp, float* smem,
                                         const Ep& ep = Ep()) {
  const int n_tiles = (g.Cout + T::BN - 1) / T::BN;
  const int m0 = (tile / n_tiles) * T::BM, n0 = (tile % n_tiles) * T::BN;
  const int M = g.B * g.Oh * g.Ow;
  using W = PlainT<typename G::Elem>;
  int4* rows =
      reinterpret_cast<int4*>(smem + ring_floats<DdyA<T, G>, RowsB<T, W>>());
  for (int l = threadIdx.x; l < T::BM; l += kGemmThreads) {
    const int m = m0 + l;
    int4 rt = make_int4(-1, 0, 0, 0);
    if (m < M) {
      const int bi = m / g.Ow, b = bi / g.Oh;
      rt = make_int4(b, (bi - b * g.Oh) * g.sh - g.ph,
                     (m - bi * g.Ow) * g.sw - g.pw, 0);
    }
    rows[l] = rt;
  }
  __syncthreads();
  DdyA<T, G> la{x, g, fd.cin, fd.kw, rows};
  RowsB<T, W> lb(W{w}, g.Cout, n0);
  float acc[T::TM][T::TN];
  int k_begin, k_end;
  split_range(g.Kh * g.Kw * g.Cin, sp, &k_begin, &k_end);
  gemm_mainloop<T>(la, lb, k_begin, k_end, acc, smem);
  split_finish<T>(acc, sp, [&](int row, int col, float v) {
    const int m = m0 + row, n = n0 + col;
    if (m < M && n < g.Cout) store_f32(ddy + m * g.Cout + n, ep(v, n));
  });
}

// -- the patch roles: conv_backward's dx and dW of a non-overlapping conv --------
//
// With S = K, P = 0 and D = 1 on both axes each pixel of x lies under one
// tap of one patch, and the conv is a pair of dense GEMMs over the patch
// matrix Pm: one row per output position p = (b, i, j), one column per
// n = (kh*Kw + kw)*Cin + c = kh*R + r, R = Kw*Cin, so that
//     Pm[p, kh*R + r] = X[b, i*Kh + kh, j*Kw*Cin + r]     (w and c flat)
// and row p is Kh runs of R contiguous values.  W is the row-major
// (Kh*Kw*Cin, Cout) matrix HWIO already is, and with m the masked
// cotangent (B*Oh*Ow, Cout):
//     dx role  m . W^T   M = B*Oh*Ow, N = Kh*Kw*Cin, k = co, each row
//              stored into dx's frame as Kh runs of R values;
//     dW role  Pm^T . m  M = Kh*Kw*Cin in tiles of whole runs, N = Cout,
//              k = p.
// dx pixels no patch covers (rows past Oh*Kh, columns past Ow*Kw of the
// frame) get 0, written by the dx role's CTAs.

__host__ __device__ inline bool non_overlapping(const ConvGeom& g) {
  return g.sh == g.Kh && g.sw == g.Kw && g.ph == 0 && g.pw == 0 &&
         g.dh == 1 && g.dw == 1;
}

// M tiles of the dW role: BM / R whole runs a tile when a run fits one,
// else ceil(R / BM) tiles a run.
__host__ __device__ inline int patch_m_tiles(int Kh, int R, int BM) {
  return R <= BM ? (Kh + BM / R - 1) / (BM / R) : Kh * ((R + BM - 1) / BM);
}

// Row l of dW M tile mt as its run kh and place r in the run; kh = -1
// for a row past the runs the tile holds.
__device__ __forceinline__ void patch_m_row(int mt, int l, int Kh, int R,
                                            int BM, int* kh, int* r) {
  if (R <= BM) {
    const int per = BM / R, u = l / R;
    *kh = u < per && mt * per + u < Kh ? mt * per + u : -1;
    *r = l - u * R;
  } else {
    const int tpr = (R + BM - 1) / BM;
    *kh = mt / tpr;
    *r = (mt % tpr) * BM + l;
    if (*r >= R) *kh = -1;
  }
}

// A[k][x] = V[(x0 + x) * ld + k] for x0 + x < rows, k < k_end: an
// (rows, ld) operand read along its contiguous k -- the dx role's
// cotangent (x = p, ld = Cout) and its W (x = n, ld = Cout).  A thread's
// rows lie kGemmThreads / kBK apart (Slab::x_of), so it keeps its first
// row's offset, the step between rows and which rows are live.
template <int X, class V>
struct KRows {
  using S = Slab<X, true>;
  static constexpr int kStage = S::template stage_floats<V>();
  V v;
  long long off;    // (x0 + S::x_of(0)) * ld
  int step;         // (kGemmThreads / kBK) * ld
  unsigned live;    // bit q: row x0 + S::x_of(q) < rows
  Stager<S, V> st;
  __device__ KRows(const V& v_, int rows, int ld, int x0)
      : v(v_), off((long long)(x0 + S::x_of(0)) * ld),
        step(kGemmThreads / kBK * ld), live(0) {
#pragma unroll
    for (int q = 0; q < S::kPer; ++q)
      if (x0 + S::x_of(q) < rows) live |= 1u << q;
  }
  __device__ __forceinline__ void fetch(int k0, int k_end, float* s) {
    const int k = k0 + S::k_of(0);
#pragma unroll
    for (int q = 0; q < S::kPer; ++q) {
      if (!S::live(q)) continue;
      st.put(s, q, v, off + (long long)q * step + k,
             k < k_end && (live >> q & 1u));
    }
  }
  __device__ __forceinline__ void settle() { st.settle(v); }
  __device__ __forceinline__ void fixup(float* s) const { st.fixup(s, v); }
};

// A[p][m] = Pm[p, m] of the dW role's M tile `mt`, read along m (a
// thread's m, so its run and place, is fixed); no bounds: a patch lies in
// the frame.  Patch p = (b*Oh + i)*Ow + j starts at
//     ((b*Nh + i*Kh)*Nw + j*Kw)*Cin = p*sj + bi*c1 + b*c2,
// bi = p / Ow, b = bi / Oh (two fast divisions), sj = Kw*Cin,
// c1 = Kh*Nw*Cin - Ow*sj, c2 = (Nh - Oh*Kh)*Nw*Cin.
template <class T, class X>
struct PatchDwA {
  using S = Slab<T::BM, false>;
  static constexpr int kStage = S::template stage_floats<X>();
  X x;
  FastDiv fd_ow, fd_oh;
  int sj, c1, c2;
  int off;    // the thread's kh*Nw*Cin + r in a patch; -1 past the runs
  Stager<S, X> st;
  __device__ PatchDwA(const X& x_, const ConvGeom& g, FastDiv ow, FastDiv oh,
                      int mt)
      : x(x_), fd_ow(ow), fd_oh(oh), sj(g.Kw * g.Cin),
        c1(g.Kh * g.Nw * g.Cin - g.Ow * g.Kw * g.Cin),
        c2((g.Nh - g.Oh * g.Kh) * g.Nw * g.Cin) {
    int kh, r;
    patch_m_row(mt, S::x_of(0), g.Kh, g.Kw * g.Cin, T::BM, &kh, &r);
    off = kh < 0 ? -1 : kh * g.Nw * g.Cin + r;
  }
  __device__ __forceinline__ void fetch(int k0, int k_end, float* s) {
#pragma unroll
    for (int q = 0; q < S::kPer; ++q) {
      if (!S::live(q)) continue;
      const int p = k0 + S::k_of(q);
      const int bi = fast_div(p, fd_ow);
      const int base = p * sj + bi * c1 + fast_div(bi, fd_oh) * c2;
      st.put(s, q, x, base + off, off >= 0 && p < k_end);
    }
  }
  __device__ __forceinline__ void settle() { st.settle(x); }
  __device__ __forceinline__ void fixup(float* s) const { st.fixup(s, x); }
};

// One dW tile (`tile` over (M tiles, N tiles), n fastest); split sp sums
// the positions of its chunk (split_range over B*Oh*Ow), as dw_tile.
template <class T, class X, class DY>
__device__ __forceinline__ void patch_dw_tile(
    const X& x, const DY& dy, typename X::Elem* __restrict__ dw,
    const ConvGeom& g, const GeomDiv& fd, int tile, const Split& sp,
    float* smem) {
  const int n_tiles = (g.Cout + T::BN - 1) / T::BN;
  const int mt = tile / n_tiles, n0 = (tile % n_tiles) * T::BN;
  int k_begin, k_end;
  split_range(g.B * g.Oh * g.Ow, sp, &k_begin, &k_end);
  PatchDwA<T, X> la(x, g, fd.ow, fd.oh, mt);
  RowsB<T, DY, true> lb(dy, g.Cout, n0);
  float acc[T::TM][T::TN];
  gemm_mainloop<T>(la, lb, k_begin, k_end, acc, smem);
  const int R = g.Kw * g.Cin;
  split_finish<T, true>(acc, sp, [&](int row, int col, float v) {
    int kh, r;
    patch_m_row(mt, row, g.Kh, R, T::BM, &kh, &r);
    const int n = n0 + col;
    if (kh >= 0 && n < g.Cout) store_f32(dw + (kh * R + r) * g.Cout + n, v);
  });
}

// dx = 0 at the frame's pixels no patch covers, over CTA `cta` of the dx
// role's `ctas`: per image the rows from Oh*Kh on (one contiguous block),
// then the columns from Ow*Kw on of each row above (a run each).
template <class E>
__device__ __forceinline__ void patch_fill(E* __restrict__ dx,
                                           const ConvGeom& g, int cta,
                                           int ctas) {
  const int hc = g.Oh * g.Kh, wc = g.Ow * g.Kw;
  const long long bottom = (long long)(g.Nh - hc) * g.Nw * g.Cin;
  const long long side = (long long)(g.Nw - wc) * g.Cin;
  const long long image = bottom + hc * side;
  const long long total = g.B * image;
  for (long long e = (long long)cta * kGemmThreads + threadIdx.x; e < total;
       e += (long long)ctas * kGemmThreads) {
    const long long b = e / image, u = e - b * image;
    long long at;
    if (u < bottom) {
      at = (b * g.Nh + hc) * g.Nw * g.Cin + u;
    } else {
      const long long h = (u - bottom) / side;
      at = ((b * g.Nh + h) * g.Nw + wc) * g.Cin + (u - bottom - h * side);
    }
    store_f32(dx + at, 0.0f);
  }
}

__host__ __device__ inline long long patch_dx_tiles(const ConvGeom& g, int BM,
                                                    int BN) {
  return ((long long)g.B * g.Oh * g.Ow + BM - 1) / BM *
         ((g.Kh * g.Kw * g.Cin + BN - 1) / BN);
}

// One dx tile (`tile` over (M tiles, N tiles), n fastest) of the dx frame
// g (n_out); split sp sums its chunk of Cout.  CTA `cta` of the role's
// `ctas` first writes its share of the uncovered pixels' zeros.  The
// tile's rows (each patch's corner in dx) and columns (each n's place in
// a patch) come from two tables in shared memory after the ring.
template <class T, class DY>
__device__ __forceinline__ void patch_dx_tile(
    const DY& dy, const typename DY::Elem* __restrict__ w,
    typename DY::Elem* __restrict__ dx, const ConvGeom& g, int tile,
    const Split& sp, float* smem, int cta, int ctas) {
  using W = PlainT<typename DY::Elem>;
  patch_fill(dx, g, cta, ctas);
  const int M = g.B * g.Oh * g.Ow, N = g.Kh * g.Kw * g.Cin, R = g.Kw * g.Cin;
  const int n_tiles = (N + T::BN - 1) / T::BN;
  const int m0 = (tile / n_tiles) * T::BM, n0 = (tile % n_tiles) * T::BN;
  int* rows = reinterpret_cast<int*>(
      smem + ring_floats<KRows<T::BM, DY>, KRows<T::BN, W>>());
  int* cols = rows + T::BM;
  for (int l = threadIdx.x; l < T::BM; l += kGemmThreads) {
    const int m = m0 + l, bi = m / g.Ow, b = bi / g.Oh;
    rows[l] = m < M ? ((b * g.Nh + (bi - b * g.Oh) * g.Kh) * g.Nw +
                       (m - bi * g.Ow) * g.Kw) * g.Cin
                    : -1;
  }
  for (int l = threadIdx.x; l < T::BN; l += kGemmThreads) {
    const int n = n0 + l, kh = n / R;
    cols[l] = n < N ? kh * g.Nw * g.Cin + (n - kh * R) : -1;
  }
  __syncthreads();
  KRows<T::BM, DY> la(dy, M, g.Cout, m0);
  KRows<T::BN, W> lb(W{w}, N, g.Cout, n0);
  float acc[T::TM][T::TN];
  int k_begin, k_end;
  split_range(g.Cout, sp, &k_begin, &k_end);
  gemm_mainloop<T>(la, lb, k_begin, k_end, acc, smem);
  split_finish<T, true>(acc, sp, [&](int row, int col, float v) {
    const int r = rows[row], c = cols[col];
    if (r >= 0 && c >= 0) store_f32(dx + r + c, v);
  });
}

// -- launching -------------------------------------------------------------------

// Dynamic shared-memory floats of each role: the ring, and a gather
// role's row table after it; the bias gradient's 256 partials.
template <class T, class X, class DY>
__host__ __device__ constexpr int dw_smem_floats() {
  return ring_floats<DwA<T, X>, RowsB<T, DY>>();
}

template <class T, class DY>
__host__ __device__ constexpr int dx_smem_floats() {
  return ring_floats<DxA<T, DY>, DxB<T, typename DY::Elem>>() + 4 * T::BM;
}

template <class T, class G>
__host__ __device__ constexpr int ddy_smem_floats() {
  return ring_floats<DdyA<T, G>, RowsB<T, PlainT<typename G::Elem>>>() +
         4 * T::BM;
}

// The patch roles' with the cotangent read through C: dx's ring and its
// two tables, dW's ring, the bias gradient's partials.
template <class E, class C>
__host__ __device__ constexpr int patch_smem_floats() {
  using T = TilePatch;
  return cmax(cmax(ring_floats<KRows<T::BM, C>, KRows<T::BN, PlainT<E>>>() +
                       T::BM + T::BN,
                   ring_floats<PatchDwA<T, PlainT<E>>, RowsB<T, C>>()),
              kGemmThreads);
}

constexpr int kSumSmemFloats = kGemmThreads;

// Launch `kernel` over `blocks` CTAs with `floats` of dynamic shared
// memory, allowing it more than the default 48 KB once per device.
template <auto kernel, class Args>
cudaError_t launch_roles(long long blocks, int floats, const Args& args,
                         cudaStream_t stream) {
  static unsigned long long allowed = 0;   // one bit per device
  const size_t bytes = sizeof(float) * (size_t)floats;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(__atomic_load_n(&allowed, __ATOMIC_RELAXED) & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    __atomic_fetch_or(&allowed, bit, __ATOMIC_RELAXED);
  }
  kernel<<<(unsigned)blocks, kGemmThreads, bytes, stream>>>(args);
  return cudaGetLastError();
}

// Calls f(TileX{}) for the tile of id `id`: the dx / ddy tiles (0, 1)
// and the dW tiles (2, 3).
template <class F>
cudaError_t with_tile(int id, F&& f) {
  switch (id) {
    case 0: return f(TileThin{});
    case 1: return f(TileTall{});
    default: return cudaErrorInvalidValue;
  }
}

template <class F>
cudaError_t with_dw_tile(int id, F&& f) {
  switch (id) {
    case 2: return f(TileSquare{});
    case 3: return f(TileSmall{});
    default: return cudaErrorInvalidValue;
  }
}

// The forwards' gather tiles: those of the backwards and TileHalf (4).
template <class F>
cudaError_t with_forward_tile(int id, F&& f) {
  return id == 4 ? f(TileHalf{}) : with_tile(id, f);
}

static inline bool gather_tile_ok(int id) { return id == 0 || id == 1; }

static inline bool forward_tile_ok(int id) {
  return gather_tile_ok(id) || id == 4;
}

static inline bool dw_tile_ok(int id) { return id == 2 || id == 3; }

constexpr int kPatchTile = 5;   // both roles' tile in a patch plan

// Tile extents by id, for the host's counts.
static inline void tile_extent(int id, int* bm, int* bn) {
  static const int kBM[6] = {256, 128, 64, 64, 256, 128};
  static const int kBN[6] = {4, 32, 64, 32, 16, 128};
  *bm = kBM[id];
  *bn = kBN[id];
}

// The roles of one launch and where each finds its tile, split,
// workspace and ticket.  CTAs are laid out role after role (dW, db, then
// the gather role dx or ddy), each tile's splits consecutive.  A role
// whose tiles take one split each has no workspace.
struct RoleGrid {
  int n_dw, n_db, n_dx;        // tiles of each role
  int dw_splits, splits;       // splits of dW and db, of dx / ddy
  long long ws_db, ws_dx;      // workspace offsets of the db and dx regions
  float* ws;
  int* tickets;                // n_dw + n_db + n_dx, all 0 between launches
};

// The workspace floats and tickets a launch needs; fills g's offsets.
static inline long long role_grid_workspace(RoleGrid* g, int dw_tile_elems,
                                            int dx_tile_elems) {
  const long long dw = g->dw_splits > 1
      ? (long long)g->n_dw * g->dw_splits * dw_tile_elems : 0;
  const long long db = g->dw_splits > 1
      ? (long long)g->n_db * g->dw_splits * kGemmThreads : 0;
  const long long dx = g->splits > 1
      ? (long long)g->n_dx * g->splits * dx_tile_elems : 0;
  g->ws_db = dw;
  g->ws_dx = dw + db;
  return dw + db + dx;
}

static inline long long role_grid_blocks(const RoleGrid& g) {
  return (long long)(g.n_dw + g.n_db) * g.dw_splits +
         (long long)g.n_dx * g.splits;
}

// CTA blockIdx.x's role (0 dW, 1 db, 2 dx / ddy), tile and split.
template <int kDwElems, int kDxElems>
__device__ __forceinline__ int role_of(const RoleGrid& g, int* tile,
                                       Split* sp) {
  int b = blockIdx.x;
  const int n_dw = g.n_dw * g.dw_splits, n_db = g.n_db * g.dw_splits;
  int role, base;
  if (b < n_dw) {
    role = 0;
    *tile = b / g.dw_splits;
    sp->split = b % g.dw_splits;
    sp->splits = g.dw_splits;
    sp->ws = g.ws + (long long)*tile * g.dw_splits * kDwElems;
    base = 0;
  } else if ((b -= n_dw) < n_db) {
    role = 1;
    *tile = b / g.dw_splits;
    sp->split = b % g.dw_splits;
    sp->splits = g.dw_splits;
    sp->ws = g.ws + g.ws_db + (long long)*tile * g.dw_splits * kGemmThreads;
    base = g.n_dw;
  } else {
    b -= n_db;
    role = 2;
    *tile = b / g.splits;
    sp->split = b % g.splits;
    sp->splits = g.splits;
    sp->ws = g.ws + g.ws_dx + (long long)*tile * g.splits * kDxElems;
    base = g.n_dw + g.n_db;
  }
  sp->ticket = g.tickets + base + *tile;
  return role;
}

// The splits and dW chunk the host's plan names: 1 <= splits <=
// kMaxSplits, the dW chunk the one split_range gives, the workspace and
// the tickets at least what the launch needs.
static inline bool plan_ok(const RoleGrid& g, int chunk, long long positions,
                           long long ws_floats, long long ws_needed,
                           int n_tickets) {
  const long long want = ((positions + g.dw_splits - 1) / g.dw_splits +
                          kBK - 1) / kBK * kBK;
  return g.dw_splits >= 1 && g.dw_splits <= kMaxSplits && g.splits >= 1 &&
         g.splits <= kMaxSplits && chunk == want && ws_floats >= ws_needed &&
         (ws_needed == 0 || g.ws != nullptr) &&
         (long long)n_tickets >= (long long)g.n_dw + g.n_db + g.n_dx &&
         g.tickets != nullptr;
}

// Every flat index of the kernels is an int: refuse larger tensors.
static inline bool fits_int(long long n) { return n < (1LL << 31); }

// The grid of a gather role launched alone (the forwards): n_tiles tiles
// of tile_elems, `splits` CTAs each, no dW or db role.  False for a plan,
// a workspace or tickets the launch cannot take.
static inline bool gather_grid(RoleGrid* g, long long n_tiles,
                               int tile_elems, int splits, void* ws,
                               long long ws_floats, void* tickets,
                               int n_tickets) {
  g->n_dw = g->n_db = 0;
  g->n_dx = (int)n_tiles;
  g->dw_splits = 1;
  g->splits = splits;
  g->ws = static_cast<float*>(ws);
  g->tickets = static_cast<int*>(tickets);
  const long long need = role_grid_workspace(g, 0, tile_elems);
  return fits_int(n_tiles) &&
         plan_ok(*g, 0, 0, ws_floats, need, n_tickets);
}
