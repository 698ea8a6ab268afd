// Predicated implicit-GEMM transposed convolution, any (stride S,
// dilation D), fp32 or bf16 (tconv_implicit_gemm_f32 /
// tconv_implicit_gemm_bf16).
//
// Replaces repro/kernels/implicit_gemm.py::tconv_implicit_gemm_pallas
// (body _ig_kernel).  Same function as tconv_phase.cu -- the input
// gradient of the forward conv with filter W (Kh,Kw,Cin,Cout) -- written
// as one flat GEMM over the full (Fh, Fw) transposed frame: rows are the
// output sites, the reduction runs over (tap, Cout), and lane (site r,
// tap kx) is live iff
//   h = r - kx*D,  h % S == 0  and  0 <= h / S < Oh
// (SNIPPETS.md Snippet 1's in_bound).  The TPU zero-interleaved dy in VMEM
// to realize this predicate; here dead lanes are skipped, not multiplied.
// No residue classes are packed and nothing is interleaved: that is
// tconv_phase.cu, which this kernel races (kernels/tiling.py).
//
// Design.  One CTA per output tile: image b, TH x TW sites of the n_out
// frame (TH, TW multiples of S, from kernels/implicit_gemm.py::plan), and
// a tile of CIN_T output channels.  The CTA loops over Cout in chunks --
// the Pallas grid's sequential (Cout-tile, tap) axes -- through a 2-stage
// cp.async ring: while one chunk is multiplied the next is copied.  A
// stage holds
//   * the dy halo of the tile: every dy row and column one of its sites
//     reaches through a tap, at most ceil((TH + D(K-1)) / S) rows by
//     ceil((TW + D(K-1)) / S) columns of the chunk, copied with cp.async's
//     zero fill (src-size 0) where the row or column lies outside dy, so
//     the frame's bounds need no test in the inner loop;
//   * the chunk's weights, Kh*Kw taps x CIN_T x chunk, read by every
//     thread of the CTA.
// 16-byte copies when Cout % 4 == 0 and the operands are 16-byte aligned
// (4-byte copies otherwise).  A halo position's pitch is the chunk padded
// to an odd number of 16-byte words, so the lanes of a quarter-warp, which
// read neighbouring positions at one Cout offset, hit distinct banks.
//
// bf16.  The stages hold the operands as they lie, in bf16: half the
// shared memory and half the bytes copied, each element widened (exactly)
// to fp32 as the inner loop reads it, every sum in fp32, and each output
// rounded to bf16 once, in its store (common.cuh's store_f32), where
// repro's kernel casts its fp32 accumulator back.  A copy moves V
// consecutive channels of Cout: 16 bytes (V = 8) where Cout % 8 == 0,
// else 8 or 4 bytes (V = 4, 2) where Cout is a multiple of V, each with
// the operands aligned to the copy and V at most the chunk; else one
// element at a time with a plain load and store (cp.async moves no fewer
// than 4 bytes), whose latency the next chunk's barrier waits out.  Each
// stage is a whole number of 16-byte words, so every copy stays aligned.
//
// Threads by period.  A thread owns one site and accumulates all CIN_T
// channels of it in registers.  Threads are grouped by the site's stride
// residue (a, c) (a < S rows, c < S columns), TH/S x TW/S sites of each
// residue class, class-major.  The plan gives each class one warp's
// sites (kernels/implicit_gemm.py::plan, up to S = 4): the 32 lanes of a
// warp share one residue per axis, each tap's predicate is one branch
// for the whole warp, and no lane idles beside a live one.  The
// predicate is stepped, not divided: the class's first full-frame row
// r >= 0 is written r = S q + m (0 <= m < S) once, and each tap subtracts
// D from (q, m) with a borrow; the tap is live iff m == 0, and then reads
// halo row q - i0.  So no h < 0 meets C's truncating / or %, and the
// inner loops hold no division.  The Cout loop of one tap is unrolled
// over the chunk: one 16-byte halo read and CIN_T 16-byte weight reads
// (one address across the warp) feed 4 CIN_T FMAs.
//
// The store.  After the last chunk each thread applies the epilogue
// act(scale * v + bias[ci]) and stores its site, already cropped by the
// padding (sites are numbered in the n_out frame; their full-frame row is
// r = y + P).  Sites no tap reaches -- residues with no tap (K < S) and
// the rows past the full frame of a non-exact n_out -- read only the
// halo's zeros or skip every tap, and store ep(0) = act(bias) with no
// special case.  No atomics, and every sum runs in one fixed order
// (chunk, tap, Cout), so reruns are bit-identical.
//
// Bound.  At the generator's last layer (K=4, S=2, Cin=3, Cout=32) the
// useful work is tiny (25 M MACs and 2.9 MB at B = 64, about 0.9 us of
// device memory): launch latency and the halo's one round trip to memory
// bound it.  The inner loop reads one halo value per Cin_t (3) FMAs, so
// shared memory, not the FMA pipes, paces the arithmetic.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

constexpr int kMaxThreads = 512;    // one thread per site of a tile
constexpr int kMaxChunk = 32;       // Cout of one stage
constexpr int kSmemBytes = 232448;  // dynamic shared memory of one CTA

template <class E>
struct IGArgs {
  const E* dy;
  const E* w;
  E* dx;
  int B, Oh, Ow, Cout, Kh, Kw, Cin, Nh, Nw, sh, sw, ph, pw, dh, dw;
  int th, tw;            // tile (sites): multiples of sh, sw
  int cu, cv;            // sites of one residue class: th / sh, tw / sw
  int hh, hw;            // halo rows and columns
  FastDiv fd_hw;
  int tiles_y, tiles_x;  // tiles over (Nh, Nw)
  int stage_elems;       // elements of one stage
  int vec;               // elements of one copy (V)
  EpilogueArgsT<E> ep;
};

// Elements of E in one 16-byte word.
template <class E>
__host__ __device__ constexpr int word_elems() {
  return 16 / (int)sizeof(E);
}

// Elements per halo position: the chunk padded to an odd number of
// 16-byte words (kernels/implicit_gemm.py::halo_pitch).
template <class E>
__host__ __device__ constexpr int halo_pitch(int chunk) {
  constexpr int kWord = word_elems<E>();
  const int words = (chunk + kWord - 1) / kWord;
  return (words % 2 ? words : words + 1) * kWord;
}

// C's / truncates toward zero; halo origins need the floor.
__host__ __device__ inline int floor_div(int n, int d) {
  return n >= 0 ? n / d : -((-n + d - 1) / d);
}

// Halo rows of a tile of `t` sites along one axis: the dy indices its
// sites reach, the same count for every tile (each tile starts at a
// multiple of S).  kernels/implicit_gemm.py::halo_extent.
static inline int halo_extent(int t, int s, int p, int d, int k) {
  return floor_div(p + t - 1, s) + floor_div(d * (k - 1) - p, s) + 1;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zero.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// V consecutive elements from src to dst, zeros when !valid: a cp.async
// of V * sizeof(E) bytes, or a plain load and store of one bf16.
template <int V, class E>
__device__ __forceinline__ void copy_elems(E* dst, const E* src,
                                           bool valid) {
  constexpr int kBytes = V * (int)sizeof(E);
  if constexpr (kBytes == 16) cp_async16(dst, src, valid);
  else if constexpr (kBytes == 8) cp_async8(dst, src, valid);
  else if constexpr (kBytes == 4) cp_async4(dst, src, valid);
  else *dst = valid ? *src : E(0.0f);
}

// Four consecutive elements of a stage, widened to fp32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy the chunk of Cout at co0 into `stage`: the halo [i0, i0 + hh) x
// [j0, j0 + hw) of image b, position-major with halo_pitch(CHUNK)
// elements each, then W[tap][ci0 + ci][co0 + co] as (tap, ci) rows of
// CHUNK elements.  What lies outside dy, past Cin or past Cout is
// zero-filled.  V elements per copy.
template <int CIN_T, int CHUNK, int V, class E>
__device__ __forceinline__ void load_chunk(const IGArgs<E>& a, E* stage,
                                           int b, int i0, int j0, int ci0,
                                           int co0) {
  constexpr int kPer = CHUNK / V, kPitch = halo_pitch<E>(CHUNK);
  const int positions = a.hh * a.hw;
  for (int e = threadIdx.x; e < positions * kPer; e += blockDim.x) {
    const int pos = e / kPer, q = e % kPer;
    const int r = fast_div(pos, a.fd_hw);
    const int i = i0 + r, j = j0 + pos - r * a.hw, co = co0 + V * q;
    const bool ok = i >= 0 && i < a.Oh && j >= 0 && j < a.Ow && co < a.Cout;
    const E* src = ok ? a.dy + ((b * a.Oh + i) * a.Ow + j) * a.Cout + co
                      : a.dy;
    copy_elems<V>(stage + pos * kPitch + V * q, src, ok);
  }
  E* wsm = stage + positions * kPitch;
  const int rows = a.Kh * a.Kw * CIN_T;
  for (int e = threadIdx.x; e < rows * kPer; e += blockDim.x) {
    const int row = e / kPer, q = e % kPer;
    const int ci = ci0 + row % CIN_T, tap = row / CIN_T, co = co0 + V * q;
    const bool ok = ci < a.Cin && co < a.Cout;
    const E* src = ok ? a.w + (tap * a.Cin + ci) * a.Cout + co : a.w;
    copy_elems<V>(wsm + row * CHUNK + V * q, src, ok);
  }
}

// The copy width the host picked (IGArgs::vec): fp32 4 or 1, bf16 8, 4, 2
// or 1, never more than the chunk.
template <int CIN_T, int CHUNK, class E>
__device__ __forceinline__ void load_chunk(const IGArgs<E>& a, E* stage,
                                           int b, int i0, int j0, int ci0,
                                           int co0) {
  if constexpr (sizeof(E) == 4) {
    if (a.vec == 4) load_chunk<CIN_T, CHUNK, 4>(a, stage, b, i0, j0, ci0, co0);
    else load_chunk<CIN_T, CHUNK, 1>(a, stage, b, i0, j0, ci0, co0);
  } else {
    if constexpr (CHUNK >= 8) {
      if (a.vec == 8) {
        load_chunk<CIN_T, CHUNK, 8>(a, stage, b, i0, j0, ci0, co0);
        return;
      }
    }
    if (a.vec == 4) load_chunk<CIN_T, CHUNK, 4>(a, stage, b, i0, j0, ci0, co0);
    else if (a.vec == 2)
      load_chunk<CIN_T, CHUNK, 2>(a, stage, b, i0, j0, ci0, co0);
    else load_chunk<CIN_T, CHUNK, 1>(a, stage, b, i0, j0, ci0, co0);
  }
}

template <int CIN_T, int CHUNK, class E>
__global__ void __launch_bounds__(kMaxThreads)
    tconv_implicit_gemm_kernel(const IGArgs<E> a) {
  extern __shared__ __align__(16) float smem_words[];
  E* smem = reinterpret_cast<E*>(smem_words);
  constexpr int kPitch = halo_pitch<E>(CHUNK);
  const int per_image = a.tiles_y * a.tiles_x;
  const int b = blockIdx.x / per_image, t = blockIdx.x % per_image;
  const int y0 = t / a.tiles_x * a.th, x0 = t % a.tiles_x * a.tw;
  const int ci0 = blockIdx.y * CIN_T;
  // The halo's first dy row / column: the least i with i*S >= r0 - D(K-1).
  const int i0 = -floor_div(a.dh * (a.Kh - 1) - y0 - a.ph, a.sh);
  const int j0 = -floor_div(a.dw * (a.Kw - 1) - x0 - a.pw, a.sw);
  // This thread's residue class (ra, rc) and site (u, v) within it.
  const int per_class = a.cu * a.cv;
  const int cls = threadIdx.x / per_class, e = threadIdx.x % per_class;
  const int ra = cls / a.sw, rc = cls % a.sw;
  const int u = e / a.cv, v = e % a.cv;
  const int y = y0 + ra + a.sh * u, x = x0 + rc + a.sw * v;
  // The class's first site in the full frame, r = y + P >= 0, as
  // r = S q + m with 0 <= m < S.  Tap kx takes h = r - kx*D, stepped
  // below without a division: live iff its m is 0, at halo row q - i0.
  const int r_cls = y0 + a.ph + ra, s_cls = x0 + a.pw + rc;
  const int hq0 = r_cls / a.sh, hm0 = r_cls % a.sh;
  const int gq0 = s_cls / a.sw, gm0 = s_cls % a.sw;
  const int dhq = a.dh / a.sh, dhm = a.dh % a.sh;
  const int dwq = a.dw / a.sw, dwm = a.dw % a.sw;
  const int site = (u * a.hw + v) * kPitch;
  const int n_chunks = (a.Cout + CHUNK - 1) / CHUNK;
  const int halo_elems = a.hh * a.hw * kPitch;

  float acc[CIN_T];
#pragma unroll
  for (int ci = 0; ci < CIN_T; ++ci) acc[ci] = 0.0f;

  load_chunk<CIN_T, CHUNK>(a, smem, b, i0, j0, ci0, 0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const E* cur = smem + (c & 1) * a.stage_elems;
    if (c + 1 < n_chunks) {
      load_chunk<CIN_T, CHUNK>(a, smem + ((c + 1) & 1) * a.stage_elems, b,
                               i0, j0, ci0, (c + 1) * CHUNK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const E* wsm = cur + halo_elems;
    int hq = hq0, hm = hm0;
    for (int kx = 0; kx < a.Kh; ++kx) {
      if (hm == 0) {   // the class's residue: one branch for the warp
        int gq = gq0, gm = gm0;
        for (int ky = 0; ky < a.Kw; ++ky) {
          if (gm == 0) {
            const E* hp =
                cur + ((hq - i0) * a.hw + gq - j0) * kPitch + site;
            const E* wp = wsm + (kx * a.Kw + ky) * CIN_T * CHUNK;
#pragma unroll
            for (int co = 0; co < CHUNK; co += 4) {
              const float4 d = load4(hp + co);
#pragma unroll
              for (int ci = 0; ci < CIN_T; ++ci) {
                const float4 wv = load4(wp + ci * CHUNK + co);
                acc[ci] = fmaf(d.x, wv.x, acc[ci]);
                acc[ci] = fmaf(d.y, wv.y, acc[ci]);
                acc[ci] = fmaf(d.z, wv.z, acc[ci]);
                acc[ci] = fmaf(d.w, wv.w, acc[ci]);
              }
            }
          }
          gq -= dwq;
          gm -= dwm;
          if (gm < 0) {
            gm += a.sw;
            --gq;
          }
        }
      }
      hq -= dhq;
      hm -= dhm;
      if (hm < 0) {
        hm += a.sh;
        --hq;
      }
    }
    __syncthreads();   // the next chunk's copy overwrites this stage
  }

  if (y < a.Nh && x < a.Nw) {
    E* out = a.dx + ((b * a.Nh + y) * a.Nw + x) * a.Cin;
#pragma unroll
    for (int ci = 0; ci < CIN_T; ++ci)
      if (ci0 + ci < a.Cin)
        store_f32(out + ci0 + ci, apply_epilogue(acc[ci], ci0 + ci, a.ep));
  }
}

template <int CIN_T, int CHUNK, class E>
static cudaError_t launch(const IGArgs<E>& a, dim3 grid, int threads,
                          size_t bytes, cudaStream_t stream) {
  static unsigned long long allowed = 0;   // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(__atomic_load_n(&allowed, __ATOMIC_RELAXED) & bit)) {
    err = cudaFuncSetAttribute(tconv_implicit_gemm_kernel<CIN_T, CHUNK, E>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    __atomic_fetch_or(&allowed, bit, __ATOMIC_RELAXED);
  }
  tconv_implicit_gemm_kernel<CIN_T, CHUNK, E>
      <<<grid, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int CIN_T, class E>
static cudaError_t launch_chunk(int chunk, const IGArgs<E>& a, dim3 grid,
                                int threads, size_t bytes,
                                cudaStream_t stream) {
  switch (chunk) {
    case 4: return launch<CIN_T, 4>(a, grid, threads, bytes, stream);
    case 8: return launch<CIN_T, 8>(a, grid, threads, bytes, stream);
    case 16: return launch<CIN_T, 16>(a, grid, threads, bytes, stream);
    default: return launch<CIN_T, 32>(a, grid, threads, bytes, stream);
  }
}

static inline bool fits_int(long long n) { return n < (1LL << 31); }

#define IG_PARAMS                                                            \
  const void *dy, const void *w, const void *bias, void *dx, int B, int Oh, \
      int Ow, int Cout, int Kh, int Kw, int Cin, int Nh, int Nw, int sh,   \
      int sw, int ph, int pw, int dh, int dw, int act, float slope,        \
      int has_scale, float scale, int th, int tw, int cin_t, int chunk,    \
      void *stream
#define IG_ARGS                                                              \
  dy, w, bias, dx, B, Oh, Ow, Cout, Kh, Kw, Cin, Nh, Nw, sh, sw, ph, pw,    \
      dh, dw, act, slope, has_scale, scale, th, tw, cin_t, chunk, stream

// The widest copy of E that Cout, the chunk and both operands' alignment
// allow (elements).
template <class E>
static int copy_width(int Cout, int chunk, const void* dy, const void* w) {
  for (int v = word_elems<E>(); v > 1; v /= 2) {
    const uintptr_t bytes = (uintptr_t)v * sizeof(E);
    if (v <= chunk && Cout % v == 0 &&
        reinterpret_cast<uintptr_t>(dy) % bytes == 0 &&
        reinterpret_cast<uintptr_t>(w) % bytes == 0 &&
        (sizeof(E) == 2 || v == word_elems<E>()))
      return v;
  }
  return 1;
}

template <class E>
static int tconv_implicit_gemm(IG_PARAMS) {
  if (B < 0 || Nh < 0 || Nw < 0 || Cin < 0 || Oh < 1 || Ow < 1 ||
      Cout < 1 || Kh < 1 || Kw < 1 || sh < 1 || sw < 1 || dh < 1 ||
      dw < 1 || ph < 0 || pw < 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * Nh * Nw * Cin == 0) return (int)cudaSuccess;
  if (th < 1 || tw < 1 || th % sh || tw % sw || th * tw > kMaxThreads ||
      !(chunk == 4 || chunk == 8 || chunk == 16 || chunk == kMaxChunk) ||
      !(cin_t == 1 || cin_t == 2 || cin_t == 3 || cin_t == 4 || cin_t == 8))
    return (int)cudaErrorInvalidValue;
  IGArgs<E> a;
  a.dy = static_cast<const E*>(dy);
  a.w = static_cast<const E*>(w);
  a.dx = static_cast<E*>(dx);
  a.B = B; a.Oh = Oh; a.Ow = Ow; a.Cout = Cout; a.Kh = Kh; a.Kw = Kw;
  a.Cin = Cin; a.Nh = Nh; a.Nw = Nw; a.sh = sh; a.sw = sw; a.ph = ph;
  a.pw = pw; a.dh = dh; a.dw = dw;
  a.th = th; a.tw = tw; a.cu = th / sh; a.cv = tw / sw;
  a.hh = halo_extent(th, sh, ph, dh, Kh);
  a.hw = halo_extent(tw, sw, pw, dw, Kw);
  a.fd_hw = make_fastdiv(a.hw);
  a.tiles_y = (Nh + th - 1) / th;
  a.tiles_x = (Nw + tw - 1) / tw;
  constexpr int kWord = word_elems<E>();
  const long long stage = ((long long)a.hh * a.hw * halo_pitch<E>(chunk) +
                           (long long)Kh * Kw * cin_t * chunk + kWord - 1) /
                          kWord * kWord;
  const long long bytes = sizeof(E) * stage * (Cout > chunk ? 2 : 1);
  const long long tiles = (long long)B * a.tiles_y * a.tiles_x;
  const long long ci_tiles = (Cin + cin_t - 1) / cin_t;
  if (bytes > kSmemBytes || !fits_int(tiles) || ci_tiles > 65535 ||
      !fits_int((long long)B * Nh * Nw * Cin) ||
      !fits_int((long long)B * Oh * Ow * Cout) ||
      !fits_int((long long)Kh * Kw * Cin * Cout))
    return (int)cudaErrorInvalidValue;
  a.stage_elems = (int)stage;
  a.vec = copy_width<E>(Cout, chunk, dy, w);
  a.ep = make_epilogue<E>(bias, act, slope, has_scale, scale);
  const dim3 grid((unsigned)tiles, (unsigned)ci_tiles);
  const int threads = th * tw;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cin_t) {
    case 1: return (int)launch_chunk<1>(chunk, a, grid, threads, bytes, s);
    case 2: return (int)launch_chunk<2>(chunk, a, grid, threads, bytes, s);
    case 3: return (int)launch_chunk<3>(chunk, a, grid, threads, bytes, s);
    case 4: return (int)launch_chunk<4>(chunk, a, grid, threads, bytes, s);
    default: return (int)launch_chunk<8>(chunk, a, grid, threads, bytes, s);
  }
}

// dy (B,Oh,Ow,Cout), w (Kh,Kw,Cin,Cout), bias (Cin,) or null ->
// dx (B,Nh,Nw,Cin); all fp32 (_f32) or all bf16 (_bf16), contiguous.
// The plan (th, tw, cin_t, chunk) comes from
// kernels/implicit_gemm.py::plan.  Returns the launch's CUDA error:
// cudaErrorInvalidValue for a plan or a size it cannot take.
extern "C" int tconv_implicit_gemm_f32(IG_PARAMS) {
  return tconv_implicit_gemm<float>(IG_ARGS);
}

extern "C" int tconv_implicit_gemm_bf16(IG_PARAMS) {
  return tconv_implicit_gemm<__nv_bfloat16>(IG_ARGS);
}

__global__ void empty_kernel() {}

// One launch of a kernel that does nothing, on `stream`: the floor under
// every launch's device time, for the timers of chip_smoke.py.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
