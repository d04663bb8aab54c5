// The backward kernels of a decoder level's glue (glue.cu), for Hopper
// (sm_90a): the vector-Jacobian products of `glue_prep`, `glue_assemble`
// and `glue_finish`, which ops/glue.py's autograd Functions launch in the
// training step. Their plain versions are ops/glue.py's
// `glue_prep_backward`, `glue_assemble_backward` and
// `glue_finish_backward`, written out from autograd's formulas for the
// plain forwards (`glue_prep`, `glue_assemble`, `glue_finish`).
//
// They replace no TPU kernel: the JAX package differentiates this glue as
// array code, and XLA fuses its VJP. Autograd of the plain chain runs each
// op's backward as kernels of its own, several hundred a level; as in the
// forward, neither bytes nor operations bound the glue's VJP on the H100
// (at most ~45 MB a level, at level 1 of d6 384x384 b=3, mostly the
// refiner input's gradient split into the cost volumes'), so each kernel
// is one pass over its outputs, and each output is written by one thread
// (gathers only, no atomics):
//
// 1. `glue_prep_backward`: threads of two kinds in one grid. A thread per
//    pixel and feature cut takes the gradient of the normalised cut of
//    the current and of the previous features (`prep_features`) back
//    through the L2 normalisation, recomputing the cut's sum of squares
//    from the saved features: dx = g r + 2 x (-r^3 / 2) (x . g), or g r
//    where the sum of squares is clamped at 1e-12 (autograd's clamp
//    passes the gradient at the bound itself). A thread per pixel of the
//    deeper level sums the gradients of the fine pixels whose bilinear
//    taps (TFv1 grid, the forward's `lerp_axis`) read it, times their
//    weights: the transpose of the resize, the parallax's doubled.
// 2. `glue_assemble_backward`: a thread per element of the refiner
//    input's gradient writes it, in float32, to the gradient of the map it
//    came from; the log-parallax channels as g / v * lvl_mul with v =
//    x * lvl_mul, where v >= 1e-12 (0 below the log's clamp).
// 3. `glue_finish_backward`: a thread per pixel writes the gradient of the
//    refiner's output: the memory channels' as given; the log parallax's
//    as (g_para + g_depth d depth / d para) d para / d out_0, with d depth
//    / d para = -(rho / para) / para / alpha from the epipolar terms
//    (recomputed as the DSCV kernels compute them) and d para / d out_0 =
//    exp(out_0) / lvl_mul inside [-7, 7], 0 outside (the clip).
//
// Precision: float32 throughout; each gradient rounded once to its
// input's dtype, as autograd rounds it. The features' gradient is first
// rounded to the features' dtype when the cost volumes' dtype differs
// (autograd's cast back), then taken through the normalisation in float32.
// Sums run in other orders than autograd's, so results differ from the
// plain versions by float32 ulps (tests/test_torch_cuda.py holds them to
// it at d6's level shapes).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// the most fine pixels of one axis that read a deeper pixel: two a side
// where the deeper level is at least half the size (the entry point
// refuses smaller ones)
constexpr int kTaps = 8;

// The taps of common.cuh's `lerp_axis` for output index i, without its
// `same` flag: source lo at weight 1 - frac, source hi at weight frac (the
// same index when the border clamps), or i itself where the axis keeps its
// size.
struct Taps {
  int lo, hi;
  float frac;
};

__device__ __forceinline__ Taps lerp_taps(int i, int src, int dst,
                                          float scale) {
  Taps a;
  if (src == dst) {
    a.lo = a.hi = i;
    a.frac = 0.f;
    return a;
  }
  const float pos =
      fminf(fmaxf(__fmul_rn((float)i, scale), 0.f), (float)(src - 1));
  a.lo = min((int)floorf(pos), src - 1);
  a.hi = min(a.lo + 1, src - 1);
  a.frac = __fsub_rn(pos, (float)a.lo);
  return a;
}

// The fine indices of one axis (dst of them) whose taps read source index
// j, with the summed weight of each: at most kTaps. Returns their number.
__device__ __forceinline__ int taps_of(int j, int src, int dst, float scale,
                                       int* idx, float* wt) {
  if (src == dst) {
    idx[0] = j;
    wt[0] = 1.f;
    return 1;
  }
  // i * scale lies in [j - 1, j + 1] for every tap; one index of margin
  // each side for the float32 rounding of the product
  const int i0 = max(0, (int)floorf((float)(j - 1) / scale) - 1);
  const int i1 = min(dst - 1, (int)ceilf((float)(j + 1) / scale) + 1);
  int n = 0;
  for (int i = i0; i <= i1 && n < kTaps; ++i) {
    const Taps a = lerp_taps(i, src, dst, scale);
    const float w = (a.lo == j ? 1.f - a.frac : 0.f) +
                    (a.hi == j ? a.frac : 0.f);
    if (a.lo == j || a.hi == j) {
      idx[n] = i;
      wt[n] = w;
      ++n;
    }
  }
  return n;
}

// The gradient of one normalised cut of n values: g (in the cost volumes'
// dtype Tcv) back to the features x (Tin) through `prep_features`, or,
// without the normalisation, g rounded to Tin. VEC values a load.
template <typename Tin, typename Tcv, int VEC>
__device__ __forceinline__ void cut_backward(const Tcv* __restrict__ g,
                                             const Tin* __restrict__ x,
                                             Tin* __restrict__ dx, int n,
                                             bool normalize) {
  float r = 1.f, k = 0.f;
  if (normalize) {
    float sq = 0.f, xg = 0.f;
    for (int i = 0; i < n; i += VEC) {
      float xv[VEC], gv[VEC];
      Vec<Tin, VEC>::load(x + i, xv);
      Vec<Tcv, VEC>::load(g + i, gv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float gj = round_to<Tin>(gv[j]);
        sq = __fadd_rn(sq, __fmul_rn(xv[j], xv[j]));
        xg = __fadd_rn(xg, __fmul_rn(gj, xv[j]));
      }
    }
    r = rsqrtf(sq < 1e-12f ? 1e-12f : sq);
    // d/d sq of rsqrt(clamp(sq)), times the gradient of r: 0 where the
    // clamp holds below its bound
    k = sq >= 1e-12f ? __fmul_rn(xg, -0.5f * r * r * r) : 0.f;
  }
  for (int i = 0; i < n; i += VEC) {
    float xv[VEC], gv[VEC];
    Vec<Tcv, VEC>::load(g + i, gv);
    if (normalize) Vec<Tin, VEC>::load(x + i, xv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float gj = round_to<Tin>(gv[j]);
      gv[j] = normalize ? __fadd_rn(__fmul_rn(gj, r),
                                    2.f * __fmul_rn(xv[j], k))
                        : gj;
    }
    Vec<Tin, VEC>::store(dx + i, gv);
  }
}

// Threads [0, n_feat): pixel t / cuts, cut t % cuts of the features'
// gradients (n_feat 0: none wanted). Threads [n_feat, n_feat + n_coarse):
// pixel of the deeper level (n_coarse 0: none wanted). A null gradient
// pointer: that gradient is not wanted (its output is null too).
template <typename Tin, typename Tcv, int VEC>
__global__ void __launch_bounds__(kThreads)
glue_prep_backward_kernel(
    const Tcv* __restrict__ g_curr, const Tcv* __restrict__ g_prev,
    const Tin* __restrict__ curr_f, const Tin* __restrict__ prev_f,
    const float* __restrict__ g_depth, const float* __restrict__ g_para,
    const float* __restrict__ g_other, Tin* __restrict__ d_curr,
    Tin* __restrict__ d_prev, float* __restrict__ d_depth,
    float* __restrict__ d_para, float* __restrict__ d_other,
    long long n_feat, long long n_coarse, int h, int w, int C, int cuts,
    int hd, int wd, int n_other, bool normalize, float scale_y,
    float scale_x) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n_feat) {
    const long long p = t / cuts;
    const int k = (int)(t - p * cuts);
    const int cc = C / cuts;
    const long long off = p * C + (long long)k * cc;
    if (g_curr != nullptr)
      cut_backward<Tin, Tcv, VEC>(g_curr + off, curr_f + off, d_curr + off,
                                  cc, normalize);
    if (g_prev != nullptr)
      cut_backward<Tin, Tcv, VEC>(g_prev + off, prev_f + off, d_prev + off,
                                  cc, normalize);
    return;
  }
  const long long q = t - n_feat;
  if (q >= n_coarse) return;
  const int jx = (int)(q % wd);
  const long long row = q / wd;
  const int jy = (int)(row % hd);
  const long long bi = row / hd;
  int iy[kTaps], ix[kTaps];
  float wy[kTaps], wx[kTaps];
  const int ny = taps_of(jy, hd, h, scale_y, iy, wy);
  const int nx = taps_of(jx, wd, w, scale_x, ix, wx);
  // the fine map's rows are resampled along the height first, then the
  // width (resize_bilinear_v1): the transpose sums the width's taps first
  const long long img = bi * h * w;
  auto gather = [&](const float* __restrict__ g, int n, int ch) {
    float acc = 0.f;
    for (int a = 0; a < ny; ++a) {
      float row_acc = 0.f;
      for (int c = 0; c < nx; ++c)
        row_acc = __fadd_rn(
            row_acc,
            __fmul_rn(g[(img + (long long)iy[a] * w + ix[c]) * n + ch],
                      wx[c]));
      acc = __fadd_rn(acc, __fmul_rn(row_acc, wy[a]));
    }
    return acc;
  };
  if (g_depth != nullptr) d_depth[q] = gather(g_depth, 1, 0);
  if (g_para != nullptr) d_para[q] = 2.f * gather(g_para, 1, 0);
  if (g_other != nullptr)
    for (int c = 0; c < n_other; ++c)
      d_other[q * n_other + c] = gather(g_other, n_other, c);
}

// d/dx of log(clamp(x * mul, min=1e-12)) times g, as autograd takes it.
__device__ __forceinline__ float log_safe_backward(float x, float g,
                                                   float mul) {
  const float v = __fmul_rn(x, mul);
  return v >= 1e-12f ? __fmul_rn(g / v, mul) : 0.f;
}

// Element e of the refiner input's gradient [n_pix, n]: channel c of
// pixel e / n, to the gradient of its map (a null one: not wanted).
template <typename T>
__global__ void __launch_bounds__(kThreads)
glue_assemble_backward_kernel(const T* __restrict__ g,
                              const float* __restrict__ para,
                              const float* __restrict__ reproj,
                              float* __restrict__ d_cv,
                              float* __restrict__ d_para,
                              float* __restrict__ d_other,
                              float* __restrict__ d_sncv,
                              float* __restrict__ d_reproj, int n_out, int n,
                              int n_cv, int n_other, int n_sncv,
                              float lvl_mul) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  const int p = e / n;
  int c = e - p * n;
  const float v = to_float(g[e]);
  if (c < n_cv) {
    if (d_cv != nullptr) d_cv[(long long)p * n_cv + c] = v;
  } else if (c == n_cv) {
    if (d_para != nullptr) d_para[p] = log_safe_backward(para[p], v, lvl_mul);
  } else if ((c -= n_cv + 1) < n_other) {
    if (d_other != nullptr) d_other[(long long)p * n_other + c] = v;
  } else if ((c -= n_other) < n_sncv) {
    if (d_sncv != nullptr) d_sncv[(long long)p * n_sncv + c] = v;
  } else if (d_reproj != nullptr) {
    d_reproj[p] = log_safe_backward(reproj[p], v, lvl_mul);
  }
}

// Pixel p: the gradient of the refiner's output out[p] (in Tin) from the
// gradients of the depth, the parallax and the memory (null: zero).
template <typename Tin>
__global__ void __launch_bounds__(kThreads)
glue_finish_backward_kernel(const float* __restrict__ g_depth,
                            const float* __restrict__ g_para,
                            const float* __restrict__ g_other,
                            const Tin* __restrict__ out,
                            const float* __restrict__ rot,
                            const float* __restrict__ trans,
                            const float* __restrict__ focal,
                            const float* __restrict__ principal,
                            Tin* __restrict__ d_out, long long n_pix, int h,
                            int w, int n_other, int rot_dim, float lvl_mul) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  const long long base = p * (1 + n_other);
  const float o0 = to_float(out[base]);
  const float ex = expf(clamp_nan(o0, -7.f, 7.f));
  const float pa = ex / lvl_mul;
  float gp = g_para != nullptr ? g_para[p] : 0.f;
  if (g_depth != nullptr) {
    const int x = (int)(p % w);
    const long long row = p / w;
    const int y = (int)(row % h);
    const long long bi = row / h;
    const Epipolar e =
        epipolar(rot, trans, focal, principal, bi, rot_dim, x, y);
    // depth = (rho / pa - t_z) / alpha
    const float gq = g_depth[p] / e.alpha;
    gp = __fsub_rn(gp, __fmul_rn(gq, (e.rho / pa) / pa));
  }
  const bool inside = o0 >= -7.f && o0 <= 7.f;
  d_out[base] = from_float<Tin>(inside ? __fmul_rn(gp / lvl_mul, ex) : 0.f);
  for (int c = 0; c < n_other; ++c)
    d_out[base + 1 + c] =
        from_float<Tin>(g_other != nullptr ? g_other[p * n_other + c] : 0.f);
}

unsigned blocks_for(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

template <typename Tin, typename Tcv>
cudaError_t launch_prep_backward(
    const void* g_curr, const void* g_prev, const void* curr_f,
    const void* prev_f, const void* g_depth, const void* g_para,
    const void* g_other, void* d_curr, void* d_prev, void* d_depth,
    void* d_para, void* d_other, long long n_feat, long long n_coarse, int h,
    int w, int C, int cuts, int hd, int wd, int n_other, bool normalize,
    float scale_y, float scale_x, cudaStream_t s) {
  const long long threads = n_feat + n_coarse;
  if (threads == 0) return cudaSuccess;
  if (threads > (long long)INT_MAX * kThreads) return cudaErrorInvalidValue;
  bool vec = (C / cuts) % 4 == 0;
  for (const void* ptr : {g_curr, g_prev, curr_f, prev_f,
                          static_cast<const void*>(d_curr),
                          static_cast<const void*>(d_prev)})
    vec = vec && (ptr == nullptr || aligned16(ptr));
  auto kernel = vec ? glue_prep_backward_kernel<Tin, Tcv, 4>
                    : glue_prep_backward_kernel<Tin, Tcv, 1>;
  kernel<<<blocks_for(threads), kThreads, 0, s>>>(
      static_cast<const Tcv*>(g_curr), static_cast<const Tcv*>(g_prev),
      static_cast<const Tin*>(curr_f), static_cast<const Tin*>(prev_f),
      static_cast<const float*>(g_depth), static_cast<const float*>(g_para),
      static_cast<const float*>(g_other), static_cast<Tin*>(d_curr),
      static_cast<Tin*>(d_prev), static_cast<float*>(d_depth),
      static_cast<float*>(d_para), static_cast<float*>(d_other), n_feat,
      n_coarse, h, w, C, cuts, hd, wd, n_other, normalize, scale_y, scale_x);
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t launch_prep_backward_in(
    int cv_dtype, const void* g_curr, const void* g_prev, const void* curr_f,
    const void* prev_f, const void* g_depth, const void* g_para,
    const void* g_other, void* d_curr, void* d_prev, void* d_depth,
    void* d_para, void* d_other, long long n_feat, long long n_coarse, int h,
    int w, int C, int cuts, int hd, int wd, int n_other, bool normalize,
    float scale_y, float scale_x, cudaStream_t s) {
#define GLUE_PREP_BACKWARD_ARGS                                              \
  g_curr, g_prev, curr_f, prev_f, g_depth, g_para, g_other, d_curr, d_prev, \
      d_depth, d_para, d_other, n_feat, n_coarse, h, w, C, cuts, hd, wd,    \
      n_other, normalize, scale_y, scale_x, s
  switch (cv_dtype) {
    case kFloat32:
      return launch_prep_backward<Tin, float>(GLUE_PREP_BACKWARD_ARGS);
    case kBFloat16:
      return launch_prep_backward<Tin, __nv_bfloat16>(
          GLUE_PREP_BACKWARD_ARGS);
    case kFloat16:
      return launch_prep_backward<Tin, __half>(GLUE_PREP_BACKWARD_ARGS);
    default:
      return cudaErrorInvalidValue;
  }
#undef GLUE_PREP_BACKWARD_ARGS
}

}  // namespace

// The gradients of glue_prep's inputs from those of its outputs. g_curr,
// g_prev: [b, h, w, C] in cv_dtype (0 float32, 1 bfloat16, 2 float16), the
// gradients of curr_p and prev_p, each null when not wanted (with d_curr,
// d_prev); curr_f, prev_f: the forward's features [b, h, w, C] in
// in_dtype (0 float32, 1 bfloat16), and d_curr, d_prev their gradients in
// in_dtype; normalize as in the forward. g_depth, g_para [b, h, w, 1] and
// g_other [b, h, w, n_other] float32, the gradients of the deeper
// estimate at this size, each null when not wanted (with its output);
// d_depth, d_para [b, hd, wd, 1] and d_other [b, hd, wd, n_other] float32,
// those of the deeper estimate, with scale_y = hd / h and scale_x = wd / w
// as the forward's; the deeper level at least half this one's size (h <=
// 2 hd, w <= 2 wd). All contiguous, on the device of `stream`. Returns
// the CUDA error code of the launch (0 on success).
extern "C" int glue_prep_backward(
    const void* g_curr, const void* g_prev, const void* curr_f,
    const void* prev_f, const void* g_depth, const void* g_para,
    const void* g_other, void* d_curr, void* d_prev, void* d_depth,
    void* d_para, void* d_other, int b, int h, int w, int C, int cuts,
    int hd, int wd, int n_other, int normalize, float scale_y, float scale_x,
    int in_dtype, int cv_dtype, void* stream) {
  const bool feat = g_curr != nullptr || g_prev != nullptr;
  const bool deep =
      g_depth != nullptr || g_para != nullptr || g_other != nullptr;
  if (b <= 0 || h <= 0 || w <= 0 || cuts <= 0 || C % cuts != 0 ||
      n_other < 0 || (g_curr == nullptr) != (d_curr == nullptr) ||
      (g_prev == nullptr) != (d_prev == nullptr) ||
      (g_depth == nullptr) != (d_depth == nullptr) ||
      (g_para == nullptr) != (d_para == nullptr) ||
      (g_other == nullptr) != (d_other == nullptr) ||
      (deep && (hd <= 0 || wd <= 0 || hd > h || wd > w || h > 2 * hd ||
                w > 2 * wd)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_feat = feat ? (long long)b * h * w * cuts : 0;
  const long long n_coarse = deep ? (long long)b * hd * wd : 0;
#define GLUE_PREP_BACKWARD_ARGS                                              \
  cv_dtype, g_curr, g_prev, curr_f, prev_f, g_depth, g_para, g_other,       \
      d_curr, d_prev, d_depth, d_para, d_other, n_feat, n_coarse, h, w, C,  \
      cuts, hd, wd, n_other, normalize != 0, scale_y, scale_x, s
  switch (in_dtype) {
    case kFloat32:
      return (int)launch_prep_backward_in<float>(GLUE_PREP_BACKWARD_ARGS);
    case kBFloat16:
      return (int)launch_prep_backward_in<__nv_bfloat16>(
          GLUE_PREP_BACKWARD_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GLUE_PREP_BACKWARD_ARGS
}

// The gradients of glue_assemble's float32 inputs from that of the
// refiner's input, g [n_pix, n] in g_dtype (0 float32, 1 bfloat16), n =
// n_cv + 1 + n_other + n_sncv + time_recurr: d_cv [n_pix, n_cv], d_para
// [n_pix, 1], d_other [n_pix, n_other], d_sncv [n_pix, n_sncv] and
// d_reproj [n_pix, 1], float32, each null when not wanted (or, for
// d_other, d_sncv and d_reproj, when n_other, n_sncv or time_recurr is 0);
// para and reproj the forward's parallax maps (reproj null without
// time_recurr). Contiguous, on the device of `stream`. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int glue_assemble_backward(const void* g, const void* para,
                                      const void* reproj, void* d_cv,
                                      void* d_para, void* d_other,
                                      void* d_sncv, void* d_reproj,
                                      int n_pix, int n_cv, int n_other,
                                      int n_sncv, int time_recurr,
                                      float lvl_mul, int g_dtype,
                                      void* stream) {
  const long long n = (long long)n_cv + 1 + n_other + n_sncv + time_recurr;
  const long long n_out = (long long)n_pix * n;
  if (n_pix <= 0 || n_cv < 0 || n_other < 0 || n_sncv < 0 ||
      (time_recurr != 0 && time_recurr != 1) || n_out > INT_MAX ||
      (d_para != nullptr && para == nullptr) ||
      (d_reproj != nullptr && (reproj == nullptr || time_recurr == 0)) ||
      (d_other != nullptr && n_other == 0) ||
      (d_sncv != nullptr && n_sncv == 0))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GLUE_ASSEMBLE_BACKWARD_ARGS(T)                                       \
  static_cast<const T*>(g), static_cast<const float*>(para),               \
      static_cast<const float*>(reproj), static_cast<float*>(d_cv),        \
      static_cast<float*>(d_para), static_cast<float*>(d_other),           \
      static_cast<float*>(d_sncv), static_cast<float*>(d_reproj),          \
      (int)n_out, (int)n, n_cv, n_other, n_sncv, lvl_mul
  switch (g_dtype) {
    case kFloat32:
      glue_assemble_backward_kernel<float>
          <<<blocks_for(n_out), kThreads, 0, s>>>(
              GLUE_ASSEMBLE_BACKWARD_ARGS(float));
      break;
    case kBFloat16:
      glue_assemble_backward_kernel<__nv_bfloat16>
          <<<blocks_for(n_out), kThreads, 0, s>>>(
              GLUE_ASSEMBLE_BACKWARD_ARGS(__nv_bfloat16));
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GLUE_ASSEMBLE_BACKWARD_ARGS
  return (int)cudaGetLastError();
}

// The gradient d_out [b, h, w, 1 + n_other] (in_dtype: 0 float32, 1
// bfloat16) of glue_finish's input out (the same shape and dtype) from
// the gradients of its depth and parallax [b, h, w, 1] and memory [b, h,
// w, n_other], float32, each null when zero; without a reset. rot [b,
// rot_dim] (3 or 4), trans [b, 3], focal and principal [b, 2] float32, the
// forward's motion and level intrinsics. Contiguous, on the device of
// `stream`. Returns the CUDA error code of the launch (0 on success).
extern "C" int glue_finish_backward(const void* g_depth, const void* g_para,
                                    const void* g_other, const void* out,
                                    const void* rot, const void* trans,
                                    const void* focal, const void* principal,
                                    void* d_out, int b, int h, int w,
                                    int n_other, int rot_dim, float lvl_mul,
                                    int in_dtype, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || n_other < 0 ||
      (rot_dim != 3 && rot_dim != 4))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_pix = (long long)b * h * w;
#define GLUE_FINISH_BACKWARD_ARGS(T)                                         \
  static_cast<const float*>(g_depth), static_cast<const float*>(g_para),   \
      static_cast<const float*>(g_other), static_cast<const T*>(out),      \
      static_cast<const float*>(rot), static_cast<const float*>(trans),    \
      static_cast<const float*>(focal),                                    \
      static_cast<const float*>(principal), static_cast<T*>(d_out), n_pix, \
      h, w, n_other, rot_dim, lvl_mul
  switch (in_dtype) {
    case kFloat32:
      glue_finish_backward_kernel<float>
          <<<blocks_for(n_pix), kThreads, 0, s>>>(
              GLUE_FINISH_BACKWARD_ARGS(float));
      break;
    case kBFloat16:
      glue_finish_backward_kernel<__nv_bfloat16>
          <<<blocks_for(n_pix), kThreads, 0, s>>>(
              GLUE_FINISH_BACKWARD_ARGS(__nv_bfloat16));
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GLUE_FINISH_BACKWARD_ARGS
  return (int)cudaGetLastError();
}

extern "C" const char* glue_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
