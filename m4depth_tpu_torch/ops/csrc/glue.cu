// A decoder level's glue in the no-grad frame, as three kernels for Hopper
// (sm_90a): everything `DecoderLevel.forward` (models/decoder.py) computes
// around its two cost volumes and its refiner. Their plain versions are
// ops/glue.py's `glue_prep`, `glue_assemble` and `glue_finish`.
//
// They replace no TPU kernel: the JAX package writes this glue as array
// code (m4depth_tpu/models/decoder.py), and XLA fuses it there. In the port
// each tensor op of the plain chain is a kernel of its own, about 200 a
// level, captured one by one into the serving frame's CUDA graph. What
// bounds the glue on the H100 is therefore neither bytes nor operations: a
// level reads and writes at most ~20 MB (level 1 of d6 384x384 at b=3,
// 6 us at 3.35 TB/s) and computes a few hundred float32 operations a pixel.
// Each launch costs a few us whatever it does. So the design is the fewest
// launches, each one pass over its pixels:
//
// 1. `glue_prep` (before the cost volumes): a thread per pixel and feature
//    cut. Each thread L2-normalises its cut of the current and of the
//    previous features (`prep_features`: float32 sums, rounded to the
//    features' dtype, then to the cost volumes'), 4 values a load where
//    the cut allows. The first thread of a pixel also writes the deeper
//    estimate at this level's size (TFv1 bilinear grid, parallax doubled;
//    the constants at the deepest level) and the previous depth's parallax
//    (`prev_depth_to_parallax`, rounded as `round_parallax` does). Block 0
//    writes the level's intrinsics (f and c over 2**level), which the DSCV
//    kernel and `glue_finish` read, so no camera, pixel grid or rotation
//    tensor is built.
// 2. `glue_assemble` (between the cost volumes and the refiner): a thread
//    per element of the refiner's input, in the reference's channel order
//    (cost volume, log parallax, memory, SNCV, log warped parallax), each
//    rounded once to the convs' dtype.
// 3. `glue_finish` (after the refiner): a thread per pixel reads the
//    refiner's output in its own dtype and writes the parallax, the depth
//    (the epipolar terms inline, as the DSCV kernels compute them), the
//    memory channels, the masks of a trajectory reset, and the depth the
//    next frame reads.
//
// Precision: float32 throughout, with the plain chain's roundings at the
// same points. Where the plain chain is a sequence of tensor ops, each
// product, sum and difference here is rounded on its own (`__fmul_rn` and
// friends, which the compiler never contracts into an FMA), so those steps
// match the plain version's bit for bit; `logf`, `expf` and `sqrtf` and
// division are the correctly rounded or faithful float32 functions that
// ATen's kernels call. The sums of squares run in another order than
// ATen's reduction, `rsqrtf` is CUDA's approximation, and the depth's
// epipolar terms are the DSCV kernels' (contracted), so those differ from
// the plain version by float32 ulps (tests/test_torch_cuda.py holds them to
// it at d6's level shapes).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// geometry/parallax.py::prev_depth_to_parallax at pixel (x, y) of image bi,
// with the level's intrinsics (fx, fy, cx, cy): the pixel ray
// ((x + 0.5 - cx) / fx, ...) times f, delta = (t f - t_z ray f) / (depth -
// t_z), its norm.
__device__ __forceinline__ float prev_parallax(float depth,
                                               const float* __restrict__ trans,
                                               long long bi, float fx,
                                               float fy, float cx, float cy,
                                               int x, int y) {
  const float tx = trans[3 * bi], ty = trans[3 * bi + 1];
  const float tz = trans[3 * bi + 2];
  const float chx = __fmul_rn(__fsub_rn((float)x + 0.5f, cx) / fx, fx);
  const float chy = __fmul_rn(__fsub_rn((float)y + 0.5f, cy) / fy, fy);
  const float den = __fsub_rn(depth, tz);
  const float dx = __fsub_rn(__fmul_rn(tx, fx), __fmul_rn(tz, chx)) / den;
  const float dy = __fsub_rn(__fmul_rn(ty, fy), __fmul_rn(tz, chy)) / den;
  return sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
}

// ops/cost_volume.py::round_parallax: float16 clamps to its finite range
// first, so that a huge parallax does not become inf.
template <typename T>
__device__ __forceinline__ T round_parallax(float v) {
  if (std::is_same<T, __half>::value) v = clamp_nan(v, -65504.f, 65504.f);
  return from_float<T>(v);
}

// One cut of n values from src to dst: per-cut L2-normalised in float32
// and rounded to Tin (prep_features), or copied, then rounded to Tcv. VEC
// values a load and a store (4, where n and the pointers allow, or 1).
template <typename Tin, typename Tcv, int VEC>
__device__ __forceinline__ void prep_cut(const Tin* __restrict__ src,
                                         Tcv* __restrict__ dst, int n,
                                         bool normalize) {
  float scale = 1.f;
  if (normalize) {
    float sq = 0.f;
    for (int i = 0; i < n; i += VEC) {
      float v[VEC];
      Vec<Tin, VEC>::load(src + i, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) sq = __fadd_rn(sq, __fmul_rn(v[j], v[j]));
    }
    scale = rsqrtf(sq < 1e-12f ? 1e-12f : sq);
  }
  for (int i = 0; i < n; i += VEC) {
    float v[VEC];
    Vec<Tin, VEC>::load(src + i, v);
    if (normalize) {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        v[j] = round_to<Tin>(__fmul_rn(v[j], scale));
    }
    Vec<Tcv, VEC>::store(dst + i, v);
  }
}

// Thread t: pixel t / cuts, cut t % cuts; the first thread of a pixel also
// writes its scalars. prev_f (and curr_p, prev_p) null: no features (a
// level without memory); prev_depth null: no parallax; deep_* null: the
// deepest level.
template <typename Tin, typename Tcv, int VEC>
__global__ void __launch_bounds__(kThreads)
glue_prep_kernel(const Tin* __restrict__ curr_f, const Tin* __restrict__ prev_f,
                 const float* __restrict__ prev_depth,
                 const float* __restrict__ deep_depth,
                 const float* __restrict__ deep_para,
                 const float* __restrict__ deep_other,
                 const float* __restrict__ trans,
                 const float* __restrict__ focal,
                 const float* __restrict__ principal, float* __restrict__ cam,
                 float* __restrict__ up_depth, float* __restrict__ up_para,
                 float* __restrict__ up_other, Tcv* __restrict__ curr_p,
                 Tcv* __restrict__ prev_p, Tcv* __restrict__ para_out, int b,
                 int h, int w, int C, int cuts, int hd, int wd, int n_other,
                 bool normalize, float factor, float scale_y, float scale_x,
                 float init_depth) {
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < 4 * b; i += blockDim.x)
      cam[i] = (i < 2 * b ? focal[i] : principal[i - 2 * b]) / factor;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_pix = (long long)b * h * w;
  if (t >= n_pix * cuts) return;
  const long long p = t / cuts;
  const int k = (int)(t - p * cuts);
  if (prev_f != nullptr) {
    const int cc = C / cuts;
    const long long off = p * C + (long long)k * cc;
    prep_cut<Tin, Tcv, VEC>(curr_f + off, curr_p + off, cc, normalize);
    prep_cut<Tin, Tcv, VEC>(prev_f + off, prev_p + off, cc, normalize);
  }
  if (k != 0) return;
  const int x = (int)(p % w);
  const long long row = p / w;
  const int y = (int)(row % h);
  const long long bi = row / h;
  if (deep_depth == nullptr) {
    up_depth[p] = init_depth;
    up_para[p] = 1.f;
    for (int c = 0; c < n_other; ++c) up_other[p * n_other + c] = 0.f;
  } else {
    const Axis ay = lerp_axis(y, hd, h, scale_y);
    const Axis ax = lerp_axis(x, wd, w, scale_x);
    const long long img = bi * hd * wd;
    up_depth[p] = upsample(deep_depth + img, wd, 1, 0, ay, ax);
    up_para[p] = __fmul_rn(upsample(deep_para + img, wd, 1, 0, ay, ax), 2.f);
    for (int c = 0; c < n_other; ++c)
      up_other[p * n_other + c] =
          upsample(deep_other + img * n_other, wd, n_other, c, ay, ax);
  }
  if (prev_depth != nullptr) {
    const float fx = focal[2 * bi] / factor, fy = focal[2 * bi + 1] / factor;
    const float cx = principal[2 * bi] / factor;
    const float cy = principal[2 * bi + 1] / factor;
    para_out[p] = round_parallax<Tcv>(
        prev_parallax(prev_depth[p], trans, bi, fx, fy, cx, cy, x, y));
  }
}

// Element e of the refiner's input [n_pix, n]: channel c of pixel e / n.
template <typename T>
__global__ void __launch_bounds__(kThreads)
glue_assemble_kernel(const float* __restrict__ cv,
                     const float* __restrict__ para,
                     const float* __restrict__ other,
                     const float* __restrict__ sncv,
                     const float* __restrict__ reproj, T* __restrict__ out,
                     int n_out, int n, int n_cv, int n_other, int n_sncv,
                     float lvl_mul) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  const int p = e / n;
  int c = e - p * n;
  float v;
  if (c < n_cv) {
    v = cv[(long long)p * n_cv + c];
  } else if (c == n_cv) {
    v = log_safe(para[p], lvl_mul);
  } else if ((c -= n_cv + 1) < n_other) {
    v = other[(long long)p * n_other + c];
  } else if ((c -= n_other) < n_sncv) {
    v = sncv[(long long)p * n_sncv + c];
  } else {
    v = log_safe(reproj[p], lvl_mul);
  }
  out[e] = from_float<T>(v);
}

// Pixel p: the refiner's output out[p] = (log parallax, memory...) in Tin.
// new_traj null: no reset (and no state_depth: the caller reads depth).
template <typename Tin>
__global__ void __launch_bounds__(kThreads)
glue_finish_kernel(const Tin* __restrict__ out,
                   const float* __restrict__ prev_depth,
                   const float* __restrict__ prev_para,
                   const float* __restrict__ prev_other,
                   const unsigned char* __restrict__ new_traj,
                   const float* __restrict__ rot,
                   const float* __restrict__ trans,
                   const float* __restrict__ focal,
                   const float* __restrict__ principal,
                   float* __restrict__ depth, float* __restrict__ para,
                   float* __restrict__ other, float* __restrict__ state_depth,
                   long long n_pix, int h, int w, int n_other, int rot_dim,
                   float lvl_mul, float init_depth) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  const int x = (int)(p % w);
  const long long row = p / w;
  const int y = (int)(row % h);
  const long long bi = row / h;
  const Tin* o = out + p * (1 + n_other);
  const float pa = expf(clamp_nan(to_float(o[0]), -7.f, 7.f)) / lvl_mul;
  const Epipolar e = epipolar(rot, trans, focal, principal, bi, rot_dim, x, y);
  const float d = (e.rho / pa - trans[3 * bi + 2]) / e.alpha;
  const bool reset = new_traj != nullptr && new_traj[bi] != 0;
  depth[p] = reset ? prev_depth[p] : d;
  para[p] = reset ? prev_para[p] : pa;
  for (int c = 0; c < n_other; ++c)
    other[p * n_other + c] =
        reset ? prev_other[p * n_other + c] : to_float(o[1 + c]);
  if (state_depth != nullptr) state_depth[p] = reset ? init_depth : d;
}

unsigned blocks_for(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

template <typename Tin, typename Tcv>
cudaError_t launch_prep(const void* curr_f, const void* prev_f,
                        const void* prev_depth, const void* deep_depth,
                        const void* deep_para, const void* deep_other,
                        const void* trans, const void* focal,
                        const void* principal, void* cam, void* up_depth,
                        void* up_para, void* up_other, void* curr_p,
                        void* prev_p, void* para_out, int b, int h, int w,
                        int C, int cuts, int hd, int wd, int n_other,
                        bool normalize, float factor, float scale_y,
                        float scale_x, float init_depth, cudaStream_t s) {
  const long long threads = (long long)b * h * w * cuts;
  if (threads > (long long)INT_MAX * kThreads) return cudaErrorInvalidValue;
  const bool vec = (C / cuts) % 4 == 0 && aligned16(curr_f) &&
                   aligned16(curr_p) && (prev_f == nullptr ||
                                         (aligned16(prev_f) &&
                                          aligned16(prev_p)));
  auto kernel =
      vec ? glue_prep_kernel<Tin, Tcv, 4> : glue_prep_kernel<Tin, Tcv, 1>;
  kernel<<<blocks_for(threads), kThreads, 0, s>>>(
      static_cast<const Tin*>(curr_f), static_cast<const Tin*>(prev_f),
      static_cast<const float*>(prev_depth),
      static_cast<const float*>(deep_depth),
      static_cast<const float*>(deep_para),
      static_cast<const float*>(deep_other),
      static_cast<const float*>(trans), static_cast<const float*>(focal),
      static_cast<const float*>(principal), static_cast<float*>(cam),
      static_cast<float*>(up_depth), static_cast<float*>(up_para),
      static_cast<float*>(up_other), static_cast<Tcv*>(curr_p),
      static_cast<Tcv*>(prev_p), static_cast<Tcv*>(para_out), b, h, w, C,
      cuts, hd, wd, n_other, normalize, factor, scale_y, scale_x,
      init_depth);
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t launch_prep_in(int cv_dtype, const void* curr_f,
                           const void* prev_f, const void* prev_depth,
                           const void* deep_depth, const void* deep_para,
                           const void* deep_other, const void* trans,
                           const void* focal, const void* principal,
                           void* cam, void* up_depth, void* up_para,
                           void* up_other, void* curr_p, void* prev_p,
                           void* para_out, int b, int h, int w, int C,
                           int cuts, int hd, int wd, int n_other,
                           bool normalize, float factor, float scale_y,
                           float scale_x, float init_depth, cudaStream_t s) {
#define GLUE_PREP_ARGS                                                      \
  curr_f, prev_f, prev_depth, deep_depth, deep_para, deep_other, trans,    \
      focal, principal, cam, up_depth, up_para, up_other, curr_p, prev_p,  \
      para_out, b, h, w, C, cuts, hd, wd, n_other, normalize, factor,      \
      scale_y, scale_x, init_depth, s
  switch (cv_dtype) {
    case kFloat32:
      return launch_prep<Tin, float>(GLUE_PREP_ARGS);
    case kBFloat16:
      return launch_prep<Tin, __nv_bfloat16>(GLUE_PREP_ARGS);
    case kFloat16:
      return launch_prep<Tin, __half>(GLUE_PREP_ARGS);
    default:
      return cudaErrorInvalidValue;
  }
#undef GLUE_PREP_ARGS
}

}  // namespace

// The glue before a level's cost volumes. curr_f, prev_f: [b, h, w, C] in
// in_dtype (0 float32, 1 bfloat16); prev_f null when the level has no
// memory (then curr_p, prev_p, prev_depth and para_out are not read or
// written either). prev_depth: [b, h, w, 1] float32, or null (no
// para_out). deep_depth, deep_para: [b, hd, wd, 1], deep_other: [b, hd,
// wd, n_other], float32, the deeper level's estimate, all null at the
// deepest level; scale_y = hd / h and scale_x = wd / w as float32.
// trans: [b, 3], focal, principal: [b, 2], float32, at full resolution;
// factor: 2**level. Outputs: cam [2, b, 2] float32 (focal, principal over
// factor); up_depth, up_para [b, h, w, 1] and up_other [b, h, w, n_other]
// float32; curr_p, prev_p [b, h, w, C] and para_out [b, h, w, 1] in
// cv_dtype (0, 1 or 2 = float16). All contiguous, on the device of
// `stream`. Returns the CUDA error code of the launch (0 on success).
extern "C" int glue_prep(const void* curr_f, const void* prev_f,
                         const void* prev_depth, const void* deep_depth,
                         const void* deep_para, const void* deep_other,
                         const void* trans, const void* focal,
                         const void* principal, void* cam, void* up_depth,
                         void* up_para, void* up_other, void* curr_p,
                         void* prev_p, void* para_out, int b, int h, int w,
                         int C, int cuts, int hd, int wd, int n_other,
                         int normalize, float factor, float scale_y,
                         float scale_x, float init_depth, int in_dtype,
                         int cv_dtype, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || cuts <= 0 || C % cuts != 0 ||
      n_other < 0 || (deep_depth != nullptr && (hd <= 0 || wd <= 0)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GLUE_PREP_ARGS                                                      \
  cv_dtype, curr_f, prev_f, prev_depth, deep_depth, deep_para, deep_other, \
      trans, focal, principal, cam, up_depth, up_para, up_other, curr_p,   \
      prev_p, para_out, b, h, w, C, cuts, hd, wd, n_other, normalize != 0, \
      factor, scale_y, scale_x, init_depth, s
  switch (in_dtype) {
    case kFloat32:
      return (int)launch_prep_in<float>(GLUE_PREP_ARGS);
    case kBFloat16:
      return (int)launch_prep_in<__nv_bfloat16>(GLUE_PREP_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GLUE_PREP_ARGS
}

// The refiner's input f_input [n_pix, n] in out_dtype (0 float32, 1
// bfloat16) from float32 maps: cv [n_pix, n_cv], para [n_pix, 1], other
// [n_pix, n_other] (n_other 0: left out), sncv [n_pix, n_sncv] (0: left
// out) and reproj [n_pix, 1] (time_recurr 0: left out), with n = n_cv + 1
// + n_other + n_sncv + time_recurr; the parallax channels as log(max(x *
// lvl_mul, 1e-12)). Contiguous, on the device of `stream`. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int glue_assemble(const void* cv, const void* para,
                             const void* other, const void* sncv,
                             const void* reproj, void* out, int n_pix,
                             int n_cv, int n_other, int n_sncv,
                             int time_recurr, float lvl_mul, int out_dtype,
                             void* stream) {
  const long long n = (long long)n_cv + 1 + n_other + n_sncv + time_recurr;
  const long long n_out = (long long)n_pix * n;
  if (n_pix <= 0 || n_cv < 0 || n_other < 0 || n_sncv < 0 ||
      (time_recurr != 0 && time_recurr != 1) || n_out > INT_MAX)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* in[5] = {static_cast<const float*>(cv),
                        static_cast<const float*>(para),
                        static_cast<const float*>(other),
                        static_cast<const float*>(sncv),
                        static_cast<const float*>(reproj)};
  switch (out_dtype) {
    case kFloat32:
      glue_assemble_kernel<float><<<blocks_for(n_out), kThreads, 0, s>>>(
          in[0], in[1], in[2], in[3], in[4], static_cast<float*>(out),
          (int)n_out, (int)n, n_cv, n_other, n_sncv, lvl_mul);
      break;
    case kBFloat16:
      glue_assemble_kernel<__nv_bfloat16>
          <<<blocks_for(n_out), kThreads, 0, s>>>(
              in[0], in[1], in[2], in[3], in[4],
              static_cast<__nv_bfloat16*>(out), (int)n_out, (int)n, n_cv,
              n_other, n_sncv, lvl_mul);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The glue after a level's refiner. out: [b, h, w, 1 + n_other] in
// in_dtype (0 float32, 1 bfloat16); prev_depth, prev_para [b, h, w, 1] and
// prev_other [b, h, w, n_other] float32, the deeper estimate at this
// level's size; new_traj: [b] bool, or null (no reset: state_depth is not
// written); rot [b, rot_dim] (3 or 4), trans [b, 3], focal and principal
// [b, 2] float32, the level's intrinsics. Outputs, float32: depth, para
// [b, h, w, 1], other [b, h, w, n_other] and state_depth [b, h, w, 1].
// Contiguous, on the device of `stream`. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int glue_finish(const void* out, const void* prev_depth,
                           const void* prev_para, const void* prev_other,
                           const void* new_traj, const void* rot,
                           const void* trans, const void* focal,
                           const void* principal, void* depth, void* para,
                           void* other, void* state_depth, int b, int h,
                           int w, int n_other, int rot_dim, float lvl_mul,
                           float init_depth, int in_dtype, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || n_other < 0 ||
      (rot_dim != 3 && rot_dim != 4) ||
      ((new_traj == nullptr) != (state_depth == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_pix = (long long)b * h * w;
#define GLUE_FINISH_ARGS(T)                                                 \
  static_cast<const T*>(out), static_cast<const float*>(prev_depth),      \
      static_cast<const float*>(prev_para),                                \
      static_cast<const float*>(prev_other),                               \
      static_cast<const unsigned char*>(new_traj),                         \
      static_cast<const float*>(rot), static_cast<const float*>(trans),    \
      static_cast<const float*>(focal),                                    \
      static_cast<const float*>(principal), static_cast<float*>(depth),    \
      static_cast<float*>(para), static_cast<float*>(other),               \
      static_cast<float*>(state_depth), n_pix, h, w, n_other, rot_dim,     \
      lvl_mul, init_depth
  switch (in_dtype) {
    case kFloat32:
      glue_finish_kernel<float><<<blocks_for(n_pix), kThreads, 0, s>>>(
          GLUE_FINISH_ARGS(float));
      break;
    case kBFloat16:
      glue_finish_kernel<__nv_bfloat16>
          <<<blocks_for(n_pix), kThreads, 0, s>>>(
              GLUE_FINISH_ARGS(__nv_bfloat16));
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GLUE_FINISH_ARGS
  return (int)cudaGetLastError();
}

extern "C" const char* glue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
