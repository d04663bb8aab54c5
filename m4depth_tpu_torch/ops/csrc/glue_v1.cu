// A V1 decoder level's glue in the no-grad frame, as three kernels for
// Hopper (sm_90a): everything `DecoderLevelV1.forward`
// (models/m4depth_v1.py) computes around its cost volume and its refiner.
// Their plain versions are ops/glue_v1.py's `glue_v1_prep`,
// `glue_v1_assemble` and `glue_v1_finish`.
//
// They replace no TPU kernel: the JAX package writes this glue as array
// code (m4depth_tpu/models/m4depth_v1.py), and XLA fuses it there. In the
// port each tensor op of the plain chain is a kernel of its own, about 160
// a level, captured one by one into the serving step's CUDA graph. A level
// moves at most ~170 MB (level 1 of 384x384 at b=8, most of it the cost
// volume read once by `glue_v1_assemble`), so the design is the fewest
// launches, each one pass over its pixels:
//
// 1. `glue_v1_prep` (before the SNCV): a thread per pixel and 16-byte chunk
//    of the features. Each thread computes its pixel's geometry (a few dozen
//    float32 operations, cheaper than sharing it): the level's intrinsics
//    (f and c over 2**level), the deeper depth resized to this level (TFv1
//    bilinear grid; 100 at the deepest level), the reprojection flow by it,
//    and the warp's taps and weights (`dense_image_warp`); then it warps its
//    chunk of the previous features, or of the current ones where the
//    element starts a trajectory or the level has no memory. The first
//    thread of a pixel also warps the previous depth seen from the new
//    viewpoint (`recompute_depth`; 1 where reset or without memory) and
//    writes the two log-depth maps.
// 2. `glue_v1_assemble` (between the SNCV and the refiner): a block per 32
//    pixels stages their rows of the refiner's input in shared memory, in
//    the plain chain's channel order (features, cost volume, the two log
//    depths, rotation, translation, the pixel's ray), each value rounded
//    once to the convs' dtype, and stores them with 16-byte writes. Its
//    reads of the features and the cost volume are 16-byte loads along
//    their rows: a thread per output vector would read the float32 cost
//    volume 4 bytes at a time, with a warp's loads 32 bytes apart.
// 3. `glue_v1_finish` (after the refiner's last activation): a thread per
//    pixel inverts the leaky ReLU, clips to [-7, 7] and writes exp(x) * 10.
//
// Precision: float32 with the plain chain's roundings at the same points.
// Each product, sum and difference of the chain is rounded on its own
// (`__fmul_rn` and friends, which the compiler never contracts into an
// FMA), the rotation matrix's too (`rot_mat_rn`); the warp's lerps are
// rounded to the features' dtype after each operation, as ATen's bfloat16
// ops round. ATen divides a tensor by a Python number as a product with the
// float32 reciprocal on the card, and so do these kernels; the three-term
// sums (`recompute_depth`'s, a quaternion's v.v) run in the order ATen's
// CUDA reduction takes (`sum3`). `logf` and `expf` and division are the
// functions ATen's kernels call. So on the card the kernels give the plain
// chain's values; a float32 ulp anywhere upstream of a value rounded to
// bfloat16 could flip that rounding, which the log of a depth near 10
// magnifies (tests/test_torch_cuda.py and chip_smoke.py phase 21 hold the
// kernels to one ulp at V1's level shapes).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// pixels a block of glue_v1_assemble stages (32 rows of at most 284 values
// of 4 bytes: 36 KB of shared memory at V1's widest level)
constexpr int kAssemblePixels = 32;
// x / 10.0 as ATen computes it on the card: x times the float32 reciprocal
constexpr float kTenth = 1.f / 10.f;

// The ray coordinate ((i + 0.5) - c) / f of pixel index i
// (geometry/camera.py::pixel_grid).
__device__ __forceinline__ float ray(int i, float c, float f) {
  return __fsub_rn((float)i + 0.5f, c) / f;
}

// a0 + a1 + a2 in the order ATen's CUDA reduction sums a row of three
// (torch.sum over a last dimension of 3): two threads along the row, the
// first adding a0 and a2, then the second's a1.
__device__ __forceinline__ float sum3(float a0, float a1, float a2) {
  return __fadd_rn(__fadd_rn(a0, a2), a1);
}

// geometry/rotations.py::rot_mat with each tensor op's rounding: a
// small-angle vector's entries as they are, a (w, x, y, z) quaternion's as
// (s eye + 2 v v^T) + (2 w) [v]x with s = w w - (x x + y y + z z).
// common.cuh's `rot_mat` contracts these into FMAs; here a float32 ulp of
// the matrix would move a sample position, and the warp rounds its
// fraction to the features' dtype, where it could change a whole step.
__device__ __forceinline__ void rot_mat_rn(const float* q, int rot_dim,
                                           float* R) {
  if (rot_dim == 3) {
    rot_mat(q, 3, R);
    return;
  }
  const float w = q[0], v[3] = {q[1], q[2], q[3]};
  const float s =
      __fsub_rn(__fmul_rn(w, w), sum3(__fmul_rn(v[0], v[0]),
                                      __fmul_rn(v[1], v[1]),
                                      __fmul_rn(v[2], v[2])));
  const float w2 = __fmul_rn(2.f, w);
  // [v]x: row i, column j holds sign * v[k], or 0 on the diagonal
  const int k_of[9] = {-1, 2, 1, 2, -1, 0, 1, 0, -1};
  const float sign[9] = {0.f, -1.f, 1.f, 1.f, 0.f, -1.f, -1.f, 1.f, 0.f};
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    const int i = e / 3, j = e % 3;
    const float base =
        __fadd_rn(i == j ? s : 0.f, __fmul_rn(2.f, __fmul_rn(v[i], v[j])));
    R[e] = k_of[e] < 0
               ? base
               : __fadd_rn(base, __fmul_rn(w2, sign[e] * v[k_of[e]]));
  }
}

// a + (b - a) * t with a, b and t values of T, as three ATen ops on T
// tensors: each result rounded to T (no rounding for float32).
template <typename T>
__device__ __forceinline__ float lerp_in(float a, float b, float t) {
  return round_to<T>(__fadd_rn(
      a, round_to<T>(__fmul_rn(round_to<T>(__fsub_rn(b, a)), t))));
}

// ops/warp.py's bilinear sample from its four taps.
template <typename T>
__device__ __forceinline__ float bilinear(float tl, float tr, float bl,
                                          float br, float ax, float ay) {
  return lerp_in<T>(lerp_in<T>(tl, tr, ax), lerp_in<T>(bl, br, ax), ay);
}

// Thread t: pixel t / chunks, channels [VEC k, VEC k + VEC) with k = t %
// chunks. prev_f null: no memory (prev_depth null too); new_traj null: no
// reset; deeper null: the deepest level.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
glue_v1_prep_kernel(const T* __restrict__ curr_f, const T* __restrict__ prev_f,
                    const float* __restrict__ prev_depth,
                    const unsigned char* __restrict__ new_traj,
                    const float* __restrict__ deeper,
                    const float* __restrict__ rot,
                    const float* __restrict__ trans,
                    const float* __restrict__ focal,
                    const float* __restrict__ principal,
                    T* __restrict__ f0_w, T* __restrict__ log_d0w,
                    T* __restrict__ log_dprev, int b, int h, int w, int C,
                    int hd, int wd, int rot_dim, float factor, float scale_y,
                    float scale_x) {
  const int chunks = C / VEC;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)b * h * w * chunks) return;
  const long long p = t / chunks;
  const int k = (int)(t - p * chunks);
  const int x = (int)(p % w);
  const long long row = p / w;
  const int y = (int)(row % h);
  const long long bi = row / h;
  const float fx = focal[2 * bi] / factor, fy = focal[2 * bi + 1] / factor;
  const float cx = principal[2 * bi] / factor;
  const float cy = principal[2 * bi + 1] / factor;
  const float* tb = trans + 3 * bi;

  // the deeper estimate at this pixel, the depth the flow reprojects
  float d_prev = 100.f;
  if (deeper != nullptr)
    d_prev = upsample(deeper + bi * hd * wd, wd, 1, 0,
                      lerp_axis(y, hd, h, scale_y),
                      lerp_axis(x, wd, w, scale_x));

  // reprojection_flow: the ray times the depth, rotated, translated and
  // projected, less the pixel's offset from c; plus the index grid
  float R[9];
  rot_mat_rn(rot + bi * rot_dim, rot_dim, R);
  const float mx = __fsub_rn((float)x + 0.5f, cx);
  const float my = __fsub_rn((float)y + 0.5f, cy);
  const float pt[3] = {__fmul_rn(mx / fx, d_prev), __fmul_rn(my / fy, d_prev),
                       d_prev};
  float m[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    m[i] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(R[3 * i], pt[0]),
                                         __fmul_rn(R[3 * i + 1], pt[1])),
                               __fmul_rn(R[3 * i + 2], pt[2])),
                     tb[i]);
  const float qx = __fadd_rn((float)x, __fsub_rn(__fmul_rn(m[0], fx) / m[2],
                                                 mx));
  const float qy = __fadd_rn((float)y, __fsub_rn(__fmul_rn(m[1], fy) / m[2],
                                                 my));

  // dense_image_warp's taps: the floor clipped to [0, size - 2] (a NaN
  // position takes 0, through fmaxf), the fraction to [0, 1] and rounded to
  // the features' dtype (a NaN position's stays NaN)
  const float x0 = fminf(fmaxf(floorf(qx), 0.f), (float)(w - 2));
  const float y0 = fminf(fmaxf(floorf(qy), 0.f), (float)(h - 2));
  const float ax = round_to<T>(clamp_nan(__fsub_rn(qx, x0), 0.f, 1.f));
  const float ay = round_to<T>(clamp_nan(__fsub_rn(qy, y0), 0.f, 1.f));
  const int ix = (int)x0, iy = (int)y0;
  const long long tl = (bi * h + iy) * w + ix;
  const long long taps[4] = {tl, tl + 1, tl + w, tl + w + 1};

  const bool fresh =
      prev_f == nullptr || (new_traj != nullptr && new_traj[bi] != 0);
  const T* src = fresh ? curr_f : prev_f;
  float v[4][VEC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    Vec<T, VEC>::load(src + taps[i] * C + (long long)k * VEC, v[i]);
  float o[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    o[j] = bilinear<T>(v[0][j], v[1][j], v[2][j], v[3][j], ax, ay);
  Vec<T, VEC>::store(f0_w + p * C + (long long)k * VEC, o);
  if (k != 0) return;

  // the previous depth at the taps, seen from the new viewpoint:
  // recompute_depth with rot_mat(-rot)'s last row r, z = (r . ray) depth +
  // r . (-t), clipped to [0.1, 2000] and rounded to the features' dtype
  float d[4] = {1.f, 1.f, 1.f, 1.f};
  if (!fresh) {
    float q[4], Rn[9];
    for (int i = 0; i < rot_dim; ++i) q[i] = -rot[bi * rot_dim + i];
    rot_mat_rn(q, rot_dim, Rn);
    const float* r = Rn + 6;
    const float shift = sum3(__fmul_rn(r[0], -tb[0]), __fmul_rn(r[1], -tb[1]),
                             __fmul_rn(r[2], -tb[2]));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float s = sum3(__fmul_rn(r[0], ray(ix + (i & 1), cx, fx)),
                           __fmul_rn(r[1], ray(iy + (i >> 1), cy, fy)), r[2]);
      d[i] = round_to<T>(clamp_nan(
          __fadd_rn(__fmul_rn(s, prev_depth[taps[i]]), shift), 0.1f,
          2000.f));
    }
  }
  const float d0_w = bilinear<T>(d[0], d[1], d[2], d[3], ax, ay);
  log_d0w[p] = from_float<T>(log_safe(d0_w, kTenth));
  log_dprev[p] = from_float<T>(log_safe(d_prev, kTenth));
}

// `count` values of src (Src: float32 or T), rows of `row` values, into the
// staged refiner input s (rows of n values of T) at column `offset`: a
// 16-byte load a thread where `vec` says src allows it, then one value at a
// time for the rest.
template <typename Src, typename T>
__device__ __forceinline__ void stage_rows(const Src* __restrict__ src,
                                           int count, int row, bool vec,
                                           T* __restrict__ s, int n,
                                           int offset) {
  constexpr int V = kVec<Src>;
  const int n_vec = vec ? count / V : 0;
  for (int k = threadIdx.x; k < n_vec; k += blockDim.x) {
    float v[V];
    Vec<Src, V>::load(src + k * V, v);
    int q = k * V / row, c = k * V - q * row;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s[q * n + offset + c] = from_float<T>(v[j]);
      if (++c == row) {
        c = 0;
        ++q;
      }
    }
  }
  for (int i = n_vec * V + threadIdx.x; i < count; i += blockDim.x) {
    const int q = i / row;
    s[q * n + offset + i - q * row] = from_float<T>(to_float(src[i]));
  }
}

// Block j: pixels [kAssemblePixels j, kAssemblePixels (j + 1)) of the
// refiner's input [n_pix, n], n = C + n_cv + 2 + rot_dim + 3 + 2. The block
// stages their rows in shared memory, each value rounded once to T: the
// features and the cost volume read as 16-byte vectors along their rows,
// the two log depths, the rotation, the translation and the pixel's ray a
// thread per pixel; then it stores the rows, contiguous in the output, as
// 16-byte vectors.
template <typename T>
__global__ void __launch_bounds__(kThreads)
glue_v1_assemble_kernel(const T* __restrict__ curr_f,
                        const float* __restrict__ cv,
                        const T* __restrict__ log_d0w,
                        const T* __restrict__ log_dprev,
                        const float* __restrict__ rot,
                        const float* __restrict__ trans,
                        const float* __restrict__ focal,
                        const float* __restrict__ principal,
                        T* __restrict__ out, long long n_pix, int h, int w,
                        int C, int n_cv, int rot_dim, float factor,
                        bool vec_f, bool vec_cv) {
  extern __shared__ __align__(16) unsigned char staged[];
  T* s = reinterpret_cast<T*>(staged);
  const int n = C + n_cv + 2 + rot_dim + 3 + 2;
  const long long p0 = (long long)blockIdx.x * kAssemblePixels;
  const int np = (int)min((long long)kAssemblePixels, n_pix - p0);
  stage_rows(curr_f + p0 * C, np * C, C, vec_f, s, n, 0);
  stage_rows(cv + p0 * n_cv, np * n_cv, n_cv, vec_cv, s, n, C);
  for (int q = threadIdx.x; q < np; q += blockDim.x) {
    const long long p = p0 + q;
    const long long bi = p / ((long long)h * w);
    T* r = s + q * n + C + n_cv;
    r[0] = log_d0w[p];
    r[1] = log_dprev[p];
    r += 2;
    for (int j = 0; j < rot_dim; ++j)
      r[j] = from_float<T>(rot[bi * rot_dim + j]);
    r += rot_dim;
    for (int j = 0; j < 3; ++j) r[j] = from_float<T>(trans[3 * bi + j]);
    r[3] = from_float<T>(ray((int)(p % w), principal[2 * bi] / factor,
                             focal[2 * bi] / factor));
    r[4] = from_float<T>(ray((int)(p / w % h), principal[2 * bi + 1] / factor,
                             focal[2 * bi + 1] / factor));
  }
  __syncthreads();
  // the rows are contiguous from out + p0 n, which kAssemblePixels n values
  // of T keep 16-byte aligned
  const int bytes = np * n * (int)sizeof(T);
  const uint4* src = reinterpret_cast<const uint4*>(staged);
  uint4* dst = reinterpret_cast<uint4*>(out + p0 * n);
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x) dst[i] = src[i];
  for (int i = bytes / 16 * 16 / (int)sizeof(T) + threadIdx.x; i < np * n;
       i += blockDim.x)
    out[p0 * n + i] = s[i];
}

// Pixel p: the refiner's activated output out[p] in T to depth, float32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
glue_v1_finish_kernel(const T* __restrict__ out, float* __restrict__ depth,
                      long long n_pix, float inv_slope) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  float v = to_float(out[p]);
  v = v > 0.f ? v : __fmul_rn(v, inv_slope);
  depth[p] = __fmul_rn(expf(clamp_nan(v, -7.f, 7.f)), 10.f);
}

unsigned blocks_for(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

template <typename T>
cudaError_t launch_prep(const void* curr_f, const void* prev_f,
                        const void* prev_depth, const void* new_traj,
                        const void* deeper, const void* rot,
                        const void* trans, const void* focal,
                        const void* principal, void* f0_w, void* log_d0w,
                        void* log_dprev, int b, int h, int w, int C, int hd,
                        int wd, int rot_dim, float factor, float scale_y,
                        float scale_x, cudaStream_t s) {
  constexpr int V = kVec<T>;
  const bool vec = C % V == 0 && aligned16(curr_f) && aligned16(f0_w) &&
                   (prev_f == nullptr || aligned16(prev_f));
  const long long threads = (long long)b * h * w * (vec ? C / V : C);
  if (threads > (long long)INT_MAX * kThreads) return cudaErrorInvalidValue;
  auto kernel = vec ? glue_v1_prep_kernel<T, V> : glue_v1_prep_kernel<T, 1>;
  kernel<<<blocks_for(threads), kThreads, 0, s>>>(
      static_cast<const T*>(curr_f), static_cast<const T*>(prev_f),
      static_cast<const float*>(prev_depth),
      static_cast<const unsigned char*>(new_traj),
      static_cast<const float*>(deeper), static_cast<const float*>(rot),
      static_cast<const float*>(trans), static_cast<const float*>(focal),
      static_cast<const float*>(principal), static_cast<T*>(f0_w),
      static_cast<T*>(log_d0w), static_cast<T*>(log_dprev), b, h, w, C, hd,
      wd, rot_dim, factor, scale_y, scale_x);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_assemble(const void* curr_f, const void* cv,
                            const void* log_d0w, const void* log_dprev,
                            const void* rot, const void* trans,
                            const void* focal, const void* principal,
                            void* out, long long n_pix, int h, int w, int C,
                            int n_cv, int rot_dim, float factor,
                            cudaStream_t s) {
  const long long blocks = (n_pix + kAssemblePixels - 1) / kAssemblePixels;
  const size_t smem = (size_t)kAssemblePixels *
                      (C + n_cv + 2 + rot_dim + 3 + 2) * sizeof(T);
  if (blocks > INT_MAX || !aligned16(out)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<glue_v1_assemble_kernel<T>>(smem);
  if (err != cudaSuccess) return err;
  // 16-byte loads where the block's first row starts 16-byte aligned
  // (kAssemblePixels rows of the cost volume always keep it so)
  const bool vec_f = aligned16(curr_f) && C % kVec<T> == 0;
  const bool vec_cv = aligned16(cv);
  glue_v1_assemble_kernel<T><<<(unsigned)blocks, kThreads, smem, s>>>(
      static_cast<const T*>(curr_f), static_cast<const float*>(cv),
      static_cast<const T*>(log_d0w), static_cast<const T*>(log_dprev),
      static_cast<const float*>(rot), static_cast<const float*>(trans),
      static_cast<const float*>(focal), static_cast<const float*>(principal),
      static_cast<T*>(out), n_pix, h, w, C, n_cv, rot_dim, factor, vec_f,
      vec_cv);
  return cudaGetLastError();
}

}  // namespace

// The glue before a V1 level's SNCV. curr_f, prev_f: [b, h, w, C] in dtype
// (0 float32, 1 bfloat16), prev_f the last frame's features or null (no
// memory: the current ones are warped, and prev_depth is null too);
// prev_depth: [b, h, w, 1] float32; new_traj: [b] bool or null (no reset);
// deeper: [b, hd, wd, 1] float32, the deeper level's depth, or null at the
// deepest level; scale_y = hd / h, scale_x = wd / w as float32. rot: [b,
// rot_dim] (3: small angle, 4: quaternion), trans [b, 3], focal and
// principal [b, 2], float32, at full resolution; factor: 2**level. h and w
// at least 2 (the warp's 2x2 taps). Outputs in dtype: f0_w [b, h, w, C], the
// warped previous features; log_d0w and log_dprev [b, h, w, 1], log(max(d /
// 10, 1e-12)) of the warped previous depth and of the deeper one. All
// contiguous, on the device of `stream`. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int glue_v1_prep(const void* curr_f, const void* prev_f,
                            const void* prev_depth, const void* new_traj,
                            const void* deeper, const void* rot,
                            const void* trans, const void* focal,
                            const void* principal, void* f0_w, void* log_d0w,
                            void* log_dprev, int b, int h, int w, int C,
                            int hd, int wd, int rot_dim, float factor,
                            float scale_y, float scale_x, int dtype,
                            void* stream) {
  if (b <= 0 || h < 2 || w < 2 || C <= 0 ||
      (rot_dim != 3 && rot_dim != 4) ||
      ((prev_f == nullptr) != (prev_depth == nullptr)) ||
      (deeper != nullptr && (hd <= 0 || wd <= 0)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GLUE_V1_PREP_ARGS                                                    \
  curr_f, prev_f, prev_depth, new_traj, deeper, rot, trans, focal,          \
      principal, f0_w, log_d0w, log_dprev, b, h, w, C, hd, wd, rot_dim,     \
      factor, scale_y, scale_x, s
  switch (dtype) {
    case kFloat32:
      return (int)launch_prep<float>(GLUE_V1_PREP_ARGS);
    case kBFloat16:
      return (int)launch_prep<__nv_bfloat16>(GLUE_V1_PREP_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GLUE_V1_PREP_ARGS
}

// The refiner's input out [b, h, w, C + n_cv + 2 + rot_dim + 3 + 2] in
// dtype (0 float32, 1 bfloat16): curr_f [b, h, w, C] and log_d0w, log_dprev
// [b, h, w, 1] in dtype; cv [b, h, w, n_cv] float32; rot [b, rot_dim],
// trans [b, 3] float32, each element's broadcast over its pixels; then the
// pixel's ray ((x + 0.5 - cx) / fx, (y + 0.5 - cy) / fy) with focal and
// principal [b, 2] float32 at full resolution over factor = 2**level. All
// contiguous, on the device of `stream`. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int glue_v1_assemble(const void* curr_f, const void* cv,
                                const void* log_d0w, const void* log_dprev,
                                const void* rot, const void* trans,
                                const void* focal, const void* principal,
                                void* out, int b, int h, int w, int C,
                                int n_cv, int rot_dim, float factor,
                                int dtype, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || C <= 0 || n_cv < 0 ||
      (rot_dim != 3 && rot_dim != 4))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_pix = (long long)b * h * w;
#define GLUE_V1_ASSEMBLE_ARGS                                               \
  curr_f, cv, log_d0w, log_dprev, rot, trans, focal, principal, out, n_pix, \
      h, w, C, n_cv, rot_dim, factor, s
  switch (dtype) {
    case kFloat32:
      return (int)launch_assemble<float>(GLUE_V1_ASSEMBLE_ARGS);
    case kBFloat16:
      return (int)launch_assemble<__nv_bfloat16>(GLUE_V1_ASSEMBLE_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GLUE_V1_ASSEMBLE_ARGS
}

// The glue after a V1 level's refiner: out [b, h, w, 1] in dtype (0
// float32, 1 bfloat16), the last conv's leaky ReLU of the given slope;
// depth [b, h, w, 1] float32, exp(clip(x, -7, 7)) * 10 of its inverse x.
// Contiguous, on the device of `stream`. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int glue_v1_finish(const void* out, void* depth, int b, int h,
                              int w, float slope, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || !(slope != 0.f))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_pix = (long long)b * h * w;
  // x / slope as ATen computes it on the card
  const float inv_slope = 1.f / slope;
  switch (dtype) {
    case kFloat32:
      glue_v1_finish_kernel<float><<<blocks_for(n_pix), kThreads, 0, s>>>(
          static_cast<const float*>(out), static_cast<float*>(depth), n_pix,
          inv_slope);
      break;
    case kBFloat16:
      glue_v1_finish_kernel<__nv_bfloat16>
          <<<blocks_for(n_pix), kThreads, 0, s>>>(
              static_cast<const __nv_bfloat16*>(out),
              static_cast<float*>(depth), n_pix, inv_slope);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* glue_v1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
