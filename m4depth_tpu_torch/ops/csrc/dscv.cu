// Fused parallax-sweeping cost volume (DSCV), forward and backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_reduce_kernel` (m4depth_tpu/ops/dscv_pallas.py:120),
// driven by `fused_reduce_chunk` from `parallax_sweeping_cv_fused`
// (m4depth_tpu/ops/cost_volume.py:1278), together with the XLA build of the
// shift-expanded map and the row gather around it. Those exist because a
// TPU gathers slowly (ops/cost_volume.py:73-91); this card samples
// directly, as the reference's own CUDA warp op does. So one kernel computes
// what `parallax_sweeping_cv_fused` returns, end to end. For each pixel p
// and hypothesis k in -r..r:
//     disp_k = clip(centre(p) + k, 1e-6, 1e6)
//     q_k    = proj(p) + delta(p) / max(rho(p), 1e-12) * disp_k + c - 0.5
//     cv[p, cut*(2r+1) + k] = mean_{c in cut} c1[p, c] * bilinear(c2, q_k)[c]
// and the centre hypothesis also samples the previous parallax:
//     para_out[p] = bilinear(para_prev_t, q_0)
// The bilinear sample clips the floor to [0, size-2] and the fraction to
// [0, 1], as dense_image_warp does. proj, delta and rho (the epipolar terms
// of geometry/parallax.py) are computed here per thread from the motion and
// the camera as the caller holds them: rot [b, 3] (small angle) or [b, 4]
// (quaternion, geometry/rotations.py), trans [b, 3], f and c [b, 2]. So the
// wrapper launches nothing but this kernel.
//
// What bounds it on the H100: bytes. Per pixel it must read C values of c1
// and of c2, the sweep centre and the previous parallax, and write
// (2r+1)*cuts floats; its 4 taps x 9 hypotheses re-read c2 36 times, but
// from L1/L2, not device memory, since the taps of neighbouring pixels
// overlap. The flops (about 8 per tap channel) stay far below the card's
// float32 rate.
//
// Design: one thread per (pixel, cut, hypothesis), numbered in the output's
// own order, so neighbouring threads write neighbouring floats. Each thread
// recomputes the rotation and the pixel's epipolar terms (about 60 flops,
// cheaper than reading them) and keeps one float32 sum: no per-pixel state
// lives in registers or shared memory. Loads are scalar; widening them to
// 16 bytes is the first step towards the bound.
//
// Backward (`dscv_backward`). Replaces the TPU kernel `_grad_kernel`
// (m4depth_tpu/ops/dscv_bwd_pallas.py:49), which only scatters the
// cotangent of the expanded map's row fetch (`_chunked_fetch_k`,
// ops/cost_volume.py:826-861, under dscv_bwd="pallas"). With no expanded
// map here, the kernel is the whole VJP of the forward above, with the
// structure of the JAX corner VJP `_dscv_corner_bwd` (cost_volume.py:973)
// and of the reference's CUDA `BackProjectGrad`: 4 bilinear corners per
// (pixel, hypothesis). With g = dcv[p, cut, k] / cc:
//     dc1[p, c]      = sum_k g * bilinear(c2, q_k)[c]
//     dc2[corner, c] += g * c1[p, c] * w_corner(q_k)
//     dcentre[p]     = sum_k [1e-6 <= centre+k <= 1e6] * (dax_k*ux + day_k*uy)
//     dpara[corner]  += dpara_out[p] * w_corner(q_0)     (when asked for)
// where (ux, uy) = delta / max(rho, 1e-12) and dax_k, day_k are the
// derivatives of the sampled values (c1-weighted, plus the parallax term
// at the centre hypothesis) with respect to the bilinear fractions, zero
// where a fraction was clipped. Both kernels take the sample position from
// one device function, so the backward differentiates exactly the forward's
// positions. The sweep-centre term carries the gradient into every deeper
// level, whose parallax, doubled and upsampled, is this level's centre.
//
// What bounds the backward: bytes as well (c1, c2, the centre, the previous
// parallax and dcv read once; dc1, dc2, dcentre written once), but the
// float32 atomics into dc2 (4 x 9 per pixel and channel) are its likely
// limit. Design: one warp per pixel, its lanes over the channels, so the
// per-pixel sums (dc1 in a shared-memory row, the position derivative by
// a warp shuffle reduction) need no atomics, and the 32 lanes' atomics into
// one corner hit 32 neighbouring floats. dc2 accumulates in a float32
// scratch that the wrapper zeroes and then casts to c2's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Row-major rotation matrix of a small-angle vector (rot_dim 3) or a unit
// (w, x, y, z) quaternion (rot_dim 4), as geometry/rotations.py builds it.
__device__ __forceinline__ void rot_mat(const float* q, int rot_dim,
                                        float* R) {
  if (rot_dim == 3) {
    const float x = q[0], y = q[1], z = q[2];
    R[0] = 1.f; R[1] = -z;  R[2] = y;
    R[3] = z;   R[4] = 1.f; R[5] = -x;
    R[6] = -y;  R[7] = x;   R[8] = 1.f;
    return;
  }
  // R = (w^2 - v.v) I + 2 v v^T + 2 w [v]x
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float s = w * w - (x * x + y * y + z * z);
  R[0] = s + 2.f * x * x;         R[1] = 2.f * x * y - 2.f * w * z;
  R[2] = 2.f * x * z + 2.f * w * y;
  R[3] = 2.f * y * x + 2.f * w * z; R[4] = s + 2.f * y * y;
  R[5] = 2.f * y * z - 2.f * w * x;
  R[6] = 2.f * z * x - 2.f * w * y; R[7] = 2.f * z * y + 2.f * w * x;
  R[8] = s + 2.f * z * z;
}

// The epipolar terms of pixel (x, y) of image bi (geometry/parallax.py
// epipolar_terms): proj = (px, py), delta = (dx, dy), rho clipped below at
// 1e-12 = den, and the pixel centre relative to c = (mx, my).
struct Epipolar {
  float px, py, dx, dy, den, mx, my;
};

__device__ __forceinline__ Epipolar epipolar(
    const float* __restrict__ rot, const float* __restrict__ trans,
    const float* __restrict__ focal, const float* __restrict__ principal,
    long long bi, int rot_dim, int x, int y) {
  float R[9];
  rot_mat(rot + bi * rot_dim, rot_dim, R);
  const float fx = focal[2 * bi], fy = focal[2 * bi + 1];
  const float cx = principal[2 * bi], cy = principal[2 * bi + 1];
  const float tx = trans[3 * bi], ty = trans[3 * bi + 1];
  const float tz = trans[3 * bi + 2];
  Epipolar e;
  e.mx = ((float)x + 0.5f) - cx;
  e.my = ((float)y + 0.5f) - cy;
  const float hx = e.mx / fx, hy = e.my / fy;
  const float rx = R[0] * hx + R[1] * hy + R[2];
  const float ry = R[3] * hx + R[4] * hy + R[5];
  const float rz = R[6] * hx + R[7] * hy + R[8];
  e.px = rx * fx / rz;
  e.py = ry * fy / rz;
  e.dx = tx * fx - tz * e.px;
  e.dy = ty * fy - tz * e.py;
  e.den = fmaxf(sqrtf(e.dx * e.dx + e.dy * e.dy), 1e-12f);
  return e;
}

// Where hypothesis k of pixel (x, y) samples, and the gates of the clips
// on its way there (for the backward: torch.clamp passes a gradient where
// min <= x <= max).
struct Sample {
  long long tap;      // top-left corner, pixel index over b*h*w
  float ax, ay;       // bilinear fractions, clipped to [0, 1]
  bool in_x, in_y;    // the fraction was not clipped
  bool in_disp;       // centre + k was inside [1e-6, 1e6]
};

__device__ __forceinline__ Sample sample_position(const Epipolar& e,
                                                  float centre, int k, int r,
                                                  int x, int y, int w, int h,
                                                  long long img) {
  const float hyp = centre + (float)(k - r);
  const float disp = fminf(fmaxf(hyp, 1e-6f), 1e6f);
  const float qx = (float)x + ((e.px + e.dx / e.den * disp) - e.mx);
  const float qy = (float)y + ((e.py + e.dy / e.den * disp) - e.my);
  const float x0f = fminf(fmaxf(floorf(qx), 0.f), (float)(w - 2));
  const float y0f = fminf(fmaxf(floorf(qy), 0.f), (float)(h - 2));
  const float tx = qx - x0f, ty = qy - y0f;
  Sample sm;
  sm.ax = fminf(fmaxf(tx, 0.f), 1.f);
  sm.ay = fminf(fmaxf(ty, 0.f), 1.f);
  sm.in_x = tx >= 0.f && tx <= 1.f;
  sm.in_y = ty >= 0.f && ty <= 1.f;
  sm.in_disp = hyp >= 1e-6f && hyp <= 1e6f;
  sm.tap = img + (long long)y0f * w + (long long)x0f;
  return sm;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dscv_forward_kernel(const T* __restrict__ c1, const T* __restrict__ c2,
                    const T* __restrict__ para,
                    const float* __restrict__ centre,
                    const float* __restrict__ rot,
                    const float* __restrict__ trans,
                    const float* __restrict__ focal,
                    const float* __restrict__ principal,
                    float* __restrict__ cv, float* __restrict__ para_out,
                    int h, int w, int C, int cuts, int r, int rot_dim,
                    long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int s = 2 * r + 1;
  const int k = (int)(idx % s);
  const long long t = idx / s;
  const int cut = (int)(t % cuts);
  const long long p = t / cuts;            // pixel index over b*h*w
  const int x = (int)(p % w);
  const int y = (int)((p / w) % h);
  const long long bi = p / ((long long)w * h);
  const long long img = bi * h * w;

  const Epipolar e = epipolar(rot, trans, focal, principal, bi, rot_dim, x,
                              y);
  const Sample sm = sample_position(e, centre[p], k, r, x, y, w, h, img);
  const float ax = sm.ax, ay = sm.ay;
  const long long tap = sm.tap;

  const int cc = C / cuts;
  const T* a = c1 + p * C + cut * cc;
  const T* tl = c2 + tap * C + cut * cc;
  const T* tr = tl + C;
  const T* bl = tl + (long long)w * C;
  const T* br = bl + C;
  float acc = 0.f;
  for (int c = 0; c < cc; ++c) {
    const float vtl = to_float(tl[c]), vtr = to_float(tr[c]);
    const float vbl = to_float(bl[c]), vbr = to_float(br[c]);
    const float top = vtl + (vtr - vtl) * ax;
    const float bot = vbl + (vbr - vbl) * ax;
    acc = fmaf(to_float(a[c]), top + (bot - top) * ay, acc);
  }
  cv[idx] = acc / (float)cc;

  if (cut == 0 && k == r) {
    const float vtl = to_float(para[tap]), vtr = to_float(para[tap + 1]);
    const float vbl = to_float(para[tap + w]), vbr = to_float(para[tap + w + 1]);
    const float top = vtl + (vtr - vtl) * ax;
    const float bot = vbl + (vbr - vbl) * ax;
    para_out[p] = top + (bot - top) * ay;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One warp per pixel p; its lanes stride over the C channels. For each
// hypothesis k, with g = dcv[p, cut(c), k] / cc and the forward's sample:
//   dc1[p, c]      += g * sample_k(c2)[c]          (shared-memory row)
//   dc2[corner, c] += g * c1[p, c] * w_corner       (float32 atomics)
//   d/dq_k          = sum_c g * c1[p, c] * d sample_k(c2)[c] / dq
// and the centre hypothesis adds the warped parallax's terms. The position
// derivative reaches the centre through q_k = ... + unit * clip(centre + k).
template <typename T>
__global__ void __launch_bounds__(kThreads)
dscv_backward_kernel(const T* __restrict__ c1, const T* __restrict__ c2,
                     const T* __restrict__ para,
                     const float* __restrict__ centre,
                     const float* __restrict__ rot,
                     const float* __restrict__ trans,
                     const float* __restrict__ focal,
                     const float* __restrict__ principal,
                     const float* __restrict__ dcv,
                     const float* __restrict__ dpara_out,
                     T* __restrict__ dc1, float* __restrict__ dc2,
                     float* __restrict__ dcentre, float* __restrict__ dpara,
                     int h, int w, int C, int cuts, int r, int rot_dim,
                     long long n_pix) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p = (long long)blockIdx.x * (kThreads / 32) + warp;
  if (p >= n_pix) return;                  // the whole warp leaves together
  float* acc = smem + warp * C;
  for (int c = lane; c < C; c += 32) acc[c] = 0.f;

  const int x = (int)(p % w);
  const int y = (int)((p / w) % h);
  const long long bi = p / ((long long)w * h);
  const long long img = bi * h * w;
  const Epipolar e = epipolar(rot, trans, focal, principal, bi, rot_dim, x,
                              y);
  const float ux = e.dx / e.den, uy = e.dy / e.den;
  const int s = 2 * r + 1;
  const int cc = C / cuts;
  const float inv_cc = 1.f / (float)cc;
  const float cen = centre[p];
  const float dpo = dpara_out[p];
  const float* g_row = dcv + p * (long long)(cuts * s);
  const T* a_row = c1 + p * C;
  float dcen = 0.f;

  for (int k = 0; k < s; ++k) {
    const Sample sm = sample_position(e, cen, k, r, x, y, w, h, img);
    const float ax = sm.ax, ay = sm.ay;
    const float wtl = (1.f - ax) * (1.f - ay), wtr = ax * (1.f - ay);
    const float wbl = (1.f - ax) * ay, wbr = ax * ay;
    const long long tap = sm.tap;
    const T* tl = c2 + tap * C;
    const T* tr = tl + C;
    const T* bl = tl + (long long)w * C;
    const T* br = bl + C;
    float* gtl = dc2 + tap * C;
    float* gtr = gtl + C;
    float* gbl = gtl + (long long)w * C;
    float* gbr = gbl + C;
    float dax = 0.f, day = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float g = g_row[(c / cc) * s + k] * inv_cc;
      const float vtl = to_float(tl[c]), vtr = to_float(tr[c]);
      const float vbl = to_float(bl[c]), vbr = to_float(br[c]);
      const float top = vtl + (vtr - vtl) * ax;
      const float bot = vbl + (vbr - vbl) * ax;
      acc[c] = fmaf(g, top + (bot - top) * ay, acc[c]);
      const float coef = g * to_float(a_row[c]);
      atomicAdd(gtl + c, coef * wtl);
      atomicAdd(gtr + c, coef * wtr);
      atomicAdd(gbl + c, coef * wbl);
      atomicAdd(gbr + c, coef * wbr);
      dax = fmaf(coef, (vtr - vtl) + ((vbr - vbl) - (vtr - vtl)) * ay, dax);
      day = fmaf(coef, bot - top, day);
    }
    dax = warp_sum(dax);
    day = warp_sum(day);
    if (k == r) {
      const float vtl = to_float(para[tap]), vtr = to_float(para[tap + 1]);
      const float vbl = to_float(para[tap + w]);
      const float vbr = to_float(para[tap + w + 1]);
      const float top = vtl + (vtr - vtl) * ax;
      const float bot = vbl + (vbr - vbl) * ax;
      dax = fmaf(dpo, (vtr - vtl) + ((vbr - vbl) - (vtr - vtl)) * ay, dax);
      day = fmaf(dpo, bot - top, day);
      if (dpara != nullptr && lane == 0) {
        atomicAdd(dpara + tap, dpo * wtl);
        atomicAdd(dpara + tap + 1, dpo * wtr);
        atomicAdd(dpara + tap + w, dpo * wbl);
        atomicAdd(dpara + tap + w + 1, dpo * wbr);
      }
    }
    if (sm.in_disp)
      dcen += (sm.in_x ? dax : 0.f) * ux + (sm.in_y ? day : 0.f) * uy;
  }
  for (int c = lane; c < C; c += 32) dc1[p * C + c] = from_float<T>(acc[c]);
  if (lane == 0) dcentre[p] = dcen;
}

template <typename T>
cudaError_t launch(const void* c1, const void* c2, const void* para,
                   const void* centre, const void* rot, const void* trans,
                   const void* focal, const void* principal, void* cv,
                   void* para_out, int b, int h, int w, int C, int cuts,
                   int r, int rot_dim, cudaStream_t stream) {
  const long long total = (long long)b * h * w * cuts * (2 * r + 1);
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dscv_forward_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(c1), static_cast<const T*>(c2),
      static_cast<const T*>(para), static_cast<const float*>(centre),
      static_cast<const float*>(rot), static_cast<const float*>(trans),
      static_cast<const float*>(focal),
      static_cast<const float*>(principal), static_cast<float*>(cv),
      static_cast<float*>(para_out), h, w, C, cuts, r, rot_dim, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_backward(const void* c1, const void* c2, const void* para,
                            const void* centre, const void* rot,
                            const void* trans, const void* focal,
                            const void* principal, const void* dcv,
                            const void* dpara_out, void* dc1, void* dc2,
                            void* dcentre, void* dpara, int b, int h, int w,
                            int C, int cuts, int r, int rot_dim,
                            cudaStream_t stream) {
  const long long n_pix = (long long)b * h * w;
  const long long blocks = (n_pix + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(kThreads / 32) * C * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  dscv_backward_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(c1), static_cast<const T*>(c2),
      static_cast<const T*>(para), static_cast<const float*>(centre),
      static_cast<const float*>(rot), static_cast<const float*>(trans),
      static_cast<const float*>(focal),
      static_cast<const float*>(principal), static_cast<const float*>(dcv),
      static_cast<const float*>(dpara_out), static_cast<T*>(dc1),
      static_cast<float*>(dc2), static_cast<float*>(dcentre),
      static_cast<float*>(dpara), h, w, C, cuts, r, rot_dim, n_pix);
  return cudaGetLastError();
}

}  // namespace

// c1, c2: [b, h, w, C] and para: [b, h, w, 1], all float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1); centre: [b, h, w, 1] float32; rot: [b, rot_dim]
// float32 with rot_dim 3 (small angle) or 4 (quaternion w, x, y, z);
// trans: [b, 3], focal and principal: [b, 2] float32; cv: [b, h, w,
// cuts*(2r+1)] float32 (cut-major, hypothesis-minor); para_out: [b, h, w, 1]
// float32. All contiguous, on the device of `stream`; h, w >= 2. Returns
// the CUDA error code of the launch (0 on success).
extern "C" int dscv_forward(const void* c1, const void* c2, const void* para,
                            const void* centre, const void* rot,
                            const void* trans, const void* focal,
                            const void* principal, void* cv, void* para_out,
                            int b, int h, int w, int C, int cuts, int r,
                            int rot_dim, int is_bf16, void* stream) {
  if (b <= 0 || h < 2 || w < 2 || cuts <= 0 || C % cuts != 0 || r < 0 ||
      (rot_dim != 3 && rot_dim != 4))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(c1, c2, para, centre, rot, trans,
                                      focal, principal, cv, para_out, b, h,
                                      w, C, cuts, r, rot_dim, s)
              : launch<float>(c1, c2, para, centre, rot, trans, focal,
                              principal, cv, para_out, b, h, w, C, cuts, r,
                              rot_dim, s);
  return (int)err;
}

// The VJP of dscv_forward with respect to c1, c2, para and centre. Inputs as
// for dscv_forward, plus dcv [b, h, w, cuts*(2r+1)] and dpara_out
// [b, h, w, 1], float32: the gradients of its two outputs. Outputs: dc1
// [b, h, w, C] in the inputs' type; dc2 [b, h, w, C] float32 and, unless
// dpara is null, dpara [b, h, w, 1] float32, both zeroed by the caller
// (accumulated with atomics); dcentre [b, h, w, 1] float32. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int dscv_backward(const void* c1, const void* c2, const void* para,
                             const void* centre, const void* rot,
                             const void* trans, const void* focal,
                             const void* principal, const void* dcv,
                             const void* dpara_out, void* dc1, void* dc2,
                             void* dcentre, void* dpara, int b, int h, int w,
                             int C, int cuts, int r, int rot_dim, int is_bf16,
                             void* stream) {
  if (b <= 0 || h < 2 || w < 2 || cuts <= 0 || C % cuts != 0 || r < 0 ||
      (rot_dim != 3 && rot_dim != 4))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_backward<__nv_bfloat16>(
                    c1, c2, para, centre, rot, trans, focal, principal, dcv,
                    dpara_out, dc1, dc2, dcentre, dpara, b, h, w, C, cuts, r,
                    rot_dim, s)
              : launch_backward<float>(
                    c1, c2, para, centre, rot, trans, focal, principal, dcv,
                    dpara_out, dc1, dc2, dcentre, dpara, b, h, w, C, cuts, r,
                    rot_dim, s);
  return (int)err;
}

extern "C" const char* dscv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
