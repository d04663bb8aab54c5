// Fused parallax-sweeping cost volume (DSCV), forward, for Hopper (sm_90a).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

  float R[9];
  rot_mat(rot + bi * rot_dim, rot_dim, R);
  const float fx = focal[2 * bi], fy = focal[2 * bi + 1];
  const float cx = principal[2 * bi], cy = principal[2 * bi + 1];
  const float tx = trans[3 * bi], ty = trans[3 * bi + 1];
  const float tz = trans[3 * bi + 2];
  // pixel ray and its rotation (geometry/parallax.py epipolar_terms)
  const float mx = ((float)x + 0.5f) - cx, my = ((float)y + 0.5f) - cy;
  const float hx = mx / fx, hy = my / fy;
  const float rx = R[0] * hx + R[1] * hy + R[2];
  const float ry = R[3] * hx + R[4] * hy + R[5];
  const float rz = R[6] * hx + R[7] * hy + R[8];
  const float px = rx * fx / rz, py = ry * fy / rz;
  const float dx = tx * fx - tz * px, dy = ty * fy - tz * py;
  const float den = fmaxf(sqrtf(dx * dx + dy * dy), 1e-12f);
  const float disp = fminf(fmaxf(centre[p] + (float)(k - r), 1e-6f), 1e6f);
  const float qx = (float)x + ((px + dx / den * disp) - mx);
  const float qy = (float)y + ((py + dy / den * disp) - my);

  const float x0f = fminf(fmaxf(floorf(qx), 0.f), (float)(w - 2));
  const float y0f = fminf(fmaxf(floorf(qy), 0.f), (float)(h - 2));
  const float ax = fminf(fmaxf(qx - x0f, 0.f), 1.f);
  const float ay = fminf(fmaxf(qy - y0f, 0.f), 1.f);
  const long long tap = img + (long long)y0f * w + (long long)x0f;

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

extern "C" const char* dscv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
