// Device helpers shared by the kernels (sncv.cu, dscv.cu, glue.cu,
// glue_backward.cu, glue_v1.cu, conv_epilogue.cu): input types (float32, bfloat16, float16)
// widened to float32 and float32 rounded to them, 16-byte vector loads and
// stores, the rotation matrix and the epipolar terms of a pixel (dscv.cu,
// glue.cu, glue_v1.cu), the glues' clamp, log and TFv1 bilinear resize as
// the plain tensor ops round them, the coalesced store of a block's staged
// outputs, the shared-memory limit of a kernel on the current device, and
// the dtype code of the C entry points.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// Two floats rounded to bfloat16 (round to nearest even, as
// __float2bfloat16), packed with the first in the lower half.
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Two floats rounded to float16 (round to nearest even, as
// torch.Tensor.to(torch.float16)), packed with the first in the lower half.
__device__ __forceinline__ unsigned pack_half2(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Both halves of a word (the lower one first) widened to float32.
__device__ __forceinline__ void unpack_half2(unsigned u, float* f) {
  const float2 v = __half22float2(*reinterpret_cast<const __half2*>(&u));
  f[0] = v.x;
  f[1] = v.y;
}

// Elements of T in one 16-byte vector.
template <typename T>
constexpr int kVec = 16 / sizeof(T);

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// VEC consecutive elements of T: VEC is kVec<T> (one 16-byte load, from an
// address aligned to 16 bytes), 4 for bfloat16 and float16 (one 8-byte
// load, aligned to 8) or 1 (one scalar load). `load_raw` reads
// them as they are stored (Raw), `unpack` widens them to float32, `load`
// does both; `store` writes VEC floats rounded to T. A kernel that keeps
// many loads in flight holds them as Raw.
template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load_raw(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void unpack(Raw v, float* f) { f[0] = v; }
  static __device__ __forceinline__ void load(const float* p, float* f) {
    unpack(load_raw(p), f);
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    *p = f[0];
  }
};

template <>
struct Vec<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load_raw(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void unpack(Raw v, float* f) {
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  static __device__ __forceinline__ void load(const float* p, float* f) {
    unpack(load_raw(p), f);
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

// A bfloat16 is the upper half of the float32 with the same value, and the
// element at the lower address sits in the lower half of each word.
template <>
struct Vec<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw load_raw(const __nv_bfloat16* p) {
    return *reinterpret_cast<const unsigned short*>(p);
  }
  static __device__ __forceinline__ void unpack(Raw v, float* f) {
    f[0] = __uint_as_float((unsigned)v << 16);
  }
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* f) {
    unpack(load_raw(p), f);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* f) {
    *p = __float2bfloat16(f[0]);
  }
};

template <>
struct Vec<__nv_bfloat16, 4> {
  using Raw = uint2;
  static __device__ __forceinline__ Raw load_raw(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ void unpack(Raw v, float* f) {
    f[0] = __uint_as_float(v.x << 16);
    f[1] = __uint_as_float(v.x & 0xffff0000u);
    f[2] = __uint_as_float(v.y << 16);
    f[3] = __uint_as_float(v.y & 0xffff0000u);
  }
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* f) {
    unpack(load_raw(p), f);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* f) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load_raw(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(Raw v, float* f) {
    const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* f) {
    unpack(load_raw(p), f);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* f) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                   pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
  }
};

// float16: loads and stores as bfloat16's, of the same widths and under the
// same alignment; the conversions round to nearest even.
template <>
struct Vec<__half, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw load_raw(const __half* p) {
    return *reinterpret_cast<const unsigned short*>(p);
  }
  static __device__ __forceinline__ void unpack(Raw v, float* f) {
    f[0] = __half2float(__ushort_as_half(v));
  }
  static __device__ __forceinline__ void load(const __half* p, float* f) {
    unpack(load_raw(p), f);
  }
  static __device__ __forceinline__ void store(__half* p, const float* f) {
    *p = __float2half_rn(f[0]);
  }
};

template <>
struct Vec<__half, 4> {
  using Raw = uint2;
  static __device__ __forceinline__ Raw load_raw(const __half* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ void unpack(Raw v, float* f) {
    unpack_half2(v.x, f);
    unpack_half2(v.y, f + 2);
  }
  static __device__ __forceinline__ void load(const __half* p, float* f) {
    unpack(load_raw(p), f);
  }
  static __device__ __forceinline__ void store(__half* p, const float* f) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_half2(f[0], f[1]), pack_half2(f[2], f[3]));
  }
};

template <>
struct Vec<__half, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load_raw(const __half* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(Raw v, float* f) {
    unpack_half2(v.x, f);
    unpack_half2(v.y, f + 2);
    unpack_half2(v.z, f + 4);
    unpack_half2(v.w, f + 6);
  }
  static __device__ __forceinline__ void load(const __half* p, float* f) {
    unpack(load_raw(p), f);
  }
  static __device__ __forceinline__ void store(__half* p, const float* f) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_half2(f[0], f[1]), pack_half2(f[2], f[3]),
                   pack_half2(f[4], f[5]), pack_half2(f[6], f[7]));
  }
};

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
// epipolar_terms): proj = (px, py), delta = (dx, dy), rho and rho clipped
// below at 1e-12 = den, alpha, and the pixel centre relative to c =
// (mx, my). The DSCV kernels read the sample positions from them, glue.cu
// the depth of a parallax.
struct Epipolar {
  float px, py, dx, dy, rho, den, alpha, mx, my;
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
  e.alpha = rz;
  e.px = rx * fx / rz;
  e.py = ry * fy / rz;
  e.dx = tx * fx - tz * e.px;
  e.dy = ty * fy - tz * e.py;
  e.rho = sqrtf(e.dx * e.dx + e.dy * e.dy);
  e.den = fmaxf(e.rho, 1e-12f);
  return e;
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// v rounded to T (to nearest even, as Tensor.to) and widened back.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// torch.clamp(v, lo, hi) in float32: a NaN stays NaN.
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// log(clamp(x * mul, min=1e-12)): the refiner's log-parallax channels.
__device__ __forceinline__ float log_safe(float x, float mul) {
  const float v = __fmul_rn(x, mul);
  return logf(v < 1e-12f ? 1e-12f : v);
}

// One axis of resize_bilinear_v1 (geometry/resize.py::_lerp_axis on the
// TFv1 grid: src = dst * scale, no half-pixel offset): the taps and the
// fraction of output index i. `same` where the axis keeps its size: the
// plain version returns it untouched.
struct Axis {
  int lo, hi;
  float frac;
  bool same;
};

__device__ __forceinline__ Axis lerp_axis(int i, int src, int dst,
                                          float scale) {
  Axis a;
  a.same = src == dst;
  if (a.same) {
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

// a + (b - a) * t, each operation rounded as a tensor op rounds it.
__device__ __forceinline__ float lerp(float a, float b, float t) {
  return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), t));
}

// Channel ch of column xx of the map m ([hd, wd, n], one image) resampled
// along the height.
__device__ __forceinline__ float column(const float* __restrict__ m, int wd,
                                        int n, int ch, const Axis& ay,
                                        int xx) {
  const float a = m[((long long)ay.lo * wd + xx) * n + ch];
  if (ay.same) return a;
  return lerp(a, m[((long long)ay.hi * wd + xx) * n + ch], ay.frac);
}

// Channel ch of the map m at this level's pixel: the height first, then the
// width, as resize_bilinear_v1 does.
__device__ __forceinline__ float upsample(const float* __restrict__ m,
                                          int wd, int n, int ch,
                                          const Axis& ay, const Axis& ax) {
  const float v0 = column(m, wd, n, ch, ay, ax.lo);
  if (ax.same) return v0;
  return lerp(v0, column(m, wd, n, ch, ay, ax.hi), ax.frac);
}

// The dtype code of the C entry points' inputs.
enum DType : int { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

// The block's threads copy n floats from shared memory to dst, neighbouring
// threads on neighbouring addresses, as 16-byte vectors when dst is aligned
// to 16 bytes (src, shared memory, always is).
__device__ __forceinline__ void store_block(float* __restrict__ dst,
                                            const float* __restrict__ src,
                                            int n) {
  int i = threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n4 = n >> 2;
    for (; i < n4; i += blockDim.x)
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(src)[i];
    i = (n4 << 2) + threadIdx.x;
  }
  for (; i < n; i += blockDim.x) dst[i] = src[i];
}

// Lets `Kernel` launch with `bytes` of dynamic shared memory on the current
// device. Above 48 KB that takes cudaFuncSetAttribute, which holds per
// device, so the largest size set is kept per device.
constexpr int kMaxDevices = 64;

template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  static size_t limit[kMaxDevices] = {};
  if (bytes <= limit[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) limit[dev] = bytes;
  return err;
}

}  // namespace
