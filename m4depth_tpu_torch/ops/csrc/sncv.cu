// Spatial-neighbourhood cost volume (SNCV), forward and backward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_sncv_kernel` (m4depth_tpu/ops/sncv_pallas.py:28),
// which `_sncv_forward` drives and `spatial_cost_volume_pallas` exposes.
//
// For every pixel p, every offset d of the (2r+1)^2 window and every cut of
// cc = C/cuts channels:
//     out[p, d*cuts + cut] = leaky(mean_{c in cut} c1[p, c] * c2[p + d, c])
// with c2 read as zero outside the image. Inputs are NHWC in float32 or
// bfloat16, products and sums are float32, the output is float32 NHWC with
// channels offset-major / cut-minor.
//
// What bounds it on the H100: bytes, and of those the output. Each pixel
// reads C input values of each map (32 to 384 bytes at the d6 384x384
// levels) and writes 49*cuts floats (196 to 1568 bytes); the 2*C flops per
// output value are far below the card's rate. At level 1 that is 1.2 MB
// read against 7.2 MB written.
//
// Design: a block owns a TILE x TILE pixel tile. It stages the tile of c1
// and the tile of c2 with its r-pixel halo (zero outside the image) in
// shared memory as float32, so every input value comes from device memory
// once per block. Its threads then walk (pixel, offset, cut) in the
// output's own order, so neighbouring threads write neighbouring floats and
// the dominant write is coalesced. Each output value is one thread's
// private sum over cc channels: no thread holds a pixel's whole output
// (392 values at level 6), which keeps register use small. The per-pixel
// stride in shared memory is C+1, an odd number of words, so threads that
// read neighbouring pixels of the halo fall on different banks.
//
// Backward (`sncv_backward`): the counterpart of the JAX custom VJP
// `_sncv_bwd` (m4depth_tpu/ops/sncv_pallas.py:134-161), which is plain XLA
// there; the port needs a kernel since its forward is one. Bound by bytes
// too: it reads g and the forward's output (49*cuts floats a pixel each)
// and c1, c2, and writes dc1, dc2; 4*C flops per offset and pixel. Its
// design is described at `sncv_backward_kernel`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kPreferredSmem = 100 * 1024;  // above: halve the tile
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sncv_forward_kernel(const T* __restrict__ c1, const T* __restrict__ c2,
                    float* __restrict__ out, int h, int w, int C, int cuts,
                    int r, int tile, float slope) {
  extern __shared__ float smem[];
  const int side = 2 * r + 1;
  const int noff = side * side;
  const int halo = tile + 2 * r;
  const int stride = C + 1;
  float* s2 = smem;                          // [halo * halo][stride]
  float* s1 = smem + halo * halo * stride;   // [tile * tile][stride]
  const int y0 = blockIdx.y * tile;
  const int x0 = blockIdx.x * tile;
  const long long img = (long long)blockIdx.z * h * w;

  for (int i = threadIdx.x; i < halo * halo * C; i += blockDim.x) {
    const int q = i / C, c = i - q * C;
    const int gy = y0 + q / halo - r, gx = x0 + q % halo - r;
    float v = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w)
      v = to_float(c2[(img + (long long)gy * w + gx) * C + c]);
    s2[q * stride + c] = v;
  }
  for (int i = threadIdx.x; i < tile * tile * C; i += blockDim.x) {
    const int q = i / C, c = i - q * C;
    const int gy = y0 + q / tile, gx = x0 + q % tile;
    float v = 0.f;
    if (gy < h && gx < w)
      v = to_float(c1[(img + (long long)gy * w + gx) * C + c]);
    s1[q * stride + c] = v;
  }
  __syncthreads();

  const int cc = C / cuts;
  const int per_pixel = noff * cuts;
  for (int i = threadIdx.x; i < tile * tile * per_pixel; i += blockDim.x) {
    const int p = i / per_pixel, rem = i - p * per_pixel;
    const int py = p / tile, px = p - py * tile;
    const int gy = y0 + py, gx = x0 + px;
    if (gy >= h || gx >= w) continue;
    const int o = rem / cuts, cut = rem - o * cuts;
    const int dy = o / side, dx = o - dy * side;
    const float* a = s1 + p * stride + cut * cc;
    const float* b = s2 + ((py + dy) * halo + px + dx) * stride + cut * cc;
    float acc = 0.f;
    for (int c = 0; c < cc; ++c) acc = fmaf(a[c], b[c], acc);
    const float v = acc / (float)cc;
    out[(img + (long long)gy * w + gx) * per_pixel + rem] =
        v > 0.f ? v : v * slope;
  }
}

// The VJP of sncv_forward: with g' = g * (out > 0 ? 1 : slope) / cc,
//     dc1[p, c] = sum_d g'[p, d, cut(c)] * c2[p + d, c]
//     dc2[q, c] = sum_d g'[q - d, d, cut(c)] * c1[q - d, c]
// both gathers (zero outside the image), one thread per output element. A
// block owns a TILE x TILE pixel tile of one cut of one image and stages,
// for the tile with its r-pixel halo, g' (noff values a pixel), c1 and c2
// (cc values a pixel, stride cc+1 against bank conflicts) in shared memory
// as float32. So each input value comes from device memory once per block
// and no output needs an atomic.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sncv_backward_kernel(const float* __restrict__ g,
                     const float* __restrict__ out, const T* __restrict__ c1,
                     const T* __restrict__ c2, T* __restrict__ dc1,
                     T* __restrict__ dc2, int h, int w, int C, int cuts,
                     int r, int tile, float slope) {
  extern __shared__ float smem[];
  const int side = 2 * r + 1;
  const int noff = side * side;
  const int halo = tile + 2 * r;
  const int cc = C / cuts;
  const int stride = cc + 1;
  float* sg = smem;                          // [halo * halo][noff]
  float* s1 = sg + halo * halo * noff;       // [halo * halo][stride]
  float* s2 = s1 + halo * halo * stride;     // [halo * halo][stride]
  const int y0 = blockIdx.y * tile;
  const int x0 = blockIdx.x * tile;
  const int bi = blockIdx.z / cuts;
  const int cut = blockIdx.z - bi * cuts;
  const long long img = (long long)bi * h * w;
  const float inv_cc = 1.f / (float)cc;

  for (int i = threadIdx.x; i < halo * halo * noff; i += blockDim.x) {
    const int q = i / noff, o = i - q * noff;
    const int gy = y0 + q / halo - r, gx = x0 + q % halo - r;
    float v = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const long long at =
          (img + (long long)gy * w + gx) * noff * cuts + o * cuts + cut;
      const float gv = g[at];
      v = (out[at] > 0.f ? gv : gv * slope) * inv_cc;
    }
    sg[i] = v;
  }
  for (int i = threadIdx.x; i < halo * halo * cc; i += blockDim.x) {
    const int q = i / cc, c = i - q * cc;
    const int gy = y0 + q / halo - r, gx = x0 + q % halo - r;
    float v1 = 0.f, v2 = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const long long at = (img + (long long)gy * w + gx) * C + cut * cc + c;
      v1 = to_float(c1[at]);
      v2 = to_float(c2[at]);
    }
    s1[q * stride + c] = v1;
    s2[q * stride + c] = v2;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < tile * tile * cc; i += blockDim.x) {
    const int p = i / cc, c = i - p * cc;
    const int py = p / tile, px = p - py * tile;
    const int gy = y0 + py, gx = x0 + px;
    if (gy >= h || gx >= w) continue;
    const float* gp = sg + ((py + r) * halo + px + r) * noff;
    float a1 = 0.f, a2 = 0.f;
    for (int dy = 0; dy < side; ++dy) {
      for (int dx = 0; dx < side; ++dx) {
        const int o = dy * side + dx;
        // p + d in halo coordinates, and q - d for q = p
        const int qp = (py + dy) * halo + px + dx;
        const int qm = (py + 2 * r - dy) * halo + px + 2 * r - dx;
        a1 = fmaf(gp[o], s2[qp * stride + c], a1);
        a2 = fmaf(sg[qm * noff + o], s1[qm * stride + c], a2);
      }
    }
    const long long at = (img + (long long)gy * w + gx) * C + cut * cc + c;
    store(dc1 + at, a1);
    store(dc2 + at, a2);
  }
}

size_t smem_bytes(int tile, int r, int C) {
  const size_t halo = tile + 2 * r;
  return (halo * halo + (size_t)tile * tile) * (C + 1) * sizeof(float);
}

template <typename T>
cudaError_t launch(const void* c1, const void* c2, void* out, int b, int h,
                   int w, int C, int cuts, int r, float slope,
                   cudaStream_t stream) {
  const int tile = smem_bytes(8, r, C) <= kPreferredSmem ? 8 : 4;
  const size_t smem = smem_bytes(tile, r, C);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // raise the kernel's dynamic shared-memory limit once, to the most any
  // launch has asked for (one device per process)
  static size_t smem_limit = 0;
  if (smem > smem_limit) {
    const cudaError_t err = cudaFuncSetAttribute(
        sncv_forward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    smem_limit = smem;
  }
  const dim3 grid((w + tile - 1) / tile, (h + tile - 1) / tile, b);
  sncv_forward_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(c1), static_cast<const T*>(c2),
      static_cast<float*>(out), h, w, C, cuts, r, tile, slope);
  return cudaGetLastError();
}

size_t backward_smem_bytes(int tile, int r, int C, int cuts) {
  const size_t halo = tile + 2 * r;
  const size_t noff = (size_t)(2 * r + 1) * (2 * r + 1);
  return halo * halo * (noff + 2 * (C / cuts + 1)) * sizeof(float);
}

template <typename T>
cudaError_t launch_backward(const void* g, const void* out, const void* c1,
                            const void* c2, void* dc1, void* dc2, int b,
                            int h, int w, int C, int cuts, int r, float slope,
                            cudaStream_t stream) {
  const int tile =
      backward_smem_bytes(8, r, C, cuts) <= kPreferredSmem ? 8 : 4;
  const size_t smem = backward_smem_bytes(tile, r, C, cuts);
  if (smem > kMaxSmem || (long long)b * cuts > 65535)
    return cudaErrorInvalidValue;
  static size_t smem_limit = 0;
  if (smem > smem_limit) {
    const cudaError_t err = cudaFuncSetAttribute(
        sncv_backward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    smem_limit = smem;
  }
  const dim3 grid((w + tile - 1) / tile, (h + tile - 1) / tile, b * cuts);
  sncv_backward_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(out),
      static_cast<const T*>(c1), static_cast<const T*>(c2),
      static_cast<T*>(dc1), static_cast<T*>(dc2), h, w, C, cuts, r, tile,
      slope);
  return cudaGetLastError();
}

}  // namespace

// c1, c2: [b, h, w, C] of float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1);
// out: [b, h, w, (2r+1)^2 * cuts] float32. All contiguous, on the device
// of `stream`. Returns the CUDA error code of the launch (0 on success).
extern "C" int sncv_forward(const void* c1, const void* c2, void* out, int b,
                            int h, int w, int C, int cuts, int r, float slope,
                            int is_bf16, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || cuts <= 0 || C % cuts != 0 || r < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(c1, c2, out, b, h, w, C, cuts, r,
                                      slope, s)
              : launch<float>(c1, c2, out, b, h, w, C, cuts, r, slope, s);
  return (int)err;
}

// g, out: [b, h, w, (2r+1)^2 * cuts] float32, the gradient of sncv_forward's
// output and that output; c1, c2: its inputs; dc1, dc2: [b, h, w, C] in
// the inputs' type (float32 when is_bf16 = 0, bfloat16 when 1). All
// contiguous, on the device of `stream`. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int sncv_backward(const void* g, const void* out, const void* c1,
                             const void* c2, void* dc1, void* dc2, int b,
                             int h, int w, int C, int cuts, int r,
                             float slope, int is_bf16, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || cuts <= 0 || C % cuts != 0 || r < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_backward<__nv_bfloat16>(g, out, c1, c2, dc1, dc2, b,
                                               h, w, C, cuts, r, slope, s)
              : launch_backward<float>(g, out, c1, c2, dc1, dc2, b, h, w, C,
                                       cuts, r, slope, s);
  return (int)err;
}

extern "C" const char* sncv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
