// Spatial-neighbourhood cost volume (SNCV), forward, for Hopper (sm_90a).
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

extern "C" const char* sncv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
