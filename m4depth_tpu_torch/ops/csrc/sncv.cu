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
// output value, on the CUDA cores in float32, take about a third of the
// bytes' time at level 1. At level 1 that is 1.2 MB read against 7.2 MB
// written. At the deep levels (6x6 to 24x24) the work is tiny and the time
// is latency: how long one thread's chain of loads and multiply-adds is.
//
// Forward design (`sncv_forward_kernel`), in three parts:
// - Work split. A thread owns two horizontally adjacent pixels, one row dy
//   of the window and one cut, and computes their 2 x (2r+1) outputs of that
//   row: it slides along 2r+2 positions of c2's row y+dy-r, each position
//   feeding one offset of each pixel, so a c2 vector read from memory feeds
//   two multiply-adds per channel; c1's values of the two pixels stay in
//   registers. Channels are read as 16-byte vectors (8 bfloat16 or 4
//   float32) through the L1 cache, straight into registers: neighbouring
//   threads read overlapping positions, so the cache, not a shared-memory
//   stage, serves the reuse, and no thread waits on a block-wide barrier
//   before it computes. Halo positions outside the image are skipped and
//   count as zero. Each thread's (pixels, dy, cut) is fixed once from its
//   index: no division per output. Each output sums its channels in
//   ascending order, as the plain version's float32 sum does.
// - Blocks. A block owns a segment of up to 32 pixels of one image row, all
//   cuts and either every row of the window or one of them, so its outputs
//   are whole pixel rows (or runs of (2r+1)*cuts floats) of the output. The
//   launch narrows the segment, then splits the window's rows across
//   blocks, until the grid has a wave of blocks (132, the H100's SM count)
//   or cannot be cut further. At b=1 the d6 384x384 levels launch 1152,
//   288, 144 (segments of 16), 168, 168 and 126 blocks (the last three one
//   window row a block). Nothing in shared memory grows with C.
// - Stores. The threads put their outputs in shared memory and the block
//   writes its contiguous output range with 16-byte stores, neighbouring
//   threads on neighbouring addresses: the dominant write is coalesced.
//
// Backward (`sncv_backward`): the counterpart of the JAX custom VJP
// `_sncv_bwd` (m4depth_tpu/ops/sncv_pallas.py:134-161), which is plain XLA
// there; the port needs a kernel since its forward is one. Bound by bytes
// too: it reads g and the forward's output (49*cuts floats a pixel each)
// and c1, c2, and writes dc1, dc2; 4*C flops per offset and pixel. Its
// design is described at `sncv_backward_kernel`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "common.cuh"

namespace {

// the backward: threads of a block, the shared memory above which its tile
// halves, and the most a block may have
constexpr int kThreads = 256;
constexpr size_t kPreferredSmem = 100 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;
// the forward: threads of a block at most, pixels of a segment at most, and
// the blocks that make one wave on the H100 (132 SMs)
constexpr int kForwardThreads = 256;
constexpr int kMaxSegment = 32;
constexpr long long kWave = 132;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Grid: x over (image row, segment of `seg` pixels), y over groups of `dys`
// rows of the window. Block: cuts x seg/2 x dys threads, the cut fastest.
// Shared memory: the block's outputs, [seg][dys][2R+1][cuts] floats.
template <typename T, int VEC, int R>
__global__ void __launch_bounds__(kForwardThreads)
sncv_forward_kernel(const T* __restrict__ c1, const T* __restrict__ c2,
                    float* __restrict__ out, int h, int w, int C, int cuts,
                    int seg, int nseg, int dys, float slope) {
  constexpr int S = 2 * R + 1;
  extern __shared__ __align__(16) float stage[];
  const int cc = C / cuts;
  const int npairs = seg >> 1;
  const int t = threadIdx.x;
  const int cut = t % cuts;
  const int pair = (t / cuts) % npairs;
  const int dyl = t / (cuts * npairs);
  const int dy = blockIdx.y * dys + dyl;
  const long long row = blockIdx.x / nseg;            // b * h + y
  const int x0 = (int)(blockIdx.x - row * nseg) * seg;
  const int y = (int)(row % h);
  const int xa = x0 + 2 * pair;                        // the pair's left pixel
  const int yy = y + dy - R;                           // c2's row

  float acc_a[S], acc_b[S];
#pragma unroll
  for (int i = 0; i < S; ++i) acc_a[i] = acc_b[i] = 0.f;
  if (xa < w && yy >= 0 && yy < h) {
    const bool has_b = xa + 1 < w;
    const T* a_ptr = c1 + (row * w + xa) * C + cut * cc;
    const T* q_row = c2 + (row + dy - R) * w * C + cut * cc;
    for (int c = 0; c < cc; c += VEC) {
      float va[VEC], vb[VEC];
      Vec<T, VEC>::load(a_ptr + c, va);
      if (has_b) {
        Vec<T, VEC>::load(a_ptr + C + c, vb);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) vb[e] = 0.f;
      }
#pragma unroll
      for (int i = 0; i <= S; ++i) {
        // position i of the row is offset dx = i of pixel a, i - 1 of b
        const int xx = xa - R + i;
        float v[VEC];
        if (xx >= 0 && xx < w) {
          Vec<T, VEC>::load(q_row + (long long)xx * C + c, v);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          if (i < S) acc_a[i] = fmaf(va[e], v[e], acc_a[i]);
          if (i > 0) acc_b[i - 1] = fmaf(vb[e], v[e], acc_b[i - 1]);
        }
      }
    }
  }

  // stage [pixel][dy of the block][dx][cut]; pixels past the image's edge
  // land in slots that are not stored
  const float inv_cc = 1.f / (float)cc;
  const int run = dys * S * cuts;                      // floats a pixel
  float* st = stage + (2 * pair) * run + dyl * S * cuts + cut;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float a = acc_a[i] * inv_cc, b = acc_b[i] * inv_cc;
    st[i * cuts] = a > 0.f ? a : a * slope;
    st[run + i * cuts] = b > 0.f ? b : b * slope;
  }
  __syncthreads();

  const int n = min(seg, w - x0);
  const int per_pixel = S * S * cuts;
  float* dst = out + (row * w + x0) * per_pixel + blockIdx.y * run;
  if (run == per_pixel) {
    store_block(dst, stage, n * run);                  // one contiguous range
  } else {
    for (int i = t; i < n * run; i += blockDim.x) {
      const int px = i / run;
      dst[(long long)px * per_pixel + (i - px * run)] = stage[i];
    }
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

// The forward's grid: segments of `seg` pixels, `nseg` to an image row, and
// `dys` rows of the window to a block.
struct ForwardGrid {
  int seg, nseg, dys;
};

// Every row of the window in one block (so a block stores whole pixel rows)
// while segments of 8 pixels or more still give a wave of blocks; else one
// row of the window a block, with segments down to one pair of pixels. The
// segment starts as wide as kForwardThreads threads allow and halves until
// the grid makes a wave. False if one pair's cuts need too many threads.
bool forward_grid(long long b, int h, int w, int cuts, int S,
                  ForwardGrid* g) {
  const long long rows = b * h;
  const int w_even = (w + 1) & ~1;
  for (const int dys : {S, 1}) {
    if (cuts * dys > kForwardThreads) continue;
    const int pairs =
        std::min(kMaxSegment / 2, kForwardThreads / (cuts * dys));
    const int min_seg = dys == S ? 8 : 2;
    int seg = std::min(2 * pairs, w_even);
    auto blocks = [&](int s) {
      return rows * ((w + s - 1) / s) * (S / dys);
    };
    while (blocks(seg) < kWave && seg > min_seg)
      seg = std::max(min_seg, ((seg >> 1) + 1) & ~1);
    if (blocks(seg) >= kWave || dys == 1) {
      *g = {seg, (w + seg - 1) / seg, dys};
      return true;
    }
  }
  return false;
}

template <typename T, int VEC, int R>
cudaError_t launch_forward(const void* c1, const void* c2, void* out, int b,
                           int h, int w, int C, int cuts, float slope,
                           cudaStream_t stream) {
  constexpr int S = 2 * R + 1;
  ForwardGrid g;
  if (!forward_grid(b, h, w, cuts, S, &g)) return cudaErrorInvalidValue;
  const long long blocks = (long long)b * h * g.nseg;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, S / g.dys);
  const int threads = cuts * (g.seg / 2) * g.dys;
  const size_t smem = (size_t)g.seg * g.dys * S * cuts * sizeof(float);
  sncv_forward_kernel<T, VEC, R><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(c1), static_cast<const T*>(c2),
      static_cast<float*>(out), h, w, C, cuts, g.seg, g.nseg, g.dys, slope);
  return cudaGetLastError();
}

// The window's radius r is a template argument (the accumulators stay in
// registers): 1 to 4, 3x3 to 9x9 windows.
template <typename T, int VEC>
cudaError_t launch_forward_r(const void* c1, const void* c2, void* out,
                             int b, int h, int w, int C, int cuts, int r,
                             float slope, cudaStream_t stream) {
  switch (r) {
    case 1:
      return launch_forward<T, VEC, 1>(c1, c2, out, b, h, w, C, cuts, slope,
                                       stream);
    case 2:
      return launch_forward<T, VEC, 2>(c1, c2, out, b, h, w, C, cuts, slope,
                                       stream);
    case 3:
      return launch_forward<T, VEC, 3>(c1, c2, out, b, h, w, C, cuts, slope,
                                       stream);
    case 4:
      return launch_forward<T, VEC, 4>(c1, c2, out, b, h, w, C, cuts, slope,
                                       stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// 16-byte loads where every vector of a cut is aligned, else scalar ones.
template <typename T>
cudaError_t launch(const void* c1, const void* c2, void* out, int b, int h,
                   int w, int C, int cuts, int r, float slope,
                   cudaStream_t stream) {
  if ((C / cuts) % kVec<T> == 0 && aligned16(c1) && aligned16(c2))
    return launch_forward_r<T, kVec<T>>(c1, c2, out, b, h, w, C, cuts, r,
                                        slope, stream);
  return launch_forward_r<T, 1>(c1, c2, out, b, h, w, C, cuts, r, slope,
                                stream);
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
// out: [b, h, w, (2r+1)^2 * cuts] float32; 1 <= r <= 4. All contiguous, on
// the device of `stream`. Returns the CUDA error code of the launch (0 on
// success).
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
