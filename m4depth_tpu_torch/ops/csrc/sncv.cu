// Spatial-neighbourhood cost volume (SNCV), forward and backward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_sncv_kernel` (m4depth_tpu/ops/sncv_pallas.py:28),
// which `_sncv_forward` drives and `spatial_cost_volume_pallas` exposes.
//
// For every pixel p, every offset d of the (2r+1)^2 window and every cut of
// cc = C/cuts channels:
//     out[p, d*cuts + cut] = leaky(mean_{c in cut} c1[p, c] * c2[p + d, c])
// with c2 read as zero outside the image. Inputs are NHWC in float32,
// bfloat16 or float16, products and sums are float32, the output is float32
// NHWC with channels offset-major / cut-minor.
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
//   registers. Channels are read as 16-byte vectors (8 bfloat16 or
//   float16, or 4 float32) through the L1 cache, straight into registers:
//   neighbouring threads read overlapping positions, so the cache, not a
//   shared-memory stage, serves the reuse, and no thread waits on a
//   block-wide barrier before it computes. Halo positions outside the
//   image are skipped and count as zero. Each thread's (pixels, dy, cut) is fixed once from its
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
// too: it reads g and the forward's output (49*cuts floats a pixel each,
// 80% of the bytes at every level) and c1 (and c2), and writes dc1 (and
// dc2); 4*C flops per offset and pixel. An earlier design read g and out
// for one cut at a time (addresses `cuts` floats apart), staged a tile in
// float32 with a division per element, and had too few blocks at the deep
// levels.
//
// Backward design (`sncv_backward_kernel`):
// - Both gradients as gathers over the same neighbours q + d: dc1 takes
//   g'[q, d] * c2[q + d], dc2 takes g'[q + d, -d] * c1[q + d]; with c1 is
//   c2 the kernel adds the two coefficients and writes one gradient,
//   rounded once, so autograd adds nothing after it.
// - A block stages g' = g * (out > 0 ? 1 : slope) / cc for its tile and the
//   r-pixel halo, every cut, from whole contiguous pixel rows of g and out
//   (16-byte loads where a pixel's row is a whole number of vectors), once.
// - A thread owns one 16-byte channel vector of one pixel (and, at the
//   small levels, one group of the window's rows), fixed once from its
//   index; it reads both coefficients from shared memory and the
//   neighbours' vectors from device memory through L1, and keeps its sums
//   in registers. Row groups add up in shared memory, in order.
// - Tiles start at 16x16 and halve while the block has more than 512
//   threads or its halo more than 128 KB of g', then while the grid has
//   less than a wave of blocks; a grid of few threads splits the window's
//   7 rows across threads. Measured (NVIDIA H100 80GB HBM3, 700 W): a
//   56 KB tile budget read 25% slower in all than 100 KB, and 128 KB 2%
//   faster (its level 2 8%).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "common.cuh"

namespace {

// the backward: threads of a block at most, and at most before its rows are
// split; the shared memory above which its tile halves, and the most a
// block may have; the threads of a grid under which the window's rows are
// split across threads
constexpr int kBackwardThreads = 768;
constexpr int kTileThreads = 512;
constexpr size_t kPreferredSmem = 128 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr long long kFewThreads = 32 * 1024;
// the forward: threads of a block at most, pixels of a segment at most, and
// the blocks that make one wave on the H100 (132 SMs)
constexpr int kForwardThreads = 256;
constexpr int kMaxSegment = 32;
constexpr long long kWave = 132;

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

// The VJP of sncv_forward. With g'[p, d, cut] = g * (out > 0 ? 1 : slope)
// / cc and the mirrored offset -d,
//     dc1[q, c] = sum_d g'[q, d, cut(c)]      * c2[q + d, c]
//     dc2[q, c] = sum_d g'[q + d, -d, cut(c)] * c1[q + d, c]
// both gathers over the same neighbours q + d (zero outside the image), so
// no output needs an atomic. With c1 is c2 (SAME) one gradient, their sum:
//     dc[q, c]  = sum_d (g'[q, d, cut] + g'[q + d, -d, cut]) * c1[q + d, c]
// Grid: x over (image, tile row, tile column) of tw x th pixel tiles.
// Block: threads over (channel vector, pixel of the tile, group of window
// rows), the vector fastest. Shared memory: g' of the tile and its r-pixel
// halo (clipped to the image), every cut, `stride` floats a pixel; after
// the gathers, the row groups' partial sums.
template <typename T, int VEC, int R, bool SAME>
__global__ void __launch_bounds__(kBackwardThreads)
sncv_backward_kernel(const float* __restrict__ g,
                     const float* __restrict__ out, const T* __restrict__ c1,
                     const T* __restrict__ c2, T* __restrict__ dc1,
                     T* __restrict__ dc2, int h, int w, int C, int cuts,
                     int tw, int th, int ntx, int nty, int nr, int stage4,
                     float slope) {
  constexpr int S = 2 * R + 1;
  extern __shared__ __align__(16) float sg[];
  const int row = S * S * cuts;                // g' floats a pixel
  const int stride = row | 1;                  // odd: pixels in other banks
  const int vecs = C / VEC;
  const int cc = C / cuts;
  const int t = threadIdx.x;
  int bx = blockIdx.x;
  const int tx = bx % ntx;
  bx /= ntx;
  const int ty = bx % nty;
  const int bi = bx / nty;
  const long long img = (long long)bi * h * w;
  const int x0 = tx * tw, y0 = ty * th;
  const int hx0 = max(x0 - R, 0), hx1 = min(x0 + tw + R, w);
  const int hy0 = max(y0 - R, 0), hy1 = min(y0 + th + R, h);
  const int hw = hx1 - hx0;

  // 1. g' of the halo: each of its rows is one contiguous range of g and of
  // out, read with neighbouring threads on neighbouring floats (16-byte
  // vectors where a pixel's row is a whole number of them)
  const float inv_cc = 1.f / (float)cc;
  const int n_row = hw * row;
  for (int yy = hy0; yy < hy1; ++yy) {
    const long long at = (img + (long long)yy * w + hx0) * row;
    float* dst = sg + (yy - hy0) * hw * stride;
    if (stage4) {
      const float4* g4 = reinterpret_cast<const float4*>(g + at);
      const float4* o4 = reinterpret_cast<const float4*>(out + at);
      for (int i = t; i < (n_row >> 2); i += blockDim.x) {
        const float4 gv = __ldg(g4 + i), ov = __ldg(o4 + i);
        const int px = (4 * i) / row, o = 4 * i - px * row;
        float* d = dst + px * stride + o;
        d[0] = (ov.x > 0.f ? gv.x : gv.x * slope) * inv_cc;
        d[1] = (ov.y > 0.f ? gv.y : gv.y * slope) * inv_cc;
        d[2] = (ov.z > 0.f ? gv.z : gv.z * slope) * inv_cc;
        d[3] = (ov.w > 0.f ? gv.w : gv.w * slope) * inv_cc;
      }
    } else {
      for (int i = t; i < n_row; i += blockDim.x) {
        const float gv = __ldg(g + at + i), ov = __ldg(out + at + i);
        const int px = i / row;
        dst[px * stride + i - px * row] =
            (ov > 0.f ? gv : gv * slope) * inv_cc;
      }
    }
  }
  __syncthreads();

  // 2. the gathers: this thread's channel vector j of pixel (x, y), over
  // the window rows dy = rg, rg + nr, ...; both coefficients come from
  // shared memory, the neighbours' vectors from device memory through L1
  const int P = tw * th;
  const int j = t % vecs;
  const int pl = (t / vecs) % P;
  const int rg = t / (vecs * P);
  const int x = x0 + pl % tw, y = y0 + pl / tw;
  const bool active = x < w && y < h && rg < nr;
  const int cut = (j * VEC) / cc;
  float acc1[VEC], acc2[VEC];
#pragma unroll
  for (int u = 0; u < VEC; ++u) acc1[u] = acc2[u] = 0.f;
  if (active) {
    const float* sa =
        sg + ((y - hy0) * hw + (x - hx0)) * stride + cut;  // g'[q, d]
    for (int dy = rg; dy < S; dy += nr) {
      const int yy = y + dy - R;
      if (yy < 0 || yy >= h) continue;
      const long long nb = (img + (long long)yy * w) * C + j * VEC;
      // g'[q + d, -d] of the neighbour in column xx: offset
      // (2R - dy) * S + 2R - dx
      const float* sb = sg + (yy - hy0) * hw * stride +
                        ((2 * R - dy) * S + 2 * R) * cuts + cut;
#pragma unroll
      for (int dx = 0; dx < S; ++dx) {
        const int xx = x + dx - R;
        if (xx < 0 || xx >= w) continue;
        const float ga = sa[(dy * S + dx) * cuts];
        const float gb = sb[(xx - hx0) * stride - dx * cuts];
        float v1[VEC];
        Vec<T, VEC>::load(c1 + nb + (long long)xx * C, v1);
        if (SAME) {
          const float gs = ga + gb;
#pragma unroll
          for (int u = 0; u < VEC; ++u) acc1[u] = fmaf(gs, v1[u], acc1[u]);
        } else {
          float v2[VEC];
          Vec<T, VEC>::load(c2 + nb + (long long)xx * C, v2);
#pragma unroll
          for (int u = 0; u < VEC; ++u) {
            acc1[u] = fmaf(ga, v2[u], acc1[u]);
            acc2[u] = fmaf(gb, v1[u], acc2[u]);
          }
        }
      }
    }
  }

  // 3. the row groups' partial sums, added in order by group 0, then the
  // gradients rounded once to T
  if (nr > 1) {
    constexpr int NA = SAME ? 1 : 2;
    __syncthreads();                           // g' is read: reuse sg
    const int slot = (t % (vecs * P)) * NA * VEC;
    const int span = vecs * P * NA * VEC;
    if (rg > 0 && rg < nr) {
      float* d = sg + (rg - 1) * span + slot;
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        d[u] = acc1[u];
        if (!SAME) d[VEC + u] = acc2[u];
      }
    }
    __syncthreads();
    if (rg == 0) {
      for (int i = 1; i < nr; ++i) {
        const float* d = sg + (i - 1) * span + slot;
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          acc1[u] += d[u];
          if (!SAME) acc2[u] += d[VEC + u];
        }
      }
    }
  }
  if (active && rg == 0) {
    const long long at = (img + (long long)y * w + x) * C + j * VEC;
    Vec<T, VEC>::store(dc1 + at, acc1);
    if (!SAME) Vec<T, VEC>::store(dc2 + at, acc2);
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

// The backward's grid: tiles of tw x th pixels, ntx x nty of them to an
// image, and nr groups of the window's rows to a block.
struct BackwardGrid {
  int tw, th, ntx, nty, nr;
  size_t smem;
};

// Starts from 16 x 16 tiles, halving the longer side until the block has at
// most kTileThreads threads and its halo's g' fits kPreferredSmem, then
// while the grid has less than a wave of blocks (down to 2 x 2 tiles).
// Where the threads are still few, the window's rows go to as many groups
// of threads (a level of a few hundred pixels). False if even a one-pixel
// tile does not fit.
bool backward_grid(long long b, int h, int w, int C, int cuts, int vec,
                   int R, bool same, BackwardGrid* g) {
  const int S = 2 * R + 1;
  const int vecs = C / vec;
  const size_t stride = (size_t)(S * S * cuts) | 1;
  int tw = std::min(16, w), th = std::min(16, h);
  auto halo = [&](int tw_, int th_) {
    return (size_t)std::min(th_ + 2 * R, h) * std::min(tw_ + 2 * R, w) *
           stride * sizeof(float);
  };
  auto blocks = [&](int tw_, int th_) {
    return b * ((w + tw_ - 1) / tw_) * ((h + th_ - 1) / th_);
  };
  auto halve = [&]() {
    if (tw >= th) tw = (tw + 1) / 2; else th = (th + 1) / 2;
  };
  while ((tw * th * vecs > kTileThreads || halo(tw, th) > kPreferredSmem) &&
         tw * th > 1)
    halve();
  while (blocks(tw, th) < kWave && tw * th > 4) halve();
  if (tw * th * vecs > kBackwardThreads || halo(tw, th) > kMaxSmem)
    return false;
  int nr = 1;
  if (blocks(tw, th) * tw * th * vecs < kFewThreads &&
      tw * th * vecs * S <= kBackwardThreads)
    nr = S;
  const size_t partial =
      (size_t)(nr - 1) * tw * th * C * (same ? 1 : 2) * sizeof(float);
  *g = {tw, th, (w + tw - 1) / tw, (h + th - 1) / th, nr,
        std::max(halo(tw, th), partial)};
  return g->smem <= kMaxSmem;
}

template <typename T, int VEC, int R, bool SAME>
cudaError_t launch_backward(const void* g, const void* out, const void* c1,
                            const void* c2, void* dc1, void* dc2, int b,
                            int h, int w, int C, int cuts, float slope,
                            cudaStream_t stream) {
  BackwardGrid gr;
  if (!backward_grid(b, h, w, C, cuts, VEC, R, SAME, &gr))
    return cudaErrorInvalidValue;
  const long long blocks = (long long)b * gr.ntx * gr.nty;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t err =
      allow_smem<sncv_backward_kernel<T, VEC, R, SAME>>(gr.smem);
  if (err != cudaSuccess) return err;
  const int threads = gr.tw * gr.th * (C / VEC) * gr.nr;
  const int row = (2 * R + 1) * (2 * R + 1) * cuts;
  const int stage4 = row % 4 == 0 && aligned16(g) && aligned16(out);
  sncv_backward_kernel<T, VEC, R, SAME>
      <<<(unsigned)blocks, threads, gr.smem, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(out),
      static_cast<const T*>(c1), static_cast<const T*>(c2),
      static_cast<T*>(dc1), static_cast<T*>(dc2), h, w, C, cuts, gr.tw,
      gr.th, gr.ntx, gr.nty, gr.nr, stage4, slope);
  return cudaGetLastError();
}

template <typename T, int VEC, int R>
cudaError_t launch_backward_same(const void* g, const void* out,
                                 const void* c1, const void* c2, void* dc1,
                                 void* dc2, int b, int h, int w, int C,
                                 int cuts, int same, float slope,
                                 cudaStream_t stream) {
  if (same)
    return launch_backward<T, VEC, R, true>(g, out, c1, c1, dc1, dc1, b, h,
                                            w, C, cuts, slope, stream);
  return launch_backward<T, VEC, R, false>(g, out, c1, c2, dc1, dc2, b, h,
                                           w, C, cuts, slope, stream);
}

// The radius as a template argument, as for the forward; 16-byte loads and
// stores where every vector of a cut is aligned, else scalar ones.
template <typename T, int VEC>
cudaError_t launch_backward_r(const void* g, const void* out, const void* c1,
                              const void* c2, void* dc1, void* dc2, int b,
                              int h, int w, int C, int cuts, int r, int same,
                              float slope, cudaStream_t stream) {
  switch (r) {
    case 1:
      return launch_backward_same<T, VEC, 1>(g, out, c1, c2, dc1, dc2, b, h,
                                             w, C, cuts, same, slope, stream);
    case 2:
      return launch_backward_same<T, VEC, 2>(g, out, c1, c2, dc1, dc2, b, h,
                                             w, C, cuts, same, slope, stream);
    case 3:
      return launch_backward_same<T, VEC, 3>(g, out, c1, c2, dc1, dc2, b, h,
                                             w, C, cuts, same, slope, stream);
    case 4:
      return launch_backward_same<T, VEC, 4>(g, out, c1, c2, dc1, dc2, b, h,
                                             w, C, cuts, same, slope, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* out, const void* c1,
                       const void* c2, void* dc1, void* dc2, int b, int h,
                       int w, int C, int cuts, int r, int same, float slope,
                       cudaStream_t stream) {
  const bool vec = (C / cuts) % kVec<T> == 0 && aligned16(c1) &&
                   aligned16(c2) && aligned16(dc1) && aligned16(dc2);
  if (vec)
    return launch_backward_r<T, kVec<T>>(g, out, c1, c2, dc1, dc2, b, h, w,
                                         C, cuts, r, same, slope, stream);
  return launch_backward_r<T, 1>(g, out, c1, c2, dc1, dc2, b, h, w, C, cuts,
                                 r, same, slope, stream);
}

}  // namespace

// c1, c2: [b, h, w, C] of float32 (dtype = 0), bfloat16 (1) or float16
// (2); out: [b, h, w, (2r+1)^2 * cuts] float32; 1 <= r <= 4. All
// contiguous, on the device of `stream`. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int sncv_forward(const void* c1, const void* c2, void* out, int b,
                            int h, int w, int C, int cuts, int r, float slope,
                            int dtype, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || cuts <= 0 || C % cuts != 0 || r < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return (int)launch<float>(c1, c2, out, b, h, w, C, cuts, r, slope, s);
    case kBFloat16:
      return (int)launch<__nv_bfloat16>(c1, c2, out, b, h, w, C, cuts, r,
                                        slope, s);
    case kFloat16:
      return (int)launch<__half>(c1, c2, out, b, h, w, C, cuts, r, slope, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// g, out: [b, h, w, (2r+1)^2 * cuts] float32, the gradient of sncv_forward's
// output and that output; c1, c2: its inputs; dc1, dc2: [b, h, w, C] in
// the inputs' type (`dtype` as for sncv_forward); 1 <= r <= 4.
// With same = 1 (c1 and c2 are one tensor) it writes one gradient, their
// sum, to dc1, and reads neither c2 nor dc2. All contiguous, on the device
// of `stream`, which is the current device. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int sncv_backward(const void* g, const void* out, const void* c1,
                             const void* c2, void* dc1, void* dc2, int b,
                             int h, int w, int C, int cuts, int r, int same,
                             float slope, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || cuts <= 0 || C % cuts != 0 || r < 0)
    return cudaErrorInvalidValue;
  if (same) c2 = c1, dc2 = dc1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return (int)launch_bwd<float>(g, out, c1, c2, dc1, dc2, b, h, w, C,
                                    cuts, r, same, slope, s);
    case kBFloat16:
      return (int)launch_bwd<__nv_bfloat16>(g, out, c1, c2, dc1, dc2, b, h,
                                            w, C, cuts, r, same, slope, s);
    case kFloat16:
      return (int)launch_bwd<__half>(g, out, c1, c2, dc1, dc2, b, h, w, C,
                                     cuts, r, same, slope, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* sncv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
