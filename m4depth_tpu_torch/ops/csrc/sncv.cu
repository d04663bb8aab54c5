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
//
// V1's shapes: radius 4, one cut of 16 to 192 channels, c1 != c2. The
// window is 9x9, 81 floats a pixel out, and a cut is the whole C. What
// bounded the designs above there:
// - Forward: a thread sums a whole cut, so at the deep levels (C = 64 to
//   192) one thread's chain ran 8-24 vectors x 10 positions, in blocks of
//   3-54 threads: latency, 20-33 us a call against a bound under 1.2 us.
//   Now a cut of more than kOneThreadCut channels is split over 2^k lanes
//   (SPLIT; kLaneVecs to 2 kLaneVecs - 1 vectors each, one each where a
//   call has at most kFewPixels pixels): the lanes add their 2 x 9 partial
//   sums with __shfl_xor_sync before the leaky ReLU, and such blocks take
//   one window row each (more, smaller blocks). Cuts of
//   kOneThreadCut channels or fewer (M4Depth's, V1's levels 1-2) run the
//   code above unchanged (SPLIT false: a runtime lane count cost those
//   shapes 10-20%).
// - Backward: 81 floats a pixel make a 16x8 tile's halo of g' 124 KB, one
//   block an SM; g and out were staged with 4-byte loads (81 is no multiple
//   of 4) and a division per float, and read 3.0 times at level 1; the
//   neighbours' vectors came through an L1 left small by the stage. The
//   one-cut backward (`sncv_backward_band_kernel`) keeps the gathers and
//   their order, and:
//   - keeps of a halo row k rows above or below the tile only the R + 1 - k
//     window rows whose offsets point back into it (10 of 36 rows' worth at
//     radius 4), so a 16x8 tile's g' is 80 KB and two blocks fit an SM;
//     where an image gives kBigTiles tiles of 16x16 or more (V1's levels
//     1-2), 16x16 tiles and one block an SM, fewer halo rows a tile row;
//   - stages g' with 16-byte loads of whole row ranges, 8 rows' loads in
//     flight a thread, no division for the tile's own rows;
//   - copies its chunk of c1 and c2 over the halo to shared memory with
//     cp.async while g' is staged, so the gathers read only shared memory;
//   - on small images shrinks the tile (down to 2x2) before it cuts the
//     channels into chunks across blocks (each chunk stages g' again), and
//     splits the window's rows into groups of neighbouring lanes (shuffle
//     sums), so each level launches at least a wave of blocks.
//   On an image one tile wide where the tile kernel above splits the
//   window's rows over nine thread groups (V1's level 5), that kernel stays:
//   12.0 against 17.1 us at b=3. What bounds the one-cut kernel now is the
//   staging: per-block %globaltimer stamps (an instrumented copy) put a
//   block's staging well above its gathers.
//   Tried and dropped (each in turns with the kept design, NVIDIA H100
//   80GB HBM3, 700 W): cp.async for the tile rows of g (8% slower in all),
//   16 rows' loads in flight (registers spill; 19%), 16x4 tiles (22%),
//   128-thread row groups (12%).

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
// the forward: channels of a cut above which its vectors are split over
// lanes; the vectors a lane takes at least, one at up to kFewPixels pixels
// (there latency, not the number of threads, sets the time); the most lanes
// a cut takes
constexpr int kOneThreadCut = 32;
constexpr int kLaneVecs = 2;
constexpr long long kFewPixels = 2048;
constexpr int kMaxLanes = 32;
// the one-cut backward (V1's): threads of a block at most; images up to
// kBandMaxWidth pixels wide are one tile wide, wider ones cut into tiles
// kBandTileWidth wide; rows of a tile at most, and the shared memory above
// which a tile loses rows: two blocks an SM, or, where an image gives
// kBigTiles such tiles or more, one block an SM with twice the rows
constexpr int kBandThreads = 512;
// threads of a block that splits the window's rows into groups, at most
// (register-bound: blocks above it ran one an SM, in two waves)
constexpr int kRowGroupThreads = 256;
constexpr int kBandMaxWidth = 32;
constexpr int kBandTileWidth = 16;
constexpr int kBandRows = 8;
constexpr size_t kBandSmem = 110 * 1024;
constexpr int kBigRows = 16;
constexpr size_t kBigSmem = 200 * 1024;
constexpr long long kBigTiles = kWave / 2;
// rows of g' whose 16-byte loads a thread of the one-cut backward keeps in
// flight together
constexpr int kStageRows = 8;

// Copies one Raw from device memory to shared memory without a stop in
// registers: cp.async (4, 8 or 16 bytes), in flight until cp_async_wait;
// a plain load and store for 2 bytes.
template <typename Raw>
__device__ __forceinline__ void copy_async(Raw* dst, const Raw* src) {
  if constexpr (sizeof(Raw) >= 4) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(sizeof(Raw)));
  } else {
    *dst = *src;
  }
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The bits of this thread's warp that name live threads (1D blocks whose
// last warp may be partial), for the shuffles that every thread reaches.
__device__ __forceinline__ unsigned live_lanes() {
  const int n = (int)blockDim.x - (int)(threadIdx.x & ~31u);
  return n >= 32 ? 0xffffffffu : (1u << n) - 1u;
}

// Grid: x over (image row, segment of `seg` pixels), y over groups of `dys`
// rows of the window. Block: lanes x cuts x seg/2 x dys threads, the lane
// fastest; with SPLIT the `lanes_` threads of a (pair, row, cut) split the
// cut's vectors and add their sums with shuffles, else one thread takes
// the cut. Shared memory: the block's outputs, [seg][dys][2R+1][cuts]
// floats.
template <typename T, int VEC, int R, bool SPLIT>
__global__ void __launch_bounds__(kForwardThreads)
sncv_forward_kernel(const T* __restrict__ c1, const T* __restrict__ c2,
                    float* __restrict__ out, int h, int w, int C, int cuts,
                    int seg, int nseg, int dys, int lanes_, float slope) {
  constexpr int S = 2 * R + 1;
  extern __shared__ __align__(16) float stage[];
  const int lanes = SPLIT ? lanes_ : 1;
  const int cc = C / cuts;
  const int npairs = seg >> 1;
  const int t = threadIdx.x;
  const int lane = t & (lanes - 1);
  const int grp = t / lanes;
  const int cut = grp % cuts;
  const int pair = (grp / cuts) % npairs;
  const int dyl = grp / (cuts * npairs);
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
    for (int c = lane * VEC; c < cc; c += lanes * VEC) {
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

  // the lanes' partial sums, added across the group (every lane ends with
  // the totals)
  if (SPLIT) {
    const unsigned mask = live_lanes();
    for (int o = lanes >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < S; ++i) {
        acc_a[i] += __shfl_xor_sync(mask, acc_a[i], o);
        acc_b[i] += __shfl_xor_sync(mask, acc_b[i], o);
      }
    }
  }

  // stage [pixel][dy of the block][dx][cut], lane k the outputs i = k mod
  // lanes of each pixel; pixels past the image's edge land in slots that
  // are not stored
  const float inv_cc = 1.f / (float)cc;
  const int run = dys * S * cuts;                      // floats a pixel
  float* st = stage + (2 * pair) * run + dyl * S * cuts + cut;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float a = acc_a[i] * inv_cc, b = acc_b[i] * inv_cc;
    if ((i & (lanes - 1)) == lane) st[i * cuts] = a > 0.f ? a : a * slope;
    if (((S + i) & (lanes - 1)) == lane)
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

// Floats of one row of g' staged by the one-cut backward: hw pixels of n
// window rows (S floats each). A tile's own rows keep every row of the
// window, each pixel S^2 floats (odd: neighbouring pixels in other banks),
// with room to start the row where its 16-byte loads fall aligned; a halo
// row keeps fewer, each pixel at an odd stride. A multiple of 4 floats, so
// every row starts aligned to 16 bytes.
__host__ __device__ __forceinline__ int band_row_floats(int hw, int n,
                                                        int S) {
  return n == S ? ((hw * S * S + 9) & ~3) : ((hw * ((n * S) | 1) + 3) & ~3);
}

// Window rows of g' that the one-cut backward keeps of image row yy, for the
// tile's rows [y0, ye): all S of its own rows; of the halo row k rows above
// (below) the tile, the R + 1 - k rows whose offsets point back into the
// tile, the last (first) of each pixel's.
template <int R>
__device__ __forceinline__ int band_kept(int yy, int y0, int ye) {
  return yy < y0 ? R + 1 - (y0 - yy) : yy < ye ? 2 * R + 1 : R + ye - yy;
}

// The VJP of sncv_forward for one cut and two gradients (V1's SNCV), with
// the same gathers as sncv_backward_kernel:
//     dc1[q, c] = sum_d g'[q, d]      * c2[q + d, c]
//     dc2[q, c] = sum_d g'[q + d, -d] * c1[q + d, c]
// Grid: x over (image, tile row, tile column, chunk of cv channel vectors),
// the chunk fastest. Block: threads over (group of window rows, vector of
// the chunk, pixel of the tw x th tile), the row group fastest, so a
// pixel's nr groups are neighbouring lanes and add their sums with
// shuffles. Shared memory: g' of the tile and its halo, row by row
// (`band_row_floats`, `band_kept`), and a table of where each row starts.
template <typename T, int VEC, int R>
__global__ void __launch_bounds__(kBandThreads)
sncv_backward_band_kernel(const float* __restrict__ g,
                          const float* __restrict__ out,
                          const T* __restrict__ c1, const T* __restrict__ c2,
                          T* __restrict__ dc1, T* __restrict__ dc2, int h,
                          int w, int C, int tw, int th, int ntx, int nty,
                          int cv, int nchunks, int nr, int c_at, int vec4,
                          float slope) {
  using Raw = typename Vec<T, VEC>::Raw;
  constexpr int S = 2 * R + 1;
  constexpr int S2 = S * S;
  extern __shared__ __align__(16) float sg[];
  __shared__ int row_at[kBigRows + 2 * R];    // where g' of a row starts
  const int t = threadIdx.x;
  int bx = blockIdx.x;
  const int chunk = bx % nchunks;
  bx /= nchunks;
  const int tx = bx % ntx;
  bx /= ntx;
  const int ty = bx % nty;
  const int bi = bx / nty;
  const long long img = (long long)bi * h * w;
  const int x0 = tx * tw, y0 = ty * th;
  const int xe = min(x0 + tw, w), ye = min(y0 + th, h);
  const int hx0 = max(x0 - R, 0), hx1 = min(xe + R, w);
  const int hy0 = max(y0 - R, 0), hy1 = min(ye + R, h);
  const int hw = hx1 - hx0, nrows = hy1 - hy0;
  const int vecs = C / VEC;
  // this block's chunk of c1 and c2 over the halo, [row][pixel][vector]
  Raw* cs1 = reinterpret_cast<Raw*>(sg + c_at);
  Raw* cs2 = cs1 + nrows * hw * cv;

  // 0. the table: a tile row starts `shift` floats into its space, where
  // its pixels' floats fall as they do in g (mod 16 bytes)
  for (int r = t; r < nrows; r += blockDim.x) {
    int at = 0;
    for (int yy = hy0; yy < hy0 + r; ++yy)
      at += band_row_floats(hw, band_kept<R>(yy, y0, ye), S);
    const int yy = hy0 + r;
    if (yy >= y0 && yy < ye)
      at += (int)(((img + (long long)yy * w + hx0) * S2) & 3);
    row_at[r] = at;
  }
  // the features: each thread one vector of a pixel, in every row, copied
  // without a stop in registers, in flight while g' is staged
  for (int i = t; i < hw * cv; i += blockDim.x) {
    const int px = i / cv, jv = i - px * cv;
    if (chunk * cv + jv >= vecs) continue;
    const long long at =
        (img + (long long)hy0 * w + hx0 + px) * C + (chunk * cv + jv) * VEC;
    for (int r = 0; r < nrows; ++r) {
      const long long a = at + (long long)r * w * C;
      copy_async(cs1 + r * hw * cv + i, reinterpret_cast<const Raw*>(c1 + a));
      copy_async(cs2 + r * hw * cv + i, reinterpret_cast<const Raw*>(c2 + a));
    }
  }
  __syncthreads();

  // 1. g' = g * (out > 0 ? 1 : slope) / C of the staged rows. Each row of
  // the halo is one contiguous range of g and of out: 16-byte loads from
  // the aligned vector that holds its first float to the one that holds its
  // last, kStageRows rows' loads in flight together, of a halo row only the
  // vectors that hold a float it keeps (the floats around a tile row land in
  // its space's margin); else 4-byte loads, float by float.
  const float inv_cc = 1.f / (float)C;
  auto leaky = [slope, inv_cc](float gv, float ov) {
    return (ov > 0.f ? gv : gv * slope) * inv_cc;
  };
  // of row r: the floats of a pixel it keeps, [lo, lo + n), at `stride` a
  // pixel from row_at[r]
  auto kept_floats = [&](int r, int* lo, int* n, int* stride) {
    const int yy = hy0 + r;
    const int k = band_kept<R>(yy, y0, ye);
    *lo = yy < y0 ? (S - k) * S : 0;
    *n = k * S;
    *stride = k == S ? S2 : (k * S) | 1;
  };
  const int n_row = hw * S2;
  if (vec4) {
    const int n4 = (n_row + 6) >> 2;
    for (int i = t; i < n4; i += blockDim.x) {
      for (int r0 = 0; r0 < nrows; r0 += kStageRows) {
        float4 gv[kStageRows], ov[kStageRows];
        unsigned todo = 0;
#pragma unroll
        for (int u = 0; u < kStageRows; ++u) {
          const int r = r0 + u;
          if (r >= nrows) continue;
          const long long at = (img + (long long)(hy0 + r) * w + hx0) * S2;
          const int e0 = 4 * i - (int)(at & 3);
          if (e0 >= n_row) continue;
          int lo, n, stride;
          kept_floats(r, &lo, &n, &stride);
          bool any = n == S2;
          for (int q = 0; q < 4 && !any; ++q) {
            const int e = e0 + q;
            const int o = e - (e / S2) * S2 - lo;
            any = e >= 0 && e < n_row && o >= 0 && o < n;
          }
          if (!any) continue;
          gv[u] = __ldg(reinterpret_cast<const float4*>(g + (at & ~3LL)) + i);
          ov[u] = __ldg(reinterpret_cast<const float4*>(out + (at & ~3LL)) + i);
          todo |= 1u << u;
        }
#pragma unroll
        for (int u = 0; u < kStageRows; ++u) {
          if (!(todo >> u & 1)) continue;
          const int r = r0 + u;
          const long long at = (img + (long long)(hy0 + r) * w + hx0) * S2;
          const int shift = (int)(at & 3);
          const float v[4] = {leaky(gv[u].x, ov[u].x), leaky(gv[u].y, ov[u].y),
                              leaky(gv[u].z, ov[u].z), leaky(gv[u].w, ov[u].w)};
          int lo, n, stride;
          kept_floats(r, &lo, &n, &stride);
          if (n == S2) {
            reinterpret_cast<float4*>(sg + row_at[r] - shift)[i] =
                make_float4(v[0], v[1], v[2], v[3]);
            continue;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int e = 4 * i - shift + q;
            const int px = e / S2, o = e - px * S2 - lo;
            if (e >= 0 && e < n_row && o >= 0 && o < n)
              sg[row_at[r] + px * stride + o] = v[q];
          }
        }
      }
    }
  } else {
    for (int e = t; e < n_row; e += blockDim.x) {
      const int px = e / S2;
#pragma unroll 4
      for (int r = 0; r < nrows; ++r) {
        int lo, n, stride;
        kept_floats(r, &lo, &n, &stride);
        const int o = e - px * S2 - lo;
        if (o < 0 || o >= n) continue;
        const long long a = (img + (long long)(hy0 + r) * w + hx0) * S2 + e;
        sg[row_at[r] + px * stride + o] = leaky(__ldg(g + a), __ldg(out + a));
      }
    }
  }
  cp_async_wait();
  __syncthreads();

  // 2. the gathers: this thread's vector j of pixel (x, y) over the window
  // rows dy = rg, rg + nr, ...; coefficients and the neighbours' vectors
  // all from shared memory
  const int rg = t & (nr - 1);
  const int q = t / nr;
  const int jv = q % cv;
  const int p = q / cv;
  const int j = chunk * cv + jv;
  const int x = x0 + p % tw, y = y0 + p / tw;
  const bool active = p < tw * th && x < w && y < h && j < vecs;
  float acc1[VEC], acc2[VEC];
#pragma unroll
  for (int u = 0; u < VEC; ++u) acc1[u] = acc2[u] = 0.f;
  if (active) {
    const float* sa = sg + row_at[y - hy0] + (x - hx0) * S2;  // g'[q, d]
    for (int dy = rg; dy < S; dy += nr) {
      const int yy = y + dy - R;
      if (yy < 0 || yy >= h) continue;
      // g'[q + d, -d] of the neighbour in column xx: offset
      // (2R - dy) * S + 2R - dx, less the window rows its row left out
      const int kept = band_kept<R>(yy, y0, ye);
      const int first = yy < y0 ? R + y0 - yy : 0;
      const int stride = kept == S ? S2 : (kept * S) | 1;
      const float* sb =
          sg + row_at[yy - hy0] + (2 * R - dy - first) * S + 2 * R;
      const int nb = (yy - hy0) * hw * cv - hx0 * cv + jv;
#pragma unroll
      for (int dx = 0; dx < S; ++dx) {
        const int xx = x + dx - R;
        if (xx < 0 || xx >= w) continue;
        const float ga = sa[dy * S + dx];
        const float gb = sb[(xx - hx0) * stride - dx];
        float v1[VEC], v2[VEC];
        Vec<T, VEC>::unpack(cs1[nb + xx * cv], v1);
        Vec<T, VEC>::unpack(cs2[nb + xx * cv], v2);
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          acc1[u] = fmaf(ga, v2[u], acc1[u]);
          acc2[u] = fmaf(gb, v1[u], acc2[u]);
        }
      }
    }
  }

  // 3. the row groups' sums, added across neighbouring lanes, then the
  // gradients rounded once to T
  if (nr > 1) {
    const unsigned mask = live_lanes();
    for (int o = nr >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        acc1[u] += __shfl_xor_sync(mask, acc1[u], o);
        acc2[u] += __shfl_xor_sync(mask, acc2[u], o);
      }
    }
  }
  if (active && rg == 0) {
    const long long at = (img + (long long)y * w + x) * C + j * VEC;
    Vec<T, VEC>::store(dc1 + at, acc1);
    Vec<T, VEC>::store(dc2 + at, acc2);
  }
}

// The forward's grid: segments of `seg` pixels, `nseg` to an image row, and
// `dys` rows of the window to a block.
struct ForwardGrid {
  int seg, nseg, dys;
};

// Lanes a cut's vectors split over: one thread a cut up to kOneThreadCut
// channels (M4Depth's cuts, V1's levels 1-2); above, a power of two that
// leaves each lane kLaneVecs to 2 kLaneVecs - 1 vectors (one to one at up
// to kFewPixels pixels), at most kMaxLanes.
int forward_lanes(long long pixels, int cc, int vec, int cuts) {
  if (cc <= kOneThreadCut) return 1;
  const int per_lane = pixels <= kFewPixels ? 1 : kLaneVecs;
  int lanes = 1;
  while (lanes * 2 <= std::min(kMaxLanes, cc / vec / per_lane) &&
         lanes * 2 * cuts <= kForwardThreads)
    lanes *= 2;
  return lanes;
}

// Every row of the window in one block (so a block stores whole pixel rows)
// while segments of 8 pixels or more still give a wave of blocks; else, and
// always for a cut split over lanes, one row of the window a block, with
// segments down to one pair of pixels. The segment starts as wide as
// kForwardThreads threads allow and halves until the grid makes a wave.
// False if one pair's lanes and cuts need too many threads.
bool forward_grid(long long b, int h, int w, int cuts, int S, int lanes,
                  ForwardGrid* g) {
  const long long rows = b * h;
  const int w_even = (w + 1) & ~1;
  for (const int dys : {S, 1}) {
    if (lanes > 1 && dys == S) continue;
    const int per_pair = lanes * cuts * dys;
    if (per_pair > kForwardThreads) continue;
    const int pairs = std::min(kMaxSegment / 2, kForwardThreads / per_pair);
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
  const int lanes = forward_lanes((long long)b * h * w, C / cuts, VEC, cuts);
  ForwardGrid g;
  if (!forward_grid(b, h, w, cuts, S, lanes, &g))
    return cudaErrorInvalidValue;
  const long long blocks = (long long)b * h * g.nseg;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, S / g.dys);
  const int threads = lanes * cuts * (g.seg / 2) * g.dys;
  const size_t smem = (size_t)g.seg * g.dys * S * cuts * sizeof(float);
  auto kernel = lanes > 1 ? sncv_forward_kernel<T, VEC, R, true>
                          : sncv_forward_kernel<T, VEC, R, false>;
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(c1), static_cast<const T*>(c2),
      static_cast<float*>(out), h, w, C, cuts, g.seg, g.nseg, g.dys, lanes,
      slope);
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

// The one-cut backward's grid: tiles of tw x th pixels, ntx x nty of them
// to an image, each split into nchunks chunks of cv channel vectors, and nr
// groups of the window's rows to a pixel.
struct BandGrid {
  int tw, th, ntx, nty, cv, nchunks, nr;
  size_t smem;
};

// The most shared memory g' of a tile tw x th (of an image h x w) can take:
// its own rows and R halo rows above and below; with `chunk` bytes of c1
// (and as many of c2) a pixel, their chunks over the halo besides.
size_t band_smem(int h, int w, int tw, int th, int R, int chunk = 0) {
  const int S = 2 * R + 1;
  const int hw = std::min(tw + 2 * R, w);
  size_t floats = (size_t)th * band_row_floats(hw, S, S);
  for (int k = 1; k <= R; ++k)
    floats += 2 * (size_t)band_row_floats(hw, R + 1 - k, S);
  return floats * sizeof(float) +
         2 * (size_t)std::min(th + 2 * R, h) * hw * chunk;
}

// Tiles one image wide up to kBandMaxWidth pixels, else kBandTileWidth
// wide; bands of at most `rows` rows, cut evenly, fewer while a tile's g'
// passes `budget`. The window's rows go to nr groups of threads (a power of
// two, at most 8, a block of kRowGroupThreads at most) while the grid has
// fewer than kFewThreads; a block takes as many of a pixel's channel
// vectors (of `vec_bytes` each, a divisor of their number) as kBandThreads
// and `budget` allow. While the grid has less than a wave of blocks the
// tile halves its longer side, down to 2x2 pixels, then the blocks take
// fewer vectors: each chunk of vectors stages the tile's g' again. False if
// no tile fits.
bool band_grid_of(long long b, int h, int w, int C, int vec, int vec_bytes,
                  int R, int rows, size_t budget, BandGrid* g) {
  const int vecs = C / vec;
  int tw = w <= kBandMaxWidth ? w : kBandTileWidth;
  int th = (h + (h + rows - 1) / rows - 1) / ((h + rows - 1) / rows);
  while (band_smem(h, w, tw, th, R, vec_bytes) > budget && th > 1)
    th = (th + 1) / 2;
  // the largest divisor of vecs not above n
  auto divisor = [vecs](int n) {
    int d = std::max(1, std::min(vecs, n));
    while (vecs % d) --d;
    return d;
  };
  for (;;) {
    const int P = tw * th;
    if (P > kBandThreads) return false;
    int nr = 1;
    while (nr < 8 && b * h * w * vecs * nr < kFewThreads &&
           2 * nr * P <= kRowGroupThreads)
      nr *= 2;
    int cv = divisor(kBandThreads / (P * nr));
    while (cv > 1 && band_smem(h, w, tw, th, R, cv * vec_bytes) > budget)
      cv = divisor(cv - 1);
    const long long tiles =
        b * ((w + tw - 1) / tw) * (long long)((h + th - 1) / th);
    if (tiles * (vecs / cv) < kWave && P > 4) {
      if (tw >= th) tw = (tw + 1) / 2; else th = (th + 1) / 2;
      continue;
    }
    while (cv > 1 && tiles * (vecs / cv) < kWave) cv = divisor(cv - 1);
    *g = {tw, th, (w + tw - 1) / tw, (h + th - 1) / th, cv, vecs / cv, nr,
          band_smem(h, w, tw, th, R, cv * vec_bytes)};
    return g->smem <= kMaxSmem;
  }
}

// Large tiles (kBigRows rows, one block an SM) where the image gives
// kBigTiles of them or more: fewer halo rows read for each row of the
// image (measured on the H100: levels 1-2 of V1's d6 384x384 model at b=3
// 11-16% faster, levels 3-4 slower); else tiles of kBandRows rows.
bool band_grid(long long b, int h, int w, int C, int vec, int vec_bytes,
               int R, BandGrid* g) {
  const int tw = w <= kBandMaxWidth ? w : kBandTileWidth;
  const long long big_tiles = b * ((w + tw - 1) / tw) *
                              (long long)((h + kBigRows - 1) / kBigRows);
  if (big_tiles >= kBigTiles &&
      band_grid_of(b, h, w, C, vec, vec_bytes, R, kBigRows, kBigSmem, g))
    return true;
  return band_grid_of(b, h, w, C, vec, vec_bytes, R, kBandRows, kBandSmem,
                      g);
}

template <typename T, int VEC, int R>
cudaError_t launch_backward_band(const void* g, const void* out,
                                 const void* c1, const void* c2, void* dc1,
                                 void* dc2, int b, int h, int w, int C,
                                 float slope, cudaStream_t stream) {
  BandGrid gr;
  if (!band_grid(b, h, w, C, VEC, VEC * (int)sizeof(T), R, &gr))
    return cudaErrorInvalidValue;
  const int c_at = (int)(band_smem(h, w, gr.tw, gr.th, R) / sizeof(float));
  const long long blocks = (long long)b * gr.ntx * gr.nty * gr.nchunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t err =
      allow_smem<sncv_backward_band_kernel<T, VEC, R>>(gr.smem);
  if (err != cudaSuccess) return err;
  const int threads = gr.nr * gr.cv * gr.tw * gr.th;
  const int vec4 = aligned16(g) && aligned16(out);
  sncv_backward_band_kernel<T, VEC, R>
      <<<(unsigned)blocks, threads, gr.smem, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(out),
      static_cast<const T*>(c1), static_cast<const T*>(c2),
      static_cast<T*>(dc1), static_cast<T*>(dc2), h, w, C, gr.tw, gr.th,
      gr.ntx, gr.nty, gr.cv, gr.nchunks, gr.nr, c_at, vec4, slope);
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
  // one cut: the band kernel, except on an image one band tile wide where
  // the tile kernel splits the window's rows (its 2x2 tiles take all of a
  // pixel's vectors in one block; the band kernel's tiles stage the whole
  // width's g' again for each chunk of vectors): V1's level 5, 12.0 against
  // 17.1 us at b=3 on the H100
  BackwardGrid tile;
  if (cuts == 1 &&
      !(w <= kBandMaxWidth &&
        backward_grid(b, h, w, C, 1, VEC, R, false, &tile) && tile.nr > 1))
    return launch_backward_band<T, VEC, R>(g, out, c1, c2, dc1, dc2, b, h,
                                           w, C, slope, stream);
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
