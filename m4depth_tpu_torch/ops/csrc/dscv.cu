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
// of geometry/parallax.py) are computed here per pixel from the motion and
// the camera as the caller holds them: rot [b, 3] (small angle) or [b, 4]
// (quaternion, geometry/rotations.py), trans [b, 3], f and c [b, 2]. So the
// wrapper launches nothing but this kernel, after a cast of para_prev_t
// where the caller holds it in another type than c1's (for float16 a
// saturating one: clamped to +-65504 first, as the JAX package's
// `_saturating_cast`, so that a huge parallax does not become inf and
// inf * 0 NaN in the bilinear weights).
//
// What bounds it on the H100. Bytes, by the count that matters for a
// bound: per pixel C values of c1 and of c2, the sweep centre and the
// previous parallax read, (2r+1)*cuts + 1 floats written (4 MB at level 1
// of d6 384x384, b=1: 1.2 us at 3.35 TB/s). The four taps x 9 hypotheses
// re-read c2 36 times, but from L1, since neighbouring pixels' taps
// overlap. In practice the time is latency and issue: each pixel's chain
// runs from the motion's loads through the epipolar terms (about 60
// flops, two divisions and a square root) and nine sample positions to
// the taps' loads, and every tap channel costs an unpack and a
// multiply-add on the CUDA cores. At the deep levels (6x6 to 24x24) the
// chain alone sets the time.
//
// Forward design (`dscv_forward_kernel`):
// - Threads of a pixel: `lanes` over the channels of a cut (each a 16-byte
//   vector: 8 bfloat16 or float16, or 4 float32), x the cuts, x `slices` of the 2r+1
//   hypotheses (slice s takes s, s + slices, ...); a power of two, pixel-
//   major, so a pixel's threads share one warp or fill whole warps.
// - Geometry. Each thread computes its pixel's epipolar terms and the
//   sample positions of its own hypotheses, with the same device functions
//   as the backward (`epipolar`, `sample_position`): the gradient
//   differentiates exactly the forward's positions. A warp issues each
//   instruction once for its 32 lanes, so the lanes of one pixel cost no
//   more than one lane would, and a shuffle broadcast would only add
//   instructions; no barrier stands before the loads.
// - Correlations. A thread keeps its vector of c1 in registers (loaded
//   before the geometry, so its latency hides there), takes its hypotheses
//   three at a time with all their 16-byte tap loads in flight together,
//   sums per channel the products of c1 with each of the four taps and
//   applies the bilinear weights to those sums; the lanes of a cut add up
//   by shuffles. The centre hypothesis's thread also warps the previous
//   parallax (para_out), with its loads in flight beside the taps'.
// - Stores. Each cut's mean goes to the block's output rows in shared
//   memory; after one barrier the block writes its pixels' rows, one
//   contiguous range of cv, with 16-byte stores.
// - Split by level shape. The grid should fill the card but stay within
//   one wave of resident threads (about 96K on 132 SMs at this kernel's
//   registers): a second, partial wave costs more than it gives. From one
//   lane a cut and one slice, the launch doubles the slices up to 4, then
//   the lanes up to the cut's vectors, then the slices up to 8, while the
//   grid stays within that wave; blocks hold 128 threads' worth of pixels.
//   At d6 384x384 in bfloat16, b=1, that gives a pixel 2 threads at level
//   1 (2 slices), 8 at level 2 (2 cuts x 4 slices), 32 at level 3, 128 at
//   levels 4 and 5 and 256 at level 6 (4 lanes x cuts x 8 slices); at b=3,
//   level 1 keeps one thread a pixel.
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
// What bounds the backward: of the two bounds, the float32 operations
// (~27 a hypothesis and channel) are larger than the unique bytes (c1, c2,
// the centre, the previous parallax and dcv read once; dc1, dc2, dcentre
// written once). In practice dc2's scatter sets the time: each pixel adds
// to 4 corners x 9 hypotheses per channel, as float32 device atomics that
// the L2 cache applies per 32-byte sector, and neighbouring pixels' samples
// lie 1 px apart, so each dc2 value takes ~36 adds.
//
// Backward design (`dscv_backward_kernel`):
// - Threads as the forward's, over 4-channel vectors: lanes over a cut's
//   vectors, x cuts x slices of the hypotheses, the slices doubling while
//   the grid stays within a wave of resident threads; 256-thread blocks of
//   at most 85 registers, three to an SM (128-thread blocks, a larger wave
//   or more registers read within 2%).
// - Per thread, in registers: its c1 vector (loaded once), its dc1 sums,
//   and its share of the position derivatives, folded at once into the
//   pixel's dcentre sum (the clip gates and the epipolar direction are the
//   same for every channel), so nothing is reduced per hypothesis. At the
//   end dc1 sums over the slices by shuffles, dcentre over the pixel's
//   threads.
// - dc2: each corner of a sample is one 16-byte atomic a lane, and the
//   lanes of a pixel's cut hold neighbouring vectors, so a warp's adds to
//   one pixel are one contiguous range (8 channels a lane with scalar
//   atomics, each lane's adds in sectors of their own, ran 5-8x slower at
//   levels 2-4). A corner of weight zero is skipped, and a sample at the
//   same position and fractions as the thread's previous one adds to it in
//   registers: the border clamp sends all 9 samples of a pixel with a
//   large sweep centre to one corner, and adds to one address serialise in
//   the L2.
// - Measured and dropped (NVIDIA H100 80GB HBM3, 700 W, `chip_smoke.py`
//   phase 10): combining dc2 in a shared-memory window over a tile's
//   samples, flushed once to device memory. With float32 shared atomics
//   (compare-and-swap loops on this card) it ran 3-8x slower than the
//   parent at levels 2-4; with integer fixed-point adds it still ran 6-22%
//   slower than direct atomics at levels 1-4.
// - The sample positions come from the same `epipolar` and
//   `sample_position` as the forward's.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "common.cuh"

namespace {

// the backward: threads of a block, and blocks of an SM (its register
// budget: at most 85 a thread)
constexpr int kBackwardThreads = 256;
constexpr int kBackwardMinBlocks = 3;
// the forward: threads' worth of pixels a block, threads of one pixel at
// most, slices of the hypotheses at most, and the threads of one wave (the
// H100's 132 SMs hold 6 of its blocks each at about 80 registers a thread)
constexpr int kForwardThreads = 128;
constexpr int kMaxPixelThreads = 512;
constexpr int kMaxSlices = 8;
constexpr long long kWaveThreads = 96 * 1024;

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

// A sample position as the forward keeps it.
struct Pos {
  int tap;        // top-left corner, pixel index over b*h*w
  float ax, ay;   // bilinear fractions
};

// Block: P pixels from p0 = blockIdx.x * P, tpp threads each (a power of
// two), pixel-major; within a pixel, fastest first: channel lane, slice of
// the hypotheses, cut. Slice s takes hypotheses s, s + slices, ... Shared
// memory: the block's output rows [P][cuts][S].
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxPixelThreads)
dscv_forward_kernel(const T* __restrict__ c1, const T* __restrict__ c2,
                    const T* __restrict__ para,
                    const float* __restrict__ centre,
                    const float* __restrict__ rot,
                    const float* __restrict__ trans,
                    const float* __restrict__ focal,
                    const float* __restrict__ principal,
                    float* __restrict__ cv, float* __restrict__ para_out,
                    int h, int w, int C, int cuts, int r, int rot_dim,
                    int n_pix, int P, int lanes, int slices, int tpp) {
  using V = Vec<T, VEC>;
  using Raw = typename V::Raw;
  extern __shared__ __align__(16) float s_out[];
  const int S = 2 * r + 1;
  const int t = threadIdx.x;
  const int cc = C / cuts;
  const int vpc = cc / VEC;                  // vectors a cut
  const int slot = t / tpp;
  const int rem = t - slot * tpp;
  const int lane = rem & (lanes - 1);
  const int slice = (rem / lanes) & (slices - 1);
  const int cut = rem / (lanes * slices);    // >= cuts on padding threads
  const int p0 = blockIdx.x * P;
  const int p = p0 + slot;
  const bool active = p < n_pix && cut < cuts;

  // this lane's first vector of c1, loaded first so that its latency hides
  // behind the geometry
  const T* a_row = c1 + (long long)(active ? p : 0) * C
                   + (active ? cut : 0) * cc;
  Raw a0{};
  if (active && lane < vpc) a0 = V::load_raw(a_row + lane * VEC);

  // 1. the geometry of this thread's pixel. The threads of a pixel sit in
  // one warp (tpp <= 32) or fill whole warps, so a warp issues it once for
  // all the pixels it holds
  const int pc = min(p, n_pix - 1);
  const int x = pc % w, y = (pc / w) % h;
  const int bi = pc / (w * h);
  const long long img = (long long)bi * h * w;
  const Epipolar e =
      epipolar(rot, trans, focal, principal, bi, rot_dim, x, y);
  const float cen = centre[pc];

  // 2. the correlations of this thread's hypotheses, KC at a time: their
  // sample positions, then all their loads in flight together. Per
  // channel, the dot products of c1 with the four taps; the bilinear
  // weights apply to the sums. The
  // centre hypothesis's first lane of cut 0 also warps the previous
  // parallax. Every thread takes part in the shuffles, active or not.
  constexpr int KC = 3;
  const float inv_cc = 1.f / (float)cc;
  const int kps = (S - slice + slices - 1) / slices;   // this slice's
  const int kmax = (S + slices - 1) / slices;          // slice 0's
  const long long wC = (long long)w * C;
  float pv[4] = {0.f, 0.f, 0.f, 0.f};
  Pos pp{0, 0.f, 0.f};   // the centre hypothesis, for para_out
  bool has_para = false;
  for (int i0 = 0; i0 < kmax; i0 += KC) {
    Pos ps[KC];
    bool on[KC];
#pragma unroll
    for (int i = 0; i < KC; ++i) {
      const int k = slice + (i0 + i) * slices;
      on[i] = active && i0 + i < kps;
      ps[i] = Pos{0, 0.f, 0.f};
      if (on[i]) {
        const Sample sm = sample_position(e, cen, k, r, x, y, w, h, img);
        ps[i] = Pos{(int)sm.tap, sm.ax, sm.ay};
      }
      if (on[i] && k == r && cut == 0 && lane == 0) {
        has_para = true;
        pp = ps[i];
        pv[0] = to_float(para[pp.tap]);
        pv[1] = to_float(para[pp.tap + 1]);
        pv[2] = to_float(para[pp.tap + w]);
        pv[3] = to_float(para[pp.tap + w + 1]);
      }
    }
    float part[KC];
#pragma unroll
    for (int i = 0; i < KC; ++i) part[i] = 0.f;
    for (int j = lane; j < vpc; j += lanes) {
      const Raw ra = j == lane ? a0 : V::load_raw(a_row + j * VEC);
      Raw v[KC][4];
#pragma unroll
      for (int i = 0; i < KC; ++i) {
        const T* tl = c2 + (long long)ps[i].tap * C + cut * cc + j * VEC;
        if (on[i]) {
          v[i][0] = V::load_raw(tl);
          v[i][1] = V::load_raw(tl + C);
          v[i][2] = V::load_raw(tl + wC);
          v[i][3] = V::load_raw(tl + wC + C);
        } else {
          v[i][0] = v[i][1] = v[i][2] = v[i][3] = Raw{};
        }
      }
      float a[VEC];
      V::unpack(ra, a);
#pragma unroll
      for (int i = 0; i < KC; ++i) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          float f[VEC];
          V::unpack(v[i][n], f);
#pragma unroll
          for (int u = 0; u < VEC; ++u) d[n] = fmaf(a[u], f[u], d[n]);
        }
        const float ax = ps[i].ax, ay = ps[i].ay;
        const float top = d[0] + (d[1] - d[0]) * ax;
        const float bot = d[2] + (d[3] - d[2]) * ax;
        part[i] += top + (bot - top) * ay;
      }
    }
#pragma unroll
    for (int i = 0; i < KC; ++i) {
      for (int off = lanes >> 1; off > 0; off >>= 1)
        part[i] += __shfl_xor_sync(0xffffffffu, part[i], off);
      if (on[i] && lane == 0)
        s_out[(slot * cuts + cut) * S + slice + (i0 + i) * slices] =
            part[i] * inv_cc;
    }
  }
  if (has_para) {
    const float top = pv[0] + (pv[1] - pv[0]) * pp.ax;
    const float bot = pv[2] + (pv[3] - pv[2]) * pp.ax;
    para_out[p] = top + (bot - top) * pp.ay;
  }
  __syncthreads();

  // the block's rows of cv: one contiguous range
  const int n = min(P, n_pix - p0);
  store_block(cv + (long long)p0 * cuts * S, s_out, n * cuts * S);
}

// dc2's corners of one sample at `tap` with bilinear fractions (ax, ay):
// coef[u] * w_n into corner n (tl, tr, bl, br) for VEC channels from `ch`,
// with one 16-byte device atomic a corner where VEC is 4 (neighbouring
// lanes on neighbouring vectors, so a warp's adds to one pixel are one
// contiguous range). A corner of weight zero (a clipped fraction) adds
// nothing and is skipped.
template <int VEC>
__device__ __forceinline__ void add_sample(float* __restrict__ dc2,
                                           long long tap, float ax, float ay,
                                           int w, int C, int ch,
                                           const float (&coef)[VEC]) {
  const float wt[4] = {(1.f - ax) * (1.f - ay), ax * (1.f - ay),
                       (1.f - ax) * ay, ax * ay};
  const long long at[4] = {tap, tap + 1, tap + w, tap + w + 1};
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    if (wt[n] == 0.f) continue;
    float* d = dc2 + at[n] * C + ch;
    if constexpr (VEC == 4) {
      atomicAdd(reinterpret_cast<float4*>(d),
                make_float4(coef[0] * wt[n], coef[1] * wt[n],
                            coef[2] * wt[n], coef[3] * wt[n]));
    } else {
#pragma unroll
      for (int u = 0; u < VEC; ++u) atomicAdd(d + u, coef[u] * wt[n]);
    }
  }
}

// The VJP of dscv_forward_kernel. For each hypothesis k of pixel p, with
// g = dcv[p, cut, k] / cc and the forward's sample:
//   dc1[p, c]      += g * sample_k(c2)[c]
//   dc2[corner, c] += g * c1[p, c] * w_corner
//   dcentre[p]     += gate_k * (ux * d/dax_k + uy * d/day_k)
// where d/dax_k = sum_c g * c1[p, c] * d sample_k(c2)[c] / dax (plus the
// warped parallax's term at the centre hypothesis).
// Block: P pixels from p0 = blockIdx.x * P, tpp threads each (a power of
// two), pixel-major; within a pixel, fastest first: channel lane, slice of
// the hypotheses, cut, as in the forward. A thread owns one VEC-channel
// vector of c1 (or several, lanes apart), keeps its dc1 sums in registers,
// and folds its part of the position derivatives into dcentre's sum at
// once: the gates and (ux, uy) are the same for every channel.
template <typename T, int VEC>
__global__ void __launch_bounds__(kBackwardThreads, kBackwardMinBlocks)
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
                     int n_pix, int P, int lanes, int slices, int tpp) {
  using V = Vec<T, VEC>;
  __shared__ float s_part[kBackwardThreads / 32];
  const int S = 2 * r + 1;
  const int cc = C / cuts;
  const int vpc = cc / VEC;
  const int t = threadIdx.x;
  const int slot = t / tpp;
  const int rem = t - slot * tpp;
  const int lane = rem & (lanes - 1);
  const int slice = (rem / lanes) & (slices - 1);
  const int cut = rem / (lanes * slices);      // >= cuts on padding threads
  const int pu = blockIdx.x * P + slot;
  const bool pix = pu < n_pix;
  const bool active = pix && cut < cuts;
  const int p = min(pu, n_pix - 1);
  const int x = p % w, y = (p / w) % h;
  const int bi = p / (w * h);
  const long long img = (long long)bi * h * w;
  const Epipolar e = epipolar(rot, trans, focal, principal, bi, rot_dim, x, y);
  const float cen = centre[p];
  const float ux = e.dx / e.den, uy = e.dy / e.den;
  const float inv_cc = 1.f / (float)cc;
  const float* g_row = dcv + (long long)p * (cuts * S) + (active ? cut : 0) * S;
  const int kps = (S - slice + slices - 1) / slices;   // this slice's
  const long long wC = (long long)w * C;
  float dcen = 0.f;
  const int nj = (vpc + lanes - 1) / lanes;
  for (int jj = 0; jj < nj; ++jj) {
    const int j = lane + jj * lanes;
    const bool on = active && j < vpc;
    const int ch = on ? cut * cc + j * VEC : 0;
    float a[VEC], acc[VEC], p_coef[VEC];
    long long p_tap = -1;                      // the pending sample
    float p_ax = 0.f, p_ay = 0.f;
#pragma unroll
    for (int u = 0; u < VEC; ++u) a[u] = acc[u] = p_coef[u] = 0.f;
    if (on) V::load(c1 + (long long)p * C + ch, a);
    for (int i = 0; on && i < kps; ++i) {
      const int k = slice + i * slices;
      const Sample sm = sample_position(e, cen, k, r, x, y, w, h, img);
      const float gk = g_row[k] * inv_cc;
      const T* tl = c2 + sm.tap * C + ch;
      float f[4][VEC];
      V::load(tl, f[0]);
      V::load(tl + C, f[1]);
      V::load(tl + wC, f[2]);
      V::load(tl + wC + C, f[3]);
      const float ax = sm.ax, ay = sm.ay;
      float dax = 0.f, day = 0.f;
      float coef[VEC];
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        const float top = f[0][u] + (f[1][u] - f[0][u]) * ax;
        const float bot = f[2][u] + (f[3][u] - f[2][u]) * ax;
        acc[u] = fmaf(gk, top + (bot - top) * ay, acc[u]);
        coef[u] = gk * a[u];
        dax = fmaf(coef[u],
                   (f[1][u] - f[0][u]) +
                       ((f[3][u] - f[2][u]) - (f[1][u] - f[0][u])) * ay,
                   dax);
        day = fmaf(coef[u], bot - top, day);
      }
      const long long tap = sm.tap;
      if (k == r && cut == 0 && j == 0) {
        // the centre hypothesis also warped the previous parallax: one
        // thread of the pixel adds its terms
        const float dpo = dpara_out[p];
        const float vtl = to_float(para[tap]), vtr = to_float(para[tap + 1]);
        const float vbl = to_float(para[tap + w]);
        const float vbr = to_float(para[tap + w + 1]);
        const float top = vtl + (vtr - vtl) * ax;
        const float bot = vbl + (vbr - vbl) * ax;
        dax = fmaf(dpo, (vtr - vtl) + ((vbr - vbl) - (vtr - vtl)) * ay, dax);
        day = fmaf(dpo, bot - top, day);
        if (dpara != nullptr) {
          atomicAdd(dpara + tap, dpo * (1.f - ax) * (1.f - ay));
          atomicAdd(dpara + tap + 1, dpo * ax * (1.f - ay));
          atomicAdd(dpara + tap + w, dpo * (1.f - ax) * ay);
          atomicAdd(dpara + tap + w + 1, dpo * ax * ay);
        }
      }
      if (sm.in_disp)
        dcen += (sm.in_x ? dax : 0.f) * ux + (sm.in_y ? day : 0.f) * uy;
      // dc2: a sample at the same position and fractions as the one before
      // (all of a far pixel's, clamped to the border) adds to it in
      // registers, so such pixels do not all add to one address
      if (tap == p_tap && ax == p_ax && ay == p_ay) {
#pragma unroll
        for (int u = 0; u < VEC; ++u) p_coef[u] += coef[u];
      } else {
        if (p_tap >= 0)
          add_sample<VEC>(dc2, p_tap, p_ax, p_ay, w, C, ch, p_coef);
        p_tap = tap;
        p_ax = ax;
        p_ay = ay;
#pragma unroll
        for (int u = 0; u < VEC; ++u) p_coef[u] = coef[u];
      }
    }
    if (p_tap >= 0) add_sample<VEC>(dc2, p_tap, p_ax, p_ay, w, C, ch, p_coef);
    // dc1: the slices of one lane and cut sit in one warp
    for (int off = lanes; off < lanes * slices; off <<= 1) {
#pragma unroll
      for (int u = 0; u < VEC; ++u)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
    }
    if (on && slice == 0) V::store(dc1 + (long long)p * C + ch, acc);
  }

  // dcentre: the sum over the pixel's threads, across warps where it has
  // more than 32
  for (int off = 1; off < min(tpp, 32); off <<= 1)
    dcen += __shfl_xor_sync(0xffffffffu, dcen, off);
  if (tpp > 32) {
    if ((t & 31) == 0) s_part[t >> 5] = dcen;
    __syncthreads();
    if (rem == 0)
      for (int i = 1; i < tpp / 32; ++i) dcen += s_part[(t >> 5) + i];
  }
  if (rem == 0 && pix) dcentre[p] = dcen;
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <typename T, int VEC>
cudaError_t launch_forward(const void* c1, const void* c2, const void* para,
                           const void* centre, const void* rot,
                           const void* trans, const void* focal,
                           const void* principal, void* cv, void* para_out,
                           int b, int h, int w, int C, int cuts, int r,
                           int rot_dim, cudaStream_t stream) {
  const int S = 2 * r + 1;
  const long long n_pix = (long long)b * h * w;
  // threads of a pixel: lanes x cuts (rounded up to a power of two) x
  // slices of the hypotheses. From one lane a cut and one slice, the
  // launch doubles the slices up to 4 (a thread then keeps 3 hypotheses
  // of 9 or fewer), then the lanes up to the cut's vectors, then the
  // slices up to 8, while the grid stays within one wave of resident
  // threads
  const int cuts_p = pow2_at_least(cuts);
  const int max_lanes = std::min(32, pow2_at_least(C / cuts / VEC));
  auto fits = [&](int lanes, int slices) {
    const int tpp = 2 * lanes * cuts_p * slices;   // after a doubling
    return n_pix * tpp <= kWaveThreads && tpp <= kMaxPixelThreads;
  };
  int lanes = 1, slices = 1;
  while (slices < std::min(4, S) && fits(lanes, slices)) slices <<= 1;
  while (lanes < max_lanes && fits(lanes, slices)) lanes <<= 1;
  while (slices < std::min(kMaxSlices, S) && fits(lanes, slices))
    slices <<= 1;
  const int tpp = lanes * cuts_p * slices;
  if (tpp > kMaxPixelThreads) return cudaErrorInvalidValue;  // too many cuts
  const int P = std::max(1, kForwardThreads / tpp);
  const int threads = P * tpp;
  const size_t smem = (size_t)P * cuts * S * sizeof(float);
  const long long blocks = (n_pix + P - 1) / P;
  if (n_pix > 0x7fffffffLL || smem > 48 * 1024)
    return cudaErrorInvalidValue;
  dscv_forward_kernel<T, VEC><<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const T*>(c1), static_cast<const T*>(c2),
      static_cast<const T*>(para), static_cast<const float*>(centre),
      static_cast<const float*>(rot), static_cast<const float*>(trans),
      static_cast<const float*>(focal),
      static_cast<const float*>(principal), static_cast<float*>(cv),
      static_cast<float*>(para_out), h, w, C, cuts, r, rot_dim, (int)n_pix,
      P, lanes, slices, tpp);
  return cudaGetLastError();
}

// 16-byte loads where every vector of a cut is aligned, else scalar ones.
template <typename T>
cudaError_t launch(const void* c1, const void* c2, const void* para,
                   const void* centre, const void* rot, const void* trans,
                   const void* focal, const void* principal, void* cv,
                   void* para_out, int b, int h, int w, int C, int cuts,
                   int r, int rot_dim, cudaStream_t stream) {
  if ((C / cuts) % kVec<T> == 0 && aligned16(c1) && aligned16(c2))
    return launch_forward<T, kVec<T>>(c1, c2, para, centre, rot, trans,
                                      focal, principal, cv, para_out, b, h,
                                      w, C, cuts, r, rot_dim, stream);
  return launch_forward<T, 1>(c1, c2, para, centre, rot, trans, focal,
                              principal, cv, para_out, b, h, w, C, cuts, r,
                              rot_dim, stream);
}

// The backward's split: as the forward's, lanes cover a cut's vectors (so a
// thread owns one, up to 32 lanes), then the slices double while the grid
// stays within one wave of resident threads and a lane's slices stay in
// one warp; a block holds kBackwardThreads threads' worth of pixels.
template <typename T, int VEC>
cudaError_t launch_backward_v(const void* c1, const void* c2,
                              const void* para, const void* centre,
                              const void* rot, const void* trans,
                              const void* focal, const void* principal,
                              const void* dcv, const void* dpara_out,
                              void* dc1, void* dc2, void* dcentre,
                              void* dpara, int b, int h, int w, int C,
                              int cuts, int r, int rot_dim,
                              cudaStream_t stream) {
  const int S = 2 * r + 1;
  const long long n_pix = (long long)b * h * w;
  const int lanes = std::min(32, pow2_at_least(C / cuts / VEC));
  const int cuts_p = pow2_at_least(cuts);
  int slices = 1;
  while (slices < S && lanes * slices * 2 <= 32 &&
         lanes * cuts_p * slices * 2 <= kBackwardThreads &&
         n_pix * lanes * cuts_p * slices * 2 <= kWaveThreads)
    slices <<= 1;
  const int tpp = lanes * cuts_p * slices;
  if (tpp > kBackwardThreads) return cudaErrorInvalidValue;  // too many cuts
  const int P = kBackwardThreads / tpp;
  const long long blocks = (n_pix + P - 1) / P;
  if (n_pix > 0x7fffffffLL) return cudaErrorInvalidValue;
  dscv_backward_kernel<T, VEC>
      <<<(unsigned)blocks, kBackwardThreads, 0, stream>>>(
          static_cast<const T*>(c1), static_cast<const T*>(c2),
          static_cast<const T*>(para), static_cast<const float*>(centre),
          static_cast<const float*>(rot), static_cast<const float*>(trans),
          static_cast<const float*>(focal),
          static_cast<const float*>(principal),
          static_cast<const float*>(dcv),
          static_cast<const float*>(dpara_out), static_cast<T*>(dc1),
          static_cast<float*>(dc2), static_cast<float*>(dcentre),
          static_cast<float*>(dpara), h, w, C, cuts, r, rot_dim, (int)n_pix,
          P, lanes, slices, tpp);
  return cudaGetLastError();
}

// 4-channel vectors (16-byte dc2 atomics; 16-byte loads of float32, 8-byte
// ones of bfloat16 and float16) where every vector of a cut is aligned, else scalars.
template <typename T>
cudaError_t launch_backward(const void* c1, const void* c2, const void* para,
                            const void* centre, const void* rot,
                            const void* trans, const void* focal,
                            const void* principal, const void* dcv,
                            const void* dpara_out, void* dc1, void* dc2,
                            void* dcentre, void* dpara, int b, int h, int w,
                            int C, int cuts, int r, int rot_dim,
                            cudaStream_t stream) {
  if ((C / cuts) % 4 == 0 && aligned16(c1) && aligned16(c2) &&
      aligned16(dc1) && aligned16(dc2))
    return launch_backward_v<T, 4>(
        c1, c2, para, centre, rot, trans, focal, principal, dcv, dpara_out,
        dc1, dc2, dcentre, dpara, b, h, w, C, cuts, r, rot_dim, stream);
  return launch_backward_v<T, 1>(c1, c2, para, centre, rot, trans, focal,
                                 principal, dcv, dpara_out, dc1, dc2,
                                 dcentre, dpara, b, h, w, C, cuts, r,
                                 rot_dim, stream);
}

}  // namespace

// c1, c2: [b, h, w, C] and para: [b, h, w, 1], all float32 (dtype = 0),
// bfloat16 (1) or float16 (2); centre: [b, h, w, 1] float32; rot: [b, rot_dim]
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
                            int rot_dim, int dtype, void* stream) {
  if (b <= 0 || h < 2 || w < 2 || cuts <= 0 || C % cuts != 0 || r < 0 ||
      (rot_dim != 3 && rot_dim != 4))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return (int)launch<float>(c1, c2, para, centre, rot, trans, focal,
                                principal, cv, para_out, b, h, w, C, cuts, r,
                                rot_dim, s);
    case kBFloat16:
      return (int)launch<__nv_bfloat16>(c1, c2, para, centre, rot, trans,
                                        focal, principal, cv, para_out, b, h,
                                        w, C, cuts, r, rot_dim, s);
    case kFloat16:
      return (int)launch<__half>(c1, c2, para, centre, rot, trans, focal,
                                 principal, cv, para_out, b, h, w, C, cuts, r,
                                 rot_dim, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
                             int C, int cuts, int r, int rot_dim, int dtype,
                             void* stream) {
  if (b <= 0 || h < 2 || w < 2 || cuts <= 0 || C % cuts != 0 || r < 0 ||
      (rot_dim != 3 && rot_dim != 4))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return (int)launch_backward<float>(
          c1, c2, para, centre, rot, trans, focal, principal, dcv, dpara_out,
          dc1, dc2, dcentre, dpara, b, h, w, C, cuts, r, rot_dim, s);
    case kBFloat16:
      return (int)launch_backward<__nv_bfloat16>(
          c1, c2, para, centre, rot, trans, focal, principal, dcv, dpara_out,
          dc1, dc2, dcentre, dpara, b, h, w, C, cuts, r, rot_dim, s);
    case kFloat16:
      return (int)launch_backward<__half>(
          c1, c2, para, centre, rot, trans, focal, principal, dcv, dpara_out,
          dc1, dc2, dcentre, dpara, b, h, w, C, cuts, r, rot_dim, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* dscv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
