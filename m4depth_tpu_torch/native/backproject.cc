// Native bilinear backproject (flow-field warp), forward and backward, on
// the host. The port's copy of m4depth_tpu/native/backproject.cc.
//
// Host-side counterpart of the reference's CUDA BackProject op pair
// (cuda_backproject/backproject_op.cc, backproject_op_gpu.cu.cc): on the
// card the warp is ops/warp.py (and the DSCV kernel samples inline); this
// implementation serves as a test oracle and as a CPU path for host-side
// preprocessing. Parallelized over the batch dimension with std::thread, so
// the backward scatter needs no atomics (each batch element owns its
// gradient slabs).
//
// Semantics match m4depth_tpu_torch/ops/warp.py:
//   out[b, y, x, :] = bilerp(img[b], x + flow[b,y,x,0], y + flow[b,y,x,1])
// with floor indices clamped to [0, size-2] and fractions to [0, 1].

#include <algorithm>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Tap {
  int x0, y0;
  float ax, ay;
  bool ax_live, ay_live;  // fraction not clamped => gradient flows
};

inline Tap make_tap(float qx, float qy, int h, int w) {
  Tap t;
  float x0f = std::floor(qx);
  float y0f = std::floor(qy);
  x0f = std::min(std::max(x0f, 0.f), float(std::max(w - 2, 0)));
  y0f = std::min(std::max(y0f, 0.f), float(std::max(h - 2, 0)));
  float ax = qx - x0f;
  float ay = qy - y0f;
  t.ax_live = ax > 0.f && ax < 1.f;
  t.ay_live = ay > 0.f && ay < 1.f;
  t.ax = std::min(std::max(ax, 0.f), 1.f);
  t.ay = std::min(std::max(ay, 0.f), 1.f);
  t.x0 = int(x0f);
  t.y0 = int(y0f);
  return t;
}

void forward_batch(const float* img, const float* flow, float* out,
                   int h, int w, int c) {
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const float* f = flow + (y * w + x) * 2;
      Tap t = make_tap(x + f[0], y + f[1], h, w);
      const float* tl = img + (t.y0 * w + t.x0) * c;
      const float* tr = tl + c;
      const float* bl = tl + w * c;
      const float* br = bl + c;
      float* o = out + (y * w + x) * c;
      for (int k = 0; k < c; ++k) {
        float top = tl[k] + (tr[k] - tl[k]) * t.ax;
        float bot = bl[k] + (br[k] - bl[k]) * t.ax;
        o[k] = top + (bot - top) * t.ay;
      }
    }
  }
}

void backward_batch(const float* img, const float* flow, const float* grad,
                    float* dimg, float* dflow, int h, int w, int c) {
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const float* f = flow + (y * w + x) * 2;
      Tap t = make_tap(x + f[0], y + f[1], h, w);
      const float* g = grad + (y * w + x) * c;
      const float* tl = img + (t.y0 * w + t.x0) * c;
      const float* tr = tl + c;
      const float* bl = tl + w * c;
      const float* br = bl + c;
      float* dtl = dimg + (t.y0 * w + t.x0) * c;
      float* dtr = dtl + c;
      float* dbl = dtl + w * c;
      float* dbr = dbl + c;
      float gx = 0.f, gy = 0.f;
      for (int k = 0; k < c; ++k) {
        float gk = g[k];
        // image gradient: bilinear weights scatter
        dtl[k] += gk * (1.f - t.ax) * (1.f - t.ay);
        dtr[k] += gk * t.ax * (1.f - t.ay);
        dbl[k] += gk * (1.f - t.ax) * t.ay;
        dbr[k] += gk * t.ax * t.ay;
        // coordinate gradients (zero where the fraction clamped)
        float top = tl[k] + (tr[k] - tl[k]) * t.ax;
        float bot = bl[k] + (br[k] - bl[k]) * t.ax;
        if (t.ax_live) {
          gx += gk * ((tr[k] - tl[k]) * (1.f - t.ay) + (br[k] - bl[k]) * t.ay);
        }
        if (t.ay_live) {
          gy += gk * (bot - top);
        }
      }
      float* df = dflow + (y * w + x) * 2;
      df[0] = gx;
      df[1] = gy;
    }
  }
}

template <typename Fn>
void parallel_over_batch(int b, int threads, Fn fn) {
  if (threads <= 1 || b <= 1) {
    for (int i = 0; i < b; ++i) fn(i);
    return;
  }
  std::vector<std::thread> pool;
  int n_threads = std::min(threads, b);
  std::vector<int> next(1, 0);
  for (int ti = 0; ti < n_threads; ++ti) {
    pool.emplace_back([&, ti]() {
      for (int i = ti; i < b; i += n_threads) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

void backproject_forward(const float* img, const float* flow, float* out,
                         int b, int h, int w, int c, int threads) {
  parallel_over_batch(b, threads, [=](int i) {
    forward_batch(img + size_t(i) * h * w * c, flow + size_t(i) * h * w * 2,
                  out + size_t(i) * h * w * c, h, w, c);
  });
}

void backproject_backward(const float* img, const float* flow,
                          const float* grad, float* dimg, float* dflow,
                          int b, int h, int w, int c, int threads) {
  std::memset(dimg, 0, sizeof(float) * size_t(b) * h * w * c);
  parallel_over_batch(b, threads, [=](int i) {
    backward_batch(img + size_t(i) * h * w * c, flow + size_t(i) * h * w * 2,
                   grad + size_t(i) * h * w * c,
                   dimg + size_t(i) * h * w * c, dflow + size_t(i) * h * w * 2,
                   h, w, c);
  });
}

}  // extern "C"
