// The epilogue of every `Conv3x3` (models/encoder.py) as two kernels for
// Hopper (sm_90a): the bias and the leaky ReLU after the cuDNN call, and
// their backward with the bias gradient. Their plain versions are
// ops/conv_epilogue.py's `conv_epilogue` and `conv_epilogue_backward`.
//
// They replace no TPU kernel: the JAX package's convs are flax `Conv`
// layers, and XLA fuses the bias and the activation into the conv's output
// there. In the port cuDNN returns the conv without its bias, then ATen
// added the bias in one broadcast pass, wrote the activation in a second,
// and, under autograd, kept the pre-activation for the activation's
// backward and summed the bias gradient over N H W in bfloat16. Both
// kernels are bound by device memory (a d6 frame's conv outputs are 57 MB
// in bfloat16, a V1 step of 8 frames 401 MB), so each is one pass:
//
// 1. `conv_epilogue_forward`, in place on the conv's output y [M, C]
//    (NHWC, M = N H W): y = act(y + bias). Each thread rewrites 16-byte
//    vectors, and takes the channel of each element from the vector's
//    offset, so any C (1 and 5 included) runs vectorised; the grid follows
//    the element count. One read and one write of y.
// 2. `conv_epilogue_backward`: dx = y > 0 ? g : g * slope from the output
//    gradient g and the saved activated output y (with a slope of 0 or
//    more, y > 0 exactly where the pre-activation is, so this is ATen's
//    leaky_relu_backward), and in the same pass the bias gradient, the sum
//    of dx over M, in float32. A thread's vectors lie a multiple of P = C /
//    gcd(C, VEC) vectors apart (the block's threads are a multiple of P), so
//    each of its VEC lanes sums one channel throughout. The block adds its
//    lanes up in shared memory in a fixed order and writes one row of
//    partial sums; a second, small launch adds the rows up in a fixed order.
//    The result is the same on every run. Without an activation dx is g:
//    the kernel only reads g.
//
// Precision: the forward gives the plain chain's two roundings bit for bit,
// t = rn(y + rn(bias)) (ATen's add of the bias cast to T) and then
// rn(t * slope) where t is not above 0 (ATen's leaky_relu, which returns t
// itself above 0), rn rounding to T to nearest even; the products and sums
// are `__fadd_rn` and `__fmul_rn`, never contracted into an FMA. The
// backward's dx is ATen's bit for bit; its bias gradient sums the rounded
// dx in float32 and stays float32, where the plain path rounded its sum to
// T: the same sum, taken more exactly.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// vectors a thread of the forward holds in flight
constexpr int kForwardItems = 2;
// the backward's block size at most, and the channels it takes
constexpr int kMaxThreads = 1024;
// the finishing launch: 32 channels a block, by 32 groups of rows
constexpr int kFinishGroups = 32;

// act(rn(y + rn(bias))) with act(t) = t > 0 ? t : rn(t * slope), or the
// identity without `act`; `b` is the bias already rounded to T.
template <typename T>
__device__ __forceinline__ float epilogue(float y, float b, float slope,
                                          bool act) {
  const float t = round_to<T>(__fadd_rn(y, b));
  return (!act || t > 0.f) ? t : round_to<T>(__fmul_rn(t, slope));
}

// y [n] in place, element e of channel e % C. A thread rewrites
// kForwardItems vectors of VEC elements, a block's vectors contiguous; the
// last vector may be short (n not a multiple of VEC). Plain loads, not the
// read-only path: the kernel writes what it reads.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
epilogue_forward_kernel(T* __restrict__ y, const float* __restrict__ bias,
                        long long n, int C, float slope, bool act) {
  using V = Vec<T, VEC>;
  const long long first =
      ((long long)blockIdx.x * kForwardItems * kThreads + threadIdx.x) * VEC;
  typename V::Raw raw[kForwardItems];
#pragma unroll
  for (int i = 0; i < kForwardItems; ++i) {
    const long long e = first + (long long)i * kThreads * VEC;
    if (e + VEC <= n)
      raw[i] = *reinterpret_cast<const typename V::Raw*>(y + e);
  }
#pragma unroll
  for (int i = 0; i < kForwardItems; ++i) {
    const long long e = first + (long long)i * kThreads * VEC;
    if (e >= n) continue;
    int c = (int)(e % C);
    if (e + VEC <= n) {
      float f[VEC];
      V::unpack(raw[i], f);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        f[k] = epilogue<T>(f[k], round_to<T>(__ldg(bias + c)), slope, act);
        if (++c == C) c = 0;
      }
      V::store(y + e, f);
    } else {
      for (long long j = e; j < n; ++j) {
        y[j] = from_float<T>(
            epilogue<T>(to_float(y[j]), round_to<T>(__ldg(bias + c)), slope,
                        act));
        if (++c == C) c = 0;
      }
    }
  }
}

// One full vector of the backward at element e: dx = y > 0 ? g : rn(g *
// slope) with `act` (stored; without it dx is g and nothing is stored)
// from the raw loads gr and yr, added to the thread's lanes acc.
template <typename T, int VEC>
__device__ __forceinline__ void backward_vector(
    typename Vec<T, VEC>::Raw gr, typename Vec<T, VEC>::Raw yr,
    T* __restrict__ dx, long long e, float slope, bool act, float* acc) {
  using V = Vec<T, VEC>;
  float d[VEC];
  V::unpack(gr, d);
  if (act) {
    float a[VEC];
    V::unpack(yr, a);
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (!(a[k] > 0.f)) d[k] = round_to<T>(__fmul_rn(d[k], slope));
    V::store(dx + e, d);
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], d[k]);
}

// dx = y > 0 ? g : rn(g * slope) with `act` (g itself without, not
// written), and partial[blockIdx.x][c] the block's float32 sum of dx over
// its elements of channel c. Thread t of a block of blockDim.x (a multiple
// of P = C / gcd(C, VEC)) handles vectors v = t + blockDim.x (blockIdx.x +
// gridDim.x i), two at a time, all congruent to t modulo P: its lane k
// always holds channel ((t % P) VEC + k) % C. The thread whose sequence
// holds the short last vector (n not a multiple of VEC) takes it element by
// element. Dynamic shared memory: blockDim.x x VEC lanes, then max(C,
// blockDim.x) slice sums.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
epilogue_backward_kernel(const T* __restrict__ g, const T* __restrict__ y,
                         T* __restrict__ dx, float* __restrict__ partial,
                         long long n, int C, int P, float slope, bool act) {
  extern __shared__ float smem[];
  using V = Vec<T, VEC>;
  const long long n_full = n / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  typename V::Raw zero{};
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  long long v = first;
  for (; v + stride < n_full; v += 2 * stride) {
    const long long e0 = v * VEC, e1 = (v + stride) * VEC;
    const typename V::Raw g0 = V::load_raw(g + e0), g1 = V::load_raw(g + e1);
    const typename V::Raw y0 = act ? V::load_raw(y + e0) : zero;
    const typename V::Raw y1 = act ? V::load_raw(y + e1) : zero;
    backward_vector<T, VEC>(g0, y0, dx, e0, slope, act, acc);
    backward_vector<T, VEC>(g1, y1, dx, e1, slope, act, acc);
  }
  if (v < n_full)
    backward_vector<T, VEC>(V::load_raw(g + v * VEC),
                            act ? V::load_raw(y + v * VEC) : zero, dx,
                            v * VEC, slope, act, acc);
  if (n_full * VEC < n && first == n_full % stride) {
    // the short last vector; unrolled, so that acc stays in registers
    const long long e = n_full * VEC;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      if (e + k >= n) break;
      float d = to_float(g[e + k]);
      if (act) {
        if (!(to_float(y[e + k]) > 0.f)) d = round_to<T>(__fmul_rn(d, slope));
        dx[e + k] = from_float<T>(d);
      }
      acc[k] = __fadd_rn(acc[k], d);
    }
  }

  // the block's lanes: thread t's lane k at t VEC + k. Channel c's lanes
  // are, in each group of P threads (period of P VEC lanes), the offsets
  // c, c + C, ... below P VEC. S slices of the groups sum their groups in
  // order, then the slices are added in order.
  float* lanes = smem;
  float* slices = smem + blockDim.x * VEC;
#pragma unroll
  for (int k = 0; k < VEC; ++k) lanes[threadIdx.x * VEC + k] = acc[k];
  __syncthreads();
  const int groups = blockDim.x / P;
  const int period = P * VEC;
  const int S = max(1, min(groups, (int)blockDim.x / C));
  for (int j = threadIdx.x; j < S * C; j += blockDim.x) {
    const int c = j % C, s = j / C;
    float sum = 0.f;
    for (int gi = s; gi < groups; gi += S)
      for (int o = c; o < period; o += C)
        sum = __fadd_rn(sum, lanes[gi * period + o]);
    slices[j] = sum;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float sum = 0.f;
    for (int s = 0; s < S; ++s) sum = __fadd_rn(sum, slices[s * C + c]);
    partial[(long long)blockIdx.x * C + c] = sum;
  }
}

// dbias[c] = the sum over r < rows of partial[r][c], in a fixed order: row
// group w of kFinishGroups sums rows w, w + kFinishGroups, ...; then the
// groups are added in order. A block takes 32 channels.
__global__ void __launch_bounds__(32 * kFinishGroups)
epilogue_bias_finish_kernel(const float* __restrict__ partial,
                            float* __restrict__ dbias, int rows, int C) {
  __shared__ float part[kFinishGroups][33];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  float sum = 0.f;
  if (c < C)
    for (int r = w; r < rows; r += kFinishGroups)
      sum = __fadd_rn(sum, partial[(long long)r * C + c]);
  part[w][lane] = sum;
  __syncthreads();
  if (w == 0 && c < C) {
    float total = part[0][lane];
    for (int i = 1; i < kFinishGroups; ++i)
      total = __fadd_rn(total, part[i][lane]);
    dbias[c] = total;
  }
}

int gcd(int a, int b) {
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

template <typename T>
cudaError_t launch_forward(void* y, const void* bias, long long n, int C,
                           float slope, bool act, cudaStream_t s) {
  T* p = static_cast<T*>(y);
  const float* b = static_cast<const float*>(bias);
  constexpr int kV = kVec<T>;
  constexpr long long kPerBlock = (long long)kThreads * kForwardItems;
  if (aligned16(y)) {
    const long long vecs = (n + kV - 1) / kV;
    epilogue_forward_kernel<T, kV>
        <<<(unsigned)((vecs + kPerBlock - 1) / kPerBlock), kThreads, 0, s>>>(
            p, b, n, C, slope, act);
  } else {
    epilogue_forward_kernel<T, 1>
        <<<(unsigned)((n + kPerBlock - 1) / kPerBlock), kThreads, 0, s>>>(
            p, b, n, C, slope, act);
  }
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_backward_vec(const T* g, const T* y, T* dx,
                                float* workspace, float* dbias, long long n,
                                int C, int rows, float slope, bool act,
                                cudaStream_t s) {
  const int P = C / gcd(C, VEC);
  const int threads = P * max(1, kThreads / P);
  const long long n_vec = (n + VEC - 1) / VEC;
  const int blocks =
      (int)std::min<long long>((n_vec + threads - 1) / threads, rows);
  const size_t smem =
      sizeof(float) * ((size_t)threads * VEC + (size_t)std::max(C, threads));
  // one block sums everything: its row is the gradient
  float* partial = blocks == 1 ? dbias : workspace;
  epilogue_backward_kernel<T, VEC><<<blocks, threads, smem, s>>>(
      g, y, dx, partial, n, C, P, slope, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 1) return err;
  epilogue_bias_finish_kernel<<<(C + 31) / 32, 32 * kFinishGroups, 0, s>>>(
      workspace, dbias, blocks, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_backward(const void* g, const void* y, void* dx,
                            void* workspace, void* dbias, long long n, int C,
                            int rows, float slope, bool act, cudaStream_t s) {
  const T* gp = static_cast<const T*>(g);
  const T* yp = static_cast<const T*>(y);
  T* dxp = static_cast<T*>(dx);
  float* ws = static_cast<float*>(workspace);
  float* db = static_cast<float*>(dbias);
  if (aligned16(g) && (!act || (aligned16(y) && aligned16(dx))))
    return launch_backward_vec<T, kVec<T>>(gp, yp, dxp, ws, db, n, C, rows,
                                           slope, act, s);
  return launch_backward_vec<T, 1>(gp, yp, dxp, ws, db, n, C, rows, slope,
                                   act, s);
}

}  // namespace

// The conv's output y [m, C] in dtype (0 float32, 1 bfloat16, 2 float16)
// rewritten in place as act(y + bias) (see `epilogue`), with bias [C]
// float32 and, where act is not 0, the leaky ReLU of the given slope; both
// contiguous, on the device of `stream`. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int conv_epilogue_forward(void* y, const void* bias, long long m,
                                     int C, float slope, int act, int dtype,
                                     void* stream) {
  if (m <= 0 || C <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = m * C;
  switch (dtype) {
    case kFloat32:
      return (int)launch_forward<float>(y, bias, n, C, slope, act != 0, s);
    case kBFloat16:
      return (int)launch_forward<__nv_bfloat16>(y, bias, n, C, slope,
                                                act != 0, s);
    case kFloat16:
      return (int)launch_forward<__half>(y, bias, n, C, slope, act != 0, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The epilogue's backward: from the output gradient g [m, C] and, where act
// is not 0, the activated output y [m, C] (both in dtype, codes as above),
// dx [m, C] in dtype = y > 0 ? g : g * slope (slope 0 or more; without
// act, y and dx are not read or written: dx is g) and dbias [C] float32,
// the sum of dx over m. workspace holds rows x C floats: the backward runs
// at most `rows` blocks. Contiguous, on the device of `stream`, C at most
// 1024. Returns the CUDA error code of the launches (0 on success).
extern "C" int conv_epilogue_backward(const void* g, const void* y, void* dx,
                                      void* workspace, void* dbias,
                                      long long m, int C, int rows,
                                      float slope, int act, int dtype,
                                      void* stream) {
  if (m <= 0 || C <= 0 || C > kMaxThreads || rows <= 0 ||
      (act && !(slope >= 0.f)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = m * C;
#define CONV_EPILOGUE_BACKWARD_ARGS \
  g, y, dx, workspace, dbias, n, C, rows, slope, act != 0, s
  switch (dtype) {
    case kFloat32:
      return (int)launch_backward<float>(CONV_EPILOGUE_BACKWARD_ARGS);
    case kBFloat16:
      return (int)launch_backward<__nv_bfloat16>(CONV_EPILOGUE_BACKWARD_ARGS);
    case kFloat16:
      return (int)launch_backward<__half>(CONV_EPILOGUE_BACKWARD_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CONV_EPILOGUE_BACKWARD_ARGS
}

extern "C" const char* conv_epilogue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
