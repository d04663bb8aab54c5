// Stage marks: empty one-thread kernels that bound the stages of a frame or
// a step on the device (m4depth_tpu_torch/utils/tracing.py).
//
// A replayed CUDA graph runs no host code per node, so a host annotation
// made while the graph was captured never reaches a replay. A stage
// boundary is therefore a kernel captured into the graph. One template
// instantiation per stage puts the stage's index into the kernel's name,
// `m4d_stage_mark<i>`, which the profiler reports as a device event on the
// clock of every other kernel. The kernel reads and writes nothing.

#include <cuda_runtime.h>

#include <array>
#include <utility>

// len(tracing.STAGES); a CPU test holds the two equal
constexpr int kStages = 24;

template <int S>
__global__ void m4d_stage_mark() {}

namespace {

using MarkKernel = void (*)();

template <int... S>
constexpr std::array<MarkKernel, sizeof...(S)> mark_kernels(
    std::integer_sequence<int, S...>) {
  return {{&m4d_stage_mark<S>...}};
}

const std::array<MarkKernel, kStages> kMarks =
    mark_kernels(std::make_integer_sequence<int, kStages>{});

}  // namespace

// Launch the mark of stage `stage` (0 <= stage < kStages) on `stream`, a
// stream of the current device. Returns the CUDA error code of the launch
// (0 on success).
extern "C" int stage_mark(int stage, void* stream) {
  if (stage < 0 || stage >= kStages) return (int)cudaErrorInvalidValue;
  return (int)cudaLaunchKernel(reinterpret_cast<const void*>(kMarks[stage]),
                               dim3(1), dim3(1), nullptr, 0,
                               static_cast<cudaStream_t>(stream));
}

extern "C" const char* mark_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
