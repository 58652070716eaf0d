// An empty kernel, one block of one thread: what a launch alone costs on
// the card. It is the yardstick ("floor") for kernels whose byte bound is
// below the cost of a launch; nothing on the serving path calls it.
#include <cuda_runtime.h>

namespace {
__global__ void noop_kernel() {}
}  // namespace

extern "C" int noop_launch(void* stream) {
  noop_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
