// CTC top-k: per row of [rows, V] f32, the max value and the FIRST column
// index reaching it.
//
// Replaces the Pallas TPU kernel ppocr_tpu/ops/pallas_kernels.py
// ctc_topk_pallas (_ctc_topk_kernel). Semantics kept exactly: ties go to
// the lower index; a row holding any NaN gives (V-1, NaN) — the Pallas
// kernel's clamped no-hit sentinel, not torch.argmax's NaN position.
//
// Bound on an H100: bytes. Each row is read once (rows·V·4 B; 41 MB at
// [32, 64, 5008], ~12 us at 3.35 TB/s) and the work is one compare per
// element. Design: one warp per row, lanes stride over V so each load
// instruction of the warp reads 128 contiguous bytes, with kUnroll loads
// issued before their compares to keep enough bytes in flight; each lane
// keeps its own first-max (strict >, its columns ascend), then a shuffle
// reduction that prefers the smaller index on equal values, and a warp
// vote for NaN.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 8;

__global__ void ctc_topk_kernel(const float* __restrict__ probs, int rows, int v,
                                int* __restrict__ idx, float* __restrict__ val) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* p = probs + (size_t)row * v;
  float best = -INFINITY;
  int bi = v;  // no-hit sentinel, as the Pallas kernel's padded width
  bool nan = false;
  for (int c0 = lane; c0 < v; c0 += 32 * kUnroll) {
    float xs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + 32 * u;
      xs[u] = c < v ? __ldg(p + c) : -INFINITY;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + 32 * u;
      nan |= isnan(xs[u]);
      if (c < v && (xs[u] > best || (xs[u] == best && c < bi))) {
        best = xs[u];
        bi = c;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (ob > best || (ob == best && oi < bi)) {
      best = ob;
      bi = oi;
    }
  }
  nan = __any_sync(0xffffffffu, nan);
  if (lane == 0) {
    idx[row] = nan ? v - 1 : min(bi, v - 1);
    val[row] = nan ? NAN : best;
  }
}

}  // namespace

extern "C" int ctc_topk_launch(const float* probs, int rows, int v, int* idx,
                               float* val, void* stream) {
  if (rows <= 0) return 0;
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ctc_topk_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      probs, rows, v, idx, val);
  return (int)cudaGetLastError();
}
