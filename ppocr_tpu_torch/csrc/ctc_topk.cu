// CTC top-k: per row of [rows, V] f32, the max value and the FIRST column
// index reaching it.
//
// Replaces the Pallas TPU kernel ppocr_tpu/ops/pallas_kernels.py
// ctc_topk_pallas (_ctc_topk_kernel). Semantics kept exactly: ties go to
// the lower index; a row holding any NaN gives (V-1, NaN) — the Pallas
// kernel's clamped no-hit sentinel, not torch.argmax's NaN position; an
// all -inf row gives index 0.
//
// Bound on an H100: bytes. Each row is read once (rows·V·4 B; 41 MB at
// [32, 64, 5008], 12.3 us at 3.35 TB/s; 10.3 MB and 3.1 us at the
// [16, 32, 5008] tier of a 768x1024 request) and the work is one compare
// per element. At the request's tier the bound is about what an empty
// launch takes, so there the kernel is held to the launch floor.
//
// The first design (one warp per row, 8 warps a block, 8 scalar loads a
// lane) got its parallelism from the row count alone: 512 rows made 64
// blocks, under half of the 132 SMs, with 8 KB in flight each — 0.5 MB on
// the card where 3.35 TB/s times the memory latency wants about 2 MB. It
// read 0.41 TB/s at 512 rows (0.0251 ms) and 1.10 TB/s at 2,048 rows
// (0.0373 ms) on an NVIDIA H100 80GB HBM3 at 700 W.
//
// This design: one block of kThreads = 128 per row, so 512 rows are ~4
// blocks on every SM and 2,048 rows fill all 16 block slots of each. A
// thread reads 16 bytes at a time (float4 through the read-only path),
// neighbouring threads neighbouring vectors, and starts kUnroll = 4 of
// them before the first compare: 8 KB a block, up to 128 KB an SM in
// flight. Chosen over a bulk asynchronous copy into shared memory because
// a row is consumed once, straight from registers: the copy engine would
// add a barrier round trip and shared-memory traffic to save address
// arithmetic that is not the limit here.
//
// Threads, loads in flight and the load instruction are macros so that
// scripts/tune_torch_kernels.py can time them against each other. On the
// same card, [32, 64, 5008]: 128x4 0.0253 ms after an L2 flush and
// 0.0139 ms without one; 256x8 0.0246 / 0.0165; 512x4 with streaming
// loads (__ldcs) 0.0217 / 0.0201. On the serving path the kernel reads
// what the softmax before it just wrote, so the choice goes by the time
// without the flush; at [16, 32, 5008] all of them are within 0.5 us
// (0.0116 ms flushed, 0.0077 ms not).
//
// Alignment: a row starts 16-byte aligned only when V % 4 == 0 and the
// base pointer is aligned. Each block peels its own scalar head (up to 3
// columns, to the next 16-byte boundary) and tail (up to 3), so any V and
// any 4-byte aligned base take the same path with no copy.
//
// Ties and NaN: every compare, in a thread and in every merge (lanes by
// shuffle, warps through shared memory), takes the other candidate when
// its value is greater, or equal with a lower column; so the order in
// which columns are read does not matter. A NaN never wins a compare; it
// sets a flag that is ORed over the block and overrides the result.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef CTC_THREADS
#define CTC_THREADS 128
#endif
#ifndef CTC_UNROLL
#define CTC_UNROLL 4
#endif
#ifndef CTC_LOAD  // the 16-byte load: __ldg (read-only path) or __ldcs (streaming)
#define CTC_LOAD __ldg
#endif

namespace {

constexpr int kThreads = CTC_THREADS;
constexpr int kUnroll = CTC_UNROLL;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void take(float x, int c, float& best, int& bi, bool& nan) {
  nan |= x != x;
  if (x > best || (x == best && c < bi)) {
    best = x;
    bi = c;
  }
}

__device__ __forceinline__ void warp_merge(float& best, int& bi, bool& nan) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (ob > best || (ob == best && oi < bi)) {
      best = ob;
      bi = oi;
    }
  }
  nan = __any_sync(kFull, nan);
}

__global__ void __launch_bounds__(kThreads)
ctc_topk_kernel(const float* __restrict__ probs, int v, int* __restrict__ idx,
                float* __restrict__ val) {
  __shared__ float s_best[kWarps];
  __shared__ int s_bi[kWarps];
  __shared__ int s_nan[kWarps];
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const float* p = probs + (size_t)row * v;
  // columns [0, head) and [tail0, v) are read one by one, [head, tail0)
  // as nvec aligned float4
  const int head = min(v, (int)((16u - ((uintptr_t)p & 15u)) & 15u) >> 2);
  const int nvec = (v - head) >> 2;
  const int tail0 = head + 4 * nvec;
  const float4* q = reinterpret_cast<const float4*>(p + head);

  float best = -INFINITY;
  int bi = v;  // no-hit sentinel, as the Pallas kernel's padded width
  bool nan = false;
  for (int i0 = tid; i0 < nvec; i0 += kThreads * kUnroll) {
    float4 xs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < nvec) xs[u] = CTC_LOAD(q + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < nvec) {
        const int c = head + 4 * i;
        take(xs[u].x, c, best, bi, nan);
        take(xs[u].y, c + 1, best, bi, nan);
        take(xs[u].z, c + 2, best, bi, nan);
        take(xs[u].w, c + 3, best, bi, nan);
      }
    }
  }
  if (tid < head) take(__ldg(p + tid), tid, best, bi, nan);
  if (tail0 + tid < v) take(__ldg(p + tail0 + tid), tail0 + tid, best, bi, nan);

  warp_merge(best, bi, nan);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (lane == 0) {
    s_best[warp] = best;
    s_bi[warp] = bi;
    s_nan[warp] = nan;
  }
  __syncthreads();
  if (warp != 0) return;
  best = lane < kWarps ? s_best[lane] : -INFINITY;
  bi = lane < kWarps ? s_bi[lane] : v;
  nan = lane < kWarps && s_nan[lane];
  warp_merge(best, bi, nan);
  if (lane == 0) {
    idx[row] = nan ? v - 1 : min(bi, v - 1);
    val[row] = nan ? NAN : best;
  }
}

}  // namespace

extern "C" int ctc_topk_launch(const float* probs, int rows, int v, int* idx,
                               float* val, void* stream) {
  if (rows <= 0 || v <= 0) return 0;
  ctc_topk_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(probs, v, idx, val);
  return (int)cudaGetLastError();
}
