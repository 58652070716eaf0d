// Blob stats: one pass over (labels, prob) of a batch of det maps giving,
// per selected root, the pixel count, the prob mass and the bbox.
//
// Replaces the Pallas TPU kernel ppocr_tpu/ops/pallas_kernels.py
// blob_stats_pallas (_blob_stats_kernel). Like it, the [K, H, W]
// membership mask is never built. The TPU kernel walked row tiles in
// order and carried its accumulator between grid steps; here blocks run
// in no order, so each block accumulates its own stretch of pixels in
// shared memory and flushes to global memory with atomics.
//
// Bound on an H100: bytes (B·H·W·8 B read; 2.1 MB at 512², ~0.6 us at
// 3.35 TB/s), so in practice the launch. Design: grid (stretches, B);
// each block holds its image's K roots in shared memory. A warp takes 32
// neighbouring pixels at a time and, for each slot, votes which lanes'
// labels equal the slot's root; for a slot with a match the warp reduces
// count, mass and min/max x/y across lanes (__reduce_*_sync, shuffles)
// and one lane adds them into the block's shared accumulators. Text
// pixels are contiguous, so this replaces up to 32 colliding shared
// atomics per statistic with one (the first version, one atomic per
// pixel, ran slower than the plain PyTorch version). Every slot whose
// root equals the label accumulates, so duplicate roots each get full
// stats and -1 slots match nothing. Accumulators: int count, f32 mass,
// int min/max of x and y. The f32 mass is summed in an order that changes
// from run to run (atomics): callers compare it with rtol 1e-5. Outputs
// are acc_i [B, K, 5] (count, x0, x1, y0, y1) and psum [B, K],
// initialised by the caller to (0, INT_MAX, INT_MIN, INT_MAX, INT_MIN)
// and 0.
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;

__global__ void blob_stats_kernel(const int* __restrict__ labels,
                                  const float* __restrict__ prob,
                                  const int* __restrict__ roots, int hw, int w,
                                  int k, int chunk, int* __restrict__ acc_i,
                                  float* __restrict__ psum) {
  extern __shared__ int smem[];
  int* s_root = smem;
  int* s_area = s_root + k;
  int* s_x0 = s_area + k;
  int* s_x1 = s_x0 + k;
  int* s_y0 = s_x1 + k;
  int* s_y1 = s_y0 + k;
  float* s_psum = reinterpret_cast<float*>(s_y1 + k);

  const int b = blockIdx.y;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    s_root[j] = roots[b * k + j];
    s_area[j] = 0;
    s_x0[j] = INT_MAX;
    s_x1[j] = INT_MIN;
    s_y0[j] = INT_MAX;
    s_y1[j] = INT_MIN;
    s_psum[j] = 0.f;
  }
  __syncthreads();

  const int* lab = labels + (size_t)b * hw;
  const float* pr = prob + (size_t)b * hw;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int beg = blockIdx.x * chunk;
  const int end = min(beg + chunk, hw);
  // warp-uniform loop: every lane runs every iteration, so the full-mask
  // votes and reductions below are legal; lanes past the end hold label -2,
  // which no root equals (roots are >= -1)
  for (int base = beg + warp * 32; base < end; base += n_warps * 32) {
    const int p = base + lane;
    const bool in = p < end;
    const int l = in ? lab[p] : -2;
    const float v = in ? pr[p] : 0.f;
    const int y = p / w;
    const int x = p - y * w;
    for (int j = 0; j < k; ++j) {
      const bool m = s_root[j] == l;
      const unsigned ball = __ballot_sync(0xffffffffu, m);
      if (ball == 0) continue;
      const int x0 = __reduce_min_sync(0xffffffffu, m ? x : INT_MAX);
      const int x1 = __reduce_max_sync(0xffffffffu, m ? x : INT_MIN);
      const int y0 = __reduce_min_sync(0xffffffffu, m ? y : INT_MAX);
      const int y1 = __reduce_max_sync(0xffffffffu, m ? y : INT_MIN);
      float ps = m ? v : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      if (lane == 0) {
        atomicAdd(&s_area[j], __popc(ball));
        atomicAdd(&s_psum[j], ps);
        atomicMin(&s_x0[j], x0);
        atomicMax(&s_x1[j], x1);
        atomicMin(&s_y0[j], y0);
        atomicMax(&s_y1[j], y1);
      }
    }
  }
  __syncthreads();

  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    if (s_area[j] == 0) continue;
    int* a = acc_i + ((size_t)b * k + j) * 5;
    atomicAdd(&a[0], s_area[j]);
    atomicMin(&a[1], s_x0[j]);
    atomicMax(&a[2], s_x1[j]);
    atomicMin(&a[3], s_y0[j]);
    atomicMax(&a[4], s_y1[j]);
    atomicAdd(&psum[(size_t)b * k + j], s_psum[j]);
  }
}

}  // namespace

extern "C" int blob_stats_launch(const int* labels, const float* prob,
                                 const int* roots, int batch, int h, int w,
                                 int k, int chunk, int* acc_i, float* psum,
                                 void* stream) {
  const int hw = h * w;
  if (batch <= 0 || hw <= 0 || k <= 0) return 0;
  const size_t smem = (size_t)k * 7 * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        blob_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((hw + chunk - 1) / chunk, batch);
  blob_stats_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      labels, prob, roots, hw, w, k, chunk, acc_i, psum);
  return (int)cudaGetLastError();
}
