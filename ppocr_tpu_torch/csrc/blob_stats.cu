// Blob stats: one pass over (labels, prob) of a batch of det maps giving,
// per selected root, the pixel count, the prob mass and the bbox, as six
// f32 [B, K] outputs (empty roots: x0/y0 = +1e9, x1/y1 = -1e9).
//
// Replaces the Pallas TPU kernel ppocr_tpu/ops/pallas_kernels.py
// blob_stats_pallas (_blob_stats_kernel). Like it, the [K, H, W]
// membership mask is never built. The TPU kernel walked row tiles in
// order and carried its accumulator between grid steps; here blocks run
// in no order, so each block accumulates its own pixels in shared memory
// and flushes to global memory with atomics.
//
// Bound on an H100: bytes (B·H·W·8 B read; 1.6 MB at [1, 384, 512],
// 0.47 us at 3.35 TB/s), which is below what an empty launch takes, so
// the yardstick is the launch floor: the kernel is latency, not rate.
//
// The first design ran, for every 32 pixels, a loop over all K slots with
// one warp vote each, background or not, and left the initialisation of
// its accumulators and the conversion to the f32 outputs to about
// fourteen small PyTorch launches around it: 0.0141 ms for the kernel and
// 0.0554 ms with its wrapper at [1, 384, 512], K = 32, on an NVIDIA H100
// 80GB HBM3 at 700 W.
//
// This design is one launch with nothing around it:
//
// * Loop by labels, not by slots. A lane loads 4 neighbouring pixels with
//   one 16-byte load each of labels and prob (scalar loads when H·W % 4
//   != 0 or a pointer is not 16-byte aligned). For each of the 4 the warp
//   holds 32 labels. If all are the background value (an argument; the
//   skip is off for an image one of whose roots equals it) the warp moves
//   on. Otherwise it takes one distinct label at a time: a vote gives the
//   lanes holding it, lane j compares it with root j (ceil(K/32) rounds),
//   and only if some slot matches does the warp reduce count, mass and
//   min/max x and y over those lanes (__reduce_*_sync, shuffles); every
//   matching lane then adds the result to its own slot, so duplicate
//   roots each get full stats and -1 slots match nothing. A text map
//   costs one or two passes per 32 pixels instead of K votes. x and y
//   come from the flat pixel index, so a warp may straddle image rows.
// * One launch. The global accumulators live in a scratch buffer that is
//   all zero between calls: count and mass add from 0, and the bbox is
//   kept as maxima of INT_MAX - x0, x1 + 1, INT_MAX - y0, y1 + 1, which
//   are > 0 for any pixel. The last block to finish (a __threadfence()
//   and an atomic ticket, word 0 of the scratch) exchanges each
//   accumulator with 0, writes the six f32 outputs with the sentinels and
//   resets the ticket. Chosen over init, main and finalize kernels queued
//   by one C call because three dependent launches cost about three
//   floors on the card, and this kernel's whole time is about two.
//   The caller zeroes the scratch once, holds one per stream, and must
//   not share it between streams.
//
// The f32 mass is summed by atomics in an order that changes from run to
// run: callers compare it with rtol 1e-5. Counts and coordinates are
// integers and exact.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;                 // pixels per lane and step
constexpr int kStep = kThreads * kPix;  // pixels per block and step
constexpr int kMaxBlocksX = 1024;
constexpr int kAcc = 6;  // scratch words per slot: count, mass, x0, x1, y0, y1
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e9f;

// A lane's kPix pixels of the warp's 32·kPix from `base`: neighbouring ones
// by one 16-byte load each of labels and prob (kVec: hw % 4 == 0, so the
// four are in range together), else pixel base + lane + 32·j by scalar
// loads. Pixels past the end read as background with prob 0.
template <bool kVec>
__device__ __forceinline__ void load_pixels(const int* __restrict__ lab,
                                            const float* __restrict__ pr, int base,
                                            int lane, int hw, int bg,
                                            int (&ls)[kPix], float (&vs)[kPix]) {
  if (kVec) {
    const int p0 = base + lane * kPix;
    int4 l4 = make_int4(bg, bg, bg, bg);
    float4 v4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p0 < hw) {
      l4 = __ldg(reinterpret_cast<const int4*>(lab + p0));
      v4 = __ldg(reinterpret_cast<const float4*>(pr + p0));
    }
    ls[0] = l4.x, ls[1] = l4.y, ls[2] = l4.z, ls[3] = l4.w;
    vs[0] = v4.x, vs[1] = v4.y, vs[2] = v4.z, vs[3] = v4.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int p = base + lane + 32 * j;
      ls[j] = p < hw ? __ldg(lab + p) : bg;
      vs[j] = p < hw ? __ldg(pr + p) : 0.f;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
blob_stats_kernel(const int* __restrict__ labels, const float* __restrict__ prob,
                  const int* __restrict__ roots, int hw, int w, int k, int bg,
                  int* __restrict__ scratch, float* __restrict__ out) {
  extern __shared__ int smem[];
  __shared__ int s_last;
  int* s_root = smem;
  int* s_area = s_root + k;
  int* s_x0 = s_area + k;
  int* s_x1 = s_x0 + k;
  int* s_y0 = s_x1 + k;
  int* s_y1 = s_y0 + k;
  float* s_psum = reinterpret_cast<float*>(s_y1 + k);

  const int b = blockIdx.y;
  const int* lab = labels + (size_t)b * hw;
  const float* pr = prob + (size_t)b * hw;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int bg_is_root = 0;
  for (int j = threadIdx.x; j < k; j += kThreads) {
    const int r = roots[b * k + j];
    bg_is_root |= r == bg;
    s_root[j] = r;
    s_area[j] = 0;
    s_x0[j] = INT_MAX;
    s_x1[j] = INT_MIN;
    s_y0[j] = INT_MAX;
    s_y1[j] = INT_MIN;
    s_psum[j] = 0.f;
  }
  const bool skip_bg = !__syncthreads_or(bg_is_root);

  // warp-uniform loops throughout: every lane runs every iteration, so
  // the full-mask votes, shuffles and reductions are legal
  for (int base = blockIdx.x * kStep + warp * (32 * kPix); base < hw;
       base += gridDim.x * kStep) {
    int ls[kPix];
    float vs[kPix];
    load_pixels<kVec>(lab, pr, base, lane, hw, bg, ls, vs);
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int p = kVec ? base + lane * kPix + j : base + lane + 32 * j;
      const int l = ls[j];
      const bool live = p < hw && !(skip_bg && l == bg);
      unsigned todo = __ballot_sync(kFull, live);
      if (todo == 0) continue;
      const int y = p / w;
      const int x = p - y * w;
      while (todo) {
        const int cur = __shfl_sync(kFull, l, __ffs(todo) - 1);
        const bool m = live && l == cur;
        const unsigned group = __ballot_sync(kFull, m);
        todo &= ~group;
        bool reduced = false;
        int x0 = 0, x1 = 0, y0 = 0, y1 = 0;
        float ps = 0.f;
        for (int r = 0; r < k; r += 32) {
          const int slot = r + lane;
          const bool hit = slot < k && s_root[slot] == cur;
          if (!__any_sync(kFull, hit)) continue;
          if (!reduced) {
            reduced = true;
            x0 = __reduce_min_sync(kFull, m ? x : INT_MAX);
            x1 = __reduce_max_sync(kFull, m ? x : INT_MIN);
            y0 = __reduce_min_sync(kFull, m ? y : INT_MAX);
            y1 = __reduce_max_sync(kFull, m ? y : INT_MIN);
            ps = m ? vs[j] : 0.f;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              ps += __shfl_xor_sync(kFull, ps, off);
          }
          if (hit) {
            atomicAdd(&s_area[slot], __popc(group));
            atomicAdd(&s_psum[slot], ps);
            atomicMin(&s_x0[slot], x0);
            atomicMax(&s_x1[slot], x1);
            atomicMin(&s_y0[slot], y0);
            atomicMax(&s_y1[slot], y1);
          }
        }
      }
    }
  }
  __syncthreads();

  int* acc = scratch + 1;
  for (int j = threadIdx.x; j < k; j += kThreads) {
    if (s_area[j] == 0) continue;
    int* a = acc + ((size_t)b * k + j) * kAcc;
    atomicAdd(&a[0], s_area[j]);
    atomicAdd(reinterpret_cast<float*>(&a[1]), s_psum[j]);
    atomicMax(&a[2], INT_MAX - s_x0[j]);
    atomicMax(&a[3], s_x1[j] + 1);
    atomicMax(&a[4], INT_MAX - s_y0[j]);
    atomicMax(&a[5], s_y1[j] + 1);
  }
  // the ticket: this block's atomics are visible before its ticket is
  // drawn, so whoever draws the last one sees every block's
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&scratch[0], 1) == (int)(gridDim.x * gridDim.y) - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int n = gridDim.y * k;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    int* a = acc + (size_t)i * kAcc;
    const int cnt = atomicExch(&a[0], 0);
    const float ps = atomicExch(reinterpret_cast<float*>(&a[1]), 0.f);
    const int x0 = atomicExch(&a[2], 0);
    const int x1 = atomicExch(&a[3], 0);
    const int y0 = atomicExch(&a[4], 0);
    const int y1 = atomicExch(&a[5], 0);
    const bool hit = cnt > 0;
    out[i] = (float)cnt;
    out[n + i] = ps;
    out[2 * n + i] = hit ? (float)(INT_MAX - x0) : kBig;
    out[3 * n + i] = hit ? (float)(x1 - 1) : -kBig;
    out[4 * n + i] = hit ? (float)(INT_MAX - y0) : kBig;
    out[5 * n + i] = hit ? (float)(y1 - 1) : -kBig;
  }
  if (threadIdx.x == 0) scratch[0] = 0;
}

template <bool kVec>
cudaError_t launch(const int* labels, const float* prob, const int* roots,
                   int batch, int hw, int w, int k, int bg, int* scratch,
                   float* out, cudaStream_t stream) {
  const size_t smem = (size_t)k * 7 * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        blob_stats_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  int blocks_x = (hw + kStep - 1) / kStep;
  blocks_x = blocks_x < 1 ? 1 : (blocks_x > kMaxBlocksX ? kMaxBlocksX : blocks_x);
  blob_stats_kernel<kVec><<<dim3(blocks_x, batch), kThreads, smem, stream>>>(
      labels, prob, roots, hw, w, k, bg, scratch, out);
  return cudaGetLastError();
}

}  // namespace

// labels, prob [batch, h, w]; roots [batch, k]; bg: the label of pixels in
// no blob; scratch: 1 + 6·batch·k zeroed int32 words, left zeroed; out:
// [6, batch, k] f32 (count, mass, x0, x1, y0, y1).
extern "C" int blob_stats_launch(const int* labels, const float* prob,
                                 const int* roots, int batch, int h, int w,
                                 int k, int bg, int* scratch, float* out,
                                 void* stream) {
  if (batch <= 0 || k <= 0) return 0;
  const int hw = h * w;
  const bool vec = hw % 4 == 0 && (((uintptr_t)labels | (uintptr_t)prob) & 15u) == 0;
  const cudaError_t e =
      vec ? launch<true>(labels, prob, roots, batch, hw, w, k, bg, scratch, out,
                         (cudaStream_t)stream)
          : launch<false>(labels, prob, roots, batch, hw, w, k, bg, scratch, out,
                          (cudaStream_t)stream);
  return (int)e;
}
