// FAST-9/16 corner score + 3x3 non-max suppression for one (H, W) f32 image.
//
// Replaces the Pallas TPU kernel `fast_score_nms_pallas`
// (qsp_slam_tpu/ops/fast_pallas.py, body `_band_kernel`).  Same function:
// per pixel the 16 ring comparisons pack into two 16-bit masks (bright,
// dark); a contiguous arc of >= 9 is found by rotate-AND; the score is
// max(sum bright (|d| - t), sum dark (|d| - t)) summed in ring order
// k = 0..15, zero where the arc test fails and within 3 px of the image
// border; NMS keeps score >= max of its 8 neighbours.
//
// Bound on the card: memory.  Each pixel is read once and written once
// (8 B/px) against ~140 integer/float operations, far below the ratio at
// which the ALUs would limit it; at the pyramid's sizes (480x640 down to
// 134x179) a launch is a few microseconds and its fixed cost dominates.
// Design: one thread per output pixel in 32x8 tiles.  The tile plus a
// 4-pixel halo (3 for the ring, 1 for NMS) is staged once in shared
// memory, zero outside the image; the scores of the tile plus a 1-pixel
// ring go to shared memory, so NMS reads neighbours' scores instead of
// recomputing them.  The TPU version's 120-row bands and manual DMA have
// no counterpart: blocks tile the whole image and run in parallel.

#include <cuda_runtime.h>

namespace {

constexpr int kTx = 32;
constexpr int kTy = 8;
constexpr int kHalo = 4;
constexpr int kSw = kTx + 2 * kHalo;  // staged image tile width
constexpr int kSh = kTy + 2 * kHalo;
constexpr int kCw = kTx + 2;          // score tile (output + 1-px ring)
constexpr int kCh = kTy + 2;

__constant__ int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ unsigned rot16(unsigned m, int r) {
  return ((m >> r) | (m << (16 - r))) & 0xFFFFu;
}

__device__ __forceinline__ bool arc9(unsigned m) {
  unsigned r = m & rot16(m, 1);
  r &= rot16(r, 2);
  r &= rot16(r, 4);
  r &= rot16(m, 8);
  return r != 0u;
}

__global__ void __launch_bounds__(kTx * kTy)
fast_score_nms_kernel(const float* __restrict__ img, float* __restrict__ out,
                      int H, int W, float t) {
  __shared__ float tile[kSh][kSw];
  __shared__ float score[kCh][kCw];
  const int x0 = blockIdx.x * kTx;
  const int y0 = blockIdx.y * kTy;
  const int tid = threadIdx.y * kTx + threadIdx.x;

  for (int i = tid; i < kSh * kSw; i += kTx * kTy) {
    const int gy = y0 - kHalo + i / kSw;
    const int gx = x0 - kHalo + i % kSw;
    tile[i / kSw][i % kSw] =
        (gy >= 0 && gy < H && gx >= 0 && gx < W) ? img[(size_t)gy * W + gx] : 0.f;
  }
  __syncthreads();

  for (int i = tid; i < kCh * kCw; i += kTx * kTy) {
    const int cy = i / kCw, cx = i % kCw;
    const int gy = y0 - 1 + cy, gx = x0 - 1 + cx;
    float s = 0.f;
    if (gy >= 3 && gy < H - 3 && gx >= 3 && gx < W - 3) {
      const int sy = cy + kHalo - 1, sx = cx + kHalo - 1;
      const float c = tile[sy][sx];
      const float hi = c + t, lo = c - t;
      unsigned bm = 0u, dm = 0u;
      float sb = 0.f, sd = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float r = tile[sy + kDy[k]][sx + kDx[k]];
        const bool b = r > hi;
        const bool d = r < lo;
        const float diff = fabsf(r - c) - t;
        bm |= (unsigned)b << k;
        dm |= (unsigned)d << k;
        sb = sb + (b ? diff : 0.f);
        sd = sd + (d ? diff : 0.f);
      }
      if (arc9(bm) || arc9(dm)) s = fmaxf(sb, sd);
    }
    score[cy][cx] = s;
  }
  __syncthreads();

  const int gx = x0 + threadIdx.x, gy = y0 + threadIdx.y;
  if (gx < W && gy < H) {
    const int cy = threadIdx.y + 1, cx = threadIdx.x + 1;
    const float s = score[cy][cx];
    float m = s;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) m = fmaxf(m, score[cy + dy][cx + dx]);
    out[(size_t)gy * W + gx] = (s >= m) ? s : 0.f;
  }
}

}  // namespace

extern "C" int qsp_fast_score_nms(const void* img, void* out, int H, int W,
                                  float threshold, void* stream) {
  const dim3 block(kTx, kTy);
  const dim3 grid((W + kTx - 1) / kTx, (H + kTy - 1) / kTy);
  fast_score_nms_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)img, (float*)out, H, W, threshold);
  return (int)cudaGetLastError();
}

extern "C" const char* qsp_fast_score_nms_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
