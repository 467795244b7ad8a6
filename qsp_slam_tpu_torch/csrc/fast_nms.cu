// FAST-9/16 corner score + 3x3 non-max suppression over a whole image
// pyramid at one or two thresholds, in one launch.
//
// Replaces the Pallas TPU kernel `fast_score_nms_pallas`
// (qsp_slam_tpu/ops/fast_pallas.py, body `_band_kernel`).  Same function,
// per (level, threshold): per pixel the 16 ring comparisons pack into two
// 16-bit masks (bright, dark); a contiguous arc of >= 9 is found by
// rotate-AND; the score is max(sum bright (|d| - t), sum dark (|d| - t))
// summed in ring order k = 0..15, zero where the arc test fails and within
// 3 px of the level's border; NMS keeps score >= max of its 8 neighbours.
// Every sum is the plain version's, term for term and in the same order,
// so the maps are bitwise equal to it.
//
// Bound on the card.  A 640x480 pyramid of 8 levels holds 950,532 pixels:
// 4 B read and 2 x 4 B written per pixel (11.4 MB, ~3.4 us at 3.35 TB/s)
// against ~140 operations per (pixel, threshold) (~4.0 us at 67 TFLOP/s).
// As written for exactness the work is ~15 instructions per ring pixel
// for both thresholds (a difference, two |d| - t, four compares, four
// predicated adds into the sums and four into the masks): ~12 M warp
// instructions a frame, ~12 us of issue on 132 SMs, so instructions and
// not memory set the floor.  One launch per level and threshold (16 a
// frame) cost ~5 us each, mostly fixed launch and ramp time on levels as
// small as 6x17 tiles, and read every pixel twice.
//
// Design:
//  - One 1-D grid over the 32x16 tiles of every level (~2 k blocks for the
//    pyramid above); a block finds its level by scanning the levels'
//    first-tile prefix sums, which stay in the kernel's parameter space
//    (`__grid_constant__`, no copy).  The levels remain separate tensors:
//    the launch carries their pointers, nothing is concatenated.
//  - Each block stages its tile plus a 4-pixel halo (3 for the ring, 1 for
//    NMS) in shared memory once, zero outside the level.
//  - Scores cover the tile plus a 1-pixel ring (34x18 positions) in 20
//    warp tasks, one per warp: 18 rows of 32 positions, whose ring reads
//    are 32 consecutive words (no bank conflicts), and the two side
//    columns.  Each position reads its 16 ring values once and forms both
//    thresholds' masks and sums from them, with the ring offsets folded
//    into the loads as constants.
//  - NMS of both maps reads the score tiles in shared memory; neighbouring
//    threads store neighbouring pixels.

#include <cuda_runtime.h>

constexpr int kMaxLevels = 16;

struct Level {
  const float* img;
  float* out[2];  // one NMS'd map per threshold
  int H, W;
  int first_tile;  // prefix sum of the earlier levels' tile counts
};

struct Pyramid {
  Level lv[kMaxLevels];
  float t[2];
  int n_levels;
  int n_thresholds;
  int n_tiles;
};

namespace {

// A tile is kTx x kTy output pixels; ops/fast_nms.py numbers the tiles with
// the same sizes.
constexpr int kTx = 32;
constexpr int kTy = 16;
constexpr int kHalo = 4;
constexpr int kSw = kTx + 2 * kHalo;  // staged image tile
constexpr int kSh = kTy + 2 * kHalo;
constexpr int kCw = kTx + 2;  // score tile: output + 1-px ring
constexpr int kCh = kTy + 2;
constexpr int kTasks = kCh + (2 * kCh + 31) / 32;  // score rows + side columns
constexpr int kThreads = 32 * kTasks;

// The FAST-16 ring (dy, dx).
__host__ __device__ constexpr int ring_dy(int k) {
  constexpr int d[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  return d[k];
}
__host__ __device__ constexpr int ring_dx(int k) {
  constexpr int d[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  return d[k];
}

// Cyclic run of >= 9 set bits in a 16-bit ring mask.  With the mask
// repeated in both halves of a word, rotating is shifting: AND with
// shifts 1, 2, 4 leaves runs >= 8, the original shifted by 8 adds the
// ninth bit.
__device__ __forceinline__ bool arc9(unsigned m) {
  const unsigned x = m * 0x10001u;
  unsigned r = x & (x >> 1);
  r &= r >> 2;
  r &= r >> 4;
  r &= x >> 8;
  return (r & 0xFFFFu) != 0u;
}

// One ring value r at one threshold: where r > hi add diff to sb and set
// `bit` in bm; where r < lo the same for sd and dm.  Predicated adds, one
// instruction each where a select and an add would be two; `add.rn` keeps
// the compiler from contracting anything into the sums.
__device__ __forceinline__ void ring_step(float r, float hi, float lo, float diff, unsigned bit,
                                          float& sb, float& sd, unsigned& bm, unsigned& dm) {
  asm("{\n\t.reg .pred pb, pd;\n\t"
      "setp.gt.f32 pb, %4, %5;\n\t"
      "setp.lt.f32 pd, %4, %6;\n\t"
      "@pb add.rn.f32 %0, %0, %7;\n\t"
      "@pd add.rn.f32 %1, %1, %7;\n\t"
      "@pb or.b32 %2, %2, %8;\n\t"
      "@pd or.b32 %3, %3, %8;\n\t}"
      : "+f"(sb), "+f"(sd), "+r"(bm), "+r"(dm)
      : "f"(r), "f"(hi), "f"(lo), "f"(diff), "r"(bit));
}

// Scores of position (cy, cx) of the score tile, global (gy, gx), at every
// threshold, into score[j][cy][cx].
template <int NT>
__device__ __forceinline__ void score_at(const float (*tile)[kSw], float (*score)[kCh][kCw],
                                         const float* t, int cy, int cx, int gy, int gx,
                                         int H, int W) {
  float s[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j] = 0.f;
  if (gy >= 3 && gy < H - 3 && gx >= 3 && gx < W - 3) {
    const float* ctr = &tile[cy + kHalo - 1][cx + kHalo - 1];
    const float c = *ctr;
    float hi[NT], lo[NT], sb[NT], sd[NT];
    unsigned bm[NT], dm[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      hi[j] = c + t[j];
      lo[j] = c - t[j];
      sb[j] = sd[j] = 0.f;
      bm[j] = dm[j] = 0u;
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float r = ctr[ring_dy(k) * kSw + ring_dx(k)];
      const float ad = fabsf(r - c);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        ring_step(r, hi[j], lo[j], ad - t[j], 1u << k, sb[j], sd[j], bm[j], dm[j]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (arc9(bm[j]) || arc9(dm[j])) s[j] = fmaxf(sb[j], sd[j]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) score[j][cy][cx] = s[j];
}

template <int NT>
__global__ void __launch_bounds__(kThreads)
fast_score_nms_pyramid_kernel(const __grid_constant__ Pyramid p) {
  __shared__ float tile[kSh][kSw];
  __shared__ float score[NT][kCh][kCw];

  int l = 0;
  while (l + 1 < p.n_levels && (int)blockIdx.x >= p.lv[l + 1].first_tile) ++l;
  const Level& L = p.lv[l];
  const int H = L.H, W = L.W;
  const int tiles_x = (W + kTx - 1) / kTx;
  const int local = blockIdx.x - L.first_tile;
  const int x0 = (local % tiles_x) * kTx;
  const int y0 = (local / tiles_x) * kTy;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float t[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) t[j] = p.t[j];

  for (int i = tid; i < kSh * kSw; i += kThreads) {
    const int gy = y0 - kHalo + i / kSw;
    const int gx = x0 - kHalo + i % kSw;
    tile[i / kSw][i % kSw] =
        (gy >= 0 && gy < H && gx >= 0 && gx < W) ? L.img[(size_t)gy * W + gx] : 0.f;
  }
  __syncthreads();

  if (warp < kCh) {
    score_at<NT>(tile, score, t, warp, lane + 1, y0 - 1 + warp, x0 + lane, H, W);
  } else {
    const int i = (warp - kCh) * 32 + lane;  // side columns: cx = 0, then cx = kCw - 1
    if (i < 2 * kCh) {
      const int cy = i % kCh, cx = i < kCh ? 0 : kCw - 1;
      score_at<NT>(tile, score, t, cy, cx, y0 - 1 + cy, x0 - 1 + cx, H, W);
    }
  }
  __syncthreads();

  if (tid < kTx * kTy) {
    const int r = tid / kTx, c = tid % kTx;
    const int gx = x0 + c, gy = y0 + r;
    if (gx < W && gy < H) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float s = score[j][r + 1][c + 1];
        float m = s;
#pragma unroll
        for (int dy = 0; dy <= 2; ++dy)
#pragma unroll
          for (int dx = 0; dx <= 2; ++dx) m = fmaxf(m, score[j][r + dy][c + dx]);
        L.out[j][(size_t)gy * W + gx] = (s >= m) ? s : 0.f;
      }
    }
  }
}

}  // namespace

// `p` arrives by value; the caller fills every level's pointers, shape and
// first tile (tiles of kTx x kTy, numbered level by level), the thresholds
// and their count (1 or 2) and the tile total.
extern "C" int qsp_fast_score_nms_pyramid(Pyramid p, void* stream) {
  if (p.n_levels < 1 || p.n_levels > kMaxLevels || p.n_thresholds < 1 ||
      p.n_thresholds > 2)
    return (int)cudaErrorInvalidValue;
  if (p.n_tiles == 0) return (int)cudaSuccess;
  const dim3 grid(p.n_tiles), block(kThreads);
  if (p.n_thresholds == 2)
    fast_score_nms_pyramid_kernel<2><<<grid, block, 0, (cudaStream_t)stream>>>(p);
  else
    fast_score_nms_pyramid_kernel<1><<<grid, block, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* qsp_fast_score_nms_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
