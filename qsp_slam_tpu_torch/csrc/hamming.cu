// Pairwise Hamming distances between packed 256-bit descriptors.
//
// Replaces the Pallas TPU kernel `hamming_matrix_packed`
// (qsp_slam_tpu/ops/hamming.py, body `_kernel`): XOR + popcount summed
// over the 8 32-bit words.  In: (A, 8) and (B, 8) words (int32 storage of
// the u32 bits).  Out: (A, B) int32, row-major.
//
// Bound on the card: memory, by the output.  At the tracking shape
// (8192 map points x 4000 features) the (A, B) int32 matrix is 131 MB,
// ~39 us at 3.35 TB/s; the ~0.8 G integer operations and the 0.4 MB of
// inputs are far below that.  Design: a block owns a 64 x 128 output tile;
// its 64 A rows sit in shared memory (one row is read by a whole warp at
// once, a broadcast); each thread keeps the 8 words of 4 B rows in
// registers and produces 32 outputs, and each warp writes 32 consecutive
// ints of one output row per store (coalesced 128 B).  Ragged edges are
// masked in the kernel; nothing is padded on the host.  Fusing the window
// mask and the best/second-best reduction, so the matrix is never stored,
// is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTa = 64;       // A rows per block
constexpr int kTb = 128;      // B rows (output columns) per block
constexpr int kWarps = 8;     // blockDim = (32, kWarps)
constexpr int kCols = kTb / 32;

__global__ void __launch_bounds__(32 * kWarps)
hamming_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               int32_t* __restrict__ out, int A, int B) {
  __shared__ uint32_t as[kTa][8];
  const int a0 = blockIdx.y * kTa;
  const int b0 = blockIdx.x * kTb;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 32 + tx;

  for (int i = tid; i < kTa * 8; i += 32 * kWarps) {
    const int r = a0 + i / 8;
    as[i / 8][i % 8] = r < A ? a[(size_t)r * 8 + i % 8] : 0u;
  }
  uint32_t bw[kCols][8];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int col = b0 + tx + 32 * j;
#pragma unroll
    for (int w = 0; w < 8; ++w) bw[j][w] = col < B ? b[(size_t)col * 8 + w] : 0u;
  }
  __syncthreads();

  for (int i = ty; i < kTa; i += kWarps) {
    const int row = a0 + i;
    if (row >= A) break;
    uint32_t aw[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) aw[w] = as[i][w];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = b0 + tx + 32 * j;
      if (col < B) {
        int s = 0;
#pragma unroll
        for (int w = 0; w < 8; ++w) s += __popc(aw[w] ^ bw[j][w]);
        out[(size_t)row * B + col] = s;
      }
    }
  }
}

}  // namespace

extern "C" int qsp_hamming_packed(const void* a, const void* b, void* out,
                                  int A, int B, void* stream) {
  if (A == 0 || B == 0) return (int)cudaSuccess;
  const dim3 block(32, kWarps);
  const dim3 grid((B + kTb - 1) / kTb, (A + kTa - 1) / kTa);
  hamming_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (int32_t*)out, A, B);
  return (int)cudaGetLastError();
}

extern "C" const char* qsp_hamming_packed_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
