// The XOR + __popc Hamming kernel that the int8 tensor-core kernel
// (qsp_slam_tpu_torch/csrc/hamming.cu) replaced, kept for one measurement:
// how far population counts alone bound it.  `store_only_if` predicates the
// store: INT_MIN stores every distance (the kernel as it was); -1, which no
// distance equals but the compiler cannot know, keeps every load and
// population count and stores nothing.  Built and timed by
// tools/k2_popc_roof.py.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTa = 64;       // A rows per block
constexpr int kTb = 128;      // B rows (output columns) per block
constexpr int kWarps = 8;     // blockDim = (32, kWarps)
constexpr int kCols = kTb / 32;

__global__ void __launch_bounds__(32 * kWarps)
hamming_popc_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                    int32_t* __restrict__ out, int A, int B, int store_only_if) {
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
        if (store_only_if == INT_MIN || s == store_only_if) out[(size_t)row * B + col] = s;
      }
    }
  }
}

}  // namespace

extern "C" int qsp_hamming_popc(const void* a, const void* b, void* out, int A, int B,
                                int store_only_if, void* stream) {
  if (A == 0 || B == 0) return (int)cudaSuccess;
  const dim3 block(32, kWarps);
  const dim3 grid((B + kTb - 1) / kTb, (A + kTa - 1) / kTa);
  hamming_popc_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (int32_t*)out, A, B, store_only_if);
  return (int)cudaGetLastError();
}
