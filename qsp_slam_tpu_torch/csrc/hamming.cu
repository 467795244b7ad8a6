// Pairwise Hamming distances between packed 256-bit descriptors, on the
// int8 tensor cores.
//
// Replaces the Pallas TPU kernel `hamming_matrix_packed`
// (qsp_slam_tpu/ops/hamming.py, body `_kernel`): XOR + popcount summed
// over the 8 32-bit words.  In: (A, 8) and (B, 8) words (int32 storage of
// the u32 bits, bit j of word w = descriptor bit 32w + j).  Out: (A, B)
// int32, row-major.  Here the same distances come as the JAX package's
// matcher computes them (qsp_slam_tpu/frontend/matcher.py): with every bit
// as a +-1 int8 (1 -> +1, 0 -> -1), <a, b> = 256 - 2 hamming(a, b), so
// hamming = (256 - <a, b>) >> 1, exact because 256 - <a, b> is even.
//
// Bound on the card: memory, by the output.  At the tracking shape
// (8192 map points x 4000 features) the (A, B) int32 matrix is 131 MB,
// ~39 us at 3.35 TB/s.  The product is 16.8 G int8 operations, ~8.5 us at
// 1,979 TOP/s; as XOR + `__popc` it was 262 M population counts, which
// the card issues at 16 per clock per SM, ~65 us on their own.
//
// Design: a block owns a 128 x 128 output tile, 8 warps of 64 x 32.
//  - Expand.  The tile's packed rows (4 KB per side) load as 16-byte words
//    and every 4-bit nibble becomes four +-1 bytes in registers (a multiply
//    spreads the bits to bytes, a multiply-add maps 0/1 to -1/+1), written
//    to shared memory as 16-byte stores: 128 rows x 256 B per side, rows
//    padded to 272 B so that `ldmatrix` and the stores hit every bank once.
//  - Product.  `ldmatrix.x4` loads the fragments; `mma.sync` m16n8k32
//    s8 x s8 -> s32 runs 8 k-steps of 32 (one packed word each).  A is
//    row-major and B is stored n-major with K contiguous, the `col` layout
//    that the instruction takes.
//  - Epilogue.  (256 - dot) >> 1 goes into an int32 tile in shared memory
//    that reuses the operand space (rows padded to 136 words, so the
//    fragments' 8-byte stores do not conflict); then each warp writes whole
//    output rows with 16-byte streaming stores, neighbouring threads on
//    neighbouring addresses.  Where B % 4 != 0 rows do not start 16-byte
//    aligned and the same rows go out as 4-byte stores.  Ragged edges are
//    masked in the kernel; nothing is padded on the host.
//  - 69,632 B of dynamic shared memory a block, so two blocks share an SM
//    and one block's stores overlap the other's product.
// Fusing the window mask and the best/second-best reduction, so the matrix
// is never stored, is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;          // output tile: kTile A rows x kTile B rows
constexpr int kThreads = 256;       // 8 warps: 2 along A x 4 along B
constexpr int kWarpM = 64;          // A rows per warp
constexpr int kWarpN = 32;          // B rows (output columns) per warp
constexpr int kMT = kWarpM / 16;    // m16 tiles per warp
constexpr int kNT = kWarpN / 8;     // n8 tiles per warp
constexpr int kPitch = 256 + 16;    // bytes per expanded row
constexpr int kOutPitch = kTile + 8;  // int32 words per staged output row
constexpr int kSmem = 2 * kTile * kPitch;
static_assert(kTile * kOutPitch * 4 <= kSmem, "output tile must fit the operand space");

// Four bits -> four bytes, bit i to byte i, each -1 (bit 0) or +1 (bit 1).
__device__ __forceinline__ uint32_t expand_nibble(uint32_t x) {
  const uint32_t b = (x * 0x00204081u) & 0x01010101u;  // disjoint shifted copies
  return 0xFFFFFFFFu - b * 0xFEu;                       // per byte: 0xFF or 0x01
}

// Expands 4 packed words (128 bits) into 128 +-1 bytes at `dst`.
__device__ __forceinline__ void expand_words(uint4 w, int8_t* dst) {
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t v = ws[q] >> (16 * h);
      uint4 e;
      e.x = expand_nibble(v & 0xFu);
      e.y = expand_nibble((v >> 4) & 0xFu);
      e.z = expand_nibble((v >> 8) & 0xFu);
      e.w = expand_nibble((v >> 12) & 0xFu);
      *reinterpret_cast<uint4*>(dst + 32 * q + 16 * h) = e;
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
hamming_mma_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                   int32_t* __restrict__ out, int A, int B) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* as = smem;                  // [kTile][kPitch] +-1 bytes of A rows
  int8_t* bs = smem + kTile * kPitch;  // [kTile][kPitch] +-1 bytes of B rows
  int32_t* cs = reinterpret_cast<int32_t*>(smem);  // [kTile][kOutPitch], after the product

  const int a0 = blockIdx.y * kTile;
  const int b0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // Expand: thread t takes half h of row r, so the 8 threads of a store
  // phase write 8 consecutive rows (4 banks apart).
  {
    const int r = tid % kTile, h = tid / kTile;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const uint4 wa = a0 + r < A ? a[(size_t)(a0 + r) * 2 + h] : zero;
    const uint4 wb = b0 + r < B ? b[(size_t)(b0 + r) * 2 + h] : zero;
    expand_words(wa, as + r * kPitch + 128 * h);
    expand_words(wb, bs + r * kPitch + 128 * h);
  }
  __syncthreads();

  // Product: warp (wm, wn) owns rows wm*64.. and columns wn*32.. of the tile.
  const int wm = warp / (kTile / kWarpN), wn = warp % (kTile / kWarpN);
  int32_t acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  // ldmatrix row addresses.  A (16 x 32 bytes): matrices (rows 0-7, k 0-15),
  // (rows 8-15, k 0-15), (rows 0-7, k 16-31), (rows 8-15, k 16-31) are the
  // fragment's a0..a3.  B (two n8 tiles x 32 bytes): (n 0-7, k 0-15),
  // (n 0-7, k 16-31), (n 8-15, k 0-15), (n 8-15, k 16-31) are b0, b1 of
  // the first tile and b0, b1 of the second.
  const int8_t* a_ld = as + (wm * kWarpM + (lane & 15)) * kPitch + (lane >> 4) * 16;
  const int8_t* b_ld = bs + (wn * kWarpN + (lane & 7) + (lane >> 4) * 8) * kPitch +
                       ((lane >> 3) & 1) * 16;
#pragma unroll 2
  for (int ks = 0; ks < 8; ++ks) {
    uint32_t bf[kNT / 2][4];
#pragma unroll
    for (int j = 0; j < kNT / 2; ++j) ldmatrix_x4(bf[j], b_ld + j * 16 * kPitch + ks * 32);
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      uint32_t af[4];
      ldmatrix_x4(af, a_ld + i * 16 * kPitch + ks * 32);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        mma_s8(acc[i][j], af, bf[j / 2][2 * (j & 1)], bf[j / 2][2 * (j & 1) + 1]);
    }
  }
  __syncthreads();  // every warp is done reading the operands

  // Epilogue into shared memory.  Fragment c0, c1: row g, columns 2q, 2q+1;
  // c2, c3: row g + 8.
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int row = wm * kWarpM + i * 16 + g;
      const int col = wn * kWarpN + j * 8 + 2 * q;
      *reinterpret_cast<int2*>(cs + row * kOutPitch + col) =
          make_int2((256 - acc[i][j][0]) >> 1, (256 - acc[i][j][1]) >> 1);
      *reinterpret_cast<int2*>(cs + (row + 8) * kOutPitch + col) =
          make_int2((256 - acc[i][j][2]) >> 1, (256 - acc[i][j][3]) >> 1);
    }
  __syncthreads();

  // Store: warp w writes rows w, w + 8, ...; one row is 512 B.
  const int rows = min(kTile, A - a0), cols = min(kTile, B - b0);
  for (int r = warp; r < rows; r += kThreads / 32) {
    const int32_t* src = cs + r * kOutPitch;
    int32_t* dst = out + (size_t)(a0 + r) * B + b0;
    if (kVec) {
      const int c = 4 * lane;  // cols % 4 == 0 when B % 4 == 0
      if (c < cols)
        __stcs(reinterpret_cast<int4*>(dst + c), *reinterpret_cast<const int4*>(src + c));
    } else {
#pragma unroll
      for (int c = lane; c < kTile; c += 32)
        if (c < cols) __stcs(dst + c, src[c]);
    }
  }
}

}  // namespace

extern "C" int qsp_hamming_packed(const void* a, const void* b, void* out,
                                  int A, int B, void* stream) {
  if (A == 0 || B == 0) return (int)cudaSuccess;
  const dim3 block(kThreads);
  const dim3 grid((B + kTile - 1) / kTile, (A + kTile - 1) / kTile);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (B % 4 == 0) {
    err = cudaFuncSetAttribute(hamming_mma_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    hamming_mma_kernel<true><<<grid, block, kSmem, (cudaStream_t)stream>>>(
        (const uint4*)a, (const uint4*)b, (int32_t*)out, A, B);
  } else {
    err = cudaFuncSetAttribute(hamming_mma_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    hamming_mma_kernel<false><<<grid, block, kSmem, (cudaStream_t)stream>>>(
        (const uint4*)a, (const uint4*)b, (int32_t*)out, A, B);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* qsp_hamming_packed_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
