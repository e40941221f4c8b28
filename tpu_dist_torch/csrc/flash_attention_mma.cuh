// bf16 tensor-core toolkit of the flash-attention kernels (forward, dK/dV
// and dQ): warp-level mma.sync.m16n8k16 with f32 accumulation, operands
// staged by cp.async and read into fragments by ldmatrix. Inline PTX only;
// no library code.
//
// Layout conventions (PTX ISA, "Matrix fragments for mma.m16n8k16"): in a
// warp, lane = 4 * g + t (g = lane / 4 in 0..7, t = lane % 4 in 0..3).
// - A, 16 x 16 row-major, four 32-bit registers of two bf16 each:
//   a[0] = (row g, cols 2t, 2t+1), a[1] = (row g+8, cols 2t, 2t+1),
//   a[2] = (row g, cols 2t+8, 2t+9), a[3] = (row g+8, cols 2t+8, 2t+9).
// - B, 16 x 8 (k x n), two registers: b[0] = (k 2t, 2t+1; n g),
//   b[1] = (k 2t+8, 2t+9; n g).
// - C/D, 16 x 8 f32, four registers: c[0], c[1] = (row g, cols 2t, 2t+1),
//   c[2], c[3] = (row g+8, cols 2t, 2t+1); see acc_row / acc_col.
// In each register the lower 16 bits hold the element of the smaller
// column (A) or k index (B).
//
// Shared-memory tiles are [rows][D + 8] bf16: the 16-byte pad shifts each
// row by four banks, so the eight 16-byte rows that one ldmatrix phase
// reads fall in 32 distinct banks (no conflicts), and every row start stays
// 16-byte aligned for cp.async.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace flash_mma {

// dtype codes of the C interfaces
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

// The route rule, one definition for every flash kernel's C dispatch (and
// mirrored by ops/flash_attention.py::uses_tensor_cores): bf16 inputs take
// the bf16 tensor-core kernels; f32 inputs keep f32-accurate kernels (the
// forward's 3xTF32 products, the backward's f32 CUDA cores), which the
// serving path and the f32 training parity hold to full-f32 results.
__host__ __device__ constexpr bool tensor_core_route(int in_dtype) {
  return in_dtype == DTYPE_BF16;
}

constexpr int BLOCK = 64;  // rows of a q tile and of a k tile
constexpr int WARPS = 4;   // each owns 16 rows of the CTA's tile
constexpr int THREADS = 32 * WARPS;
constexpr int ROW_PAD = 8;  // bf16 per row: 16 bytes
static_assert(BLOCK == 16 * WARPS, "one 16-row mma slab per warp");

template <int D>
__host__ __device__ constexpr int row_stride() {
  return D + ROW_PAD;
}

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- cp.async -----------------------------------------------------------------

// 16 bytes global -> shared, asynchronous; `valid` false copies no byte and
// zero-fills the destination (src-size 0). `src` must stay a mapped address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, for the f32 row statistics (a row of S floats is 16-byte aligned
// only when S is a multiple of 4).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + BLOCK) of one [S, D] bf16 slab into a padded shared
// tile, 16 bytes a thread at a time; rows at or past S are zero-filled (a
// zero row adds exactly 0 to every product). The caller commits.
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* __restrict__ src, int row0,
                                                int S) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < BLOCK * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * 8;
    const int gr = row0 + r;
    const bool valid = gr < S;
    cp_async16(dst + r * row_stride<D>() + c, src + (size_t)(valid ? gr : 0) * D + c, valid);
  }
}

// Rows [row0, row0 + BLOCK) of one [S] f32 statistic; zeros past S.
__device__ __forceinline__ void load_rows_async(float* dst, const float* __restrict__ src,
                                                int row0, int S) {
  for (int r = threadIdx.x; r < BLOCK; r += THREADS) {
    const int gr = row0 + r;
    const bool valid = gr < S;
    cp_async4(dst + r, src + (valid ? gr : 0), valid);
  }
}

// -- ldmatrix -----------------------------------------------------------------

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and register i receives matrix i in the mma fragment layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The same, each matrix transposed on the way: for a B operand whose k
// (reduction) index runs along the rows of the shared tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// A fragment of the 16 x 16 block at (row0, col0) of a row-major tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int row0, int col0,
                                       int lane) {
  ldmatrix_x4(a, tile + (row0 + (lane & 15)) * LD + col0 + (lane >> 4) * 8);
}

// B fragments of two neighbouring 8-column n tiles, n0 and n0 + 8, over the
// k chunk [k0, k0 + 16), from a tile stored [n][k] (each B column is a tile
// row: K for Q K^T). b[0..1] is n tile n0, b[2..3] n tile n0 + 8.
template <int LD>
__device__ __forceinline__ void load_b_pair(uint32_t (&b)[4], const bf16* tile, int n0, int k0,
                                            int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 + ((lane >> 3) & 1) * 8);
}

// The same from a tile stored [k][n] (V for P V), through ldmatrix.trans.
template <int LD>
__device__ __forceinline__ void load_b_pair_trans(uint32_t (&b)[4], const bf16* tile, int k0,
                                                  int n0, int lane) {
  ldmatrix_x4_trans(b,
                    tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 + (lane >> 4) * 8);
}

// -- mma ----------------------------------------------------------------------

// d += a b, 16 x 8 x 16, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[n tile n0], d[n tile n0 + 8] += a b for a B pair from load_b_pair*.
__device__ __forceinline__ void mma_bf16_pair(float (&d0)[4], float (&d1)[4],
                                              const uint32_t (&a)[4], const uint32_t (&b)[4]) {
  mma_bf16(d0, a, b[0], b[1]);
  mma_bf16(d1, a, b[2], b[3]);
}

// -- fragments ----------------------------------------------------------------

// Row and column within a 16 x 8 accumulator of this lane's element i.
__device__ __forceinline__ int acc_row(int lane, int i) { return (lane >> 2) + (i >> 1) * 8; }
__device__ __forceinline__ int acc_col(int lane, int i) { return (lane & 3) * 2 + (i & 1); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// The bf16 A fragment of a 16 x 16 k chunk from the f32 accumulators of
// the two 16 x 8 tiles that hold its columns [0, 8) (lo) and [8, 16) (hi),
// in registers only (FlashAttention-2's hand-off: an accumulator's element
// sits where the next product's A operand wants it, so P never touches
// shared memory). Rounds to nearest even.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

}  // namespace flash_mma
