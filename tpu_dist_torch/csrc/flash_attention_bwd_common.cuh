// Shared block math of the flash-attention backward kernels
// (flash_attention_bwd_dkdv.cu and flash_attention_bwd_dq.cu).
//
// Counterpart of tpu_dist/ops/flash_attention.py::_recompute_p_ds: one
// definition of the mask, the max(l, 1e-30) clamp and the probability /
// score-gradient recompute, so the dK/dV and the dQ passes, on either
// route, never desync. Every kernel uses 64-row tiles of q and of k. The
// f32 CUDA-core kernels (dkdv_kernel, dq_kernel) run 256 threads, four per
// tile row, with operands staged in shared memory as f32; the tensor-core
// kernels take their geometry from flash_attention_mma.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <type_traits>

namespace flash_bwd {

constexpr int BLOCK = 64;  // rows of a q tile and of a k tile
constexpr int THREADS_PER_ROW = 4;
constexpr int THREADS = BLOCK * THREADS_PER_ROW;          // 256
constexpr int COLS_PER_THREAD = BLOCK / THREADS_PER_ROW;  // 16 scores per thread
// Row pad of the staged tiles and strips: with a stride of D + 4 (or 68)
// the 8 rows and 4 column groups a warp touches at once fall in distinct
// banks, and rows stay 16-byte aligned.
constexpr int PAD = 4;
constexpr int STRIP = BLOCK + PAD;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Rows [row0, row0 + 64) of one [S, D] slab into shared memory as f32
// (row stride D + PAD); rows at or past S as zeros, so a masked row adds
// exactly 0 and never NaN.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                                          int S) {
  for (int idx = threadIdx.x; idx < BLOCK * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx % D;
    const int gr = row0 + r;
    dst[r * (D + PAD) + c] = gr < S ? to_float(src[(size_t)gr * D + c]) : 0.f;
  }
}

// Rows [row0, row0 + 64) of one [S] f32 row statistic; zeros past S (the
// JAX code pads m, l and delta with zeros and masks those rows by
// position: they are never read from beyond S).
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int row0,
                                          int S) {
  for (int r = threadIdx.x; r < BLOCK; r += THREADS) {
    const int gr = row0 + r;
    dst[r] = gr < S ? src[gr] : 0.f;
  }
}

// Whether score (q_pos, k_pos) is visible: both inside S, and on or below
// the diagonal when causal. Padded q rows are masked explicitly.
__device__ __forceinline__ bool live(int q_pos, int k_pos, int S, int causal) {
  return q_pos < S && k_pos < S && (!causal || q_pos >= k_pos);
}

// One score's probability and score gradient from the saved statistics:
// p = exp(qk * scale - m) / max(l, 1e-30), exactly 0 where masked;
// ds = p * (dp - delta) * scale, with dp = do . v.
__device__ __forceinline__ void p_ds(float qk, float dp, float m, float l, float delta,
                                     float scale, bool visible, float& p, float& ds) {
  p = visible ? expf(qk * scale - m) / fmaxf(l, 1e-30f) : 0.f;
  ds = visible ? p * (dp - delta) * scale : 0.f;
}

// False iff the (q tile, k tile) pair lies wholly above the causal
// diagonal (largest q_pos below the smallest k_pos): every score in it is
// masked and it adds nothing, so a causal pass skips it
// (tpu_dist/ops/flash_attention.py::_causal_block_live).
__device__ __forceinline__ bool causal_tile_live(int qt, int kt) {
  return (qt + 1) * BLOCK - 1 >= kt * BLOCK;
}

// Shared memory of one [BLOCK, D] operand tile, padded.
template <int D>
__host__ __device__ constexpr size_t tile_floats() {
  return (size_t)BLOCK * (D + PAD);
}

// Runtime output dtype code (0 = float32, 1 = bfloat16) and head dim to one
// template instance of input type TI: calls f(tag<TI>, tag<TO>,
// integral_constant<D>).
template <typename T>
struct tag {
  using type = T;
};

template <typename TI, typename TO, typename F>
cudaError_t dispatch_d(int D, F& f) {
  switch (D) {
    case 16: return f(tag<TI>{}, tag<TO>{}, std::integral_constant<int, 16>{});
    case 32: return f(tag<TI>{}, tag<TO>{}, std::integral_constant<int, 32>{});
    case 64: return f(tag<TI>{}, tag<TO>{}, std::integral_constant<int, 64>{});
    case 128: return f(tag<TI>{}, tag<TO>{}, std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename TI, typename F>
cudaError_t dispatch_out(int out_dtype, int D, F& f) {
  if (out_dtype == 0) return dispatch_d<TI, float>(D, f);
  if (out_dtype == 1) return dispatch_d<TI, __nv_bfloat16>(D, f);
  return cudaErrorInvalidValue;
}

}  // namespace flash_bwd
