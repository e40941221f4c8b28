// Flash-attention forward for Hopper (sm_90a), f32 accumulation.
//
// Replaces: tpu_dist/ops/flash_attention.py::_fwd_kernel, the Pallas TPU
// kernel launched by the pl.pallas_call in _fwd. Same contract: q, k, v
// [BH, S, D] (f32 or bf16) -> out [BH, S, D] (f32 or bf16), and the row
// statistics m [BH, S] (max of the scaled, masked scores) and l [BH, S]
// (sum of exp(s - m)), both f32; out = acc / max(l, 1e-30); scale 1/sqrt(D);
// key padding masked, causal mask q_pos >= k_pos, the -1e30 fill and the
// exact zeros of masked probabilities kept, so a wholly masked tile leaves
// m, l and acc as they were.
//
// What bounds it on this card: at the ViT-B/16 serving shape (BH = 8 * 12,
// S = 196, D = 64, f32) a call must move ~19 MB (q, k, v read once, out,
// m, l written once): 5.8 us at 3.35 TB/s. Its two products are ~0.94
// GFLOP, 14 us at the 67 TFLOP/s f32 rate of the CUDA cores. So arithmetic
// binds, not bytes; and above all the [S, S] score matrix must never go
// to device memory, which would multiply the bytes.
//
// What the design does about it: one CTA per (64-row q tile, bh); every
// such tile runs in parallel (BH * ceil(S / 64) CTAs, 384 at the ViT
// shape, about one wave on 132 SMs at three CTAs per SM). The TPU's
// sequential k grid dimension becomes a loop inside the CTA over 64-row
// K/V tiles staged in shared memory, converted to f32 on load. Four
// threads own one q row: each computes 16 of the tile's 64 scores in
// registers, the row max and sum go across the four lanes by warp
// shuffles, and each thread keeps a quarter of the row's f32 accumulator
// in registers; the probabilities pass through a per-row strip of shared
// memory. The ragged last tile (196 = 3 * 64 + 4) is masked by position
// and zero-filled on load; causal tiles wholly above the diagonal are not
// visited. The products run on the f32 CUDA cores; bf16 tensor-core
// products (mma.sync, then wgmma fed by TMA) are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int THREADS_PER_ROW = 4;
constexpr int THREADS = BLOCK_Q * THREADS_PER_ROW;          // 256
constexpr int KEYS_PER_THREAD = BLOCK_K / THREADS_PER_ROW;  // 16
// Row pad of the Q/K tiles and the probability strip: with a stride of
// D + 4 (or 68) the 8 rows and 4 column groups a warp touches at once
// fall in distinct banks.
constexpr int PAD = 4;
constexpr int P_STRIDE = BLOCK_K + PAD;
constexpr float NEG_INF = -1e30f;  // the TPU kernel's fill: keeps exp() NaN-free
static_assert(BLOCK_Q == BLOCK_K, "load_tile stages Q, K and V tiles of one height");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BLOCK_Q * (D + PAD) + BLOCK_K * (D + PAD) + BLOCK_K * D + BLOCK_Q * P_STRIDE);
}

// Rows [row0, row0 + 64) of one [S, D] slab into shared memory as f32,
// rows at or past S as zeros (a masked probability is exactly 0, and 0
// times a zero-filled V row stays 0, never NaN).
template <typename T, int D, int STRIDE>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                                          int S) {
  for (int idx = threadIdx.x; idx < BLOCK_K * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx % D;
    const int gr = row0 + r;
    dst[r * STRIDE + c] = gr < S ? to_float(src[(size_t)gr * D + c]) : 0.f;
  }
}

template <typename TI, typename TO, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const TI* __restrict__ q, const TI* __restrict__ k,
                     const TI* __restrict__ v, TO* __restrict__ out, float* __restrict__ m_out,
                     float* __restrict__ l_out, int S, float scale, int causal) {
  constexpr int COLS = D / THREADS_PER_ROW;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                      // [BLOCK_Q][D + PAD]
  float* Ks = Qs + BLOCK_Q * (D + PAD);  // [BLOCK_K][D + PAD]
  float* Vs = Ks + BLOCK_K * (D + PAD);  // [BLOCK_K][D]
  float* Ps = Vs + BLOCK_K * D;          // [BLOCK_Q][P_STRIDE]

  const int bh = blockIdx.x;
  const int qt = blockIdx.y;
  const size_t base = (size_t)bh * S * D;
  const int row = threadIdx.x / THREADS_PER_ROW;
  const int part = threadIdx.x % THREADS_PER_ROW;
  const int q_pos = qt * BLOCK_Q + row;

  load_tile<TI, D, D + PAD>(Qs, q + base, qt * BLOCK_Q, S);

  float m_i = NEG_INF;
  float l_i = 0.f;
  float acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.f;

  int n_k = (S + BLOCK_K - 1) / BLOCK_K;
  if (causal) {
    // tiles wholly above the diagonal (max q_pos < min k_pos) are all
    // masked: they would leave m, l and acc unchanged, so skip them
    n_k = min(n_k, ((qt + 1) * BLOCK_Q - 1) / BLOCK_K + 1);
  }
  const float* qrow = Qs + row * (D + PAD);
  float* prow = Ps + row * P_STRIDE;

  for (int kt = 0; kt < n_k; ++kt) {
    __syncthreads();  // the previous tile's K, V and P reads are done
    load_tile<TI, D, D + PAD>(Ks, k + base, kt * BLOCK_K, S);
    load_tile<TI, D, D>(Vs, v + base, kt * BLOCK_K, S);
    __syncthreads();

    // scores of this thread's keys: j = part + 4 * jj
    float s[KEYS_PER_THREAD];
#pragma unroll
    for (int jj = 0; jj < KEYS_PER_THREAD; ++jj) s[jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int jj = 0; jj < KEYS_PER_THREAD; ++jj)
        s[jj] += qd * Ks[(part + THREADS_PER_ROW * jj) * (D + PAD) + d];
    }

    unsigned live = 0;  // bit jj: key j is visible from this row
    float tile_max = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < KEYS_PER_THREAD; ++jj) {
      const int k_pos = kt * BLOCK_K + part + THREADS_PER_ROW * jj;
      const bool ok = k_pos < S && (!causal || q_pos >= k_pos);
      live |= (ok ? 1u : 0u) << jj;
      s[jj] = ok ? s[jj] * scale : NEG_INF;
      tile_max = fmaxf(tile_max, s[jj]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m_i, tile_max);
    const float corr = expf(m_i - m_new);

    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < KEYS_PER_THREAD; ++jj) {
      const float p = (live >> jj) & 1u ? expf(s[jj] - m_new) : 0.f;  // exact zeros
      prow[part + THREADS_PER_ROW * jj] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_i = l_i * corr + psum;
    m_i = m_new;
    __syncwarp();  // the row's strip was written by the four lanes of this warp

#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[c] *= corr;
#pragma unroll 4
    for (int j = 0; j < BLOCK_K; ++j) {
      const float p = prow[j];
      const float* vrow = Vs + j * D + part;
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[c] += p * vrow[THREADS_PER_ROW * c];
    }
  }

  if (q_pos < S) {
    const float denom = fmaxf(l_i, 1e-30f);
    TO* orow = out + base + (size_t)q_pos * D + part;
#pragma unroll
    for (int c = 0; c < COLS; ++c) store(orow + THREADS_PER_ROW * c, acc[c] / denom);
    if (part == 0) {
      m_out[(size_t)bh * S + q_pos] = m_i;
      l_out[(size_t)bh * S + q_pos] = l_i;
    }
  }
}

template <typename TI, typename TO, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* m, void* l,
                   int bh, int S, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_fwd_kernel<TI, TO, D>;
  // above 48 KB only as dynamic shared memory, after this opt-in
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (S + BLOCK_Q - 1) / BLOCK_Q);
  const float scale = (float)(1.0 / sqrt((double)D));
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const TI*>(q), static_cast<const TI*>(k),
                                        static_cast<const TI*>(v), static_cast<TO*>(out),
                                        static_cast<float*>(m), static_cast<float*>(l), S,
                                        scale, causal);
  return cudaGetLastError();
}

template <typename TI, typename TO>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out, void* m, void* l,
                     int bh, int S, int D, int causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<TI, TO, 16>(q, k, v, out, m, l, bh, S, causal, stream);
    case 32: return launch<TI, TO, 32>(q, k, v, out, m, l, bh, S, causal, stream);
    case 64: return launch<TI, TO, 64>(q, k, v, out, m, l, bh, S, causal, stream);
    case 128: return launch<TI, TO, 128>(q, k, v, out, m, l, bh, S, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after
// the launch (0 on success). Launches on `stream`, does not synchronise,
// allocates nothing.
extern "C" int tpu_dist_flash_fwd(const void* q, const void* k, const void* v, void* out,
                                  void* m, void* l, int bh, int S, int D, int in_dtype,
                                  int out_dtype, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || S <= 0) return cudaErrorInvalidValue;
  if (in_dtype == 0 && out_dtype == 0)
    return launch_d<float, float>(q, k, v, out, m, l, bh, S, D, causal, st);
  if (in_dtype == 0 && out_dtype == 1)
    return launch_d<float, __nv_bfloat16>(q, k, v, out, m, l, bh, S, D, causal, st);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_d<__nv_bfloat16, float>(q, k, v, out, m, l, bh, S, D, causal, st);
  if (in_dtype == 1 && out_dtype == 1)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(q, k, v, out, m, l, bh, S, D, causal, st);
  return cudaErrorInvalidValue;
}
