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
// Two kernels, chosen by the input dtype (flash_mma::tensor_core_route):
// - f32 inputs (serving): flash_fwd_kernel below, full-f32 products on the
//   CUDA cores.
// - bf16 inputs (training): flash_fwd_mma_kernel further down, products on
//   the bf16 tensor cores; P enters P V as bf16.
//
// flash_fwd_kernel (f32). What bounds it on this card: at the ViT-B/16
// serving shape (BH = 8 * 12, S = 196, D = 64) a call must move ~19 MB
// (q, k, v read once, out, m, l written once): 5.8 us at 3.35 TB/s. Its
// two products are ~0.94 GFLOP, 14 us at the 67 TFLOP/s f32 rate of the
// CUDA cores. So arithmetic binds, not bytes; and above all the [S, S]
// score matrix must never go to device memory, which would multiply the
// bytes.
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
// visited. The products run on the f32 CUDA cores: TF32 or bf16 tensor
// cores would change the function the serving path is checked for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "flash_attention_mma.cuh"

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

// flash_fwd_mma_kernel (bf16 inputs). What bounds it on this card: at the
// ViT-B/16 training shape (BH = 64 * 12, S = 196, D = 64) a call moves
// ~78 MB (23 us at 3.35 TB/s); its two products are 7.5 GFLOP, 7.6 us at
// the 989 TFLOP/s of the bf16 tensor cores. So bytes bind, once the
// products are on the tensor cores and the operands stay bf16.
//
// What the design does about it (FlashAttention-2's forward): one CTA per
// (bh, 64-row q tile), four warps of 16 q rows. Q arrives once by cp.async
// and its A fragments stay in registers for the whole K loop. K and V come
// in 64-row bf16 tiles, double-buffered by cp.async so that tile j + 1 is
// in flight while tile j computes; rows are padded for conflict-free
// ldmatrix. S = Q K^T runs on mma.sync into a 16 x 64 f32 fragment per
// warp; the online softmax stays in registers, a row's four owning lanes
// combining by shuffles; P is rounded to bf16 A fragments in registers and
// acc += P V runs on mma.sync with V through ldmatrix.trans. l sums the f32
// probabilities, so only P V sees the rounding (the plain version rounds
// P the same way for bf16 inputs). Ragged and causal masking as the f32
// kernel; causal tiles wholly above the diagonal are not loaded.
template <typename TO, int D>
__global__ void __launch_bounds__(flash_mma::THREADS)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, TO* __restrict__ out,
                         float* __restrict__ m_out, float* __restrict__ l_out, int S, float scale,
                         int causal) {
  using namespace flash_mma;
  constexpr int LD = row_stride<D>();
  constexpr int KC = D / 16;         // 16-wide chunks of D: the k steps of Q K^T
  constexpr int NT_S = BLOCK / 8;    // 8-key n tiles of a score row
  constexpr int NT_O = D / 8;        // 8-column n tiles of an output row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BLOCK][LD]
  bf16* Ks = Qs + BLOCK * LD;                     // [2][BLOCK][LD]
  bf16* Vs = Ks + 2 * BLOCK * LD;                 // [2][BLOCK][LD]

  const int bh = blockIdx.x;
  const int qt = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t base = (size_t)bh * S * D;
  const int row_w = warp * 16;  // the warp's first row in the tile
  int q_pos[2];                 // this lane's two rows: acc_row(lane, 0) and + 8
  q_pos[0] = qt * BLOCK + row_w + acc_row(lane, 0);
  q_pos[1] = q_pos[0] + 8;

  int n_k = (S + BLOCK - 1) / BLOCK;
  // tiles wholly above the diagonal (max q_pos < min k_pos) are all masked
  if (causal) n_k = min(n_k, ((qt + 1) * BLOCK - 1) / BLOCK + 1);

  load_tile_async<D>(Qs, q + base, qt * BLOCK, S);
  cp_async_commit();
  load_tile_async<D>(Ks, k + base, 0, S);
  load_tile_async<D>(Vs, v + base, 0, S);
  cp_async_commit();

  cp_async_wait<1>();  // Q has landed; K and V tile 0 may still fly
  __syncthreads();
  uint32_t qa[KC][4];  // Q's A fragments, held for the whole K loop
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) load_a<LD>(qa[kc], Qs, row_w, kc * 16, lane);

  float acc[NT_O][4];
#pragma unroll
  for (int nt = 0; nt < NT_O; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF};
  float l_i[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_k) {  // the next tile flies while this one computes
      load_tile_async<D>(Ks + (buf ^ 1) * BLOCK * LD, k + base, (kt + 1) * BLOCK, S);
      load_tile_async<D>(Vs + (buf ^ 1) * BLOCK * LD, v + base, (kt + 1) * BLOCK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt is in shared memory
    const bf16* Kb = Ks + buf * BLOCK * LD;
    const bf16* Vb = Vs + buf * BLOCK * LD;

    // S = Q K^T: 16 x 64 per warp
    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int jp = 0; jp < NT_S / 2; ++jp) {
        uint32_t b[4];
        load_b_pair<LD>(b, Kb, jp * 16, kc * 16, lane);
        mma_bf16_pair(s[2 * jp], s[2 * jp + 1], qa[kc], b);
      }
    }

    // scale and mask; the row max over this tile
    unsigned live = 0;  // bit 4 j + i: score s[j][i] is visible
    float tile_max[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k_pos = kt * BLOCK + j * 8 + acc_col(lane, i);
        const int r = i >> 1;
        const bool ok = k_pos < S && (!causal || q_pos[r] >= k_pos);
        live |= (ok ? 1u : 0u) << (4 * j + i);
        s[j][i] = ok ? s[j][i] * scale : NEG_INF;
        tile_max[r] = fmaxf(tile_max[r], s[j][i]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a row lives on the four lanes of one g
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float m_new = fmaxf(m_i[r], tile_max[r]);
      corr[r] = expf(m_i[r] - m_new);
      m_i[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        s[j][i] = (live >> (4 * j + i)) & 1u ? expf(s[j][i] - m_i[r]) : 0.f;  // exact zeros
        psum[r] += s[j][i];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l_i[r] = l_i[r] * corr[r] + psum[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] *= corr[i >> 1];

    // acc += P V, P as bf16 A fragments straight from the score registers
#pragma unroll
    for (int kk = 0; kk < BLOCK / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < NT_O / 2; ++dp) {
        uint32_t b[4];
        load_b_pair_trans<LD>(b, Vb, kk * 16, dp * 16, lane);
        mma_bf16_pair(acc[2 * dp], acc[2 * dp + 1], pa, b);
      }
    }
    __syncthreads();  // every warp is done with buffer `buf` before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (q_pos[r] >= S) continue;
    const float denom = fmaxf(l_i[r], 1e-30f);
    TO* orow = out + base + (size_t)q_pos[r] * D;
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt)
      store2(orow + nt * 8 + acc_col(lane, 0), acc[nt][2 * r] / denom,
             acc[nt][2 * r + 1] / denom);
    if ((lane & 3) == 0) {
      m_out[(size_t)bh * S + q_pos[r]] = m_i[r];
      l_out[(size_t)bh * S + q_pos[r]] = l_i[r];
    }
  }
}

template <int D>
constexpr size_t mma_smem_bytes() {
  // Q, then K and V double-buffered
  return sizeof(__nv_bfloat16) * 5 * flash_mma::BLOCK * flash_mma::row_stride<D>();
}

// Launch one kernel instance on grid (bh, ceil(S / 64)); shared memory
// above 48 KB needs the opt-in first.
template <typename Kern, typename... Args>
cudaError_t launch_kernel(Kern kern, int threads, size_t smem, int bh, int S, int block,
                          cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (S + block - 1) / block);
  kern<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename TO, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* m, void* l,
                   int bh, int S, int causal, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)D));
  return launch_kernel(flash_fwd_kernel<float, TO, D>, THREADS, smem_bytes<D>(), bh, S, BLOCK_Q,
                       stream, static_cast<const float*>(q), static_cast<const float*>(k),
                       static_cast<const float*>(v), static_cast<TO*>(out),
                       static_cast<float*>(m), static_cast<float*>(l), S, scale, causal);
}

template <typename TO, int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, void* m, void* l,
                       int bh, int S, int causal, cudaStream_t stream) {
  using flash_mma::bf16;
  const float scale = (float)(1.0 / sqrt((double)D));
  return launch_kernel(flash_fwd_mma_kernel<TO, D>, flash_mma::THREADS, mma_smem_bytes<D>(), bh,
                       S, flash_mma::BLOCK, stream, static_cast<const bf16*>(q),
                       static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                       static_cast<TO*>(out), static_cast<float*>(m), static_cast<float*>(l), S,
                       scale, causal);
}

// One instance per (route, out dtype, head dim).
template <typename TO>
cudaError_t launch_d(bool mma, const void* q, const void* k, const void* v, void* out, void* m,
                     void* l, int bh, int S, int D, int causal, cudaStream_t st) {
#define TPU_DIST_FWD_CASE(HD)                                              \
  case HD:                                                                 \
    return mma ? launch_mma<TO, HD>(q, k, v, out, m, l, bh, S, causal, st) \
               : launch<TO, HD>(q, k, v, out, m, l, bh, S, causal, st);
  switch (D) {
    TPU_DIST_FWD_CASE(16)
    TPU_DIST_FWD_CASE(32)
    TPU_DIST_FWD_CASE(64)
    TPU_DIST_FWD_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef TPU_DIST_FWD_CASE
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (flash_mma::DTYPE_*). bf16 inputs
// take the tensor-core kernel, f32 inputs the CUDA-core kernel
// (flash_mma::tensor_core_route); either writes f32 or bf16 out. Returns
// cudaGetLastError() after the launch (0 on success). Launches on `stream`,
// does not synchronise, allocates nothing. q, k, v must be 16-byte aligned
// for the tensor-core kernel's cp.async (the wrapper checks).
extern "C" int tpu_dist_flash_fwd(const void* q, const void* k, const void* v, void* out,
                                  void* m, void* l, int bh, int S, int D, int in_dtype,
                                  int out_dtype, int causal, void* stream) {
  using namespace flash_mma;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || S <= 0) return cudaErrorInvalidValue;
  if (in_dtype != DTYPE_F32 && in_dtype != DTYPE_BF16) return cudaErrorInvalidValue;
  const bool mma = tensor_core_route(in_dtype);
  if (out_dtype == DTYPE_F32)
    return launch_d<float>(mma, q, k, v, out, m, l, bh, S, D, causal, st);
  if (out_dtype == DTYPE_BF16)
    return launch_d<__nv_bfloat16>(mma, q, k, v, out, m, l, bh, S, D, causal, st);
  return cudaErrorInvalidValue;
}
