// Flash-attention backward, dQ pass, for Hopper (sm_90a), f32 accumulation.
//
// Replaces: tpu_dist/ops/flash_attention.py::_bwd_dq_kernel (through the
// shared _recompute_p_ds), the Pallas TPU kernel of the second
// pl.pallas_call in _bwd_pallas. Same contract: q, k, v, do [BH, S, D] (f32
// or bf16, one dtype) and m, l, delta [BH, S] f32 -> dq [BH, S, D] (f32 or
// bf16). For each q tile it recomputes P and dS = P * (do v^T - delta) *
// scale over every k tile and accumulates dQ += dS k in f32, with the mask
// and the max(l, 1e-30) clamp of the dK/dV pass (one shared header).
//
// What bounds it on this card: at the ViT-B/16 training shape (BH = 64 * 12,
// S = 196, D = 64, bf16) a call must move ~98 MB (q, k, v, do, m, l, delta
// read once, dq written once): 29 us at 3.35 TB/s. Its three products are
// 6 * BH * S^2 * D = 11.3 GFLOP: 11 us at the 989 TFLOP/s bf16 tensor-core
// rate, so against the card's peaks it is bytes-bound. Its products run on
// the f32 CUDA cores (169 us for the same work at 67 TFLOP/s), so there
// arithmetic binds it.
//
// What the design does about it: one CTA per (bh, 64-row q tile), all in
// parallel; the TPU's sequential k grid dimension becomes a loop inside the
// CTA, so each dQ row has one writer and no atomics are needed. Q and dO
// stay in shared memory, each k tile stages K and V. Four threads own one q
// row and keep its m, l, delta in registers: each computes 16 of the tile's
// 64 scores and do.v products, writes dS into the row's strip of shared
// memory, and keeps a quarter of the row's dQ accumulator (D / 4 f32) in
// registers. Causal k tiles wholly above the diagonal are not visited.

#include "flash_attention_bwd_common.cuh"

namespace {

using namespace flash_bwd;

template <int D>
constexpr size_t smem_bytes() {
  // Q, dO, K, V tiles and the dS strip
  return sizeof(float) * (4 * tile_floats<D>() + BLOCK * STRIP);
}

template <typename TI, typename TO, int D>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const TI* __restrict__ q, const TI* __restrict__ k, const TI* __restrict__ v,
              const TI* __restrict__ dout, const float* __restrict__ m,
              const float* __restrict__ l, const float* __restrict__ delta,
              TO* __restrict__ dq, int S, float scale, int causal) {
  constexpr int COLS = D / THREADS_PER_ROW;  // accumulator columns per thread
  constexpr int LD = D + PAD;
  extern __shared__ float smem[];
  float* Qs = smem;  // [BLOCK][LD]
  float* dOs = Qs + tile_floats<D>();
  float* Ks = dOs + tile_floats<D>();
  float* Vs = Ks + tile_floats<D>();
  float* dSs = Vs + tile_floats<D>();  // [BLOCK q rows][STRIP]

  const int bh = blockIdx.x;
  const int qt = blockIdx.y;
  const size_t base = (size_t)bh * S * D;
  const int row = threadIdx.x / THREADS_PER_ROW;  // q row of the tile
  const int part = threadIdx.x % THREADS_PER_ROW;
  const int q_pos = qt * BLOCK + row;

  // the row's statistics; rows past S are masked by position, never read
  const bool in_range = q_pos < S;
  const size_t r = (size_t)bh * S + q_pos;
  const float m_i = in_range ? m[r] : 0.f;
  const float l_i = in_range ? l[r] : 0.f;
  const float delta_i = in_range ? delta[r] : 0.f;

  load_tile<TI, D>(Qs, q + base, qt * BLOCK, S);
  load_tile<TI, D>(dOs, dout + base, qt * BLOCK, S);

  float dq_acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) dq_acc[c] = 0.f;

  const float* qrow = Qs + row * LD;
  const float* dorow = dOs + row * LD;
  float* dsrow = dSs + row * STRIP;
  const int n_k = (S + BLOCK - 1) / BLOCK;

  for (int kt = 0; kt < n_k; ++kt) {
    if (causal && !causal_tile_live(qt, kt)) break;  // every later k tile is dead too
    __syncthreads();  // Q, dO are staged; the previous k tile's reads are done
    load_tile<TI, D>(Ks, k + base, kt * BLOCK, S);
    load_tile<TI, D>(Vs, v + base, kt * BLOCK, S);
    __syncthreads();

    // q . k and do . v for this thread's keys: j = part + 4 * jj
    float s[COLS_PER_THREAD], dp[COLS_PER_THREAD];
#pragma unroll
    for (int jj = 0; jj < COLS_PER_THREAD; ++jj) s[jj] = dp[jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
      const float dod = dorow[d];
#pragma unroll
      for (int jj = 0; jj < COLS_PER_THREAD; ++jj) {
        const int j = part + THREADS_PER_ROW * jj;
        s[jj] += qd * Ks[j * LD + d];
        dp[jj] += dod * Vs[j * LD + d];
      }
    }
#pragma unroll
    for (int jj = 0; jj < COLS_PER_THREAD; ++jj) {
      const int j = part + THREADS_PER_ROW * jj;
      float p, ds;
      p_ds(s[jj], dp[jj], m_i, l_i, delta_i, scale, live(q_pos, kt * BLOCK + j, S, causal), p,
           ds);
      dsrow[j] = ds;
    }
    __syncwarp();  // the row's strip was written by the four lanes of this warp

    // dQ[i] += sum_j dS[i][j] K[j]
#pragma unroll 4
    for (int j = 0; j < BLOCK; ++j) {
      const float ds = dsrow[j];
      const float* kr = Ks + j * LD + part;
#pragma unroll
      for (int c = 0; c < COLS; ++c) dq_acc[c] += ds * kr[THREADS_PER_ROW * c];
    }
  }

  if (in_range) {
    TO* dqrow = dq + base + (size_t)q_pos * D + part;
#pragma unroll
    for (int c = 0; c < COLS; ++c) store(dqrow + THREADS_PER_ROW * c, dq_acc[c]);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and do share in_dtype; dq
// is out_dtype). Returns cudaGetLastError() after the launch (0 on
// success). Launches on `stream`, does not synchronise, allocates nothing.
extern "C" int tpu_dist_flash_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* dout, const void* m, const void* l,
                                     const void* delta, void* dq, int bh, int S, int D,
                                     int in_dtype, int out_dtype, int causal, void* stream) {
  if (bh <= 0 || S <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(in_dtype, out_dtype, D, [&](auto ti, auto to, auto dim) -> cudaError_t {
    using TI = typename decltype(ti)::type;
    using TO = typename decltype(to)::type;
    constexpr int HD = decltype(dim)::value;
    constexpr size_t smem = smem_bytes<HD>();
    auto kern = dq_kernel<TI, TO, HD>;
    // above 48 KB only as dynamic shared memory, after this opt-in
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(bh, (S + BLOCK - 1) / BLOCK);
    const float scale = (float)(1.0 / sqrt((double)HD));
    kern<<<grid, THREADS, smem, st>>>(
        static_cast<const TI*>(q), static_cast<const TI*>(k), static_cast<const TI*>(v),
        static_cast<const TI*>(dout), static_cast<const float*>(m),
        static_cast<const float*>(l), static_cast<const float*>(delta), static_cast<TO*>(dq),
        S, scale, causal);
    return cudaGetLastError();
  });
}
