// Flash-attention backward, dK/dV pass, for Hopper (sm_90a), f32 accumulation.
//
// Replaces: tpu_dist/ops/flash_attention.py::_bwd_dkdv_kernel (through the
// shared _recompute_p_ds), the Pallas TPU kernel of the first pl.pallas_call
// in _bwd_pallas. Same contract: q, k, v, do [BH, S, D] (f32 or bf16, one
// dtype) and the forward's row statistics m, l plus delta = rowsum(do * o),
// all [BH, S] f32 -> dk, dv [BH, S, D] (f32 or bf16). For each k tile it
// recomputes P = exp(q k^T * scale - m) / max(l, 1e-30) and
// dS = P * (do v^T - delta) * scale over every q tile, and accumulates
// dV += P^T do and dK += dS^T q in f32. Padded q and k rows are masked by
// position, the causal mask is q_pos >= k_pos, and masked scores add
// exactly 0.
//
// What bounds it on this card: at the ViT-B/16 training shape (BH = 64 * 12,
// S = 196, D = 64, bf16) a call must move ~117 MB (q, k, v, do read once,
// m, l, delta read once, dk, dv written once): 35 us at 3.35 TB/s. Its four
// products are 8 * BH * S^2 * D = 15.1 GFLOP: 15 us at the 989 TFLOP/s of
// the bf16 tensor cores, so against the card's peaks it is bytes-bound.
// This first kernel runs its products on the f32 CUDA cores (67 TFLOP/s,
// 225 us for the same work), so there arithmetic binds it; above all, the
// [S, S] scores never go to device memory.
//
// What the design does about it: one CTA per (bh, 64-row k tile), all in
// parallel (BH * ceil(S / 64) CTAs). The TPU's sequential q grid dimension
// becomes a loop inside the CTA, so no two CTAs write one dK/dV row and no
// atomics are needed. K and V stay in shared memory for the whole loop; each
// q tile stages Q, dO and its m, l, delta rows. Four threads own one k row:
// each computes 16 of the tile's 64 scores and do.v products in registers,
// writes P and dS into the row's strip of shared memory, and keeps a
// quarter of the row's dK and dV accumulators (2 * D / 4 f32) in registers.
// Causal q tiles wholly above the diagonal are not visited. bf16 tensor-core
// products (mma.sync, then wgmma fed by TMA) are the next step.

#include "flash_attention_bwd_common.cuh"

namespace {

using namespace flash_bwd;

template <int D>
constexpr size_t smem_bytes() {
  // K, V, Q, dO tiles; the P^T and dS^T strips; the m, l, delta rows
  return sizeof(float) * (4 * tile_floats<D>() + 2 * BLOCK * STRIP + 3 * BLOCK);
}

template <typename TI, typename TO, int D>
__global__ void __launch_bounds__(THREADS)
    dkdv_kernel(const TI* __restrict__ q, const TI* __restrict__ k, const TI* __restrict__ v,
                const TI* __restrict__ dout, const float* __restrict__ m,
                const float* __restrict__ l, const float* __restrict__ delta,
                TO* __restrict__ dk, TO* __restrict__ dv, int S, float scale, int causal) {
  constexpr int COLS = D / THREADS_PER_ROW;  // accumulator columns per thread
  constexpr int LD = D + PAD;
  extern __shared__ float smem[];
  float* Ks = smem;                  // [BLOCK][LD]
  float* Vs = Ks + tile_floats<D>();
  float* Qs = Vs + tile_floats<D>();
  float* dOs = Qs + tile_floats<D>();
  float* Ps = dOs + tile_floats<D>();  // [BLOCK k rows][STRIP]: P^T
  float* dSs = Ps + BLOCK * STRIP;     // dS^T
  float* ms = dSs + BLOCK * STRIP;     // [BLOCK]
  float* ls = ms + BLOCK;
  float* deltas = ls + BLOCK;

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;
  const size_t base = (size_t)bh * S * D;
  const size_t rbase = (size_t)bh * S;
  const int row = threadIdx.x / THREADS_PER_ROW;  // k row of the tile
  const int part = threadIdx.x % THREADS_PER_ROW;
  const int k_pos = kt * BLOCK + row;

  load_tile<TI, D>(Ks, k + base, kt * BLOCK, S);
  load_tile<TI, D>(Vs, v + base, kt * BLOCK, S);

  float dk_acc[COLS], dv_acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  const float* krow = Ks + row * LD;
  const float* vrow = Vs + row * LD;
  float* prow = Ps + row * STRIP;
  float* dsrow = dSs + row * STRIP;
  const int n_q = (S + BLOCK - 1) / BLOCK;

  for (int qt = 0; qt < n_q; ++qt) {
    if (causal && !causal_tile_live(qt, kt)) continue;  // uniform over the CTA
    __syncthreads();  // K, V are staged; the previous q tile's reads are done
    load_tile<TI, D>(Qs, q + base, qt * BLOCK, S);
    load_tile<TI, D>(dOs, dout + base, qt * BLOCK, S);
    load_rows(ms, m + rbase, qt * BLOCK, S);
    load_rows(ls, l + rbase, qt * BLOCK, S);
    load_rows(deltas, delta + rbase, qt * BLOCK, S);
    __syncthreads();

    // q . k and do . v for this thread's q rows: i = part + 4 * jj
    float s[COLS_PER_THREAD], dp[COLS_PER_THREAD];
#pragma unroll
    for (int jj = 0; jj < COLS_PER_THREAD; ++jj) s[jj] = dp[jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
      const float vd = vrow[d];
#pragma unroll
      for (int jj = 0; jj < COLS_PER_THREAD; ++jj) {
        const int i = part + THREADS_PER_ROW * jj;
        s[jj] += Qs[i * LD + d] * kd;
        dp[jj] += dOs[i * LD + d] * vd;
      }
    }
#pragma unroll
    for (int jj = 0; jj < COLS_PER_THREAD; ++jj) {
      const int i = part + THREADS_PER_ROW * jj;
      float p, ds;
      p_ds(s[jj], dp[jj], ms[i], ls[i], deltas[i], scale,
           live(qt * BLOCK + i, k_pos, S, causal), p, ds);
      prow[i] = p;
      dsrow[i] = ds;
    }
    __syncwarp();  // the row's strips were written by the four lanes of this warp

    // dV[k] += sum_i P[i][k] dO[i];  dK[k] += sum_i dS[i][k] Q[i]
#pragma unroll 4
    for (int i = 0; i < BLOCK; ++i) {
      const float p = prow[i];
      const float ds = dsrow[i];
      const float* dorow = dOs + i * LD + part;
      const float* qrow = Qs + i * LD + part;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        dv_acc[c] += p * dorow[THREADS_PER_ROW * c];
        dk_acc[c] += ds * qrow[THREADS_PER_ROW * c];
      }
    }
  }

  if (k_pos < S) {
    TO* dkrow = dk + base + (size_t)k_pos * D + part;
    TO* dvrow = dv + base + (size_t)k_pos * D + part;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      store(dkrow + THREADS_PER_ROW * c, dk_acc[c]);
      store(dvrow + THREADS_PER_ROW * c, dv_acc[c]);
    }
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and do share in_dtype; dk
// and dv are out_dtype). Returns cudaGetLastError() after the launch (0 on
// success). Launches on `stream`, does not synchronise, allocates nothing.
extern "C" int tpu_dist_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* m, const void* l,
                                       const void* delta, void* dk, void* dv, int bh, int S,
                                       int D, int in_dtype, int out_dtype, int causal,
                                       void* stream) {
  if (bh <= 0 || S <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(in_dtype, out_dtype, D, [&](auto ti, auto to, auto dim) -> cudaError_t {
    using TI = typename decltype(ti)::type;
    using TO = typename decltype(to)::type;
    constexpr int HD = decltype(dim)::value;
    constexpr size_t smem = smem_bytes<HD>();
    auto kern = dkdv_kernel<TI, TO, HD>;
    // above 48 KB only as dynamic shared memory, after this opt-in
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(bh, (S + BLOCK - 1) / BLOCK);
    const float scale = (float)(1.0 / sqrt((double)HD));
    kern<<<grid, THREADS, smem, st>>>(
        static_cast<const TI*>(q), static_cast<const TI*>(k), static_cast<const TI*>(v),
        static_cast<const TI*>(dout), static_cast<const float*>(m),
        static_cast<const float*>(l), static_cast<const float*>(delta), static_cast<TO*>(dk),
        static_cast<TO*>(dv), S, scale, causal);
    return cudaGetLastError();
  });
}
