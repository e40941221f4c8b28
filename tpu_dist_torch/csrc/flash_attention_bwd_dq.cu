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
// Two kernels, chosen by the input dtype (flash_mma::tensor_core_route):
// f32 inputs run dq_kernel below on the f32 CUDA cores; bf16 inputs (the
// training path) run dq_mma_kernel further down on the bf16 tensor cores,
// where dS enters dQ += dS K as bf16.
//
// What bounds it on this card: at the ViT-B/16 training shape (BH = 64 * 12,
// S = 196, D = 64, bf16) a call must move ~98 MB (q, k, v, do, m, l, delta
// read once, dq written once): 29 us at 3.35 TB/s. Its three products are
// 6 * BH * S^2 * D = 11.3 GFLOP: 11 us at the 989 TFLOP/s bf16 tensor-core
// rate, so against the card's peaks it is bytes-bound. dq_kernel runs its
// products on the f32 CUDA cores (169 us for the same work at 67 TFLOP/s),
// so there arithmetic binds it, and each of its FMAs also reads K or V from
// shared memory.
//
// dq_kernel. What the design does about it: one CTA per (bh, 64-row q
// tile), all in parallel; the TPU's sequential k grid dimension becomes a
// loop inside the CTA, so each dQ row has one writer and no atomics are
// needed. Q and dO stay in shared memory, each k tile stages K and V. Four
// threads own one q row and keep its m, l, delta in registers: each
// computes 16 of the tile's 64 scores and do.v products, writes dS into the
// row's strip of shared memory, and keeps a quarter of the row's dQ
// accumulator (D / 4 f32) in registers. Causal k tiles wholly above the
// diagonal are not visited.

#include "flash_attention_bwd_common.cuh"
#include "flash_attention_mma.cuh"

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

// dq_mma_kernel (bf16 inputs): the same pass on the bf16 tensor cores
// (FlashAttention-2's dQ loop). One CTA per (bh, 64-row q tile), four warps
// of 16 q rows, so every dQ row has one writer, as above. Q and dO arrive
// once by cp.async; at D <= 64 their A fragments stay in registers for the
// whole k loop (at D = 128 they are read again from shared memory each k
// tile, which keeps the registers under 255). Each lane keeps m, l and
// delta of its two rows in registers. K and V come in 64-row bf16 tiles,
// double-buffered by cp.async so that tile j + 1 is in flight while tile j
// computes. S = Q K^T and dP = dO V^T run on mma.sync with K and V stored
// [n][k]; P and dS are computed element by element through the shared
// live() and p_ds() of flash_attention_bwd_common.cuh; dS is rounded to
// bf16 A fragments in registers and dQ += dS K runs on mma.sync with K
// through ldmatrix.trans, so dS never touches shared memory. At D = 128 a
// k tile is taken in two halves of 32 keys, so the S and dP fragments fit
// beside the D-wide accumulator. Rows at or past S are zero-filled and
// masked by position; causal k tiles wholly above the diagonal are not
// loaded.
template <typename TO, int D>
__global__ void __launch_bounds__(flash_mma::THREADS)
    dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ m, const float* __restrict__ l,
                  const float* __restrict__ delta, TO* __restrict__ dq, int S, float scale,
                  int causal) {
  namespace fm = flash_mma;
  using fm::bf16;
  static_assert(fm::BLOCK == BLOCK, "one tile height for causal_tile_live");
  constexpr int LD = fm::row_stride<D>();
  constexpr int KC = D / 16;             // k steps of Q K^T and dO V^T
  constexpr int KN = D <= 64 ? 64 : 32;  // keys a sub-step
  constexpr int NT_K = KN / 8;           // 8-key n tiles of S and dP
  constexpr int NT_D = D / 8;            // 8-column n tiles of dQ
  constexpr bool QDO_IN_REGS = D <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BLOCK][LD]
  bf16* dOs = Qs + BLOCK * LD;                    // [BLOCK][LD]
  bf16* Ks = dOs + BLOCK * LD;                    // [2][BLOCK][LD]
  bf16* Vs = Ks + 2 * BLOCK * LD;                 // [2][BLOCK][LD]

  const int bh = blockIdx.x;
  const int qt = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t base = (size_t)bh * S * D;
  const int row_w = warp * 16;  // the warp's first q row in the tile
  int q_pos[2];                 // this lane's two q rows
  q_pos[0] = qt * BLOCK + row_w + fm::acc_row(lane, 0);
  q_pos[1] = q_pos[0] + 8;
  // the rows' statistics; rows past S are masked by position, never read
  float m_i[2], l_i[2], delta_i[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in_range = q_pos[r] < S;
    const size_t idx = (size_t)bh * S + (in_range ? q_pos[r] : 0);
    m_i[r] = in_range ? m[idx] : 0.f;
    l_i[r] = in_range ? l[idx] : 0.f;
    delta_i[r] = in_range ? delta[idx] : 0.f;
  }

  int n_k = (S + BLOCK - 1) / BLOCK;
  // k tiles wholly above the diagonal (max q_pos < min k_pos) are all masked
  if (causal) n_k = min(n_k, ((qt + 1) * BLOCK - 1) / BLOCK + 1);

  fm::load_tile_async<D>(Qs, q + base, qt * BLOCK, S);
  fm::load_tile_async<D>(dOs, dout + base, qt * BLOCK, S);
  fm::cp_async_commit();
  fm::load_tile_async<D>(Ks, k + base, 0, S);
  fm::load_tile_async<D>(Vs, v + base, 0, S);
  fm::cp_async_commit();

  uint32_t qa[QDO_IN_REGS ? KC : 1][4], doa[QDO_IN_REGS ? KC : 1][4];
  if constexpr (QDO_IN_REGS) {
    fm::cp_async_wait<1>();  // Q and dO have landed; K and V tile 0 may still fly
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      fm::load_a<LD>(qa[kc], Qs, row_w, kc * 16, lane);
      fm::load_a<LD>(doa[kc], dOs, row_w, kc * 16, lane);
    }
  }

  float acc[NT_D][4];
#pragma unroll
  for (int nt = 0; nt < NT_D; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_k) {  // the next tile flies while this one computes
      fm::load_tile_async<D>(Ks + (buf ^ 1) * BLOCK * LD, k + base, (kt + 1) * BLOCK, S);
      fm::load_tile_async<D>(Vs + (buf ^ 1) * BLOCK * LD, v + base, (kt + 1) * BLOCK, S);
      fm::cp_async_commit();
      fm::cp_async_wait<1>();
    } else {
      fm::cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and Q, dO) are in shared memory
    const bf16* Kb = Ks + buf * BLOCK * LD;
    const bf16* Vb = Vs + buf * BLOCK * LD;

#pragma unroll
    for (int c0 = 0; c0 < BLOCK; c0 += KN) {
      // S = Q K^T and dP = dO V^T over keys [c0, c0 + KN)
      float s[NT_K][4], dp[NT_K][4];
#pragma unroll
      for (int j = 0; j < NT_K; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t qf[4], dof[4];
        if constexpr (QDO_IN_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            qf[i] = qa[kc][i];
            dof[i] = doa[kc][i];
          }
        } else {
          fm::load_a<LD>(qf, Qs, row_w, kc * 16, lane);
          fm::load_a<LD>(dof, dOs, row_w, kc * 16, lane);
        }
#pragma unroll
        for (int jp = 0; jp < NT_K / 2; ++jp) {
          uint32_t b[4];
          fm::load_b_pair<LD>(b, Kb, c0 + jp * 16, kc * 16, lane);
          fm::mma_bf16_pair(s[2 * jp], s[2 * jp + 1], qf, b);
          fm::load_b_pair<LD>(b, Vb, c0 + jp * 16, kc * 16, lane);
          fm::mma_bf16_pair(dp[2 * jp], dp[2 * jp + 1], dof, b);
        }
      }

      // dS in place of dP, through the one definition of the mask, the
      // clamp and the recompute
#pragma unroll
      for (int j = 0; j < NT_K; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const int k_pos = kt * BLOCK + c0 + j * 8 + fm::acc_col(lane, i);
          float p, ds;
          p_ds(s[j][i], dp[j][i], m_i[r], l_i[r], delta_i[r], scale,
               live(q_pos[r], k_pos, S, causal), p, ds);
          dp[j][i] = ds;
        }
      }

      // dQ += dS K, dS as bf16 A fragments, K through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk) {
        uint32_t dsa[4];
        fm::acc_to_a(dsa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int dpair = 0; dpair < NT_D / 2; ++dpair) {
          uint32_t b[4];
          fm::load_b_pair_trans<LD>(b, Kb, c0 + kk * 16, dpair * 16, lane);
          fm::mma_bf16_pair(acc[2 * dpair], acc[2 * dpair + 1], dsa, b);
        }
      }
    }
    __syncthreads();  // every warp is done with buffer `buf` before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (q_pos[r] >= S) continue;
    TO* dqrow = dq + base + (size_t)q_pos[r] * D;
#pragma unroll
    for (int nt = 0; nt < NT_D; ++nt)
      fm::store2(dqrow + nt * 8 + fm::acc_col(lane, 0), acc[nt][2 * r], acc[nt][2 * r + 1]);
  }
}

template <int D>
constexpr size_t mma_smem_bytes() {
  // Q, dO; K and V double-buffered
  return sizeof(__nv_bfloat16) * 6 * flash_mma::BLOCK * flash_mma::row_stride<D>();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (flash_mma::DTYPE_*; q, k, v and
// do share in_dtype; dq is out_dtype). bf16 inputs take the tensor-core
// kernel dq_mma_kernel, f32 inputs the CUDA-core kernel dq_kernel
// (flash_mma::tensor_core_route). Returns cudaGetLastError() after the
// launch (0 on success). Launches on `stream`, does not synchronise,
// allocates nothing. q, k, v, do must be 16-byte aligned for the
// tensor-core kernel's cp.async (the wrapper checks).
extern "C" int tpu_dist_flash_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* dout, const void* m, const void* l,
                                     const void* delta, void* dq, int bh, int S, int D,
                                     int in_dtype, int out_dtype, int causal, void* stream) {
  if (bh <= 0 || S <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto ti, auto to, auto dim) -> cudaError_t {
    using TI = typename decltype(ti)::type;
    using TO = typename decltype(to)::type;
    constexpr int HD = decltype(dim)::value;
    constexpr bool MMA = std::is_same<TI, __nv_bfloat16>::value;
    constexpr size_t smem = MMA ? mma_smem_bytes<HD>() : smem_bytes<HD>();
    auto kern = [] {
      if constexpr (MMA)
        return dq_mma_kernel<TO, HD>;
      else
        return dq_kernel<float, TO, HD>;
    }();
    // above 48 KB only as dynamic shared memory, after this opt-in
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(bh, (S + BLOCK - 1) / BLOCK);
    const float scale = (float)(1.0 / sqrt((double)HD));
    kern<<<grid, MMA ? flash_mma::THREADS : THREADS, smem, st>>>(
        static_cast<const TI*>(q), static_cast<const TI*>(k), static_cast<const TI*>(v),
        static_cast<const TI*>(dout), static_cast<const float*>(m),
        static_cast<const float*>(l), static_cast<const float*>(delta), static_cast<TO*>(dq),
        S, scale, causal);
    return cudaGetLastError();
  };
  if (flash_mma::tensor_core_route(in_dtype))
    return dispatch_out<__nv_bfloat16>(out_dtype, D, launch);
  if (in_dtype == flash_mma::DTYPE_F32) return dispatch_out<float>(out_dtype, D, launch);
  return cudaErrorInvalidValue;
}
