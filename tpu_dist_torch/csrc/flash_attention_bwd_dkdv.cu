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
// Two kernels, chosen by the input dtype (flash_mma::tensor_core_route):
// f32 inputs run dkdv_kernel below on the f32 CUDA cores; bf16 inputs (the
// training path) run dkdv_mma_kernel further down on the bf16 tensor
// cores, where P and dS enter their products as bf16.
//
// What bounds it on this card: at the ViT-B/16 training shape (BH = 64 * 12,
// S = 196, D = 64, bf16) a call must move ~117 MB (q, k, v, do read once,
// m, l, delta read once, dk, dv written once): 35 us at 3.35 TB/s. Its four
// products are 8 * BH * S^2 * D = 15.1 GFLOP: 15 us at the 989 TFLOP/s of
// the bf16 tensor cores, so against the card's peaks it is bytes-bound.
// dkdv_kernel runs its products on the f32 CUDA cores (67 TFLOP/s, 225 us
// for the same work), so there arithmetic binds it; above all, the [S, S]
// scores never go to device memory.
//
// dkdv_kernel. What the design does about it: one CTA per (bh, 64-row k
// tile), all in parallel (BH * ceil(S / 64) CTAs). The TPU's sequential q grid dimension
// becomes a loop inside the CTA, so no two CTAs write one dK/dV row and no
// atomics are needed. K and V stay in shared memory for the whole loop; each
// q tile stages Q, dO and its m, l, delta rows. Four threads own one k row:
// each computes 16 of the tile's 64 scores and do.v products in registers,
// writes P and dS into the row's strip of shared memory, and keeps a
// quarter of the row's dK and dV accumulators (2 * D / 4 f32) in registers.
// Causal q tiles wholly above the diagonal are not visited.

#include "flash_attention_bwd_common.cuh"
#include "flash_attention_mma.cuh"

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

// dkdv_mma_kernel (bf16 inputs): the same pass on the bf16 tensor cores
// (FlashAttention-2's dK/dV loop). One CTA per (bh, 64-row k tile), four
// warps of 16 k rows; as above, each CTA loops over the q tiles, so every
// dK/dV row has one writer. K and V arrive once by cp.async, and at D <= 64
// their A fragments stay in registers for the whole loop (at D = 128 they
// are read again from shared memory, which keeps the registers under 255
// without a spill). Q, dO and the tile's m, l, delta rows come in by
// double-buffered cp.async, the next q tile in flight while this one
// computes. S^T = K Q^T and dP^T = V dO^T run on mma.sync with the k rows
// as M, so P^T and dS^T, computed element by element through the shared
// live() and p_ds() of flash_attention_bwd_common.cuh, sit in registers in
// the layout of the next products' A operand: dV += P^T dO and
// dK += dS^T Q take them as bf16 A fragments, with dO and Q through
// ldmatrix.trans. At D = 128 a q tile is taken in two halves of 32 columns,
// so the S^T and dP^T fragments fit beside the two D-wide accumulators.
template <typename TO, int D>
__global__ void __launch_bounds__(flash_mma::THREADS)
    dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ m, const float* __restrict__ l,
                    const float* __restrict__ delta, TO* __restrict__ dk, TO* __restrict__ dv,
                    int S, float scale, int causal) {
  namespace fm = flash_mma;
  using fm::bf16;
  static_assert(fm::BLOCK == BLOCK, "one tile height for causal_tile_live");
  constexpr int LD = fm::row_stride<D>();
  constexpr int KC = D / 16;             // k steps of K Q^T and V dO^T
  constexpr int QN = D <= 64 ? 64 : 32;  // q columns a sub-step
  constexpr int NT_Q = QN / 8;           // 8-column n tiles of S^T and dP^T
  constexpr int NT_D = D / 8;            // 8-column n tiles of dK and dV
  constexpr bool KV_IN_REGS = D <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BLOCK][LD]
  bf16* Vs = Ks + BLOCK * LD;                     // [BLOCK][LD]
  bf16* Qs = Vs + BLOCK * LD;                     // [2][BLOCK][LD]
  bf16* dOs = Qs + 2 * BLOCK * LD;                // [2][BLOCK][LD]
  float* stats = reinterpret_cast<float*>(dOs + 2 * BLOCK * LD);  // [2][m, l, delta][BLOCK]

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t base = (size_t)bh * S * D;
  const size_t rbase = (size_t)bh * S;
  const int row_w = warp * 16;  // the warp's first k row in the tile
  int k_pos[2];                 // this lane's two k rows
  k_pos[0] = kt * BLOCK + row_w + fm::acc_row(lane, 0);
  k_pos[1] = k_pos[0] + 8;
  const int n_q = (S + BLOCK - 1) / BLOCK;
  int qt0 = 0;  // the first q tile not wholly above the diagonal (qt0 <= kt)
  if (causal)
    while (!causal_tile_live(qt0, kt)) ++qt0;

  auto load_q_tile = [&](int qt, int buf) {
    fm::load_tile_async<D>(Qs + buf * BLOCK * LD, q + base, qt * BLOCK, S);
    fm::load_tile_async<D>(dOs + buf * BLOCK * LD, dout + base, qt * BLOCK, S);
    float* st = stats + buf * 3 * BLOCK;
    fm::load_rows_async(st, m + rbase, qt * BLOCK, S);
    fm::load_rows_async(st + BLOCK, l + rbase, qt * BLOCK, S);
    fm::load_rows_async(st + 2 * BLOCK, delta + rbase, qt * BLOCK, S);
  };

  fm::load_tile_async<D>(Ks, k + base, kt * BLOCK, S);
  fm::load_tile_async<D>(Vs, v + base, kt * BLOCK, S);
  fm::cp_async_commit();
  load_q_tile(qt0, 0);
  fm::cp_async_commit();

  uint32_t ka[KV_IN_REGS ? KC : 1][4], va[KV_IN_REGS ? KC : 1][4];
  if constexpr (KV_IN_REGS) {
    fm::cp_async_wait<1>();  // K and V have landed; the first q tile may still fly
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      fm::load_a<LD>(ka[kc], Ks, row_w, kc * 16, lane);
      fm::load_a<LD>(va[kc], Vs, row_w, kc * 16, lane);
    }
  }

  float dk_acc[NT_D][4], dv_acc[NT_D][4];
#pragma unroll
  for (int nt = 0; nt < NT_D; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[nt][i] = dv_acc[nt][i] = 0.f;

  for (int qt = qt0; qt < n_q; ++qt) {
    const int buf = (qt - qt0) & 1;
    if (qt + 1 < n_q) {  // the next q tile flies while this one computes
      load_q_tile(qt + 1, buf ^ 1);
      fm::cp_async_commit();
      fm::cp_async_wait<1>();
    } else {
      fm::cp_async_wait<0>();
    }
    __syncthreads();  // q tile qt (and K, V) are in shared memory
    const bf16* Qb = Qs + buf * BLOCK * LD;
    const bf16* dOb = dOs + buf * BLOCK * LD;
    const float* mb = stats + buf * 3 * BLOCK;
    const float* lb = mb + BLOCK;
    const float* db = lb + BLOCK;

#pragma unroll
    for (int c0 = 0; c0 < BLOCK; c0 += QN) {
      // S^T = K Q^T and dP^T = V dO^T over q columns [c0, c0 + QN)
      float st[NT_Q][4], dpt[NT_Q][4];
#pragma unroll
      for (int j = 0; j < NT_Q; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[j][i] = dpt[j][i] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t kf[4], vf[4];
        if constexpr (KV_IN_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            kf[i] = ka[kc][i];
            vf[i] = va[kc][i];
          }
        } else {
          fm::load_a<LD>(kf, Ks, row_w, kc * 16, lane);
          fm::load_a<LD>(vf, Vs, row_w, kc * 16, lane);
        }
#pragma unroll
        for (int jp = 0; jp < NT_Q / 2; ++jp) {
          uint32_t b[4];
          fm::load_b_pair<LD>(b, Qb, c0 + jp * 16, kc * 16, lane);
          fm::mma_bf16_pair(st[2 * jp], st[2 * jp + 1], kf, b);
          fm::load_b_pair<LD>(b, dOb, c0 + jp * 16, kc * 16, lane);
          fm::mma_bf16_pair(dpt[2 * jp], dpt[2 * jp + 1], vf, b);
        }
      }

      // P^T and dS^T in place, through the one definition of the mask,
      // the clamp and the recompute
#pragma unroll
      for (int j = 0; j < NT_Q; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = c0 + j * 8 + fm::acc_col(lane, i);  // q row in the tile
          float p, ds;
          p_ds(st[j][i], dpt[j][i], mb[qi], lb[qi], db[qi], scale,
               live(qt * BLOCK + qi, k_pos[i >> 1], S, causal), p, ds);
          st[j][i] = p;
          dpt[j][i] = ds;
        }
      }

      // dV += P^T dO and dK += dS^T Q, P^T and dS^T as bf16 A fragments
#pragma unroll
      for (int kk = 0; kk < QN / 16; ++kk) {
        uint32_t pa[4], dsa[4];
        fm::acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
        fm::acc_to_a(dsa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < NT_D / 2; ++dp) {
          uint32_t b[4];
          fm::load_b_pair_trans<LD>(b, dOb, c0 + kk * 16, dp * 16, lane);
          fm::mma_bf16_pair(dv_acc[2 * dp], dv_acc[2 * dp + 1], pa, b);
          fm::load_b_pair_trans<LD>(b, Qb, c0 + kk * 16, dp * 16, lane);
          fm::mma_bf16_pair(dk_acc[2 * dp], dk_acc[2 * dp + 1], dsa, b);
        }
      }
    }
    __syncthreads();  // every warp is done with buffer `buf` before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (k_pos[r] >= S) continue;
    TO* dkrow = dk + base + (size_t)k_pos[r] * D;
    TO* dvrow = dv + base + (size_t)k_pos[r] * D;
#pragma unroll
    for (int nt = 0; nt < NT_D; ++nt) {
      const int col = nt * 8 + fm::acc_col(lane, 0);
      fm::store2(dkrow + col, dk_acc[nt][2 * r], dk_acc[nt][2 * r + 1]);
      fm::store2(dvrow + col, dv_acc[nt][2 * r], dv_acc[nt][2 * r + 1]);
    }
  }
}

template <int D>
constexpr size_t mma_smem_bytes() {
  // K, V; Q and dO double-buffered; m, l, delta double-buffered
  return sizeof(__nv_bfloat16) * 6 * flash_mma::BLOCK * flash_mma::row_stride<D>() +
         sizeof(float) * 2 * 3 * flash_mma::BLOCK;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (flash_mma::DTYPE_*; q, k, v and
// do share in_dtype; dk and dv are out_dtype). bf16 inputs take the
// tensor-core kernel, f32 inputs the CUDA-core kernel
// (flash_mma::tensor_core_route). Returns cudaGetLastError() after the
// launch (0 on success). Launches on `stream`, does not synchronise,
// allocates nothing. q, k, v, do must be 16-byte aligned for the
// tensor-core kernel's cp.async (the wrapper checks).
extern "C" int tpu_dist_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* m, const void* l,
                                       const void* delta, void* dk, void* dv, int bh, int S,
                                       int D, int in_dtype, int out_dtype, int causal,
                                       void* stream) {
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
        return dkdv_mma_kernel<TO, HD>;
      else
        return dkdv_kernel<float, TO, HD>;
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
        static_cast<const float*>(l), static_cast<const float*>(delta), static_cast<TO*>(dk),
        static_cast<TO*>(dv), S, scale, causal);
    return cudaGetLastError();
  };
  if (flash_mma::tensor_core_route(in_dtype))
    return dispatch_out<__nv_bfloat16>(out_dtype, D, launch);
  if (in_dtype == flash_mma::DTYPE_F32) return dispatch_out<float>(out_dtype, D, launch);
  return cudaErrorInvalidValue;
}
