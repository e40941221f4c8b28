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
// - f32 inputs (serving): flash_fwd_kernel below, f32-accurate products on
//   the TF32 tensor cores (3xTF32).
// - bf16 inputs (training): flash_fwd_mma_kernel further down, products on
//   the bf16 tensor cores; P enters P V as bf16.
//
// flash_fwd_kernel (f32). What bounds it on this card: at the ViT-B/16
// serving shape (BH = 8 * 12, S = 196, D = 64) a call must move ~19 MB
// (q, k, v read once, out, m, l written once): 5.8 us at 3.35 TB/s. Its
// two products are ~0.94 GFLOP: 14 us at the 67 TFLOP/s f32 rate of the
// CUDA cores, or, as three TF32 products each, 2.8 GFLOP, 5.7 us at the
// 495 TFLOP/s of the TF32 tensor cores. On the CUDA cores arithmetic binds,
// and each FMA wants a 4-byte shared-memory operand; above all the [S, S]
// score matrix must never go to device memory, which would multiply the
// bytes.
//
// What the design does about it (FlashAttention-2's forward, as the bf16
// kernel, with 3xTF32 products): one CTA per (bh, 64-row q tile), four
// warps of 16 q rows. Each f32 operand x is split into TF32 parts
// big = tf32(x) and small = tf32(x - big), and a b is taken as
// a_small b_big + a_big b_small + a_big b_big on mma.sync.m16n8k8 with f32
// accumulation: the dropped a_small b_small term and the TF32 rounding of
// the parts leave each product within ~2^-21 of its f32 value, so the
// function stays the f32 one the serving checks hold it to (this is how
// CUTLASS's OpMultiplyAddFastF32 runs f32 GEMMs). Q's A fragments come
// straight from device memory into registers, split once. K and V come in
// 32-row f32 tiles by cp.async, the next tile in flight while this one
// computes; the CTA splits each element once into a second, split tile, so
// a warp's B fragment is one 16-byte shared-memory load ({b0, b1} big,
// then small) with no conversion, and 51 KB of shared memory lets three
// CTAs share an SM at D = 64 (384 CTAs at the serving shape: one wave; the
// register cap this needs, 168, costs 44 bytes of spill). The reduction
// index of a TF32 fragment is permuted (fragment column t takes element
// 2t, column t + 4 element 2t + 1): the S accumulator's elements then sit
// where the P V product's A fragment wants them, so P stays in registers.
// The online softmax runs in registers, a row's four owning lanes
// combining by shuffles. Work that adds exactly nothing is skipped: 8-key
// slabs at or past S (32-key tiles pad S = 196 to 224 keys, not 256), slabs
// wholly above the causal diagonal, and warps whose 16 rows all lie past S
// (3 of the last q tile's 4).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "flash_attention_mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;  // the TPU kernel's fill: keeps exp() NaN-free

// -- 3xTF32 ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small (to ~2^-22 |x|), each part a TF32 value.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d += a b, 16 x 8 x 8, TF32 in, f32 accumulate. Fragments as the PTX ISA's
// "mma.m16n8k8 .tf32": a[0] = (row g, k t), a[1] = (g + 8, t),
// a[2] = (g, t + 4), a[3] = (g + 8, t + 4); b0 = (k t, n g), b1 = (t + 4, g);
// d as flash_mma's acc_row / acc_col.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An f32 A fragment as its TF32 parts.
struct SplitA {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ SplitA split_a(float a0, float a1, float a2, float a3) {
  SplitA s;
  split_tf32(a0, s.big[0], s.small[0]);
  split_tf32(a1, s.big[1], s.small[1]);
  split_tf32(a2, s.big[2], s.small[2]);
  split_tf32(a3, s.big[3], s.small[3]);
  return s;
}

// d += a b to f32 accuracy: three TF32 products, the small terms first. b
// holds a B fragment already split: {b0 big, b1 big, b0 small, b1 small}.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const SplitA& a, const float4& b) {
  const uint32_t b0_big = __float_as_uint(b.x), b1_big = __float_as_uint(b.y);
  mma_tf32(d, a.small, b0_big, b1_big);
  mma_tf32(d, a.big, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(d, a.big, b0_big, b1_big);
}

// {big(x), big(y), small(x), small(y)}: two f32 values of one B fragment,
// split, as one 16-byte shared-memory entry.
__device__ __forceinline__ float4 split_pair(float x, float y) {
  uint32_t xb, xs, yb, ys;
  split_tf32(x, xb, xs);
  split_tf32(y, yb, ys);
  return make_float4(__uint_as_float(xb), __uint_as_float(yb), __uint_as_float(xs),
                     __uint_as_float(ys));
}

constexpr int F32_BLOCK_K = 32;  // keys a tile of the f32 kernel

// Row strides, in 16-byte entries, of the split tiles: the eight lanes of a
// quarter-warp read entries (g, t) of rows g in {0, 1} and entries t in
// 0..3 (K) or rows t and columns g (V) from distinct bank groups.
template <int D>
__host__ __device__ constexpr int k_split_stride() {
  return D / 2 + 4;
}
template <int D>
__host__ __device__ constexpr int v_split_stride() {
  return D + 2;
}

// At D <= 64 three CTAs share an SM: 384 CTAs at the ViT-B/16 serving shape
// are then one wave on 132 SMs, not two.
template <int D>
__host__ __device__ constexpr int fwd_ctas_per_sm() {
  return D <= 64 ? 3 : 1;
}

template <typename TO, int D>
__global__ void __launch_bounds__(flash_mma::THREADS, fwd_ctas_per_sm<D>())
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, TO* __restrict__ out, float* __restrict__ m_out,
                     float* __restrict__ l_out, int S, float scale, int causal) {
  using namespace flash_mma;
  constexpr int BK = F32_BLOCK_K;
  constexpr int LK = k_split_stride<D>();
  constexpr int LV = v_split_stride<D>();
  constexpr int KC = D / 8;      // 8-wide chunks of D: the k steps of Q K^T
  constexpr int NT_S = BK / 8;   // 8-key slabs of a tile: the k steps of P V
  constexpr int NT_O = D / 8;    // 8-column n tiles of an output row
  constexpr int CHUNKS = D / 4;  // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Kraw = reinterpret_cast<float*>(smem_raw);  // [BK][D], as cp.async lands it
  float* Vraw = Kraw + BK * D;                         // [BK][D]
  // K split: entry (key, p) = keys' d 2p, 2p + 1; V split: entry (key pair
  // kp, n) = keys 2kp, 2kp + 1 of column n
  float4* Ksp = reinterpret_cast<float4*>(Vraw + BK * D);  // [BK][LK]
  float4* Vsp = Ksp + BK * LK;                             // [BK / 2][LV]

  const int bh = blockIdx.x;
  const int qt = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t base = (size_t)bh * S * D;
  const int row_w = warp * 16;  // the warp's first row in the tile
  int q_pos[2];                 // this lane's two rows: acc_row(lane, 0) and + 8
  q_pos[0] = qt * BLOCK + row_w + g;
  q_pos[1] = q_pos[0] + 8;
  const bool warp_live = qt * BLOCK + row_w < S;  // some row of the warp is inside S
  const int warp_last_row = qt * BLOCK + row_w + 15;

  int n_k = (S + BK - 1) / BK;
  // tiles wholly above the diagonal (max q_pos < min k_pos) are all masked
  if (causal) n_k = min(n_k, ((qt + 1) * BLOCK - 1) / BK + 1);

  auto load_raw = [&](int kt) {  // rows at or past S zero-filled
    for (int idx = threadIdx.x; idx < 2 * BK * CHUNKS; idx += THREADS) {
      const bool is_v = idx >= BK * CHUNKS;
      const int i = is_v ? idx - BK * CHUNKS : idx;
      const int r = i / CHUNKS;
      const int c = (i % CHUNKS) * 4;
      const int gr = kt * BK + r;
      const bool valid = gr < S;
      cp_async16((is_v ? Vraw : Kraw) + r * D + c,
                 (is_v ? v : k) + base + (size_t)(valid ? gr : 0) * D + c, valid);
    }
    cp_async_commit();
  };
  load_raw(0);

  // Q's A fragments (reduction index permuted), straight from device
  // memory and split once, for the whole K loop; rows past S as zeros
  SplitA qa[KC];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    float2 x[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      x[r] = q_pos[r] < S ? *reinterpret_cast<const float2*>(q + base + (size_t)q_pos[r] * D +
                                                             kc * 8 + 2 * t)
                          : make_float2(0.f, 0.f);
    qa[kc] = split_a(x[0].x, x[1].x, x[0].y, x[1].y);
  }

  float acc[NT_O][4];
#pragma unroll
  for (int nt = 0; nt < NT_O; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF};
  float l_i[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt's raw K, V have landed; the split tiles are free
    // split each K and V element into its TF32 parts once for the CTA
    for (int idx = threadIdx.x; idx < BK * CHUNKS; idx += THREADS) {
      const int r = idx / CHUNKS;
      const int c = (idx % CHUNKS) * 4;
      const float4 x = *reinterpret_cast<const float4*>(Kraw + r * D + c);
      Ksp[r * LK + c / 2] = split_pair(x.x, x.y);
      Ksp[r * LK + c / 2 + 1] = split_pair(x.z, x.w);
    }
    for (int idx = threadIdx.x; idx < (BK / 2) * CHUNKS; idx += THREADS) {
      const int kp = idx / CHUNKS;
      const int c = (idx % CHUNKS) * 4;
      const float4 x = *reinterpret_cast<const float4*>(Vraw + 2 * kp * D + c);
      const float4 y = *reinterpret_cast<const float4*>(Vraw + (2 * kp + 1) * D + c);
      Vsp[kp * LV + c] = split_pair(x.x, y.x);
      Vsp[kp * LV + c + 1] = split_pair(x.y, y.y);
      Vsp[kp * LV + c + 2] = split_pair(x.z, y.z);
      Vsp[kp * LV + c + 3] = split_pair(x.w, y.w);
    }
    __syncthreads();  // the split tiles are ready; the raw tiles are free
    if (kt + 1 < n_k) load_raw(kt + 1);  // flies while this tile computes

    if (warp_live) {
      // an 8-key slab adds exactly nothing when it lies at or past S or
      // wholly above the causal diagonal of this warp's rows
      unsigned slab_live = 0;
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        const int k0 = kt * BK + j * 8;
        slab_live |= (k0 < S && (!causal || k0 <= warp_last_row) ? 1u : 0u) << j;
      }

      // S = Q K^T: 16 x 32 per warp
      float s[NT_S][4];
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
#pragma unroll
        for (int j = 0; j < NT_S; ++j)
          if ((slab_live >> j) & 1u) mma_3xtf32(s[j], qa[kc], Ksp[(j * 8 + g) * LK + kc * 4 + t]);

      // scale and mask; the row max over this tile
      unsigned live = 0;  // bit 4 j + i: score s[j][i] is visible
      float tile_max[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k_pos = kt * BK + j * 8 + acc_col(lane, i);
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

      // acc += P V over each live 8-key slab j: fragment column t is key
      // 2t, column t + 4 key 2t + 1, so P's A fragment is the S
      // accumulator's own elements
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        if (!((slab_live >> j) & 1u)) continue;
        const SplitA a = split_a(s[j][0], s[j][2], s[j][1], s[j][3]);
        const float4* vrow = Vsp + (j * 4 + t) * LV + g;
#pragma unroll
        for (int nt = 0; nt < NT_O; ++nt) mma_3xtf32(acc[nt], a, vrow[nt * 8]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (q_pos[r] >= S) continue;
    const float denom = fmaxf(l_i[r], 1e-30f);
    TO* orow = out + base + (size_t)q_pos[r] * D;
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt)
      store2(orow + nt * 8 + 2 * t, acc[nt][2 * r] / denom, acc[nt][2 * r + 1] / denom);
    if (t == 0) {
      m_out[(size_t)bh * S + q_pos[r]] = m_i[r];
      l_out[(size_t)bh * S + q_pos[r]] = l_i[r];
    }
  }
}

template <int D>
constexpr size_t smem_bytes() {
  // raw K, V tiles (f32), then their split tiles (16-byte entries)
  return sizeof(float) * 2 * F32_BLOCK_K * D +
         sizeof(float4) * (F32_BLOCK_K * k_split_stride<D>() +
                           F32_BLOCK_K / 2 * v_split_stride<D>());
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

// Launch one kernel instance (128 threads) on grid (bh, ceil(S / 64));
// shared memory above 48 KB needs the opt-in first.
template <typename Kern, typename... Args>
cudaError_t launch_kernel(Kern kern, size_t smem, int bh, int S, cudaStream_t stream,
                          Args... args) {
  using flash_mma::BLOCK;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (S + BLOCK - 1) / BLOCK);
  kern<<<grid, flash_mma::THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename TO, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* m, void* l,
                   int bh, int S, int causal, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)D));
  return launch_kernel(flash_fwd_kernel<TO, D>, smem_bytes<D>(), bh, S, stream,
                       static_cast<const float*>(q), static_cast<const float*>(k),
                       static_cast<const float*>(v), static_cast<TO*>(out),
                       static_cast<float*>(m), static_cast<float*>(l), S, scale, causal);
}

template <typename TO, int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, void* m, void* l,
                       int bh, int S, int causal, cudaStream_t stream) {
  using flash_mma::bf16;
  const float scale = (float)(1.0 / sqrt((double)D));
  return launch_kernel(flash_fwd_mma_kernel<TO, D>, mma_smem_bytes<D>(), bh, S, stream,
                       static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v), static_cast<TO*>(out),
                       static_cast<float*>(m), static_cast<float*>(l), S, scale, causal);
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
// take the bf16 tensor-core kernel flash_fwd_mma_kernel, f32 inputs the
// 3xTF32 kernel flash_fwd_kernel (flash_mma::tensor_core_route); either
// writes f32 or bf16 out. Returns cudaGetLastError() after the launch (0 on
// success). Launches on `stream`, does not synchronise, allocates nothing.
// q, k, v must be 16-byte aligned for both kernels' cp.async (the wrapper
// checks).
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
