// Fused SGD + momentum + weight decay over every parameter leaf in one
// launch, for Hopper (sm_90a), f32.
//
// Replaces: tpu_dist/ops/fused_sgd.py::_kernel, the Pallas TPU kernel that
// fused_sgd_leaf launches once per leaf from train/optim.py::SGD. Same
// arithmetic, per element, in f32:
//     g' = g + wd * p;   b' = mu * b + g';   p' = p - lr * b'
// written with __fmul_rn / __fadd_rn / __fsub_rn so nvcc contracts nothing
// into an FMA: each of the six operations rounds once, as the plain PyTorch
// version (six eager operations) does, and the two agree bit for bit. p and
// b are updated in place. lr is read from a device scalar (or passed by
// value when the caller has a float), so a changing learning rate never
// changes the launch and a CUDA graph of it stays valid.
//
// What bounds it on this card: bytes. Each parameter costs 20 bytes (p, g, b
// read once, p, b written once) against 6 operations: ViT-B/16's 86,566,120
// parameters are 1.73 GB, 0.52 ms at 3.35 TB/s; ResNet-18's 11,220,132 are
// 224 MB, 0.067 ms.
//
// What the design does about it:
// - Small tiles (TILE elements, a multiple of 4; a leaf's last tile covers
//   its remainder) walked by a grid of CTAS_PER_SM CTAs a streaming
//   multiprocessor (the SM count read from the device, never written here),
//   each striding over the tiles, so every SM streams until the work runs
//   out, and a 100-element bias costs one loop iteration, not a CTA.
// - Each thread issues VEC 16-byte loads of each of p, g and b before any
//   arithmetic, with streaming cache hints (nothing is reused in the step).
// - The leaf table (pointers, lengths, first tiles) is a __grid_constant__
//   kernel parameter, copied from the host with the launch: nothing is
//   copied to the device beforehand and nothing is allocated, so the launch
//   can be captured in a CUDA graph. A CTA's tiles rise, so it finds each
//   one's leaf by walking the prefix counts forward.
// - A leaf whose p, g or b is not 16-byte aligned, and the last 1-3
//   elements of a leaf, take a scalar path.
//
// The three sizes below were chosen by measuring at both training paths'
// leaves (`python -m tpu_dist_torch.obs.fused_sgd_bench --sweep`, which
// rebuilds this file with other values by -D); ops/fused_sgd.py plans for
// the same TILE and MAX_LEAVES, and the entry point refuses a table whose
// tile counts were planned for another TILE.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef FUSED_SGD_VEC
#define FUSED_SGD_VEC 4  // float4 of each of p, g, b a thread a tile
#endif
#ifndef FUSED_SGD_CTAS_PER_SM
#define FUSED_SGD_CTAS_PER_SM 6
#endif
#ifndef FUSED_SGD_MAX_LEAVES
#define FUSED_SGD_MAX_LEAVES 768  // the largest table a launch takes
#endif

namespace {

constexpr int THREADS = 256;
constexpr int VEC = FUSED_SGD_VEC;
constexpr long long TILE = THREADS * 4 * VEC;  // 4,096 elements
constexpr int CTAS_PER_SM = FUSED_SGD_CTAS_PER_SM;
constexpr int MAX_LEAVES = FUSED_SGD_MAX_LEAVES;
constexpr int MAX_DEVICES = 64;

// A launch's leaves: `first[i]` is leaf i's first tile and `first[n_leaves]`
// the number of tiles; 40 bytes a leaf, within the 32,764 bytes of
// parameters that CUDA 12.1+ allows a kernel on sm_70 and up.
struct LeafTable {
  long long first[MAX_LEAVES + 1];
  long long n[MAX_LEAVES];
  float* p[MAX_LEAVES];
  const float* g[MAX_LEAVES];
  float* b[MAX_LEAVES];
  int n_leaves;
};
static_assert(sizeof(LeafTable) + 32 <= 32764, "kernel parameters over CUDA's limit");

__device__ __forceinline__ void update(float& p, float g, float& b, float lr, float mu,
                                       float wd) {
  const float g2 = __fadd_rn(g, __fmul_rn(wd, p));
  b = __fadd_rn(__fmul_rn(mu, b), g2);
  p = __fsub_rn(p, __fmul_rn(lr, b));
}

__device__ __forceinline__ void update4(float4& p, const float4& g, float4& b, float lr, float mu,
                                        float wd) {
  update(p.x, g.x, b.x, lr, mu, wd);
  update(p.y, g.y, b.y, lr, mu, wd);
  update(p.z, g.z, b.z, lr, mu, wd);
  update(p.w, g.w, b.w, lr, mu, wd);
}

__global__ void __launch_bounds__(THREADS)
    fused_sgd_kernel(const __grid_constant__ LeafTable t, const float* __restrict__ lr_ptr,
                     float lr_value, float mu, float wd) {
  const float lr = lr_ptr ? __ldg(lr_ptr) : lr_value;
  const long long n_tiles = t.first[t.n_leaves];
  int leaf = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    while (t.first[leaf + 1] <= tile) ++leaf;  // tiles rise: walk forward
    const long long start = (tile - t.first[leaf]) * TILE;
    const int len = (int)min(TILE, t.n[leaf] - start);
    float* p = t.p[leaf] + start;
    const float* g = t.g[leaf] + start;
    float* b = t.b[leaf] + start;
    int tail = 0;
    // start is a multiple of TILE, so of 4: an aligned leaf's tiles are too
    if (((reinterpret_cast<uintptr_t>(t.p[leaf]) | reinterpret_cast<uintptr_t>(t.g[leaf]) |
          reinterpret_cast<uintptr_t>(t.b[leaf])) & 15) == 0) {
      const int n4 = len / 4;
      float4* p4 = reinterpret_cast<float4*>(p);
      const float4* g4 = reinterpret_cast<const float4*>(g);
      float4* b4 = reinterpret_cast<float4*>(b);
      float4 pv[VEC], gv[VEC], bv[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const int i = threadIdx.x + k * THREADS;
        if (i < n4) {
          pv[k] = __ldcs(p4 + i);
          gv[k] = __ldcs(g4 + i);
          bv[k] = __ldcs(b4 + i);
        }
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const int i = threadIdx.x + k * THREADS;
        if (i < n4) {
          update4(pv[k], gv[k], bv[k], lr, mu, wd);
          __stcs(p4 + i, pv[k]);
          __stcs(b4 + i, bv[k]);
        }
      }
      tail = 4 * n4;
    }
    for (int e = tail + threadIdx.x; e < len; e += THREADS) {
      float pv = p[e], bv = b[e];
      update(pv, g[e], bv, lr, mu, wd);
      p[e] = pv;
      b[e] = bv;
    }
  }
}

}  // namespace

// table: HOST int64 [5 * n_leaves + 1]: [first tiles (n_leaves + 1, the
// last being the number of tiles) | lengths | p pointers | g pointers | b
// pointers], leaf order, every length > 0, first tiles counted in TILE;
// lr: a device float32 scalar, or null to take lr_value; device: the card
// the pointers and the stream belong to. Launches one kernel of
// min(tiles, CTAS_PER_SM x SMs) CTAs on `stream` (the table travels as its
// parameter), does not synchronise, allocates nothing. Returns
// cudaErrorInvalidValue for a table it cannot take, else cudaGetLastError()
// after the launch (0 on success).
extern "C" int tpu_dist_fused_sgd(const long long* table, int n_leaves, const float* lr,
                                  float lr_value, float momentum, float weight_decay, int device,
                                  void* stream) {
  if (n_leaves <= 0 || n_leaves > MAX_LEAVES || device < 0 || device >= MAX_DEVICES)
    return cudaErrorInvalidValue;
  LeafTable t;
  t.n_leaves = n_leaves;
  t.first[0] = table[0];
  for (int i = 0; i < n_leaves; ++i) {
    t.first[i + 1] = table[i + 1];
    t.n[i] = table[n_leaves + 1 + i];
    if (t.n[i] <= 0 || t.first[i + 1] - t.first[i] != (t.n[i] + TILE - 1) / TILE)
      return cudaErrorInvalidValue;  // planned for another TILE, or an empty leaf
    t.p[i] = reinterpret_cast<float*>(table[2 * n_leaves + 1 + i]);
    t.g[i] = reinterpret_cast<const float*>(table[3 * n_leaves + 1 + i]);
    t.b[i] = reinterpret_cast<float*>(table[4 * n_leaves + 1 + i]);
  }
  if (t.first[0] != 0) return cudaErrorInvalidValue;
  static int sms[MAX_DEVICES];  // per device, read once
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return err;
  if (sms[device] == 0)
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    const long long n_tiles = t.first[n_leaves];
    const long long most = (long long)CTAS_PER_SM * sms[device];
    fused_sgd_kernel<<<(unsigned)(n_tiles < most ? n_tiles : most), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(t, lr, lr_value, momentum,
                                                            weight_decay);
    err = cudaGetLastError();
  }
  if (current != device) cudaSetDevice(current);
  return err;
}
