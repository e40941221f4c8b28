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
// b are updated in place. lr is read from a device scalar, so a changing
// learning rate never changes the launch and a later CUDA graph stays valid.
//
// What bounds it on this card: bytes. Each parameter costs 20 bytes (p, g, b
// read once, p, b written once) against 6 operations: ViT-B/16's 86,566,120
// parameters are 1.73 GB, 0.52 ms at 3.35 TB/s.
//
// What the design does about it: one launch over all leaves (apex's
// multi-tensor apply). A device table holds each leaf's p, g, b pointers,
// its length and its first chunk; each CTA binary-searches the table for
// its chunk of 64 Ki elements and streams it with 16-byte loads and stores
// (scalar ones for a misaligned leaf and for the tail), neighbouring
// threads on neighbouring addresses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long CHUNK = 1 << 16;  // elements per CTA

__device__ __forceinline__ void update(float& p, float g, float& b, float lr, float mu,
                                       float wd) {
  const float g2 = __fadd_rn(g, __fmul_rn(wd, p));
  b = __fadd_rn(__fmul_rn(mu, b), g2);
  p = __fsub_rn(p, __fmul_rn(lr, b));
}

// table: [p pointers | g pointers | b pointers | lengths | first chunks], each
// n_leaves int64 entries, leaf order.
__global__ void __launch_bounds__(THREADS)
    fused_sgd_kernel(const long long* __restrict__ table, int n_leaves,
                     const float* __restrict__ lr_ptr, float mu, float wd) {
  const long long* first = table + 4 * (size_t)n_leaves;
  const long long blk = blockIdx.x;
  // the leaf of this chunk: the last one whose first chunk is <= blk (a
  // leaf of length 0 owns no chunk and is never picked)
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (first[mid] <= blk) lo = mid;
    else hi = mid - 1;
  }
  float* p = reinterpret_cast<float*>(table[lo]);
  const float* g = reinterpret_cast<const float*>(table[n_leaves + lo]);
  float* b = reinterpret_cast<float*>(table[2 * (size_t)n_leaves + lo]);
  const long long n = table[3 * (size_t)n_leaves + lo];
  const long long start = (blk - first[lo]) * CHUNK;
  const long long end = min(start + CHUNK, n);
  const float lr = *lr_ptr;

  long long tail = start;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
        reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  if (aligned) {  // start is a multiple of 4, so every float4 is aligned
    const long long n4 = (end - start) / 4;
    float4* p4 = reinterpret_cast<float4*>(p + start);
    const float4* g4 = reinterpret_cast<const float4*>(g + start);
    float4* b4 = reinterpret_cast<float4*>(b + start);
    for (long long i = threadIdx.x; i < n4; i += THREADS) {
      float4 pv = p4[i], bv = b4[i];
      const float4 gv = g4[i];
      update(pv.x, gv.x, bv.x, lr, mu, wd);
      update(pv.y, gv.y, bv.y, lr, mu, wd);
      update(pv.z, gv.z, bv.z, lr, mu, wd);
      update(pv.w, gv.w, bv.w, lr, mu, wd);
      p4[i] = pv;
      b4[i] = bv;
    }
    tail = start + 4 * n4;
  }
  for (long long e = tail + threadIdx.x; e < end; e += THREADS) {
    float pv = p[e], bv = b[e];
    update(pv, g[e], bv, lr, mu, wd);
    p[e] = pv;
    b[e] = bv;
  }
}

}  // namespace

// table: device int64 [5 * n_leaves] as above; n_chunks = the sum over leaves
// of ceil(length / 65536); lr: device float32 scalar. Returns
// cudaGetLastError() after the launch (0 on success). Launches on
// `stream`, does not synchronise, allocates nothing.
extern "C" int tpu_dist_fused_sgd(const void* table, int n_leaves, long long n_chunks,
                                  const void* lr, float momentum, float weight_decay,
                                  void* stream) {
  if (n_leaves <= 0 || n_chunks <= 0 || n_chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fused_sgd_kernel<<<(unsigned)n_chunks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), n_leaves, static_cast<const float*>(lr), momentum,
      weight_decay);
  return cudaGetLastError();
}
