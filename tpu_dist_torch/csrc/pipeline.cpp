// Native input pipeline: fused gather + pad + random-crop + normalize.
//
// TPU-native replacement for the role torchvision's C extensions play in the
// reference input path (utils/dataset.py:5-9 — RandomCrop(32, padding=4) +
// ToTensor + Normalize, applied per-sample in DataLoader worker processes).
// Here the whole batch transform is one fused, multi-threaded pass over
// uint8 NHWC source images producing the normalized f32 batch the device
// consumes: one read of the source bytes, one write of the output, no
// intermediate arrays, no worker processes.
//
// Determinism: crop offsets come from a per-(seed, batch_index) splitmix64,
// so a given (seed, epoch) reproduces exactly — the per-rank seeding
// semantics of the reference's init_seeds (distributed_mp.py:29-39).
//
// Build: `make -C tpu_dist/csrc` (g++ -O3 -shared -fPIC). Loaded via ctypes
// by tpu_dist/data/native.py; absent .so falls back to the numpy path.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// splitmix64: tiny, high-quality, stateless — one value per (seed, idx).
inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

struct CropJob {
  const uint8_t* images;  // [N_src, H, W, C] uint8
  const int64_t* indices; // [n] gather indices into images
  float* out;             // [n, H, W, C] f32
  int64_t h, w, c;
  int64_t pad;
  uint64_t seed;
  const float* mean;      // [C] in 0..1 scale
  const float* stddev;    // [C]
  bool train;             // train: random crop; eval: identity window
};

void process_range(const CropJob& job, int64_t begin, int64_t end) {
  const int64_t h = job.h, w = job.w, c = job.c, pad = job.pad;
  const int64_t img_sz = h * w * c;
  // Precompute 1/255/std and -mean/std so the inner loop is one fma.
  std::vector<float> scale(c), shift(c);
  for (int64_t ch = 0; ch < c; ++ch) {
    scale[ch] = 1.0f / (255.0f * job.stddev[ch]);
    shift[ch] = -job.mean[ch] / job.stddev[ch];
  }
  for (int64_t i = begin; i < end; ++i) {
    const uint8_t* src = job.images + job.indices[i] * img_sz;
    float* dst = job.out + i * img_sz;
    int64_t dy = 0, dx = 0;
    if (job.train && pad > 0) {
      uint64_t r = splitmix64(job.seed * 0x100000001B3ull + (uint64_t)i);
      dy = (int64_t)(r % (uint64_t)(2 * pad + 1)) - pad;   // offset in [-pad, pad]
      dx = (int64_t)((r >> 32) % (uint64_t)(2 * pad + 1)) - pad;
    }
    for (int64_t y = 0; y < h; ++y) {
      const int64_t sy = y + dy;
      if (sy < 0 || sy >= h) {  // zero padding rows: out = (0 - mean)/std
        for (int64_t x = 0; x < w; ++x)
          for (int64_t ch = 0; ch < c; ++ch)
            dst[(y * w + x) * c + ch] = shift[ch];
        continue;
      }
      for (int64_t x = 0; x < w; ++x) {
        const int64_t sx = x + dx;
        if (sx < 0 || sx >= w) {
          for (int64_t ch = 0; ch < c; ++ch)
            dst[(y * w + x) * c + ch] = shift[ch];
        } else {
          const uint8_t* px = src + (sy * w + sx) * c;
          for (int64_t ch = 0; ch < c; ++ch)
            dst[(y * w + x) * c + ch] = (float)px[ch] * scale[ch] + shift[ch];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns 0 on success. `train` != 0 applies the random crop.
int tpu_dist_augment_batch(
    const uint8_t* images, const int64_t* indices, float* out,
    int64_t n, int64_t h, int64_t w, int64_t c,
    int64_t pad, uint64_t seed, const float* mean, const float* stddev,
    int train, int n_threads) {
  if (!images || !indices || !out || n < 0) return 1;
  CropJob job{images, indices, out, h, w, c, pad, seed, mean, stddev, train != 0};
  int hw = (int)std::thread::hardware_concurrency();
  int nt = n_threads > 0 ? n_threads : (hw > 0 ? hw : 4);
  if (nt > n) nt = (int)(n > 0 ? n : 1);
  if (nt <= 1) {
    process_range(job, 0, n);
    return 0;
  }
  std::vector<std::thread> threads;
  threads.reserve(nt);
  const int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    const int64_t b = t * chunk;
    const int64_t e = b + chunk < n ? b + chunk : n;
    if (b >= e) break;
    threads.emplace_back([&, b, e] { process_range(job, b, e); });
  }
  for (auto& th : threads) th.join();
  return 0;
}

int tpu_dist_pipeline_abi_version() { return 1; }

}  // extern "C"
