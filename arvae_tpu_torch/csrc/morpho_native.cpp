// Zhang–Suen batch thinning for the host-side Morpho-MNIST measurement.
//
// A copy of the JAX package's cpp/morpho_native.cpp (ABI version 1):
// the thinning of the upscaled 112x112 binary images in C++, OpenMP over
// the batch, behind a plain C ABI that
// arvae_tpu_torch/data/morphomnist/native.py binds with ctypes.
//
// The algorithm is arvae_tpu_torch/data/morphomnist/morpho.py's numpy
// zhang_suen_thin_numpy() step for step (the same neighbour conditions
// and sub-pass semantics), so both give the same skeleton bit for bit.
// One change from the JAX package's copy: a call on one image runs no
// OpenMP team (`if (n > 1)`). The measurement thins one image a call,
// and starting a team of one thread a core for it cost ~9 ms an image
// against ~0.5 ms without one.

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline uint8_t at(const std::vector<uint8_t>& img, int w, int i, int j) {
  return img[i * w + j];
}

// One Zhang–Suen sub-pass over a padded working copy. Returns true if
// any pixel was deleted. `step` is 0 or 1.
bool thin_subpass(std::vector<uint8_t>& img, int h, int w, int step,
                  std::vector<int>& to_delete) {
  to_delete.clear();
  for (int i = 1; i < h - 1; ++i) {
    for (int j = 1; j < w - 1; ++j) {
      if (!at(img, w, i, j)) continue;
      const uint8_t P2 = at(img, w, i - 1, j);
      const uint8_t P3 = at(img, w, i - 1, j + 1);
      const uint8_t P4 = at(img, w, i, j + 1);
      const uint8_t P5 = at(img, w, i + 1, j + 1);
      const uint8_t P6 = at(img, w, i + 1, j);
      const uint8_t P7 = at(img, w, i + 1, j - 1);
      const uint8_t P8 = at(img, w, i, j - 1);
      const uint8_t P9 = at(img, w, i - 1, j - 1);
      const int B = P2 + P3 + P4 + P5 + P6 + P7 + P8 + P9;
      if (B < 2 || B > 6) continue;
      const uint8_t seq[9] = {P2, P3, P4, P5, P6, P7, P8, P9, P2};
      int A = 0;
      for (int k = 0; k < 8; ++k)
        if (seq[k] == 0 && seq[k + 1] == 1) ++A;
      if (A != 1) continue;
      bool cond;
      if (step == 0)
        cond = (P2 * P4 * P6 == 0) && (P4 * P6 * P8 == 0);
      else
        cond = (P2 * P4 * P8 == 0) && (P2 * P6 * P8 == 0);
      if (cond) to_delete.push_back(i * w + j);
    }
  }
  for (int idx : to_delete) img[idx] = 0;
  return !to_delete.empty();
}

void thin_one(const uint8_t* in, uint8_t* out, int h, int w, int max_iter) {
  // pad by 1 so neighbour reads need no bounds checks
  const int ph = h + 2, pw = w + 2;
  std::vector<uint8_t> img(ph * pw, 0);
  for (int i = 0; i < h; ++i)
    std::memcpy(&img[(i + 1) * pw + 1], &in[i * w], w);
  std::vector<int> scratch;
  scratch.reserve(256);
  for (int it = 0; it < max_iter; ++it) {
    const bool c0 = thin_subpass(img, ph, pw, 0, scratch);
    const bool c1 = thin_subpass(img, ph, pw, 1, scratch);
    if (!c0 && !c1) break;
  }
  for (int i = 0; i < h; ++i)
    std::memcpy(&out[i * w], &img[(i + 1) * pw + 1], w);
}

}  // namespace

extern "C" {

// in/out: (n, h, w) uint8 binary images (0/1), out preallocated.
void zhang_suen_thin_batch(const uint8_t* in, uint8_t* out, int n, int h,
                           int w, int max_iter) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic) if (n > 1)
#endif
  for (int k = 0; k < n; ++k)
    thin_one(in + (size_t)k * h * w, out + (size_t)k * h * w, h, w, max_iter);
}

int morpho_native_abi_version(void) { return 1; }

}  // extern "C"
