// AR pairwise regulariser, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pair of
// arvae_tpu/ops/reg_pallas.py::fused_reg_loss (_fwd_kernel, _bwd_kernel).
// Per regularised latent dim r, over a (B,) latent column z and a (B,)
// attribute column a:
//
//   loss_r = 1/B^2 * sum_ij | tanh(delta (z_i - z_j)) - sign(a_i - a_j) |
//
// and, with t = tanh(delta (z_i - z_j)), s = sign(a_i - a_j) and
// g_ij = sign(t - s) (1 - t^2), which is odd under i <-> j:
//
//   dz[r, i] = 2 ct_r / B^2 * sum_j g_ij delta
//   ddelta   = sum_r ct_r / B^2 * sum_ij g_ij (z_i - z_j)
//
// What bounds it: at the training shape (R = 5, B = 128) a call is 82k
// pairs and reads O(R B) bytes, so it is bound by launch latency, not by
// device memory or arithmetic. The design keeps the B^2 pair block out of
// device memory (each thread owns one row i and walks the j columns
// staged in shared memory), and makes a call two small launches.
//
// The TPU kernel carries its sum across sequential grid steps; blocks on
// this card run in parallel and in no order. So each block writes one
// partial sum per (r, block) into a scratch buffer, and a second launch
// adds the partials in a fixed order. There are no float atomics: two
// runs on the same input give bitwise-equal results.
//
// sign(0) = 0 in both directions, written as (x > 0) - (x < 0): the
// diagonal and tied labels (common, since dSprites labels are discrete)
// contribute nothing to the loss or the gradient.
//
// Plain C interface, loaded with ctypes: each entry launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sign_of(float x) {
  return static_cast<float>((x > 0.f) - (x < 0.f));
}

// Fixed-order tree sum over the block; the result is valid in thread 0.
__device__ float block_sum(float v, float* buf) {
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) buf[threadIdx.x] += buf[threadIdx.x + s];
    __syncthreads();
  }
  return buf[0];
}

__device__ __forceinline__ float inv_b2(int b) {
  return static_cast<float>(1.0 / (static_cast<double>(b) * b));
}

// grid (ceil(B / kThreads), R); partials (R, gridDim.x).
__global__ void __launch_bounds__(kThreads)
reg_fwd_partials(const float* __restrict__ z, const float* __restrict__ a,
                 const float* __restrict__ delta_ptr, int b,
                 float* __restrict__ partials) {
  __shared__ float zs[kThreads];
  __shared__ float as[kThreads];
  __shared__ float red[kThreads];
  const int r = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float* zr = z + static_cast<size_t>(r) * b;
  const float* ar = a + static_cast<size_t>(r) * b;
  const float delta = *delta_ptr;
  const bool row_ok = i < b;
  const float zi = row_ok ? zr[i] : 0.f;
  const float ai = row_ok ? ar[i] : 0.f;

  float acc = 0.f;
  for (int j0 = 0; j0 < b; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    zs[threadIdx.x] = j < b ? zr[j] : 0.f;
    as[threadIdx.x] = j < b ? ar[j] : 0.f;
    __syncthreads();
    const int n = min(kThreads, b - j0);
    if (row_ok) {
      for (int k = 0; k < n; ++k) {
        const float t = tanhf(delta * (zi - zs[k]));
        acc += fabsf(t - sign_of(ai - as[k]));
      }
    }
    __syncthreads();
  }
  const float total = block_sum(acc, red);
  if (threadIdx.x == 0) partials[r * gridDim.x + blockIdx.x] = total;
}

// grid (R), one thread each: out[r] = sum of the row's partials / B^2.
__global__ void reg_fwd_finish(const float* __restrict__ partials, int nblk,
                               int b, float* __restrict__ out) {
  const int r = blockIdx.x;
  float s = 0.f;
  for (int k = 0; k < nblk; ++k) s += partials[r * nblk + k];
  out[r] = s * inv_b2(b);
}

// grid (ceil(B / kThreads), R); writes dz directly and one ddelta
// partial per (r, block).
__global__ void __launch_bounds__(kThreads)
reg_bwd_rows(const float* __restrict__ z, const float* __restrict__ a,
             const float* __restrict__ delta_ptr,
             const float* __restrict__ ct, int b, float* __restrict__ dz,
             float* __restrict__ partials) {
  __shared__ float zs[kThreads];
  __shared__ float as[kThreads];
  __shared__ float red[kThreads];
  const int r = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float* zr = z + static_cast<size_t>(r) * b;
  const float* ar = a + static_cast<size_t>(r) * b;
  const float delta = *delta_ptr;
  const bool row_ok = i < b;
  const float zi = row_ok ? zr[i] : 0.f;
  const float ai = row_ok ? ar[i] : 0.f;

  float g = 0.f;   // sum_j g_ij delta
  float gd = 0.f;  // sum_j g_ij (z_i - z_j), the ddelta integrand
  for (int j0 = 0; j0 < b; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    zs[threadIdx.x] = j < b ? zr[j] : 0.f;
    as[threadIdx.x] = j < b ? ar[j] : 0.f;
    __syncthreads();
    const int n = min(kThreads, b - j0);
    if (row_ok) {
      for (int k = 0; k < n; ++k) {
        const float d = zi - zs[k];
        const float t = tanhf(delta * d);
        const float core = sign_of(t - sign_of(ai - as[k])) * (1.f - t * t);
        g += core * delta;
        gd += core * d;
      }
    }
    __syncthreads();
  }
  // antisymmetry g_ji = -g_ij folds the column sum into the row sum
  if (row_ok) dz[static_cast<size_t>(r) * b + i] = 2.f * g * (ct[r] * inv_b2(b));
  const float total = block_sum(gd, red);
  if (threadIdx.x == 0) partials[r * gridDim.x + blockIdx.x] = total;
}

// One thread: ddelta = sum_r ct_r * (sum of the row's partials) / B^2.
__global__ void reg_bwd_finish(const float* __restrict__ partials,
                               const float* __restrict__ ct, int r_dims,
                               int nblk, int b, float* __restrict__ ddelta) {
  float s = 0.f;
  for (int r = 0; r < r_dims; ++r) {
    float dd = 0.f;
    for (int k = 0; k < nblk; ++k) dd += partials[r * nblk + k];
    s += ct[r] * dd;
  }
  *ddelta = s * inv_b2(b);
}

int num_blocks(int b) { return (b + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// Threads per block, so the caller sizes the (R, ceil(B / threads))
// partials buffer from the same constant the launches use.
int reg_loss_threads() { return kThreads; }

const char* reg_loss_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// z, a: (R, B) f32; delta: (1,) f32; partials: (R, ceil(B / threads)) f32
// scratch; out: (R,) f32.
int reg_loss_fwd(const float* z, const float* a, const float* delta,
                 int r_dims, int b, float* partials, float* out,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = num_blocks(b);
  reg_fwd_partials<<<dim3(nblk, r_dims), kThreads, 0, st>>>(z, a, delta, b,
                                                             partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reg_fwd_finish<<<r_dims, 1, 0, st>>>(partials, nblk, b, out);
  return static_cast<int>(cudaGetLastError());
}

// z, a: (R, B) f32; delta: (1,) f32; ct: (R,) f32 cotangent of the
// per-dim losses; dz: (R, B) f32; partials as above; ddelta: (1,) f32.
int reg_loss_bwd(const float* z, const float* a, const float* delta,
                 const float* ct, int r_dims, int b, float* dz,
                 float* partials, float* ddelta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = num_blocks(b);
  reg_bwd_rows<<<dim3(nblk, r_dims), kThreads, 0, st>>>(z, a, delta, ct, b,
                                                         dz, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reg_bwd_finish<<<1, 1, 0, st>>>(partials, ct, r_dims, nblk, b, ddelta);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
