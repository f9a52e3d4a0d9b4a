// Pieces shared by the two recurrence kernels (gru_chain.cu and
// hier_tick_chain.cu): torch-exact GRU gate math forward and backward,
// block-wide products of a tile of rows with a weight matrix read from
// global memory (L2-resident), and the fixed-order two-pass reduction
// that sums weight gradients over (t, b).
//
// Gate math, as torch.nn.GRU and arvae_tpu/ops/gru_pallas.py::_gates:
//   r = sigmoid(i_r + h_r), z = sigmoid(i_z + h_z),
//   n = tanh(i_n + r * h_n)   (b_hn rides inside the reset gate),
//   h' = (1 - z) n + z h.
#pragma once

#include <cuda_runtime.h>

namespace arvae {

// Threads of the sequential (time-loop) kernels: one per gate column of
// the per-step (rows x H) @ (H x 3H) product at H = 128.
constexpr int kSeqThreads = 384;
// The largest dynamic shared memory a block may use on Hopper.
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

struct Gates {
  float r, z, n, hn;  // hn = h W_hn + b_hn, kept for the backward
};

__device__ __forceinline__ Gates gru_gates(float ir, float iz, float in, float hr,
                                           float hz, float hn) {
  Gates g;
  g.r = sigmoid_f(ir + hr);
  g.z = sigmoid_f(iz + hz);
  g.n = tanhf(in + g.r * hn);
  g.hn = hn;
  return g;
}

__device__ __forceinline__ float gru_out(const Gates& g, float h) {
  return (1.f - g.z) * g.n + g.z * h;
}

// Backward through one cell (arvae_tpu/ops/gru_pallas.py::_gru_bwd).
// dgi = (dr, dz, dn_pre), dgh = (dr, dz, dn_pre * r); dh_prev is
// dh_z + dgh @ w_hh^T, whose product the caller adds.
struct CellGrads {
  float dr, dz, dn, dgh_n, dh_z;
};

__device__ __forceinline__ CellGrads gru_cell_bwd(float dh, const Gates& g, float h_prev) {
  const float dn = dh * (1.f - g.z);
  const float dzz = dh * (h_prev - g.n);
  const float da_n = dn * (1.f - g.n * g.n);
  const float dr = da_n * g.hn;
  CellGrads o;
  o.dn = da_n;
  o.dgh_n = da_n * g.r;
  o.dz = dzz * g.z * (1.f - g.z);
  o.dr = dr * g.r * (1.f - g.r);
  o.dh_z = dh * g.z;
  return o;
}

// out_s[r * N + k] = sum_j in_s[r * K + j] * W[j * N + k]
//                    (+ bias[k]) (+ row_add[r * add_ld + k] for r < nr)
// for every r < RB and k < N. One thread per output column k, looping
// over the RB rows, so each weight element is read once per block and
// neighbouring threads read neighbouring columns. in_s holds zeros in
// rows past nr, which keeps every output finite.
template <int RB>
__device__ void block_matvec(const float* in_s, int K, const float* __restrict__ W,
                             int N, const float* __restrict__ bias,
                             const float* __restrict__ row_add, int add_ld, int nr,
                             float* out_s) {
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    float acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.f;
    const float* w = W + k;
    if ((K & 3) == 0) {
      for (int j = 0; j < K; j += 4) {
        const float w0 = __ldg(w + static_cast<size_t>(j) * N);
        const float w1 = __ldg(w + static_cast<size_t>(j + 1) * N);
        const float w2 = __ldg(w + static_cast<size_t>(j + 2) * N);
        const float w3 = __ldg(w + static_cast<size_t>(j + 3) * N);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float4 x = *reinterpret_cast<const float4*>(in_s + r * K + j);
          acc[r] = fmaf(x.x, w0, acc[r]);
          acc[r] = fmaf(x.y, w1, acc[r]);
          acc[r] = fmaf(x.z, w2, acc[r]);
          acc[r] = fmaf(x.w, w3, acc[r]);
        }
      }
    } else {
      for (int j = 0; j < K; ++j) {
        const float wj = __ldg(w + static_cast<size_t>(j) * N);
#pragma unroll
        for (int r = 0; r < RB; ++r) acc[r] = fmaf(in_s[r * K + j], wj, acc[r]);
      }
    }
    const float b = bias != nullptr ? bias[k] : 0.f;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float v = acc[r] + b;
      if (row_add != nullptr && r < nr) v += row_add[static_cast<size_t>(r) * add_ld + k];
      out_s[r * N + k] = v;
    }
  }
}

// out[r * ld + j] (+)= sum_k g_s[r * N + k] * W[j * N + k]  (g @ W^T)
// for r < nr, j < M. One warp per output column j: its lanes read row j
// of W with neighbouring lanes on neighbouring addresses, keep a partial
// sum for each of the RB rows, and add the 32 partials with a fixed
// shuffle tree (so the result repeats bitwise). Rows past nr of g_s are
// read but never written out; out may be shared or global memory.
template <int RB>
__device__ void block_matvec_t(const float* g_s, int N, const float* __restrict__ W,
                               int M, int nr, float* out, int ld, bool accumulate) {
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < M; j += blockDim.x >> 5) {
    float acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.f;
    const float* w = W + static_cast<size_t>(j) * N;
    for (int k = lane; k < N; k += 32) {
      const float wk = __ldg(w + k);
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = fmaf(g_s[r * N + k], wk, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      for (int off = 16; off > 0; off >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < nr) {
          float* o = out + static_cast<size_t>(r) * ld + j;
          *o = accumulate ? *o + acc[r] : acc[r];
        }
      }
    }
  }
}

// An operand of the reduction, element (d, t, b, c) at
//   base[d * ds + (t - shift) * ts + b * rs + c],
// where, when base0 is set, the t == 0 slab is base0[d * ds + b * rs + c]
// instead and shift = 1 (the GRU chain's h_{t-1}: h0, then outs[t-1]).
struct Operand {
  const float* base;
  const float* base0;
  long long ds, ts, rs;
};

__device__ __forceinline__ float load_op(const Operand& o, int d, int t, int b, int c) {
  if (o.base0 != nullptr) {
    if (t == 0) return o.base0[d * o.ds + b * o.rs + c];
    return o.base[d * o.ds + (t - 1) * o.ts + b * o.rs + c];
  }
  return o.base[d * o.ds + t * o.ts + b * o.rs + c];
}

constexpr int kRedTile = 32;
constexpr int kRedThreads = 256;
// Terms (t, b) per block of the first pass: a sum over T*B = 6144 terms
// is split into 24 blocks, so that the small reductions (an output of a
// few 32x32 tiles) still spread over the card.
constexpr int kRedChunk = 256;

__host__ __device__ inline int reduce_splits(int T, int B) {
  return static_cast<int>((static_cast<long long>(T) * B + kRedChunk - 1) / kRedChunk);
}

// Floats of scratch that launch_reduce needs for an (M (+1 bias row), N)
// output over D slices.
inline long long reduce_scratch_floats(int M, bool bias, int N, int T, int B, int D) {
  return static_cast<long long>(D) * reduce_splits(T, B) * (M + (bias ? 1 : 0)) * N;
}

// The fixed-order reduction, in two passes:
//   out[d][j][k] = sum_{t < T, b < B} A(d, t, b, j) * X(d, t, b, k),
//   bias[d][k]   = sum_{t, b} X(d, t, b, k)          (when bias is set),
// with A(d, t, b, j) = (tokens[t * B + b] == j) when tokens is set (the
// embedding gradient's one-hot). The first pass, grid (ceil(N / 32),
// ceil(rows / 32), D * S) with rows = M (+1 for the bias), sums chunk s
// of kRedChunk terms in order into partial[d][s][j][k]; each thread owns
// four outputs. The second adds the S partials of each output in order
// of s. So repeats are bitwise equal (no atomics).
__global__ void __launch_bounds__(kRedThreads)
reduce_atb(Operand A, const int* __restrict__ tokens, int M, Operand X, int N, int T,
           int B, int rows, float* __restrict__ partial) {
  __shared__ float as[kRedTile][kRedTile + 1];
  __shared__ float xs[kRedTile][kRedTile + 1];
  const int S = reduce_splits(T, B);
  const int d = blockIdx.z / S;
  const int split = blockIdx.z - d * S;
  const int k0 = blockIdx.x * kRedTile;
  const int j0 = blockIdx.y * kRedTile;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const long long K = static_cast<long long>(T) * B;
  const long long K0 = static_cast<long long>(split) * kRedChunk;
  const long long K1 = K0 + kRedChunk < K ? K0 + kRedChunk : K;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (long long s0 = K0; s0 < K1; s0 += kRedTile) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int sl = ty + 8 * i;
      const long long s = s0 + sl;
      float a = 0.f, x = 0.f;
      if (s < K1) {
        const int t = static_cast<int>(s / B);
        const int b = static_cast<int>(s - static_cast<long long>(t) * B);
        const int j = j0 + tx;
        const int k = k0 + tx;
        if (j < M) {
          a = tokens != nullptr ? (tokens[s] == j ? 1.f : 0.f) : load_op(A, d, t, b, j);
        } else if (j < rows) {
          a = 1.f;  // the bias row
        }
        if (k < N) x = load_op(X, d, t, b, k);
      }
      as[sl][tx] = a;
      xs[sl][tx] = x;
    }
    __syncthreads();
#pragma unroll 8
    for (int sl = 0; sl < kRedTile; ++sl) {
      const float x = xs[sl][tx];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(as[sl][ty + 8 * i], x, acc[i]);
    }
    __syncthreads();
  }
  const int k = k0 + tx;
  if (k >= N) return;
  float* p = partial + static_cast<size_t>(blockIdx.z) * rows * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = j0 + ty + 8 * i;
    if (j < rows) p[static_cast<size_t>(j) * N + k] = acc[i];
  }
}

__global__ void reduce_finish(const float* __restrict__ partial, int S, int rows, int M,
                              int N, float* __restrict__ out, float* __restrict__ bias) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int d = blockIdx.y;
  if (i >= rows * N) return;
  const float* p = partial + static_cast<size_t>(d) * S * rows * N + i;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += p[static_cast<size_t>(s) * rows * N];
  const int j = i / N;
  if (j < M) {
    out[static_cast<size_t>(d) * M * N + i] = acc;
  } else {
    bias[static_cast<size_t>(d) * N + (i - M * N)] = acc;
  }
}

// Launches both passes for D slices; scratch holds reduce_scratch_floats.
// Returns cudaGetLastError().
inline cudaError_t launch_reduce(const Operand& A, const int* tokens, int M,
                                 const Operand& X, int N, int T, int B, int D,
                                 float* out, float* bias, float* scratch, cudaStream_t st) {
  const int rows = M + (bias != nullptr ? 1 : 0);
  const int S = reduce_splits(T, B);
  const dim3 grid((N + kRedTile - 1) / kRedTile, (rows + kRedTile - 1) / kRedTile, D * S);
  reduce_atb<<<grid, kRedThreads, 0, st>>>(A, tokens, M, X, N, T, B, rows, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid2((rows * N + 255) / 256, D);
  reduce_finish<<<grid2, 256, 0, st>>>(scratch, S, rows, M, N, out, bias);
  return cudaGetLastError();
}

}  // namespace arvae
