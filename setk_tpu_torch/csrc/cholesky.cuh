// Loaded Hermitian Cholesky solve of one medium system (n <= 128) by one
// thread block, in shared memory: the body that kernels 16 (cholesky.cu
// hermitian_solve_kernel) and 17 (cholesky.cu gram_solve_kernel) share.
//
// The arithmetic of setk_tpu/ops/pallas/cholesky.py _solve_kernel (:39) and
// _gram_solve_kernel (:114): pivots 1 / sqrt(max(A[j][j] - sum_q |L[j][q]|^2
// + load, EPS)), L[i][j] = (A[i][j] - sum_q L[i][q] conj(L[j][q])) * pivot,
// then L y = b and L^H x = y.  The TPU runs the factorization left-looking
// over 128 bins in lanes; here a block owns one system and runs it
// right-looking: step j scales column j and subtracts its rank-one term
// from the trailing triangle, so every entry still receives its terms in
// the order q = 0, 1, ..., j - 1 (the TPU's order), and each step is spread
// over the block (a warp a row, lanes over columns) between two barriers.
// Forward substitution is right-looking too (the TPU's order); back
// substitution subtracts x_q for q descending, the TPU ascending.  The
// plain PyTorch version (ops/cuda/cholesky.py _chol_solve_plain) follows
// these orders.  sqrtf and the divisions are the IEEE ones.
//
// Layouts in shared memory: the lower triangle packed by rows,
// low[tri(i) + j] = A[i][j] for j <= i (8 n (n + 1) / 2 bytes, 14.6 KB at
// n = 60, 66 KB at n = 128); the right-hand sides y (n x k, row-major,
// overwritten by the solution) and the scratch z (n x k); dinv (n).
#pragma once
#include <cuda_runtime.h>

namespace setk {

constexpr float kCholEps = 1.1920928955078125e-07f;  // float32 epsilon

__host__ __device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

// Bytes of shared memory chol_solve needs beside its caller's own.
__host__ __device__ inline size_t chol_smem_bytes(int n, int k) {
  return sizeof(float2) * ((size_t)tri(n) + 2 * (size_t)n * k) +
         sizeof(float) * (size_t)n;
}

// Factor the matrix in `low` (lower triangle, packed) loaded by `load` on
// the diagonal, then solve for the k columns of `y`.  Every thread of the
// block calls it; it begins and ends with a barrier.
__device__ void chol_solve(float2* low, float* dinv, float2* y, float2* z,
                           int n, int k, float load) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = (nth + 31) >> 5;
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    const float inv = 1.0f / sqrtf(fmaxf(low[tri(j) + j].x + load,
                                         kCholEps));
    for (int i = j + 1 + tid; i < n; i += nth) {
      float2 v = low[tri(i) + j];
      low[tri(i) + j] = make_float2(v.x * inv, v.y * inv);
    }
    if (tid == 0) dinv[j] = inv;
    __syncthreads();
    // A[i][c] -= L[i][j] conj(L[c][j]) for j < c <= i
    for (int i = j + 1 + warp; i < n; i += nwarp) {
      const float2 lij = low[tri(i) + j];
      float2* row = low + tri(i);
      for (int c = j + 1 + lane; c <= i; c += 32) {
        const float2 lcj = low[tri(c) + j];
        float2 s = row[c];
        s.x -= lij.x * lcj.x + lij.y * lcj.y;
        s.y -= lij.y * lcj.x - lij.x * lcj.y;
        row[c] = s;
      }
    }
    __syncthreads();
  }
  // L y = b: y_q = b_q * dinv[q] into z, then b_i -= L[i][q] y_q, i > q
  for (int q = 0; q < n; ++q) {
    const float inv = dinv[q];
    for (int idx = tid; idx < (n - q - 1) * k; idx += nth) {
      const int i = q + 1 + idx / k, c = idx - (idx / k) * k;
      const float2 b = y[q * k + c];
      const float2 yq = make_float2(b.x * inv, b.y * inv);
      const float2 l = low[tri(i) + q];
      float2 s = y[i * k + c];
      s.x -= l.x * yq.x - l.y * yq.y;
      s.y -= l.x * yq.y + l.y * yq.x;
      y[i * k + c] = s;
    }
    for (int c = tid; c < k; c += nth) {
      const float2 b = y[q * k + c];
      z[q * k + c] = make_float2(b.x * inv, b.y * inv);
    }
    __syncthreads();
  }
  // L^H x = y: x_q = z_q * dinv[q] into y, then z_i -= conj(L[q][i]) x_q
  for (int q = n - 1; q >= 0; --q) {
    const float inv = dinv[q];
    for (int idx = tid; idx < q * k; idx += nth) {
      const int i = idx / k, c = idx - i * k;
      const float2 v = z[q * k + c];
      const float2 xq = make_float2(v.x * inv, v.y * inv);
      const float2 l = low[tri(q) + i];
      float2 s = z[i * k + c];
      s.x -= l.x * xq.x + l.y * xq.y;
      s.y -= l.x * xq.y - l.y * xq.x;
      z[i * k + c] = s;
    }
    for (int c = tid; c < k; c += nth) {
      const float2 v = z[q * k + c];
      y[q * k + c] = make_float2(v.x * inv, v.y * inv);
    }
    __syncthreads();
  }
}

}  // namespace setk
