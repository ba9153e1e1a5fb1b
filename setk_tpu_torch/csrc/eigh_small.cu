// Kernel 14 (sm_90a): the eigenvalue-floored inverse of batched small
// Hermitian matrices by cyclic complex Jacobi, one matrix a thread; and
// beside it the batched Hermitian EVD (hermitian_eigh_kernel, below),
// which replaces no TPU kernel.
//
// Replaces setk_tpu/ops/pallas/eigh_small.py _jacobi_flat (:183, body
// _jacobi_kernel :170) via regularized_inverse_pallas (:207), the
// regularized inverse of the clustering EM's scan and of its non-Higuchi
// inits (ops/linalg.regularized_inverse).  a (n, M, M) complex64 ->
// inv (n, M, M) complex64 and logdet (n) f32, M <= 8, `sweeps` sweeps.
// The arithmetic is jacobi.cuh's, shared with kernel 15.
//
// Bound on the card: operations.  At K = 2 classes of B = 128 utterances x
// 257 bins (65,792 matrices of 6 x 6) six sweeps are about 36 kFLOP a
// matrix, ~2.35 GFLOP in all (~0.035 ms at 67 TFLOP/s f32), against 38 MB
// read and written (~0.01 ms).  One thread keeps its matrix, the rotation
// state and the eigenvectors in registers (4 M^2 floats, 144 at M = 6), so
// the sweeps never touch memory; the TPU's entry-major (8, 128) planes have
// no counterpart.  Loads and stores are strided by M^2 complex values
// between threads, a few percent of the time at these sizes.  The CGMM
// CLI's per-utterance resume launches it on 2 x 257 = 514 matrices, where
// the launch lasts one thread's chain of 90 rotations.  Lane groups
// (jacobi_regularized_inverse_group, kernel 15's body) measured slower on
// the H100 at both counts, since the rotation's angle is a serial chain
// that a group does not shorten, and staging each warp's matrices through
// shared memory gained no more than the spread between runs on the EM's
// covariances (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "jacobi.cuh"

namespace {

constexpr int kThreads = 128;

template <int M>
__global__ void __launch_bounds__(kThreads)
regularized_inverse_kernel(const float2* __restrict__ a,
                           float2* __restrict__ inv,
                           float* __restrict__ logdet, int n, int sweeps) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  const float2* src = a + (size_t)idx * M * M;
  float ar[M][M], ai[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const float2 v = src[i * M + j];
      ar[i][j] = v.x;
      ai[i][j] = v.y;
    }
  }
  float ir[M][M], ii[M][M], ld;
  setk::jacobi_regularized_inverse<M>(ar, ai, sweeps, ir, ii, ld);
  float2* dst = inv + (size_t)idx * M * M;
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) dst[i * M + j] = make_float2(ir[i][j], ii[i][j]);
  }
  if (logdet != nullptr) logdet[idx] = ld;
}

// L of herm(B) + (eps_rel * mean(diag) + EPS) I, left-looking: pivot
// d_j = B[j][j] + load - sum_q |L[j][q]|^2, dinv[j] = 1 / sqrtf(d_j),
// L[i][j] = (B[i][j] - sum_q L[i][q] conj(L[j][q])) dinv[j], each sum over
// q = 0, 1, ..., j - 1 in that order; only the strictly lower triangle
// of l is written (the diagonal is 1 / dinv).
template <int M>
__device__ __forceinline__ void loaded_cholesky(const float2* src,
                                                float eps_rel,
                                                float (&l_re)[M][M],
                                                float (&l_im)[M][M],
                                                float (&dinv)[M]) {
  float br[M][M], bi[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const float2 x = src[i * M + j];
      br[i][j] = x.x;
      bi[i][j] = x.y;
    }
  }
  setk::hermitianize<M>(br, bi, l_re, l_im);
  float tr = 0.0f;
#pragma unroll
  for (int i = 0; i < M; ++i) tr += l_re[i][i];
  const float load = eps_rel * (tr / M) + setk::kEps;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    float d = l_re[j][j] + load;
#pragma unroll
    for (int q = 0; q < j; ++q)
      d -= l_re[j][q] * l_re[j][q] + l_im[j][q] * l_im[j][q];
    dinv[j] = 1.0f / sqrtf(d);
#pragma unroll
    for (int i = j + 1; i < M; ++i) {
      float re = l_re[i][j], im = l_im[i][j];
#pragma unroll
      for (int q = 0; q < j; ++q) {
        // L[i][q] conj(L[j][q])
        re -= l_re[i][q] * l_re[j][q] + l_im[i][q] * l_im[j][q];
        im -= l_im[i][q] * l_re[j][q] - l_re[i][q] * l_im[j][q];
      }
      l_re[i][j] = re * dinv[j];
      l_im[i][j] = im * dinv[j];
    }
  }
}

// The batched Hermitian EVD, plain (GEN false) and generalized (GEN true).
//
// Replaces no TPU kernel: on the TPU every EVD of the JAX package is XLA's
// jnp.linalg.eigh (setk_tpu/ops/linalg.py:27-36), which the eigh steer of
// mvdr, gevd, mpdr, mpdr-whiten, the rank-1 approximation, the online
// family and the WPD scan reach through ops/linalg.eigh, generalized_eigh
// and solve_pevd.  On the card those calls come here (M <= 8), since the
// port uses no vendor solver; cuSOLVER's batched eigh has also refused
// 32,768 matrices in one call on the H100 (PERF.md), and a batch of 128
// utterances has 32,896 bins.
//
// GEN false: a (n, M, M) complex64, hermitianized on load, `sweeps` cyclic
// Jacobi sweeps (jacobi.cuh's jacobi_sweeps, kernel 14's rotation with an
// annihilated entry left alone), then w (n, M) f32 ascending and V (n, M, M)
// complex64 with matching columns: the convention of torch.linalg.eigh.
// GEN true: (a, b), the statements of setk_tpu/ops/linalg.py:178-199 in
// registers: L = chol(herm(b) + (eps_rel mean diag + EPS) I) left-looking,
// C = L^{-1} herm(a) L^{-H} (X = L^{-1} herm(a) by forward substitution,
// then C = X L^{-H} by substitution along each row, in place), herm(C),
// the sweeps, V = L^{-H} U by back substitution; eigenvalues ascending,
// v^H B v = I.  A matrix that is not positive definite after the loading
// takes the square root of a negative pivot and comes out NaN, as
// jnp.linalg.cholesky gives it.
//
// The order: column i goes to slot rank_i, the count of eigenvalues below
// w_i with ties broken by index (NaN ranks above everything), so the
// sort needs no runtime register index (those spill) and equal
// eigenvalues keep their order: a zero or scaled-identity matrix stores
// V = I, and its principal vector is e_{M-1}, as LAPACK gives it.
//
// Bound on the card: operations.  At M = 6 eight sweeps are 120
// rotations of ~385 FLOP (_flops_jacobi in chip_smoke.py), ~46 kFLOP a
// matrix against 560 bytes moved; 32,896 matrices (a batch of 128
// utterances) are ~1.5 GFLOP, ~0.02 ms at 67 TFLOP/s f32.  A thread owns
// one matrix in registers (A and V, 4 M^2 floats), as kernel 14: the
// rotation angle is a serial chain that no lane group shortens (kernel
// 14's measurements, PERF.md).  L is not kept through the sweeps: the
// factor is formed again from b for the back substitution, a second read
// of b and ~M^3 / 3 operations, so the sweeps hold only A and V.
template <int M, bool GEN>
__global__ void __launch_bounds__(kThreads)
hermitian_eigh_kernel(const float2* __restrict__ a,
                      const float2* __restrict__ b,
                      float* __restrict__ w_out,
                      float2* __restrict__ v_out, int n, int sweeps,
                      float eps_rel) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  float a_re[M][M], a_im[M][M];
  {
    const float2* src = a + (size_t)idx * M * M;
    float ar[M][M], ai[M][M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const float2 x = src[i * M + j];
        ar[i][j] = x.x;
        ai[i][j] = x.y;
      }
    }
    setk::hermitianize<M>(ar, ai, a_re, a_im);
  }
  if constexpr (GEN) {
    float l_re[M][M], l_im[M][M], dinv[M];
    loaded_cholesky<M>(b + (size_t)idx * M * M, eps_rel, l_re, l_im, dinv);
    // X = L^{-1} A, column by column, in place
#pragma unroll
    for (int j = 0; j < M; ++j) {
#pragma unroll
      for (int i = 0; i < M; ++i) {
        float re = a_re[i][j], im = a_im[i][j];
#pragma unroll
        for (int q = 0; q < i; ++q) {
          re -= l_re[i][q] * a_re[q][j] - l_im[i][q] * a_im[q][j];
          im -= l_re[i][q] * a_im[q][j] + l_im[i][q] * a_re[q][j];
        }
        a_re[i][j] = re * dinv[i];
        a_im[i][j] = im * dinv[i];
      }
    }
    // C = X L^{-H}: each row z of C solves z L^H = x, in place
#pragma unroll
    for (int r = 0; r < M; ++r) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        float re = a_re[r][j], im = a_im[r][j];
#pragma unroll
        for (int q = 0; q < j; ++q) {
          // z_q conj(L[j][q])
          re -= a_re[r][q] * l_re[j][q] + a_im[r][q] * l_im[j][q];
          im -= a_im[r][q] * l_re[j][q] - a_re[r][q] * l_im[j][q];
        }
        a_re[r][j] = re * dinv[j];
        a_im[r][j] = im * dinv[j];
      }
    }
    float c_re[M][M], c_im[M][M];
    setk::hermitianize<M>(a_re, a_im, c_re, c_im);
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        a_re[i][j] = c_re[i][j];
        a_im[i][j] = c_im[i][j];
      }
    }
  }
  float v_re[M][M], v_im[M][M];
  setk::jacobi_sweeps<M, true>(a_re, a_im, v_re, v_im, sweeps);
  if constexpr (GEN) {
    // the factor again, then V = L^{-H} U column by column, in place
    float l_re[M][M], l_im[M][M], dinv[M];
    loaded_cholesky<M>(b + (size_t)idx * M * M, eps_rel, l_re, l_im, dinv);
#pragma unroll
    for (int j = 0; j < M; ++j) {
#pragma unroll
      for (int i = M - 1; i >= 0; --i) {
        float re = v_re[i][j], im = v_im[i][j];
#pragma unroll
        for (int q = i + 1; q < M; ++q) {
          // conj(L[q][i]) x_q
          re -= l_re[q][i] * v_re[q][j] + l_im[q][i] * v_im[q][j];
          im -= l_re[q][i] * v_im[q][j] - l_im[q][i] * v_re[q][j];
        }
        v_re[i][j] = re * dinv[i];
        v_im[i][j] = im * dinv[i];
      }
    }
  }
  // ascending order by rank; NaN sorts last, ties by index
  float key[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float wi = a_re[i][i];
    key[i] = wi != wi ? INFINITY : wi;
  }
  float* w_dst = w_out + (size_t)idx * M;
  float2* v_dst = v_out + (size_t)idx * M * M;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    int rank = 0;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (j != i)
        rank += key[j] < key[i] || (key[j] == key[i] && j < i) ? 1 : 0;
    }
    w_dst[rank] = a_re[i][i];
#pragma unroll
    for (int k = 0; k < M; ++k)
      v_dst[k * M + rank] = make_float2(v_re[k][i], v_im[k][i]);
  }
}

}  // namespace

// a, inv: (n, m, m) complex64; logdet: (n) f32 or null.  1 <= m <= 8,
// sweeps >= 0.
extern "C" int regularized_inverse_launch(const void* a, void* inv,
                                          void* logdet, int n, int m,
                                          int sweeps, void* stream) {
  if (n < 1 || m < 1 || m > 8 || sweeps < 0) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto src = static_cast<const float2*>(a);
  auto dst = static_cast<float2*>(inv);
  auto ld = static_cast<float*>(logdet);
  const int grid = (n + kThreads - 1) / kThreads;
  switch (m) {
#define CASE(mm)                                                          \
  case mm:                                                                \
    regularized_inverse_kernel<mm><<<grid, kThreads, 0, st>>>(src, dst,  \
                                                              ld, n,     \
                                                              sweeps);   \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// a, b: (n, m, m) complex64 (b null: the plain EVD); w: (n, m) f32;
// v: (n, m, m) complex64.  1 <= m <= 8, sweeps >= 0.
extern "C" int hermitian_eigh_launch(const void* a, const void* b, void* w,
                                     void* v, int n, int m, int sweeps,
                                     float eps_rel, void* stream) {
  if (n < 1 || m < 1 || m > 8 || sweeps < 0) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto src = static_cast<const float2*>(a);
  auto bsrc = static_cast<const float2*>(b);
  auto wd = static_cast<float*>(w);
  auto vd = static_cast<float2*>(v);
  const int grid = (n + kThreads - 1) / kThreads;
  switch (m) {
#define CASE(mm)                                                          \
  case mm:                                                                \
    if (bsrc != nullptr)                                                  \
      hermitian_eigh_kernel<mm, true><<<grid, kThreads, 0, st>>>(         \
          src, bsrc, wd, vd, n, sweeps, eps_rel);                         \
    else                                                                  \
      hermitian_eigh_kernel<mm, false><<<grid, kThreads, 0, st>>>(        \
          src, bsrc, wd, vd, n, sweeps, eps_rel);                         \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
