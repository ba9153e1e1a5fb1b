// Kernel 14 (sm_90a): the eigenvalue-floored inverse of batched small
// Hermitian matrices by cyclic complex Jacobi, one matrix a thread.
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
