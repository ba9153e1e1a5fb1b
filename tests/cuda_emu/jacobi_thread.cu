// jacobi.cuh's one-thread statements of the TPU kernel's cyclic Jacobi
// (jacobi_regularized_inverse), a thread a matrix, for the emulator tests:
// the reference that kernel 15's lane-group Jacobi
// (jacobi_regularized_inverse_group) is held to within a few ulps.  Built
// only by tests/test_torch_cuda_emu.py; no kernel of the port runs it.
#include <cuda_runtime.h>

#include "jacobi.cuh"

namespace {

template <int M>
__global__ void jacobi_thread_kernel(const float2* __restrict__ a,
                                     float2* __restrict__ inv,
                                     float* __restrict__ logdet, int n,
                                     int sweeps) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const float2* src = a + (size_t)idx * M * M;
  float ar[M][M], ai[M][M];
  for (int i = 0; i < M; ++i) {
    for (int j = 0; j < M; ++j) {
      ar[i][j] = src[i * M + j].x;
      ai[i][j] = src[i * M + j].y;
    }
  }
  float ir[M][M], ii[M][M], ld;
  setk::jacobi_regularized_inverse<M>(ar, ai, sweeps, ir, ii, ld);
  float2* dst = inv + (size_t)idx * M * M;
  for (int i = 0; i < M; ++i) {
    for (int j = 0; j < M; ++j) dst[i * M + j] = make_float2(ir[i][j], ii[i][j]);
  }
  logdet[idx] = ld;
}

}  // namespace

// a, inv: (n, m, m) complex64; logdet: (n) f32.  1 <= m <= 8.
extern "C" int jacobi_thread_launch(const void* a, void* inv, void* logdet,
                                    int n, int m, int sweeps, void* stream) {
  if (n < 1 || m < 1 || m > 8 || sweeps < 0) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto src = static_cast<const float2*>(a);
  auto dst = static_cast<float2*>(inv);
  auto ld = static_cast<float*>(logdet);
  const int grid = (n + 31) / 32;
  switch (m) {
#define CASE(mm)                                                        \
  case mm:                                                              \
    jacobi_thread_kernel<mm><<<grid, 32, 0, st>>>(src, dst, ld, n,     \
                                                  sweeps);             \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
