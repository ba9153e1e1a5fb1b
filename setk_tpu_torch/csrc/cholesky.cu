// Kernels 16 and 17 (sm_90a): loaded Hermitian Cholesky solves of medium
// systems (n <= 128), one system a thread block, over cholesky.cuh.
//
// Kernel 16, hermitian_solve_kernel, replaces setk_tpu/ops/pallas/
// cholesky.py _solve_lanes (:384, body _solve_kernel :39) via
// hermitian_solve_lanes_pallas (:413): a (bins, n, n) complex64,
// hermitianized 0.5 (A + A^H) on load unless the caller vouches that it is
// exactly Hermitian, loaded by (eps_rel / n) tr(A) + EPS; b (bins, n, k)
// complex64 -> x (bins, n, k).  It serves ops/linalg.hermitian_solve on a
// CUDA tensor for 16 <= n <= 128: WPE's tap-matrix scan (8,224 systems of
// 60 x 60 with k = 6 at 32 utterances x 257 bins) and the equilibrated
// solves.
//
// Kernel 17, gram_solve_kernel, replaces cholesky.py solve_wpe_gram_pallas
// (:304, body _gram_solve_kernel :114): the fused WPE loop's solve, read
// straight out of kernel 18's Gram (bins, g, g) complex64: corr =
// gram[row0:row0+n, row0:row0+n], cross = gram[row0:row0+n, 0:k], nothing
// copied.  With `equilibrate` (WPD) the Jacobi scales sc_j = 1 / sqrt(diag)
// (1 where diag <= 1e-30) fold into the reads, the load is eps_rel alone
// (the equilibrated diagonal is 1), and x is unscaled on the way out;
// otherwise the load is (eps_rel / n) tr(corr) + EPS.  x (bins, n, k).
//
// Bound on the card: at the WPE scene (n = 60, k = 6, 8,224 bins) a
// system is ~0.29 MFLOP of factorization and ~0.17 of substitution, ~3.8
// GFLOP in all (~0.06 ms at 67 TFLOP/s f32), against 237 MB of A for
// kernel 16 (~0.07 ms at 3.35 TB/s) and the 170 MB of Gram that kernel 17
// reads.  Neither bound is near: the factorization is a chain of n steps,
// each a barrier and a triangle update that shrinks to nothing, so a block
// is latency-bound and the card fills with blocks instead (the packed
// triangle keeps a 60 x 60 system at 14.6 KB, ~14 blocks an SM).  At
// n = 128 the triangle is 66 KB: above the 48 KB of static shared memory,
// so the launch opts in to dynamic shared memory up to 227 KB.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cholesky.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kTiny = 1e-30f;

// The caller's arrays after chol_solve's: low, y, z, dinv, then sc, load.
struct Smem {
  float2 *low, *y, *z;
  float *dinv, *sc, *load;
};

__device__ Smem carve(float2* base, int n, int k) {
  Smem s;
  s.low = base;
  s.y = s.low + setk::tri(n);
  s.z = s.y + n * k;
  s.dinv = reinterpret_cast<float*>(s.z + n * k);
  s.sc = s.dinv + n;
  s.load = s.sc + n;
  return s;
}

size_t smem_bytes(int n, int k) {
  return setk::chol_smem_bytes(n, k) + sizeof(float) * (n + 1);
}

template <int HERM>
__global__ void __launch_bounds__(kThreads)
hermitian_solve_kernel(const float2* __restrict__ a,
                       const float2* __restrict__ b, float2* __restrict__ x,
                       int n, int k, float eps_rel) {
  extern __shared__ float2 smem[];
  const Smem s = carve(smem, n, k);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float2* ab = a + (size_t)blockIdx.x * n * n;
  for (int i = warp; i < n; i += kThreads / 32) {
    for (int j = lane; j <= i; j += 32) {
      float2 v = ab[i * n + j];
      if (HERM) {
        const float2 u = ab[j * n + i];
        v = make_float2(0.5f * (v.x + u.x), 0.5f * (v.y - u.y));
      }
      s.low[setk::tri(i) + j] = v;
    }
  }
  const float2* bb = b + (size_t)blockIdx.x * n * k;
  for (int i = tid; i < n * k; i += kThreads) s.y[i] = bb[i];
  if (tid == 0) {
    float tr = 0.0f;
    for (int j = 0; j < n; ++j) tr += ab[j * n + j].x;
    *s.load = (eps_rel / n) * tr + setk::kCholEps;
  }
  __syncthreads();
  setk::chol_solve(s.low, s.dinv, s.y, s.z, n, k, *s.load);
  float2* xb = x + (size_t)blockIdx.x * n * k;
  for (int i = tid; i < n * k; i += kThreads) xb[i] = s.y[i];
}

template <int EQ>
__global__ void __launch_bounds__(kThreads)
gram_solve_kernel(const float2* __restrict__ gram, float2* __restrict__ x,
                  int g, int row0, int n, int k, float eps_rel) {
  extern __shared__ float2 smem[];
  const Smem s = carve(smem, n, k);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float2* gb = gram + (size_t)blockIdx.x * g * g;
  const float2* corr = gb + (size_t)row0 * g + row0;
  for (int j = tid; j < n; j += kThreads) {
    const float dj = corr[(size_t)j * g + j].x;
    s.sc[j] = (EQ && dj > kTiny) ? 1.0f / sqrtf(fmaxf(dj, kTiny)) : 1.0f;
  }
  __syncthreads();
  for (int i = warp; i < n; i += kThreads / 32) {
    for (int j = lane; j <= i; j += 32) {
      float2 v = corr[(size_t)i * g + j];
      if (EQ) {
        const float f = s.sc[i] * s.sc[j];
        v = make_float2(v.x * f, v.y * f);
      }
      s.low[setk::tri(i) + j] = v;
    }
  }
  for (int idx = tid; idx < n * k; idx += kThreads) {
    const int i = idx / k, c = idx - i * k;
    const float2 v = gb[(size_t)(row0 + i) * g + c];
    s.y[idx] = make_float2(v.x * s.sc[i], v.y * s.sc[i]);
  }
  if (tid == 0) {
    if (EQ) {
      *s.load = eps_rel;
    } else {
      float tr = 0.0f;
      for (int j = 0; j < n; ++j) tr += corr[(size_t)j * g + j].x;
      *s.load = (eps_rel / n) * tr + setk::kCholEps;
    }
  }
  __syncthreads();
  setk::chol_solve(s.low, s.dinv, s.y, s.z, n, k, *s.load);
  float2* xb = x + (size_t)blockIdx.x * n * k;
  for (int idx = tid; idx < n * k; idx += kThreads) {
    const float f = s.sc[idx / k];
    xb[idx] = make_float2(s.y[idx].x * f, s.y[idx].y * f);
  }
}

template <typename K>
int opt_in(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// a: (bins, n, n) complex64, b and x: (bins, n, k) complex64.
// 1 <= n <= 128, k >= 1 within the 227 KB of shared memory a block has.
extern "C" int hermitian_solve_launch(const void* a, const void* b, void* x,
                                      int bins, int n, int k, float eps_rel,
                                      int hermitianize, void* stream) {
  if (bins < 1 || n < 1 || n > 128 || k < 1) return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(n, k);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto aa = static_cast<const float2*>(a);
  auto bb = static_cast<const float2*>(b);
  auto xx = static_cast<float2*>(x);
  int err;
  if (hermitianize) {
    err = opt_in(hermitian_solve_kernel<1>, bytes);
    if (err != cudaSuccess) return err;
    hermitian_solve_kernel<1><<<bins, kThreads, bytes, st>>>(aa, bb, xx, n,
                                                             k, eps_rel);
  } else {
    err = opt_in(hermitian_solve_kernel<0>, bytes);
    if (err != cudaSuccess) return err;
    hermitian_solve_kernel<0><<<bins, kThreads, bytes, st>>>(aa, bb, xx, n,
                                                             k, eps_rel);
  }
  return cudaGetLastError();
}

// gram: (bins, g, g) complex64; x: (bins, n, k) complex64.
// 1 <= n <= 128, row0 + n <= g, 1 <= k <= g.
extern "C" int gram_solve_launch(const void* gram, void* x, int bins, int g,
                                 int row0, int n, int k, float eps_rel,
                                 int equilibrate, void* stream) {
  if (bins < 1 || n < 1 || n > 128 || k < 1 || row0 < 0 || k > g ||
      row0 + n > g)
    return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(n, k);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto gg = static_cast<const float2*>(gram);
  auto xx = static_cast<float2*>(x);
  int err;
  if (equilibrate) {
    err = opt_in(gram_solve_kernel<1>, bytes);
    if (err != cudaSuccess) return err;
    gram_solve_kernel<1><<<bins, kThreads, bytes, st>>>(gg, xx, g, row0, n,
                                                        k, eps_rel);
  } else {
    err = opt_in(gram_solve_kernel<0>, bytes);
    if (err != cudaSuccess) return err;
    gram_solve_kernel<0><<<bins, kThreads, bytes, st>>>(gg, xx, g, row0, n,
                                                        k, eps_rel);
  }
  return cudaGetLastError();
}
