// Kernel 13 (sm_90a): masked spatial covariances of one observation
// against K weight classes.
//
// Replaces setk_tpu/ops/pallas/covariance.py masked_covar_pallas (:46, body
// _covar_kernel :25), reached from covar_stats
// (setk_tpu/enhance/beamformer.py:39-93): the clustering EM's M-step
// _weighted_covar (setk_tpu/enhance/cluster.py:62-71) and its inits.
//   y (L, F, N, T) complex64, w (K, L, F, T) f32 ->
//   num[k, l, f] = sum_t w[k, l, f, t] y[l, f, :, t] y[l, f, :, t]^H
// as (K, L, F, N, N) complex64, Hermitian-filled.  The TPU materialises the
// K-fold broadcast of y (beamformer.py:67-70); here y is read once for all
// K classes.  The mask-sum denominator stays in PyTorch, as on the TPU
// (covariance.py:81-82).
//
// Bound on the card: bytes.  At B = 128 utterances x 8 s (F = 257, N = 6,
// T = 512) and K = 2 it reads 808 MB of y and 135 MB of weights (~0.28 ms
// at 3.35 TB/s); about 130 FLOP a frame and bin (~0.07 ms).  One warp owns
// one (l, f) bin: its lanes take frames lane, lane + 32, ..., so every load
// of a mic row is one contiguous 256-byte run, and each lane keeps K N (N+1)/2
// complex partial sums in registers (42 at K = 2, N = 6).  The 32 partials
// are then summed by a butterfly of warp shuffles, the same tree on every
// run: a fixed order and no atomics.  N <= 8 and K <= 4 a launch (the
// wrapper splits larger K); any F and T.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <int N, int K>
__global__ void __launch_bounds__(kThreads)
masked_covar_kernel(const float2* __restrict__ y, const float* __restrict__ w,
                    float2* __restrict__ num, int nbins, int T) {
  constexpr int NP = N * (N + 1) / 2;
  const int lane = threadIdx.x & 31;
  const int bin = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bin >= nbins) return;  // a whole warp leaves together
  const float2* yb = y + (size_t)bin * N * T;

  float acc_re[K][NP], acc_im[K][NP];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int i = 0; i < NP; ++i) acc_re[k][i] = acc_im[k][i] = 0.0f;
  }

  for (int t = lane; t < T; t += 32) {
    float2 x[N];
#pragma unroll
    for (int a = 0; a < N; ++a) x[a] = yb[(size_t)a * T + t];
    float wk[K];
#pragma unroll
    for (int k = 0; k < K; ++k) wk[k] = w[((size_t)k * nbins + bin) * T + t];
    int idx = 0;
#pragma unroll
    for (int a = 0; a < N; ++a) {
#pragma unroll
      for (int c = a; c < N; ++c, ++idx) {
        // y_a conj(y_c); the diagonal is real
        const float pr = x[a].x * x[c].x + x[a].y * x[c].y;
        const float pi = x[a].y * x[c].x - x[a].x * x[c].y;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          acc_re[k][idx] += wk[k] * pr;
          if (c != a) acc_im[k][idx] += wk[k] * pi;
        }
      }
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        acc_re[k][i] += __shfl_xor_sync(0xffffffffu, acc_re[k][i], off);
        acc_im[k][i] += __shfl_xor_sync(0xffffffffu, acc_im[k][i], off);
      }
    }
  }
  if (lane != 0) return;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float2* out = num + ((size_t)k * nbins + bin) * N * N;
    int idx = 0;
#pragma unroll
    for (int a = 0; a < N; ++a) {
#pragma unroll
      for (int c = a; c < N; ++c, ++idx) {
        out[a * N + c] = make_float2(acc_re[k][idx], acc_im[k][idx]);
        if (c != a) out[c * N + a] = make_float2(acc_re[k][idx],
                                                 -acc_im[k][idx]);
      }
    }
  }
}

template <int N>
int launch_k(const float2* y, const float* w, float2* num, int nbins, int T,
             int K, cudaStream_t st) {
  const int grid = (nbins + kWarps - 1) / kWarps;
  switch (K) {
#define CASE(kk)                                                           \
  case kk:                                                                 \
    masked_covar_kernel<N, kk><<<grid, kThreads, 0, st>>>(y, w, num, nbins, \
                                                          T);               \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// y: (nbins, n, t) complex64 (bin = l * F + f); w: (k, nbins, t) f32;
// num: (k, nbins, n, n) complex64.  1 <= n <= 8, 1 <= k <= 4.
extern "C" int masked_covar_launch(const void* y, const void* w, void* num,
                                   int nbins, int n, int t, int k,
                                   void* stream) {
  if (nbins < 1 || n < 1 || n > 8 || t < 1 || k < 1 || k > 4)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto yy = static_cast<const float2*>(y);
  auto ww = static_cast<const float*>(w);
  auto out = static_cast<float2*>(num);
  switch (n) {
#define CASE(nn) \
  case nn: return launch_k<nn>(yy, ww, out, nbins, t, k, st);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}
