// Masked covariance pair from materialized spectra (sm_90a): kernels 11
// and 12 as one templated kernel.
//
// Replaces setk_tpu/ops/pallas/covariance_pair.py:
//   pair_covar_complement_pallas (:105, body _pair_kernel_complement :70),
//     mask_n = max(1 - m, 0) [t < n_valid_t] formed in the kernel (the
//     planar path's default complement, one mask read);
//   pair_covar_pallas (:139, body _pair_kernel :42), mask_n read (the
//     spectrum-domain supervised run's compute_covar_pair, any mask_n).
// obs (B, N, T, F) complex as re and im planes (kernel 11: two f32
// planes) or interleaved complex64 (kernel 12: re = base, im = base + 1,
// element stride 2), masks (B, T, F) f32 addressed through their batch
// and frame strides (the planar path hands the first n_fft/2 columns of
// the (B, T, n_fft/2 + 1) mask without a copy) -> the unnormalized
// numerators
//   Rs[b,a,c,f] = sum_t m y_a conj(y_c),  Rn = sum_t mask_n y_a conj(y_c)
// as four (B, N, N, F) f32 planes, Hermitian-filled.  Each mask multiplies
// the pair product before the sum: Rn is the literal sum of (1 - m) y y^H,
// never total minus masked (doc/KERNELS.md:135-137).
//
// Bound on the card: bytes.  At B=128, N=6, n_fft 1024, T=251 kernel 11
// reads 790 MB of planes and 66 MB of mask and writes 38 MB (~0.27 ms at
// 3.35 TB/s); at n_fft 512, hop 128, T=1001 kernel 12 reads 1.58 GB of
// spectrum and 263 MB of masks (~0.55 ms).  One thread owns one
// (utterance, bin) and walks the frames in order, so the sum over T has a
// fixed order and no atomics; its N (N+1)/2 pair sums for each of Rs and
// Rn stay in registers (21 complex each at N = 6, 36 at N = 8).  Threads
// of a warp own neighbouring bins, so every load of a frame is one
// contiguous run of the plane.  The TPU kernel's F padding to 128 lanes
// has no counterpart: any F and T.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

struct cpx {
  float re, im;
};

template <int N, bool kComplement>
__global__ void __launch_bounds__(kThreads)
pair_covar_kernel(const float* __restrict__ re, const float* __restrict__ im,
                  int es, const float* __restrict__ ms,
                  const float* __restrict__ mn, int m_bstride, int m_tstride,
                  float* __restrict__ rs_re, float* __restrict__ rs_im,
                  float* __restrict__ rn_re, float* __restrict__ rn_im, int T,
                  int F, int n_valid_t) {
  constexpr int NP = N * (N + 1) / 2;
  const int b = blockIdx.y;
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= F) return;
  const size_t plane = (size_t)T * F;  // one mic's (T, F) plane
  const size_t obs0 = (size_t)b * N * plane + f;
  const size_t m0 = (size_t)b * m_bstride + f;

  cpx acc_s[NP], acc_n[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) acc_s[i] = acc_n[i] = {0.0f, 0.0f};

#pragma unroll 2
  for (int t = 0; t < T; ++t) {
    const size_t mi = m0 + (size_t)t * m_tstride;
    const float m = ms[mi];
    float mnv;
    if (kComplement) mnv = t < n_valid_t ? fmaxf(1.0f - m, 0.0f) : 0.0f;
    else mnv = mn[mi];
    cpx X[N];
#pragma unroll
    for (int a = 0; a < N; ++a) {
      const size_t idx = (obs0 + a * plane + (size_t)t * F) * es;
      X[a] = {re[idx], im[idx]};
    }
    int idx = 0;
#pragma unroll
    for (int a = 0; a < N; ++a) {
#pragma unroll
      for (int c = a; c < N; ++c, ++idx) {
        // X_a conj(X_c); the diagonal is real
        const float pr = X[a].re * X[c].re + X[a].im * X[c].im;
        acc_s[idx].re += m * pr;
        acc_n[idx].re += mnv * pr;
        if (c != a) {
          const float pi = X[a].im * X[c].re - X[a].re * X[c].im;
          acc_s[idx].im += m * pi;
          acc_n[idx].im += mnv * pi;
        }
      }
    }
  }

  const size_t out0 = (size_t)b * N * N * F + f;
  int idx = 0;
#pragma unroll
  for (int a = 0; a < N; ++a) {
#pragma unroll
    for (int c = a; c < N; ++c, ++idx) {
      const size_t up = out0 + (size_t)(a * N + c) * F;
      const size_t lo = out0 + (size_t)(c * N + a) * F;
      rs_re[up] = acc_s[idx].re;
      rs_im[up] = acc_s[idx].im;
      rn_re[up] = acc_n[idx].re;
      rn_im[up] = acc_n[idx].im;
      if (c != a) {
        rs_re[lo] = acc_s[idx].re;
        rs_im[lo] = -acc_s[idx].im;
        rn_re[lo] = acc_n[idx].re;
        rn_im[lo] = -acc_n[idx].im;
      }
    }
  }
}

template <bool kComplement>
int launch(const float* re, const float* im, int es, const float* ms,
           const float* mn, int m_bstride, int m_tstride, float* rs_re,
           float* rs_im, float* rn_re, float* rn_im, int B, int N, int T,
           int F, int n_valid_t, cudaStream_t st) {
  dim3 grid((F + kThreads - 1) / kThreads, B);
  switch (N) {
#define CASE(n)                                                              \
  case n:                                                                    \
    pair_covar_kernel<n, kComplement><<<grid, kThreads, 0, st>>>(           \
        re, im, es, ms, mn, m_bstride, m_tstride, rs_re, rs_im, rn_re,       \
        rn_im, T, F, n_valid_t);                                             \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// re, im: obs (B, N, T, F) at element stride es (1: two f32 planes, 2:
// interleaved complex64 with im = re + 1); ms, mn: masks (B, T, F) f32 at
// [b * m_bstride + t * m_tstride + f] (mn unused with complement = 1,
// where mask_n = max(1 - ms, 0) for t < n_valid_t and 0 after);
// rs_re, rs_im, rn_re, rn_im: (B, N, N, F) f32.  1 <= N <= 8.
extern "C" int pair_covar_launch(const void* re, const void* im, int es,
                                 const void* ms, const void* mn,
                                 int m_bstride, int m_tstride, void* rs_re,
                                 void* rs_im, void* rn_re, void* rn_im, int B,
                                 int N, int T, int F, int n_valid_t,
                                 int complement, void* stream) {
  if (B < 1 || N < 1 || N > 8 || T < 1 || F < 1 || (es != 1 && es != 2) ||
      m_tstride < F || m_bstride < (T - 1) * m_tstride + F ||
      (!complement && mn == nullptr))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto r = static_cast<const float*>(re);
  auto i = static_cast<const float*>(im);
  auto s = static_cast<const float*>(ms);
  auto n = static_cast<const float*>(mn);
  auto a = static_cast<float*>(rs_re);
  auto c = static_cast<float*>(rs_im);
  auto d = static_cast<float*>(rn_re);
  auto e = static_cast<float*>(rn_im);
  return complement ? launch<true>(r, i, es, s, n, m_bstride, m_tstride, a, c,
                                   d, e, B, N, T, F, n_valid_t, st)
                    : launch<false>(r, i, es, s, n, m_bstride, m_tstride, a,
                                    c, d, e, B, N, T, F, n_valid_t, st);
}
