// Kernel 15 (sm_90a): the whole CGMM / CACGMM EM loop in one launch.
//
// Replaces setk_tpu/ops/pallas/cacgmm_em.py _em_blocks (:301, body
// _em_kernel :61) via cacgmm_em_pallas (:483) and cgmm_em_pallas (:507).
// One thread owns one (utterance, bin) and runs every iteration:
//   M-step  w[k,t] = (gamma fm / max(kern, EPS)) (M / max(sum_t gamma fm, EPS))
//           R[k]   = sum_t w[k,t] z_t z_t^H        (Im = -sum w Im(conj(z_i) z_j))
//           alpha  = sum_t gamma fm / max(sum_t fm, 1)        (update_alpha)
//   E-step  B[k], logdet[k] = the floored Jacobi inverse of R[k] (jacobi.cuh)
//           quad   = max(z^H B z, EPS), carried as is (cacg) or / M (cg)
//           log_pdf = -M log(quad) - logdet; a max-shifted softmax over k
//           with den >= EPS and gamma clamped to <= 1 (indefinite Rn
//           downstream otherwise); Q += (mx + log den) fm over the frames.
// in the order and with the expressions of _em_kernel.  The two models
// differ only in the carried plane (CGMM takes raw spectra, CACGMM spectra
// L2-normalised over mics by the caller).  With `higuchi` (K = 2) the
// init runs first in the kernel: class 0 the fm-weighted sample covariance
// over max(sum fm, 1), class 1 exactly the identity (inverse I, logdet 0,
// quad sum |z_i|^2, no Jacobi: a Jacobi of an exact identity would rotate),
// then its predict; its Q is not part of the history.  This is the TPU
// kernel's "plane" form (:232-248) at every T.  State out: the last
// iteration's M-step covariances and alpha, and its E-step planes.
//
// Layout: z (M, T, nb) re and im planes, gamma and kern (K, T, nb) planes
// in device memory (in: the operands, out: the last E-step), bins
// innermost so neighbouring threads read neighbouring words; the frame
// mask through its (utterance, bin, frame) strides (a (B, 1, T) mask is
// read with a zero bin stride).  The per-bin Q of every iteration goes to
// q (iters, nb), reduced over bins in PyTorch in a fixed order.
//
// Bound on the card: operations.  At B = 128 x 8 s (32,896 bins, T = 512,
// K = 2, M = 6, 20 iterations) about 620 FLOP a bin, frame and iteration
// plus the Jacobi (~3.5 ms at 67 TFLOP/s f32); reading z once is 0.24 ms.
// This first design reads z twice an iteration (M-step, E-step) and the
// planes three times, ~45 GB a call, from 32,896 threads (about eight
// warps an SM): well above its bound, latency- and bandwidth-held.  The
// per-class sums and packed inverses stay in registers; the Jacobi state
// is a non-inlined call per class and iteration.

#include <cuda_runtime.h>
#include <stdint.h>

#include "jacobi.cuh"

namespace {

constexpr int kThreads = 32;
using setk::kEps;

template <int M>
__device__ __noinline__ void floored_inverse(const float (&cr)[M][M],
                                             const float (&ci)[M][M],
                                             int sweeps, float (&br)[M][M],
                                             float (&bi)[M][M], float& ld) {
  setk::jacobi_regularized_inverse<M>(cr, ci, sweeps, br, bi, ld);
}

template <int M, int K>
struct Em {
  static constexpr int NP = M * (M + 1) / 2;
  const float* zre;
  const float* zim;
  const float* fm;  // at this bin; null: all frames valid
  int64_t fm_ts;
  float* gamma;
  float* kern;
  int nb, T, j, sweeps;
  bool cg;

  __device__ float frame_mask(int t) const {
    return fm == nullptr ? 1.0f : fm[t * fm_ts];
  }
  __device__ size_t at(int row, int t) const {
    return ((size_t)row * T + t) * nb + j;
  }
  __device__ void load_z(int t, float (&zr)[M], float (&zi)[M]) const {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      zr[i] = zre[at(i, t)];
      zi[i] = zim[at(i, t)];
    }
  }

  // Inverse + quadratic + posterior from per-class covariances; writes the
  // gamma and quad planes and returns sum_t log_marg fm.  Class `eye` (or
  // -1) is exactly the identity.
  __device__ float e_step(float (&cr)[K][M][M], float (&ci)[K][M][M],
                          const float (&alpha)[K], int eye) const {
    float bpr[K][NP], bpi[K][NP], logdet[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k == eye) {
        logdet[k] = 0.0f;
        continue;
      }
      float br[M][M], bi[M][M];
      floored_inverse<M>(cr[k], ci[k], sweeps, br, bi, logdet[k]);
      int idx = 0;
#pragma unroll
      for (int i = 0; i < M; ++i) {
#pragma unroll
        for (int c = i; c < M; ++c, ++idx) {
          bpr[k][idx] = br[i][c];
          bpi[k][idx] = bi[i][c];
        }
      }
    }
    float q = 0.0f;
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      float zr[M], zi[M];
      load_z(t, zr, zi);
      float qds[K];
#pragma unroll
      for (int k = 0; k < K; ++k) qds[k] = 0.0f;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const float p_re = zr[i] * zr[i] + zi[i] * zi[i];
        const int d = i * M - i * (i - 1) / 2;  // packed (i, i)
#pragma unroll
        for (int k = 0; k < K; ++k)
          qds[k] += k == eye ? p_re : bpr[k][d] * p_re;
      }
#pragma unroll
      for (int i = 0; i < M; ++i) {
#pragma unroll
        for (int c = i + 1; c < M; ++c) {
          const int idx = i * M - i * (i - 1) / 2 + (c - i);
          const float p_re = zr[i] * zr[c] + zi[i] * zi[c];
          const float p_im = zr[i] * zi[c] - zi[i] * zr[c];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (k == eye) continue;
            // 2 Re(conj(z_i) B_ic z_c) = 2 (Bre Pre - Bim Pim)
            qds[k] += 2.0f * (bpr[k][idx] * p_re - bpi[k][idx] * p_im);
          }
        }
      }
      float quad[K], lp[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        quad[k] = cg ? fmaxf(qds[k], kEps) * (1.0f / M) : fmaxf(qds[k], kEps);
        lp[k] = -(float)M * logf(quad[k]) - logdet[k];
      }
      float mx = lp[0];
#pragma unroll
      for (int k = 1; k < K; ++k) mx = fmaxf(mx, lp[k]);
      float num[K];
#pragma unroll
      for (int k = 0; k < K; ++k) num[k] = expf(lp[k] - mx) * alpha[k];
      float den = num[0];
#pragma unroll
      for (int k = 1; k < K; ++k) den += num[k];
      den = fmaxf(den, kEps);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        gamma[at(k, t)] = fminf(num[k] / den, 1.0f);
        kern[at(k, t)] = quad[k];
      }
      q += (mx + logf(den)) * frame_mask(t);
    }
    return q;
  }

  // Weighted covariances and the alpha update from the gamma and kern
  // planes.
  __device__ void m_step(float fm_den, bool update_alpha, float (&alpha)[K],
                         float (&cr)[K][M][M], float (&ci)[K][M][M]) const {
    float gsum[K];
#pragma unroll
    for (int k = 0; k < K; ++k) gsum[k] = 0.0f;
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      const float f = frame_mask(t);
#pragma unroll
      for (int k = 0; k < K; ++k) gsum[k] += gamma[at(k, t)] * f;
    }
    float scale[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      scale[k] = (float)M / fmaxf(gsum[k], kEps);
      if (update_alpha) alpha[k] = gsum[k] / fm_den;
    }
    float sr[K][NP], si[K][NP];
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int i = 0; i < NP; ++i) sr[k][i] = si[k][i] = 0.0f;
    }
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      const float f = frame_mask(t);
      float w[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        w[k] = (gamma[at(k, t)] * f / fmaxf(kern[at(k, t)], kEps)) * scale[k];
      float zr[M], zi[M];
      load_z(t, zr, zi);
      int idx = 0;
#pragma unroll
      for (int i = 0; i < M; ++i) {
#pragma unroll
        for (int c = i; c < M; ++c, ++idx) {
          const float p_re = zr[i] * zr[c] + zi[i] * zi[c];
          const float p_im = zr[i] * zi[c] - zi[i] * zr[c];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            sr[k][idx] += w[k] * p_re;
            if (c != i) si[k][idx] += w[k] * p_im;
          }
        }
      }
    }
    unpack(sr, si, cr, ci);
  }

  // (re, im) packed upper sums of conj(z_i) z_c -> R = sum z_i conj(z_c):
  // Im negated, the lower triangle filled Hermitian.
  __device__ static void unpack(const float (&sr)[K][NP],
                                const float (&si)[K][NP],
                                float (&cr)[K][M][M], float (&ci)[K][M][M]) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      int idx = 0;
#pragma unroll
      for (int i = 0; i < M; ++i) {
#pragma unroll
        for (int c = i; c < M; ++c, ++idx) {
          cr[k][i][c] = sr[k][idx];
          ci[k][i][c] = -si[k][idx];
          if (c != i) {
            cr[k][c][i] = cr[k][i][c];
            ci[k][c][i] = -ci[k][i][c];
          }
        }
      }
    }
  }

  // Higuchi init covariances: class 0 = sum_t fm z z^H / fm_den, class 1 = I.
  __device__ void higuchi(float fm_den, float (&cr)[K][M][M],
                          float (&ci)[K][M][M]) const {
    float sr[K][NP], si[K][NP];
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int i = 0; i < NP; ++i) sr[k][i] = si[k][i] = 0.0f;
    }
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      const float f = frame_mask(t);
      float zr[M], zi[M];
      load_z(t, zr, zi);
      int idx = 0;
#pragma unroll
      for (int i = 0; i < M; ++i) {
#pragma unroll
        for (int c = i; c < M; ++c, ++idx) {
          sr[0][idx] += f * (zr[i] * zr[c] + zi[i] * zi[c]);
          if (c != i) si[0][idx] += f * (zr[i] * zi[c] - zi[i] * zr[c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      sr[0][i] /= fm_den;
      si[0][i] /= fm_den;
    }
    unpack(sr, si, cr, ci);
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int c = 0; c < M; ++c) {
        cr[1][i][c] = i == c ? 1.0f : 0.0f;
        ci[1][i][c] = 0.0f;
      }
    }
  }
};

template <int M, int K>
__global__ void __launch_bounds__(kThreads)
em_kernel(const float* __restrict__ zre, const float* __restrict__ zim,
          const float* __restrict__ fm, int64_t fm_ls, int64_t fm_fs,
          int64_t fm_ts, float* gamma, float* kern, float* __restrict__ q,
          float2* __restrict__ covar, float* __restrict__ alpha_out, int nb,
          int F, int T, int iters, int cg, int higuchi, int update_alpha,
          int sweeps) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= nb) return;
  Em<M, K> em;
  em.zre = zre;
  em.zim = zim;
  em.fm = fm == nullptr ? nullptr : fm + (j / F) * fm_ls + (j % F) * fm_fs;
  em.fm_ts = fm_ts;
  em.gamma = gamma;
  em.kern = kern;
  em.nb = nb;
  em.T = T;
  em.j = j;
  em.sweeps = sweeps;
  em.cg = cg != 0;

  float fm_sum = 0.0f;
#pragma unroll 1
  for (int t = 0; t < T; ++t) fm_sum += em.frame_mask(t);
  const float fm_den = fmaxf(fm_sum, 1.0f);
  float alpha[K];
#pragma unroll
  for (int k = 0; k < K; ++k) alpha[k] = 1.0f / K;

  float cr[K][M][M], ci[K][M][M];
  if constexpr (K == 2) {
    if (higuchi) {
      em.higuchi(fm_den, cr, ci);
      em.e_step(cr, ci, alpha, 1);
    }
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    em.m_step(fm_den, update_alpha != 0, alpha, cr, ci);
    if (it == iters - 1) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float2* out = covar + ((size_t)k * nb + j) * M * M;
#pragma unroll
        for (int i = 0; i < M; ++i) {
#pragma unroll
          for (int c = 0; c < M; ++c)
            out[i * M + c] = make_float2(cr[k][i][c], ci[k][i][c]);
        }
      }
    }
    q[(size_t)it * nb + j] = em.e_step(cr, ci, alpha, -1);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) alpha_out[(size_t)k * nb + j] = alpha[k];
}

template <int M>
int launch_k(const float* zre, const float* zim, const float* fm,
             int64_t fm_ls, int64_t fm_fs, int64_t fm_ts, float* gamma,
             float* kern, float* q, float2* covar, float* alpha, int nb,
             int F, int T, int K, int iters, int cg, int higuchi,
             int update_alpha, int sweeps, cudaStream_t st) {
  const int grid = (nb + kThreads - 1) / kThreads;
  switch (K) {
#define CASE(kk)                                                            \
  case kk:                                                                  \
    em_kernel<M, kk><<<grid, kThreads, 0, st>>>(                            \
        zre, zim, fm, fm_ls, fm_fs, fm_ts, gamma, kern, q, covar, alpha, nb, \
        F, T, iters, cg, higuchi, update_alpha, sweeps);                     \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// zre, zim: (m, t, nb) f32 planes (bin = l * F + f); fm: f32 at
// [l * fm_ls + f * fm_fs + t * fm_ts], or null for all frames valid;
// gamma, kern: (k, t, nb) f32, the operands on entry unless higuchi, the
// last E-step on exit; q: (iters, nb) f32 per-bin Q; covar: (k, nb, m, m)
// complex64; alpha: (k, nb) f32.  1 <= m <= 8, 1 <= k <= 4, iters >= 1;
// higuchi needs k == 2.
extern "C" int cacgmm_em_launch(const void* zre, const void* zim,
                                const void* fm, int64_t fm_ls, int64_t fm_fs,
                                int64_t fm_ts, void* gamma, void* kern,
                                void* q, void* covar, void* alpha, int nb,
                                int F, int t, int m, int k, int iters, int cg,
                                int higuchi, int update_alpha, int sweeps,
                                void* stream) {
  if (nb < 1 || F < 1 || nb % F != 0 || t < 1 || m < 1 || m > 8 || k < 1 ||
      k > 4 || iters < 1 || sweeps < 0 || (higuchi && k != 2))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto zr = static_cast<const float*>(zre);
  auto zi = static_cast<const float*>(zim);
  auto f = static_cast<const float*>(fm);
  auto g = static_cast<float*>(gamma);
  auto kn = static_cast<float*>(kern);
  auto qq = static_cast<float*>(q);
  auto cv = static_cast<float2*>(covar);
  auto al = static_cast<float*>(alpha);
  switch (m) {
#define CASE(mm)                                                         \
  case mm:                                                               \
    return launch_k<mm>(zr, zi, f, fm_ls, fm_fs, fm_ts, g, kn, qq, cv, al, \
                        nb, F, t, k, iters, cg, higuchi, update_alpha,    \
                        sweeps, st);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}
