// Cyclic complex Jacobi EVD with the reference's eigenvalue-floored inverse,
// for one small Hermitian matrix held by one thread (M <= 8).
//
// The arithmetic of setk_tpu/ops/pallas/eigh_small.py
// jacobi_regularized_inverse (:40-167), statement for statement: hermitianize
// on load, a fixed number of cyclic sweeps over the (p, q) pairs, each a
// complex Givens similarity A <- G^H A G applied to the columns, then the
// rows, then V <- V G; then w = diag(A) / max(max(w), EPS) floored at EPS,
// inv = V diag(1 / w) V^H and logdet = sum log w of the scaled spectrum.
// The rotation phase defaults to 1 (not 0) where the off-diagonal is already
// annihilated: with 0 the rotation goes singular and eigenvalues are lost.
// Shared by kernel 14 (eigh_small.cu) and kernel 15 (cacgmm_em.cu); the
// plain PyTorch version is setk_tpu_torch/ops/cuda/eigh_small.py
// jacobi_regularized_inverse_plain.  sqrtf, logf and the divisions are the
// IEEE ones (no fast-math build); 1 / sqrtf stands for the TPU's rsqrt.
#pragma once
#include <cuda_runtime.h>

namespace setk {

constexpr float kEps = 1.1920928955078125e-07f;  // float32 machine epsilon
constexpr float kTiny = 1e-30f;

template <int M>
__device__ __forceinline__ void jacobi_regularized_inverse(
    const float (&ar)[M][M], const float (&ai)[M][M], int sweeps,
    float (&inv_re)[M][M], float (&inv_im)[M][M], float& logdet) {
  float a_re[M][M], a_im[M][M], v_re[M][M], v_im[M][M];
  // hermitianize on load: a[i][j] = (A[i][j] + conj(A[j][i])) / 2
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = i; j < M; ++j) {
      a_re[i][j] = 0.5f * (ar[i][j] + ar[j][i]);
      a_im[i][j] = 0.5f * (ai[i][j] - ai[j][i]);
      if (j != i) {
        a_re[j][i] = a_re[i][j];
        a_im[j][i] = -a_im[i][j];
      } else {
        a_im[i][i] = 0.0f;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      v_re[i][j] = i == j ? 1.0f : 0.0f;
      v_im[i][j] = 0.0f;
    }
  }

#pragma unroll 1
  for (int sweep = 0; sweep < sweeps; ++sweep) {
#pragma unroll
    for (int p = 0; p < M - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < M; ++q) {
        const float apq_re = a_re[p][q], apq_im = a_im[p][q];
        const float r2 = apq_re * apq_re + apq_im * apq_im;
        const float r = sqrtf(fmaxf(r2, kTiny));
        // phase e^{i phi} = apq / r, 1 for an annihilated off-diagonal
        const bool safe = r2 > kTiny;
        const float ph_re = safe ? apq_re / r : 1.0f;
        const float ph_im = safe ? apq_im / r : 0.0f;
        // real 2x2 [[app, r], [r, aqq]] Jacobi angle
        const float tau = (a_re[q][q] - a_re[p][p]) / (2.0f * r);
        const float sgn = tau >= 0.0f ? 1.0f : -1.0f;
        const float t = sgn / (fabsf(tau) + sqrtf(1.0f + tau * tau));
        const float c = 1.0f / sqrtf(1.0f + t * t);
        const float s = t * c;
        // G[p][p] = c, G[p][q] = s, G[q][p] = -conj(ph) s, G[q][q] = conj(ph) c
        const float gqp_re = -ph_re * s, gqp_im = ph_im * s;
        const float gqq_re = ph_re * c, gqq_im = -ph_im * c;
        const float gpq_re = s;
        // columns: A <- A G on columns p, q
#pragma unroll
        for (int k = 0; k < M; ++k) {
          const float akp_re = a_re[k][p], akp_im = a_im[k][p];
          const float akq_re = a_re[k][q], akq_im = a_im[k][q];
          a_re[k][p] = akp_re * c + akq_re * gqp_re - akq_im * gqp_im;
          a_im[k][p] = akp_im * c + akq_re * gqp_im + akq_im * gqp_re;
          a_re[k][q] = akp_re * gpq_re + akq_re * gqq_re - akq_im * gqq_im;
          a_im[k][q] = akp_im * gpq_re + akq_re * gqq_im + akq_im * gqq_re;
        }
        // rows: A <- G^H A on rows p, q
#pragma unroll
        for (int k = 0; k < M; ++k) {
          const float apk_re = a_re[p][k], apk_im = a_im[p][k];
          const float aqk_re = a_re[q][k], aqk_im = a_im[q][k];
          a_re[p][k] = apk_re * c + aqk_re * gqp_re + aqk_im * gqp_im;
          a_im[p][k] = apk_im * c + aqk_im * gqp_re - aqk_re * gqp_im;
          a_re[q][k] = apk_re * gpq_re + aqk_re * gqq_re + aqk_im * gqq_im;
          a_im[q][k] = apk_im * gpq_re + aqk_im * gqq_re - aqk_re * gqq_im;
        }
        // V <- V G
#pragma unroll
        for (int k = 0; k < M; ++k) {
          const float vkp_re = v_re[k][p], vkp_im = v_im[k][p];
          const float vkq_re = v_re[k][q], vkq_im = v_im[k][q];
          v_re[k][p] = vkp_re * c + vkq_re * gqp_re - vkq_im * gqp_im;
          v_im[k][p] = vkp_im * c + vkq_re * gqp_im + vkq_im * gqp_re;
          v_re[k][q] = vkp_re * gpq_re + vkq_re * gqq_re - vkq_im * gqq_im;
          v_im[k][q] = vkp_im * gpq_re + vkq_re * gqq_im + vkq_im * gqq_re;
        }
      }
    }
  }

  // w /= max(max(w), EPS); w = max(w, EPS); inv = V diag(1/w) V^H
  float wmax = a_re[0][0];
#pragma unroll
  for (int i = 1; i < M; ++i) wmax = fmaxf(wmax, a_re[i][i]);
  wmax = fmaxf(wmax, kEps);
  float winv[M];
  float ld = 0.0f;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float wi = fmaxf(a_re[i][i] / wmax, kEps);
    ld += logf(wi);
    winv[i] = 1.0f / wi;
  }
  logdet = ld;
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = i; j < M; ++j) {
      float acc_re = 0.0f, acc_im = 0.0f;
#pragma unroll
      for (int y = 0; y < M; ++y) {
        // V[i][y] winv[y] conj(V[j][y])
        const float p_re = v_re[i][y] * v_re[j][y] + v_im[i][y] * v_im[j][y];
        const float p_im = v_im[i][y] * v_re[j][y] - v_re[i][y] * v_im[j][y];
        acc_re += p_re * winv[y];
        acc_im += p_im * winv[y];
      }
      inv_re[i][j] = acc_re;
      inv_im[i][j] = acc_im;
      if (j != i) {
        inv_re[j][i] = acc_re;
        inv_im[j][i] = -acc_im;
      }
    }
  }
}

}  // namespace setk
