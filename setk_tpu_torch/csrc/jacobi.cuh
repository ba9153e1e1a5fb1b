// Cyclic complex Jacobi EVD with the reference's eigenvalue-floored inverse,
// for one small Hermitian matrix held by one thread (M <= 8).
//
// The arithmetic of setk_tpu/ops/pallas/eigh_small.py
// jacobi_regularized_inverse (:40-167), statement for statement: hermitianize
// on load, a fixed number of cyclic sweeps over the (p, q) pairs, each a
// complex Givens similarity A <- G^H A G applied to the columns, then the
// rows, then V <- V G (jacobi_sweeps); then w = diag(A) / max(max(w), EPS)
// floored at EPS, inv = V diag(1 / w) V^H and logdet = sum log w of the
// scaled spectrum.
// The rotation phase defaults to 1 (not 0) where the off-diagonal is already
// annihilated: with 0 the rotation goes singular and eigenvalues are lost.
// jacobi_regularized_inverse holds the matrix in one thread's registers
// (the statements as the TPU kernel runs them, held by the emulator tests
// against the group's; kernel 14 in eigh_small.cu runs the EVD's
// round-robin sweeps instead); jacobi_regularized_inverse_group spreads the
// same statements over a lane group of a warp, a few rows a lane in
// registers (kernel 15, cacgmm_em.cu).  The plain PyTorch version is
// setk_tpu_torch/ops/cuda/eigh_small.py jacobi_regularized_inverse_plain.
// sqrtf, logf and the divisions are the IEEE ones (no fast-math build);
// 1 / sqrtf stands for the TPU's rsqrt.
#pragma once
#include <cuda_runtime.h>

namespace setk {

constexpr float kEps = 1.1920928955078125e-07f;  // float32 machine epsilon
constexpr float kTiny = 1e-30f;

// hermitianize on load: a[i][j] = (A[i][j] + conj(A[j][i])) / 2
template <int M>
__device__ __forceinline__ void hermitianize(const float (&ar)[M][M],
                                             const float (&ai)[M][M],
                                             float (&a_re)[M][M],
                                             float (&a_im)[M][M]) {
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
}

// V = I, then `sweeps` cyclic sweeps of complex Givens similarities on the
// Hermitian A (diagonalized in place) accumulated into V, so that the
// input equals V diag(A) V^H.  An annihilated off-diagonal still rotates
// by the angle of its diagonal pair (tau = 0 gives 45 degrees on equal
// diagonal entries), harmless to the floored inverse, whose
// V diag(1 / w) V^H does not see a basis of equal eigenvalues.
template <int M>
__device__ __forceinline__ void jacobi_sweeps(float (&a_re)[M][M],
                                              float (&a_im)[M][M],
                                              float (&v_re)[M][M],
                                              float (&v_im)[M][M],
                                              int sweeps) {
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
}

template <int M>
__device__ __forceinline__ void jacobi_regularized_inverse(
    const float (&ar)[M][M], const float (&ai)[M][M], int sweeps,
    float (&inv_re)[M][M], float (&inv_im)[M][M], float& logdet) {
  float a_re[M][M], a_im[M][M], v_re[M][M], v_im[M][M];
  hermitianize<M>(ar, ai, a_re, a_im);
  jacobi_sweeps<M>(a_re, a_im, v_re, v_im, sweeps);

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

// The same floored inverse, spread over a group of G lanes of one warp
// (G a power of 2 up to 8): lane r of the group holds rows r, r + G, ...
// of A and of V in registers.  A rotation's angle is computed by every lane
// from the three entries the owners of rows p and q send (warp shuffles);
// the column update (A <- A G on columns p, q) and V <- V G touch only each
// lane's own rows, entry by entry; the row update (A <- G^H A on rows p,
// q) is made by the owners of rows p and q, each sent the other's row.
// Every entry is the thread version's expression on the same operands, in
// the same cyclic (p, q) order, so the group gives the thread version's
// numbers up to the compiler's contraction choices; nothing goes through
// shared memory.  `in(i, j)` gives entry (i, j) of the input (float2, any
// lane may ask for any entry; hermitianized on load here); `out(i, j, re,
// im)` takes entry (i, j >= i) of the inverse from the lane that holds
// row i.  Returns the log-determinant, summed in the thread version's
// order.  Every lane of the warp must call it together (its shuffles take
// all 32 lanes); a group with `active` false only takes part.
template <int M, int G, typename In, typename Out>
__device__ __forceinline__ float jacobi_regularized_inverse_group(
    In in, int sweeps, int r, bool active, Out out) {
  constexpr int E = (M + G - 1) / G;   // rows a lane
  const int base = (threadIdx.x & 31) - r;
  float ar[E][M], ai[E][M], vr[E][M], vi[E][M];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int k = r + e * G;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      ar[e][j] = ai[e][j] = 0.0f;
      vr[e][j] = j == k ? 1.0f : 0.0f;
      vi[e][j] = 0.0f;
      if (!active || k >= M) continue;
      // hermitianize on load: a[i][j] = (A[i][j] + conj(A[j][i])) / 2
      const float2 x = in(k, j), y = in(j, k);
      if (j > k) {
        ar[e][j] = 0.5f * (x.x + y.x);
        ai[e][j] = 0.5f * (x.y - y.y);
      } else if (j < k) {
        ar[e][j] = 0.5f * (y.x + x.x);
        ai[e][j] = -(0.5f * (y.y - x.y));
      } else {
        ar[e][j] = 0.5f * (x.x + x.x);
      }
    }
  }

#pragma unroll 1
  for (int sweep = 0; sweep < sweeps; ++sweep) {
#pragma unroll
    for (int p = 0; p < M - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < M; ++q) {
        constexpr unsigned all = 0xffffffffu;
        const int lp = base + p % G, lq = base + q % G;
        const float apq_re = __shfl_sync(all, ar[p / G][q], lp);
        const float apq_im = __shfl_sync(all, ai[p / G][q], lp);
        const float app = __shfl_sync(all, ar[p / G][p], lp);
        const float aqq = __shfl_sync(all, ar[q / G][q], lq);
        const float r2 = apq_re * apq_re + apq_im * apq_im;
        const float rr = sqrtf(fmaxf(r2, kTiny));
        // phase e^{i phi} = apq / r, 1 for an annihilated off-diagonal
        const bool safe = r2 > kTiny;
        const float ph_re = safe ? apq_re / rr : 1.0f;
        const float ph_im = safe ? apq_im / rr : 0.0f;
        // real 2x2 [[app, r], [r, aqq]] Jacobi angle
        const float tau = (aqq - app) / (2.0f * rr);
        const float sgn = tau >= 0.0f ? 1.0f : -1.0f;
        const float t = sgn / (fabsf(tau) + sqrtf(1.0f + tau * tau));
        const float c = 1.0f / sqrtf(1.0f + t * t);
        const float s = t * c;
        // G[p][p] = c, G[p][q] = s, G[q][p] = -conj(ph) s, G[q][q] = conj(ph) c
        const float gqp_re = -ph_re * s, gqp_im = ph_im * s;
        const float gqq_re = ph_re * c, gqq_im = -ph_im * c;
        const float gpq_re = s;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          // columns: A <- A G on columns p, q, this lane's rows
          const float akp_re = ar[e][p], akp_im = ai[e][p];
          const float akq_re = ar[e][q], akq_im = ai[e][q];
          ar[e][p] = akp_re * c + akq_re * gqp_re - akq_im * gqp_im;
          ai[e][p] = akp_im * c + akq_re * gqp_im + akq_im * gqp_re;
          ar[e][q] = akp_re * gpq_re + akq_re * gqq_re - akq_im * gqq_im;
          ai[e][q] = akp_im * gpq_re + akq_re * gqq_im + akq_im * gqq_re;
          // V <- V G, this lane's rows
          const float vkp_re = vr[e][p], vkp_im = vi[e][p];
          const float vkq_re = vr[e][q], vkq_im = vi[e][q];
          vr[e][p] = vkp_re * c + vkq_re * gqp_re - vkq_im * gqp_im;
          vi[e][p] = vkp_im * c + vkq_re * gqp_im + vkq_im * gqp_re;
          vr[e][q] = vkp_re * gpq_re + vkq_re * gqq_re - vkq_im * gqq_im;
          vi[e][q] = vkp_im * gpq_re + vkq_re * gqq_im + vkq_im * gqq_re;
        }
        // rows: A <- G^H A on rows p, q; the owner of row p (q) is sent
        // row q (p) entry by entry.  Both rows' entries have the form
        // apk x + aqk y (+/-) aqk z, with (x, y, z) = (c, gqp_re, gqp_im)
        // for row p and (gpq_re, gqq_re, gqq_im) for row q.
        const bool own_p = r == p % G, own_q = r == q % G;
        const float x = own_p ? c : gpq_re;
        const float y = own_p ? gqp_re : gqq_re;
        const float z = own_p ? gqp_im : gqq_im;
#pragma unroll
        for (int k = 0; k < M; ++k) {
          const float own_re = own_p ? ar[p / G][k] : ar[q / G][k];
          const float own_im = own_p ? ai[p / G][k] : ai[q / G][k];
          float apk_re, apk_im, aqk_re, aqk_im;
          if (p % G == q % G) {   // one lane holds both rows
            apk_re = ar[p / G][k];
            apk_im = ai[p / G][k];
            aqk_re = ar[q / G][k];
            aqk_im = ai[q / G][k];
          } else {
            const int from = own_p ? lq : lp;
            const float got_re = __shfl_sync(all, own_re, from);
            const float got_im = __shfl_sync(all, own_im, from);
            apk_re = own_p ? own_re : got_re;
            apk_im = own_p ? own_im : got_im;
            aqk_re = own_p ? got_re : own_re;
            aqk_im = own_p ? got_im : own_im;
          }
          if (p % G == q % G && own_p) {
            ar[p / G][k] = apk_re * c + aqk_re * gqp_re + aqk_im * gqp_im;
            ai[p / G][k] = apk_im * c + aqk_im * gqp_re - aqk_re * gqp_im;
            ar[q / G][k] = apk_re * gpq_re + aqk_re * gqq_re + aqk_im * gqq_im;
            ai[q / G][k] = apk_im * gpq_re + aqk_im * gqq_re - aqk_re * gqq_im;
          } else if (p % G != q % G) {
            const float re = apk_re * x + aqk_re * y + aqk_im * z;
            const float im = apk_im * x + aqk_im * y - aqk_re * z;
            if (own_p) {
              ar[p / G][k] = re;
              ai[p / G][k] = im;
            }
            if (own_q) {
              ar[q / G][k] = re;
              ai[q / G][k] = im;
            }
          }
        }
      }
    }
  }

  // w /= max(max(w), EPS); w = max(w, EPS); inv = V diag(1/w) V^H
  float w[M];
#pragma unroll
  for (int i = 0; i < M; ++i)
    w[i] = __shfl_sync(0xffffffffu, ar[i / G][i], base + i % G);
  float wmax = w[0];
#pragma unroll
  for (int i = 1; i < M; ++i) wmax = fmaxf(wmax, w[i]);
  wmax = fmaxf(wmax, kEps);
  float winv[M];
  float ld = 0.0f;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float wi = fmaxf(w[i] / wmax, kEps);
    ld += logf(wi);
    winv[i] = 1.0f / wi;
  }
#pragma unroll
  for (int j = 0; j < M; ++j) {
    // row j of V to every lane of the group, then entries (i, j), i <= j
    float vj_re[M], vj_im[M];
#pragma unroll
    for (int y = 0; y < M; ++y) {
      vj_re[y] = __shfl_sync(0xffffffffu, vr[j / G][y], base + j % G);
      vj_im[y] = __shfl_sync(0xffffffffu, vi[j / G][y], base + j % G);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = r + e * G;
      if (!active || i > j) continue;
      float acc_re = 0.0f, acc_im = 0.0f;
#pragma unroll
      for (int y = 0; y < M; ++y) {
        // V[i][y] winv[y] conj(V[j][y])
        const float p_re = vr[e][y] * vj_re[y] + vi[e][y] * vj_im[y];
        const float p_im = vi[e][y] * vj_re[y] - vr[e][y] * vj_im[y];
        acc_re += p_re * winv[y];
        acc_im += p_im * winv[y];
      }
      out(i, j, acc_re, acc_im);
    }
  }
  return ld;
}

}  // namespace setk
