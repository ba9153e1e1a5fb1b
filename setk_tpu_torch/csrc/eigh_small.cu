// Kernel 14 (sm_90a): the eigenvalue-floored inverse of batched small
// Hermitian matrices; and the batched Hermitian EVD (hermitian_eigh_kernel
// and hermitian_eigh_lanes_kernel, below), which replaces no TPU kernel.
// Both run the same round-robin Jacobi sweeps with a stop, in the same two
// forms (a thread a matrix, a lane group a matrix); they differ in the
// ending.
//
// Kernel 14 replaces setk_tpu/ops/pallas/eigh_small.py _jacobi_flat
// (:183, body _jacobi_kernel :170) via regularized_inverse_pallas (:207),
// the regularized inverse of the clustering EM's scan and of its
// non-Higuchi inits (ops/linalg.regularized_inverse).  a (n, M, M)
// complex64, hermitianized on load -> inv (n, M, M) complex64 and logdet
// (n) f32, M <= 8: at most `sweeps` round-robin sweeps (the EVD's, below;
// the TPU's six cyclic sweeps are the cap), then w = diag(A) scaled by
// max(max w, EPS) and floored at EPS, logdet = sum log w, inv = V diag(1 /
// w) V^H, its upper triangle mirrored (jacobi.cuh's ending, the TPU
// kernel's).  The plain version is ops/cuda/eigh_small.py
// regularized_inverse_plain.
// - regularized_inverse_kernel: a thread a matrix, the thread form's
//   sweeps, then the ending in registers, each entry summed over y = 0..M-1
//   in order.  For large batches at M = 5-7, and at M <= 3.
// - regularized_inverse_lanes_kernel: a lane group a matrix, a lane a pair
//   (the lane form's sweeps and hand-over); every lane gets the true
//   columns' eigenvalues by shuffles (the bye's column and idle lanes hold
//   zeros and never enter the maximum, the floor or the logdet), adds its
//   two columns' terms v v^H / w into the upper triangle and writes it to
//   shared memory; lane l sums the group's G triangles at entries l, l +
//   G, ... of the row-major matrix and stores them, so a group's stores
//   are G adjacent entries an instruction.  Measured against a sum by xor
//   shuffles (2 steps of 42 floats at M = 6): 4-12 % faster at the
//   resume's 514 matrices (PERF.md).  For the per-utterance
//   resume's 514 matrices, where a
//   thread a matrix leaves the card idle and the launch lasts one
//   thread's chain; at M = 4 and 8 for every batch.
// regularized_inverse_pick chooses by n and M (kInverseLanesUpTo).
//
// Bound on the card: operations, from the sweeps the matrices take
// (ops/cuda/eigh_small.inverse_sweeps_needed): a rotation ~385 FLOP at M =
// 6 (chip_smoke.py _flops_jacobi), 15 a sweep, then the inverse (8 FLOP a
// term, M^2 (M + 1) / 2 terms) and the logdet; against 2 x 288 bytes a
// matrix at M = 6.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "jacobi.cuh"

namespace {

constexpr int kThreads = 128;

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

// ---- the batched Hermitian EVD, plain (GEN false) and generalized (GEN
// true) ----
//
// Replaces no TPU kernel: on the TPU every EVD of the JAX package is XLA's
// jnp.linalg.eigh (setk_tpu/ops/linalg.py:27-36), which the eigh steer of
// mvdr, gevd, mpdr, mpdr-whiten, the rank-1 approximation, the online
// family and the WPD scan reach through ops/linalg.eigh, generalized_eigh
// and solve_pevd.  On the card those calls come here (M <= 8), since the
// port uses no vendor solver; cuSOLVER's batched eigh has also refused
// 32,768 matrices in one call on the H100 (PERF.md), and a batch of 128
// utterances has 32,896 bins.  The rotation order, the angle's formulas
// and the sweep count are this kernel's own, held to the
// eigendecomposition's bars (kernel 15 keeps jacobi.cuh's cyclic
// statements, which follow the TPU kernel's; kernel 14 runs these
// sweeps).
//
// GEN false: a (n, M, M) complex64, hermitianized on load, then at most
// `sweeps` round-robin Jacobi sweeps, then w (n, M) f32 ascending and V
// (n, M, M) complex64 with matching columns: the convention of
// torch.linalg.eigh.  GEN true: (a, b), the statements of
// setk_tpu/ops/linalg.py:178-199 in registers: L = chol(herm(b) + (eps_rel
// mean diag + EPS) I) left-looking, C = L^{-1} herm(a) L^{-H} (X = L^{-1}
// herm(a) by forward substitution, then C = X L^{-H} by substitution along
// each row, in place), herm(C), the sweeps, V = L^{-H} U by back
// substitution; eigenvalues ascending, v^H B v = I.  A matrix that is not
// positive definite after the loading takes the square root of a negative
// pivot and comes out NaN, as jnp.linalg.cholesky gives it.  L is not kept
// through the sweeps: it is formed again from b for the back substitution.
//
// The sweeps (ops/cuda/eigh_small.py _eigh_sweeps is the plain version):
// - Round-robin ("chess tournament", Brent-Luk) order, RoundRobin below: a
//   sweep is P - 1 rounds (P = M rounded up to even) of P / 2 disjoint
//   pairs, every pair once.  A round's angles come from the round's
//   starting A; disjoint rotations commute, so all of the round's column
//   updates go first, then its row updates, then V <- V G.  At M = 6 a
//   sweep is 5 dependent steps of 3 independent angles, against 15 in
//   cyclic order.
// - One reciprocal square root a rotation for the phase and tau, one
//   reciprocal for t, one more for c (rr_angle).
// - The stop: a matrix has converged when every off-diagonal entry has
//   |a_pq|^2 <= (M EPS ||A||_F)^2, ||A||_F taken once as the sweeps begin,
//   tested at each sweep's start.  A converged matrix takes identity
//   rotations; a warp leaves the loop once all its matrices have converged
//   (__all_sync), so `sweeps` is a cap, and a zero, diagonal or
//   scaled-identity matrix takes no sweep.
//
// Two forms, each a launch (hermitian_eigh_pick chooses by n and M):
// - hermitian_eigh_kernel: a thread a matrix, A and V (4 M^2 floats) in
//   registers; a round's angle chains overlap (ILP).  For large batches
//   at M = 5-7, and at M <= 3.
// - hermitian_eigh_lanes_kernel: a group of M / 2 lanes (rounded up to a
//   power of two; at M = 5 and 6 one of the 4 is idle) a matrix, a lane a
//   pair: lane l holds the two columns of A and of V of its pair, computes
//   its angle, gets the round's others by __shfl_sync for the row updates,
//   and hands its columns to the next round's owners.  For one
//   utterance's 257 bins, where a thread a matrix leaves the card idle and
//   the launch lasts one thread's chain; at M = 4 and 8 for every batch.
//
// The order: column i goes to slot rank_i, the count of eigenvalues below
// w_i with ties broken by index (NaN ranks above everything), so the sort
// needs no runtime register index (those spill) and equal eigenvalues keep
// their order: a zero or scaled-identity matrix stores V = I, and its
// principal vector is e_{M-1}, as LAPACK gives it.
//
// Bound on the card: operations.  A rotation is ~385 FLOP at M = 6
// (_flops_eigh in chip_smoke.py), 15 a sweep; the sweeps the matrices take
// (ops/cuda/eigh_small.eigh_sweeps_needed) set the count, ~4 on full-rank
// matrices at M = 6.

#ifdef SETK_EIGH_PHASES
// tools/eigh_profile.py's build: every thread of an active matrix adds the
// SM cycles of each phase (load and whitening, angles with the stopping
// test, updates with the round's broadcast, the lane form's hand-over,
// back substitution with the sort and store), itself, the sweeps its warp
// ran and the sweeps its own matrix took to the counters.
__device__ unsigned long long g_eigh_phase[8];
__device__ __forceinline__ long long eigh_clock() { return clock64(); }
struct EighClock {
  long long t, acc[5];
  int run = 0, own = 0;
  __device__ EighClock() : t(eigh_clock()), acc{0, 0, 0, 0, 0} {}
  __device__ void mark(int i) {
    const long long now = eigh_clock();
    acc[i] += now - t;
    t = now;
  }
  __device__ void sweep(bool still) {
    ++run;
    own += still ? 1 : 0;
  }
  __device__ void flush(bool active) {
    if (!active) return;
    for (int i = 0; i < 5; ++i)
      atomicAdd(&g_eigh_phase[i], (unsigned long long)acc[i]);
    atomicAdd(&g_eigh_phase[5], 1ull);
    atomicAdd(&g_eigh_phase[6], (unsigned long long)run);
    atomicAdd(&g_eigh_phase[7], (unsigned long long)own);
  }
};
#else
struct EighClock {
  __device__ void mark(int) {}
  __device__ void sweep(bool) {}
  __device__ void flush(bool) {}
};
#endif
enum { kPhaseLoad, kPhaseAngles, kPhaseUpdates, kPhaseHandover, kPhaseStore };

// The round-robin order (ops/cuda/eigh_small.py eigh_schedule): P players
// (index M the bye of an odd M) at positions 0..P-1; position 0 keeps
// player 0, position k >= 1 holds player (k - 1 + r) % (P - 1) + 1 in round
// r, and slot i pairs positions i and P - 1 - i, (x, y) = (player at i,
// player at P - 1 - i).  From one round to the next each player at
// position k >= 2 moves to k - 1, and the one at 1 to P - 1.
template <int M>
struct RoundRobin {
  static constexpr int kPlayers = M + (M & 1);
  static constexpr int kSlots = kPlayers / 2;
  static constexpr int kRounds = kPlayers - 1;
  static constexpr int kLanes = kSlots <= 1 ? 1 : kSlots <= 2 ? 2 : 4;
};

__host__ __device__ constexpr int rr_player(int players, int pos, int r) {
  return pos == 0 ? 0 : (pos - 1 + r) % (players - 1) + 1;
}

struct Rot {
  float c, s, ph_re, ph_im;
};

// The rotation that annihilates a_xy of [[a_xx, a_xy], [a_yx, a_yy]]:
// G[x][x] = c, G[x][y] = s, G[y][x] = -conj(ph) s, G[y][y] = conj(ph) c,
// ph = a_xy / |a_xy|.  rs = rsqrt(|a_xy|^2) gives the phase and tau =
// (a_yy - a_xx) rs / 2; t = sgn(tau) / (|tau| + sqrt(1 + tau^2)) takes one
// reciprocal (sqrt(q) = q rsqrt(q); past |tau| ~ 1.8e19, where q
// overflows, t < 3e-20 is taken as 0); c = rsqrt(1 + t^2), s = t c.  The
// identity (t = 0, ph = 1) where `still` is false (the matrix has
// converged) or |a_xy|^2 <= 1e-30, so a zero or scaled-identity matrix
// keeps V = I.  rsqrtf and __fdividef are the SFU's approximations (~1
// ulp); the plain version takes torch.rsqrt and an IEEE division.
__device__ __forceinline__ Rot rr_angle(float axx, float ayy, float axy_re,
                                        float axy_im, bool still) {
  const float r2 = axy_re * axy_re + axy_im * axy_im;
  const bool rotate = still && r2 > setk::kTiny;
  const float rs = rsqrtf(rotate ? r2 : 1.0f);
  const float tau = (ayy - axx) * 0.5f * rs;
  const float q = tau * tau + 1.0f;
  const float t =
      rotate && q < INFINITY
          ? __fdividef(tau >= 0.0f ? 1.0f : -1.0f, fabsf(tau) + q * rsqrtf(q))
          : 0.0f;
  const float c = rotate ? rsqrtf(t * t + 1.0f) : 1.0f;
  return {c, rotate ? t * c : 0.0f, rotate ? axy_re * rs : 1.0f,
          rotate ? axy_im * rs : 0.0f};
}

// A <- A G (or V <- V G) on one row's entries k of columns x and y
__device__ __forceinline__ void rr_columns(const Rot& g, float& kx_re,
                                           float& kx_im, float& ky_re,
                                           float& ky_im) {
  const float gyx_re = -g.ph_re * g.s, gyx_im = g.ph_im * g.s;
  const float gyy_re = g.ph_re * g.c, gyy_im = -g.ph_im * g.c;
  const float x_re = kx_re, x_im = kx_im, y_re = ky_re, y_im = ky_im;
  kx_re = x_re * g.c + y_re * gyx_re - y_im * gyx_im;
  kx_im = x_im * g.c + y_re * gyx_im + y_im * gyx_re;
  ky_re = x_re * g.s + y_re * gyy_re - y_im * gyy_im;
  ky_im = x_im * g.s + y_re * gyy_im + y_im * gyy_re;
}

// A <- G^H A on one column's entries of rows x and y
__device__ __forceinline__ void rr_rows(const Rot& g, float& xk_re,
                                        float& xk_im, float& yk_re,
                                        float& yk_im) {
  const float gyx_re = -g.ph_re * g.s, gyx_im = g.ph_im * g.s;
  const float gyy_re = g.ph_re * g.c, gyy_im = -g.ph_im * g.c;
  const float x_re = xk_re, x_im = xk_im, y_re = yk_re, y_im = yk_im;
  xk_re = x_re * g.c + y_re * gyx_re + y_im * gyx_im;
  xk_im = x_im * g.c + y_im * gyx_re - y_re * gyx_im;
  yk_re = x_re * g.s + y_re * gyy_re + y_im * gyy_im;
  yk_im = x_im * g.s + y_im * gyy_re - y_re * gyy_im;
}

// herm(a) of matrix idx (zeros where `active` is false), whitened to
// herm(L^{-1} herm(a) L^{-H}) when GEN
template <int M, bool GEN>
__device__ __forceinline__ void eigh_load(const float2* __restrict__ a,
                                          const float2* __restrict__ b,
                                          int idx, bool active, float eps_rel,
                                          float (&a_re)[M][M],
                                          float (&a_im)[M][M]) {
  {
    const float2* src = a + (size_t)idx * M * M;
    float ar[M][M], ai[M][M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const float2 x = active ? src[i * M + j] : make_float2(0.0f, 0.0f);
        ar[i][j] = x.x;
        ai[i][j] = x.y;
      }
    }
    setk::hermitianize<M>(ar, ai, a_re, a_im);
  }
  if constexpr (GEN) {
    if (!active) return;
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
}

// the stopping test's bar on |a_pq|^2: (M EPS ||A||_F)^2, ||A||_F^2 summed
// row by row
template <int M>
__device__ __forceinline__ float eigh_tolerance(const float (&a_re)[M][M],
                                                const float (&a_im)[M][M]) {
  float f2 = 0.0f;
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j)
      f2 += a_re[i][j] * a_re[i][j] + a_im[i][j] * a_im[i][j];
  }
  constexpr float bar = M * setk::kEps;
  return bar * bar * f2;
}

// V <- L^{-H} V on one column of V (L of loaded_cholesky), in place
template <int M>
__device__ __forceinline__ void back_substitute(const float (&l_re)[M][M],
                                                const float (&l_im)[M][M],
                                                const float (&dinv)[M],
                                                float (&v_re)[M],
                                                float (&v_im)[M]) {
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    float re = v_re[i], im = v_im[i];
#pragma unroll
    for (int q = i + 1; q < M; ++q) {
      // conj(L[q][i]) x_q
      re -= l_re[q][i] * v_re[q] + l_im[q][i] * v_im[q];
      im -= l_re[q][i] * v_im[q] - l_im[q][i] * v_re[q];
    }
    v_re[i] = re * dinv[i];
    v_im[i] = im * dinv[i];
  }
}

// slot of eigenvalue i among key (ascending, NaN as +inf, ties by index)
template <int M>
__device__ __forceinline__ int eigh_rank(const float (&key)[M], int i,
                                         float ki) {
  int rank = 0;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    if (j != i) rank += key[j] < ki || (key[j] == ki && j < i) ? 1 : 0;
  }
  return rank;
}

// V = I, then at most `sweeps` round-robin sweeps on one thread's matrix
// (the thread form of the EVD and of kernel 14).  Threads past n hold a
// zero matrix, converged at once, and vote with the rest of their warp.
template <int M>
__device__ __forceinline__ void thread_sweeps(float (&a_re)[M][M],
                                              float (&a_im)[M][M],
                                              float (&v_re)[M][M],
                                              float (&v_im)[M][M],
                                              float tol2, int sweeps,
                                              EighClock& clk) {
  using RR = RoundRobin<M>;
  constexpr int P = RR::kPlayers;
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      v_re[i][j] = i == j ? 1.0f : 0.0f;
      v_im[i][j] = 0.0f;
    }
  }
  clk.mark(kPhaseLoad);
#pragma unroll 1
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    bool done = true;
#pragma unroll
    for (int p = 0; p < M - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < M; ++q)
        done &= a_re[p][q] * a_re[p][q] + a_im[p][q] * a_im[p][q] <= tol2;
    }
    if (__all_sync(0xffffffffu, done)) break;
    clk.sweep(!done);
#pragma unroll
    for (int r = 0; r < RR::kRounds; ++r) {
      Rot g[RR::kSlots];
#pragma unroll
      for (int i = 0; i < RR::kSlots; ++i) {
        const int x = rr_player(P, i, r), y = rr_player(P, P - 1 - i, r);
        if (x < M && y < M)
          g[i] = rr_angle(a_re[x][x], a_re[y][y], a_re[x][y], a_im[x][y],
                          !done);
      }
      clk.mark(kPhaseAngles);
#pragma unroll
      for (int i = 0; i < RR::kSlots; ++i) {
        const int x = rr_player(P, i, r), y = rr_player(P, P - 1 - i, r);
        if (x >= M || y >= M) continue;
#pragma unroll
        for (int k = 0; k < M; ++k)
          rr_columns(g[i], a_re[k][x], a_im[k][x], a_re[k][y], a_im[k][y]);
      }
#pragma unroll
      for (int i = 0; i < RR::kSlots; ++i) {
        const int x = rr_player(P, i, r), y = rr_player(P, P - 1 - i, r);
        if (x >= M || y >= M) continue;
#pragma unroll
        for (int k = 0; k < M; ++k)
          rr_rows(g[i], a_re[x][k], a_im[x][k], a_re[y][k], a_im[y][k]);
      }
#pragma unroll
      for (int i = 0; i < RR::kSlots; ++i) {
        const int x = rr_player(P, i, r), y = rr_player(P, P - 1 - i, r);
        if (x >= M || y >= M) continue;
#pragma unroll
        for (int k = 0; k < M; ++k)
          rr_columns(g[i], v_re[k][x], v_im[k][x], v_re[k][y], v_im[k][y]);
      }
      clk.mark(kPhaseUpdates);
    }
  }
}

// One matrix a thread.
template <int M, bool GEN>
__global__ void __launch_bounds__(kThreads)
hermitian_eigh_kernel(const float2* __restrict__ a,
                      const float2* __restrict__ b,
                      float* __restrict__ w_out,
                      float2* __restrict__ v_out, int n, int sweeps,
                      float eps_rel) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = idx < n;
  EighClock clk;
  float a_re[M][M], a_im[M][M];
  eigh_load<M, GEN>(a, b, idx, active, eps_rel, a_re, a_im);
  const float tol2 = eigh_tolerance<M>(a_re, a_im);
  float v_re[M][M], v_im[M][M];
  thread_sweeps<M>(a_re, a_im, v_re, v_im, tol2, sweeps, clk);
  if (active) {
    if constexpr (GEN) {
      // the factor again, then V = L^{-H} U column by column, in place
      float l_re[M][M], l_im[M][M], dinv[M];
      loaded_cholesky<M>(b + (size_t)idx * M * M, eps_rel, l_re, l_im, dinv);
#pragma unroll
      for (int j = 0; j < M; ++j) {
        float cr[M], ci[M];
#pragma unroll
        for (int k = 0; k < M; ++k) {
          cr[k] = v_re[k][j];
          ci[k] = v_im[k][j];
        }
        back_substitute<M>(l_re, l_im, dinv, cr, ci);
#pragma unroll
        for (int k = 0; k < M; ++k) {
          v_re[k][j] = cr[k];
          v_im[k][j] = ci[k];
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
      const int rank = eigh_rank<M>(key, i, key[i]);
      w_dst[rank] = a_re[i][i];
#pragma unroll
      for (int k = 0; k < M; ++k)
        v_dst[k * M + rank] = make_float2(v_re[k][i], v_im[k][i]);
    }
  }
  clk.mark(kPhaseStore);
  clk.flush(active);
}

// entry (k, c) of the register matrix at a runtime column c (selects, not
// a runtime register index)
template <int M>
__device__ __forceinline__ void take_column(const float (&m_re)[M][M],
                                            const float (&m_im)[M][M], int c,
                                            float (&col_re)[M],
                                            float (&col_im)[M]) {
#pragma unroll
  for (int k = 0; k < M; ++k) {
    col_re[k] = col_im[k] = 0.0f;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (j == c) {
        col_re[k] = m_re[k][j];
        col_im[k] = m_im[k][j];
      }
    }
  }
}

template <int M>
__device__ __forceinline__ float entry_at(const float (&col)[M], int k) {
  float x = 0.0f;
#pragma unroll
  for (int j = 0; j < M; ++j) x = j == k ? col[j] : x;
  return x;
}

// A group of G = RoundRobin<M>::kLanes adjacent lanes a matrix, lane l a
// slot: at a sweep's start lane l holds columns l (top) and P - 1 - l
// (bottom) of A and of V, and through a round the columns of its pair's
// players (x at position l, y at position P - 1 - l).  Lanes l >= P / 2
// and the bye's column hold zeros and take identity rotations.  Every lane
// loads (and, GEN, whitens) the whole matrix and keeps its two columns.
// Every lane of the warp meets every shuffle and vote: a group past n
// holds a zero matrix, converged at once.
//
// At most `sweeps` round-robin sweeps of the lane form (the lane form of
// the EVD and of kernel 14): each round a lane computes its pair's angle,
// turns its two columns of A (tr, ti, br, bi) and V (vtr, vti, vbr, vbi),
// turns the round's rows of them with the others' angles (__shfl_sync),
// and hands its columns to the next round's owners.  The EVD keeps its
// columns in separate arrays: a struct holding them cost its lane form 2
// registers and 5-10 % (PERF.md).
template <int M>
__device__ __forceinline__ void lane_sweeps(
    float (&tr)[M], float (&ti)[M], float (&br)[M], float (&bi)[M],
    float (&vtr)[M], float (&vti)[M], float (&vbr)[M], float (&vbi)[M],
    int l, int base, bool own, int ct, int cb, float tol2, int sweeps,
    EighClock& clk) {
  using RR = RoundRobin<M>;
  constexpr int P = RR::kPlayers, H = RR::kSlots;
  constexpr unsigned all = 0xffffffffu;
  clk.mark(kPhaseLoad);
  // the votes of the group's H lanes that hold a pair (at M = 5 and 6 a
  // group of 4 has 3)
  const unsigned group = ((1u << H) - 1u) << base;
#pragma unroll 1
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    // the test on this lane's entries above the diagonal, then the group's
    bool ok = true;
#pragma unroll
    for (int k = 0; k < M; ++k) {
      ok &= k >= ct || tr[k] * tr[k] + ti[k] * ti[k] <= tol2;
      ok &= k >= cb || br[k] * br[k] + bi[k] * bi[k] <= tol2;
    }
    const bool done = (__ballot_sync(all, ok) & group) == group;
    if (__all_sync(all, done)) break;
    clk.sweep(!done);
#pragma unroll
    for (int r = 0; r < RR::kRounds; ++r) {
      // this lane's angle: its pair's entries, picked by slot
      float axx = 0.0f, ayy = 0.0f, axy_re = 0.0f, axy_im = 0.0f;
      bool pair = false;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const int x = rr_player(P, i, r), y = rr_player(P, P - 1 - i, r);
        if (x < M && y < M && l == i) {
          axx = tr[x];
          ayy = br[y];
          axy_re = br[x];
          axy_im = bi[x];
          pair = true;
        }
      }
      const Rot g = rr_angle(axx, ayy, axy_re, axy_im, pair && !done);
      clk.mark(kPhaseAngles);
      // columns x, y of A, then every pair's rows of them, then V's
#pragma unroll
      for (int k = 0; k < M; ++k) rr_columns(g, tr[k], ti[k], br[k], bi[k]);
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const int x = rr_player(P, i, r), y = rr_player(P, P - 1 - i, r);
        if (x >= M || y >= M) continue;
        const Rot gi = {__shfl_sync(all, g.c, base + i),
                        __shfl_sync(all, g.s, base + i),
                        __shfl_sync(all, g.ph_re, base + i),
                        __shfl_sync(all, g.ph_im, base + i)};
        rr_rows(gi, tr[x], ti[x], tr[y], ti[y]);
        rr_rows(gi, br[x], bi[x], br[y], bi[y]);
      }
#pragma unroll
      for (int k = 0; k < M; ++k)
        rr_columns(g, vtr[k], vti[k], vbr[k], vbi[k]);
      clk.mark(kPhaseUpdates);
      // the hand-over: position k >= 2 to k - 1, position 1 to P - 1
      if constexpr (P > 2) {
        const int from_up = base + (l == 0 ? 1 : l + 1);
        const int from_down = base + l - 1;
        const bool keep_top = l == 0, own_bottom_up = l == H - 1;
        auto hand = [&](float& top, float& bottom) {
          const float up = __shfl_sync(all, top, from_up);
          const float down = __shfl_sync(all, bottom, from_down);
          if (!own) return;   // an idle lane keeps its zeros
          const float mine = bottom;
          bottom = keep_top ? up : down;
          top = keep_top ? top : own_bottom_up ? mine : up;
        };
#pragma unroll
        for (int k = 0; k < M; ++k) {
          hand(tr[k], br[k]);
          hand(ti[k], bi[k]);
          hand(vtr[k], vbr[k]);
          hand(vti[k], vbi[k]);
        }
      }
      clk.mark(kPhaseHandover);
    }
  }
}

template <int M, bool GEN>
__global__ void __launch_bounds__(kThreads)
hermitian_eigh_lanes_kernel(const float2* __restrict__ a,
                            const float2* __restrict__ b,
                            float* __restrict__ w_out,
                            float2* __restrict__ v_out, int n, int sweeps,
                            float eps_rel) {
  using RR = RoundRobin<M>;
  constexpr int P = RR::kPlayers, H = RR::kSlots, G = RR::kLanes;
  constexpr unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int l = lane & (G - 1);
  const int base = lane - l;
  const int idx = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  const bool active = idx < n;
  const bool own = l < H;
  // this lane's columns at a sweep's start (M: none, or the bye)
  const int ct = own ? l : M, cb = own ? P - 1 - l : M;
  EighClock clk;
  float tr[M], ti[M], br[M], bi[M];   // A's columns
  float tol2;
  {
    float a_re[M][M], a_im[M][M];
    eigh_load<M, GEN>(a, b, idx, active, eps_rel, a_re, a_im);
    tol2 = eigh_tolerance<M>(a_re, a_im);
    take_column<M>(a_re, a_im, ct, tr, ti);
    take_column<M>(a_re, a_im, cb, br, bi);
  }
  float vtr[M], vti[M], vbr[M], vbi[M];   // V's columns
#pragma unroll
  for (int k = 0; k < M; ++k) {
    vtr[k] = k == ct ? 1.0f : 0.0f;
    vbr[k] = k == cb ? 1.0f : 0.0f;
    vti[k] = vbi[k] = 0.0f;
  }
  lane_sweeps<M>(tr, ti, br, bi, vtr, vti, vbr, vbi, l, base, own, ct, cb,
                 tol2, sweeps, clk);
  // the diagonal: column ct's entry ct, cb's entry cb; V = L^{-H} U
  const float dt = entry_at<M>(tr, ct), db = entry_at<M>(br, cb);
  if constexpr (GEN) {
    if (active && own) {
      float l_re[M][M], l_im[M][M], dinv[M];
      loaded_cholesky<M>(b + (size_t)idx * M * M, eps_rel, l_re, l_im, dinv);
      back_substitute<M>(l_re, l_im, dinv, vtr, vti);
      back_substitute<M>(l_re, l_im, dinv, vbr, vbi);
    }
  }
  // every eigenvalue from its lane; ascending order by rank
  float key[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const float wj =
        __shfl_sync(all, j < H ? dt : db, base + (j < H ? j : P - 1 - j));
    key[j] = wj != wj ? INFINITY : wj;
  }
  if (active && own) {
    float* w_dst = w_out + (size_t)idx * M;
    float2* v_dst = v_out + (size_t)idx * M * M;
    const int rt = eigh_rank<M>(key, ct, dt != dt ? INFINITY : dt);
    w_dst[rt] = dt;
#pragma unroll
    for (int k = 0; k < M; ++k)
      v_dst[k * M + rt] = make_float2(vtr[k], vti[k]);
    if (cb < M) {
      const int rb = eigh_rank<M>(key, cb, db != db ? INFINITY : db);
      w_dst[rb] = db;
#pragma unroll
      for (int k = 0; k < M; ++k)
        v_dst[k * M + rb] = make_float2(vbr[k], vbi[k]);
    }
  }
  clk.mark(kPhaseStore);
  clk.flush(active && own);
}

// ---- kernel 14: the floored inverse on the same sweeps ----

// w / max(max w, EPS) floored at EPS, over the true columns' eigenvalues
// in index order: winv = 1 / w, returns logdet = sum log w (jacobi.cuh's
// statements, IEEE division and logf)
template <int M>
__device__ __forceinline__ float floored_spectrum(const float (&w)[M],
                                                  float (&winv)[M]) {
  float wmax = w[0];
#pragma unroll
  for (int i = 1; i < M; ++i) wmax = fmaxf(wmax, w[i]);
  wmax = fmaxf(wmax, setk::kEps);
  float ld = 0.0f;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float wi = fmaxf(w[i] / wmax, setk::kEps);
    ld += logf(wi);
    winv[i] = 1.0f / wi;
  }
  return ld;
}

// entry (i, j) of the upper triangle (j >= i) in a packed row-major array
__host__ __device__ constexpr int upper_at(int m, int i, int j) {
  return i * m - i * (i - 1) / 2 + (j - i);
}

// One matrix a thread: inv[i][j] = sum_y V[i][y] winv[y] conj(V[j][y])
// over y = 0..M-1 in order, stored with its mirror conj at (j, i).
template <int M>
__global__ void __launch_bounds__(kThreads)
regularized_inverse_kernel(const float2* __restrict__ a,
                           float2* __restrict__ inv,
                           float* __restrict__ logdet, int n, int sweeps) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = idx < n;
  EighClock clk;
  float a_re[M][M], a_im[M][M];
  eigh_load<M, false>(a, nullptr, idx, active, 0.0f, a_re, a_im);
  const float tol2 = eigh_tolerance<M>(a_re, a_im);
  float v_re[M][M], v_im[M][M];
  thread_sweeps<M>(a_re, a_im, v_re, v_im, tol2, sweeps, clk);
  if (active) {
    float w[M], winv[M];
#pragma unroll
    for (int i = 0; i < M; ++i) w[i] = a_re[i][i];
    const float ld = floored_spectrum<M>(w, winv);
    float2* dst = inv + (size_t)idx * M * M;
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = i; j < M; ++j) {
        float acc_re = 0.0f, acc_im = 0.0f;
#pragma unroll
        for (int y = 0; y < M; ++y) {
          const float p_re = v_re[i][y] * v_re[j][y] + v_im[i][y] * v_im[j][y];
          const float p_im = v_im[i][y] * v_re[j][y] - v_re[i][y] * v_im[j][y];
          acc_re += p_re * winv[y];
          acc_im += p_im * winv[y];
        }
        dst[i * M + j] = make_float2(acc_re, acc_im);
        if (j != i) dst[j * M + i] = make_float2(acc_re, -acc_im);
      }
    }
    if (logdet != nullptr) logdet[idx] = ld;
  }
  clk.mark(kPhaseStore);
  clk.flush(active);
}

// A lane group a matrix, a lane a pair (the lane form's sweeps).  Every
// lane takes the true columns' eigenvalues from their lanes, so the bye's
// column and idle lanes (zeros) enter neither the maximum nor the floor nor
// the logdet; adds its own columns' terms V[i][y] winv[y] conj(V[j][y]) into
// the packed upper triangle (a lane without a column adds zeros) and
// writes it to shared memory; lane l sums the group's G triangles (in lane
// order) at entries l, l + G, ... of the row-major matrix and stores them.
// Every lane of the warp meets the __syncwarp.
template <int M>
__global__ void __launch_bounds__(kThreads)
regularized_inverse_lanes_kernel(const float2* __restrict__ a,
                                 float2* __restrict__ inv,
                                 float* __restrict__ logdet, int n,
                                 int sweeps) {
  using RR = RoundRobin<M>;
  constexpr int P = RR::kPlayers, H = RR::kSlots, G = RR::kLanes;
  constexpr int T = M * (M + 1) / 2;
  constexpr unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int l = lane & (G - 1);
  const int base = lane - l;
  const int idx = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  const bool active = idx < n;
  const bool own = l < H;
  const int ct = own ? l : M, cb = own ? P - 1 - l : M;
  EighClock clk;
  // the lane's columns of A and V in one local struct: so built, the
  // kernel takes 96 registers and ~0.015 ms at the resume's 514 matrices
  // (M = 6), against 80 and ~0.0185 with eight separate arrays (PERF.md)
  struct {
    float tr[M], ti[M], br[M], bi[M], vtr[M], vti[M], vbr[M], vbi[M];
  } c;
  float tol2;
  {
    float a_re[M][M], a_im[M][M];
    eigh_load<M, false>(a, nullptr, idx, active, 0.0f, a_re, a_im);
    tol2 = eigh_tolerance<M>(a_re, a_im);
    take_column<M>(a_re, a_im, ct, c.tr, c.ti);
    take_column<M>(a_re, a_im, cb, c.br, c.bi);
  }
#pragma unroll
  for (int k = 0; k < M; ++k) {
    c.vtr[k] = k == ct ? 1.0f : 0.0f;
    c.vbr[k] = k == cb ? 1.0f : 0.0f;
    c.vti[k] = c.vbi[k] = 0.0f;
  }
  lane_sweeps<M>(c.tr, c.ti, c.br, c.bi, c.vtr, c.vti, c.vbr, c.vbi, l, base,
                 own, ct, cb, tol2, sweeps, clk);
  float (&tr)[M] = c.tr, (&br)[M] = c.br;
  float (&vtr)[M] = c.vtr, (&vti)[M] = c.vti, (&vbr)[M] = c.vbr,
        (&vbi)[M] = c.vbi;
  const float dt = entry_at<M>(tr, ct), db = entry_at<M>(br, cb);
  float w[M], winv[M];
#pragma unroll
  for (int j = 0; j < M; ++j)
    w[j] = __shfl_sync(all, j < H ? dt : db, base + (j < H ? j : P - 1 - j));
  const float ld = floored_spectrum<M>(w, winv);
  // this lane's weights: 0 for no column or the bye
  const float wt = entry_at<M>(winv, ct), wb = entry_at<M>(winv, cb);
  float sr[T], si[T];
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = i; j < M; ++j) {
      const float t_re = vtr[i] * vtr[j] + vti[i] * vti[j];
      const float t_im = vti[i] * vtr[j] - vtr[i] * vti[j];
      const float b_re = vbr[i] * vbr[j] + vbi[i] * vbi[j];
      const float b_im = vbi[i] * vbr[j] - vbr[i] * vbi[j];
      sr[upper_at(M, i, j)] = t_re * wt + b_re * wb;
      si[upper_at(M, i, j)] = t_im * wt + b_im * wb;
    }
  }
  // the group's sum through shared memory: each lane's triangle, then
  // lane l sums the group's G triangles at the entries it stores
  __shared__ float part[kThreads][2 * T];
#pragma unroll
  for (int k = 0; k < T; ++k) {
    part[threadIdx.x][k] = sr[k];
    part[threadIdx.x][T + k] = si[k];
  }
  __syncwarp();
  if (active) {
    float2* dst = inv + (size_t)idx * M * M;
    const int first = threadIdx.x - l;
    for (int e = l; e < M * M; e += G) {
      const int i = e / M, j = e % M;
      const int k = j >= i ? upper_at(M, i, j) : upper_at(M, j, i);
      float re = 0.0f, im = 0.0f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        re += part[first + g][k];
        im += part[first + g][T + k];
      }
      dst[e] = make_float2(re, j >= i ? im : -im);
    }
    if (logdet != nullptr && l == 0) logdet[idx] = ld;
  }
  clk.mark(kPhaseStore);
  clk.flush(active && own);
}

}  // namespace

// The form hermitian_eigh_launch takes for n matrices of m x m: 1 (lane
// groups) up to kLanesUpTo[m] matrices, else 0 (a thread a matrix).  On
// the H100 (PERF.md, tools/eigh_profile.py) a thread wins or ties at every
// count at M <= 3 (at M = 2 a group is one lane), lane groups at M = 4 and
// 8 (at 8 a thread's registers spill), and lane groups up to 8,224
// matrices at M = 5 and up to 16,448 at M = 6 and 7, a thread from the
// next count measured (16,448; 32,896).  Each form is built only at the M
// where the pick can take it.
constexpr int kLanesUpTo[9] = {0, 0, 0, 0, INT_MAX, 8224, 16448, 16448,
                               INT_MAX};

constexpr bool eigh_built(int form, int m) {
  return form ? kLanesUpTo[m] > 0 : kLanesUpTo[m] < INT_MAX;
}

extern "C" int hermitian_eigh_pick(int n, int m) {
  return m >= 1 && m <= 8 && n <= kLanesUpTo[m] ? 1 : 0;
}

// a launch's block: 128 threads, 32 where 128 leaves fewer blocks than
// the card has SMs
static int launch_block(long long threads, int sms) {
  return (threads + kThreads - 1) / kThreads >= sms ? kThreads : 32;
}

// the card's SM count
static int device_sms(int* sms) {
  int dev = 0;
  const int err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// one form's launch
template <int M, bool LANES>
void eigh_launch_form(const float2* a, const float2* b, float* w, float2* v,
                      int n, int sweeps, float eps_rel, int sms,
                      cudaStream_t st) {
  const long long threads = (long long)n * (LANES ? RoundRobin<M>::kLanes : 1);
  const int block = launch_block(threads, sms);
  const int grid = (int)((threads + block - 1) / block);
  if constexpr (LANES) {
    if (b != nullptr)
      hermitian_eigh_lanes_kernel<M, true><<<grid, block, 0, st>>>(
          a, b, w, v, n, sweeps, eps_rel);
    else
      hermitian_eigh_lanes_kernel<M, false><<<grid, block, 0, st>>>(
          a, b, w, v, n, sweeps, eps_rel);
  } else {
    if (b != nullptr)
      hermitian_eigh_kernel<M, true><<<grid, block, 0, st>>>(
          a, b, w, v, n, sweeps, eps_rel);
    else
      hermitian_eigh_kernel<M, false><<<grid, block, 0, st>>>(
          a, b, w, v, n, sweeps, eps_rel);
  }
}

// the form at M, if built
template <int M>
int eigh_launch_m(int form, const float2* a, const float2* b, float* w,
                  float2* v, int n, int sweeps, float eps_rel, int sms,
                  cudaStream_t st) {
  if constexpr (eigh_built(1, M)) {
    if (form == 1) {
      eigh_launch_form<M, true>(a, b, w, v, n, sweeps, eps_rel, sms, st);
      return cudaGetLastError();
    }
  }
  if constexpr (eigh_built(0, M)) {
    if (form == 0) {
      eigh_launch_form<M, false>(a, b, w, v, n, sweeps, eps_rel, sms, st);
      return cudaGetLastError();
    }
  }
  return cudaErrorInvalidValue;
}

// a, b: (n, m, m) complex64 (b null: the plain EVD); w: (n, m) f32;
// v: (n, m, m) complex64.  1 <= m <= 8, sweeps >= 0; form 0 a thread a
// matrix, 1 lane groups (each where it is built, else refused), -1
// hermitian_eigh_pick's.
extern "C" int hermitian_eigh_form_launch(const void* a, const void* b,
                                          void* w, void* v, int n, int m,
                                          int sweeps, float eps_rel, int form,
                                          void* stream) {
  if (n < 1 || m < 1 || m > 8 || sweeps < 0 || form < -1 || form > 1)
    return cudaErrorInvalidValue;
  if (form < 0) form = hermitian_eigh_pick(n, m);
  int sms = 0;
  const int err = device_sms(&sms);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  auto src = static_cast<const float2*>(a);
  auto bsrc = static_cast<const float2*>(b);
  auto wd = static_cast<float*>(w);
  auto vd = static_cast<float2*>(v);
  switch (m) {
#define CASE(mm)                                                         \
  case mm:                                                               \
    return eigh_launch_m<mm>(form, src, bsrc, wd, vd, n, sweeps, eps_rel, \
                             sms, st);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

// the form hermitian_eigh_pick gives
extern "C" int hermitian_eigh_launch(const void* a, const void* b, void* w,
                                     void* v, int n, int m, int sweeps,
                                     float eps_rel, void* stream) {
  return hermitian_eigh_form_launch(a, b, w, v, n, m, sweeps, eps_rel, -1,
                                    stream);
}

// The form regularized_inverse_launch takes for n matrices of m x m: 1
// (lane groups) up to kInverseLanesUpTo[m] matrices, else 0 (a thread a
// matrix), measured on the H100 for this kernel at 514, 4,112, 16,448 and
// 65,792 matrices (PERF.md, tools/inverse_profile.py): a thread wins at M
// = 3 at every count and at M = 2 up to 4,112 (past it lanes by <= 6 %; a
// group there is one lane), lane groups at M = 4 and 8 at every count (at
// 8 a thread's registers spill), and lane groups up to 4,112 at M = 5-7,
// a thread from 16,448 (at M = 6 the two within 0.1 % there).  Each form
// is built only at the M where the pick can take it.
constexpr int kInverseLanesUpTo[9] = {0, 0, 0, 0, INT_MAX, 4112, 4112, 4112,
                                      INT_MAX};

constexpr bool inverse_built(int form, int m) {
  return form ? kInverseLanesUpTo[m] > 0 : kInverseLanesUpTo[m] < INT_MAX;
}

extern "C" int regularized_inverse_pick(int n, int m) {
  return m >= 1 && m <= 8 && n <= kInverseLanesUpTo[m] ? 1 : 0;
}

template <int M>
int inverse_launch_m(int form, const float2* a, float2* inv, float* logdet,
                     int n, int sweeps, int sms, cudaStream_t st) {
  if constexpr (inverse_built(1, M)) {
    if (form == 1) {
      const long long threads = (long long)n * RoundRobin<M>::kLanes;
      const int block = launch_block(threads, sms);
      const int grid = (int)((threads + block - 1) / block);
      regularized_inverse_lanes_kernel<M><<<grid, block, 0, st>>>(
          a, inv, logdet, n, sweeps);
      return cudaGetLastError();
    }
  }
  if constexpr (inverse_built(0, M)) {
    if (form == 0) {
      const int block = launch_block(n, sms);
      const int grid = (n + block - 1) / block;
      regularized_inverse_kernel<M><<<grid, block, 0, st>>>(a, inv, logdet,
                                                            n, sweeps);
      return cudaGetLastError();
    }
  }
  return cudaErrorInvalidValue;
}

// a, inv: (n, m, m) complex64; logdet: (n) f32 or null.  1 <= m <= 8,
// sweeps >= 0 (a cap); form 0 a thread a matrix, 1 lane groups (each where
// it is built, else refused), -1 regularized_inverse_pick's.
extern "C" int regularized_inverse_launch(const void* a, void* inv,
                                          void* logdet, int n, int m,
                                          int sweeps, int form,
                                          void* stream) {
  if (n < 1 || m < 1 || m > 8 || sweeps < 0 || form < -1 || form > 1)
    return cudaErrorInvalidValue;
  if (form < 0) form = regularized_inverse_pick(n, m);
  int sms = 0;
  const int err = device_sms(&sms);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  auto src = static_cast<const float2*>(a);
  auto dst = static_cast<float2*>(inv);
  auto ld = static_cast<float*>(logdet);
  switch (m) {
#define CASE(mm)                                                         \
  case mm:                                                               \
    return inverse_launch_m<mm>(form, src, dst, ld, n, sweeps, sms, st);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

#ifdef SETK_EIGH_PHASES
// the counters of the instrumented build: read (8 values: cycles of load,
// angles, updates, hand-over, store, the threads counted, the sweeps run
// and the sweeps taken, summed over them) and zero
extern "C" int eigh_phase_read(unsigned long long* out) {
  int err = cudaMemcpyFromSymbol(out, g_eigh_phase, 8 * 8);
  if (err != cudaSuccess) return err;
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return cudaMemcpyToSymbol(g_eigh_phase, zero, 8 * 8);
}
#endif
