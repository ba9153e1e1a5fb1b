// Loaded Hermitian Cholesky solve of one medium system (n <= 128) in
// shared memory by one warp: chol_solve_warp, the body of kernels 16 and
// 17 (cholesky.cu hermitian_solve_kernel and gram_solve_kernel).
//
// The arithmetic of setk_tpu/ops/pallas/cholesky.py _solve_kernel (:39) and
// _gram_solve_kernel (:114): pivots 1 / sqrt(max(A[j][j] - sum_q |L[j][q]|^2
// + load, EPS)), L[i][j] = (A[i][j] - sum_q L[i][q] conj(L[j][q])) * pivot,
// then L y = b and L^H x = y.  The TPU runs the factorization left-looking
// over 128 bins in lanes; here a warp owns one system and runs it
// left-looking too, kCholPanel columns a step (warp_panel): lanes over
// the columns' rows, each entry's terms q = 0, 1, ..., j - 1 summed in a
// register in that order (the TPU's order), with __syncwarp alone.  Forward
// substitution is right-looking (the TPU's order) and back substitution
// subtracts x_q for q descending (the TPU ascending), both in place in y,
// lanes over rows.  The plain PyTorch version (ops/cuda/cholesky.py
// _chol_solve_plain) runs the factorization right-looking, which gives
// every entry the same terms in the same order.  sqrtf and the divisions
// are the IEEE ones.  (Kernel 16 once ran a right-looking block body with
// the same terms and expressions; on the CPU the two bodies agreed to the
// bit.)
//
// Layouts in shared memory: the lower triangle packed by rows,
// low[tri(i) + j] = A[i][j] for j <= i (8 n (n + 1) / 2 bytes, 14.6 KB at
// n = 60, 66 KB at n = 128); the right-hand sides y (n x k, row-major,
// overwritten by the solution); dinv (n).
#pragma once
#include <cuda_runtime.h>

namespace setk {

constexpr float kCholEps = 1.1920928955078125e-07f;  // float32 epsilon
// columns a left-looking step of chol_solve_warp (warp_panel): 1, 2 or
// 4; the emulator's tests build 1 with -D to hold the panel to a column a
// step, bit for bit.  On an H100 at the WPE scene (PERF.md) 4 ran kernel
// 17 in 0.777 ms and kernel 16 in 0.925, against 0.814 and 0.996 at 2 and
// 0.888 and 1.057 at 1: a row's L[r][q] is read once for the panel, and
// its columns' chains run side by side.
#ifndef SETK_CHOL_PANEL
#define SETK_CHOL_PANEL 4
#endif
constexpr int kCholPanel = SETK_CHOL_PANEL;

#ifdef SETK_WPE_PHASES
// tools/wpe_phase_profile.py's build: lane 0 of every warp adds the SM
// cycles since `t` to phase i of kernel 16 or 17 (factorization,
// forward, back, the rest: the system's load, the loading, the store) and
// restarts `t`
__device__ unsigned long long g_chol_phase[4];
__device__ __forceinline__ void chol_phase(int i, long long& t) {
  if ((threadIdx.x & 31) == 0) {
    const long long now = clock64();
    atomicAdd(&g_chol_phase[i], (unsigned long long)(now - t));
    t = now;
  }
}
#define CHOL_CLOCK() clock64()
#define CHOL_PHASE(i, t) setk::chol_phase(i, t)
#else
#define CHOL_CLOCK() 0
#define CHOL_PHASE(i, t) \
  do {                   \
  } while (0)
#endif

__host__ __device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

// Bytes of shared memory chol_solve_warp needs beside its caller's own.
__host__ __device__ inline size_t chol_warp_smem_bytes(int n, int k) {
  return sizeof(float2) * ((size_t)tri(n) + (size_t)n * k) +
         sizeof(float) * (size_t)n;
}

// A[i][c] -= L[i][j] conj(L[c][j]) at one pair of the trailing triangle.
__device__ __forceinline__ float2 rank1_term(float2 s, float2 lij,
                                             float2 lcj) {
  s.x -= lij.x * lcj.x + lij.y * lcj.y;
  s.y -= lij.y * lcj.x - lij.x * lcj.y;
  return s;
}

// Columns j ... j + P - 1 (a panel, j + P <= n) of the left-looking
// factorization by one warp, H = column j's 32-row chunks: lane l holds
// rows r = j + l + 32 h of every column of the panel (column j + c's
// diagonal at lane c), reads each row's L[r][q] once for the panel's
// terms q < j, then column by column gives column j + c its terms q = j
// ... j + c - 1 (L[j + c][q] from lane c), pivots it and scales its rows
// below the diagonal.  Every entry receives its terms in q order, by
// rank1_term, as with a column a step (P = 1).
template <int P, int H>
__device__ __forceinline__ void warp_panel(float2* low, float* dinv, int n,
                                           int j, float load, int lane) {
  float2 s[P][H];
  const float2* li[H];
  const float2* lc[P];
#pragma unroll
  for (int c = 0; c < P; ++c) lc[c] = low + tri(j + c);
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int r = j + lane + 32 * h;
    li[h] = low + tri(r < n ? r : j);
#pragma unroll
    for (int c = 0; c < P; ++c)
      s[c][h] = li[h][r < n && r >= j + c ? j + c : 0];
  }
#pragma unroll 4
  for (int q = 0; q < j; ++q) {
    float2 b[P];
#pragma unroll
    for (int c = 0; c < P; ++c) b[c] = lc[c][q];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const float2 a = li[h][q];
#pragma unroll
      for (int c = 0; c < P; ++c) s[c][h] = rank1_term(s[c][h], a, b[c]);
    }
  }
  float inv[P];
#pragma unroll
  for (int c = 0; c < P; ++c) {
#pragma unroll
    for (int e = 0; e < c; ++e) {
      const float2 b = make_float2(__shfl_sync(0xffffffffu, s[e][0].x, c),
                                   __shfl_sync(0xffffffffu, s[e][0].y, c));
#pragma unroll
      for (int h = 0; h < H; ++h) s[c][h] = rank1_term(s[c][h], s[e][h], b);
    }
    inv[c] = __shfl_sync(
        0xffffffffu, 1.0f / sqrtf(fmaxf(s[c][0].x + load, kCholEps)), c);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      if (lane + 32 * h != c)  // the diagonal stays as summed
        s[c][h] = make_float2(s[c][h].x * inv[c], s[c][h].y * inv[c]);
    }
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int r = j + lane + 32 * h;
#pragma unroll
    for (int c = 0; c < P; ++c) {
      if (r == j + c) {
        low[tri(r) + r] = s[c][h];
        dinv[r] = inv[c];
      } else if (r > j + c && r < n) {
        low[tri(r) + j + c] = s[c][h];
      }
    }
  }
}

// A step of P columns at column j, H chosen from the rows left.
template <int P>
__device__ __forceinline__ void warp_panel_step(float2* low, float* dinv,
                                                int n, int j, float load,
                                                int lane) {
  const int rows = n - j;
  if (rows > 96) {
    warp_panel<P, 4>(low, dinv, n, j, load, lane);
  } else if (rows > 64) {
    warp_panel<P, 3>(low, dinv, n, j, load, lane);
  } else if (rows > 32) {
    warp_panel<P, 2>(low, dinv, n, j, load, lane);
  } else {
    warp_panel<P, 1>(low, dinv, n, j, load, lane);
  }
}

// Step q of the in-place forward substitution by one warp, H = the 32-row
// chunks below row q: lane l holds rows i = q + 1 + l + 32 h and, a pair
// of right-hand sides at a time (both read before either is written),
// subtracts L[i][q] y_q; after __syncwarp, y_q
// = b_q dinv[q] replaces b_q (lanes over the right-hand sides).
template <int H>
__device__ __forceinline__ void warp_forward(const float2* low,
                                             const float* dinv, float2* y,
                                             int n, int k, int q, int lane) {
  const float inv = dinv[q];
  float2 l[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int i = q + 1 + lane + 32 * h;
    l[h] = low[tri(i < n ? i : q) + q];
  }
  for (int c = 0; c < k; c += 2) {
    const bool two = c + 1 < k;
    const float2 b0 = y[q * k + c], b1 = two ? y[q * k + c + 1] : b0;
    const float2 y0 = make_float2(b0.x * inv, b0.y * inv);
    const float2 y1 = make_float2(b1.x * inv, b1.y * inv);
    float2 s0[H], s1[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int i = q + 1 + lane + 32 * h;
      if (i < n) {
        s0[h] = y[i * k + c];
        if (two) s1[h] = y[i * k + c + 1];
      }
    }
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int i = q + 1 + lane + 32 * h;
      if (i < n) {
        s0[h].x -= l[h].x * y0.x - l[h].y * y0.y;
        s0[h].y -= l[h].x * y0.y + l[h].y * y0.x;
        y[i * k + c] = s0[h];
        if (two) {
          s1[h].x -= l[h].x * y1.x - l[h].y * y1.y;
          s1[h].y -= l[h].x * y1.y + l[h].y * y1.x;
          y[i * k + c + 1] = s1[h];
        }
      }
    }
  }
  __syncwarp();
  for (int c = lane; c < k; c += 32) {
    const float2 b = y[q * k + c];
    y[q * k + c] = make_float2(b.x * inv, b.y * inv);
  }
}

// Step q of the in-place back substitution by one warp, H = the 32-row
// chunks above row q: lane l holds rows i = l + 32 h < q and subtracts
// conj(L[q][i]) x_q, x_q = y_q dinv[q]; after
// __syncwarp, x_q replaces y_q.
template <int H>
__device__ __forceinline__ void warp_back(const float2* low,
                                          const float* dinv, float2* y,
                                          int k, int q, int lane) {
  const float inv = dinv[q];
  float2 l[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int i = lane + 32 * h;
    l[h] = low[tri(q) + (i < q ? i : 0)];
  }
  for (int c = 0; c < k; c += 2) {
    const bool two = c + 1 < k;
    const float2 v0 = y[q * k + c], v1 = two ? y[q * k + c + 1] : v0;
    const float2 x0 = make_float2(v0.x * inv, v0.y * inv);
    const float2 x1 = make_float2(v1.x * inv, v1.y * inv);
    float2 s0[H], s1[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int i = lane + 32 * h;
      if (i < q) {
        s0[h] = y[i * k + c];
        if (two) s1[h] = y[i * k + c + 1];
      }
    }
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int i = lane + 32 * h;
      if (i < q) {
        s0[h].x -= l[h].x * x0.x + l[h].y * x0.y;
        s0[h].y -= l[h].x * x0.y - l[h].y * x0.x;
        y[i * k + c] = s0[h];
        if (two) {
          s1[h].x -= l[h].x * x1.x + l[h].y * x1.y;
          s1[h].y -= l[h].x * x1.y - l[h].y * x1.x;
          y[i * k + c + 1] = s1[h];
        }
      }
    }
  }
  __syncwarp();
  for (int c = lane; c < k; c += 32) {
    const float2 v = y[q * k + c];
    y[q * k + c] = make_float2(v.x * inv, v.y * inv);
  }
}

// Factor the matrix in `low` (lower triangle, packed) loaded by `load` on
// the diagonal, then solve for the k columns of `y` in place.  Every lane
// of the calling warp calls it; it begins and ends with __syncwarp.
__device__ void chol_solve_warp(float2* low, float* dinv, float2* y, int n,
                                int k, float load) {
  const int lane = threadIdx.x & 31;
  [[maybe_unused]] long long t = CHOL_CLOCK();
  __syncwarp();
  for (int j = 0; j < n;) {
    if (n - j >= kCholPanel) {
      warp_panel_step<kCholPanel>(low, dinv, n, j, load, lane);
      j += kCholPanel;
    } else {
      warp_panel_step<1>(low, dinv, n, j, load, lane);
      ++j;
    }
    __syncwarp();
  }
  CHOL_PHASE(0, t);
  // L y = b in place: step q subtracts L[i][q] y_q from rows i > q (lane
  // l: rows q + 1 + l + 32 h), then y_q = b_q dinv[q] replaces b_q
  for (int q = 0; q < n; ++q) {
    const int rows = n - 1 - q;
    if (rows > 96) {
      warp_forward<4>(low, dinv, y, n, k, q, lane);
    } else if (rows > 64) {
      warp_forward<3>(low, dinv, y, n, k, q, lane);
    } else if (rows > 32) {
      warp_forward<2>(low, dinv, y, n, k, q, lane);
    } else {
      warp_forward<1>(low, dinv, y, n, k, q, lane);
    }
  }
  __syncwarp();  // y_q of the last step
  CHOL_PHASE(1, t);
  // L^H x = y in place: step q (descending) subtracts conj(L[q][i]) x_q
  // from rows i < q (lane l: rows l + 32 h), then x_q = y_q dinv[q]
  for (int q = n - 1; q >= 0; --q) {
    if (q > 96) {
      warp_back<4>(low, dinv, y, k, q, lane);
    } else if (q > 64) {
      warp_back<3>(low, dinv, y, k, q, lane);
    } else if (q > 32) {
      warp_back<2>(low, dinv, y, k, q, lane);
    } else {
      warp_back<1>(low, dinv, y, k, q, lane);
    }
  }
  __syncwarp();  // x_q of the last step
  CHOL_PHASE(2, t);
}

}  // namespace setk
