// Loaded Hermitian Cholesky solve of one medium system (n <= 128) in
// shared memory: chol_solve, by one thread block (kernel 16, cholesky.cu
// hermitian_solve_kernel), and chol_solve_warp, by one warp (kernel 17,
// cholesky.cu gram_solve_kernel).
//
// The arithmetic of setk_tpu/ops/pallas/cholesky.py _solve_kernel (:39) and
// _gram_solve_kernel (:114): pivots 1 / sqrt(max(A[j][j] - sum_q |L[j][q]|^2
// + load, EPS)), L[i][j] = (A[i][j] - sum_q L[i][q] conj(L[j][q])) * pivot,
// then L y = b and L^H x = y.  The TPU runs the factorization left-looking
// over 128 bins in lanes; here a block owns one system and runs it
// right-looking: step j scales column j and subtracts its rank-one term
// from the trailing triangle, so every entry still receives its terms in
// the order q = 0, 1, ..., j - 1 (the TPU's order), and each step is spread
// over the block (a warp a row, lanes over columns) between two barriers.
// Forward substitution is right-looking too (the TPU's order); back
// substitution subtracts x_q for q descending, the TPU ascending.  The
// plain PyTorch version (ops/cuda/cholesky.py _chol_solve_plain) follows
// these orders.  sqrtf and the divisions are the IEEE ones.
//
// chol_solve_warp is the same solve by one warp, with __syncwarp alone:
// the factorization left-looking, lanes over a column's rows, each entry's
// terms summed in a register; the substitutions in place in y, lanes over
// rows.  Every entry receives the same terms in the same order as in
// chol_solve, by the same expressions: on the CPU the two agree to the bit.
//
// Layouts in shared memory: the lower triangle packed by rows,
// low[tri(i) + j] = A[i][j] for j <= i (8 n (n + 1) / 2 bytes, 14.6 KB at
// n = 60, 66 KB at n = 128); the right-hand sides y (n x k, row-major,
// overwritten by the solution) and, for chol_solve, the scratch z (n x
// k); dinv (n).
#pragma once
#include <cuda_runtime.h>

namespace setk {

constexpr float kCholEps = 1.1920928955078125e-07f;  // float32 epsilon

#ifdef SETK_WPE_PHASES
// tools/wpe_phase_profile.py's build: lane 0 of every warp adds the SM
// cycles since `t` to phase i of kernel 17 (factorization, forward, back,
// the rest) and restarts `t`
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

// Bytes of shared memory chol_solve needs beside its caller's own.
__host__ __device__ inline size_t chol_smem_bytes(int n, int k) {
  return sizeof(float2) * ((size_t)tri(n) + 2 * (size_t)n * k) +
         sizeof(float) * (size_t)n;
}

// The same for chol_solve_warp, which needs no z.
__host__ __device__ inline size_t chol_warp_smem_bytes(int n, int k) {
  return sizeof(float2) * ((size_t)tri(n) + (size_t)n * k) +
         sizeof(float) * (size_t)n;
}

// Factor the matrix in `low` (lower triangle, packed) loaded by `load` on
// the diagonal, then solve for the k columns of `y`.  Every thread of the
// block calls it; it begins and ends with a barrier.
__device__ void chol_solve(float2* low, float* dinv, float2* y, float2* z,
                           int n, int k, float load) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = (nth + 31) >> 5;
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    const float inv = 1.0f / sqrtf(fmaxf(low[tri(j) + j].x + load,
                                         kCholEps));
    for (int i = j + 1 + tid; i < n; i += nth) {
      float2 v = low[tri(i) + j];
      low[tri(i) + j] = make_float2(v.x * inv, v.y * inv);
    }
    if (tid == 0) dinv[j] = inv;
    __syncthreads();
    // A[i][c] -= L[i][j] conj(L[c][j]) for j < c <= i
    for (int i = j + 1 + warp; i < n; i += nwarp) {
      const float2 lij = low[tri(i) + j];
      float2* row = low + tri(i);
      for (int c = j + 1 + lane; c <= i; c += 32) {
        const float2 lcj = low[tri(c) + j];
        float2 s = row[c];
        s.x -= lij.x * lcj.x + lij.y * lcj.y;
        s.y -= lij.y * lcj.x - lij.x * lcj.y;
        row[c] = s;
      }
    }
    __syncthreads();
  }
  // L y = b: y_q = b_q * dinv[q] into z, then b_i -= L[i][q] y_q, i > q
  for (int q = 0; q < n; ++q) {
    const float inv = dinv[q];
    for (int idx = tid; idx < (n - q - 1) * k; idx += nth) {
      const int i = q + 1 + idx / k, c = idx - (idx / k) * k;
      const float2 b = y[q * k + c];
      const float2 yq = make_float2(b.x * inv, b.y * inv);
      const float2 l = low[tri(i) + q];
      float2 s = y[i * k + c];
      s.x -= l.x * yq.x - l.y * yq.y;
      s.y -= l.x * yq.y + l.y * yq.x;
      y[i * k + c] = s;
    }
    for (int c = tid; c < k; c += nth) {
      const float2 b = y[q * k + c];
      z[q * k + c] = make_float2(b.x * inv, b.y * inv);
    }
    __syncthreads();
  }
  // L^H x = y: x_q = z_q * dinv[q] into y, then z_i -= conj(L[q][i]) x_q
  for (int q = n - 1; q >= 0; --q) {
    const float inv = dinv[q];
    for (int idx = tid; idx < q * k; idx += nth) {
      const int i = idx / k, c = idx - i * k;
      const float2 v = z[q * k + c];
      const float2 xq = make_float2(v.x * inv, v.y * inv);
      const float2 l = low[tri(q) + i];
      float2 s = z[i * k + c];
      s.x -= l.x * xq.x + l.y * xq.y;
      s.y -= l.x * xq.y - l.y * xq.x;
      z[i * k + c] = s;
    }
    for (int c = tid; c < k; c += nth) {
      const float2 v = z[q * k + c];
      y[q * k + c] = make_float2(v.x * inv, v.y * inv);
    }
    __syncthreads();
  }
}


// A[i][c] -= L[i][j] conj(L[c][j]) at one pair of the trailing triangle.
__device__ __forceinline__ float2 rank1_term(float2 s, float2 lij,
                                             float2 lcj) {
  s.x -= lij.x * lcj.x + lij.y * lcj.y;
  s.y -= lij.y * lcj.x - lij.x * lcj.y;
  return s;
}

// Column j of the left-looking factorization by one warp, H = the
// column's 32-row chunks: lane l holds rows j + l + 32 h (h < H; the
// diagonal at lane 0) and subtracts their terms for q = 0 ... j - 1 in
// that order from a register, by chol_solve's expression.
template <int H>
__device__ __forceinline__ void warp_column(float2* low, float* dinv, int n,
                                            int j, float load, int lane) {
  const float2* lj = low + tri(j);
  float2 s[H];
  const float2* li[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int r = j + lane + 32 * h;
    li[h] = low + tri(r < n ? r : j);
    s[h] = li[h][r < n ? j : 0];
  }
#pragma unroll 4
  for (int q = 0; q < j; ++q) {
    const float2 b = lj[q];
#pragma unroll
    for (int h = 0; h < H; ++h) s[h] = rank1_term(s[h], li[h][q], b);
  }
  const float inv = __shfl_sync(
      0xffffffffu, 1.0f / sqrtf(fmaxf(s[0].x + load, kCholEps)), 0);
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int r = j + lane + 32 * h;
    if (r == j) {
      low[tri(j) + j] = s[h];
      dinv[j] = inv;
    } else if (r < n) {
      low[tri(r) + j] = make_float2(s[h].x * inv, s[h].y * inv);
    }
  }
}

// Step q of the in-place forward substitution by one warp, H = the 32-row
// chunks below row q: lane l holds rows i = q + 1 + l + 32 h and, a pair
// of right-hand sides at a time (both read before either is written),
// subtracts L[i][q] y_q by chol_solve's expression; after __syncwarp, y_q
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
// conj(L[q][i]) x_q, x_q = y_q dinv[q], by chol_solve's expression; after
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

// chol_solve by the calling warp alone: every lane of the warp calls it,
// and it begins and ends with __syncwarp.  The factorization runs
// left-looking, a column a step (warp_column): every entry receives the
// terms of chol_solve's right-looking update in the same order, so it
// rounds as there.  The substitutions run in place in y (no z: a system
// needs chol_warp_smem_bytes), lanes over rows (warp_forward, warp_back),
// with chol_solve's orders and expressions.
__device__ void chol_solve_warp(float2* low, float* dinv, float2* y, int n,
                                int k, float load) {
  const int lane = threadIdx.x & 31;
  [[maybe_unused]] long long t = CHOL_CLOCK();
  __syncwarp();
  for (int j = 0; j < n; ++j) {
    const int rows = n - j;
    if (rows > 96) {
      warp_column<4>(low, dinv, n, j, load, lane);
    } else if (rows > 64) {
      warp_column<3>(low, dinv, n, j, load, lane);
    } else if (rows > 32) {
      warp_column<2>(low, dinv, n, j, load, lane);
    } else {
      warp_column<1>(low, dinv, n, j, load, lane);
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
