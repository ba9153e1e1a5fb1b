// Kernels 16 and 17 (sm_90a): loaded Hermitian Cholesky solves of medium
// systems (n <= 128), each one system a warp over cholesky.cuh's
// chol_solve_warp, several systems a block.
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
// GFLOP in all (~0.06 ms at 67 TFLOP/s f32), against 284 MB of A, b and x
// for kernel 16 (~0.085 ms at 3.35 TB/s) and the 170 MB of Gram that
// kernel 17 reads.  Neither bound is near: the factorization is a chain of
// n steps, each a column that shrinks to nothing.  A warp owns a system
// and meets at __syncwarp alone (chol_solve_warp): the factorization
// left-looking, lanes over a column's rows, each entry's terms summed in
// a register; the substitutions in place, lanes over rows.  Its floor is
// shared-memory traffic, ~n^3 / 6 updates of two 8-byte reads a system.
// A block holds the systems that let an SM hold the most
// (systems_per_block: at n = 60 six a block, two blocks an SM).  Both
// kernels read a system with kLoadU reads in flight a lane, lanes over
// consecutive entries of a row.  Kernel 16 reads
// A's lower triangle into the packed triangle, then (hermitianizing) its
// strict upper triangle row by row and folds each entry into its mirror,
// 0.5 (A[j][i] + conj A[i][j]): every byte of A once, in coalesced reads.
// (A block a system, two block barriers a factorization step, and the
// upper triangle read down columns ran ~1.3x slower.)  The trace is
// summed by lane 0 over the staged diagonal in row order, as kernel 17
// sums it, so that on the CPU the two kernels give the same system the
// same bits.  As first written, kernel 17 ran right-looking with lanes
// over the trailing triangle's (row, column) pairs and was slower than a
// block a system: its index arithmetic made it bound by instructions at
// ~10 warps an SM.  At n = 128 the triangle is 66 KB: above the 48 KB of
// static shared memory, so the launches opt in to dynamic shared memory
// up to 227 KB.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cholesky.cuh"

namespace {

// global reads in flight a lane (kernel 16 on an H100 at the WPE scene:
// 0.898 ms at 8, 0.925 at 4, 1.017 at 16, 0.926 at 32)
constexpr int kLoadU = 8;
constexpr float kTiny = 1e-30f;

// Kernel 17's shared memory a system: low, y, dinv (chol_solve_warp's),
// then sc, rounded up to 16 bytes.
size_t system_bytes(int n, int k) {
  return (setk::chol_warp_smem_bytes(n, k) + sizeof(float) * n + 15) / 16 *
         16;
}

// Kernel 17's arrays a system: low, y, dinv, sc.
struct WarpSmem {
  float2 *low, *y;
  float *dinv, *sc;
};

__device__ WarpSmem carve_warp(float2* base, int n, int k) {
  WarpSmem s;
  s.low = base;
  s.y = s.low + setk::tri(n);
  s.dinv = reinterpret_cast<float*>(s.y + n * k);
  s.sc = s.dinv + n;
  return s;
}

constexpr int kSmBytes = 233472;     // an H100 SM's shared memory
constexpr int kBlockReserve = 1024;  // the runtime's share of it a block
constexpr int kMaxSystems = 8;       // systems (warps) a block

// Systems a block of kernel 16 or 17 (`per` bytes each): the count in
// 1 ... kMaxSystems that lets an SM hold the most systems (the larger on a
// tie), 0 when none fits.  Kernel 17 at n = 60, k = 6 (18,000 bytes a
// system) 6 a block, two blocks an SM; at n = 128, k = 8 (75,264 bytes) 3
// a block, one block.
int systems_per_block(size_t per) {
  int best = 0, best_s = 0;
  for (int s = 1; s <= kMaxSystems && s * per <= 227 * 1024; ++s) {
    // at most 32 blocks and 64 warps an SM
    const int cap = 64 / s < 32 ? 64 / s : 32;
    const int fit = (int)(kSmBytes / (s * per + kBlockReserve));
    const int blocks = fit < cap ? fit : cap;
    if (s * blocks >= best) {
      best = s * blocks;
      best_s = s;
    }
  }
  return best_s;
}

// Kernel 17: a warp a system, several systems a block, __syncwarp only.  A
// warp past the last system solves the last one again and stores nothing,
// so that every warp of a block runs the same trip counts.
template <int EQ>
__global__ void __launch_bounds__(32 * kMaxSystems)
gram_solve_kernel(const float2* __restrict__ gram, float2* __restrict__ x,
                  int bins, int g, int row0, int n, int k, float eps_rel,
                  int per) {
  extern __shared__ float2 smem[];
  [[maybe_unused]] long long t = CHOL_CLOCK();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int sys = blockIdx.x * (blockDim.x >> 5) + w;
  const WarpSmem s = carve_warp(smem + (size_t)w * per, n, k);
  const float2* gb = gram + (size_t)min(sys, bins - 1) * g * g;
  const float2* corr = gb + (size_t)row0 * g + row0;
  for (int j = lane; j < n; j += 32) {
    const float dj = corr[(size_t)j * g + j].x;
    s.sc[j] = (EQ && dj > kTiny) ? 1.0f / sqrtf(fmaxf(dj, kTiny)) : 1.0f;
  }
  __syncwarp();
  // the lower triangle, lanes over its packed entries e = tri(i) + c,
  // kLoadU global reads in flight a lane
  const int ne = setk::tri(n);
  for (int e0 = lane; e0 < ne; e0 += 32 * kLoadU) {
    int at[kLoadU], row[kLoadU], col[kLoadU];
    float2 v[kLoadU];
#pragma unroll
    for (int u = 0; u < kLoadU; ++u) {
      const int e = e0 + 32 * u;
      at[u] = -1;
      if (e < ne) {
        int i = (int)((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
        if (setk::tri(i + 1) <= e) ++i;
        if (setk::tri(i) > e) --i;
        at[u] = e;
        row[u] = i;
        col[u] = e - setk::tri(i);
        v[u] = corr[(size_t)i * g + col[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadU; ++u) {
      if (at[u] >= 0) {
        if (EQ) {
          const float f = s.sc[row[u]] * s.sc[col[u]];
          v[u] = make_float2(v[u].x * f, v[u].y * f);
        }
        s.low[at[u]] = v[u];
      }
    }
  }
  for (int i0 = lane; i0 < n * k; i0 += 32 * kLoadU) {
    float2 v[kLoadU];
#pragma unroll
    for (int u = 0; u < kLoadU; ++u) {
      const int idx = i0 + 32 * u;
      if (idx < n * k) {
        const int r = idx / k;
        v[u] = gb[(size_t)(row0 + r) * g + idx - r * k];
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadU; ++u) {
      const int idx = i0 + 32 * u;
      if (idx < n * k) {
        const float f = s.sc[idx / k];
        s.y[idx] = make_float2(v[u].x * f, v[u].y * f);
      }
    }
  }
  __syncwarp();
  float load = eps_rel;
  if (!EQ) {
    float tr = 0.0f;
    if (lane == 0) {
#pragma unroll 8
      for (int j = 0; j < n; ++j) tr += s.low[setk::tri(j) + j].x;
    }
    load = (eps_rel / n) * __shfl_sync(0xffffffffu, tr, 0) + setk::kCholEps;
  }
  CHOL_PHASE(3, t);
  setk::chol_solve_warp(s.low, s.dinv, s.y, n, k, load);
  t = CHOL_CLOCK();
  if (sys < bins) {
    float2* xb = x + (size_t)sys * n * k;
    for (int idx = lane; idx < n * k; idx += 32) {
      const float f = s.sc[idx / k];
      xb[idx] = make_float2(s.y[idx].x * f, s.y[idx].y * f);
    }
  }
  CHOL_PHASE(3, t);
}

// Kernel 16's shared memory a system: chol_solve_warp's low, y and dinv,
// rounded up to 16 bytes.
size_t lanes_system_bytes(int n, int k) {
  return (setk::chol_warp_smem_bytes(n, k) + 15) / 16 * 16;
}

// Row i and column c of entry e of a lower triangle packed by rows.
__device__ __forceinline__ void packed_entry(int e, int& i, int& c) {
  i = (int)((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
  if (setk::tri(i + 1) <= e) ++i;
  if (setk::tri(i) > e) --i;
  c = e - setk::tri(i);
}

// Kernel 16's system into `low` by the calling warp: A's lower triangle
// (lanes over its packed entries, i.e. along A's rows), then with HERM
// the strict upper triangle, rows bottom up and lanes along a row, each
// entry A[i][j] folded into its mirror: 0.5 (A[j][i] + conj A[i][j]).
template <int HERM>
__device__ void load_system(float2* low, const float2* ab, int n, int lane) {
  const int ne = setk::tri(n);
  for (int e0 = lane; e0 < ne; e0 += 32 * kLoadU) {
    int at[kLoadU];
    bool diag[kLoadU];
    float2 v[kLoadU];
#pragma unroll
    for (int u = 0; u < kLoadU; ++u) {
      const int e = e0 + 32 * u;
      at[u] = -1;
      if (e < ne) {
        int i, c;
        packed_entry(e, i, c);
        at[u] = e;
        diag[u] = HERM && c == i;
        v[u] = ab[(size_t)i * n + c];
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadU; ++u) {
      if (at[u] >= 0) {
        low[at[u]] = diag[u] ? make_float2(0.5f * (v[u].x + v[u].x),
                                           0.5f * (v[u].y - v[u].y))
                             : v[u];
      }
    }
  }
  if (!HERM) return;
  __syncwarp();  // the lower triangle in
  // strict upper row i = n - 2 - r holds r + 1 entries A[i][n - 1 - r + c]
  const int nu = setk::tri(n - 1);
  for (int e0 = lane; e0 < nu; e0 += 32 * kLoadU) {
    int at[kLoadU];
    float2 v[kLoadU];
#pragma unroll
    for (int u = 0; u < kLoadU; ++u) {
      const int e = e0 + 32 * u;
      at[u] = -1;
      if (e < nu) {
        int r, c;
        packed_entry(e, r, c);
        const int i = n - 2 - r, j = n - 1 - r + c;
        at[u] = setk::tri(j) + i;
        v[u] = ab[(size_t)i * n + j];
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadU; ++u) {
      if (at[u] >= 0) {
        const float2 w = low[at[u]];
        low[at[u]] = make_float2(0.5f * (w.x + v[u].x), 0.5f * (w.y - v[u].y));
      }
    }
  }
}

// Kernel 16: a warp a system, several systems a block, __syncwarp only.  A
// warp past the last system solves the last one again and stores nothing,
// so that every warp of a block runs the same trip counts.
template <int HERM>
__global__ void __launch_bounds__(32 * kMaxSystems)
hermitian_solve_kernel(const float2* __restrict__ a,
                       const float2* __restrict__ b, float2* __restrict__ x,
                       int bins, int n, int k, float eps_rel, int per) {
  extern __shared__ float2 smem[];
  [[maybe_unused]] long long t = CHOL_CLOCK();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int sys = blockIdx.x * (blockDim.x >> 5) + w;
  float2* low = smem + (size_t)w * per;
  float2* y = low + setk::tri(n);
  float* dinv = reinterpret_cast<float*>(y + n * k);
  const size_t s = min(sys, bins - 1);
  load_system<HERM>(low, a + s * n * n, n, lane);
  const float2* bb = b + s * n * k;
  for (int i0 = lane; i0 < n * k; i0 += 32 * kLoadU) {
    float2 v[kLoadU];
#pragma unroll
    for (int u = 0; u < kLoadU; ++u) {
      if (i0 + 32 * u < n * k) v[u] = bb[i0 + 32 * u];
    }
#pragma unroll
    for (int u = 0; u < kLoadU; ++u) {
      if (i0 + 32 * u < n * k) y[i0 + 32 * u] = v[u];
    }
  }
  __syncwarp();
  float tr = 0.0f;
  if (lane == 0) {
#pragma unroll 8
    for (int j = 0; j < n; ++j) tr += low[setk::tri(j) + j].x;
  }
  const float load =
      (eps_rel / n) * __shfl_sync(0xffffffffu, tr, 0) + setk::kCholEps;
  CHOL_PHASE(3, t);
  setk::chol_solve_warp(low, dinv, y, n, k, load);
  t = CHOL_CLOCK();
  if (sys < bins) {
    float2* xb = x + (size_t)sys * n * k;
    for (int idx = lane; idx < n * k; idx += 32) xb[idx] = y[idx];
  }
  CHOL_PHASE(3, t);
}

template <typename K>
int opt_in(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// opt_in, and the largest shared-memory carveout, so that an SM holds as
// many of kernel 17's blocks as its 228 KB allow
template <typename K>
int carve_out(K kernel, size_t bytes) {
  const int err = opt_in(kernel, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// a: (bins, n, n) complex64, b and x: (bins, n, k) complex64.
// 1 <= n <= 128, k >= 1 within the 227 KB of shared memory a block has.
extern "C" int hermitian_solve_launch(const void* a, const void* b, void* x,
                                      int bins, int n, int k, float eps_rel,
                                      int hermitianize, void* stream) {
  if (bins < 1 || n < 1 || n > 128 || k < 1) return cudaErrorInvalidValue;
  const size_t per = lanes_system_bytes(n, k);
  const int spb = systems_per_block(per);
  if (spb < 1) return cudaErrorInvalidValue;
  const size_t bytes = per * spb;
  const int blocks = (bins + spb - 1) / spb, per_f2 = (int)(per / 8);
  auto st = static_cast<cudaStream_t>(stream);
  auto aa = static_cast<const float2*>(a);
  auto bb = static_cast<const float2*>(b);
  auto xx = static_cast<float2*>(x);
  int err;
  if (hermitianize) {
    err = carve_out(hermitian_solve_kernel<1>, bytes);
    if (err != cudaSuccess) return err;
    hermitian_solve_kernel<1><<<blocks, 32 * spb, bytes, st>>>(
        aa, bb, xx, bins, n, k, eps_rel, per_f2);
  } else {
    err = carve_out(hermitian_solve_kernel<0>, bytes);
    if (err != cudaSuccess) return err;
    hermitian_solve_kernel<0><<<blocks, 32 * spb, bytes, st>>>(
        aa, bb, xx, bins, n, k, eps_rel, per_f2);
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
  const size_t per = system_bytes(n, k);
  const int spb = systems_per_block(per);
  if (spb < 1) return cudaErrorInvalidValue;
  const size_t bytes = per * spb;
  const int blocks = (bins + spb - 1) / spb, per_f2 = (int)(per / 8);
  auto st = static_cast<cudaStream_t>(stream);
  auto gg = static_cast<const float2*>(gram);
  auto xx = static_cast<float2*>(x);
  int err;
  if (equilibrate) {
    err = carve_out(gram_solve_kernel<1>, bytes);
    if (err != cudaSuccess) return err;
    gram_solve_kernel<1><<<blocks, 32 * spb, bytes, st>>>(
        gg, xx, bins, g, row0, n, k, eps_rel, per_f2);
  } else {
    err = carve_out(gram_solve_kernel<0>, bytes);
    if (err != cudaSuccess) return err;
    gram_solve_kernel<0><<<blocks, 32 * spb, bytes, st>>>(
        gg, xx, bins, g, row0, n, k, eps_rel, per_f2);
  }
  return cudaGetLastError();
}

// Kernel 17's layout at (n, k): out[0] systems a block, out[1] bytes of
// shared memory a system; nonzero where no system fits a block.
extern "C" int gram_solve_layout(int n, int k, int* out) {
  if (n < 1 || n > 128 || k < 1) return cudaErrorInvalidValue;
  const size_t per = system_bytes(n, k);
  out[0] = systems_per_block(per);
  out[1] = (int)per;
  return out[0] < 1 ? cudaErrorInvalidValue : cudaSuccess;
}

// Kernel 16's layout at (n, k), as gram_solve_layout's.
extern "C" int hermitian_solve_layout(int n, int k, int* out) {
  if (n < 1 || n > 128 || k < 1) return cudaErrorInvalidValue;
  const size_t per = lanes_system_bytes(n, k);
  out[0] = systems_per_block(per);
  out[1] = (int)per;
  return out[0] < 1 ? cudaErrorInvalidValue : cudaSuccess;
}

#ifdef SETK_WPE_PHASES
// the phase counters of the instrumented build: read (4 values) and zero
extern "C" int chol_phase_read(unsigned long long* out) {
  int err = cudaMemcpyFromSymbol(out, setk::g_chol_phase, 4 * 8);
  if (err != cudaSuccess) return err;
  const unsigned long long zero[4] = {0, 0, 0, 0};
  return cudaMemcpyToSymbol(setk::g_chol_phase, zero, 4 * 8);
}
#endif
