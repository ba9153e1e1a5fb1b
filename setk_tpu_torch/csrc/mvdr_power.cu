// Per-bin beamformer weight solves from mask-weighted covariances (sm_90a).
//
// mvdr_power and capon take one thread per frequency bin, gevd_power and
// pmwf_solve a group of lanes; the N x N recurrences (N <= 8) are
// unrolled by template.  All four kernels share the device helpers below:
// load_herm (0.5 (R + R^H)), equil_cholesky (Jacobi
// equilibration to a unit diagonal, scale 1 where the diagonal is <= 0,
// loading max(eps_rel, 4 N EPS), complex Cholesky with pivots
// rsqrt(max(d, EPS))), equil_solve (forward and back substitution through
// the equilibrated factor, x = D solve(D A D, D b)) and anchor_phase
// (rotate so mic 0 is real-positive, floor EPS).  These copy
// setk_tpu/ops/pallas/mvdr.py:101-205.
//
// mvdr_power_kernel replaces mvdr_power_pallas (:458), body _mvdr_kernel
// (:258) over mvdr_weights_tiles (:208): `iters` power iterations on
// hermitianized Rs from the ramp (k+1)/N renormalized by
// rsqrt(max(|u|^2, EPS^2)), the mic-0 anchor, the equilibrated solve
// Rn x = d and w = x conj(den) / max(|den|^2, EPS^2), den = d^H x.
// Bound: bytes (2 x 9.5 MB in, 1.6 MB out at the bench shape, ~6 us;
// ~5.5 kFLOP a bin, ~3 us).  Rs dies after the power iteration, before
// Rn is read, so both matrices live in registers in turn.
//
// capon_kernel replaces capon_pallas (:523), body _capon_kernel (:307):
// steps 3-5 of the above for a given steer d.  Bound: bytes (R 9.5 MB and
// d 1.6 MB in, 1.6 MB out).  Same design as mvdr_power's second half.
//
// gevd_power_kernel replaces gevd_power_pallas (:474), body _gevd_kernel
// (:271): `iters` power iterations v <- unit(Rn^{-1} Rs v) through the
// equilibrated factor (L L^H = D Rn D + load I), then v^H Rn v = 1
// (rsqrt(max(q, EPS))) and the mic-0 anchor.  With v = D L^{-H} w the step
// is w <- unit(M w), M = L^{-1} (D Rs D) L^{-H} Hermitian: the same
// directions, so the kernel forms M once (2N substitutions), starts from
// w = L^H D^{-1} ramp, iterates a matvec and a norm with no substitution in
// the loop, and maps back once, v = unit(D L^{-H} w), the unit vector the
// loop's last iterate was.  A bin takes G = gevd_lanes(N) lanes (2 from
// N = 2); lane l owns rows l, l + G, ... of M, and w reaches the group by
// shuffles.  Bound: bytes at 30 iterations (2 x 9.5 MB in, 1.6 MB out at
// the bench shape; ~12 kFLOP a bin at N = 6, close behind), operations at
// 50.  On the H100 every lane of a larger group re-forms the factor and an
// iteration's broadcast of w costs 2N shuffles a warp: 4 and 8 lanes were
// slower than the thread-a-bin kernel this replaces, 1 lane (M's upper
// triangle on one thread) no faster than 2 and spilling at N = 8.
//
// pmwf_solve_kernel replaces pmwf_solve_pallas (:493), body _pmwf_kernel
// (:335): W = X conj(tr) / max(|tr|^2, EPS^2) with X = Rn^{-1} Rs and
// tr = trace(X) + beta; optionally the per-channel powers
// ps_c = Re(w_c^H Rs w_c), pn_c = Re(w_c^H Rn w_c) with the raw, unloaded
// Rn.  Bound: bytes (W is as large as Rs).  A bin takes a group of G
// lanes (the power of two >= N), lane c its column c: every lane forms the
// factor in registers (equil_cholesky) and solves X's column through it
// (equil_solve), the trace meets in the group's xor shuffles, and the lane
// scales its column and forms its two powers.  W is assembled in the Rs
// tile and leaves in 16-byte stores; no X goes through device memory.
//
// Both family kernels stage a block's Rs and Rn in dynamic shared memory
// (16-byte loads where the tensor lies on 16 bytes), a bin's matrix
// group_stride float2s apart, so that a half-warp's 8-byte reads of one
// word a group, or of a row's consecutive columns, fall in distinct banks;
// past the 48 KB default (gevd_power at N = 7 and 8) the launch opts in.
// A group past the last bin works on the last bin's tiles and stores
// nothing, and lanes past N repeat lane N - 1's column, so every lane
// meets every shuffle and barrier.
//
// mvdr_power and capon stage their bins' covariances through shared memory
// so the global loads are coalesced (a thread's own matrix is N*N*8
// contiguous bytes).

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kEps = 1.1920928955078125e-07f;  // float32 machine eps
constexpr int kMaxMics = 8;
constexpr int kBlock = 64;        // mvdr_power, capon: a thread a bin
constexpr int kFamThreads = 128;  // gevd_power, pmwf_solve: lane groups

// lanes a bin of pmwf_solve: the power of two >= n
__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// lanes a bin of gevd_power, at most 2: every lane forms the factor and an
// iteration broadcasts w in 2N shuffles, so fewer lanes, each owning more
// rows of M, do less work
__host__ __device__ constexpr int gevd_lanes(int n) {
  return pow2_at_least(n) < 2 ? pow2_at_least(n) : 2;
}

struct cpx {
  float re, im;
};

__device__ __forceinline__ cpx cmul(cpx a, cpx b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

// a * conj(b)
__device__ __forceinline__ cpx cmul_conj(cpx a, cpx b) {
  return {a.re * b.re + a.im * b.im, a.im * b.re - a.re * b.im};
}

// the block's matrices [base, base + nvalid) into a tile, by all BLOCK
// threads
template <int N, int BLOCK>
__device__ __forceinline__ void stage(const float2* __restrict__ src,
                                      float2* tile, long long base,
                                      int nvalid) {
  constexpr int NN = N * N;
  for (int i = threadIdx.x; i < nvalid * NN; i += BLOCK)
    tile[i] = src[base * NN + i];
}

// 0.5 (R + R^H) of the matrix at m into registers
template <int N>
__device__ __forceinline__ void load_herm(const float2* m, cpx (&h)[N][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = i; j < N; ++j) {
      float2 a = m[i * N + j];
      float2 b = m[j * N + i];
      h[i][j] = {0.5f * (a.x + b.x), 0.5f * (a.y - b.y)};
      h[j][i] = {h[i][j].re, -h[i][j].im};
    }
  }
}

// u = M v for the matrix at m (shared memory)
template <int N>
__device__ __forceinline__ void matvec(const float2* m, const cpx (&v)[N],
                                       cpx (&u)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    cpx acc = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float2 e = m[i * N + j];
      cpx p = cmul({e.x, e.y}, v[j]);
      acc.re += p.re;
      acc.im += p.im;
    }
    u[i] = acc;
  }
}

// Re(v^H M v) for the matrix at m (shared memory): the same for M and
// 0.5 (M + M^H)
template <int N>
__device__ __forceinline__ float quad(const float2* m, const cpx (&v)[N]) {
  cpx u[N];
  matvec<N>(m, v, u);
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) acc = acc + v[i].re * u[i].re + v[i].im * u[i].im;
  return acc;
}

// Jacobi equilibration, loading and Cholesky of the Hermitian a, in place:
// the lower triangle of a becomes the factor
template <int N>
__device__ __forceinline__ void equil_cholesky(cpx (&a)[N][N],
                                               float (&dsc)[N],
                                               float (&inv_diag)[N],
                                               float eps_rel) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float dii = a[i][i].re;
    dsc[i] = dii > 0.0f ? rsqrtf(fmaxf(dii, 1e-30f)) : 1.0f;
  }
  const float load = fmaxf(eps_rel, 4.0f * N * kEps);
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      a[i][j] = {a[i][j].re * dsc[i] * dsc[j], a[i][j].im * dsc[i] * dsc[j]};
    }
    a[i][i].re += load;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float dj = a[j][j].re;
#pragma unroll
    for (int q = 0; q < j; ++q)
      dj -= a[j][q].re * a[j][q].re + a[j][q].im * a[j][q].im;
    inv_diag[j] = rsqrtf(fmaxf(dj, kEps));
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      cpx s = a[i][j];
#pragma unroll
      for (int q = 0; q < j; ++q) {
        cpx p = cmul_conj(a[i][q], a[j][q]);
        s.re -= p.re;
        s.im -= p.im;
      }
      a[i][j] = {s.re * inv_diag[j], s.im * inv_diag[j]};
    }
  }
}

// x = D solve(D A D, D b) through the factor in l's lower triangle
template <int N>
__device__ __forceinline__ void equil_solve(const cpx (&l)[N][N],
                                            const float (&dsc)[N],
                                            const float (&inv_diag)[N],
                                            const cpx (&b)[N], cpx (&x)[N]) {
  cpx y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    cpx s = {b[i].re * dsc[i], b[i].im * dsc[i]};
#pragma unroll
    for (int q = 0; q < i; ++q) {
      cpx p = cmul(l[i][q], y[q]);
      s.re -= p.re;
      s.im -= p.im;
    }
    y[i] = {s.re * inv_diag[i], s.im * inv_diag[i]};
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    cpx s = y[i];
#pragma unroll
    for (int q = i + 1; q < N; ++q) {
      cpx p = cmul({l[q][i].re, -l[q][i].im}, x[q]);
      s.re -= p.re;
      s.im -= p.im;
    }
    x[i] = {s.re * inv_diag[i], s.im * inv_diag[i]};
  }
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = {x[i].re * dsc[i], x[i].im * dsc[i]};
}

// d = v rotated so that d[0] is real-positive
template <int N>
__device__ __forceinline__ void anchor_phase(const cpx (&v)[N], cpx (&d)[N]) {
  const float mag = sqrtf(v[0].re * v[0].re + v[0].im * v[0].im);
  const float inv_mag = 1.0f / fmaxf(mag, kEps);
  const cpx p = {v[0].re * inv_mag, -v[0].im * inv_mag};
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = cmul(v[i], p);
}

// v <- u / max(|u|, EPS)
template <int N>
__device__ __forceinline__ void unit(const cpx (&u)[N], cpx (&v)[N]) {
  float nrm2 = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) nrm2 += u[i].re * u[i].re + u[i].im * u[i].im;
  const float inv = rsqrtf(fmaxf(nrm2, kEps * kEps));
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = {u[i].re * inv, u[i].im * inv};
}

// ---- lane groups (gevd_power, pmwf_solve): a bin's G lanes, adjacent in
// one warp ----

// float2s a bin's matrix takes in a tile: >= N * N and an odd multiple of
// G, so a half-warp's 8-byte reads of one word a group, or of a row's
// consecutive columns by a group's lanes, fall in distinct banks
template <int N, int G>
__host__ __device__ constexpr int group_stride() {
  return (N * N + G - 1) / G % 2 ? (N * N + G - 1) / G * G
                                 : ((N * N + G - 1) / G + 1) * G;
}

// float2 i of a block's contiguous run of matrices -> its tile slot
template <int NN, int STRIDE>
__device__ __forceinline__ int tile_at(int i) {
  return i / NN * STRIDE + i % NN;
}

// the block's `count` float2s at src (device memory) into a tile, by all
// kFamThreads threads, 16 bytes a load where src lies on 16 bytes
template <int NN, int STRIDE>
__device__ __forceinline__ void tile_in(const float2* __restrict__ src,
                                        float2* tile, int count) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int k = threadIdx.x; 2 * k + 1 < count; k += kFamThreads) {
      const float4 v = src4[k];
      tile[tile_at<NN, STRIDE>(2 * k)] = make_float2(v.x, v.y);
      tile[tile_at<NN, STRIDE>(2 * k + 1)] = make_float2(v.z, v.w);
    }
    if (count % 2 && threadIdx.x == 0)
      tile[tile_at<NN, STRIDE>(count - 1)] = src[count - 1];
  } else {
    for (int i = threadIdx.x; i < count; i += kFamThreads)
      tile[tile_at<NN, STRIDE>(i)] = src[i];
  }
}

// the tile's first `count` float2s out to dst (device memory), as tile_in
template <int NN, int STRIDE>
__device__ __forceinline__ void tile_out(const float2* tile,
                                         float2* __restrict__ dst,
                                         int count) {
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int k = threadIdx.x; 2 * k + 1 < count; k += kFamThreads) {
      const float2 a = tile[tile_at<NN, STRIDE>(2 * k)];
      const float2 b = tile[tile_at<NN, STRIDE>(2 * k + 1)];
      dst4[k] = make_float4(a.x, a.y, b.x, b.y);
    }
    if (count % 2 && threadIdx.x == 0)
      dst[count - 1] = tile[tile_at<NN, STRIDE>(count - 1)];
  } else {
    for (int i = threadIdx.x; i < count; i += kFamThreads)
      dst[i] = tile[tile_at<NN, STRIDE>(i)];
  }
}

// the sum of x over the group's G lanes, the same bits on every lane
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = G / 2; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// every entry of a vector spread over a group (entry j on lane j % G, as
// own[j / G]) on every lane; src0 is the group's first lane in the warp
template <int N, int G, int R>
__device__ __forceinline__ void gather(const cpx (&own)[R], int src0,
                                       cpx (&all)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if constexpr (G == 1) {
      all[j] = own[j];
    } else {
      all[j] = {__shfl_sync(0xffffffffu, own[j / G].re, src0 + j % G),
                __shfl_sync(0xffffffffu, own[j / G].im, src0 + j % G)};
    }
  }
}

// a[i] for a lane's own i in [0, N), by selects (no local memory)
template <int N, typename T>
__device__ __forceinline__ T pick(const T (&a)[N], int i) {
  T r = a[0];
#pragma unroll
  for (int k = 1; k < N; ++k)
    if (k == i) r = a[k];
  return r;
}

// 0.5 (R + R^H)[i][j] of the matrix at m, the bits load_herm forms
template <int N>
__device__ __forceinline__ cpx herm_at(const float2* m, int i, int j) {
  const float2 a = m[i * N + j], b = m[j * N + i];
  return {0.5f * (a.x + b.x), 0.5f * (a.y - b.y)};
}

// y = L^{-1} b (pivots 1 / inv_diag): equil_solve's forward half
template <int N>
__device__ __forceinline__ void lower_solve(const cpx (&l)[N][N],
                                            const float (&inv_diag)[N],
                                            const cpx (&b)[N], cpx (&y)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    cpx s = b[i];
#pragma unroll
    for (int q = 0; q < i; ++q) {
      cpx p = cmul(l[i][q], y[q]);
      s.re -= p.re;
      s.im -= p.im;
    }
    y[i] = {s.re * inv_diag[i], s.im * inv_diag[i]};
  }
}

// x = L^{-H} y: equil_solve's back half
template <int N>
__device__ __forceinline__ void upper_solve(const cpx (&l)[N][N],
                                            const float (&inv_diag)[N],
                                            const cpx (&y)[N], cpx (&x)[N]) {
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    cpx s = y[i];
#pragma unroll
    for (int q = i + 1; q < N; ++q) {
      cpx p = cmul({l[q][i].re, -l[q][i].im}, x[q]);
      s.re -= p.re;
      s.im -= p.im;
    }
    x[i] = {s.re * inv_diag[i], s.im * inv_diag[i]};
  }
}

// Capon: solve R x = d through the equilibrated factor of the matrix at m
// (the thread's slot of a staged tile), write x / (d^H x) to out
template <int N>
__device__ __forceinline__ void capon_solve(const float2* m,
                                            const cpx (&d)[N], float eps_rel,
                                            float2* out) {
  cpx a[N][N];
  load_herm<N>(m, a);
  float dsc[N], inv_diag[N];
  equil_cholesky<N>(a, dsc, inv_diag, eps_rel);
  cpx x[N];
  equil_solve<N>(a, dsc, inv_diag, d, x);
  cpx den = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    cpx p = cmul({d[i].re, -d[i].im}, x[i]);
    den.re += p.re;
    den.im += p.im;
  }
  const float inv_den =
      1.0f / fmaxf(den.re * den.re + den.im * den.im, kEps * kEps);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    cpx q = cmul_conj(x[i], den);
    out[i] = make_float2(q.re * inv_den, q.im * inv_den);
  }
}

template <int N>
__global__ void __launch_bounds__(kBlock)
mvdr_power_kernel(const float2* __restrict__ rs, const float2* __restrict__ rn,
                  float2* __restrict__ w, int nbins, int iters,
                  float eps_rel) {
  __shared__ float2 tile[kBlock * N * N];
  const long long base = (long long)blockIdx.x * kBlock;
  const int nvalid = min(kBlock, (int)(nbins - base));
  const bool active = threadIdx.x < nvalid;

  // ---- steer vector: power iteration on hermitianized Rs ----
  stage<N, kBlock>(rs, tile, base, nvalid);
  __syncthreads();
  cpx v[N];
  {
    cpx s[N][N];
    if (active) load_herm<N>(tile + threadIdx.x * N * N, s);
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = {(k + 1.0f) / N, 0.0f};
    if (active) {
#pragma unroll 1
      for (int it = 0; it < iters; ++it) {
        cpx u[N];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          cpx acc = {0.0f, 0.0f};
#pragma unroll
          for (int j = 0; j < N; ++j) {
            cpx p = cmul(s[i][j], v[j]);
            acc.re += p.re;
            acc.im += p.im;
          }
          u[i] = acc;
        }
        unit<N>(u, v);
      }
    }
  }
  __syncthreads();  // every thread is done with the Rs tile
  cpx d[N];
  anchor_phase<N>(v, d);

  // ---- Capon solve against Rn ----
  stage<N, kBlock>(rn, tile, base, nvalid);
  __syncthreads();
  if (!active) return;
  capon_solve<N>(tile + threadIdx.x * N * N, d, eps_rel,
                 w + (base + threadIdx.x) * N);
}

template <int N>
__global__ void __launch_bounds__(kBlock)
capon_kernel(const float2* __restrict__ steer, const float2* __restrict__ r,
             float2* __restrict__ w, int nbins, float eps_rel) {
  __shared__ float2 tile[kBlock * N * N];
  const long long base = (long long)blockIdx.x * kBlock;
  const int nvalid = min(kBlock, (int)(nbins - base));
  stage<N, kBlock>(r, tile, base, nvalid);
  __syncthreads();
  if (threadIdx.x >= nvalid) return;
  const float2* ds = steer + (base + threadIdx.x) * N;
  cpx d[N];
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = {ds[i].x, ds[i].y};
  capon_solve<N>(tile + threadIdx.x * N * N, d, eps_rel,
                 w + (base + threadIdx.x) * N);
}

template <int N>
__global__ void __launch_bounds__(kFamThreads)
gevd_power_kernel(const float2* __restrict__ rs, const float2* __restrict__ rn,
                  float2* __restrict__ w, int nbins, int iters,
                  float eps_rel) {
  constexpr int G = gevd_lanes(N), R = (N + G - 1) / G, NN = N * N;
  constexpr int S = group_stride<N, G>(), BINS = kFamThreads / G;
  extern __shared__ float2 fam_tiles[];
  float2* ts = fam_tiles;  // Rs, then Z = L^{-1} D Rs D
  float2* tn = ts + BINS * S;
  const long long base = (long long)blockIdx.x * BINS;
  const int nvalid = min(BINS, (int)(nbins - base));
  tile_in<NN, S>(rs + base * NN, ts, nvalid * NN);
  tile_in<NN, S>(rn + base * NN, tn, nvalid * NN);
  __syncthreads();
  const int g = threadIdx.x / G, lane = threadIdx.x % G;
  const int src0 = (threadIdx.x & 31) - lane;
  const float2* ms = ts + min(g, nvalid - 1) * S;
  const float2* mn = tn + min(g, nvalid - 1) * S;

  cpx l[N][N];
  float dsc[N], inv_diag[N];
  load_herm<N>(mn, l);
  equil_cholesky<N>(l, dsc, inv_diag, eps_rel);

  // the lane's columns c = lane + r G of Z = L^{-1} (D Rs D)
  cpx z[R][N];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = min(lane + r * G, N - 1);
    const float dc = pick<N>(dsc, c);
    cpx b[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const cpx h = herm_at<N>(ms, i, c);
      b[i] = {h.re * dsc[i] * dc, h.im * dsc[i] * dc};
    }
    lower_solve<N>(l, inv_diag, b, z[r]);
  }
  // the lane's rows c of M = L^{-1} Z^H: conj(L^{-1} conj(Z[c][:])), Z's
  // rows from the group's columns through the Rs tile
  __syncthreads();  // every group is done with the Rs tile
  float2* zt = ts + g * S;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = lane + r * G;
    if (c < N) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        zt[i * N + c] = make_float2(z[r][i].re, z[r][i].im);
    }
  }
  __syncthreads();
  cpx m[R][N];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = min(lane + r * G, N - 1);
    cpx b[N], y[N];
#pragma unroll
    for (int j = 0; j < N; ++j) b[j] = {zt[c * N + j].x, -zt[c * N + j].y};
    lower_solve<N>(l, inv_diag, b, y);
#pragma unroll
    for (int j = 0; j < N; ++j) m[r][j] = {y[j].re, -y[j].im};
  }

  // w = L^H D^{-1} ramp, so that D L^{-H} w is the ramp
  cpx wo[R];
  {
    cpx t[N], w0[N];
#pragma unroll
    for (int i = 0; i < N; ++i) t[i] = {(i + 1.0f) / N / dsc[i], 0.0f};
#pragma unroll
    for (int i = 0; i < N; ++i) {
      cpx s = {t[i].re / inv_diag[i], 0.0f};
#pragma unroll
      for (int j = i + 1; j < N; ++j) {
        cpx p = cmul({l[j][i].re, -l[j][i].im}, t[j]);
        s.re += p.re;
        s.im += p.im;
      }
      w0[i] = s;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) wo[r] = pick<N>(w0, min(lane + r * G, N - 1));
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    cpx wf[N];
    gather<N, G, R>(wo, src0, wf);
    float n2 = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      cpx u = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < N; ++j) {
        cpx p = cmul(m[r][j], wf[j]);
        u.re += p.re;
        u.im += p.im;
      }
      wo[r] = u;
      if (lane + r * G < N) n2 += u.re * u.re + u.im * u.im;
    }
    const float inv = rsqrtf(fmaxf(group_sum<G>(n2), kEps * kEps));
#pragma unroll
    for (int r = 0; r < R; ++r) wo[r] = {wo[r].re * inv, wo[r].im * inv};
  }
  // v = unit(D L^{-H} w), the unit vector the loop's last iterate was
  cpx v[N];
  if (iters > 0) {
    cpx wf[N], x[N];
    gather<N, G, R>(wo, src0, wf);
    upper_solve<N>(l, inv_diag, wf, x);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = {x[i].re * dsc[i], x[i].im * dsc[i]};
    unit<N>(x, v);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = {(k + 1.0f) / N, 0.0f};
  }
  // v^H Rn v = 1 with the raw Rn (the lane's rows), then the mic-0 anchor
  float q = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = lane + r * G;
    if (c < N) {
      cpx acc = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float2 e = mn[c * N + j];
        cpx p = cmul({e.x, e.y}, v[j]);
        acc.re += p.re;
        acc.im += p.im;
      }
      const cpx vc = pick<N>(v, c);
      q += vc.re * acc.re + vc.im * acc.im;
    }
  }
  const float scale = rsqrtf(fmaxf(group_sum<G>(q), kEps));
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = {v[i].re * scale, v[i].im * scale};
  cpx d[N];
  anchor_phase<N>(v, d);
  if (g < nvalid) {
    float2* out = w + (base + g) * N;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = lane + r * G;
      if (c < N) {
        const cpx dc = pick<N>(d, c);
        out[c] = make_float2(dc.re, dc.im);
      }
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kFamThreads)
pmwf_solve_kernel(const float2* __restrict__ rs, const float2* __restrict__ rn,
                  float2* __restrict__ w, float* __restrict__ ps,
                  float* __restrict__ pn, int nbins, float beta,
                  float eps_rel) {
  constexpr int G = pow2_at_least(N), NN = N * N;
  constexpr int S = group_stride<N, G>(), BINS = kFamThreads / G;
  extern __shared__ float2 fam_tiles[];
  float2* ts = fam_tiles;  // Rs, then W
  float2* tn = ts + BINS * S;
  const long long base = (long long)blockIdx.x * BINS;
  const int nvalid = min(BINS, (int)(nbins - base));
  tile_in<NN, S>(rs + base * NN, ts, nvalid * NN);
  tile_in<NN, S>(rn + base * NN, tn, nvalid * NN);
  __syncthreads();
  const int g = threadIdx.x / G, lane = threadIdx.x % G;
  const int c = min(lane, N - 1);  // the lane's column
  const bool owner = g < nvalid && lane < N;
  const float2* ms = ts + min(g, nvalid - 1) * S;
  const float2* mn = tn + min(g, nvalid - 1) * S;

  cpx l[N][N];
  float dsc[N], inv_diag[N];
  load_herm<N>(mn, l);
  equil_cholesky<N>(l, dsc, inv_diag, eps_rel);
  // column c of X = D solve(D A D, D Rs e_c)
  cpx b[N], x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) b[i] = herm_at<N>(ms, i, c);
  equil_solve<N>(l, dsc, inv_diag, b, x);
  // tr = trace(X) + beta; lanes past N add nothing
  cpx t = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i == lane) t = x[i];
  t = {group_sum<G>(t.re) + beta, group_sum<G>(t.im)};
  const float inv_den = 1.0f / fmaxf(t.re * t.re + t.im * t.im, kEps * kEps);
  // column c of W, and its powers
#pragma unroll
  for (int i = 0; i < N; ++i) {
    cpx q = cmul_conj(x[i], t);
    x[i] = {q.re * inv_den, q.im * inv_den};
  }
  const long long bin = base + g;
  if (ps != nullptr) {
    const float p_s = quad<N>(ms, x), p_n = quad<N>(mn, x);
    if (owner) {
      ps[bin * N + lane] = p_s;
      pn[bin * N + lane] = p_n;
    }
  }
  __syncthreads();  // every group is done with the Rs tile
  if (owner) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      ts[g * S + i * N + lane] = make_float2(x[i].re, x[i].im);
  }
  __syncthreads();
  tile_out<NN, S>(ts, w + base * NN, nvalid * NN);
}

// dynamic shared memory of a family kernel with `tiles` tiles: over the
// 48 KB default for gevd_power at N = 7 and 8 (50 and 66 KB)
template <int N, int G>
constexpr int fam_smem_bytes(int tiles) {
  return tiles * (kFamThreads / G) * group_stride<N, G>() *
         (int)sizeof(float2);
}

// a kernel's opt-in to `bytes` of dynamic shared memory past the default
template <typename K>
int opt_in(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

inline int grid_for(int nbins, int block) { return (nbins + block - 1) / block; }

// call f(std::integral_constant<int, n>{}) for 1 <= n <= kMaxMics, then
// return the error f returned, if it returns one, or the launch's; n
// outside that range is refused
template <int N = 1, typename F>
int with_mics(int n, F f) {
  if constexpr (N > kMaxMics) {
    return cudaErrorInvalidValue;
  } else {
    if (n != N) return with_mics<N + 1>(n, f);
    using Mics = std::integral_constant<int, N>;
    if constexpr (std::is_same_v<decltype(f(Mics{})), int>) {
      const int err = f(Mics{});
      if (err != cudaSuccess) return err;
    } else {
      f(Mics{});
    }
    return cudaGetLastError();
  }
}

}  // namespace

// rs, rn: (nbins, n, n) complex64; w: (nbins, n) complex64; 1 <= n <= 8.
extern "C" int mvdr_power_launch(const void* rs, const void* rn, void* w,
                                 int nbins, int n, int iters, float eps_rel,
                                 void* stream) {
  if (nbins <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float2*>(rs);
  auto b = static_cast<const float2*>(rn);
  auto o = static_cast<float2*>(w);
  return with_mics(n, [&](auto mics) {
    constexpr int N = decltype(mics)::value;
    mvdr_power_kernel<N><<<grid_for(nbins, kBlock), kBlock, 0, s>>>(
        a, b, o, nbins, iters, eps_rel);
  });
}

// steer: (nbins, n) complex64; r: (nbins, n, n); w: (nbins, n); nbins >= 1.
extern "C" int capon_launch(const void* steer, const void* r, void* w,
                            int nbins, int n, float eps_rel, void* stream) {
  if (nbins <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto d = static_cast<const float2*>(steer);
  auto a = static_cast<const float2*>(r);
  auto o = static_cast<float2*>(w);
  return with_mics(n, [&](auto mics) {
    constexpr int N = decltype(mics)::value;
    capon_kernel<N><<<grid_for(nbins, kBlock), kBlock, 0, s>>>(d, a, o, nbins,
                                                               eps_rel);
  });
}

// rs, rn: (nbins, n, n) complex64; w: (nbins, n) complex64; nbins >= 1.
extern "C" int gevd_power_launch(const void* rs, const void* rn, void* w,
                                 int nbins, int n, int iters, float eps_rel,
                                 void* stream) {
  if (nbins <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float2*>(rs);
  auto b = static_cast<const float2*>(rn);
  auto o = static_cast<float2*>(w);
  return with_mics(n, [&](auto mics) {
    constexpr int N = decltype(mics)::value;
    constexpr int G = gevd_lanes(N);
    constexpr int smem = fam_smem_bytes<N, G>(2);  // Rs (then Z), Rn
    const int err = opt_in(gevd_power_kernel<N>, smem);
    if (err != cudaSuccess) return err;
    gevd_power_kernel<N><<<grid_for(nbins, kFamThreads / G), kFamThreads,
                           smem, s>>>(a, b, o, nbins, iters, eps_rel);
    return (int)cudaSuccess;
  });
}

// rs, rn, w: (nbins, n, n) complex64; ps, pn: (nbins, n) float32, or both
// null for no powers; nbins >= 1.
extern "C" int pmwf_solve_launch(const void* rs, const void* rn, void* w,
                                 void* ps, void* pn, int nbins, int n,
                                 float beta, float eps_rel, void* stream) {
  if (nbins <= 0 || (ps == nullptr) != (pn == nullptr))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float2*>(rs);
  auto b = static_cast<const float2*>(rn);
  auto o = static_cast<float2*>(w);
  auto p = static_cast<float*>(ps);
  auto q = static_cast<float*>(pn);
  return with_mics(n, [&](auto mics) {
    constexpr int N = decltype(mics)::value;
    constexpr int G = pow2_at_least(N);
    constexpr int smem = fam_smem_bytes<N, G>(2);  // Rs (then W), Rn
    const int err = opt_in(pmwf_solve_kernel<N>, smem);
    if (err != cudaSuccess) return err;
    pmwf_solve_kernel<N><<<grid_for(nbins, kFamThreads / G), kFamThreads,
                           smem, s>>>(a, b, o, p, q, nbins, beta, eps_rel);
    return (int)cudaSuccess;
  });
}
