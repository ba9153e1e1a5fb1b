// Per-bin beamformer weight solves from mask-weighted covariances (sm_90a).
//
// One thread per frequency bin; the N x N recurrences (N <= 8) are
// unrolled by template.  All four kernels share the device helpers below:
// load_herm / herm_in_place (0.5 (R + R^H)), equil_cholesky (Jacobi
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
// equilibrated factor, then v^H Rn v = 1 (rsqrt(max(q, EPS))) and the
// mic-0 anchor.  Bound: operations at 30-50 iterations (each a matvec and
// a two-sided triangular solve, ~0.6 kFLOP a bin at N = 6).
// pmwf_solve_kernel replaces pmwf_solve_pallas (:493), body _pmwf_kernel
// (:335): W = X conj(tr) / max(|tr|^2, EPS^2) with X = Rn^{-1} Rs solved
// column by column and tr = trace(X) + beta; optionally the per-channel
// powers ps_c = Re(w_c^H Rs w_c), pn_c = Re(w_c^H Rn w_c) with the raw,
// unloaded hermitianized Rn.  Bound: bytes (W is as large as Rs).
// Registers are their trap: Rs and the factor, or Rs, the factor and X,
// do not fit in 255 registers at N = 8.  So both keep the hermitianized
// Rs and Rn in shared memory (rows padded to an odd float2 stride, so a
// warp's 8-byte reads are free of bank conflicts) and only the factor in
// registers; pmwf writes X's columns to W as they are solved and scales
// them by the trace afterwards, reading each column back.  32 threads a
// block keep two tiles under 48 KB of static shared memory at N = 8.
//
// Every block stages its bins' covariances through shared memory so the
// global loads are coalesced (a thread's own matrix is N*N*8 contiguous
// bytes).

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr float kEps = 1.1920928955078125e-07f;  // float32 machine eps
constexpr int kMaxMics = 8;
constexpr int kBlock = 64;     // mvdr_power, capon: matrices in registers
constexpr int kFamBlock = 32;  // gevd_power, pmwf_solve: two tiles kept

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

// odd float2 row stride for a kept tile: conflict-free 8-byte reads
template <int N>
__host__ __device__ constexpr int padded_stride() {
  return (N * N) % 2 ? N * N : N * N + 1;
}

// the block's matrices [base, base + nvalid) into a tile, STRIDE float2s
// apart, by all BLOCK threads
template <int N, int BLOCK, int STRIDE>
__device__ __forceinline__ void stage(const float2* __restrict__ src,
                                      float2* tile, long long base,
                                      int nvalid) {
  constexpr int NN = N * N;
  for (int i = threadIdx.x; i < nvalid * NN; i += BLOCK) {
    if constexpr (STRIDE == NN)
      tile[i] = src[base * NN + i];
    else
      tile[(i / NN) * STRIDE + i % NN] = src[base * NN + i];
  }
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

// 0.5 (R + R^H) of the thread's own matrix at m, in place
template <int N>
__device__ __forceinline__ void herm_in_place(float2* m) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = i; j < N; ++j) {
      float2 a = m[i * N + j];
      float2 b = m[j * N + i];
      float2 h = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
      m[i * N + j] = h;
      m[j * N + i] = make_float2(h.x, -h.y);
    }
  }
}

// u = M v for the Hermitian matrix at m (shared memory)
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

// Re(v^H M v) for the Hermitian matrix at m (shared memory)
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
  stage<N, kBlock, N * N>(rs, tile, base, nvalid);
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
  stage<N, kBlock, N * N>(rn, tile, base, nvalid);
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
  stage<N, kBlock, N * N>(r, tile, base, nvalid);
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
__global__ void __launch_bounds__(kFamBlock)
gevd_power_kernel(const float2* __restrict__ rs, const float2* __restrict__ rn,
                  float2* __restrict__ w, int nbins, int iters,
                  float eps_rel) {
  constexpr int S = padded_stride<N>();
  __shared__ float2 ts[kFamBlock * S];
  __shared__ float2 tn[kFamBlock * S];
  const long long base = (long long)blockIdx.x * kFamBlock;
  const int nvalid = min(kFamBlock, (int)(nbins - base));
  stage<N, kFamBlock, S>(rs, ts, base, nvalid);
  stage<N, kFamBlock, S>(rn, tn, base, nvalid);
  __syncthreads();
  if (threadIdx.x >= nvalid) return;
  float2* ms = ts + threadIdx.x * S;
  float2* mn = tn + threadIdx.x * S;
  herm_in_place<N>(ms);
  herm_in_place<N>(mn);

  cpx l[N][N];
  load_herm<N>(mn, l);
  float dsc[N], inv_diag[N];
  equil_cholesky<N>(l, dsc, inv_diag, eps_rel);

  cpx v[N];
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = {(k + 1.0f) / N, 0.0f};
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    cpx u[N], x[N];
    matvec<N>(ms, v, u);
    equil_solve<N>(l, dsc, inv_diag, u, x);
    unit<N>(x, v);
  }
  // v^H Rn v = 1 with the raw hermitianized Rn, then the mic-0 anchor
  const float scale = rsqrtf(fmaxf(quad<N>(mn, v), kEps));
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = {v[i].re * scale, v[i].im * scale};
  cpx d[N];
  anchor_phase<N>(v, d);
  float2* out = w + (base + threadIdx.x) * N;
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = make_float2(d[i].re, d[i].im);
}

template <int N>
__global__ void __launch_bounds__(kFamBlock)
pmwf_solve_kernel(const float2* __restrict__ rs, const float2* __restrict__ rn,
                  float2* __restrict__ w, float* __restrict__ ps,
                  float* __restrict__ pn, int nbins, float beta,
                  float eps_rel) {
  constexpr int S = padded_stride<N>();
  __shared__ float2 ts[kFamBlock * S];
  __shared__ float2 tn[kFamBlock * S];
  const long long base = (long long)blockIdx.x * kFamBlock;
  const int nvalid = min(kFamBlock, (int)(nbins - base));
  stage<N, kFamBlock, S>(rs, ts, base, nvalid);
  stage<N, kFamBlock, S>(rn, tn, base, nvalid);
  __syncthreads();
  if (threadIdx.x >= nvalid) return;
  float2* ms = ts + threadIdx.x * S;
  float2* mn = tn + threadIdx.x * S;
  herm_in_place<N>(ms);
  herm_in_place<N>(mn);

  cpx l[N][N];
  load_herm<N>(mn, l);
  float dsc[N], inv_diag[N];
  equil_cholesky<N>(l, dsc, inv_diag, eps_rel);

  // X = Rn^{-1} Rs column by column, written to W unscaled
  const long long bin = base + threadIdx.x;
  float2* wo = w + bin * N * N;
  cpx tr = {0.0f, 0.0f};
#pragma unroll 1
  for (int j = 0; j < N; ++j) {
    cpx b[N], x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) b[i] = {ms[i * N + j].x, ms[i * N + j].y};
    equil_solve<N>(l, dsc, inv_diag, b, x);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      wo[i * N + j] = make_float2(x[i].re, x[i].im);
      if (i == j) {
        tr.re += x[i].re;
        tr.im += x[i].im;
      }
    }
  }
  tr.re += beta;
  const float inv_den = 1.0f / fmaxf(tr.re * tr.re + tr.im * tr.im,
                                     kEps * kEps);

  // W = X conj(tr) / |tr|^2, column by column, with the column's powers
#pragma unroll 1
  for (int c = 0; c < N; ++c) {
    cpx wc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float2 x = wo[i * N + c];
      cpx q = cmul_conj({x.x, x.y}, tr);
      wc[i] = {q.re * inv_den, q.im * inv_den};
      wo[i * N + c] = make_float2(wc[i].re, wc[i].im);
    }
    if (ps != nullptr) {
      ps[bin * N + c] = quad<N>(ms, wc);
      pn[bin * N + c] = quad<N>(mn, wc);
    }
  }
}

inline int grid_for(int nbins, int block) { return (nbins + block - 1) / block; }

// call f(std::integral_constant<int, n>{}) for 1 <= n <= kMaxMics, then
// return the launch's error; n outside that range is refused
template <int N = 1, typename F>
int with_mics(int n, F f) {
  if constexpr (N > kMaxMics) {
    return cudaErrorInvalidValue;
  } else {
    if (n != N) return with_mics<N + 1>(n, f);
    f(std::integral_constant<int, N>{});
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
    gevd_power_kernel<N><<<grid_for(nbins, kFamBlock), kFamBlock, 0, s>>>(
        a, b, o, nbins, iters, eps_rel);
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
    pmwf_solve_kernel<N><<<grid_for(nbins, kFamBlock), kFamBlock, 0, s>>>(
        a, b, o, p, q, nbins, beta, eps_rel);
  });
}
