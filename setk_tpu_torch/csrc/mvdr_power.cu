// Per-bin MVDR weights from mask-weighted covariances (sm_90a).
//
// Replaces setk_tpu/ops/pallas/mvdr.py: mvdr_power_pallas (:458), whose
// body _mvdr_kernel (:258) runs mvdr_weights_tiles (:208):
//   1. hermitianize Rs, `iters` power iterations from the ramp (k+1)/N,
//      renormalized by rsqrt(max(|u|^2, EPS^2));
//   2. rotate the steer vector so mic 0 is real-positive (floor EPS);
//   3. hermitianize Rn, Jacobi-equilibrate to a unit diagonal (scale 1
//      where the diagonal is <= 0), load max(eps_rel, 4 N EPS);
//   4. complex Cholesky with pivots rsqrt(max(d, EPS)), solve Rn x = d
//      through the equilibrated factor;
//   5. Capon normalization w = x conj(den) / max(|den|^2, EPS^2),
//      den = d^H x.
//
// Bound on the card: bytes.  At the bench shape (32,896 bins, N = 6)
// the kernel reads 2 x 9.5 MB of covariances and writes 1.6 MB of
// weights (~6 us at 3.35 TB/s); its ~5.5 kFLOP per bin come to ~3 us at
// the f32 peak.  Design: one thread per bin, the N x N recurrences
// unrolled by template so every matrix lives in registers; Rs dies after
// the power iteration, before Rn is read.  A block of 64 bins stages
// each covariance through shared memory so the global loads are
// coalesced (a thread's own matrix is N*N*8 contiguous bytes).

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1.1920928955078125e-07f;  // float32 machine eps
constexpr int kBlock = 64;

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

template <int N>
__device__ __forceinline__ void stage(const float2* __restrict__ src,
                                      float2* tile, long long base,
                                      int nvalid) {
  constexpr int NN = N * N;
  for (int i = threadIdx.x; i < nvalid * NN; i += kBlock)
    tile[i] = src[base * NN + i];
}

// 0.5 (R + R^H) of the thread's matrix in the staged tile
template <int N>
__device__ __forceinline__ void load_herm(const float2* tile, cpx (&h)[N][N]) {
  const float2* m = tile + threadIdx.x * N * N;
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

template <int N>
__global__ void __launch_bounds__(kBlock)
mvdr_power_kernel(const float2* __restrict__ rs, const float2* __restrict__ rn,
                  float2* __restrict__ w, int nbins, int iters,
                  float eps_rel) {
  __shared__ float2 tile[kBlock * N * N];
  const long long base = (long long)blockIdx.x * kBlock;
  const int nvalid = min(kBlock, (int)(nbins - base));
  const bool active = threadIdx.x < nvalid;

  // ---- 1. steer vector: power iteration on hermitianized Rs ----
  stage<N>(rs, tile, base, nvalid);
  __syncthreads();
  cpx v[N];
  {
    cpx s[N][N];
    if (active) load_herm<N>(tile, s);
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = {(k + 1.0f) / N, 0.0f};
    if (active) {
#pragma unroll 1
      for (int it = 0; it < iters; ++it) {
        cpx u[N];
        float nrm2 = 0.0f;
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
          nrm2 += acc.re * acc.re + acc.im * acc.im;
        }
        const float inv = rsqrtf(fmaxf(nrm2, kEps * kEps));
#pragma unroll
        for (int i = 0; i < N; ++i) v[i] = {u[i].re * inv, u[i].im * inv};
      }
    }
  }
  __syncthreads();  // every thread is done with the Rs tile

  // ---- 2. phase anchor to channel 0 ----
  cpx d[N];
  {
    const float mag = sqrtf(v[0].re * v[0].re + v[0].im * v[0].im);
    const float inv_mag = 1.0f / fmaxf(mag, kEps);
    const cpx p = {v[0].re * inv_mag, -v[0].im * inv_mag};
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = cmul(v[i], p);
  }

  // ---- 3. equilibrated, loaded Rn ----
  stage<N>(rn, tile, base, nvalid);
  __syncthreads();
  if (!active) return;
  cpx a[N][N];
  load_herm<N>(tile, a);
  float dsc[N];
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

  // ---- 4. Cholesky in place (lower triangle), then the solve ----
  float inv_diag[N];
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
  cpx y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    cpx s = {d[i].re * dsc[i], d[i].im * dsc[i]};
#pragma unroll
    for (int q = 0; q < i; ++q) {
      cpx p = cmul(a[i][q], y[q]);
      s.re -= p.re;
      s.im -= p.im;
    }
    y[i] = {s.re * inv_diag[i], s.im * inv_diag[i]};
  }
  cpx x[N];
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    cpx s = y[i];
#pragma unroll
    for (int q = i + 1; q < N; ++q) {
      cpx p = cmul({a[q][i].re, -a[q][i].im}, x[q]);
      s.re -= p.re;
      s.im -= p.im;
    }
    x[i] = {s.re * inv_diag[i], s.im * inv_diag[i]};
  }
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = {x[i].re * dsc[i], x[i].im * dsc[i]};

  // ---- 5. Capon normalization ----
  cpx den = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    cpx p = cmul({d[i].re, -d[i].im}, x[i]);
    den.re += p.re;
    den.im += p.im;
  }
  const float inv_den =
      1.0f / fmaxf(den.re * den.re + den.im * den.im, kEps * kEps);
  float2* out = w + (base + threadIdx.x) * N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    cpx q = cmul_conj(x[i], den);
    out[i] = make_float2(q.re * inv_den, q.im * inv_den);
  }
}

template <int N>
void launch(const float2* rs, const float2* rn, float2* w, int nbins,
            int iters, float eps_rel, cudaStream_t stream) {
  const int grid = (nbins + kBlock - 1) / kBlock;
  mvdr_power_kernel<N><<<grid, kBlock, 0, stream>>>(rs, rn, w, nbins, iters,
                                                     eps_rel);
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
  switch (n) {
    case 1: launch<1>(a, b, o, nbins, iters, eps_rel, s); break;
    case 2: launch<2>(a, b, o, nbins, iters, eps_rel, s); break;
    case 3: launch<3>(a, b, o, nbins, iters, eps_rel, s); break;
    case 4: launch<4>(a, b, o, nbins, iters, eps_rel, s); break;
    case 5: launch<5>(a, b, o, nbins, iters, eps_rel, s); break;
    case 6: launch<6>(a, b, o, nbins, iters, eps_rel, s); break;
    case 7: launch<7>(a, b, o, nbins, iters, eps_rel, s); break;
    case 8: launch<8>(a, b, o, nbins, iters, eps_rel, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
