// Kernels 18 and 19 (sm_90a): the tap-free weighted WPE Gram and the
// filter application, built from the raw spectra (no tap matrix in memory).
//
// Kernel 18, wpe_gram_kernel, replaces setk_tpu/ops/pallas/wpe_gram.py
// wpe_gram_pallas (:292, body _wpe_gram_kernel :170).  Per bin, with the
// design rows A = [current mics | delayed taps] (row N + k N + m reads mic m
// at frame t - delay - k, zero before the first frame; the order of
// enhance/wpe.compute_tap_mat):
//   * d = y - G^H taps, the previous iteration's dereverberated signal
//     (`use_g`; d = y on the first iteration);
//   * lambda = the context-smoothed mean power of d over mics with the
//     edge counts of compute_lambda, or the caller's lambda (WPD);
//   * gram = sum_t A[:, t] A[:, t]^H / max(lambda_t, EPS), each (i <= j)
//     entry summed once, written at (i, j) and conjugated at (j, i) with a
//     real diagonal: exactly Hermitian, as the TPU's is.  The sum is
//     two-level: over a tile's 64 frames in registers, then over the tiles
//     in shared memory, so its rounding grows with 64 + T / 64 terms, not
//     T.  A reverberant scene's tap correlation reaches a condition number
//     of ~2e6, and the Gram's rounding, not the solve's, sets how far the
//     f32 loop lies from a float64 run (tools/wpe_precision.py).
// obs (bins, N, T) complex64, G (bins, N taps, N) complex64, lambda
// (bins, T) f32 or null -> gram (bins, cols, cols) complex64, cols =
// (taps + 1) N.
//
// Kernel 19, wpe_apply_kernel, replaces wpe_gram.py wpe_apply_pallas (:344,
// body _wpe_apply_kernel :264): d = y - G^H taps for the N valid rows,
// obs, G -> d (bins, N, T) complex64.
//
// f32 on the CUDA cores throughout: the TPU needed f32-grade Gram entries
// (a two-term bf16 split cost ~20 dB of speech parity, wpe_gram.py:154-167),
// and TF32 is the same error class.
//
// Bound on the card, at the WPE scene (32 utterances x 8 s, N = 6, taps 10,
// T = 501, 8,224 bins, cols = 66): kernel 18 does 2,211 (i <= j) complex
// multiply-adds a frame (72.9 GFLOP) plus the dereverberation's 360 a
// frame (11.9 GFLOP), ~1.26 ms at 67 TFLOP/s, against 198 MB of spectra,
// 24 MB of G and 287 MB of Gram (~0.15 ms at 3.35 TB/s): operations.  A
// block owns a bin and walks T in tiles of 64 frames, staged in shared
// memory with the halo the taps and the context need (any T runs; ~7 KB
// of shared memory at the scene, plus 32 KB of the threads' tile sums),
// recomputing lambda on the 2 C frames a tile shares with its
// neighbours.  Each thread owns a 4 x 4 block of the
// Gram's upper block triangle (153 blocks at cols = 66, one pass of 256
// threads; larger cols take more passes), so a frame costs it 8 loads for
// 16 complex multiply-adds.  Kernel 19 (11.9 GFLOP, 396 MB: ~0.18 ms by
// operations) gives a block a bin and a tile of 64 frames.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGramThreads = 256;
constexpr int kApplyThreads = 128;
constexpr int kTile = 64;   // frames a tile
constexpr int kRB = 4;      // Gram rows and columns a thread owns
constexpr float kEps = 1.1920928955078125e-07f;  // float32 epsilon

// Stage frames [f0, f0 + wt) of the bin's n mics into xs (n rows of wt),
// zero outside [0, t).
__device__ void stage(float2* xs, const float2* ob, int n, int t, int f0,
                      int wt) {
  for (int idx = threadIdx.x; idx < n * wt; idx += blockDim.x) {
    const int m = idx / wt, f = f0 + idx - m * wt;
    xs[idx] = (f >= 0 && f < t) ? ob[(size_t)m * t + f]
                                : make_float2(0.0f, 0.0f);
  }
}

// d_m at the frame staged at column f: y_m - sum_r conj(G[r][m]) tap_r, tap
// r = k n + m2 reading mic m2 at column f - delay - k.
__device__ float2 dereverb(const float2* xs, int wt, const float2* gs, int n,
                           int taps, int delay, int m, int f) {
  float sx = 0.0f, sy = 0.0f;
  for (int k = 0; k < taps; ++k) {
    for (int m2 = 0; m2 < n; ++m2) {
      const float2 g = gs[(k * n + m2) * n + m];
      const float2 x = xs[m2 * wt + f - delay - k];
      sx += g.x * x.x + g.y * x.y;
      sy += g.x * x.y - g.y * x.x;
    }
  }
  const float2 y = xs[m * wt + f];
  return make_float2(y.x - sx, y.y - sy);
}

// Shared-memory column of design row i at tile frame 0: mic m of the
// current rows, or the tap row's mic shifted back by delay + k; rows past
// cols read the zero row.
__device__ int row_base(int i, int n, int cols, int delay, int wt, int off) {
  if (i < n) return i * wt + off;
  if (i >= cols) return n * wt;
  const int k = (i - n) / n, m = (i - n) - k * n;
  return m * wt + off - delay - k;
}

template <int RB>
__global__ void __launch_bounds__(kGramThreads)
wpe_gram_kernel(const float2* __restrict__ obs, const float2* __restrict__ g,
                const float* __restrict__ lam, float2* __restrict__ gram,
                int n, int t, int taps, int delay, int context, int use_g) {
  extern __shared__ float2 smem[];
  const int tid = threadIdx.x;
  const int cols = (taps + 1) * n, nk = n * taps;
  const int h = delay + taps - 1;            // the deepest tap's shift
  const int halo = context + h;              // frames staged before a tile
  const int wt = kTile + 2 * context + h;    // staged frames a tile
  float2* xs = smem;                         // n rows + the zero row
  float2* gs = xs + (n + 1) * wt;            // G (nk, n)
  float* ps = reinterpret_cast<float*>(gs + nk * n);  // power, tile + 2C
  float* ws = ps + kTile + 2 * context;      // weights, tile
  // the tiles' running sums: 2 RB RB floats a thread, strided by thread
  float* tot = ws + kTile;
  const size_t bin = blockIdx.x;
  const float2* ob = obs + bin * n * t;
  for (int i = tid; i < wt; i += blockDim.x)
    xs[n * wt + i] = make_float2(0.0f, 0.0f);
  if (use_g && lam == nullptr) {
    for (int i = tid; i < nk * n; i += blockDim.x) gs[i] = g[bin * nk * n + i];
  }
  const int nt = (cols + RB - 1) / RB;
  const int ntiles = nt * (nt + 1) / 2;
  for (int pass = 0; pass * (int)blockDim.x < ntiles; ++pass) {
    int q = pass * blockDim.x + tid;
    const bool active = q < ntiles;
    int bi = 0;
    if (active) {
      while (q >= nt - bi) {
        q -= nt - bi;
        ++bi;
      }
    }
    const int bj = bi + q;
    int rb[RB], cb[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      rb[r] = row_base(bi * RB + r, n, cols, delay, wt, halo);
      cb[r] = row_base(bj * RB + r, n, cols, delay, wt, halo);
    }
    for (int e = 0; e < 2 * RB * RB; ++e) tot[e * blockDim.x + tid] = 0.0f;
    for (int t0 = 0; t0 < t; t0 += kTile) {
      __syncthreads();  // the last tile's readers are done
      stage(xs, ob, n, t, t0 - halo, wt);
      __syncthreads();
      if (lam != nullptr) {
        for (int u = tid; u < kTile; u += blockDim.x) {
          const int f = t0 + u;
          const float sw =
              f < t ? 1.0f / sqrtf(fmaxf(lam[bin * t + f], kEps)) : 0.0f;
          ws[u] = sw * sw;
        }
      } else {
        // mean power over mics of d at frames t0 - C ... t0 + tile + C
        for (int u = tid; u < kTile + 2 * context; u += blockDim.x) {
          const int f = t0 - context + u;
          float p = 0.0f;
          if (f >= 0 && f < t) {
            for (int m = 0; m < n; ++m) {
              const float2 d =
                  use_g ? dereverb(xs, wt, gs, n, taps, delay, m, u + h)
                        : xs[m * wt + u + h];
              p += d.x * d.x + d.y * d.y;
            }
          }
          ps[u] = p * (1.0f / n);
        }
        __syncthreads();
        for (int u = tid; u < kTile; u += blockDim.x) {
          const int f = t0 + u;
          float acc = ps[u + context], cnt = 1.0f;
          for (int c = 1; c <= context; ++c) {
            if (f - c >= 0) {
              acc += ps[u + context - c];
              cnt += 1.0f;
            }
            if (f + c < t) {
              acc += ps[u + context + c];
              cnt += 1.0f;
            }
          }
          const float sw = 1.0f / sqrtf(fmaxf(acc / cnt, kEps));
          ws[u] = f < t ? sw * sw : 0.0f;
        }
      }
      __syncthreads();
      if (active) {
        float acc_re[RB][RB], acc_im[RB][RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
#pragma unroll
          for (int c = 0; c < RB; ++c) acc_re[r][c] = acc_im[r][c] = 0.0f;
        }
        const int len = min(kTile, t - t0);
        for (int u = 0; u < len; ++u) {
          const float w = ws[u];
          float2 a[RB], b[RB];
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float2 v = xs[rb[r] + u];
            a[r] = make_float2(v.x * w, v.y * w);
            b[r] = xs[cb[r] + u];
          }
#pragma unroll
          for (int r = 0; r < RB; ++r) {
#pragma unroll
            for (int c = 0; c < RB; ++c) {
              acc_re[r][c] += a[r].x * b[c].x + a[r].y * b[c].y;
              acc_im[r][c] += a[r].y * b[c].x - a[r].x * b[c].y;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
#pragma unroll
          for (int c = 0; c < RB; ++c) {
            float* sum = tot + 2 * (r * RB + c) * blockDim.x + tid;
            sum[0] += acc_re[r][c];
            sum[blockDim.x] += acc_im[r][c];
          }
        }
      }
    }
    if (active) {
      float2* gb = gram + bin * cols * cols;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
#pragma unroll
        for (int c = 0; c < RB; ++c) {
          const int i = bi * RB + r, j = bj * RB + c;
          if (i < cols && j < cols && i <= j) {
            const float* sum = tot + 2 * (r * RB + c) * blockDim.x + tid;
            const float re = sum[0], im = i == j ? 0.0f : sum[blockDim.x];
            gb[i * cols + j] = make_float2(re, im);
            gb[j * cols + i] = make_float2(re, -im);
          }
        }
      }
    }
  }
}

template <int TILE>
__global__ void __launch_bounds__(kApplyThreads)
wpe_apply_kernel(const float2* __restrict__ obs, const float2* __restrict__ g,
                 float2* __restrict__ out, int n, int t, int taps,
                 int delay) {
  extern __shared__ float2 smem[];
  const int tid = threadIdx.x, nk = n * taps;
  const int h = delay + taps - 1, wt = TILE + h;
  float2* xs = smem;
  float2* gs = xs + n * wt;
  const size_t bin = blockIdx.x;
  const int t0 = blockIdx.y * TILE;
  for (int i = tid; i < nk * n; i += blockDim.x) gs[i] = g[bin * nk * n + i];
  stage(xs, obs + bin * n * t, n, t, t0 - h, wt);
  __syncthreads();
  float2* ob = out + bin * n * t;
  for (int idx = tid; idx < n * TILE; idx += blockDim.x) {
    const int m = idx / TILE, u = idx - m * TILE;
    if (t0 + u < t)
      ob[(size_t)m * t + t0 + u] = dereverb(xs, wt, gs, n, taps, delay, m,
                                            u + h);
  }
}

template <typename K>
int opt_in(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

bool bad_shape(int bins, int n, int t, int taps, int delay) {
  return bins < 1 || n < 1 || n > 8 || t < 1 || taps < 1 || delay < 0 ||
         n * taps > 128;
}

}  // namespace

// obs: (bins, n, t) complex64; g: (bins, n taps, n) complex64, read when
// use_g and lam is null; lam: (bins, t) f32 or null; gram: (bins, cols,
// cols) complex64, cols = (taps + 1) n.  n <= 8, n taps <= 128.
extern "C" int wpe_gram_launch(const void* obs, const void* g,
                               const void* lam, void* gram, int bins, int n,
                               int t, int taps, int delay, int context,
                               int use_g, void* stream) {
  if (bad_shape(bins, n, t, taps, delay) || context < 0 ||
      (use_g && g == nullptr && lam == nullptr))
    return cudaErrorInvalidValue;
  const int wt = kTile + 2 * context + delay + taps - 1;
  const size_t bytes = sizeof(float2) * ((size_t)(n + 1) * wt +
                                         (size_t)n * taps * n) +
                       sizeof(float) * (2 * kTile + 2 * context +
                                        2 * kRB * kRB * kGramThreads);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  int err = opt_in(wpe_gram_kernel<kRB>, bytes);
  if (err != cudaSuccess) return err;
  wpe_gram_kernel<kRB><<<bins, kGramThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(obs), static_cast<const float2*>(g),
      static_cast<const float*>(lam), static_cast<float2*>(gram), n, t, taps,
      delay, context, use_g);
  return cudaGetLastError();
}

// obs and out: (bins, n, t) complex64; g: (bins, n taps, n) complex64.
extern "C" int wpe_apply_launch(const void* obs, const void* g, void* out,
                                int bins, int n, int t, int taps, int delay,
                                void* stream) {
  if (bad_shape(bins, n, t, taps, delay)) return cudaErrorInvalidValue;
  const size_t bytes = sizeof(float2) * ((size_t)n * (kTile + delay +
                                                      taps - 1) +
                                         (size_t)n * taps * n);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  int err = opt_in(wpe_apply_kernel<kTile>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(bins, (t + kTile - 1) / kTile);
  wpe_apply_kernel<kTile><<<grid, kApplyThreads, bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(obs), static_cast<const float2*>(g),
      static_cast<float2*>(out), n, t, taps, delay);
  return cudaGetLastError();
}
