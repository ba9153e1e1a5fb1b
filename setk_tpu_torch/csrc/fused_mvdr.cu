// Fused STFT + covariance (kernel A) and beamform + iSTFT (kernel B)
// for the mask-based MVDR main path (sm_90a).  Geometry: n_fft 512,
// hop 256, center reflect padding, 1 <= N <= 8 mics, S % 256 == 0,
// S >= 512, any frame count T = S / 256 + 1.  Bins stay in natural order.
//
// Kernel A replaces setk_tpu/ops/pallas/fused_mvdr.py:
// stft_covar_pallas (:321, body _stft_covar_kernel :228): framing, the
// windowed 512-point real DFT and the masked numerators
//   Rs[b,f] = sum_t m[b,t,f] y y^H,   Rn[b,f] = sum_t max(1-m,0) y y^H
// with no spectrum written to device memory.
// Kernel B replaces beamform_istft_pallas (:430, body
// _beamform_istft_kernel :378): the DFT recomputed from the waveform,
// enh = sum_n conj(w_n) y_n per bin (only the real part at bins 0 and
// 256 enters the inverse real DFT), inverse DFT, synthesis window, 50%
// overlap-add out[j] = P[j+1] + Q[j] and the wss_inv multiply.
//
// Bound on the card at the bench shape (B=128, N=6, S=128000 int16):
//   kernel A reads 196.6 MB of wav + 65.9 MB of mask and writes 19 MB of
//   Rs/Rn (~84 us at 3.35 TB/s); kernel B reads the wav, 1.6 MB of
//   weights and 0.5 MB of wss_inv and writes 65.5 MB (~79 us).  The
//   TPU kernel's direct matmul DFT needs ~2e11 FLOP per pass (~3 ms at
//   the f32 peak); the design here does the transform as radix-2 FFTs
//   in shared memory (~5 N log2 N FLOP per 512 points), two mics per
//   complex FFT (x = y_a + i y_b, split by Hermitian symmetry), which
//   cuts the operations ~20x, to about the byte bound (~0.1 ms each).
//   Twiddles come from a float64 sincospi table, so the transform stays
//   f32-grade.  No atomics: kernel A runs one block per (utterance, run
//   of frames), keeps each bin's N(N+1)/2 pair sums in the registers of
//   the thread owning that bin and writes them per run; a small second
//   kernel adds the runs in a fixed order (deterministic).  The wrapper
//   picks the number of runs so that about two blocks fill each SM.
//   Kernel B gives each block a run of output hop blocks and computes
//   the one extra frame its overlap-add needs itself.  Both kernels
//   transform two frames per pass of the FFT's chain of block barriers,
//   which sets their time more than bytes or FLOP do.
//
// The online (chunked EMA) pair replaces stft_covar_online_pallas (:651,
// body _stft_covar_online_kernel :530) and beamform_istft_online_pallas
// (:771, body :712).  The TPU kernel's EMA-mixing matmuls with hi/lo
// K-stacks, its lane permutation and its 128-frame quarters are TPU
// devices and have no counterpart here.  Instead:
//   - kernel A runs with one block per (utterance, chunk of frames), so
//     its partial runs are exactly the per-chunk numerators
//     (stft_covar_chunks_launch, no reduce);
//   - covar_ema_kernel walks the chunks in order, one thread per output
//     entry of a bin's E_s or E_n: it normalizes by the chunk's mask sums
//     (formed in the block from the mask), carries the EMA
//     E <- a E + (1 - a) R_c in an f32 register (the first chunk
//     initializes) and writes the full Hermitian E_s, E_n per chunk for
//     the mvdr_power kernel;
//   - beamform_istft_online_kernel is kernel B with one weight row per
//     chunk: each thread reloads its bin's weights when a frame crosses
//     into another chunk, so the extra frame a block computes for its
//     overlap-add takes its own chunk's weights.
// covar_ema is bound by bytes: at B=128, N=6, T=501, chunk 32 it reads
// 177 MB of sums and 66 MB of mask and writes 303 MB (~0.16 ms).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNfft = 512;
constexpr int kHop = 256;
constexpr int kBins = 257;
constexpr int kThreads = 288;  // 9 warps: 257 bin owners, 256 butterflies
constexpr int kStride = kNfft + kNfft / 32;  // padded FFT buffer

// Shared-memory slot of FFT point q: one float2 of padding every 32
// points, so the bit-reversed scatter of 16 consecutive samples (points
// 16 apart) lands in 16 distinct bank pairs instead of one.
__device__ __forceinline__ int slot(int q) { return q + (q >> 5); }

struct cpx {
  float re, im;
};

__device__ __forceinline__ int bitrev9(int n) {
  return (int)(__brev((unsigned)n) >> 23);
}

// tw[j] = exp(-2 pi i j / 512), j < 256
__device__ __forceinline__ void init_tables(float2* tw, float* win,
                                            const float* __restrict__ window) {
  for (int j = threadIdx.x; j < kNfft / 2; j += blockDim.x) {
    double s, c;
    sincospi(-(double)j / 256.0, &s, &c);
    tw[j] = make_float2((float)c, (float)s);
  }
  for (int j = threadIdx.x; j < kNfft; j += blockDim.x) win[j] = window[j];
}

// P in-place radix-2 decimation-in-time FFTs of 512 points over
// buf[p * kStride + slot(i)], input already in bit-reversed order.
// Forward uses exp(-i...), inverse exp(+i...) without the 1/512.  Every
// thread of the block must call it (it synchronizes before each stage and
// at the end).
template <int P, bool kInverse>
__device__ __forceinline__ void fft512(float2* buf, const float2* tw) {
  const int t = threadIdx.x;
#pragma unroll
  for (int s = 0; s < 9; ++s) {
    __syncthreads();
    if (t < kNfft / 2) {
      const int half = 1 << s;
      const int pos = t & (half - 1);
      const int i0 = ((t >> s) << (s + 1)) + pos;
      const int i1 = i0 + half;
      float2 w = tw[pos << (8 - s)];
      if (kInverse) w.y = -w.y;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float2 u = buf[p * kStride + slot(i0)];
        const float2 x = buf[p * kStride + slot(i1)];
        const float2 v = make_float2(x.x * w.x - x.y * w.y,
                                     x.x * w.y + x.y * w.x);
        buf[p * kStride + slot(i0)] = make_float2(u.x + v.x, u.y + v.y);
        buf[p * kStride + slot(i1)] = make_float2(u.x - v.x, u.y - v.y);
      }
    }
  }
  __syncthreads();
}

// Windowed frame t of every mic, two mics per complex buffer
// (mic 2p real, mic 2p+1 imaginary), written bit-reversed.  Frame t
// covers samples j = 256 (t - 1) + n, reflected at both ends.
template <int N, typename T>
__device__ __forceinline__ void load_frame(float2* buf, const T* __restrict__ x,
                                           const float* win, int S, int t) {
  constexpr int P = (N + 1) / 2;
  for (int i = threadIdx.x; i < P * kNfft; i += kThreads) {
    const int p = i >> 9;
    const int n = i & (kNfft - 1);
    int j = t * kHop + n - kNfft / 2;
    if (j < 0) j = -j;
    else if (j >= S) j = 2 * S - 2 - j;
    const float re = (float)x[(size_t)(2 * p) * S + j] * win[n];
    const float im =
        (2 * p + 1 < N) ? (float)x[(size_t)(2 * p + 1) * S + j] * win[n] : 0.0f;
    buf[p * kStride + slot(bitrev9(n))] = make_float2(re, im);
  }
}

// Spectra of all mics at bin k from the packed FFT outputs.
template <int N>
__device__ __forceinline__ void unpack_bin(const float2* buf, int k,
                                           cpx (&X)[N]) {
  const int km = (kNfft - k) & (kNfft - 1);
#pragma unroll
  for (int p = 0; p < (N + 1) / 2; ++p) {
    const float2 zk = buf[p * kStride + slot(k)];
    const float2 zm = buf[p * kStride + slot(km)];
    // mic 2p: (Z[k] + conj Z[-k]) / 2 ; mic 2p+1: (Z[k] - conj Z[-k]) / 2i
    X[2 * p] = {0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y)};
    if (2 * p + 1 < N)
      X[2 * p + 1] = {0.5f * (zk.y + zm.y), 0.5f * (zm.x - zk.x)};
  }
}

// Adds one frame's masked pair products at bin k: Rs += m X X^H and
// Rn += max(1 - m, 0) X X^H over the upper triangle (the diagonal is real).
template <int N>
__device__ __forceinline__ void accumulate_bin(
    const float2* buf, int k, float ms, cpx (&acc_s)[N * (N + 1) / 2],
    cpx (&acc_n)[N * (N + 1) / 2]) {
  const float mn = fmaxf(1.0f - ms, 0.0f);
  cpx X[N];
  unpack_bin<N>(buf, k, X);
  int idx = 0;
#pragma unroll
  for (int a = 0; a < N; ++a) {
#pragma unroll
    for (int c = a; c < N; ++c, ++idx) {
      // X_a conj(X_c)
      const float pr = X[a].re * X[c].re + X[a].im * X[c].im;
      acc_s[idx].re += ms * pr;
      acc_n[idx].re += mn * pr;
      if (c != a) {
        const float pi = X[a].im * X[c].re - X[a].re * X[c].im;
        acc_s[idx].im += ms * pi;
        acc_n[idx].im += mn * pi;
      }
    }
  }
}

// One block per (utterance, run of frames); partial pair sums go to
// part[b, kc, f, 0..2 NP) (Rs pairs, then Rn pairs, upper triangle in
// row order) and covar_reduce_kernel adds the runs in a fixed order.
template <int N, typename T>
__global__ void __launch_bounds__(kThreads, 2)
stft_covar_kernel(const T* __restrict__ wav, const float* __restrict__ mask,
                  const float* __restrict__ window, float2* __restrict__ part,
                  int S, int n_frames, int frames_per_block) {
  constexpr int P = (N + 1) / 2;
  constexpr int NP = N * (N + 1) / 2;
  __shared__ float2 buf[2 * P * kStride];
  __shared__ float2 tw[kNfft / 2];
  __shared__ float win[kNfft];
  const int b = blockIdx.x;
  const int kc = blockIdx.y;
  const int t0 = kc * frames_per_block;
  const int t1 = min(n_frames, t0 + frames_per_block);
  const int k = threadIdx.x;  // the bin this thread accumulates
  init_tables(tw, win, window);
  const T* x = wav + (size_t)b * N * S;
  const float* mrow = mask + (size_t)b * n_frames * kBins;

  cpx acc_s[NP], acc_n[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) acc_s[i] = acc_n[i] = {0.0f, 0.0f};

  // two frames per pass: one chain of FFT barriers transforms both
  for (int t = t0; t < t1; t += 2) {
    const bool two = t + 1 < t1;
    __syncthreads();  // tables ready / last pass's spectra consumed
    load_frame<N, T>(buf, x, win, S, t);
    if (two) load_frame<N, T>(buf + P * kStride, x, win, S, t + 1);
    fft512<2 * P, false>(buf, tw);
    if (k < kBins) {
      accumulate_bin<N>(buf, k, mrow[(size_t)t * kBins + k], acc_s, acc_n);
      if (two)
        accumulate_bin<N>(buf + P * kStride, k,
                          mrow[(size_t)(t + 1) * kBins + k], acc_s, acc_n);
    }
  }
  if (k >= kBins) return;
  float2* out = part + (((size_t)b * gridDim.y + kc) * kBins + k) * 2 * NP;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    out[i] = make_float2(acc_s[i].re, acc_s[i].im);
    out[NP + i] = make_float2(acc_n[i].re, acc_n[i].im);
  }
}

// Rs, Rn (B, 257, N, N) from the K partial runs of stft_covar_kernel,
// added in run order; the lower triangle is the conjugate mirror.
template <int N>
__global__ void covar_reduce_kernel(const float2* __restrict__ part,
                                    float2* __restrict__ rs,
                                    float2* __restrict__ rn, int B, int K) {
  constexpr int NP = N * (N + 1) / 2;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= B * kBins) return;
  const int b = g / kBins;
  const int k = g - b * kBins;
  float2* os = rs + (size_t)g * N * N;
  float2* on = rn + (size_t)g * N * N;
  int idx = 0;
#pragma unroll
  for (int a = 0; a < N; ++a) {
#pragma unroll
    for (int c = a; c < N; ++c, ++idx) {
      float2 s = make_float2(0.0f, 0.0f), n = make_float2(0.0f, 0.0f);
      for (int kc = 0; kc < K; ++kc) {
        const float2* run = part + (((size_t)b * K + kc) * kBins + k) * 2 * NP;
        s.x += run[idx].x;
        s.y += run[idx].y;
        n.x += run[NP + idx].x;
        n.y += run[NP + idx].y;
      }
      os[a * N + c] = s;
      on[a * N + c] = n;
      if (c != a) {
        os[c * N + a] = make_float2(s.x, -s.y);
        on[c * N + a] = make_float2(n.x, -n.y);
      }
    }
  }
}

// Online state per chunk: E_c = R_c (c = 0), E_c = a E_{c-1} + (1 - a) R_c,
// R_c = numerator_c / max(sum_{t in c} m, 1e-6) with m = mask for Rs and
// max(1 - mask, 0) for Rn.  part (B, C, 257, 2 NP) from kernel A with one
// run per chunk; es, en (B, C, 257, N, N).  Every entry of E evolves on
// its own, so each thread carries one output entry (Rs or Rn, row a,
// column c) of one bin through the chunks, and a block covers kEmaBins
// consecutive bins: its stores per chunk are contiguous.  The block first
// forms the mask sums of a tile of up to kEmaTile chunks, one thread per
// (chunk, kind, bin), so the walk over the tile's chunks has no barrier
// and no chain of mask loads in it (PERF.md: forming them chunk by chunk
// made the kernel latency-bound).
constexpr int kEmaBins = 4;
constexpr int kEmaTile = 64;

template <int N>
__global__ void covar_ema_kernel(const float2* __restrict__ part,
                                 const float* __restrict__ mask,
                                 float2* __restrict__ es,
                                 float2* __restrict__ en, int B,
                                 int n_frames, int chunk, int n_chunks,
                                 float alpha) {
  constexpr int NP = N * (N + 1) / 2;
  constexpr int E = N * N;
  __shared__ float den[kEmaTile][2][kEmaBins];
  const int rows = B * kBins;              // (utterance, bin) rows
  const int row0 = blockIdx.x * kEmaBins;
  const int g = threadIdx.x / (2 * E);     // this thread's bin in the block
  const int e = threadIdx.x - g * 2 * E;
  const int which = e / E;                 // 0: Rs, 1: Rn
  const int a = (e - which * E) / N;
  const int c = (e - which * E) - a * N;
  const int lo = min(a, c), hi = max(a, c);
  // pairs of the upper triangle in row order; the lower is the conjugate
  const int pidx = which * NP + lo * N - lo * (lo - 1) / 2 + (hi - lo);
  const float sgn = a > c ? -1.0f : 1.0f;
  const int row = row0 + g;
  const bool live = row < rows;
  const int b = row / kBins;
  const int k = row - b * kBins;
  const float beta = 1.0f - alpha;
  cpx acc = {0.0f, 0.0f};
  for (int c0 = 0; c0 < n_chunks; c0 += kEmaTile) {
    const int nc = min(kEmaTile, n_chunks - c0);
    __syncthreads();  // the previous tile's sums are consumed
    for (int i = threadIdx.x; i < nc * 2 * kEmaBins; i += blockDim.x) {
      const int gw = i % kEmaBins;
      const int wh = (i / kEmaBins) % 2;
      const int cc = i / (2 * kEmaBins);
      const int r = row0 + gw;
      float d = 0.0f;
      if (r < rows) {
        const int bb = r / kBins;
        const float* mcol =
            mask + (size_t)bb * n_frames * kBins + (r - bb * kBins);
        const int t0 = (c0 + cc) * chunk;
        const int t1 = min(n_frames, t0 + chunk);
        for (int t = t0; t < t1; ++t) {
          const float m = mcol[(size_t)t * kBins];
          d += wh ? fmaxf(1.0f - m, 0.0f) : m;
        }
      }
      den[cc][wh][gw] = fmaxf(d, 1e-6f);
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int cc = 0; cc < nc; ++cc) {
      const size_t out_row = ((size_t)b * n_chunks + c0 + cc) * kBins + k;
      const float d = den[cc][which][g];
      const float2 v = part[out_row * 2 * NP + pidx];
      const cpx r = {v.x / d, (sgn * v.y) / d};
      if (c0 + cc == 0) {
        acc = r;
      } else {
        acc = {alpha * acc.re + beta * r.re, alpha * acc.im + beta * r.im};
      }
      (which ? en : es)[out_row * E + a * N + c] = make_float2(acc.re,
                                                               acc.im);
    }
  }
}

// enh = sum_m conj(w_m) X_m at bin k; only the real part of bins 0 and
// 256 enters the inverse real DFT.
template <int N>
__device__ __forceinline__ cpx beamform_bin(const float2* buf, int k,
                                            const cpx (&wk)[N]) {
  cpx X[N];
  unpack_bin<N>(buf, k, X);
  cpx s = {0.0f, 0.0f};
#pragma unroll
  for (int m = 0; m < N; ++m) {
    s.re += wk[m].re * X[m].re + wk[m].im * X[m].im;
    s.im += wk[m].re * X[m].im - wk[m].im * X[m].re;
  }
  if (k == 0 || k == kBins - 1) s.im = 0.0f;
  return s;
}

// Output hop blocks per kernel-B block: fewer for N > 6, whose two frame
// buffers leave less of the 48 KB of static shared memory.
__host__ __device__ constexpr int chunk_blocks(int n) {
  return n <= 6 ? 16 : 8;
}

// Bin k's weights of one chunk: w[row * N .. row * N + N).
template <int N>
__device__ __forceinline__ void load_weights(const float2* __restrict__ w,
                                             size_t row, cpx (&wk)[N]) {
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const float2 v = w[row * N + m];
    wk[m] = {v.x, v.y};
  }
}

// The body of kernel B.  Offline (kOnline false) one weight row per
// utterance, w (B, 257, N); online, w (B, n_chunks, 257, N) and frame f
// takes chunk f / chunk's row.
template <int N, typename T, bool kOnline>
__device__ __forceinline__ void beamform_istft_body(
    const T* __restrict__ wav, const float2* __restrict__ w,
    const float* __restrict__ wss_inv, const float* __restrict__ window,
    const float* __restrict__ synth, float* __restrict__ out, int S,
    int nblk_out, int chunk, int n_chunks) {
  constexpr int P = (N + 1) / 2;
  constexpr int CH = chunk_blocks(N);
  __shared__ float2 buf[2 * P * kStride];
  float2* zbuf = buf;  // the inverse FFT reuses the first buffer
  __shared__ float2 tw[kNfft / 2];
  __shared__ float win[kNfft];
  __shared__ float syn[kNfft];
  __shared__ float acc[CH * kHop];
  const int b = blockIdx.y;
  const int j0 = blockIdx.x * CH;
  const int nj = min(CH, nblk_out - j0);
  const int k = threadIdx.x;
  init_tables(tw, win, window);
  for (int j = threadIdx.x; j < kNfft; j += kThreads) syn[j] = synth[j];
  for (int i = threadIdx.x; i < nj * kHop; i += kThreads) acc[i] = 0.0f;
  const T* x = wav + (size_t)b * N * S;

  cpx wk[N];
  int cur = 0;  // the chunk whose weights wk holds
  if (k < kBins) load_weights<N>(w, ((size_t)b * n_chunks) * kBins + k, wk);
  // before beamforming frame f: its chunk's weights (online only; frames
  // only increase within a block)
  auto weights_for = [&](int f) {
    if (!kOnline) return;
    const int c = f / chunk;
    if (c != cur) {
      load_weights<N>(w, ((size_t)b * n_chunks + c) * kBins + k, wk);
      cur = c;
    }
  };

  // frames j0 .. j0 + nj feed output blocks j0 .. j0 + nj - 1; they run
  // in pairs (fa, fb): one chain of FFT barriers transforms both, and one
  // complex inverse FFT synthesizes both (z = x_fa + i x_fb)
  for (int fa = j0; fa <= j0 + nj; fa += 2) {
    const int fb = fa + 1;
    const bool has_b = fb <= j0 + nj;
    __syncthreads();  // buffers free, tables ready
    load_frame<N, T>(buf, x, win, S, fa);
    if (has_b) load_frame<N, T>(buf + P * kStride, x, win, S, fb);
    fft512<2 * P, false>(buf, tw);
    cpx e[2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    if (k < kBins) {
      weights_for(fa);
      e[0] = beamform_bin<N>(buf, k, wk);
      if (has_b) {
        weights_for(fb);
        e[1] = beamform_bin<N>(buf + P * kStride, k, wk);
      }
    }
    __syncthreads();  // spectra consumed: zbuf (= buf) is free
    if (k < kBins) {
      // Z = E_a + i E_b, Hermitian-extended to 512 bins
      zbuf[slot(bitrev9(k & (kNfft - 1)))] =
          make_float2(e[0].re - e[1].im, e[0].im + e[1].re);
      if (k > 0 && k < kBins - 1)
        zbuf[slot(bitrev9(kNfft - k))] =
            make_float2(e[0].re + e[1].im, e[1].re - e[0].im);
    }
    fft512<1, true>(zbuf, tw);
    // synthesis frame f, sample n: first half (P) -> block f - 1 at n,
    // second half (Q) -> block f at n - 256.  One thread per offset o
    // adds every contribution to that offset, so no two threads collide.
    const float inv_n = 1.0f / kNfft;
    for (int o = threadIdx.x; o < kHop; o += kThreads) {
      const float2 zp = zbuf[slot(o)];
      const float2 zq = zbuf[slot(o + kHop)];
      const float pa = zp.x * inv_n * syn[o];
      const float qa = zq.x * inv_n * syn[o + kHop];
      const float pb = zp.y * inv_n * syn[o];
      const float qb = zq.y * inv_n * syn[o + kHop];
      const int la = fa - j0;  // local block of fa's second half
      if (la - 1 >= 0) acc[(la - 1) * kHop + o] += pa;
      if (la < nj) acc[la * kHop + o] += qa + (has_b ? pb : 0.0f);
      if (has_b && la + 1 < nj) acc[(la + 1) * kHop + o] += qb;
    }
  }
  __syncthreads();
  const size_t obase = (size_t)b * nblk_out * kHop + (size_t)j0 * kHop;
  for (int i = threadIdx.x; i < nj * kHop; i += kThreads)
    out[obase + i] = acc[i] * wss_inv[(size_t)j0 * kHop + i];
}

// At most 56 registers a thread, so four blocks share an SM (measured
// faster than three blocks without spills, PERF.md).
template <int N, typename T>
__global__ void __launch_bounds__(kThreads, 4)
beamform_istft_kernel(const T* __restrict__ wav, const float2* __restrict__ w,
                      const float* __restrict__ wss_inv,
                      const float* __restrict__ window,
                      const float* __restrict__ synth, float* __restrict__ out,
                      int S, int nblk_out) {
  beamform_istft_body<N, T, false>(wav, w, wss_inv, window, synth, out, S,
                                   nblk_out, 1, 1);
}

template <int N, typename T>
__global__ void __launch_bounds__(kThreads, 4)
beamform_istft_online_kernel(const T* __restrict__ wav,
                             const float2* __restrict__ w,
                             const float* __restrict__ wss_inv,
                             const float* __restrict__ window,
                             const float* __restrict__ synth,
                             float* __restrict__ out, int S, int nblk_out,
                             int chunk, int n_chunks) {
  beamform_istft_body<N, T, true>(wav, w, wss_inv, window, synth, out, S,
                                  nblk_out, chunk, n_chunks);
}

template <typename T>
int launch_a(const void* wav, const float* mask, const float* window,
             float2* part, float2* rs, float2* rn, int B, int N, int S,
             int K, cudaStream_t st) {
  const int nf = S / kHop + 1;
  const int per = (nf + K - 1) / K;
  const T* x = static_cast<const T*>(wav);
  dim3 grid(B, K);
  const int rblocks = (B * kBins + 127) / 128;
  switch (N) {
#define CASE(n)                                                              \
  case n:                                                                    \
    stft_covar_kernel<n, T><<<grid, kThreads, 0, st>>>(x, mask, window,     \
                                                       part, S, nf, per);    \
    covar_reduce_kernel<n><<<rblocks, 128, 0, st>>>(part, rs, rn, B, K);     \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Kernel A alone with one run of `chunk` frames per block: part holds the
// per-chunk numerators, nothing is reduced.
template <typename T>
int launch_a_chunks(const void* wav, const float* mask, const float* window,
                    float2* part, int B, int N, int S, int chunk,
                    cudaStream_t st) {
  const int nf = S / kHop + 1;
  const T* x = static_cast<const T*>(wav);
  dim3 grid(B, (nf + chunk - 1) / chunk);
  switch (N) {
#define CASE(n)                                                              \
  case n:                                                                    \
    stft_covar_kernel<n, T><<<grid, kThreads, 0, st>>>(x, mask, window,     \
                                                       part, S, nf, chunk);  \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// chunk <= 0: offline kernel B; else the online kernel with one weight row
// per chunk of frames.
template <typename T>
int launch_b(const void* wav, const float2* w, const float* wss_inv,
             const float* window, const float* synth, float* out, int B, int N,
             int S, int chunk, cudaStream_t st) {
  const int nblk_out = S / kHop;
  const int n_chunks = chunk > 0 ? (nblk_out + chunk) / chunk : 1;
  const T* x = static_cast<const T*>(wav);
  dim3 grid((nblk_out + chunk_blocks(N) - 1) / chunk_blocks(N), B);
  switch (N) {
#define CASE(n)                                                          \
  case n:                                                                \
    if (chunk > 0)                                                       \
      beamform_istft_online_kernel<n, T><<<grid, kThreads, 0, st>>>(    \
          x, w, wss_inv, window, synth, out, S, nblk_out, chunk,         \
          n_chunks);                                                     \
    else                                                                 \
      beamform_istft_kernel<n, T><<<grid, kThreads, 0, st>>>(           \
          x, w, wss_inv, window, synth, out, S, nblk_out);               \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

bool geometry_ok(int B, int N, int S) {
  return B > 0 && N >= 1 && N <= 8 && S % kHop == 0 && S >= kNfft;
}

}  // namespace

// wav (B, N, S) int16 (is_int16 = 1) or float32; mask (B, S/256+1, 257)
// f32; window (512,) f32 analysis window with any input scale folded in;
// part (B, K, 257, N (N+1)) complex64 scratch for K runs of frames
// (1 <= K <= S/256+1); rs, rn (B, 257, N, N) complex64 numerators.
extern "C" int stft_covar_launch(const void* wav, const void* mask,
                                 const void* window, void* part, void* rs,
                                 void* rn, int B, int N, int S, int K,
                                 int is_int16, void* stream) {
  if (!geometry_ok(B, N, S) || K < 1 || K > S / kHop + 1)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto m = static_cast<const float*>(mask);
  auto win = static_cast<const float*>(window);
  auto pt = static_cast<float2*>(part);
  auto a = static_cast<float2*>(rs);
  auto c = static_cast<float2*>(rn);
  return is_int16 ? launch_a<int16_t>(wav, m, win, pt, a, c, B, N, S, K, st)
                  : launch_a<float>(wav, m, win, pt, a, c, B, N, S, K, st);
}

// wav as above; w (B, 257, N) complex64; wss_inv (S/256, 256) f32;
// window as above; synth (512,) f32 synthesis window; out (B, S) f32.
extern "C" int beamform_istft_launch(const void* wav, const void* w,
                                     const void* wss_inv, const void* window,
                                     const void* synth, void* out, int B,
                                     int N, int S, int is_int16,
                                     void* stream) {
  if (!geometry_ok(B, N, S)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto wt = static_cast<const float2*>(w);
  auto wi = static_cast<const float*>(wss_inv);
  auto win = static_cast<const float*>(window);
  auto syn = static_cast<const float*>(synth);
  auto o = static_cast<float*>(out);
  return is_int16
             ? launch_b<int16_t>(wav, wt, wi, win, syn, o, B, N, S, 0, st)
             : launch_b<float>(wav, wt, wi, win, syn, o, B, N, S, 0, st);
}

// Online pair.  C = ceil(T / chunk) chunks of frames, T = S/256 + 1;
// chunk c covers frames [c chunk, min(T, (c + 1) chunk)).
// Kernel A per chunk: wav, mask, window as stft_covar_launch; part
// (B, C, 257, N (N+1)) complex64, the per-chunk numerators.
extern "C" int stft_covar_chunks_launch(const void* wav, const void* mask,
                                        const void* window, void* part,
                                        int B, int N, int S, int chunk,
                                        int is_int16, void* stream) {
  if (!geometry_ok(B, N, S) || chunk < 1) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto m = static_cast<const float*>(mask);
  auto win = static_cast<const float*>(window);
  auto pt = static_cast<float2*>(part);
  return is_int16
             ? launch_a_chunks<int16_t>(wav, m, win, pt, B, N, S, chunk, st)
             : launch_a_chunks<float>(wav, m, win, pt, B, N, S, chunk, st);
}

// part as above for T frames, mask (B, T, 257) f32 -> es, en
// (B, C, 257, N, N) complex64, the EMA state after each chunk.
extern "C" int covar_ema_launch(const void* part, const void* mask, void* es,
                                void* en, int B, int N, int T, int chunk,
                                float alpha, void* stream) {
  if (B < 1 || N < 1 || N > 8 || T < 1 || chunk < 1)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto pt = static_cast<const float2*>(part);
  auto m = static_cast<const float*>(mask);
  auto s = static_cast<float2*>(es);
  auto n = static_cast<float2*>(en);
  const int n_chunks = (T + chunk - 1) / chunk;
  const int blocks = (B * kBins + kEmaBins - 1) / kEmaBins;
  const int threads = 2 * N * N * kEmaBins;
  switch (N) {
#define CASE(k)                                                          \
  case k:                                                                \
    covar_ema_kernel<k><<<blocks, threads, 0, st>>>(pt, m, s, n, B, T,   \
                                                    chunk, n_chunks,     \
                                                    alpha);              \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// wav, wss_inv, window, synth, out as beamform_istft_launch; w
// (B, C, 257, N) complex64, one weight row per chunk.
extern "C" int beamform_istft_online_launch(const void* wav, const void* w,
                                            const void* wss_inv,
                                            const void* window,
                                            const void* synth, void* out,
                                            int B, int N, int S, int chunk,
                                            int is_int16, void* stream) {
  if (!geometry_ok(B, N, S) || chunk < 1) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto wt = static_cast<const float2*>(w);
  auto wi = static_cast<const float*>(wss_inv);
  auto win = static_cast<const float*>(window);
  auto syn = static_cast<const float*>(synth);
  auto o = static_cast<float*>(out);
  return is_int16
             ? launch_b<int16_t>(wav, wt, wi, win, syn, o, B, N, S, chunk, st)
             : launch_b<float>(wav, wt, wi, win, syn, o, B, N, S, chunk, st);
}
