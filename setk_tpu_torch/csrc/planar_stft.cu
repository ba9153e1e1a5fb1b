// Planar STFT (kernel 9) and planar iSTFT (kernel 10) for the geometries
// outside the fused kernels' gate (sm_90a): n_fft = 2 hop, n_fft a power
// of two in [256, 2048], any sample count S >= n_fft.
//
// Kernel 9 replaces setk_tpu/ops/pallas/stft.py: _stft_pallas_blocks
// (:126, body _stft_kernel :100) and _stft_pallas_wavblocks (:157, body
// _stft_kernel_edges :106), reached through forward_stft_pallas_planar
// (:195).  Rows of samples (B N, S) int16 or f32 -> re, im (rows, T,
// n_fft/2) f32 (bins 0 .. n_fft/2 - 1) and the real Nyquist bin (rows, T).
// With center, frame t is the reflect-padded signal over
// [t hop, t hop + n_fft); without, the signal itself.  T is the frame
// count, with no padding rows.  int16 enters as is; the caller folds
// 1/32768 into the window.
//
// Kernel 10 replaces _istft_pallas (:300, body _istft_kernel :269),
// reached through inverse_stft_pallas_planar (:365): the inverse real DFT
// of each frame's (re, im, Nyquist) with the synthesis window, the 50%
// overlap-add out[j] = P[j+1] + Q[j] (P, Q the frame halves; the +1 is the
// center trim) and the reciprocal window-sum-square multiply, for center
// framing and any output length: samples at or past (T - 1) hop are zeros,
// as the reference's inverse_stft zero-pads after the trim.
//
// Bound on the card (B=128, N=6, 8 s at n_fft 1024, T=251): kernel 9
// reads 197 MB of int16 and writes 790 MB of planes (~0.29 ms at
// 3.35 TB/s); kernel 10 reads 132 MB of planes and writes 66 MB
// (~0.06 ms).  Both are bound by bytes.  The TPU kernels' matmul DFT
// against a window-folded basis (with bf16 hi/lo splits) would be
// ~n_fft / (5 log2 n_fft) times the operations of an FFT; here each block
// runs radix-2 FFTs in shared memory, two frames per complex FFT
// (x = frame_a + i frame_b, split by Hermitian symmetry), twiddles from a
// float64 sincospi table.  Kernel 9 gives each block a run of frames of
// one row; kernel 10 gives each block a run of output hop blocks of one
// utterance and synthesizes the one extra frame its overlap-add needs
// itself, so no block reads another's result.  The TPU's 128-frame T
// padding, _T_MAX chunking, hi/lo basis splits and edge side input have
// no counterpart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFramesPerBlock = 16;  // kernel 9: frames of one row a block

// Shared-memory slot of FFT point q: one float2 of padding every 32
// points, so the bit-reversed scatter does not land in one bank.
__device__ __forceinline__ int slot(int q) { return q + (q >> 5); }

template <int LOG2N>
__device__ __forceinline__ int bitrev(int n) {
  return (int)(__brev((unsigned)n) >> (32 - LOG2N));
}

// tw[j] = exp(-2 pi i j / n_fft), j < n_fft / 2
template <int LOG2N>
__device__ __forceinline__ void init_twiddles(float2* tw) {
  constexpr int kN = 1 << LOG2N;
  for (int j = threadIdx.x; j < kN / 2; j += blockDim.x) {
    double s, c;
    sincospi(-2.0 * (double)j / (double)kN, &s, &c);
    tw[j] = make_float2((float)c, (float)s);
  }
}

// P in-place radix-2 decimation-in-time FFTs of n_fft points over
// buf[p * stride + slot(i)], input in bit-reversed order.  Forward uses
// exp(-i...), inverse exp(+i...) without the 1/n_fft.  Every thread of
// the block calls it (it synchronizes before each stage and at the end).
template <int LOG2N, int P, bool kInverse>
__device__ __forceinline__ void fft(float2* buf, const float2* tw) {
  constexpr int kN = 1 << LOG2N;
  constexpr int kStride = kN + kN / 32;
#pragma unroll 1
  for (int s = 0; s < LOG2N; ++s) {
    __syncthreads();
    const int half = 1 << s;
    for (int t = threadIdx.x; t < kN / 2; t += blockDim.x) {
      const int pos = t & (half - 1);
      const int i0 = ((t >> s) << (s + 1)) + pos;
      const int i1 = i0 + half;
      float2 w = tw[pos << (LOG2N - 1 - s)];
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

// Sample n of frame t of one row, reflected at both ends with center.
template <int LOG2N, bool kCenter, typename T>
__device__ __forceinline__ float frame_sample(const T* __restrict__ x, int S,
                                              int t, int n) {
  constexpr int kHop = 1 << (LOG2N - 1);
  int j = t * kHop + n - (kCenter ? kHop : 0);
  if (kCenter) {
    if (j < 0) j = -j;
    else if (j >= S) j = 2 * S - 2 - j;
  }
  return (float)x[j];
}

// Complex buffers a kernel-9 pass transforms (two frames each): two up to
// n_fft 1024, one at 2048 (48 KB of static shared memory).
template <int LOG2N>
__host__ __device__ constexpr int stft_buffers() {
  return LOG2N >= 11 ? 1 : 2;
}

template <int LOG2N, bool kCenter, typename T>
__global__ void __launch_bounds__(kThreads)
stft_planar_kernel(const T* __restrict__ wav, const float* __restrict__ window,
                   float* __restrict__ re, float* __restrict__ im,
                   float* __restrict__ nyq, int S, int n_frames) {
  constexpr int kN = 1 << LOG2N;
  constexpr int kFh = kN / 2;
  constexpr int kStride = kN + kN / 32;
  constexpr int P = stft_buffers<LOG2N>();
  __shared__ float2 buf[P * kStride];
  __shared__ float2 tw[kN / 2];
  __shared__ float win[kN];
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * kFramesPerBlock;
  const int t1 = min(n_frames, t0 + kFramesPerBlock);
  init_twiddles<LOG2N>(tw);
  for (int j = threadIdx.x; j < kN; j += kThreads) win[j] = window[j];
  const T* x = wav + (size_t)row * S;
  const size_t orow = (size_t)row * n_frames;

  for (int t = t0; t < t1; t += 2 * P) {
    __syncthreads();  // tables ready / last pass's spectra consumed
    // frame t + 2p in the real part of buffer p, t + 2p + 1 in the
    // imaginary part (zero past the run)
    for (int i = threadIdx.x; i < P * kN; i += kThreads) {
      const int p = i >> LOG2N;
      const int n = i & (kN - 1);
      const int fa = t + 2 * p;
      const float a = fa < t1 ? frame_sample<LOG2N, kCenter>(x, S, fa, n) *
                                    win[n]
                              : 0.0f;
      const float b = fa + 1 < t1
                          ? frame_sample<LOG2N, kCenter>(x, S, fa + 1, n) *
                                win[n]
                          : 0.0f;
      buf[p * kStride + slot(bitrev<LOG2N>(n))] = make_float2(a, b);
    }
    fft<LOG2N, P, false>(buf, tw);
    // bins 0 .. n_fft/2 of both frames of each buffer:
    // X_a = (Z[k] + conj Z[-k]) / 2, X_b = (Z[k] - conj Z[-k]) / 2i
    for (int i = threadIdx.x; i < P * (kFh + 1); i += kThreads) {
      const int p = i / (kFh + 1);
      const int k = i - p * (kFh + 1);
      const int fa = t + 2 * p;
      if (fa >= t1) continue;
      const bool has_b = fa + 1 < t1;
      const float2 zk = buf[p * kStride + slot(k)];
      const float2 zm = buf[p * kStride + slot((kN - k) & (kN - 1))];
      if (k < kFh) {
        const size_t oa = (orow + fa) * kFh + k;
        re[oa] = 0.5f * (zk.x + zm.x);
        im[oa] = 0.5f * (zk.y - zm.y);
        if (has_b) {
          re[oa + kFh] = 0.5f * (zk.y + zm.y);
          im[oa + kFh] = 0.5f * (zm.x - zk.x);
        }
      } else {
        // the Nyquist bin is real: Re Z for frame a, Im Z for frame b
        nyq[orow + fa] = zk.x;
        if (has_b) nyq[orow + fa + 1] = zk.y;
      }
    }
  }
}

// Output hop blocks a kernel-10 block writes: 16 KB of overlap-add
// accumulator at every n_fft.
template <int LOG2N>
__host__ __device__ constexpr int istft_blocks() {
  return 4096 >> (LOG2N - 1);
}

// Bin k of frame f of one utterance's beamformed spectrum; only the real
// part of bins 0 and n_fft/2 enters the inverse real DFT.
template <int LOG2N>
__device__ __forceinline__ float2 enh_bin(const float* __restrict__ er,
                                          const float* __restrict__ ei,
                                          const float* __restrict__ ny,
                                          size_t frame, int k) {
  constexpr int kFh = 1 << (LOG2N - 1);
  if (k == kFh) return make_float2(ny[frame], 0.0f);
  const size_t idx = frame * kFh + k;
  return make_float2(er[idx], k == 0 ? 0.0f : ei[idx]);
}

template <int LOG2N>
__global__ void __launch_bounds__(kThreads)
istft_planar_kernel(const float* __restrict__ er, const float* __restrict__ ei,
                    const float* __restrict__ ny,
                    const float* __restrict__ window,
                    const float* __restrict__ wss_inv, float* __restrict__ out,
                    int n_frames, int n_valid, int nsamps) {
  constexpr int kN = 1 << LOG2N;
  constexpr int kFh = kN / 2;
  constexpr int kHop = kN / 2;
  constexpr int kStride = kN + kN / 32;
  constexpr int CH = istft_blocks<LOG2N>();
  __shared__ float2 zbuf[kStride];
  __shared__ float2 tw[kN / 2];
  __shared__ float acc[CH * kHop];
  const int b = blockIdx.y;
  const int j0 = blockIdx.x * CH;
  const int nblk = (nsamps + kHop - 1) / kHop;      // output hop blocks
  const int nj = min(CH, nblk - j0);
  const int nvb = (n_valid + kHop - 1) / kHop;      // blocks with signal
  const int njv = max(0, min(nj, nvb - j0));
  init_twiddles<LOG2N>(tw);
  for (int i = threadIdx.x; i < nj * kHop; i += kThreads) acc[i] = 0.0f;
  const size_t fbase = (size_t)b * n_frames;
  const float inv_n = 1.0f / kN;

  // output blocks j0 .. j0 + njv - 1 take frames j0 .. j0 + njv; frames
  // run in pairs (fa, fb), one complex inverse FFT for both
  // (z = x_fa + i x_fb)
  for (int fa = j0; njv > 0 && fa <= j0 + njv; fa += 2) {
    const int fb = fa + 1;
    const bool has_b = fb <= j0 + njv;
    __syncthreads();  // zbuf free, tables ready
    for (int k = threadIdx.x; k <= kFh; k += kThreads) {
      const float2 ea = enh_bin<LOG2N>(er, ei, ny, fbase + fa, k);
      const float2 eb = has_b ? enh_bin<LOG2N>(er, ei, ny, fbase + fb, k)
                              : make_float2(0.0f, 0.0f);
      // Z = E_a + i E_b, Hermitian-extended to n_fft bins
      zbuf[slot(bitrev<LOG2N>(k & (kN - 1)))] =
          make_float2(ea.x - eb.y, ea.y + eb.x);
      if (k > 0 && k < kFh)
        zbuf[slot(bitrev<LOG2N>(kN - k))] =
            make_float2(ea.x + eb.y, eb.x - ea.y);
    }
    fft<LOG2N, 1, true>(zbuf, tw);
    // synthesis frame f, sample n: first half (P) -> block f - 1 at n,
    // second half (Q) -> block f at n - hop.  One thread per offset o
    // adds every contribution to that offset, so no two threads collide.
    const int la = fa - j0;
    for (int o = threadIdx.x; o < kHop; o += kThreads) {
      const float2 zp = zbuf[slot(o)];
      const float2 zq = zbuf[slot(o + kHop)];
      const float sp = window[o] * inv_n;
      const float sq = window[o + kHop] * inv_n;
      if (la - 1 >= 0) acc[(la - 1) * kHop + o] += zp.x * sp;
      if (la < nj) acc[la * kHop + o] += zq.x * sq + (has_b ? zp.y * sp : 0.0f);
      if (has_b && la + 1 < nj) acc[(la + 1) * kHop + o] += zq.y * sq;
    }
  }
  __syncthreads();
  const size_t obase = (size_t)b * nsamps;
  for (int i = threadIdx.x; i < nj * kHop; i += kThreads) {
    const int g = j0 * kHop + i;
    if (g < nsamps) out[obase + g] = g < n_valid ? acc[i] * wss_inv[g] : 0.0f;
  }
}

template <int LOG2N, typename T>
int launch_stft(const void* wav, const float* window, float* re, float* im,
                float* nyq, int rows, int S, int center, cudaStream_t st) {
  constexpr int kN = 1 << LOG2N;
  const int n_frames =
      center ? 1 + S / (kN / 2) : 1 + (S - kN) / (kN / 2);
  dim3 grid((n_frames + kFramesPerBlock - 1) / kFramesPerBlock, rows);
  const T* x = static_cast<const T*>(wav);
  if (center)
    stft_planar_kernel<LOG2N, true, T><<<grid, kThreads, 0, st>>>(
        x, window, re, im, nyq, S, n_frames);
  else
    stft_planar_kernel<LOG2N, false, T><<<grid, kThreads, 0, st>>>(
        x, window, re, im, nyq, S, n_frames);
  return cudaGetLastError();
}

template <typename T>
int dispatch_stft(const void* wav, const float* window, float* re, float* im,
                  float* nyq, int rows, int S, int n_fft, int center,
                  cudaStream_t st) {
  switch (n_fft) {
    case 256:
      return launch_stft<8, T>(wav, window, re, im, nyq, rows, S, center, st);
    case 512:
      return launch_stft<9, T>(wav, window, re, im, nyq, rows, S, center, st);
    case 1024:
      return launch_stft<10, T>(wav, window, re, im, nyq, rows, S, center,
                                st);
    case 2048:
      return launch_stft<11, T>(wav, window, re, im, nyq, rows, S, center,
                                st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int LOG2N>
int launch_istft(const float* er, const float* ei, const float* ny,
                 const float* window, const float* wss_inv, float* out, int B,
                 int n_frames, int n_valid, int nsamps, cudaStream_t st) {
  constexpr int kHop = 1 << (LOG2N - 1);
  constexpr int CH = istft_blocks<LOG2N>();
  const int nblk = (nsamps + kHop - 1) / kHop;
  dim3 grid((nblk + CH - 1) / CH, B);
  istft_planar_kernel<LOG2N><<<grid, kThreads, 0, st>>>(
      er, ei, ny, window, wss_inv, out, n_frames, n_valid, nsamps);
  return cudaGetLastError();
}

bool n_fft_ok(int n_fft) {
  return n_fft == 256 || n_fft == 512 || n_fft == 1024 || n_fft == 2048;
}

}  // namespace

// wav (rows, S) int16 (is_int16 = 1) or float32; window (n_fft,) f32 with
// any input scale folded in; re, im (rows, T, n_fft/2) and nyq (rows, T)
// f32, T = S / hop + 1 with center, (S - n_fft) / hop + 1 without.
// hop = n_fft / 2, n_fft in {256, 512, 1024, 2048}, S >= n_fft.
extern "C" int stft_planar_launch(const void* wav, const void* window,
                                  void* re, void* im, void* nyq, int rows,
                                  int S, int n_fft, int center, int is_int16,
                                  void* stream) {
  if (rows < 1 || !n_fft_ok(n_fft) || S < n_fft) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto win = static_cast<const float*>(window);
  auto r = static_cast<float*>(re);
  auto i = static_cast<float*>(im);
  auto q = static_cast<float*>(nyq);
  return is_int16
             ? dispatch_stft<int16_t>(wav, win, r, i, q, rows, S, n_fft,
                                      center, st)
             : dispatch_stft<float>(wav, win, r, i, q, rows, S, n_fft, center,
                                    st);
}

// er, ei (B, T, n_fft/2) and ny (B, T) f32, the beamformed spectrum;
// window (n_fft,) synthesis window; wss_inv (>= n_valid,) f32 reciprocal
// window-sum-square of the center-trimmed signal; out (B, nsamps) f32.
// n_valid = min(nsamps, (T - 1) hop): samples from n_valid on are zeros.
extern "C" int istft_planar_launch(const void* er, const void* ei,
                                   const void* ny, const void* window,
                                   const void* wss_inv, void* out, int B,
                                   int n_frames, int n_fft, int n_valid,
                                   int nsamps, void* stream) {
  if (B < 1 || !n_fft_ok(n_fft) || n_frames < 2 || nsamps < 1 ||
      n_valid < 0 || n_valid > nsamps ||
      n_valid > (n_frames - 1) * (n_fft / 2))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float*>(er);
  auto c = static_cast<const float*>(ei);
  auto q = static_cast<const float*>(ny);
  auto win = static_cast<const float*>(window);
  auto wi = static_cast<const float*>(wss_inv);
  auto o = static_cast<float*>(out);
  switch (n_fft) {
    case 256:
      return launch_istft<8>(a, c, q, win, wi, o, B, n_frames, n_valid,
                             nsamps, st);
    case 512:
      return launch_istft<9>(a, c, q, win, wi, o, B, n_frames, n_valid,
                             nsamps, st);
    case 1024:
      return launch_istft<10>(a, c, q, win, wi, o, B, n_frames, n_valid,
                              nsamps, st);
    default:
      return launch_istft<11>(a, c, q, win, wi, o, B, n_frames, n_valid,
                              nsamps, st);
  }
}
