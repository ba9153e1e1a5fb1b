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
// as the reference's inverse_stft zero-pads after the trim.  Its second
// entry (beamform_istft_planar_launch) first beamforms the N mics' planes,
// E[t, k] = sum_n conj(w[k, n]) X_n[t, k] (at the Nyquist bin
// sum_n Re w[k, n] X_n[t, k]), which setk_tpu/enhance/pipeline.py:259-269
// does in XLA before the TPU kernel; no beamformed spectrum reaches device
// memory.
//
// Bound on the card (B=128, N=6, 8 s at n_fft 1024, T=251): kernel 9
// reads 197 MB of int16 and writes 790 MB of planes (~0.29 ms at
// 3.35 TB/s); kernel 10 reads 132 MB of planes and writes 66 MB
// (~0.06 ms), and with the beamform reads the 790 MB of planes, 0.8 MB of
// Nyquist rows and 3.2 MB of weights instead (~0.26 ms).  All are bound by
// bytes.  The TPU kernels' matmul DFT against a window-folded basis (with
// bf16 hi/lo splits) would be ~n_fft / (5 log2 n_fft) times the operations
// of an FFT; here two frames share one complex FFT (x = frame_a + i
// frame_b, split by Hermitian symmetry), twiddles from float64 sincospi
// tables.  The TPU's 128-frame T padding, _T_MAX chunking, hi/lo basis
// splits and edge side input have no counterpart.
//
// Kernel 9: a block of W warps takes a run of frames of one row in tiles
// of 2 W frames, a warp a pair of frames a tile.  Per tile: one block
// barrier (the tile's hop blocks have landed, the last tile's buffer is
// free), the next tile's 2 W + 1 hop blocks issued by 16-byte cp.async
// into the other half of a two-tile ring (sample by sample for the
// reflected edge blocks and rows off 16-byte alignment), then each warp's
// transform with no block barrier inside it (warp_transform):
// n_fft = R1 x 8 x 8 (R1 = n_fft / 64), n = 64 a + 8 b + c, k = k0 +
// R1 k1 + 8 R1 k2, three passes in registers (two R1-point DFTs a lane
// over a; R1 / 4 8-point DFTs over b; R1 / 4 over c) with the twiddles
// W_{8 R1}^(b k0) and W_n^(c (k0 + R1 k1)) between them and two
// transposes through the warp's slot under __syncwarp (rows of 68 float2
// with an XOR swizzle: no bank conflicts at any n_fft).  The spectrum goes
// to the slot in natural order and the split reads bin k and its mirror
// from it, so each store covers 32 consecutive bins of one plane.  Every
// sample is read from device memory once a run (plus one hop block a
// tile).
//
// Kernel 10: a block of W = 4 warps makes a run of up to 127 output hop
// blocks [j0, j1) of one utterance from frames j0 .. j1 (the frame a run
// shares with the next is synthesized by both: 1/127 more reads), in tiles
// of 2 W frames, a warp a pair of frames (a, b) a tile, with one block
// barrier a tile:
//   - beamform in registers (istft_beamform): lane l takes bins l + 32 m
//     of both frames and, mic by mic, loads up to 16 bins' re and im of
//     each frame (64 loads of 4 bytes a lane, rows of 128 bytes) straight
//     from device memory, where each plane byte is read once (nothing is
//     gained by staging), then adds conj(w) X into E_a, E_b in registers;
//     the utterance's weight row sits in shared memory, staged once a
//     block.  A block's 4 warps keep up to 32 KB of loads in flight; at
//     n_fft 1024 an SM holds two blocks (89 KB of shared memory with N =
//     6, 204 registers a thread), 64 KB, above the ~25-30 KB an SM needs
//     for 3.35 TB/s.  Without the beamform N = 1 and the weight is 1.
//   - the inverse (warp_inverse): E_a, E_b of bins 0 .. n_fft/2 go to the
//     warp's slot as float4s (only the real parts at bins 0 and n_fft/2);
//     Z = E_a + i E_b and its Hermitian mirror Z[n - k] = conj E_a[k] +
//     i conj E_b[k] are read from there into kernel 9's three passes, run
//     on conj Z (IDFT(Z) = conj DFT(conj Z) / n): frame a's samples are the
//     real parts, frame b's the negated imaginary parts, in natural order
//     in the slot, with no block barrier.
//   - overlap-add on chip: the warp writes output block a = Q[a] + P[b]
//     itself, publishes P[a] for warp w - 1 (two buffers by tile parity, so
//     that one barrier a tile suffices) and after the barrier writes block
//     b = Q[b] + P[b + 1] from warp w + 1's; the last warp keeps its Q[b]
//     in shared memory until the next tile's warp 0 publishes P[b + 1].
//     Stores are 128-byte rows with wss_inv applied, its values loaded
//     before the beamform (an L2 round trip per store group, waited for
//     between the inverse and the stores, took ~40 % of a warp's cycles);
//     blocks past the signal are zeros.
//   - the transform's twiddles and the synthesis window (over n_fft) are
//     built once a block.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStftWarps = 4;   // kernel 9: warps a block
constexpr int kStftTiles = 8;   // kernel 9: tiles of 2 warps frames a run
constexpr int kStftRun = 2 * kStftWarps * kStftTiles;  // frames a block

// ---- kernel 9 ----
constexpr int kRow = 68;  // float2 a k0 row of a warp's slot

__device__ __forceinline__ float2 f2add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 f2sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 f2mul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// cos(k pi / 16), 0 <= k <= 8
__host__ __device__ constexpr float qcos(int k) {
  return k == 0 ? 1.0f
         : k == 1 ? 0.98078528040323044913f
         : k == 2 ? 0.92387953251128675613f
         : k == 3 ? 0.83146961230254523708f
         : k == 4 ? 0.70710678118654752440f
         : k == 5 ? 0.55557023301960222474f
         : k == 6 ? 0.38268343236508977173f
         : k == 7 ? 0.19509032201612826785f
                  : 0.0f;
}
// cos(2 pi j / 32), any j
__host__ __device__ constexpr float cos32(int j) {
  return (j & 31) <= 8    ? qcos(j & 31)
         : (j & 31) <= 16 ? -qcos(16 - (j & 31))
         : (j & 31) <= 24 ? -qcos((j & 31) - 16)
                          : qcos(32 - (j & 31));
}

// z W_r^e, W_r = exp(-2 pi i / r), r <= 32; e and r are constants once the
// callers' loops unroll, so the trivial twiddles cost nothing.
__device__ __forceinline__ float2 mul_w(float2 z, int e, int r) {
  constexpr float h = 0.70710678118654752f;
  if (e == 0) return z;
  if (4 * e == r) return make_float2(z.y, -z.x);                    // -i
  if (8 * e == r) return make_float2(h * (z.x + z.y), h * (z.y - z.x));
  if (8 * e == 3 * r) return make_float2(h * (z.y - z.x), -h * (z.x + z.y));
  const int j = e * (32 / r);
  return f2mul(z, make_float2(cos32(j), -cos32(j - 8)));
}

__host__ __device__ constexpr int bitrev_c(int i, int r) {
  int out = 0;
  for (int m = 1; m < r; m <<= 1) out = (out << 1) | ((i & m) ? 1 : 0);
  return out;
}

// Forward R-point DFT in registers (R = 4 .. 32), natural order in and
// out: radix-2 decimation in frequency, then the bit-reversal as a renaming.
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
#pragma unroll
  for (int half = R / 2; half >= 1; half /= 2) {
#pragma unroll
    for (int s = 0; s < R; s += 2 * half) {
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const float2 x = v[s + j], y = v[s + j + half];
        v[s + j] = f2add(x, y);
        v[s + j + half] = mul_w(f2sub(x, y), j, 2 * half);
      }
    }
  }
  float2 t[R];
#pragma unroll
  for (int i = 0; i < R; ++i) t[i] = v[i];
#pragma unroll
  for (int i = 0; i < R; ++i) v[i] = t[bitrev_c(i, R)];
}

// Two consecutive samples (even offset) as floats.  int16 without the
// conversion unit: x + 32768 in the low mantissa bits of 2^23 is exact,
// so (2^23 + x + 32768) - (2^23 + 32768) = x.
__device__ __forceinline__ float2 two_samples(const int16_t* p) {
  const unsigned v = *reinterpret_cast<const unsigned*>(p) ^ 0x80008000u;
  constexpr float kBias = 8421376.0f;  // 2^23 + 32768
  return make_float2(__uint_as_float(0x4b000000u | (v & 0xffffu)) - kBias,
                     __uint_as_float(0x4b000000u | (v >> 16)) - kBias);
}
__device__ __forceinline__ float2 two_samples(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// The warp transform's geometry at n_fft = 2^LOG2N.
template <int LOG2N>
struct WarpFft {
  static constexpr int N = 1 << LOG2N;
  static constexpr int HOP = N / 2;
  static constexpr int R1 = N / 64;      // the first pass's radix
  static constexpr int COLS = R1 / 4;    // 8-point DFTs a lane a pass
  static constexpr int SLOT = R1 * kRow;  // float2 a warp's slot
};

// Slot cell of (k0, r, c), r = b after the first pass and k1 after the
// second: rows of 68 float2 and c XOR-swizzled by r and k0 / 4, so that
// every pass's reads and writes are free of bank conflicts.
__device__ __forceinline__ int cell(int k0, int r, int c) {
  return k0 * kRow + 8 * r + (c ^ ((2 * r ^ 3 * (k0 >> 2)) & 7));
}

// The warp transform's twiddles: tw2 the pass-2 twiddles
// W_n^(c (k0 + R1 k1)) of lane l's column ii at [(ii 8 + k1) 32 + l]
// (column u = l + 32 ii is k0 = u % R1, c = u / R1); tw1[k0 8 + b] =
// W_{8 R1}^(b k0).  Each from the float64 sincospi.
template <int LOG2N>
__device__ __forceinline__ void fft_tables(float2* tw2, float2* tw1) {
  using F = WarpFft<LOG2N>;
  for (int i = threadIdx.x; i < F::N; i += blockDim.x) {
    const int l = i & 31, k1 = (i >> 5) & 7, ii = i >> 8;
    const int u = l + 32 * ii, k0 = u % F::R1, c = u / F::R1;
    double s, co;
    sincospi(-2.0 * (double)((c * (k0 + F::R1 * k1)) & (F::N - 1)) /
                 (double)F::N, &s, &co);
    tw2[i] = make_float2((float)co, (float)s);
  }
  for (int i = threadIdx.x; i < 8 * F::R1; i += blockDim.x) {
    double s, co;
    sincospi(-2.0 * (double)((i >> 3) * (i & 7)) / (double)(8 * F::R1), &s,
             &co);
    tw1[i] = make_float2((float)co, (float)s);
  }
}

// Kernel 9's tables: the twiddles and win2, half the window in pairs (a
// unit window for null).
template <int LOG2N>
__device__ __forceinline__ void stft_tables(float2* tw2, float2* tw1,
                                            float2* win2,
                                            const float* __restrict__ window) {
  fft_tables<LOG2N>(tw2, tw1);
  for (int i = threadIdx.x; i < WarpFft<LOG2N>::HOP; i += blockDim.x)
    win2[i] = window == nullptr
                  ? make_float2(0.5f, 0.5f)
                  : make_float2(0.5f * window[2 * i],
                                0.5f * window[2 * i + 1]);
}

// The warp transform's three passes, no block barrier: z0[a], z1[a] hold
// points 64 a + 2 l and 64 a + 2 l + 1 of lane l (b = l / 4, c = 2 (l %
// 4) + e); the DFT over a, then over b, then over c.  Leaves the
// transform in the slot's first n_fft float2 in natural order and returns
// after a __syncwarp.  The slot must be free (no lane still reading it);
// every lane of the warp must call it.
template <int LOG2N, int R1 = WarpFft<LOG2N>::R1>
__device__ __forceinline__ void warp_passes(float2* wslot, float2 (&z0)[R1],
                                            float2 (&z1)[R1],
                                            const float2* tw1,
                                            const float2* tw2) {
  using F = WarpFft<LOG2N>;
  const int l = threadIdx.x & 31;
  dft<R1>(z0);
  dft<R1>(z1);
  {
    const int b = l >> 2, q = l & 3;
#pragma unroll
    for (int k0 = 0; k0 < R1; ++k0) {
      float2 u0 = z0[k0], u1 = z1[k0];
      if (k0 > 0) {
        const float2 w = tw1[8 * k0 + b];
        u0 = f2mul(u0, w);
        u1 = f2mul(u1, w);
      }
      // cells (k0, b, 2q) and (k0, b, 2q + 1): one aligned pair, swapped
      // where the swizzle is odd
      const int sw = (2 * b ^ 3 * (k0 >> 2)) & 7;
      const float4 v = (sw & 1) ? make_float4(u1.x, u1.y, u0.x, u0.y)
                                : make_float4(u0.x, u0.y, u1.x, u1.y);
      *reinterpret_cast<float4*>(wslot + k0 * kRow + 8 * b +
                                 ((2 * q) ^ (sw & 6))) = v;
    }
  }
  __syncwarp();
  // pass 2: column u = l + 32 ii is (k0, c) = (u % R1, u / R1); DFT over b,
  // then W_n^(c (k0 + R1 k1)), back to the same cells
#pragma unroll
  for (int ii = 0; ii < F::COLS; ++ii) {
    const int u = l + 32 * ii, k0 = u % R1, c = u / R1;
    float2 v[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) v[b] = wslot[cell(k0, b, c)];
    dft<8>(v);
#pragma unroll
    for (int k1 = 0; k1 < 8; ++k1)
      wslot[cell(k0, k1, c)] = f2mul(v[k1], tw2[(8 * ii + k1) * 32 + l]);
  }
  __syncwarp();
  // pass 3: column v = l + 32 ii is (k0, k1) = (v % R1, v / R1); DFT over
  // c: z[ii][k2] = Z[k0 + R1 k1 + 8 R1 k2]
  float2 z[F::COLS][8];
#pragma unroll
  for (int ii = 0; ii < F::COLS; ++ii) {
    const int v = l + 32 * ii, k0 = v % R1, k1 = v / R1;
    const int sw = (2 * k1 ^ 3 * (k0 >> 2)) & 7;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float4 x = *reinterpret_cast<const float4*>(
          wslot + k0 * kRow + 8 * k1 + ((2 * p) ^ (sw & 6)));
      const float2 lo = make_float2(x.x, x.y), hi = make_float2(x.z, x.w);
      z[ii][2 * p] = (sw & 1) ? hi : lo;
      z[ii][2 * p + 1] = (sw & 1) ? lo : hi;
    }
    dft<8>(z[ii]);
  }
  __syncwarp();
#pragma unroll
  for (int ii = 0; ii < F::COLS; ++ii) {
    const int v = l + 32 * ii;
#pragma unroll
    for (int k2 = 0; k2 < 8; ++k2) wslot[v + 8 * R1 * k2] = z[ii][k2];
  }
  __syncwarp();
}

// One warp's n_fft-point transform of z = w (x_a + i x_b) / 2, no block
// barrier: xa, xb the two frames' samples (16-byte aligned shared memory
// or not), win2 half the window in pairs.  Without has_b, x_b is zero and
// xb is not read.  Leaves Z in the slot's first n_fft float2 in natural
// order and returns after a __syncwarp.  Every lane of the warp must call
// it.
template <int LOG2N, typename T>
__device__ __forceinline__ void warp_transform(float2* wslot, const T* xa,
                                               const T* xb, bool has_b,
                                               const float2* win2,
                                               const float2* tw1,
                                               const float2* tw2) {
  constexpr int R1 = WarpFft<LOG2N>::R1;
  const int l = threadIdx.x & 31;
  // pass 1's points n = 64 a + 2 l + e, e = 0 in z0 and 1 in z1
  float2 z0[R1], z1[R1];
#pragma unroll
  for (int a = 0; a < R1; ++a) {
    const int n = 64 * a + 2 * l;
    const float2 w = win2[32 * a + l];
    const float2 sa = two_samples(xa + n);
    const float2 sb = has_b ? two_samples(xb + n) : make_float2(0.f, 0.f);
    z0[a] = make_float2(sa.x * w.x, sb.x * w.x);
    z1[a] = make_float2(sa.y * w.y, sb.y * w.y);
  }
  warp_passes<LOG2N>(wslot, z0, z1, tw1, tw2);
}

template <int LOG2N, typename T>
__host__ __device__ constexpr size_t stft_smem_bytes() {
  using F = WarpFft<LOG2N>;
  return ((size_t)F::N + 8 * F::R1 + F::HOP + (size_t)kStftWarps * F::SLOT) *
             8 +
         (size_t)2 * (2 * kStftWarps + 1) * F::HOP * sizeof(T);
}

// Hop blocks q0 .. q0 + nb - 1 of one row (x, S samples) into dst, block
// q at dst + (q - q0) hop: 16-byte cp.async inside the row, sample by
// sample for the reflected blocks -1 and past S (center) and for every
// block of a row that is not 16-byte aligned.
template <int LOG2N, bool kCenter, typename T>
__device__ __forceinline__ void stft_stage(T* dst, const T* __restrict__ x,
                                           int S, int q0, int nb,
                                           bool aligned) {
  constexpr int HOP = WarpFft<LOG2N>::HOP;
  constexpr int V = 16 / sizeof(T);
  constexpr int PER = HOP / V;
  for (int i = threadIdx.x; i < nb * PER; i += blockDim.x) {
    const int q = q0 + i / PER, v = i % PER;
    T* d = dst + (size_t)(i / PER) * HOP + v * V;
    if (aligned && q >= 0 && (q + 1) * HOP <= S) {
      __pipeline_memcpy_async(d, x + (size_t)q * HOP + v * V, 16);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        int j = q * HOP + v * V + e;
        if (kCenter) {
          if (j < 0) j = -j;
          else if (j >= S) j = 2 * S - 2 - j;
        }
        d[e] = x[j];
      }
    }
  }
  __pipeline_commit();
}

template <int LOG2N, bool kCenter, typename T>
__global__ void __launch_bounds__(32 * kStftWarps)
stft_planar_kernel(const T* __restrict__ wav, const float* __restrict__ window,
                   float* __restrict__ re, float* __restrict__ im,
                   float* __restrict__ nyq, int S, int n_frames) {
  using F = WarpFft<LOG2N>;
  extern __shared__ float4 smem4[];
  constexpr int W = kStftWarps;
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  float2* tw2 = reinterpret_cast<float2*>(smem4);
  float2* tw1 = tw2 + F::N;
  float2* win2 = tw1 + 8 * F::R1;
  float2* wslot = win2 + F::HOP + (size_t)warp * F::SLOT;
  T* ring = reinterpret_cast<T*>(win2 + F::HOP + (size_t)W * F::SLOT);
  const int buf = (2 * W + 1) * F::HOP;  // samples a tile's buffer
  const int row = blockIdx.y;
  const int r0 = blockIdx.x * kStftRun;
  const int r1 = min(n_frames, r0 + kStftRun);
  const int tiles = (r1 - r0 + 2 * W - 1) / (2 * W);
  const T* x = wav + (size_t)row * S;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int c = kCenter ? 1 : 0;
  const size_t orow = (size_t)row * n_frames;
  stft_tables<LOG2N>(tw2, tw1, win2, window);
  stft_stage<LOG2N, kCenter>(ring, x, S, r0 - c, min(2 * W, r1 - r0) + 1,
                             aligned);
#pragma unroll 1
  for (int k = 0; k < tiles; ++k) {
    const int tt = r0 + 2 * W * k;
    __pipeline_wait_prior(0);
    __syncthreads();  // tile k landed; tile k - 1's buffer free; tables
    if (k + 1 < tiles)
      stft_stage<LOG2N, kCenter>(ring + ((k + 1) & 1) * buf, x, S,
                                 tt + 2 * W - c,
                                 min(2 * W, r1 - tt - 2 * W) + 1, aligned);
    // frames fa and fa + 1; a frame past the run was not staged (only the
    // last tile of a run has such frames, so a warp past it is done)
    const int fa = tt + 2 * warp;
    if (fa >= r1) continue;
    const bool has_b = fa + 1 < r1;
    const T* xa = ring + (k & 1) * buf + 2 * warp * F::HOP;
    warp_transform<LOG2N, T>(wslot, xa, xa + F::HOP, has_b, win2, tw1, tw2);
    // X_a = (Z[k] + conj Z[-k]) / 2, X_b = (Z[k] - conj Z[-k]) / 2i (the
    // halves are in the window)
    float* ra = re + (orow + fa) * F::HOP;
    float* ia = im + (orow + fa) * F::HOP;
#pragma unroll
    for (int m = 0; m < F::HOP / 32; ++m) {
      const int kk = l + 32 * m;
      const float2 zk = wslot[kk], zm = wslot[(F::N - kk) & (F::N - 1)];
      ra[kk] = zk.x + zm.x;
      ia[kk] = zk.y - zm.y;
      if (has_b) {
        ra[F::HOP + kk] = zk.y + zm.y;
        ia[F::HOP + kk] = zm.x - zk.x;
      }
    }
    if (l == 0) {  // the Nyquist bin is real: Re Z for a, Im Z for b
      const float2 zn = wslot[F::HOP];
      nyq[orow + fa] = zn.x + zn.x;
      if (has_b) nyq[orow + fa + 1] = zn.y + zn.y;
    }
  }
}

// Test entry's kernel: warp_transform on windowed rows, a warp a pair of
// rows (frames a and b of pair p at frames + (2 p + {0, 1}) n_fft), spec
// (pairs, 2, n_fft / 2 + 1) complex64; unit window.
template <int LOG2N>
__global__ void stft_planar_transform_kernel(const float* __restrict__ frames,
                                             float2* __restrict__ spec) {
  using F = WarpFft<LOG2N>;
  extern __shared__ float4 smem4[];
  float2* tw2 = reinterpret_cast<float2*>(smem4);
  float2* tw1 = tw2 + F::N;
  float2* win2 = tw1 + 8 * F::R1;
  float2* wslot = win2 + F::HOP;
  stft_tables<LOG2N>(tw2, tw1, win2, nullptr);
  __syncthreads();
  const float* xa = frames + (size_t)blockIdx.x * 2 * F::N;
  warp_transform<LOG2N, float>(wslot, xa, xa + F::N, true, win2, tw1, tw2);
  float2* out = spec + (size_t)blockIdx.x * 2 * (F::HOP + 1);
  for (int kk = threadIdx.x; kk <= F::HOP; kk += 32) {
    const float2 zk = wslot[kk], zm = wslot[(F::N - kk) & (F::N - 1)];
    out[kk] = make_float2(zk.x + zm.x, zk.y - zm.y);
    out[F::HOP + 1 + kk] = make_float2(zk.y + zm.y, zm.x - zk.x);
  }
}

// ---- kernel 10 ----
constexpr int kIstftWarps = 4;                 // warps a block
constexpr int kIstftTile = 2 * kIstftWarps;    // frames a tile
// output hop blocks a block: 128 frames, 16 whole tiles
constexpr int kIstftRun = 16 * kIstftTile - 1;
constexpr int kIstftBins = 16;  // bins a lane loads a mic and frame at once

// Byte offsets into kernel 10's dynamic shared memory; the beamform's
// weights (mics x n_fft/2 float2, bins in order) and the Nyquist bin's
// real weights (mics floats) come last.
template <int LOG2N>
struct IstftLayout {
  using F = WarpFft<LOG2N>;
  static constexpr size_t slots = 0;  // a warp's slot: E, then the inverse
  static constexpr size_t tw2 = slots + (size_t)kIstftWarps * F::SLOT * 8;
  static constexpr size_t tw1 = tw2 + (size_t)F::N * 8;
  static constexpr size_t syn = tw1 + (size_t)8 * F::R1 * 8;  // window / n
  // each warp's P[a], two buffers by tile parity
  static constexpr size_t xchg = syn + (size_t)F::N * 4;
  static constexpr size_t carry = xchg + (size_t)2 * kIstftWarps * F::HOP * 4;
  static constexpr size_t wts = carry + (size_t)F::HOP * 4;
  __host__ __device__ static constexpr size_t bytes(int mics) {
    return wts + (size_t)mics * (F::HOP * 8 + 4);
  }
};

// Bin k of E_a, E_b into the slot's float4 k; only the real parts of bins
// 0 and n_fft/2 enter the inverse real DFT.
template <int LOG2N>
__device__ __forceinline__ void put_e(float4* e4, int k, float2 ea,
                                      float2 eb) {
  const bool real = (k & (WarpFft<LOG2N>::HOP - 1)) == 0;
  e4[k] = make_float4(ea.x, real ? 0.0f : ea.y, eb.x, real ? 0.0f : eb.y);
}

// One warp's beamform of frames fa and fb (-1: past the run, zeros) of
// utterance b into the slot as E (put_e, bins 0 .. n_fft/2).  re, im
// (B, mics, T, n_fft/2), nyq (B, mics, T); wts[n n_fft/2 + k] = w[k, n]
// and wny[n] = Re w[n_fft/2, n] in shared memory (kBeamform), else one mic
// of weight 1.  Lane l takes bins l + 32 m, kIstftBins at once, and
// issues a mic's loads of both frames before the sums that use them.
// Returns after a __syncwarp; every lane of the warp must call it.
template <int LOG2N, bool kBeamform>
__device__ __forceinline__ void istft_beamform(
    float4* e4, const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ nyq, const float2* wts, const float* wny,
    int b, int mics, int n_frames, int fa, int fb) {
  using F = WarpFft<LOG2N>;
  constexpr int HOP = F::HOP;
  constexpr int M = HOP / 32;  // bins a lane
  constexpr int G = M < kIstftBins ? M : kIstftBins;
  const int l = threadIdx.x & 31;
  float nya = 0.0f, nyb = 0.0f;
#pragma unroll 1
  for (int m0 = 0; m0 < M; m0 += G) {
    float2 ea[G], eb[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      ea[g] = eb[g] = make_float2(0.0f, 0.0f);
#pragma unroll 1
    for (int n = 0; n < mics; ++n) {
      const size_t row = (size_t)(b * mics + n) * n_frames;
      float ar[G], ai[G], br[G], bi[G];
      float na = 0.0f, nb = 0.0f;
      if (fa >= 0) {
        const size_t o = (row + fa) * HOP + 32 * m0 + l;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          ar[g] = re[o + 32 * g];
          ai[g] = im[o + 32 * g];
        }
        if (m0 == 0 && l == 0) na = nyq[row + fa];
      } else {
#pragma unroll
        for (int g = 0; g < G; ++g) ar[g] = ai[g] = 0.0f;
      }
      if (fb >= 0) {
        const size_t o = (row + fb) * HOP + 32 * m0 + l;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          br[g] = re[o + 32 * g];
          bi[g] = im[o + 32 * g];
        }
        if (m0 == 0 && l == 0) nb = nyq[row + fb];
      } else {
#pragma unroll
        for (int g = 0; g < G; ++g) br[g] = bi[g] = 0.0f;
      }
      // conj(w) x = (wr x.re + wi x.im, wr x.im - wi x.re)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float2 w = kBeamform ? wts[n * HOP + 32 * (m0 + g) + l]
                                   : make_float2(1.0f, 0.0f);
        ea[g].x += w.x * ar[g] + w.y * ai[g];
        ea[g].y += w.x * ai[g] - w.y * ar[g];
        eb[g].x += w.x * br[g] + w.y * bi[g];
        eb[g].y += w.x * bi[g] - w.y * br[g];
      }
      const float wn = kBeamform ? wny[n] : 1.0f;
      nya += wn * na;
      nyb += wn * nb;
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
      put_e<LOG2N>(e4, 32 * (m0 + g) + l, ea[g], eb[g]);
  }
  if (l == 0)
    put_e<LOG2N>(e4, HOP, make_float2(nya, 0.0f), make_float2(nyb, 0.0f));
  __syncwarp();
}

// One warp's inverse of the slot's E (bins 0 .. n_fft/2 of frames a and b
// from put_e), no block barrier: kernel 9's passes on conj Z, Z = E_a +
// i E_b Hermitian-extended (Z[n - k] = conj E_a[k] + i conj E_b[k]), so
// that the slot ends with y[j] = n (x_a[j] - i x_b[j]) in natural order
// (IDFT(Z) = conj DFT(conj Z) / n).  Every lane of the warp must call it.
template <int LOG2N>
__device__ __forceinline__ void warp_inverse(float2* wslot,
                                             const float2* tw1,
                                             const float2* tw2) {
  using F = WarpFft<LOG2N>;
  constexpr int R1 = F::R1;
  const int l = threadIdx.x & 31;
  const float4* e4 = reinterpret_cast<const float4*>(wslot);
  float2 z0[R1], z1[R1];
#pragma unroll
  for (int a = 0; a < R1; ++a) {
    const int k = 64 * a + 2 * l;
    // points k and k + 1: below n/2 conj Z[k] = (Ea.re - Eb.im,
    // -(Ea.im + Eb.re)); from n/2 on, from the mirror bin n - k, conj Z[k]
    // = (Ea.re + Eb.im, Ea.im - Eb.re)
    if (a < R1 / 2) {
      const float4 u = e4[k], v = e4[k + 1];
      z0[a] = make_float2(u.x - u.w, -(u.y + u.z));
      z1[a] = make_float2(v.x - v.w, -(v.y + v.z));
    } else {
      const float4 u = e4[F::N - k], v = e4[F::N - k - 1];
      z0[a] = make_float2(u.x + u.w, u.y - u.z);
      z1[a] = make_float2(v.x + v.w, v.y - v.z);
    }
  }
  __syncwarp();  // E read: the passes overwrite it
  warp_passes<LOG2N>(wslot, z0, z1, tw1, tw2);
}

// wss_inv over output hop block j's samples l + 32 i of a lane, 0 where
// the block lies outside [j0, j1) or past n_valid: loaded a tile ahead of
// its use, so that no L2 round trip waits between the inverse and the
// stores.
template <int HOP>
__device__ __forceinline__ void load_wss(float (&ws)[HOP / 32],
                                         const float* __restrict__ wss_inv,
                                         int j, int j0, int j1, int n_valid) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < HOP / 32; ++i) {
    const int g = j * HOP + l + 32 * i;
    ws[i] = j >= j0 && j < j1 && g < n_valid ? wss_inv[g] : 0.0f;
  }
}

// One sample of an output row with its wss_inv: zeros from n_valid on,
// nothing past nsamps.
__device__ __forceinline__ void put_sample(float* __restrict__ ob, int g,
                                           float v, float ws, int n_valid,
                                           int nsamps) {
  if (g < nsamps) ob[g] = g < n_valid ? v * ws : 0.0f;
}

#ifdef SETK_ISTFT_PHASES
// tools/planar_variants.py's phase build: every warp of kernel 10 adds the
// SM cycles of each phase in registers and lane 0 adds them into device
// counters when the block ends: 0 the tables and weights, 1 the beamform
// (loads and sums), 2 the inverse, 3 the overlap-add before the tile
// barrier, 4 the tile barrier, 5 the blocks written after it
__device__ unsigned long long g_istft_phase[6];
#define I_PHASE(i)                      \
  do {                                  \
    const long long now_ = clock64();   \
    iph_[i] += now_ - it_;              \
    it_ = now_;                         \
  } while (0)
#define I_PHASE_START \
  long long it_ = clock64(), iph_[6] = {0, 0, 0, 0, 0, 0}
#define I_PHASE_END                                                     \
  do {                                                                  \
    if ((threadIdx.x & 31) == 0)                                        \
      for (int i_ = 0; i_ < 6; ++i_)                                    \
        atomicAdd(&g_istft_phase[i_], (unsigned long long)iph_[i_]);    \
  } while (0)
#else
#define I_PHASE(i) \
  do {             \
  } while (0)
#define I_PHASE_START
#define I_PHASE_END
#endif

// Kernel 10.  Block (x, b) makes output hop blocks [x run, (x + 1) run) of
// utterance b, those with signal from frames of its own (see the header).
// kBeamform: re, im (B, mics, T, n_fft/2) and nyq (B, mics, T) with the
// MVDR weights w (B, n_fft/2 + 1, mics); else the beamformed planes, mics
// = 1, w unread.
template <int LOG2N, bool kBeamform>
__global__ void __launch_bounds__(32 * kIstftWarps)
istft_planar_kernel(const float* __restrict__ re, const float* __restrict__ im,
                    const float* __restrict__ nyq,
                    const float2* __restrict__ w,
                    const float* __restrict__ window,
                    const float* __restrict__ wss_inv, float* __restrict__ out,
                    int mics, int n_frames, int n_valid, int nsamps) {
  using F = WarpFft<LOG2N>;
  using L = IstftLayout<LOG2N>;
  constexpr int W = kIstftWarps, HOP = F::HOP;
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  float2* wslot = reinterpret_cast<float2*>(sm + L::slots) +
                  (size_t)warp * F::SLOT;
  float2* tw2 = reinterpret_cast<float2*>(sm + L::tw2);
  float2* tw1 = reinterpret_cast<float2*>(sm + L::tw1);
  float* syn = reinterpret_cast<float*>(sm + L::syn);
  float* xchg = reinterpret_cast<float*>(sm + L::xchg);
  float* carry = reinterpret_cast<float*>(sm + L::carry);
  float2* wts = reinterpret_cast<float2*>(sm + L::wts);
  float* wny = reinterpret_cast<float*>(wts + (size_t)mics * HOP);
  const int b = blockIdx.y;
  const int nblk = (nsamps + HOP - 1) / HOP;    // output hop blocks
  const int nvb = (n_valid + HOP - 1) / HOP;    // blocks with signal
  const int j0 = blockIdx.x * kIstftRun;
  const int jz = min(nblk, j0 + kIstftRun);
  const int j1 = min(jz, nvb);
  float* ob = out + (size_t)b * nsamps;
  for (int g = max(j0, j1) * HOP + threadIdx.x; g < min(nsamps, jz * HOP);
       g += blockDim.x)
    ob[g] = 0.0f;
  if (j1 <= j0) return;
  I_PHASE_START;
  fft_tables<LOG2N>(tw2, tw1);
  for (int i = threadIdx.x; i < F::N; i += blockDim.x)
    syn[i] = window[i] * (1.0f / F::N);
  if (kBeamform) {
    const float2* wr = w + (size_t)b * (HOP + 1) * mics;
    for (int i = threadIdx.x; i < HOP * mics; i += blockDim.x) {
      const int k = i / mics, n = i - k * mics;
      wts[n * HOP + k] = wr[i];
    }
    for (int n = threadIdx.x; n < mics; n += blockDim.x)
      wny[n] = wr[HOP * mics + n].x;
  }
  __syncthreads();
  I_PHASE(0);
  const bool last = warp == W - 1;
#pragma unroll 1
  for (int t0 = j0, k = 0; t0 <= j1; t0 += 2 * W, ++k) {
    // frames fa, fb; past j1 they are zeros, transformed all the same so
    // that every lane meets every __syncwarp
    const int fa = t0 + 2 * warp, fb = fa + 1;
    float* xc = xchg + (size_t)(k & 1) * W * HOP;
    // block fa's and (after the barrier) block j's wss_inv, in flight
    // during the beamform
    const int j = last ? t0 - 1 : fb;
    float wsa[HOP / 32], wsj[HOP / 32];
    load_wss<HOP>(wsa, wss_inv, fa, j0, j1, n_valid);
    load_wss<HOP>(wsj, wss_inv, j, j0, j1, n_valid);
    __syncwarp();  // the slot's reads of the last tile done
    istft_beamform<LOG2N, kBeamform>(
        reinterpret_cast<float4*>(wslot), re, im, nyq, wts, wny, b, mics,
        n_frames, fa <= j1 ? fa : -1, fb <= j1 ? fb : -1);
    I_PHASE(1);
    warp_inverse<LOG2N>(wslot, tw1, tw2);
    I_PHASE(2);
    // sample o of frame fa is y[o].x / n, of frame fb -y[o].y / n (syn
    // holds the 1 / n): block fa = Q[fa] + P[fb] here, P[fa] published
#pragma unroll
    for (int i = 0; i < HOP / 32; ++i) {
      const int o = l + 32 * i;
      const float2 p = wslot[o], q = wslot[HOP + o];
      const float sp = syn[o], sq = syn[HOP + o];
      xc[warp * HOP + o] = p.x * sp;
      if (fa < j1)
        put_sample(ob, fa * HOP + o, q.x * sq - p.y * sp, wsa[i], n_valid,
                   nsamps);
    }
    I_PHASE(3);
    __syncthreads();  // P halves published
    I_PHASE(4);
    // block j: fb = Q[fb] + P[fb + 1] (warp w + 1's P); the last warp's
    // t0 - 1 = Q[t0 - 1] (kept from the last tile) + P[t0] (warp 0's)
    const float* pn = xc + (last ? 0 : (warp + 1) * HOP);
    if (j >= j0 && j < j1) {
#pragma unroll
      for (int i = 0; i < HOP / 32; ++i) {
        const int o = l + 32 * i;
        const float qb =
            last ? carry[o] : -wslot[HOP + o].y * syn[HOP + o];
        put_sample(ob, j * HOP + o, qb + pn[o], wsj[i], n_valid, nsamps);
      }
    }
    if (last) {
#pragma unroll 4
      for (int i = 0; i < HOP / 32; ++i) {
        const int o = l + 32 * i;
        carry[o] = -wslot[HOP + o].y * syn[HOP + o];
      }
    }
    I_PHASE(5);
  }
  I_PHASE_END;
}

// Test entry's kernel: warp_inverse on pairs of real spectra, a warp a
// pair; spec (pairs, 2, n_fft / 2 + 1) complex64 (the imaginary parts at
// bins 0 and n_fft / 2 ignored) -> frames (pairs, 2, n_fft) f32, the
// inverse real DFTs with the 1 / n_fft.
template <int LOG2N>
__global__ void istft_planar_inverse_kernel(const float2* __restrict__ spec,
                                            float* __restrict__ frames) {
  using F = WarpFft<LOG2N>;
  extern __shared__ float4 smem4[];
  float2* tw2 = reinterpret_cast<float2*>(smem4);
  float2* tw1 = tw2 + F::N;
  float2* wslot = tw1 + 8 * F::R1;
  fft_tables<LOG2N>(tw2, tw1);
  const float2* sa = spec + (size_t)blockIdx.x * 2 * (F::HOP + 1);
  const float2* sb = sa + F::HOP + 1;
  for (int k = threadIdx.x; k <= F::HOP; k += 32)
    put_e<LOG2N>(reinterpret_cast<float4*>(wslot), k, sa[k], sb[k]);
  __syncthreads();
  warp_inverse<LOG2N>(wslot, tw1, tw2);
  float* fa = frames + (size_t)blockIdx.x * 2 * F::N;
  for (int j = threadIdx.x; j < F::N; j += 32) {
    fa[j] = wslot[j].x * (1.0f / F::N);
    fa[F::N + j] = -wslot[j].y * (1.0f / F::N);
  }
}

template <int LOG2N, typename T>
int launch_stft(const void* wav, const float* window, float* re, float* im,
                float* nyq, int rows, int S, int center, cudaStream_t st) {
  constexpr int kN = 1 << LOG2N;
  const int n_frames =
      center ? 1 + S / (kN / 2) : 1 + (S - kN) / (kN / 2);
  dim3 grid((n_frames + kStftRun - 1) / kStftRun, rows);
  const size_t smem = stft_smem_bytes<LOG2N, T>();
  const T* x = static_cast<const T*>(wav);
  if (smem > 48 * 1024) {
    int err = cudaFuncSetAttribute(stft_planar_kernel<LOG2N, true, T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(stft_planar_kernel<LOG2N, false, T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (center)
    stft_planar_kernel<LOG2N, true, T><<<grid, 32 * kStftWarps, smem, st>>>(
        x, window, re, im, nyq, S, n_frames);
  else
    stft_planar_kernel<LOG2N, false, T><<<grid, 32 * kStftWarps, smem, st>>>(
        x, window, re, im, nyq, S, n_frames);
  return cudaGetLastError();
}

template <typename T>
int dispatch_stft(const void* wav, const float* window, float* re, float* im,
                  float* nyq, int rows, int S, int n_fft, int center,
                  cudaStream_t st) {
  switch (n_fft) {
#define CASE(nn, lg)                                                       \
  case nn:                                                                 \
    return launch_stft<lg, T>(wav, window, re, im, nyq, rows, S, center,   \
                              st);
    CASE(256, 8) CASE(512, 9) CASE(1024, 10) CASE(2048, 11)
#undef CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <int LOG2N, bool kBeamform>
int launch_istft(const float* re, const float* im, const float* nyq,
                 const float2* w, const float* window, const float* wss_inv,
                 float* out, int B, int mics, int n_frames, int n_valid,
                 int nsamps, cudaStream_t st) {
  constexpr int kHop = 1 << (LOG2N - 1);
  const int nblk = (nsamps + kHop - 1) / kHop;
  dim3 grid((nblk + kIstftRun - 1) / kIstftRun, B);
  const size_t smem = IstftLayout<LOG2N>::bytes(kBeamform ? mics : 0);
  if (smem > 48 * 1024) {
    const int err = cudaFuncSetAttribute(
        istft_planar_kernel<LOG2N, kBeamform>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  istft_planar_kernel<LOG2N, kBeamform><<<grid, 32 * kIstftWarps, smem, st>>>(
      re, im, nyq, w, window, wss_inv, out, mics, n_frames, n_valid, nsamps);
  return cudaGetLastError();
}

template <bool kBeamform>
int dispatch_istft(const void* re, const void* im, const void* nyq,
                   const void* w, const void* window, const void* wss_inv,
                   void* out, int B, int mics, int n_frames, int n_fft,
                   int n_valid, int nsamps, cudaStream_t st) {
  auto r = static_cast<const float*>(re);
  auto i = static_cast<const float*>(im);
  auto q = static_cast<const float*>(nyq);
  auto wt = static_cast<const float2*>(w);
  auto win = static_cast<const float*>(window);
  auto wi = static_cast<const float*>(wss_inv);
  auto o = static_cast<float*>(out);
  switch (n_fft) {
#define CASE(nn, lg)                                                          \
  case nn:                                                                    \
    return launch_istft<lg, kBeamform>(r, i, q, wt, win, wi, o, B, mics,      \
                                       n_frames, n_valid, nsamps, st);
    CASE(256, 8) CASE(512, 9) CASE(1024, 10) CASE(2048, 11)
#undef CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <int LOG2N, bool kBeamform>
int istft_layout(int mics, int* out) {
  const size_t smem = IstftLayout<LOG2N>::bytes(mics);
  int err = cudaFuncSetAttribute(istft_planar_kernel<LOG2N, kBeamform>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], istft_planar_kernel<LOG2N, kBeamform>, 32 * kIstftWarps,
        smem);
  out[0] = (int)smem;
  out[2] = kIstftRun;
  return err;
}

// Kernel 10's refusals, both entries.
bool istft_args_ok(int B, int n_frames, int n_fft, int n_valid, int nsamps) {
  return B >= 1 && n_frames >= 2 && nsamps >= 1 && n_valid >= 0 &&
         n_valid <= nsamps && n_valid <= (n_frames - 1) * (n_fft / 2);
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

// Kernel 9's warp transform alone, for the tests: frames (pairs, 2, n_fft)
// f32 rows (windowed), spec (pairs, 2, n_fft / 2 + 1) complex64, the two
// rows of a pair split from one complex transform.
extern "C" int stft_planar_transform_launch(const void* frames, void* spec,
                                            int pairs, int n_fft,
                                            void* stream) {
  if (pairs < 1 || !n_fft_ok(n_fft)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto f = static_cast<const float*>(frames);
  auto o = static_cast<float2*>(spec);
  switch (n_fft) {
#define CASE(nn, lg)                                                          \
  case nn: {                                                                  \
    using F = WarpFft<lg>;                                                    \
    const size_t smem = (size_t)(F::N + 8 * F::R1 + F::HOP + F::SLOT) * 8;    \
    if (smem > 48 * 1024) {                                                   \
      const int err = cudaFuncSetAttribute(                                   \
          stft_planar_transform_kernel<lg>,                                   \
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);            \
      if (err != cudaSuccess) return err;                                     \
    }                                                                         \
    stft_planar_transform_kernel<lg><<<pairs, 32, smem, st>>>(f, o);          \
    break;                                                                    \
  }
    CASE(256, 8) CASE(512, 9) CASE(1024, 10) CASE(2048, 11)
#undef CASE
  }
  return cudaGetLastError();
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
  if (!n_fft_ok(n_fft) || !istft_args_ok(B, n_frames, n_fft, n_valid, nsamps))
    return cudaErrorInvalidValue;
  return dispatch_istft<false>(er, ei, ny, nullptr, window, wss_inv, out, B,
                               1, n_frames, n_fft, n_valid, nsamps,
                               static_cast<cudaStream_t>(stream));
}

// Kernel 10 with the beamform: re, im (B, mics, T, n_fft/2) and nyq (B,
// mics, T) f32, the observation's planes; w (B, n_fft/2 + 1, mics)
// complex64 MVDR weights; 1 <= mics <= 8; the rest as istft_planar_launch.
extern "C" int beamform_istft_planar_launch(
    const void* re, const void* im, const void* nyq, const void* w,
    const void* window, const void* wss_inv, void* out, int B, int mics,
    int n_frames, int n_fft, int n_valid, int nsamps, void* stream) {
  if (!n_fft_ok(n_fft) || mics < 1 || mics > 8 ||
      !istft_args_ok(B, n_frames, n_fft, n_valid, nsamps))
    return cudaErrorInvalidValue;
  return dispatch_istft<true>(re, im, nyq, w, window, wss_inv, out, B, mics,
                              n_frames, n_fft, n_valid, nsamps,
                              static_cast<cudaStream_t>(stream));
}

// Kernel 10's launch at n_fft with mics weights (0: the entry without the
// beamform): out[0] its dynamic shared memory in bytes, out[1] the blocks
// an SM holds (the occupancy query), out[2] the output hop blocks a block
// makes.
extern "C" int istft_planar_layout(int n_fft, int mics, int* out) {
  if (!n_fft_ok(n_fft) || mics < 0 || mics > 8) return cudaErrorInvalidValue;
  switch (n_fft) {
#define CASE(nn, lg)                                                       \
  case nn:                                                                 \
    return mics ? istft_layout<lg, true>(mics, out)                        \
                : istft_layout<lg, false>(0, out);
    CASE(256, 8) CASE(512, 9) CASE(1024, 10) CASE(2048, 11)
#undef CASE
  }
  return cudaErrorInvalidValue;
}

// Kernel 10's warp inverse alone, for the tests: spec (pairs, 2, n_fft/2
// + 1) complex64 pairs of real spectra -> frames (pairs, 2, n_fft) f32,
// their inverse real DFTs.
extern "C" int istft_planar_inverse_launch(const void* spec, void* frames,
                                           int pairs, int n_fft,
                                           void* stream) {
  if (pairs < 1 || !n_fft_ok(n_fft)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto s = static_cast<const float2*>(spec);
  auto f = static_cast<float*>(frames);
  switch (n_fft) {
#define CASE(nn, lg)                                                          \
  case nn: {                                                                  \
    using F = WarpFft<lg>;                                                    \
    const size_t smem = (size_t)(F::N + 8 * F::R1 + F::SLOT) * 8;             \
    if (smem > 48 * 1024) {                                                   \
      const int err = cudaFuncSetAttribute(                                   \
          istft_planar_inverse_kernel<lg>,                                    \
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);            \
      if (err != cudaSuccess) return err;                                     \
    }                                                                         \
    istft_planar_inverse_kernel<lg><<<pairs, 32, smem, st>>>(s, f);           \
    break;                                                                    \
  }
    CASE(256, 8) CASE(512, 9) CASE(1024, 10) CASE(2048, 11)
#undef CASE
  }
  return cudaGetLastError();
}

#ifdef SETK_ISTFT_PHASES
// The phase build's counters (6 sums of SM cycles over warps), read and
// zeroed.
extern "C" int istft_phase_read(unsigned long long* out) {
  int err = cudaMemcpyFromSymbol(out, g_istft_phase, 6 * 8);
  if (err != cudaSuccess) return err;
  const unsigned long long zero[6] = {};
  return cudaMemcpyToSymbol(g_istft_phase, zero, 6 * 8);
}
#endif
