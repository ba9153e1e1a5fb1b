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
// ~n_fft / (5 log2 n_fft) times the operations of an FFT; here two frames
// share one complex FFT (x = frame_a + i frame_b, split by Hermitian
// symmetry), twiddles from float64 sincospi tables.  The TPU's 128-frame T
// padding, _T_MAX chunking, hi/lo basis splits and edge side input have no
// counterpart.
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
// tile).  The old block-wide radix-2 FFT (fft below, one barrier a stage)
// remains kernel 10's.
//
// Kernel 10 gives each block a run of output hop blocks of one utterance
// and synthesizes the one extra frame its overlap-add needs itself, so no
// block reads another's result; it runs radix-2 FFTs over the block in
// shared memory.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // kernel 10
constexpr int kStftWarps = 4;   // kernel 9: warps a block
constexpr int kStftTiles = 8;   // kernel 9: tiles of 2 warps frames a run
constexpr int kStftRun = 2 * kStftWarps * kStftTiles;  // frames a block

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

// Kernel 9's tables: tw2 the pass-2 twiddles W_n^(c (k0 + R1 k1)) of
// lane l's column ii at [(ii 8 + k1) 32 + l] (column u = l + 32 ii is k0
// = u % R1, c = u / R1); tw1[k0 8 + b] = W_{8 R1}^(b k0); win2 half the
// window in pairs (a unit window for null).  Each twiddle from the
// float64 sincospi.
template <int LOG2N>
__device__ __forceinline__ void stft_tables(float2* tw2, float2* tw1,
                                            float2* win2,
                                            const float* __restrict__ window) {
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
  for (int i = threadIdx.x; i < F::HOP; i += blockDim.x)
    win2[i] = window == nullptr
                  ? make_float2(0.5f, 0.5f)
                  : make_float2(0.5f * window[2 * i],
                                0.5f * window[2 * i + 1]);
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
  using F = WarpFft<LOG2N>;
  constexpr int R1 = F::R1;
  const int l = threadIdx.x & 31;
  {
    // pass 1: lane l holds n = 64 a + 2 l + e (b = l / 4, c = 2 (l % 4)
    // + e), e = 0 in z0 and 1 in z1; DFT over a
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
    dft<R1>(z0);
    dft<R1>(z1);
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
