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
//   the f32 peak); here the transforms are FFTs, two mics per complex
//   transform (x = y_a + i y_b, split by Hermitian symmetry), which cuts
//   the operations ~20x, to about the byte bound (~0.1 ms each).
//   Twiddles come from a float64 sincospi table, so the transform stays
//   f32-grade.  No atomics: every sum over frames runs in frame order in
//   one thread, and runs of frames are added in a fixed order.
//
// Kernel A (stft_covar_kernel) was first a chain of block barriers (the
// radix-2 fft512 below, ~11 barriers a pair of frames) with a bin owner's
// 2 N (N+1) sums spilling at 96 registers.  Its design now:
//   - a warp transforms one (frame, mic pair) alone: 512 = 8 x 8 x 8, two
//     8-point DFTs a lane a pass in registers, two transposes through the
//     warp's slot of shared memory under __syncwarp, the two mics split in
//     registers (a lane holds bins k and their mirrors 512 - k);
//   - a block of 8 SH warps takes TF frames a tile (one transform a warp),
//     then one block barrier, then each thread adds the tile's frames to
//     the sums of one share of a bin's pairs (SH shares: at most 9 pairs,
//     36 f32 a thread at N = 8; bins 0 and 256, both real, share slot 0),
//     then one block barrier: two barriers a tile of 8 frames;
//   - each hop block of samples is copied once, by cp.async in 16-byte
//     vectors into a ring of TF + 1 blocks, the next tile's while this
//     tile's sums run; the mask while the transforms run; the reflected
//     edges (blocks -1 and S / 256) sample by sample;
//   - a block's last segment of frames goes out through the transform
//     slots, staged by bin and copied in order (a thread's pairs alone
//     would be 8-byte stores a row apart); the offline entry writes Rs,
//     Rn so itself when one run of frames an utterance fills the card (no
//     reduce); the per-chunk entry gives a block one chunk or, for chunks
//     under 32 frames, several, the earlier ones written when they end.
// Kernel B gives each block a run of output hop blocks, computes the one
// extra frame its overlap-add needs itself and still transforms two frames
// per pass of the radix-2 FFT's chain of block barriers (fft512).

// The online (chunked EMA) pair replaces stft_covar_online_pallas (:651,
// body _stft_covar_online_kernel :530) and beamform_istft_online_pallas
// (:771, body :712).  The TPU kernel's EMA-mixing matmuls with hi/lo
// K-stacks, its lane permutation and its 128-frame quarters are TPU
// devices and have no counterpart here.  Instead:
//   - kernel A sums each chunk of frames as a segment of its own (a block
//     takes one chunk or several), so its outputs are exactly the
//     per-chunk numerators (stft_covar_chunks_launch, no reduce);
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

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ---- kernel A ----
// A block of W = 8 SH warps sums one (utterance, range of frames) in tiles
// of TF frames.  Per tile: each warp transforms one (frame, mic pair) of
// the tile with no block barrier inside the transform (a_transform); one
// block barrier; every thread adds the tile's frames to the pair sums of
// its (share, bin slot); one block barrier.  The tile's samples were staged
// by cp.async during the previous tile's sums, its mask during its own
// transforms.  Bins 0 and 256 are real, so slot 0's thread sums both (bin
// 0's products in the real parts, bin 256's in the imaginary parts) and
// 256 slots cover 257 bins.
template <int N>
struct ACfg {
  static constexpr int P = (N + 1) / 2;        // complex transforms a frame
  static constexpr int NP = N * (N + 1) / 2;   // pairs of the upper triangle
  // shares of a bin's pairs (one thread each): at most 9 pairs, 36 f32
  static constexpr int SH = N <= 3 ? 1 : N == 4 ? 2 : N <= 6 ? 3 : 4;
  static constexpr int W = 8 * SH;             // warps: 256 slots x SH
  static constexpr int THREADS = 32 * W;
  static constexpr int TF = W / P;             // frames a tile: a warp each
  static constexpr int PPS = (NP + SH - 1) / SH;
  // blocks an SM that shared memory admits (registers follow from it)
  static constexpr int MIN_BLOCKS = N <= 3 ? 4 : N == 4 ? 2 : 1;
  static_assert(TF * P == W, "one transform a warp a tile");
};

// float4s of one transform's slot: the 8 x 33 float4 transposes of
// a_transform, then the two mics' bins 0..255
constexpr int kSlot4 = 264;
constexpr int kNyq = 8;  // bin 256 of a frame's mics (up to 8)

// Byte offsets into kernel A's dynamic shared memory.
template <int N, typename T>
struct ALayout {
  using C = ACfg<N>;
  static constexpr size_t spec = 0;            // W transform slots
  static constexpr size_t tw2 = spec + (size_t)C::W * kSlot4 * 16;
  static constexpr size_t tw1 = tw2 + 256 * 16;  // pass-2, pass-1 twiddles
  static constexpr size_t win = tw1 + 64 * 8;    // 0.5 x the window
  static constexpr size_t nyq = win + kNfft * 4;  // the tile's bin 256
  static constexpr size_t mask = nyq + (size_t)C::TF * kNyq * 4;  // its mask
  static constexpr size_t ring = mask + ((size_t)C::TF * kBins * 4 + 31) /
                                            16 * 16;  // TF + 1 hop blocks
  static constexpr int R = C::TF + 1;
  static constexpr size_t bytes = ring + (size_t)R * N * kHop * sizeof(T);
};

#ifdef SETK_FUSED_PHASES
// tools/fused_phase_profile.py's build: every warp of kernel A adds the SM
// cycles of each phase in registers and lane 0 adds them into device
// counters when the block ends: 0 staging (the tables, the mask and sample
// copies issued), 1 transform, 2 tile barriers (waiting for the copies and
// the block), 3 accumulation, 4 write
__device__ unsigned long long g_fused_phase[5];
#define A_PHASE(i)                      \
  do {                                  \
    const long long now_ = clock64();   \
    ph_[i] += now_ - t_;                \
    t_ = now_;                          \
  } while (0)
#define A_PHASE_START \
  long long t_ = clock64(), ph_[5] = {0, 0, 0, 0, 0}
#define A_PHASE_END                                                  \
  do {                                                               \
    if ((threadIdx.x & 31) == 0)                                     \
      for (int i_ = 0; i_ < 5; ++i_)                                 \
        atomicAdd(&g_fused_phase[i_], (unsigned long long)ph_[i_]);  \
  } while (0)
#else
#define A_PHASE(i) \
  do {             \
  } while (0)
#define A_PHASE_START
#define A_PHASE_END
#endif

__device__ __forceinline__ float2 f2add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 f2sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 f2mul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}
__device__ __forceinline__ float2 mul_mi(float2 z) {  // -i z
  return make_float2(z.y, -z.x);
}

// Forward 8-point DFT in registers, natural order in and out: three
// radix-2 stages, 52 additions and 4 multiplications.
__device__ __forceinline__ void dft8(float2 (&v)[8]) {
  constexpr float r = 0.70710678118654752f;
  const float2 a0 = f2add(v[0], v[4]), a4 = f2sub(v[0], v[4]);
  const float2 a1 = f2add(v[1], v[5]), d5 = f2sub(v[1], v[5]);
  const float2 a2 = f2add(v[2], v[6]), d6 = f2sub(v[2], v[6]);
  const float2 a3 = f2add(v[3], v[7]), d7 = f2sub(v[3], v[7]);
  // d5 W8, d6 W8^2 = -i d6, d7 W8^3
  const float2 a5 = make_float2(r * (d5.x + d5.y), r * (d5.y - d5.x));
  const float2 a6 = mul_mi(d6);
  const float2 a7 = make_float2(r * (d7.y - d7.x), -r * (d7.x + d7.y));
  const float2 b0 = f2add(a0, a2), b2 = f2sub(a0, a2);
  const float2 b1 = f2add(a1, a3), b3 = mul_mi(f2sub(a1, a3));
  const float2 b4 = f2add(a4, a6), b6 = f2sub(a4, a6);
  const float2 b5 = f2add(a5, a7), b7 = mul_mi(f2sub(a5, a7));
  v[0] = f2add(b0, b1);
  v[4] = f2sub(b0, b1);
  v[2] = f2add(b2, b3);
  v[6] = f2sub(b2, b3);
  v[1] = f2add(b4, b5);
  v[5] = f2sub(b4, b5);
  v[3] = f2add(b6, b7);
  v[7] = f2sub(b6, b7);
}

// Kernel A's twiddles: tw2[k1 32 + l] the pass-2 twiddles of lane l (k0 =
// l & 7, c = 2 (l >> 3) and c + 1): W512^(c (k0 + 8 k1)); tw1[k0 8 + b] =
// W64^(b k0); each from the float64 sincospi.
__device__ __forceinline__ void a_twiddles(float4* tw2, float2* tw1) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    const int k1 = i >> 5, l = i & 31;
    const int m = (l & 7) + 8 * k1, c = 2 * (l >> 3);
    double s0, c0, s1, c1;
    sincospi(-(double)((c * m) & 511) / 256.0, &s0, &c0);
    sincospi(-(double)(((c + 1) * m) & 511) / 256.0, &s1, &c1);
    tw2[i] = make_float4((float)c0, (float)s0, (float)c1, (float)s1);
  }
  for (int i = threadIdx.x; i < 64; i += blockDim.x) {
    double s, c;
    sincospi(-(double)((i >> 3) * (i & 7)) / 32.0, &s, &c);
    tw1[i] = make_float2((float)c, (float)s);
  }
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

// One warp's 512-point transform of z = w (x_a + i x_b), no block barrier:
// n = 64 a + 8 b + c, k = k0 + 8 k1 + 64 k2, three passes of two 8-point
// DFTs a lane (over a, then b, then c) with the twiddles W64^(b k0) and
// W512^(c (k0 + 8 k1)) between them and two transposes through the warp's
// slot under __syncwarp (rows of 33 float4: no bank conflicts).  Lane l
// keeps bins l + 64 m and their mirrors 512 - l - 64 m, so it splits the
// two mics (Z[k] +- conj Z[-k]) in registers and writes mic a's bins
// 0..255 to slot plane 0, mic b's to plane 1, and bin 256 (real, as bin 0
// is) to nyq[0], nyq[1].  h0, h1: mic a's hop blocks under the frame (mic
// b 256 samples after each); two: mic b exists.  Every lane of the warp
// must call it.
template <typename T>
__device__ __forceinline__ void a_transform(float4* slot, float* nyq,
                                            const T* h0, const T* h1,
                                            bool two, const float2* win2,
                                            const float2* tw1,
                                            const float4* tw2) {
  const int l = threadIdx.x & 31;
  float2 z0[8], z1[8];
  // pass 1: lane l holds n = 64 a + 2 l + e (b = l >> 2), e = 0, 1
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const T* h = (a < 4 ? h0 : h1) + 64 * (a & 3) + 2 * l;
    const float2 w = win2[32 * a + l];
    const float2 xa = two_samples(h);
    const float2 xb = two ? two_samples(h + kHop) : make_float2(0.0f, 0.0f);
    z0[a] = make_float2(xa.x * w.x, xb.x * w.x);
    z1[a] = make_float2(xa.y * w.y, xb.y * w.y);
  }
  dft8(z0);
  dft8(z1);
  const int b = l >> 2;
  slot[l] = make_float4(z0[0].x, z0[0].y, z1[0].x, z1[0].y);
#pragma unroll
  for (int k0 = 1; k0 < 8; ++k0) {
    const float2 w = tw1[8 * k0 + b];
    const float2 u = f2mul(z0[k0], w), v = f2mul(z1[k0], w);
    slot[33 * k0 + l] = make_float4(u.x, u.y, v.x, v.y);
  }
  __syncwarp();
  // pass 2: lane l takes k0 = l & 7 and c = 2 q, 2 q + 1 (q = l >> 3)
  const int k0 = l & 7, q = l >> 3;
#pragma unroll
  for (int bb = 0; bb < 8; ++bb) {
    const float4 v = slot[33 * k0 + 4 * bb + q];
    z0[bb] = make_float2(v.x, v.y);
    z1[bb] = make_float2(v.z, v.w);
  }
  __syncwarp();
  dft8(z0);
  dft8(z1);
#pragma unroll
  for (int k1 = 0; k1 < 8; ++k1) {
    const float4 w = tw2[32 * k1 + l];
    const float2 u = f2mul(z0[k1], make_float2(w.x, w.y));
    const float2 v = f2mul(z1[k1], make_float2(w.z, w.w));
    slot[33 * k0 + 4 * k1 + q] = make_float4(u.x, u.y, v.x, v.y);
  }
  __syncwarp();
  // pass 3: lane l takes (k0, k1) = (l & 7, l >> 3), bins l + 64 k2, and
  // its mirror column, bins 64 - l + 64 k2 (lane 0: (0, 4), bins 32 +
  // 64 k2, and bin 0's own mirrors in its first column)
  const bool l0 = l == 0;
  const int m0 = (8 - k0) & 7;
  const int m1 = l0 ? 4 : (k0 ? 7 - q : 8 - q);
  const int kb = l0 ? 32 : 64 - l;
#pragma unroll
  for (int cp = 0; cp < 4; ++cp) {
    const float4 u = slot[33 * k0 + 4 * q + cp];
    const float4 v = slot[33 * m0 + 4 * m1 + cp];
    z0[2 * cp] = make_float2(u.x, u.y);
    z0[2 * cp + 1] = make_float2(u.z, u.w);
    z1[2 * cp] = make_float2(v.x, v.y);
    z1[2 * cp + 1] = make_float2(v.z, v.w);
  }
  __syncwarp();
  dft8(z0);  // z0[k2] = Z[l + 64 k2]
  dft8(z1);  // z1[k2] = Z[kb + 64 k2]
  float2* pa = reinterpret_cast<float2*>(slot);
  float2* pb = pa + 256;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    // mic a: Z[k] + conj Z[-k]; mic b: -i (Z[k] - conj Z[-k])
    float2 zk = z0[m];
    float2 zm = l0 ? z0[(8 - m) & 7] : z1[7 - m];
    pa[l + 64 * m] = make_float2(zk.x + zm.x, zk.y - zm.y);
    pb[l + 64 * m] = make_float2(zk.y + zm.y, zm.x - zk.x);
    zk = z1[m];
    zm = l0 ? z1[7 - m] : z0[7 - m];
    pa[kb + 64 * m] = make_float2(zk.x + zm.x, zk.y - zm.y);
    pb[kb + 64 * m] = make_float2(zk.y + zm.y, zm.x - zk.x);
  }
  if (l0) {  // bin 256: Z[256] is its own mirror
    nyq[0] = z0[4].x + z0[4].x;
    if (two) nyq[1] = z0[4].y + z0[4].y;
  }
}

// Hop blocks q0..q1 of the utterance's N mics into the ring, block q in
// slot (q + 1) % R: 16-byte cp.async inside the waveform, sample by
// sample for the reflected blocks -1 and S / 256 (and for every block of a
// waveform that is not 16-byte aligned).
template <int N, typename T>
__device__ __forceinline__ void a_stage(T* ring, const T* __restrict__ x,
                                        int S, int q0, int q1, bool aligned) {
  constexpr int R = ALayout<N, T>::R;
  constexpr int V = 16 / sizeof(T);    // samples a copy
  constexpr int PER = kHop / V;        // copies a (block, mic)
  const int last = S / kHop;
  const int items = (q1 - q0 + 1) * N * PER;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int v = i % PER, m = (i / PER) % N, q = q0 + i / (PER * N);
    T* dst = ring + ((size_t)((q + 1) % R) * N + m) * kHop + v * V;
    if (aligned && q >= 0 && q < last) {
      __pipeline_memcpy_async(dst, x + (size_t)m * S + q * kHop + v * V, 16);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        int j = q * kHop + v * V + e;
        if (j < 0) j = -j;
        else if (j >= S) j = 2 * S - 2 - j;
        dst[e] = x[(size_t)m * S + j];
      }
    }
  }
  __pipeline_commit();
}

// Rows of `n` frames of the mask into the tile's mask buffer at ms + off,
// off (0..3 floats) chosen so that source and copy share their alignment
// and all but at most 3 floats at each end move in 16-byte vectors.
// Returns off.
__device__ __forceinline__ int a_stage_mask(float* ms,
                                            const float* __restrict__ rows,
                                            int n) {
  const int total = n * kBins;
  const int off = (int)((reinterpret_cast<uintptr_t>(rows) >> 2) & 3);
  const int head = min(total, (4 - off) & 3);
  const int vecs = (total - head) >> 2, tail = head + 4 * vecs;
  float* dst = ms + off;
  for (int i = threadIdx.x; i < vecs; i += blockDim.x)
    __pipeline_memcpy_async(dst + head + 4 * i, rows + head + 4 * i, 16);
  for (int i = threadIdx.x; i < head + total - tail; i += blockDim.x) {
    const int e = i < head ? i : tail + i - head;
    __pipeline_memcpy_async(dst + e, rows + e, 4);
  }
  __pipeline_commit();
  return off;
}

// Share H's pairs: [lo, hi) of the upper triangle in row order.
template <int N, int H>
struct AShare {
  static constexpr int lo = H * ACfg<N>::NP / ACfg<N>::SH;
  static constexpr int hi = (H + 1) * ACfg<N>::NP / ACfg<N>::SH;
};

// f(std::integral_constant<int, h>) for the thread's share h
// (warp-uniform), so that each share's code indexes its sums with
// constants and they stay in registers.
template <int N, int H = 0, typename F>
__device__ __forceinline__ void with_share(int h, F&& f) {
  if constexpr (H + 1 < ACfg<N>::SH) {
    if (h != H) {
      with_share<N, H + 1>(h, f);
      return;
    }
  }
  f(std::integral_constant<int, H>{});
}

// Frames [f0, f1) of the tile added to share H's pairs at bin slot s:
// Rs += m X X^H, Rn += max(1 - m, 0) X X^H, frame by frame.  spec: the
// tile's transform slots (frame f's at f P), ms: its mask rows, nyq: its
// bin-256 rows (kNyq a frame).  Slot 0 is bin 0, whose spectra are real;
// its thread then adds bin 256's products (also real) to the imaginary
// parts, which bin 0 leaves at zero.
template <int N, int H>
__device__ __forceinline__ void a_accumulate(
    const float4* spec, const float* ms, const float* nyq, int s, int f0,
    int f1, cpx (&acc_s)[ACfg<N>::PPS], cpx (&acc_n)[ACfg<N>::PPS]) {
  constexpr int lo = AShare<N, H>::lo, hi = AShare<N, H>::hi;
  for (int f = f0; f < f1; ++f) {
    const float2* sf =
        reinterpret_cast<const float2*>(spec + f * ACfg<N>::P * kSlot4) + s;
    cpx X[N];
#pragma unroll
    for (int a = 0; a < N; ++a) {
      const float2 v = sf[(a >> 1) * 2 * kSlot4 + (a & 1) * 256];
      X[a] = {v.x, v.y};
    }
    const float m = ms[f * kBins + s], mn = fmaxf(1.0f - m, 0.0f);
    int idx = 0;
#pragma unroll
    for (int a = 0; a < N; ++a) {
#pragma unroll
      for (int c = a; c < N; ++c, ++idx) {
        if (idx < lo || idx >= hi) continue;
        const int i = idx - lo;
        // X_a conj(X_c)
        const float pr = X[a].re * X[c].re + X[a].im * X[c].im;
        acc_s[i].re += m * pr;
        acc_n[i].re += mn * pr;
        if (c != a) {
          const float pi = X[a].im * X[c].re - X[a].re * X[c].im;
          acc_s[i].im += m * pi;
          acc_n[i].im += mn * pi;
        }
      }
    }
  }
  if (s != 0) return;
  for (int f = f0; f < f1; ++f) {
    const float* x = nyq + f * kNyq;
    const float m = ms[f * kBins + kBins - 1], mn = fmaxf(1.0f - m, 0.0f);
    int idx = 0;
#pragma unroll
    for (int a = 0; a < N; ++a) {
#pragma unroll
      for (int c = a; c < N; ++c, ++idx) {
        if (idx < lo || idx >= hi) continue;
        const float pr = x[a] * x[c];
        acc_s[idx - lo].im += m * pr;
        acc_n[idx - lo].im += mn * pr;
      }
    }
  }
}

// Share H's sums of a segment that ends inside the block, straight to
// its row os of part (B, segments, 257, N (N+1)), then zeroed.
template <int N, int H>
__device__ __forceinline__ void a_write(int s, cpx (&acc_s)[ACfg<N>::PPS],
                                        cpx (&acc_n)[ACfg<N>::PPS],
                                        float2* os) {
  constexpr int NP = ACfg<N>::NP;
  constexpr int lo = AShare<N, H>::lo, hi = AShare<N, H>::hi;
  int idx = 0;
#pragma unroll
  for (int a = 0; a < N; ++a) {
#pragma unroll
    for (int c = a; c < N; ++c, ++idx) {
      if (idx < lo || idx >= hi) continue;
      const int i = idx - lo;
      // slot 0: bin 0 from the real parts, bin 256 from the imaginary
      if (s == 0) {
        os[idx] = make_float2(acc_s[i].re, 0.0f);
        os[NP + idx] = make_float2(acc_n[i].re, 0.0f);
        os[(size_t)(kBins - 1) * 2 * NP + idx] = make_float2(acc_s[i].im,
                                                             0.0f);
        os[(size_t)(kBins - 1) * 2 * NP + NP + idx] =
            make_float2(acc_n[i].im, 0.0f);
      } else {
        os[(size_t)s * 2 * NP + idx] = make_float2(acc_s[i].re, acc_s[i].im);
        os[(size_t)s * 2 * NP + NP + idx] =
            make_float2(acc_n[i].re, acc_n[i].im);
      }
      acc_s[i] = acc_n[i] = {0.0f, 0.0f};
    }
  }
}

// One kind (Rs or Rn) of share H's sums into the block's staging rows,
// bin k's at stage + k ws: each pair at its row-order index or, DIRECT, at
// a N + c with its conjugate at c N + a.
template <int N, int H, bool DIRECT>
__device__ __forceinline__ void a_stage_sums(int s,
                                             const cpx (&acc)[ACfg<N>::PPS],
                                             float2* stage, int ws) {
  constexpr int lo = AShare<N, H>::lo, hi = AShare<N, H>::hi;
  int idx = 0;
#pragma unroll
  for (int a = 0; a < N; ++a) {
#pragma unroll
    for (int c = a; c < N; ++c, ++idx) {
      if (idx < lo || idx >= hi) continue;
      const cpx v = acc[idx - lo];
      // slot 0: bin 0 from the real parts, bin 256 from the imaginary
      for (int r = 0; r < (s == 0 ? 2 : 1); ++r) {
        float2* row = stage + (r ? kBins - 1 : s) * ws;
        const float2 e = s != 0 ? make_float2(v.re, v.im)
                                : make_float2(r ? v.im : v.re, 0.0f);
        if (DIRECT) {
          row[a * N + c] = e;
          if (c != a) row[c * N + a] = make_float2(e.x, -e.y);
        } else {
          row[idx] = e;
        }
      }
    }
  }
}

// One kind of the block's last segment out through shared memory: staged
// by bin, then copied in order, neighbouring threads on neighbouring
// entries.  dst: the kind's first entry of bin 0; a bin's W entries there,
// rows ROW apart.
template <int N, bool DIRECT>
__device__ __forceinline__ void a_write_kind(int h, int s,
                                             const cpx (&acc)[ACfg<N>::PPS],
                                             float2* stage, float2* dst) {
  constexpr int W = DIRECT ? N * N : ACfg<N>::NP;
  constexpr int WS = W | 1;  // odd: a warp's rows in distinct banks
  constexpr int ROW = DIRECT ? N * N : 2 * ACfg<N>::NP;
  static_assert((size_t)kBins * WS * 8 <= (size_t)ACfg<N>::W * kSlot4 * 16,
                "the staging rows fit in the transform slots");
  __syncthreads();  // the slots are free
  with_share<N>(h, [&](auto H) {
    a_stage_sums<N, decltype(H)::value, DIRECT>(s, acc, stage, WS);
  });
  __syncthreads();
  for (int e = threadIdx.x; e < kBins * W; e += blockDim.x) {
    const int k = e / W, j = e - k * W;
    dst[(size_t)k * ROW + j] = stage[k * WS + j];
  }
}

// Kernel A.  Block (x, b) sums segments [x spb, min(n_segs, (x + 1) spb))
// of `seg` frames each of utterance b (frames [c seg, min(T, (c + 1) seg))
// for segment c) and writes each segment's pair sums: part (B, n_segs,
// 257, N (N+1)) at out_s (Rs pairs, then Rn pairs, upper triangle in row
// order) or, direct (one segment an utterance), the full Rs, Rn (B, 257,
// N, N) at out_s, out_n.  Each thread owns the pairs of share h = warp / 8
// at bin slot s; the sums of a segment are frames in order, so the result
// does not depend on the launch.
template <int N, typename T>
__global__ void __launch_bounds__(ACfg<N>::THREADS, ACfg<N>::MIN_BLOCKS)
stft_covar_kernel(const T* __restrict__ wav, const float* __restrict__ mask,
                  const float* __restrict__ window, float2* __restrict__ out_s,
                  float2* __restrict__ out_n, int S, int n_frames, int seg,
                  int spb, int n_segs, int aligned, int direct) {
  using C = ACfg<N>;
  using L = ALayout<N, T>;
  extern __shared__ float4 a_smem[];
  char* sm = reinterpret_cast<char*>(a_smem);
  float4* spec = reinterpret_cast<float4*>(sm + L::spec);
  float4* tw2 = reinterpret_cast<float4*>(sm + L::tw2);
  float2* tw1 = reinterpret_cast<float2*>(sm + L::tw1);
  float* win = reinterpret_cast<float*>(sm + L::win);
  float* ms = reinterpret_cast<float*>(sm + L::mask);
  float* nyq = reinterpret_cast<float*>(sm + L::nyq);
  T* ring = reinterpret_cast<T*>(sm + L::ring);
  A_PHASE_START;
  const int b = blockIdx.y;
  const int c_lo = blockIdx.x * spb, c_hi = min(n_segs, c_lo + spb);
  const int t_begin = min(n_frames, c_lo * seg);
  const int t_end = min(n_frames, c_hi * seg);
  const int warp = threadIdx.x >> 5;
  const int h = warp >> 3;
  // slot 0 of each share in a warp of its own scheduler (h << 5)
  const int s = (threadIdx.x & 255) ^ (h << 5);
  const int f_job = warp / C::P, p_job = warp - f_job * C::P;
  const bool two = 2 * p_job + 1 < N;
  const T* x = wav + (size_t)b * N * S;
  const float* mrows = mask + (size_t)b * n_frames * kBins;
  float2* os = direct ? out_s + (size_t)b * kBins * N * N
                      : out_s + (size_t)b * n_segs * kBins * 2 * C::NP;
  float2* on = direct ? out_n + (size_t)b * kBins * N * N : nullptr;
  const size_t seg_stride = direct ? 0 : (size_t)kBins * 2 * C::NP;

  cpx acc_s[C::PPS], acc_n[C::PPS];
#pragma unroll
  for (int i = 0; i < C::PPS; ++i) acc_s[i] = acc_n[i] = {0.0f, 0.0f};
  a_twiddles(tw2, tw1);
  // 0.5: the two-mic split's halves folded into the window
  for (int i = threadIdx.x; i < kNfft; i += blockDim.x)
    win[i] = 0.5f * window[i];
  if (t_begin < t_end)
    a_stage<N, T>(ring, x, S, t_begin - 1, min(t_end, t_begin + C::TF) - 1,
                  aligned);
  A_PHASE(0);
  __pipeline_wait_prior(0);
  __syncthreads();
  A_PHASE(2);
  int cur = c_lo;  // the segment being summed
  for (int t0 = t_begin; t0 < t_end; t0 += C::TF) {
    const int nv = min(C::TF, t_end - t0);
    const float* mt = ms + a_stage_mask(ms, mrows + (size_t)t0 * kBins, nv);
    A_PHASE(0);
    {
      // frame t0 + f_job (past the range in a short last tile: transformed
      // from stale samples and never read)
      const int t = t0 + f_job;
      const T* h0 = ring + ((size_t)(t % L::R) * N + 2 * p_job) * kHop;
      const T* h1 = ring + ((size_t)((t + 1) % L::R) * N + 2 * p_job) * kHop;
      a_transform<T>(spec + warp * kSlot4, nyq + f_job * kNyq + 2 * p_job,
                     h0, h1, two, reinterpret_cast<const float2*>(win), tw1,
                     tw2);
    }
    A_PHASE(1);
    __pipeline_wait_prior(0);
    __syncthreads();  // spectra whole, mask landed, ring read
    A_PHASE(2);
    if (t0 + C::TF < t_end)
      a_stage<N, T>(ring, x, S, t0 + C::TF,
                    min(t_end, t0 + 2 * C::TF) - 1, aligned);
    A_PHASE(0);
    // the tile's frames in runs that end where a segment ends
    for (int f = 0; f < nv;) {
      const int end = min(nv, (cur + 1) * seg - t0);
      with_share<N>(h, [&](auto H) {
        a_accumulate<N, decltype(H)::value>(spec, mt, nyq, s, f, end, acc_s,
                                            acc_n);
      });
      f = end;
      if (t0 + f == (cur + 1) * seg && t0 + f < t_end) {  // cur complete
        A_PHASE(3);
        with_share<N>(h, [&](auto H) {
          a_write<N, decltype(H)::value>(s, acc_s, acc_n,
                                         os + cur * seg_stride);
        });
        ++cur;
        A_PHASE(4);
      }
    }
    A_PHASE(3);
    __pipeline_wait_prior(0);
    __syncthreads();  // spectra and mask consumed, next samples landed
    A_PHASE(2);
  }
  // the block's last segment (zeros for a run past the utterance's end)
  float2* stage = reinterpret_cast<float2*>(spec);
  if (direct) {
    a_write_kind<N, true>(h, s, acc_s, stage, os);
    a_write_kind<N, true>(h, s, acc_n, stage, on);
  } else {
    a_write_kind<N, false>(h, s, acc_s, stage, os + cur * seg_stride);
    a_write_kind<N, false>(h, s, acc_n, stage,
                           os + cur * seg_stride + C::NP);
  }
  A_PHASE(4);
  A_PHASE_END;
}

// Test entry's kernel: a_transform on windowed frames, one warp a pair of
// rows; spec (count, 2, 257) complex64.
template <typename T>
__global__ void stft_covar_transform_kernel(const T* __restrict__ frames,
                                            float2* __restrict__ spec) {
  __shared__ float4 slot[kSlot4];
  __shared__ float4 tw2[256];
  __shared__ float2 tw1[64];
  __shared__ float win[kNfft];
  __shared__ T rows[2 * kNfft];  // hop blocks 0, 1 of rows a, b
  __shared__ float nyq[2];
  const T* fr = frames + (size_t)blockIdx.x * 2 * kNfft;
  for (int i = threadIdx.x; i < 2 * kNfft; i += blockDim.x) {
    const int r = i >> 9, n = i & (kNfft - 1);
    rows[(n >> 8) * 2 * kHop + r * kHop + (n & (kHop - 1))] = fr[i];
  }
  a_twiddles(tw2, tw1);
  for (int i = threadIdx.x; i < kNfft; i += blockDim.x) win[i] = 0.5f;
  __syncthreads();
  a_transform<T>(slot, nyq, rows, rows + 2 * kHop, true,
                     reinterpret_cast<const float2*>(win), tw1, tw2);
  __syncwarp();
  const float2* p = reinterpret_cast<const float2*>(slot);
  float2* out = spec + (size_t)blockIdx.x * 2 * kBins;
  for (int i = threadIdx.x; i < 2 * kBins; i += blockDim.x) {
    const int r = i / kBins, k = i - r * kBins;
    out[i] = k == kBins - 1 ? make_float2(nyq[r], 0.0f) : p[r * 256 + k];
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

template <typename K>
int a_opt_in(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Kernel A's blocks an SM and the current device's SMs.
template <int N, typename T>
int a_occupancy(int* per_sm, int* sms) {
  int err = a_opt_in(stft_covar_kernel<N, T>, ALayout<N, T>::bytes);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, stft_covar_kernel<N, T>, ACfg<N>::THREADS,
      ALayout<N, T>::bytes);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

template <int N, typename T>
int a_launch(const T* x, const float* mask, const float* window,
             float2* out_s, float2* out_n, int B, int S, int seg, int spb,
             int n_segs, int direct, cudaStream_t st) {
  using L = ALayout<N, T>;
  const int err = a_opt_in(stft_covar_kernel<N, T>, L::bytes);
  if (err != cudaSuccess) return err;
  const int aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const dim3 grid((n_segs + spb - 1) / spb, B);
  stft_covar_kernel<N, T><<<grid, ACfg<N>::THREADS, L::bytes, st>>>(
      x, mask, window, out_s, out_n, S, S / kHop + 1, seg, spb, n_segs,
      aligned, direct);
  return cudaGetLastError();
}

// Offline: K runs of ceil(T / K) frames, a block each.  One run writes Rs,
// Rn itself; more are added by covar_reduce_kernel in run order.
template <typename T>
int launch_a(const void* wav, const float* mask, const float* window,
             float2* part, float2* rs, float2* rn, int B, int N, int S,
             int K, cudaStream_t st) {
  const int nf = S / kHop + 1;
  const int per = (nf + K - 1) / K;
  const T* x = static_cast<const T*>(wav);
  const int direct = K == 1;
  const int rblocks = (B * kBins + 127) / 128;
  int err = cudaSuccess;
  switch (N) {
#define CASE(n)                                                             \
  case n:                                                                   \
    err = a_launch<n, T>(x, mask, window, direct ? rs : part,               \
                         direct ? rn : nullptr, B, S, per, 1, K, direct,    \
                         st);                                               \
    if (err == cudaSuccess && !direct)                                      \
      covar_reduce_kernel<n><<<rblocks, 128, 0, st>>>(part, rs, rn, B, K);  \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Chunks a block of the per-chunk entry: up to 32 frames a block, fewer
// when the batch's chunks would not fill every SM's blocks.
int a_chunks_a_block(int B, int n_chunks, int chunk, int slots) {
  const int cap = max(1, 32 / chunk);
  const long long want = ((long long)B * n_chunks + slots - 1) / slots;
  return (int)max(1LL, min((long long)cap, want));
}

// Kernel A alone, per chunk of frames: part holds the per-chunk
// numerators, nothing is reduced.
template <typename T>
int launch_a_chunks(const void* wav, const float* mask, const float* window,
                    float2* part, int B, int N, int S, int chunk,
                    cudaStream_t st) {
  const int nf = S / kHop + 1;
  const int n_chunks = (nf + chunk - 1) / chunk;
  const T* x = static_cast<const T*>(wav);
  int per_sm = 0, sms = 0, err = cudaSuccess;
  switch (N) {
#define CASE(n)                                                              \
  case n:                                                                    \
    err = a_occupancy<n, T>(&per_sm, &sms);                                  \
    if (err == cudaSuccess)                                                  \
      err = a_launch<n, T>(                                                  \
          x, mask, window, part, nullptr, B, S, chunk,                       \
          a_chunks_a_block(B, n_chunks, chunk, max(1, per_sm * sms)),        \
          n_chunks, 0, st);                                                  \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
  return err;
}

// Kernel A's shape for N mics: blocks an SM, threads a block, frames a
// tile, shared memory bytes, the device's SMs.
template <typename T>
int a_layout(int N, int* out) {
  int per_sm = 0, sms = 0, err = cudaErrorInvalidValue;
  switch (N) {
#define CASE(n)                                  \
  case n:                                        \
    err = a_occupancy<n, T>(&per_sm, &sms);      \
    out[1] = ACfg<n>::THREADS;                   \
    out[2] = ACfg<n>::TF;                        \
    out[3] = (int)ALayout<n, T>::bytes;          \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
  out[0] = per_sm;
  out[4] = sms;
  return err;
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
// (1 <= K <= S/256+1; not read at K = 1); rs, rn (B, 257, N, N) complex64
// numerators.
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

// Kernel A's shape for N mics and the input type: out[0] blocks an SM,
// out[1] threads a block, out[2] frames a tile, out[3] shared memory
// bytes, out[4] the current device's SMs.
extern "C" int stft_covar_layout(int N, int is_int16, int* out) {
  return is_int16 ? a_layout<int16_t>(N, out) : a_layout<float>(N, out);
}

// Tests: kernel A's transform alone.  frames (count, 2, 512) f32, already
// windowed; spec (count, 2, 257) complex64, the real DFT of each row.
extern "C" int stft_covar_transform_launch(const void* frames, void* spec,
                                           int count, void* stream) {
  if (count < 1) return cudaErrorInvalidValue;
  stft_covar_transform_kernel<float><<<count, 32, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<float2*>(spec));
  return cudaGetLastError();
}

#ifdef SETK_FUSED_PHASES
// the phase counters of the instrumented build: read (5 values) and zero
extern "C" int fused_phase_read(unsigned long long* out) {
  int err = cudaMemcpyFromSymbol(out, g_fused_phase, 5 * 8);
  if (err != cudaSuccess) return err;
  const unsigned long long zero[5] = {};
  return cudaMemcpyToSymbol(g_fused_phase, zero, 5 * 8);
}
#endif

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
