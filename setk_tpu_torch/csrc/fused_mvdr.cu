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
//   the operations ~20x, to about the byte bound (kernel B: 5.0 GFLOP,
//   ~75 us, so its bytes bound it).  Twiddles come from float64 sincospi
//   tables, so the transforms stay f32-grade.  No atomics: every sum over
//   frames runs in frame order in one thread, runs of frames are added in
//   a fixed order, and an overlap-add is one addition of two halves.
//
// Both kernels transform on a warp alone: 512 = 8 x 8 x 8, two 8-point
// DFTs a lane a pass in registers, two transposes through the warp's slot
// of shared memory under __syncwarp, no block barrier inside a transform
// (a_passes).
//
// Kernel A (stft_covar_kernel):
//   - a warp transforms one (frame, mic pair); a lane keeps bins k and
//     their mirrors 512 - k, so it splits the two mics in registers;
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
//
// Kernel B (beamform_istft_kernel, and _online_ with a weight row per
// chunk): a block of W = 4 warps makes one run of output hop blocks
// [j0, j1) of an utterance from frames j0..j1 (the one frame it shares
// with the next run is computed by both; the launcher picks the runs an
// utterance from the kernel's occupancy), in tiles of 2 W frames:
//   - warp w takes the pair of frames (a, b) = (t0 + 2 w, t0 + 2 w + 1)
//     through all its P = ceil(N / 2) mic pairs, one a_passes transform
//     each, and beamforms in registers as each transform ends: lane l
//     holds the 8 bins l + 64 m and 64 - l + 64 m (m < 4; lane 0 also bin
//     256) of both mics, so it adds conj(w) X for its bins into 8 complex
//     sums a frame; offline weights sit in shared memory (one row an
//     utterance, a float4 a mic pair and bin), online ones are read from
//     the frame's own chunk row (L1 / L2), so any chunk >= 1 works;
//   - those sums are the first inverse pass's points: Z = E_a + i E_b and
//     its Hermitian mirror, columns l and 64 - l of stride 64, so the
//     inverse (b_inverse: 8 x 8 x 8 with conjugate twiddles, two
//     transposes through the slot) starts without an exchange and leaves
//     lane l samples l + 64 n and l + 32 + 64 n of frame a (real part) and
//     b (imaginary part): it writes output block a = Q[a] + P[b] itself,
//     in 128-byte rows, and hands P[a] to warp w - 1 through shared memory
//     (block b = Q[b] + P[b + 1] is warp w's, once warp w + 1 has
//     published; the last warp's waits for the next tile);
//   - two block barriers a tile: after the forward transforms (the ring
//     is free: the next tile's hop blocks go out by cp.async and land
//     during the inverse) and after the publish;
//   - shared memory: W warp slots of 576 float2 (4.5 KB), the forward and
//     inverse twiddles, the analysis and synthesis windows, the published
//     halves (1 KB a warp), the offline weights (P x 257 float4) and the
//     ring of 2 W + 1 hop blocks: 75 KB at N = 6 int16, 3 blocks an SM.

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
//     chunk: each frame reads its own chunk's row.
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

struct cpx {
  float re, im;
};

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
// kernel B's: 0 staging (the tables, the weights and the sample copies
// issued), 1 forward transform, 2 beamform, 3 inverse transform, 4
// overlap-add and write, 5 tile barriers (waiting for the copies and the
// block)
__device__ unsigned long long g_fused_b_phase[6];
#define B_PHASE(i)                      \
  do {                                  \
    const long long now_ = clock64();   \
    bph_[i] += now_ - bt_;              \
    bt_ = now_;                         \
  } while (0)
#define B_PHASE_START \
  long long bt_ = clock64(), bph_[6] = {0, 0, 0, 0, 0, 0}
#define B_PHASE_END                                                    \
  do {                                                                 \
    if ((threadIdx.x & 31) == 0)                                       \
      for (int i_ = 0; i_ < 6; ++i_)                                   \
        atomicAdd(&g_fused_b_phase[i_], (unsigned long long)bph_[i_]); \
  } while (0)
#else
#define A_PHASE(i) \
  do {             \
  } while (0)
#define A_PHASE_START
#define A_PHASE_END
#define B_PHASE(i) \
  do {             \
  } while (0)
#define B_PHASE_START
#define B_PHASE_END
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

__device__ __forceinline__ float2 mul_pi(float2 z) {  // i z
  return make_float2(-z.y, z.x);
}

// Inverse 8-point DFT in registers (dft8 with the conjugate twiddles, no
// 1/8), natural order in and out.
__device__ __forceinline__ void idft8(float2 (&v)[8]) {
  constexpr float r = 0.70710678118654752f;
  const float2 a0 = f2add(v[0], v[4]), a4 = f2sub(v[0], v[4]);
  const float2 a1 = f2add(v[1], v[5]), d5 = f2sub(v[1], v[5]);
  const float2 a2 = f2add(v[2], v[6]), d6 = f2sub(v[2], v[6]);
  const float2 a3 = f2add(v[3], v[7]), d7 = f2sub(v[3], v[7]);
  // d5 conj(W8), d6 conj(W8^2) = i d6, d7 conj(W8^3)
  const float2 a5 = make_float2(r * (d5.x - d5.y), r * (d5.x + d5.y));
  const float2 a6 = mul_pi(d6);
  const float2 a7 = make_float2(-r * (d7.x + d7.y), r * (d7.x - d7.y));
  const float2 b0 = f2add(a0, a2), b2 = f2sub(a0, a2);
  const float2 b1 = f2add(a1, a3), b3 = mul_pi(f2sub(a1, a3));
  const float2 b4 = f2add(a4, a6), b6 = f2sub(a4, a6);
  const float2 b5 = f2add(a5, a7), b7 = mul_pi(f2sub(a5, a7));
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
// ends with z0[k2] = Z[l + 64 k2] and z1[k2] = Z[kb + 64 k2], kb = 64 - l
// (lane 0: 32): bins l + 64 m and their mirrors 512 - l - 64 m.  h0, h1:
// mic a's hop blocks under the frame (mic b 256 samples after each); two:
// mic b exists.  Every lane of the warp must call it; the slot is free
// again when it returns.
template <typename T>
__device__ __forceinline__ void a_passes(float4* slot, const T* h0,
                                         const T* h1, bool two,
                                         const float2* win2,
                                         const float2* tw1,
                                         const float4* tw2, float2 (&z0)[8],
                                         float2 (&z1)[8]) {
  const int l = threadIdx.x & 31;
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
}

// a_passes, then the two mics split in registers (Z[k] +- conj Z[-k]):
// mic a's bins 0..255 to slot plane 0, mic b's to plane 1, and bin 256
// (real, as bin 0 is) to nyq[0], nyq[1].
template <typename T>
__device__ __forceinline__ void a_transform(float4* slot, float* nyq,
                                            const T* h0, const T* h1,
                                            bool two, const float2* win2,
                                            const float2* tw1,
                                            const float4* tw2) {
  const int l = threadIdx.x & 31;
  const bool l0 = l == 0;
  const int kb = l0 ? 32 : 64 - l;
  float2 z0[8], z1[8];
  a_passes<T>(slot, h0, h1, two, win2, tw1, tw2, z0, z1);
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

// Hop blocks q0..q1 of the utterance's N mics into the ring of R blocks,
// block q in slot (q + 1) % R: 16-byte cp.async inside the waveform, sample by
// sample for the reflected blocks -1 and S / 256 (and for every block of a
// waveform that is not 16-byte aligned).
template <int N, typename T, int R = ALayout<N, T>::R>
__device__ __forceinline__ void a_stage(T* ring, const T* __restrict__ x,
                                        int S, int q0, int q1, bool aligned) {
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

// ---- kernel B ----
// A block of W warps makes output hop blocks [j0, j1) of one utterance
// from frames j0..j1, in tiles of TF = 2 W frames, warp w the pair of
// frames (t0 + 2 w, t0 + 2 w + 1) of the tile at t0 (see the file's head).
template <int N>
struct BCfg {
  static constexpr int P = (N + 1) / 2;  // complex transforms a frame
  static constexpr int W = 4;            // warps a block: a pair of frames each
  static constexpr int THREADS = 32 * W;
  static constexpr int TF = 2 * W;       // frames a tile
};

// float2 of a kernel-B warp's slot: a_passes' 264 float4, or the
// inverse's first transpose (8 rows of 72: each half-warp's two rows in
// opposite bank halves) and second (8 rows of 66)
constexpr int kSlotB = 576;

// Byte offsets into kernel B's dynamic shared memory.
template <int N, typename T, bool kOnline>
struct BLayout {
  using C = BCfg<N>;
  static constexpr size_t slots = 0;            // W warp slots
  static constexpr size_t tw2 = slots + (size_t)C::W * kSlotB * 8;
  static constexpr size_t itw2 = tw2 + 256 * 16;  // inverse pass-2 twiddles
  static constexpr size_t tw1 = itw2 + 256 * 16;  // pass-1 twiddles
  static constexpr size_t win = tw1 + 64 * 8;     // 0.5 x the window
  static constexpr size_t syn = win + kNfft * 4;  // synthesis window / 512
  static constexpr size_t xchg = syn + kNfft * 4;  // each warp's P[a]
  static constexpr size_t wts = xchg + (size_t)C::W * kHop * 4;
  // offline weights: float4 (w_2p, w_2p+1) at p 257 + k
  static constexpr size_t ring =
      wts + (kOnline ? 0 : (size_t)C::P * kBins * 16);
  static constexpr int R = C::TF + 1;  // hop blocks under a tile
  static constexpr size_t bytes = ring + (size_t)R * N * kHop * sizeof(T);
  // blocks an SM that its 228 KB admit (1 KB a block reserved), at most
  // 4; the launch bound gives each thread the registers that leave (128
  // or more)
  static constexpr size_t FIT = 233472 / (bytes + 1024);
  static constexpr int MIN_BLOCKS = FIT < 1 ? 1 : FIT > 4 ? 4 : (int)FIT;
};

// Kernel B's inverse twiddles: itw2[n1 32 + l] = (W512^-((n0 + 8 n1) a),
// W512^-((n0 + 4 + 8 n1) a)) for lane l's a = l & 7, n0 = l >> 3, from the
// float64 sincospi.
__device__ __forceinline__ void b_twiddles(float4* itw2) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    const int n1 = i >> 5, l = i & 31, a = l & 7, n0 = l >> 3;
    double s0, c0, s1, c1;
    sincospi((double)(((n0 + 8 * n1) * a) & 511) / 256.0, &s0, &c0);
    sincospi((double)(((n0 + 4 + 8 * n1) * a) & 511) / 256.0, &s1, &c1);
    itw2[i] = make_float4((float)c0, (float)s0, (float)c1, (float)s1);
  }
}

// e + conj(w_a) X_a + conj(w_b) X_b, the two mics split from the pair's
// transform at Z[k], Z[-k]; v = (w_a, w_b).
__device__ __forceinline__ float2 b_mac(float2 e, float2 zk, float2 zm,
                                        float4 v) {
  const float2 xa = make_float2(zk.x + zm.x, zk.y - zm.y);
  const float2 xb = make_float2(zk.y + zm.y, zm.x - zk.x);
  e.x += v.x * xa.x + v.y * xa.y + v.z * xb.x + v.w * xb.y;
  e.y += v.x * xa.y - v.y * xa.x + v.z * xb.y - v.w * xb.x;
  return e;
}

// Mic pair p's weights at bin k as a float4 (w_2p, w_2p+1): offline from
// the block's staged row (p 257 + k), online from the frame's chunk row of
// w (k N + 2 p), w_2p+1 = 0 past the last mic.
template <int N, bool kOnline>
struct BWeights {
  const float4* wts;
  const float2* row;
  int p;
  __device__ __forceinline__ float4 operator()(int k) const {
    if (!kOnline) return wts[p * kBins + k];
    const float2 wa = row[k * N + 2 * p];
    const float2 wb =
        2 * p + 1 < N ? row[k * N + 2 * p + 1] : make_float2(0.0f, 0.0f);
    return make_float4(wa.x, wa.y, wb.x, wb.y);
  }
};

// One mic pair's a_passes output added into the frame's beamformed bins:
// e[m] at bin l + 64 m, e[4 + m] at bin kb + 64 m (m < 4); lane 0 also
// e256, bin 256's real part (bin 0's imaginary part is never read).
template <int N, bool kOnline>
__device__ __forceinline__ void b_beamform(const float2 (&z0)[8],
                                           const float2 (&z1)[8],
                                           const BWeights<N, kOnline>& wk,
                                           float2 (&e)[8], float& e256) {
  const int l = threadIdx.x & 31;
  const bool l0 = l == 0;
  const int kb = l0 ? 32 : 64 - l;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    e[m] = b_mac(e[m], z0[m], l0 ? z0[(8 - m) & 7] : z1[7 - m],
                 wk(l + 64 * m));
    e[4 + m] = b_mac(e[4 + m], z1[m], l0 ? z1[7 - m] : z0[7 - m],
                     wk(kb + 64 * m));
  }
  if (l0) {
    const float4 v = wk(kBins - 1);
    e256 += v.x * (z0[4].x + z0[4].x) + v.z * (z0[4].y + z0[4].y);
  }
}

// Z = E_a + i E_b at the inverse's first-pass points: z0[k2] = Z[l + 64 k2]
// and z1[k2] = Z[kb + 64 k2] (kb = 64 - l, lane 0: 32), from the frames'
// bins as b_beamform holds them; above bin 255, Z[512 - k] = conj(E_a[k])
// + i conj(E_b[k]); bins 0 and 256 take the real parts alone.
__device__ __forceinline__ void b_columns(const float2 (&ea)[8],
                                          const float2 (&eb)[8], float na,
                                          float nb, float2 (&z0)[8],
                                          float2 (&z1)[8]) {
  const bool l0 = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    z0[m] = make_float2(ea[m].x - eb[m].y, ea[m].y + eb[m].x);
    z1[m] = make_float2(ea[4 + m].x - eb[4 + m].y,
                        ea[4 + m].y + eb[4 + m].x);
  }
  if (l0) z0[0] = make_float2(ea[0].x, eb[0].x);
#pragma unroll
  for (int k2 = 4; k2 < 8; ++k2) {
    // the mirror bins: column kb's (m = 7 - k2) for column l, column l's
    // for column kb; lane 0's columns are their own mirrors (values picked,
    // not indices, so that the sums stay in registers)
    const float2 a0 = l0 ? ea[(8 - k2) & 7] : ea[11 - k2];
    const float2 b0 = l0 ? eb[(8 - k2) & 7] : eb[11 - k2];
    const float2 a1 = l0 ? ea[11 - k2] : ea[7 - k2];
    const float2 b1 = l0 ? eb[11 - k2] : eb[7 - k2];
    z0[k2] = make_float2(a0.x + b0.y, b0.x - a0.y);
    z1[k2] = make_float2(a1.x + b1.y, b1.x - a1.y);
  }
  if (l0) z0[4] = make_float2(na, nb);
}

// One warp's inverse 512-point transform of the columns from b_columns,
// no block barrier: k = a + 8 c + 64 k2, n = n0 + 8 n1 + 64 n2, three
// passes of two inverse 8-point DFTs a lane (over k2, then c, then a) with
// the twiddles W64^-(c n0) and W512^-((n0 + 8 n1) a) between them and two
// transposes through the warp's slot under __syncwarp.  Lane l ends with
// z0[n2] = z[l + 64 n2] and z1[n2] = z[l + 32 + 64 n2], unscaled.  Every
// lane of the warp must call it; the slot is free again when it returns.
__device__ __forceinline__ void b_inverse(float2* slot, float2 (&z0)[8],
                                          float2 (&z1)[8],
                                          const float2* tw1,
                                          const float4* itw2) {
  const int l = threadIdx.x & 31;
  const int r1 = l == 0 ? 32 : 64 - l;  // z1's column
  // pass 1 over k2: Y1[a + 8 c, n0] to row n0 (72 float2 a row)
  idft8(z0);
  idft8(z1);
  slot[l] = z0[0];
  slot[r1] = z1[0];
#pragma unroll
  for (int n0 = 1; n0 < 8; ++n0) {
    const float2 w0 = tw1[8 * n0 + (l >> 3)], w1 = tw1[8 * n0 + (r1 >> 3)];
    slot[72 * n0 + l] = f2mul(z0[n0], make_float2(w0.x, -w0.y));
    slot[72 * n0 + r1] = f2mul(z1[n0], make_float2(w1.x, -w1.y));
  }
  __syncwarp();
  // pass 2 over c: lane l takes a = l & 7 and n0 = q, q + 4 (q = l >> 3)
  const int a = l & 7, q = l >> 3;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    z0[c] = slot[72 * q + a + 8 * c];
    z1[c] = slot[72 * (q + 4) + a + 8 * c];
  }
  __syncwarp();
  idft8(z0);
  idft8(z1);
  // Y2[a, n0, n1] to row a (66 float2 a row), column n0 + 8 n1
#pragma unroll
  for (int n1 = 0; n1 < 8; ++n1) {
    const float4 w = itw2[32 * n1 + l];
    slot[66 * a + q + 8 * n1] = f2mul(z0[n1], make_float2(w.x, w.y));
    slot[66 * a + q + 4 + 8 * n1] = f2mul(z1[n1], make_float2(w.z, w.w));
  }
  __syncwarp();
  // pass 3 over a: lane l takes n0 + 8 n1 = l and l + 32
#pragma unroll
  for (int aa = 0; aa < 8; ++aa) {
    z0[aa] = slot[66 * aa + l];
    z1[aa] = slot[66 * aa + l + 32];
  }
  __syncwarp();
  idft8(z0);
  idft8(z1);
}

// The body of kernel B.  Offline (kOnline false) one weight row per
// utterance, w (B, 257, N); online, w (B, n_chunks, 257, N) and frame f
// takes chunk f / chunk's row.  Block (x, b) makes output hop blocks
// [x per, min(S / 256, (x + 1) per)) of utterance b.
template <int N, typename T, bool kOnline>
__device__ __forceinline__ void beamform_istft_body(
    const T* __restrict__ wav, const float2* __restrict__ w,
    const float* __restrict__ wss_inv, const float* __restrict__ window,
    const float* __restrict__ synth, float* __restrict__ out, int S,
    int per, int chunk, int n_chunks, int aligned) {
  using C = BCfg<N>;
  using L = BLayout<N, T, kOnline>;
  extern __shared__ float4 b_smem[];
  char* sm = reinterpret_cast<char*>(b_smem);
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  float2* slot = reinterpret_cast<float2*>(sm + L::slots) + warp * kSlotB;
  float4* tw2 = reinterpret_cast<float4*>(sm + L::tw2);
  float4* itw2 = reinterpret_cast<float4*>(sm + L::itw2);
  float2* tw1 = reinterpret_cast<float2*>(sm + L::tw1);
  float* win = reinterpret_cast<float*>(sm + L::win);
  float* syn = reinterpret_cast<float*>(sm + L::syn);
  float* xchg = reinterpret_cast<float*>(sm + L::xchg);
  float4* wts = reinterpret_cast<float4*>(sm + L::wts);
  T* ring = reinterpret_cast<T*>(sm + L::ring);
  B_PHASE_START;
  const int b = blockIdx.y;
  const int j0 = blockIdx.x * per, j1 = min(S / kHop, j0 + per);
  if (j0 >= j1) return;
  const T* x = wav + (size_t)b * N * S;
  float* ob = out + (size_t)b * S;
  a_twiddles(tw2, tw1);
  b_twiddles(itw2);
  for (int i = threadIdx.x; i < kNfft; i += blockDim.x) {
    win[i] = 0.5f * window[i];  // the two-mic split's halves
    syn[i] = synth[i] * (1.0f / kNfft);
  }
  if (!kOnline) {
    const float2* wr = w + (size_t)b * kBins * N;
    for (int i = threadIdx.x; i < C::P * kBins; i += blockDim.x) {
      const int p = i / kBins, k = i - p * kBins;
      const float2 wa = wr[k * N + 2 * p];
      const float2 wb = 2 * p + 1 < N ? wr[k * N + 2 * p + 1]
                                      : make_float2(0.0f, 0.0f);
      wts[i] = make_float4(wa.x, wa.y, wb.x, wb.y);
    }
  }
  a_stage<N, T, L::R>(ring, x, S, j0 - 1, min(j1, j0 + C::TF - 1),
                      aligned);
  B_PHASE(0);
  __pipeline_wait_prior(0);
  __syncthreads();
  B_PHASE(5);
  const float2* win2 = reinterpret_cast<const float2*>(win);
  float pend[8];  // the last warp's Q[b], until the next tile's P[b + 1]
#pragma unroll
  for (int i = 0; i < 8; ++i) pend[i] = 0.0f;
  for (int t0 = j0; t0 <= j1; t0 += C::TF) {
    // frames fa, fb (past j1 in a short last tile: transformed from stale
    // samples and never written)
    const int fa = t0 + 2 * warp, fb = fa + 1;
    float2 ea[8], eb[8];
    float na = 0.0f, nb = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) ea[i] = eb[i] = make_float2(0.0f, 0.0f);
#pragma unroll 1
    for (int i = 0; i < 2 * C::P; ++i) {
      const int f = i < C::P ? fa : fb, p = i < C::P ? i : i - C::P;
      const bool two = 2 * p + 1 < N;
      float2 z0[8], z1[8];
      a_passes<T>(reinterpret_cast<float4*>(slot),
                  ring + ((size_t)(f % L::R) * N + 2 * p) * kHop,
                  ring + ((size_t)((f + 1) % L::R) * N + 2 * p) * kHop, two,
                  win2, tw1, tw2, z0, z1);
      B_PHASE(1);
      const BWeights<N, kOnline> wk{
          wts,
          w + ((size_t)b * n_chunks + min(f / chunk, n_chunks - 1)) *
                  kBins * N,
          p};
      if (i < C::P) {
        b_beamform(z0, z1, wk, ea, na);
      } else {
        b_beamform(z0, z1, wk, eb, nb);
      }
      B_PHASE(2);
    }
    if (fb > j1) {  // frame b lies past the run: its sums may be garbage
#pragma unroll
      for (int i = 0; i < 8; ++i) eb[i] = make_float2(0.0f, 0.0f);
      nb = 0.0f;
    }
    __syncthreads();  // the ring's samples consumed
    B_PHASE(5);
    if (t0 + C::TF <= j1)
      a_stage<N, T, L::R>(ring, x, S, t0 + C::TF,
                          min(j1, t0 + 2 * C::TF - 1), aligned);
    B_PHASE(0);
    float2 z0[8], z1[8];
    b_columns(ea, eb, na, nb, z0, z1);
    b_inverse(slot, z0, z1, tw1, itw2);
    B_PHASE(3);
    // sample n = m + 64 n2 (m = l, l + 32) of frame fa (real parts) and fb
    // (imaginary): block fa = Q[fa] + P[fb] here, P[fa] published, Q[fb]
    // kept for block fb
    float q[8];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        const int o = l + 32 * k + 64 * n2;
        const float2 u = k ? z1[n2] : z0[n2];
        const float2 v = k ? z1[n2 + 4] : z0[n2 + 4];
        const float sp = syn[o], sq = syn[o + kHop];
        xchg[warp * kHop + o] = u.x * sp;
        q[4 * k + n2] = v.y * sq;
        if (fa < j1)
          ob[(size_t)fa * kHop + o] =
              (v.x * sq + u.y * sp) * wss_inv[(size_t)fa * kHop + o];
      }
    }
    B_PHASE(4);
    __pipeline_wait_prior(0);
    __syncthreads();  // P halves published, the next tile's samples landed
    B_PHASE(5);
    // block fb = Q[fb] + P[fb + 1] (warp w + 1's P); the last warp's block
    // t0 - 1 = Q[t0 - 1] (the previous tile's) + P[t0] (warp 0's)
    const bool last = warp == C::W - 1;
    const int j = last ? t0 - 1 : fb;
    const float* pn = xchg + (last ? 0 : (warp + 1) * kHop);
    if (j < j1 && j >= j0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int o = l + 32 * (i >> 2) + 64 * (i & 3);
        ob[(size_t)j * kHop + o] =
            ((last ? pend[i] : q[i]) + pn[o]) * wss_inv[(size_t)j * kHop + o];
      }
    }
    if (last) {
#pragma unroll
      for (int i = 0; i < 8; ++i) pend[i] = q[i];
    }
    B_PHASE(4);
  }
  B_PHASE_END;
}

template <int N, typename T>
__global__ void __launch_bounds__(BCfg<N>::THREADS,
                                  BLayout<N, T, false>::MIN_BLOCKS)
beamform_istft_kernel(const T* __restrict__ wav, const float2* __restrict__ w,
                      const float* __restrict__ wss_inv,
                      const float* __restrict__ window,
                      const float* __restrict__ synth, float* __restrict__ out,
                      int S, int per, int chunk, int n_chunks, int aligned) {
  beamform_istft_body<N, T, false>(wav, w, wss_inv, window, synth, out, S,
                                   per, chunk, n_chunks, aligned);
}

template <int N, typename T>
__global__ void __launch_bounds__(BCfg<N>::THREADS,
                                  BLayout<N, T, true>::MIN_BLOCKS)
beamform_istft_online_kernel(const T* __restrict__ wav,
                             const float2* __restrict__ w,
                             const float* __restrict__ wss_inv,
                             const float* __restrict__ window,
                             const float* __restrict__ synth,
                             float* __restrict__ out, int S, int per,
                             int chunk, int n_chunks, int aligned) {
  beamform_istft_body<N, T, true>(wav, w, wss_inv, window, synth, out, S,
                                  per, chunk, n_chunks, aligned);
}

// Test entry's kernel: b_columns and b_inverse on pairs of real spectra,
// one warp a pair; spec (count, 2, 257) complex64 (the imaginary parts at
// bins 0 and 256 ignored) -> frames (count, 2, 512) f32, the inverse real
// DFTs with the 1/512.
template <typename T>
__global__ void beamform_istft_inverse_kernel(const float2* __restrict__ spec,
                                              T* __restrict__ frames) {
  __shared__ float2 slot[kSlotB];
  __shared__ float4 tw2[256];
  __shared__ float4 itw2[256];
  __shared__ float2 tw1[64];
  a_twiddles(tw2, tw1);
  b_twiddles(itw2);
  __syncthreads();
  const int l = threadIdx.x & 31;
  const int kb = l == 0 ? 32 : 64 - l;
  const float2* sa = spec + (size_t)blockIdx.x * 2 * kBins;
  const float2* sb = sa + kBins;
  float2 ea[8], eb[8];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    ea[m] = sa[l + 64 * m];
    eb[m] = sb[l + 64 * m];
    ea[4 + m] = sa[kb + 64 * m];
    eb[4 + m] = sb[kb + 64 * m];
  }
  float2 z0[8], z1[8];
  b_columns(ea, eb, sa[kBins - 1].x, sb[kBins - 1].x, z0, z1);
  b_inverse(slot, z0, z1, tw1, itw2);
  T* fa = frames + (size_t)blockIdx.x * 2 * kNfft;
#pragma unroll
  for (int n2 = 0; n2 < 8; ++n2) {
    fa[l + 64 * n2] = z0[n2].x * (1.0f / kNfft);
    fa[l + 32 + 64 * n2] = z1[n2].x * (1.0f / kNfft);
    fa[kNfft + l + 64 * n2] = z0[n2].y * (1.0f / kNfft);
    fa[kNfft + l + 32 + 64 * n2] = z1[n2].y * (1.0f / kNfft);
  }
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

// Kernel B's blocks an SM and the current device's SMs.
template <int N, typename T, bool kOnline>
int b_occupancy(int* per_sm, int* sms) {
  using L = BLayout<N, T, kOnline>;
  int err;
  if constexpr (kOnline) {
    err = a_opt_in(beamform_istft_online_kernel<N, T>, L::bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          per_sm, beamform_istft_online_kernel<N, T>, BCfg<N>::THREADS,
          L::bytes);
  } else {
    err = a_opt_in(beamform_istft_kernel<N, T>, L::bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          per_sm, beamform_istft_kernel<N, T>, BCfg<N>::THREADS, L::bytes);
  }
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Runs of output hop blocks an utterance, a block each: the fewest that
// fill the card's slots (blocks an SM x SMs) as well as any count does,
// each run at least one tile of frames (fused_mvdr.frame_runs' rule).
int b_runs(int B, int nblk, int slots, int tile) {
  const long long most = max(
      1LL, min((2LL * slots + B - 1) / B, (long long)(nblk / tile)));
  long long best = 1, best_blocks = B;
  long long best_cap = (best_blocks + slots - 1) / slots * slots;
  for (long long k = 2; k <= most; ++k) {
    const long long blocks = B * k, cap = (blocks + slots - 1) / slots * slots;
    if (blocks * best_cap > best_blocks * cap) {  // a better filled card
      best = k;
      best_blocks = blocks;
      best_cap = cap;
    }
  }
  return (int)best;
}

template <int N, typename T, bool kOnline>
int b_launch(const T* x, const float2* w, const float* wss_inv,
             const float* window, const float* synth, float* out, int B,
             int S, int chunk, int n_chunks, cudaStream_t st) {
  using L = BLayout<N, T, kOnline>;
  int per_sm = 0, sms = 0;
  const int err = b_occupancy<N, T, kOnline>(&per_sm, &sms);
  if (err != cudaSuccess) return err;
  const int nblk = S / kHop;
  const int runs = b_runs(B, nblk, max(1, per_sm * sms), BCfg<N>::TF);
  const int per = (nblk + runs - 1) / runs;
  const dim3 grid((nblk + per - 1) / per, B);
  const int aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if constexpr (kOnline)
    beamform_istft_online_kernel<N, T><<<grid, BCfg<N>::THREADS, L::bytes,
                                         st>>>(x, w, wss_inv, window, synth,
                                               out, S, per, chunk, n_chunks,
                                               aligned);
  else
    beamform_istft_kernel<N, T><<<grid, BCfg<N>::THREADS, L::bytes, st>>>(
        x, w, wss_inv, window, synth, out, S, per, 1, 1, aligned);
  return cudaGetLastError();
}

// chunk <= 0: offline kernel B; else the online kernel with one weight row
// per chunk of frames.
template <typename T>
int launch_b(const void* wav, const float2* w, const float* wss_inv,
             const float* window, const float* synth, float* out, int B, int N,
             int S, int chunk, cudaStream_t st) {
  const int n_chunks = chunk > 0 ? (S / kHop + chunk) / chunk : 1;
  const T* x = static_cast<const T*>(wav);
  switch (N) {
#define CASE(n)                                                           \
  case n:                                                                 \
    return chunk > 0 ? b_launch<n, T, true>(x, w, wss_inv, window, synth, \
                                            out, B, S, chunk, n_chunks,   \
                                            st)                           \
                     : b_launch<n, T, false>(x, w, wss_inv, window,       \
                                             synth, out, B, S, 1, 1, st);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

// Kernel B's shape for N mics, the input type and the entry: blocks an
// SM, threads a block, frames a tile, shared memory bytes, the device's
// SMs and the runs an utterance at batch B and S samples.
template <typename T>
int b_layout(int N, int online, int B, int S, int* out) {
  int per_sm = 0, sms = 0, err = cudaErrorInvalidValue;
  switch (N) {
#define CASE(n)                                                    \
  case n:                                                          \
    err = online ? b_occupancy<n, T, true>(&per_sm, &sms)          \
                 : b_occupancy<n, T, false>(&per_sm, &sms);        \
    out[1] = BCfg<n>::THREADS;                                     \
    out[2] = BCfg<n>::TF;                                          \
    out[3] = (int)(online ? BLayout<n, T, true>::bytes             \
                          : BLayout<n, T, false>::bytes);          \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
  out[0] = per_sm;
  out[4] = sms;
  out[5] = b_runs(B, S / kHop, max(1, per_sm * sms), out[2]);
  return err;
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

// Kernel B's shape for N mics, the input type and the entry (online: the
// per-chunk one): out[0] blocks an SM, out[1] threads a block, out[2]
// frames a tile, out[3] shared memory bytes, out[4] the current device's
// SMs, out[5] the runs of output blocks an utterance the launch takes at
// batch B and S samples.
extern "C" int beamform_istft_layout(int N, int is_int16, int online, int B,
                                     int S, int* out) {
  if (B < 1 || S < kNfft) return cudaErrorInvalidValue;
  return is_int16 ? b_layout<int16_t>(N, online, B, S, out)
                  : b_layout<float>(N, online, B, S, out);
}

// Tests: kernel B's inverse transform alone.  spec (count, 2, 257)
// complex64 pairs of real spectra; frames (count, 2, 512) f32, the
// inverse real DFT of each (with the 1/512).
extern "C" int beamform_istft_inverse_launch(const void* spec, void* frames,
                                             int count, void* stream) {
  if (count < 1) return cudaErrorInvalidValue;
  beamform_istft_inverse_kernel<float><<<count, 32, 0,
                                         static_cast<cudaStream_t>(
                                             stream)>>>(
      static_cast<const float2*>(spec), static_cast<float*>(frames));
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

// kernel B's (6 values)
extern "C" int fused_b_phase_read(unsigned long long* out) {
  int err = cudaMemcpyFromSymbol(out, g_fused_b_phase, 6 * 8);
  if (err != cudaSuccess) return err;
  const unsigned long long zero[6] = {};
  return cudaMemcpyToSymbol(g_fused_b_phase, zero, 6 * 8);
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
