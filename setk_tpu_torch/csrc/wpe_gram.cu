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
//   * gram = sum_t (sw_t A[:, t]) (sw_t A[:, t])^H, sw = 1 / sqrt(max(
//     lambda, EPS)), each (i <= j) entry summed once, written at (i, j)
//     and conjugated at (j, i) with a real diagonal: exactly Hermitian, as
//     the TPU's is.  The sum is two-level: over a tile's 64 frames in
//     registers, then over the tiles in registers, so its rounding grows
//     with 64 + T / 64 terms, not T.  A reverberant scene's tap
//     correlation reaches a condition number of ~2e6, and the Gram's
//     rounding, not the solve's, sets how far the f32 loop lies from a
//     float64 run (tools/wpe_precision.py).
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
// 24 MB of G and 287 MB of Gram (~0.15 ms at 3.35 TB/s): operations.
// Kernel 19 does the dereverberation's 360 complex multiply-adds a frame
// alone (11.9 GFLOP, ~0.18 ms) against 198 MB of spectra in, 198 MB out
// and 24 MB of G (~0.13 ms): operations, with the bytes close behind.
//
// Kernel 18's design.  A block owns a bin and walks T in tiles of 64
// frames; each thread owns a 4 x 4 block of the Gram's upper block
// triangle, and the block has as many threads as there are such blocks,
// rounded up to a warp (160 threads for the 153 blocks at cols = 66;
// above 256 blocks, at cols = 136, passes of up to 256 threads).  A tile
// runs in four steps, each spread over the whole block:
//   1. the raw frames (with the halo the taps and the context need) are
//      already in shared memory: cp.async copied them while the previous
//      tile's products ran;
//   2. d = y - G^H taps for the tile's frames and their 2 C neighbours,
//      a thread a (frame, half of the taps) pair with all N mics' sums in
//      registers (dereverb_power), then lambda and sw, a thread a frame;
//   3. the weighted design tile sw_t A[:, t] (64 frames x 4 ceil(cols / 4)
//      rows, 34.8 KB at the scene) in two planes of float4, rows 4q, 4q + 1
//      and 4q + 2, 4q + 3 of frame t at plane 0 and 1, so that a thread
//      reads its four rows of a frame as two conflict-free 16-byte loads;
//   4. the products: per frame 4 such loads and 64 FFMAs a thread, no
//      weights left to apply; the tile's sums then join the running sums,
//      both in registers.  With one pass the Gram leaves through shared
//      memory in 16-byte stores.
// What bounds it: a 4 x 4 block reads 64 bytes of shared memory for 64
// FFMAs, and an SM serves 128 bytes a cycle against 128 FFMAs a cycle, so
// the products alone fill the shared-memory pipe at the FFMA peak and the
// staging and dereverberation compete with them for it (PERF.md: on an
// H100 ~3.1 ms at the scene, ~2.4x the bound).  Producer warps feeding
// consumer warps through two design tiles were tried and ran slower: two
// producer warps could not keep up, and the products' 127 registers a
// thread left room for two blocks an SM.
//
// Kernel 19's design.  Its work is a list of items, (bin, tile of
// kApplyTile frames), bin-major; a launch has one wave of blocks (the SMs
// times the blocks an SM holds) and each block of 4 warps walks
// a contiguous run of items, across bins.  An item's window (frames t0 -
// delay - taps + 1 ... t0 + tile, zero outside [0, T)) and, at a bin's
// first item, the bin's G (into one of two G buffers, by the bin's
// parity: staged once a bin a block walks) arrive in 16-byte cp.async
// copies through a two-slot ring while the previous item's sums run, so
// that a block meets at one barrier an item.  A copy's source address
// decides its alignment: a window row that starts at an odd complex word
// holds one frame more, and G goes in 8-byte copies where its first word
// is not on 16 bytes.
// Lane l of warp w owns frames t0 + 32 (kApplyFrames w + f) + l and holds
// all N mics' sums of each in registers (the template's N): for each
// (tap, mic m2) it loads each of its frames' samples once (two wavefronts
// a warp) and reads G's row as broadcast 8-byte words, then runs 4 N
// kApplyFrames FFMAs.  The current frames y are the window's last
// kApplyTile columns, and d = y - sum leaves in stores of consecutive
// frames of a mic's row.  Where delay + taps - 1 exceeds kApplyTile the
// window stops at t0 - delay + tile and y is read from device memory
// instead, so that shared memory stays under 80 KB at every delay (y from
// device memory at every delay measured ~19 % slower).  On an H100 at the
// WPE scene (PERF.md) it runs ~1.75x its bound: a warp spends about half
// its cycles at the item's barrier and ~40 % in its sums; 1 frame a lane
// ran ~16 % slower, 4 ~2 % faster there but ~80 % slower at WPD's T =
// 251 (half of a 512-frame tile idle), and neither a third slot, 2 or 8
// warps a block nor 16-byte reads of G moved it by more than 3 %; a block
// a bin with G staged once (two tiles a bin at T = 501) spent 55 % waiting
// for its first window.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxGramThreads = 256;
constexpr int kTile = 64;   // frames a tile of kernel 18
// kernel 19's block: 4 warps, 2 frames a lane (2 and 8 warps, 1 frame,
// and 4 frames at WPD's T = 251 measured slower)
constexpr int kApplyThreads = 128;
constexpr int kApplyFrames = 2;
constexpr int kApplyTile = kApplyThreads * kApplyFrames;  // frames a tile
constexpr int kRB = 4;      // Gram rows and columns a thread owns
constexpr float kEps = 1.1920928955078125e-07f;  // float32 epsilon

#ifdef SETK_WPE_PHASES
// tools/wpe_phase_profile.py's build: lane 0 of every warp adds the SM
// cycles of each phase into device counters.  Kernel 18: 0 waiting for
// the frames and the block, 1 d, lambda and sw, 2 the design tile, 3 the
// barrier after it and the next frames' cp.async, 4 products, 5 tile sums
// and the Gram's write.  Kernel 19: 0 waiting for the tile's window and
// the block (with issuing the next window's cp.async), 1 the sums, 2 the
// current frames' reads and d's stores.
__device__ unsigned long long g_wpe_phase[6];
__device__ unsigned long long g_apply_phase[3];
#define PHASE_TO(counters, i)                                       \
  do {                                                              \
    if ((threadIdx.x & 31) == 0) {                                  \
      const long long now_ = clock64();                             \
      atomicAdd(&counters[i], (unsigned long long)(now_ - t_));     \
      t_ = now_;                                                    \
    }                                                               \
  } while (0)
#define WPE_PHASE(i) PHASE_TO(g_wpe_phase, i)
#define APPLY_PHASE(i) PHASE_TO(g_apply_phase, i)
#define WPE_PHASE_START long long t_ = clock64()
#else
#define WPE_PHASE(i) \
  do {               \
  } while (0)
#define APPLY_PHASE(i) WPE_PHASE(i)
#define WPE_PHASE_START
#endif

// Stage frames [f0, f0 + wt) of the bin's n mics into xs (n rows of wt)
// through cp.async: the copies land while the block goes on; a frame
// outside [0, t) is zero-filled without a read.
__device__ void stage_async(float2* xs, const float2* ob, int n, int t,
                            int f0, int wt) {
  for (int idx = threadIdx.x; idx < n * wt; idx += blockDim.x) {
    const int m = idx / wt, f = f0 + idx - m * wt;
    const bool in = f >= 0 && f < t;
    __pipeline_memcpy_async(xs + idx, in ? ob + (size_t)m * t + f : ob,
                            sizeof(float2), in ? 0 : sizeof(float2));
  }
  __pipeline_commit();
}

// The mean power over mics of d = y - G^H taps at the tile's span frames
// t0 - C ... t0 + tile + C into ps (zero outside [0, t)).  An item is a
// (frame, half of the taps) pair, the halves in neighbouring lanes: a
// thread sums its half's taps for all N mics at once (N accumulators, one
// staged frame read a tap and mic), the pair joins its halves through a
// shuffle, and the even lane forms the power, summed in mic order.  Every
// thread runs every round, so that each meets every shuffle.
template <int N>
__device__ void dereverb_power(const float2* xs, int wt, const float2* gs,
                               int taps, int delay, int h, int context,
                               int span, int t0, int t, float* ps) {
  const int half = (taps + 1) / 2;
  const int rounds = (2 * span + blockDim.x - 1) / blockDim.x;
  for (int r = 0; r < rounds; ++r) {
    const int item = r * blockDim.x + threadIdx.x;
    const int u = item >> 1, k0 = (item & 1) ? half : 0;
    const int k1 = (item & 1) ? taps : half;
    const int f = t0 - context + u;
    const bool in = u < span && f >= 0 && f < t;
    float2 acc[N];
#pragma unroll
    for (int m = 0; m < N; ++m) acc[m] = make_float2(0.0f, 0.0f);
    if (in) {
      for (int k = k0; k < k1; ++k) {
#pragma unroll
        for (int m2 = 0; m2 < N; ++m2) {
          const float2 x = xs[m2 * wt + u + h - delay - k];
          const float2* gk = gs + (k * N + m2) * N;
#pragma unroll
          for (int m = 0; m < N; ++m) {
            const float2 g = gk[m];  // conj(g) x
            acc[m].x = fmaf(g.x, x.x, acc[m].x);
            acc[m].x = fmaf(g.y, x.y, acc[m].x);
            acc[m].y = fmaf(g.x, x.y, acc[m].y);
            acc[m].y = fmaf(-g.y, x.x, acc[m].y);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < N; ++m) {
      acc[m].x += __shfl_xor_sync(0xffffffffu, acc[m].x, 1);
      acc[m].y += __shfl_xor_sync(0xffffffffu, acc[m].y, 1);
    }
    if (u < span && (item & 1) == 0) {
      float p = 0.0f;
#pragma unroll
      for (int m = 0; m < N; ++m) {
        const float2 y = xs[m * wt + u + h];
        const float dx = y.x - acc[m].x, dy = y.y - acc[m].y;
        p += dx * dx + dy * dy;
      }
      ps[u] = in ? p * (1.0f / N) : 0.0f;
    }
  }
}

// Kernel 18's launch shape: nt 4-row blocks a side, ntiles (i <= j) pairs
// of them, in passes of `threads` (a multiple of 32, at most 256).
struct GramLayout {
  int nt, ntiles, passes, threads;
};

__host__ __device__ GramLayout gram_layout(int cols) {
  GramLayout l;
  l.nt = (cols + kRB - 1) / kRB;
  l.ntiles = l.nt * (l.nt + 1) / 2;
  l.passes = (l.ntiles + kMaxGramThreads - 1) / kMaxGramThreads;
  const int per = (l.ntiles + l.passes - 1) / l.passes;
  l.threads = (per + 31) / 32 * 32;
  return l;
}

// Kernel 18's dynamic shared memory: the design tile (2 kTile nt float4;
// in one pass also the whole Gram at the end, cols^2 float2), the raw
// frames (n wt float2), G (nk n float2), the span's power (span f32), sw
// (kTile f32), the design rows' offsets into the raw frames (4 nt int).
__host__ __device__ size_t gram_tile_bytes(int cols) {
  const GramLayout l = gram_layout(cols);
  const size_t tile = 16 * (size_t)(2 * kTile * l.nt);
  const size_t whole = 8 * (size_t)cols * cols;
  return l.passes == 1 && whole > tile ? (whole + 15) / 16 * 16 : tile;
}

size_t gram_smem_bytes(int n, int taps, int delay, int context) {
  const GramLayout l = gram_layout((taps + 1) * n);
  const int span = kTile + 2 * context;
  const int wt = span + delay + taps - 1;
  return gram_tile_bytes((taps + 1) * n) +
         8 * ((size_t)n * wt + (size_t)n * taps * n) +
         4 * ((size_t)span + kTile + kRB * l.nt);
}

template <int RB>
__global__ void __launch_bounds__(kMaxGramThreads)
wpe_gram_kernel(const float2* __restrict__ obs, const float2* __restrict__ g,
                const float* __restrict__ lam, float2* __restrict__ gram,
                int n, int t, int taps, int delay, int context, int use_g) {
  static_assert(RB == 4, "a thread's rows are two float4 of the planes");
  extern __shared__ float4 smem[];
  WPE_PHASE_START;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int cols = (taps + 1) * n, nk = n * taps;
  const GramLayout l = gram_layout(cols);
  const int nt = l.nt, rows = RB * nt;
  const int h = delay + taps - 1;            // the deepest tap's shift
  const int halo = context + h;              // frames staged before a tile
  const int span = kTile + 2 * context;      // frames with a power
  const int wt = span + h;                   // staged frames a tile
  float4* as = smem;                         // design tile, 2 planes
  float2* xs = reinterpret_cast<float2*>(as + gram_tile_bytes(cols) / 16);
  float2* gs = xs + n * wt;                  // G (nk, n)
  float* ps = reinterpret_cast<float*>(gs + nk * n);  // the span's power
  float* sw = ps + span;                     // the tile's weights
  int* ro = reinterpret_cast<int*>(sw + kTile);       // row offsets
  const size_t bin = blockIdx.x;
  const float2* ob = obs + bin * n * t;
  const bool derev = use_g && lam == nullptr;
  if (derev) {
    for (int i = tid; i < nk * n; i += nth) gs[i] = g[bin * nk * n + i];
  }
  // design row i at tile frame 0: mic m of the current rows, or the tap
  // row's mic shifted back by delay + k; -1 past cols (a zero row)
  for (int i = tid; i < rows; i += nth) {
    int off = -1;
    if (i < n) {
      off = i * wt + halo;
    } else if (i < cols) {
      const int k = (i - n) / n, m = (i - n) - k * n;
      off = m * wt + halo - delay - k;
    }
    ro[i] = off;
  }
  float2* as2 = reinterpret_cast<float2*>(as);
  const int phases = nth / rows > 1 ? nth / rows : 1;  // threads a row
  for (int pass = 0; pass < l.passes; ++pass) {
    int q = pass * nth + tid;
    const bool active = q < l.ntiles;
    int bi = 0;
    if (active) {
      while (q >= nt - bi) {
        q -= nt - bi;
        ++bi;
      }
    }
    const int bj = bi + q;
    float tot_re[RB][RB], tot_im[RB][RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
#pragma unroll
      for (int c = 0; c < RB; ++c) tot_re[r][c] = tot_im[r][c] = 0.0f;
    }
    stage_async(xs, ob, n, t, -halo, wt);
    for (int t0 = 0; t0 < t; t0 += kTile) {
      __pipeline_wait_prior(0);
      __syncthreads();  // frames staged, G and ro in, the last products done
      WPE_PHASE(0);
      if (derev) {
        switch (n) {
#define CASE(N)                                                             \
  case N:                                                                   \
    dereverb_power<N>(xs, wt, gs, taps, delay, h, context, span, t0, t, ps); \
    break;
          CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
        }
        __syncthreads();
      } else if (lam == nullptr) {
        // the mean power over mics of y at frames t0 - C ... t0 + tile + C
        for (int u = tid; u < span; u += nth) {
          const int f = t0 - context + u;
          float p = 0.0f;
          if (f >= 0 && f < t) {
            for (int m = 0; m < n; ++m) {
              const float2 y = xs[m * wt + u + h];
              p += y.x * y.x + y.y * y.y;
            }
          }
          ps[u] = p * (1.0f / n);
        }
        __syncthreads();
      }
      for (int u = tid; u < kTile; u += nth) {
        const int f = t0 + u;
        float s = 0.0f;
        if (f < t) {
          float lv;
          if (lam != nullptr) {
            lv = lam[bin * t + f];
          } else {
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
            lv = acc / cnt;
          }
          s = 1.0f / sqrtf(fmaxf(lv, kEps));
        }
        sw[u] = s;
      }
      __syncthreads();
      WPE_PHASE(1);
      // the weighted design tile: element (u, i) = sw_u A[i][t0 + u] at
      // plane (i / 2) % 2, float4 i / 4 of frame u, half i % 2; a thread
      // holds row i = e % rows at frames e / rows + phases v
      for (int e = tid; e < phases * rows; e += nth) {
        const int i = e % rows, ph = e / rows, off = ro[i];
        float2* dst = as2 + ((2 * ph + ((i >> 1) & 1)) * nt + (i >> 2)) * 2 +
                      (i & 1);
        const int step = 4 * phases * nt;  // float2s between its frames
        if (off >= 0) {
#pragma unroll 4
          for (int u = ph; u < kTile; u += phases, dst += step) {
            const float2 x = xs[off + u];
            const float w = sw[u];
            *dst = make_float2(x.x * w, x.y * w);
          }
        } else {
          for (int u = ph; u < kTile; u += phases, dst += step)
            *dst = make_float2(0.0f, 0.0f);
        }
      }
      WPE_PHASE(2);
      __syncthreads();  // the tile is built; xs is free
      if (t0 + kTile < t) stage_async(xs, ob, n, t, t0 + kTile - halo, wt);
      WPE_PHASE(3);
      if (active) {
        float acc_re[RB][RB], acc_im[RB][RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
#pragma unroll
          for (int c = 0; c < RB; ++c) acc_re[r][c] = acc_im[r][c] = 0.0f;
        }
        const float4* pa = as + bi;
        const float4* pb = as + bj;
        // frames past T carry sw = 0: every tile runs its 64 frames
#pragma unroll 2
        for (int u = 0; u < kTile; ++u) {
          const float4 a01 = pa[2 * u * nt], a23 = pa[(2 * u + 1) * nt];
          const float4 b01 = pb[2 * u * nt], b23 = pb[(2 * u + 1) * nt];
          const float2 a[RB] = {make_float2(a01.x, a01.y),
                                 make_float2(a01.z, a01.w),
                                 make_float2(a23.x, a23.y),
                                 make_float2(a23.z, a23.w)};
          const float2 b[RB] = {make_float2(b01.x, b01.y),
                                 make_float2(b01.z, b01.w),
                                 make_float2(b23.x, b23.y),
                                 make_float2(b23.z, b23.w)};
#pragma unroll
          for (int r = 0; r < RB; ++r) {
#pragma unroll
            for (int c = 0; c < RB; ++c) {
              // a_r conj(b_c)
              acc_re[r][c] = fmaf(a[r].x, b[c].x, acc_re[r][c]);
              acc_re[r][c] = fmaf(a[r].y, b[c].y, acc_re[r][c]);
              acc_im[r][c] = fmaf(a[r].y, b[c].x, acc_im[r][c]);
              acc_im[r][c] = fmaf(-a[r].x, b[c].y, acc_im[r][c]);
            }
          }
        }
        WPE_PHASE(4);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
#pragma unroll
          for (int c = 0; c < RB; ++c) {
            tot_re[r][c] += acc_re[r][c];
            tot_im[r][c] += acc_im[r][c];
          }
        }
        WPE_PHASE(5);
      }
    }
    float2* gb = gram + bin * cols * cols;
    if (l.passes == 1) {
      // through shared memory: both triangles into the design tile's
      // room, then the bin's Gram out in coalesced 16-byte stores
      __syncthreads();  // every thread's products are done with the tile
      float2* whole = as2;
      if (active) {
#pragma unroll
        for (int r = 0; r < RB; ++r) {
#pragma unroll
          for (int c = 0; c < RB; ++c) {
            const int i = bi * RB + r, j = bj * RB + c;
            if (i < cols && j < cols && i <= j) {
              const float re = tot_re[r][c];
              const float im = i == j ? 0.0f : tot_im[r][c];
              whole[i * cols + j] = make_float2(re, im);
              whole[j * cols + i] = make_float2(re, -im);
            }
          }
        }
      }
      __syncthreads();
      const int quads = cols * cols / 2;  // cols = (taps + 1) n: whole float4s
      if ((cols & 1) == 0) {
        float4* g4 = reinterpret_cast<float4*>(gb);
        for (int e = tid; e < quads; e += nth) g4[e] = as[e];
      } else {
        for (int e = tid; e < cols * cols; e += nth) gb[e] = whole[e];
      }
    } else if (active) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
#pragma unroll
        for (int c = 0; c < RB; ++c) {
          const int i = bi * RB + r, j = bj * RB + c;
          if (i < cols && j < cols && i <= j) {
            const float re = tot_re[r][c], im = i == j ? 0.0f : tot_im[r][c];
            gb[i * cols + j] = make_float2(re, im);
            gb[j * cols + i] = make_float2(re, -im);
          }
        }
      }
    }
    WPE_PHASE(5);
  }
}

// Kernel 19's shared memory, in float2: two G buffers (n taps rows of n,
// rounded up to even), a bin's G in buffer bin % 2, then the ring's two
// windows, n rows of wr each (wl frames, kApplyTile + delay + taps - 1
// where the window holds y, else kApplyTile + taps - 1, and one frame
// before them where a row's first frame lies at an odd complex word,
// rounded up to even).
struct ApplyShape {
  int lead, wl, wr, gl, win;
  bool y_in;
};

__host__ __device__ ApplyShape apply_shape(int n, int taps, int delay) {
  ApplyShape a;
  a.lead = delay + taps - 1;
  a.y_in = a.lead <= kApplyTile;
  a.wl = kApplyTile + (a.y_in ? a.lead : taps - 1);
  a.wr = (a.wl + 2) & ~1;
  a.gl = (n * n * taps + 1) & ~1;
  a.win = n * a.wr;
  return a;
}

// The parity of the complex word at frame f0 of mic m's row of the bin (0
// or 1), `base` that of obs's first word: the frames a window row from f0
// holds before it, so that its 16-byte copies read from 16-byte addresses
// whatever obs's offset.  (Taking base from obs inside, or the parity of
// a row pointer, cost kernel 19 27 or 11 registers at N = 6, and 4-8 %.)
__device__ __forceinline__ int row_shift(int base, size_t bin, int n, int m,
                                         int t, int f0) {
  return (int)((base + (long long)(bin * n + m) * t + f0) & 1);
}

// Stage item `item` (bin item / tiles, its tile item % tiles), one
// cp.async group: with `gs`, the bin's G there (in 16-byte copies where
// its size is even and its first word lies on 16 bytes); then into `xs`
// each mic's window row from frame f0 - shift in 16-byte copies of two
// frames, a pair across 0 or T copied frame by frame, frames outside [0,
// T) zero-filled without a read.
template <int N>
__device__ void stage_item(float2* gs, float2* xs, const float2* obs,
                           const float2* g, int item, int tiles, int t,
                           int taps, const ApplyShape& a) {
  // the zero fills name a 16-byte-aligned source that they do not read:
  // obs's words start 8-byte aligned, so the 16 bytes at or just before
  // its first word lie in its allocation
  const float2* zero = reinterpret_cast<const float2*>(
      reinterpret_cast<uintptr_t>(obs) & ~(uintptr_t)15);
  const int base = (int)(reinterpret_cast<uintptr_t>(obs) >> 3) & 1;
  const int ng = N * N * taps;
  const size_t bin = item / tiles;
  const int f0 = (item - (int)bin * tiles) * kApplyTile - a.lead;
  const float2* gb = g + bin * ng;
  if (gs != nullptr && ng % 2 == 0 &&
      (reinterpret_cast<uintptr_t>(gb) & 15) == 0) {
    for (int i = 2 * threadIdx.x; i < ng; i += 2 * blockDim.x)
      __pipeline_memcpy_async(gs + i, gb + i, 16);
  } else if (gs != nullptr) {
    for (int i = threadIdx.x; i < ng; i += blockDim.x)
      __pipeline_memcpy_async(gs + i, gb + i, sizeof(float2));
  }
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const float2* row = obs + (bin * N + m) * t;
    const int g0 = f0 - row_shift(base, bin, N, m, t, f0);
    for (int c = threadIdx.x; c < a.wr / 2; c += blockDim.x) {
      const int f = g0 + 2 * c;
      float2* d = xs + m * a.wr + 2 * c;
      if (f >= 0 && f + 1 < t) {
        __pipeline_memcpy_async(d, row + f, 16);
      } else if (f + 1 < 0 || f >= t) {
        __pipeline_memcpy_async(d, zero, 16, 16);
      } else {
        __pipeline_memcpy_async(d, f >= 0 ? row + f : obs, 8, f >= 0 ? 0 : 8);
        __pipeline_memcpy_async(d + 1, f + 1 < t ? row + f + 1 : obs, 8,
                                f + 1 < t ? 0 : 8);
      }
    }
  }
  __pipeline_commit();
}

// A block walks items blockIdx.x * per ... (at most per of them): d = y -
// G^H taps for their frames.
template <int N>
__global__ void __launch_bounds__(kApplyThreads)
wpe_apply_kernel(const float2* __restrict__ obs, const float2* __restrict__ g,
                 float2* __restrict__ out, int bins, int t, int taps,
                 int delay, int per) {
  constexpr int F = kApplyFrames;
  extern __shared__ float4 smem[];
  WPE_PHASE_START;
  const ApplyShape a = apply_shape(N, taps, delay);
  const int base = (int)(reinterpret_cast<uintptr_t>(obs) >> 3) & 1;
  float2* gbuf = reinterpret_cast<float2*>(smem);  // G of even, odd bins
  float2* ring = gbuf + 2 * a.gl;                  // two windows
  const int tiles = (t + kApplyTile - 1) / kApplyTile;
  const int first = blockIdx.x * per;
  const int last = min(bins * tiles, first + per);
  stage_item<N>(gbuf + (first / tiles & 1) * a.gl, ring, obs, g, first,
                tiles, t, taps, a);
  // the lane's frames in a tile: u0 + 32 f, f < F
  const int u0 = (threadIdx.x >> 5) * 32 * F + (threadIdx.x & 31);
  for (int item = first; item < last; ++item) {
    __pipeline_wait_prior(0);
    __syncthreads();  // the item's slot in; every warp done with the last
    const int bin = item / tiles;
    if (item + 1 < last) {
      // a new bin's G into the other buffer, whose bin is done
      const int next = (item + 1) / tiles;
      stage_item<N>(next != bin ? gbuf + (next & 1) * a.gl : nullptr,
                    ring + ((item + 1 - first) & 1) * a.win, obs, g,
                    item + 1, tiles, t, taps, a);
    }
    APPLY_PHASE(0);
    const int t0 = (item - bin * tiles) * kApplyTile;
    const float2* gs = gbuf + (bin & 1) * a.gl;
    // frame t0 + u of mic m at xs[sh[m] + u + lead]; at tap k frame u
    // reads window column u + taps - 1 - k
    const float2* xs = ring + ((item - first) & 1) * a.win;
    const float2* xw = xs + u0 + taps - 1;
    int sh[N];
#pragma unroll
    for (int m = 0; m < N; ++m)
      sh[m] = m * a.wr + row_shift(base, bin, N, m, t, t0 - a.lead);
    float2 acc[F][N];
#pragma unroll
    for (int f = 0; f < F; ++f) {
#pragma unroll
      for (int m = 0; m < N; ++m) acc[f][m] = make_float2(0.0f, 0.0f);
    }
    for (int k = 0; k < taps; ++k) {
#pragma unroll
      for (int m2 = 0; m2 < N; ++m2) {
        float2 x[F];
#pragma unroll
        for (int f = 0; f < F; ++f) x[f] = xw[sh[m2] + 32 * f - k];
        const float2* gr = gs + (k * N + m2) * N;  // G's row, broadcast
#pragma unroll
        for (int m = 0; m < N; ++m) {
          const float2 gm = gr[m];
#pragma unroll
          for (int f = 0; f < F; ++f) {  // conj(g) x
            acc[f][m].x = fmaf(gm.x, x[f].x, acc[f][m].x);
            acc[f][m].x = fmaf(gm.y, x[f].y, acc[f][m].x);
            acc[f][m].y = fmaf(gm.x, x[f].y, acc[f][m].y);
            acc[f][m].y = fmaf(-gm.y, x[f].x, acc[f][m].y);
          }
        }
      }
    }
    APPLY_PHASE(1);
    const float2* ob = obs + (size_t)bin * N * t;
    float2* od = out + (size_t)bin * N * t;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int u = u0 + 32 * f;
      if (t0 + u < t) {
#pragma unroll
        for (int m = 0; m < N; ++m) {
          const float2 y = a.y_in ? xs[sh[m] + u + a.lead]
                                  : ob[(size_t)m * t + t0 + u];
          od[(size_t)m * t + t0 + u] =
              make_float2(y.x - acc[f][m].x, y.y - acc[f][m].y);
        }
      }
    }
    APPLY_PHASE(2);
  }
}

template <typename K>
int opt_in(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// opt_in, and the largest shared-memory carveout, so that an SM holds as
// many of kernel 18's blocks as its 228 KB allow
template <typename K>
int carve_out(K kernel, size_t bytes) {
  const int err = opt_in(kernel, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Kernel 19's launch: one wave of blocks, each walking `per` items.
struct ApplyPlan {
  size_t bytes;
  int blocks, per, per_sm;
};

template <int N>
int apply_plan(int bins, int t, int taps, int delay, int sms,
               ApplyPlan* plan) {
  const ApplyShape s = apply_shape(N, taps, delay);
  plan->bytes = 2 * sizeof(float2) * (s.gl + s.win);
  int err = opt_in(wpe_apply_kernel<N>, plan->bytes);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &plan->per_sm, wpe_apply_kernel<N>, kApplyThreads, plan->bytes);
  if (err != cudaSuccess) return err;
  if (plan->per_sm < 1) return cudaErrorInvalidValue;
  const long items = (long)bins * ((t + kApplyTile - 1) / kApplyTile);
  const long want = (long)sms * plan->per_sm;
  plan->per = (int)((items + want - 1) / want);
  plan->blocks = (int)((items + plan->per - 1) / plan->per);
  return cudaSuccess;
}

int apply_plan_n(int n, int bins, int t, int taps, int delay, int sms,
                 ApplyPlan* plan) {
  switch (n) {
#define CASE(N) \
  case N:       \
    return apply_plan<N>(bins, t, taps, delay, sms, plan);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
  }
  return cudaErrorInvalidValue;
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
  const size_t bytes = gram_smem_bytes(n, taps, delay, context);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  int err = carve_out(wpe_gram_kernel<kRB>, bytes);
  if (err != cudaSuccess) return err;
  wpe_gram_kernel<kRB><<<bins, gram_layout((taps + 1) * n).threads, bytes,
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
  if (bad_shape(bins, n, t, taps, delay) ||
      (long)bins * ((t + kApplyTile - 1) / kApplyTile) > 0x7fffffffL)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  int err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  ApplyPlan plan;
  err = apply_plan_n(n, bins, t, taps, delay, sms, &plan);
  if (err != cudaSuccess) return err;
  auto st = static_cast<cudaStream_t>(stream);
  auto ob = static_cast<const float2*>(obs);
  auto gg = static_cast<const float2*>(g);
  auto dd = static_cast<float2*>(out);
  switch (n) {
#define CASE(N)                                                          \
  case N:                                                                \
    wpe_apply_kernel<N><<<plan.blocks, kApplyThreads, plan.bytes, st>>>( \
        ob, gg, dd, bins, t, taps, delay, plan.per);                     \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
  }
  return cudaGetLastError();
}

// Kernel 19's launch at (bins, n, t, taps, delay) on a card of `sms` SMs:
// out[0] frames a tile, out[1] blocks, out[2] items (bin, tile) a block,
// out[3] threads a block, out[4] blocks an SM, out[5] shared memory a
// block (bytes), out[6] 1 where the window holds the current frames.
extern "C" int wpe_apply_layout(int bins, int n, int t, int taps, int delay,
                                int sms, int* out) {
  if (bad_shape(bins, n, t, taps, delay) || sms < 1)
    return cudaErrorInvalidValue;
  ApplyPlan plan;
  const int err = apply_plan_n(n, bins, t, taps, delay, sms, &plan);
  if (err != cudaSuccess) return err;
  out[0] = kApplyTile;
  out[1] = plan.blocks;
  out[2] = plan.per;
  out[3] = kApplyThreads;
  out[4] = plan.per_sm;
  out[5] = (int)plan.bytes;
  out[6] = apply_shape(n, taps, delay).y_in;
  return cudaSuccess;
}

#ifdef SETK_WPE_PHASES
// the phase counters of the instrumented build: read (6 values) and zero
extern "C" int wpe_phase_read(unsigned long long* out) {
  int err = cudaMemcpyFromSymbol(out, g_wpe_phase, 6 * 8);
  if (err != cudaSuccess) return err;
  const unsigned long long zero[6] = {};
  return cudaMemcpyToSymbol(g_wpe_phase, zero, 6 * 8);
}

// kernel 19's: read (3 values) and zero
extern "C" int apply_phase_read(unsigned long long* out) {
  int err = cudaMemcpyFromSymbol(out, g_apply_phase, 3 * 8);
  if (err != cudaSuccess) return err;
  const unsigned long long zero[3] = {};
  return cudaMemcpyToSymbol(g_apply_phase, zero, 3 * 8);
}
#endif
