// Kernel 15 (sm_90a): the whole CGMM / CACGMM EM loop in one launch.
//
// Replaces setk_tpu/ops/pallas/cacgmm_em.py _em_blocks (:301, body
// _em_kernel :61) via cacgmm_em_pallas (:483) and cgmm_em_pallas (:507).
// One warp owns a few (utterance, bin)s and runs every iteration:
//   M-step  w[k,t] = (gamma fm / max(kern, EPS)) (M / max(sum_t gamma fm, EPS))
//           R[k]   = sum_t w[k,t] z_t z_t^H        (Im = -sum w Im(conj(z_i) z_j))
//           alpha  = sum_t gamma fm / max(sum_t fm, 1)        (update_alpha)
//   E-step  B[k], logdet[k] = the floored Jacobi inverse of R[k] (jacobi.cuh)
//           quad   = max(z^H B z, EPS), carried as is (cacg) or / M (cg)
//           log_pdf = -M log(quad) - logdet; a max-shifted softmax over k
//           with den >= EPS and gamma clamped to <= 1 (indefinite Rn
//           downstream otherwise); Q += (mx + log den) fm over the frames.
// with the expressions of _em_kernel.  The two models differ only in the
// carried plane (CGMM takes raw spectra, CACGMM spectra L2-normalised over
// mics by the caller).  With `higuchi` (K = 2) the init runs first: class 0
// the fm-weighted sample covariance over max(sum fm, 1), class 1 exactly
// the identity (inverse I, logdet 0, so quad = sum |z_i|^2; no Jacobi: a
// Jacobi of an exact identity would rotate), then its predict; its Q is not
// part of the history.  State out: the last iteration's M-step covariances
// and alpha, and its E-step gamma and quad.
//
// Layout: the caller's own.  obs (nb, M, T) complex64 (bin = l * F + f),
// each mic's frames contiguous; gamma0 / kern0 in and gamma / kern out
// (K, nb, T) f32; the frame mask through its (utterance, bin, frame)
// strides (a (B, 1, T) mask is read with a zero bin stride).  The per-bin
// Q of every iteration goes to q (iters, nb), reduced over bins in PyTorch
// in a fixed order.
//
// Bound on the card: operations.  At B = 128 x 8 s (32,896 bins, T = 512,
// K = 2, M = 6, 20 iterations) about 460 FLOP a bin, frame and iteration
// with the pair products shared (chip_smoke.py's _flops_em) plus the
// Jacobi: ~3.1 ms at 67 TFLOP/s f32; reading z once is 0.24 ms.  The design:
//   - Lanes over a bin's frames (lane l takes frames l, l + 32, ...), so
//     each mic row is read as one contiguous run and every lane keeps the K
//     classes' partial sums in registers; the sums over lanes meet in a
//     fixed-order transpose through shared memory (deterministic, no
//     atomics).
//   - One pass over z an iteration: E-step i (quad, posterior, Q) and the
//     accumulation of M-step i + 1 share it, since the M-step's weight is
//     (gamma fm / max(kern, EPS)) times a per-class scalar, applied after
//     the pass.  This changes only the order of rounding in the M-step's
//     sums (the scalar multiplies the sum, not each term).  gamma and kern
//     never leave the chip except at the last E-step; operand gamma0 /
//     kern0 are read once, by the first M-step's pass; the Higuchi init's
//     sample covariance is a pass of its own.  Passes over z: iters + 1
//     (+1 for Higuchi).
//   - The Jacobi spread over the warp: a group of kGroup lanes a class
//     (jacobi_regularized_inverse_group), each lane a few rows of A and V
//     in registers, rows exchanged by shuffles.  Its cyclic order is a
//     chain of 90 rotations (M = 6, 6 sweeps), each an angle of IEEE
//     square roots and divisions that every lane of a group computes, so
//     its instructions are paid once for all the groups of the warp: a warp
//     holds as many bins as its groups hold all K classes of
//     (bins_per_warp: 8 at K = 2), passes over them one after another and
//     inverts all their classes at once.  (With one bin a warp, groups of
//     8 and A and V in shared memory, the Jacobi took 3/4 of the kernel's
//     cycles; PERF.md.)  The inverses go to shared memory and every lane
//     reads them as float4 broadcasts in the next pass, so the pass's
//     registers hold the sums, z and the pair products, not the inverses.
//     Measured (PERF.md): two thirds of a warp's cycles are the passes,
//     held by each frame's latency chain at ~7 warps an SM.
//   - z is read through L2: a first design staged each bin's z in shared
//     memory (29,776 bytes a warp at the bench bucket, 7 warps an SM) and
//     was slower than reading it through L2 at the bench shape (PERF.md).
// One warp a block, so that blocks pack an SM by their registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "jacobi.cuh"

namespace {

using setk::kEps;

constexpr int kLanes = 32;
constexpr int kRedStride = kLanes + 1;   // padded rows of the transpose
constexpr int kGroup = 2;                // lanes a class's Jacobi

// A class's sums: Re of conj(z_i) z_c on the upper triangle (NP), Im off
// the diagonal (NO), sum_t gamma fm; then Q after the K classes.
__host__ __device__ constexpr int packed(int m) { return m * (m + 1) / 2; }
__host__ __device__ constexpr int off_diag(int m) { return m * (m - 1) / 2; }
__host__ __device__ constexpr int class_sums(int m) {
  return packed(m) + off_diag(m) + 1;
}
__host__ __device__ constexpr int sums_of(int m, int k) {
  return k * class_sums(m) + 1;
}
// bins a warp: as many as its lane groups hold all K classes of
__host__ __device__ constexpr int bins_per_warp(int k) {
  return kLanes / kGroup / k;
}
// A class's inverse in the order the E-step reads it: the diagonal (M),
// then (Re, Im) of each off-diagonal entry row by row, then logdet; a
// multiple of 4, so that a class is read as float4 broadcasts.
__host__ __device__ constexpr int inverse_floats(int m) {
  return (m + 2 * off_diag(m) + 1 + 3) / 4 * 4;
}
// a bin's state: the reduced sums, alpha, max(sum fm, 1)
__host__ __device__ constexpr int state_floats(int m, int k) {
  return sums_of(m, k) + k + 1;
}

// A warp's shared memory in bytes: its bins' inverses as the E-step reads
// them, the transpose tile, the bins' state.
__host__ __device__ constexpr int em_smem_bytes(int m, int k) {
  return 4 * (bins_per_warp(k) * k * inverse_floats(m) + kLanes * kRedStride +
              bins_per_warp(k) * state_floats(m, k));
}

#ifdef SETK_EM_PHASES
// tools/em_phase_profile.py's build: lane 0 of every warp adds the SM
// cycles of each phase (frame passes, sums over lanes, Jacobi, the rest)
__device__ unsigned long long g_em_phase[4];
#define EM_PHASE(i)                                                 \
  do {                                                              \
    if (lane == 0) {                                                \
      const long long now_ = clock64();                             \
      atomicAdd(&g_em_phase[i], (unsigned long long)(now_ - t_));   \
      t_ = now_;                                                    \
    }                                                               \
  } while (0)
#define EM_PHASE_START long long t_ = clock64()
#else
#define EM_PHASE(i) \
  do {              \
  } while (0)
#define EM_PHASE_START
#endif

// Sums over the warp's lanes of each lane's part[0 .. N), in a fixed order
// (lane 0 first), into out[0 .. N): 32 values at a time through a padded
// 32 x 33 tile, lane l adding up value l of the chunk.
template <int N>
__device__ __forceinline__ void sum_lanes(const float (&part)[N], float* red,
                                          float* out, int lane) {
#pragma unroll
  for (int c0 = 0; c0 < N; c0 += kLanes) {
#pragma unroll
    for (int i = 0; i < kLanes; ++i)
      if (c0 + i < N) red[i * kRedStride + lane] = part[c0 + i];
    __syncwarp();
    if (c0 + lane < N) {
      float s = red[lane * kRedStride];
#pragma unroll
      for (int l = 1; l < kLanes; ++l) s += red[lane * kRedStride + l];
      out[c0 + lane] = s;
    }
    __syncwarp();
  }
}

enum Pass { kSample, kOperands, kEstep, kLast };

template <int M, int K>
struct EmWarp {
  static constexpr int NP = packed(M);
  static constexpr int NO = off_diag(M);
  static constexpr int CL = class_sums(M);
  static constexpr int NV = sums_of(M, K);
  static constexpr int P = bins_per_warp(K);
  static constexpr int BQ = inverse_floats(M);
  static constexpr int NS = state_floats(M, K);

  int T, lane, first, bins;   // this warp's bins: first .. first + bins - 1
  bool cg;
  float* bq;     // P x K x BQ: the inverses as the E-step reads them
  float* red;    // the transpose tile
  float* state;  // P x NS: each bin's sums, alpha and max(sum fm, 1)

  // One pass over bin b's frames (this lane's) into part (NV partial
  // sums):
  //   kSample    the Higuchi init's class 0, weight fm
  //   kOperands  the first M-step's sums from gamma0 / kern0 (g_in, k_in)
  //   kEstep     an E-step (gamma, quad, Q) and the next M-step's sums
  //   kLast      the last E-step: Q, and gamma and quad to g_out, k_out
  // The pair products conj(z_i) z_j are formed once a frame and serve the
  // quadratic forms and the sums alike.
  template <int MODE>
  __device__ void pass(int b, const float2* z, const float* fm, int64_t fm_ts,
                       const float* g_in, const float* k_in, float* g_out,
                       float* k_out, size_t plane, float (&part)[NV]) const {
#pragma unroll
    for (int v = 0; v < NV; ++v) part[v] = 0.0f;
    const float* bb = bq + b * K * BQ;
    float alpha[K], logdet[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      alpha[c] = state[b * NS + NV + c];
      logdet[c] = bb[c * BQ + M + 2 * NO];
    }
    for (int t = lane; t < T; t += kLanes) {
      // the inverses are read from shared memory in every frame, not held
      // in registers across the loop
      asm volatile("" ::: "memory");
      const float f = fm == nullptr ? 1.0f : fm[t * fm_ts];
      float2 x[M];
#pragma unroll
      for (int i = 0; i < M; ++i) x[i] = z[(size_t)i * T + t];
      float pd[M], pr[NO > 0 ? NO : 1], pi[NO > 0 ? NO : 1];
#pragma unroll
      for (int i = 0, o = 0; i < M; ++i) {
        pd[i] = x[i].x * x[i].x + x[i].y * x[i].y;
#pragma unroll
        for (int j = i + 1; j < M; ++j, ++o) {
          pr[o] = x[i].x * x[j].x + x[i].y * x[j].y;
          pi[o] = x[i].x * x[j].y - x[i].y * x[j].x;
        }
      }
      float gf[K], w[K];
      if constexpr (MODE == kSample) {
        gf[0] = 0.0f;
        w[0] = f;
      } else if constexpr (MODE == kOperands) {
#pragma unroll
        for (int c = 0; c < K; ++c) {
          gf[c] = g_in[c * plane + t] * f;
          w[c] = gf[c] / fmaxf(k_in[c * plane + t], kEps);
        }
      } else {
        float quad[K], lp[K];
#pragma unroll
        for (int c = 0; c < K; ++c) {
          float bc[BQ];
          const float4* b4 = reinterpret_cast<const float4*>(bb + c * BQ);
#pragma unroll
          for (int n = 0; n < BQ / 4; ++n) {
            const float4 v = b4[n];
            bc[4 * n] = v.x;
            bc[4 * n + 1] = v.y;
            bc[4 * n + 2] = v.z;
            bc[4 * n + 3] = v.w;
          }
          float qds = 0.0f;
#pragma unroll
          for (int i = 0; i < M; ++i) qds += bc[i] * pd[i];
#pragma unroll
          for (int o = 0; o < NO; ++o)
            // 2 Re(conj(z_i) B_ij z_j) = 2 (Bre Pre - Bim Pim)
            qds += 2.0f * (bc[M + 2 * o] * pr[o] - bc[M + 2 * o + 1] * pi[o]);
          quad[c] = cg ? fmaxf(qds, kEps) * (1.0f / M) : fmaxf(qds, kEps);
          lp[c] = -(float)M * logf(quad[c]) - logdet[c];
        }
        float mx = lp[0];
#pragma unroll
        for (int c = 1; c < K; ++c) mx = fmaxf(mx, lp[c]);
        float num[K];
#pragma unroll
        for (int c = 0; c < K; ++c) num[c] = expf(lp[c] - mx) * alpha[c];
        float den = num[0];
#pragma unroll
        for (int c = 1; c < K; ++c) den += num[c];
        den = fmaxf(den, kEps);
        part[NV - 1] += (mx + logf(den)) * f;
#pragma unroll
        for (int c = 0; c < K; ++c) {
          const float gamma = fminf(num[c] / den, 1.0f);
          if constexpr (MODE == kLast) {
            g_out[c * plane + t] = gamma;
            k_out[c * plane + t] = quad[c];
          } else {
            gf[c] = gamma * f;
            w[c] = gf[c] / fmaxf(quad[c], kEps);
          }
        }
      }
      if constexpr (MODE != kLast) {
        constexpr int classes = MODE == kSample ? 1 : K;
#pragma unroll
        for (int c = 0; c < classes; ++c) {
          float* s = part + c * CL;
          s[NP + NO] += gf[c];
#pragma unroll
          for (int i = 0, idx = 0, o = 0; i < M; ++i) {
            s[idx++] += w[c] * pd[i];
#pragma unroll
            for (int j = i + 1; j < M; ++j, ++idx, ++o) {
              s[idx] += w[c] * pr[o];
              s[NP + o] += w[c] * pi[o];
            }
          }
        }
      }
    }
  }

  // This lane's Jacobi group: bin b, class c, lane r of the group; active
  // when it holds a bin of the launch.
  __device__ void group(int& b, int& c, int& r, bool& active) const {
    const int g = lane / kGroup;
    r = lane % kGroup;
    b = g / K;
    c = g % K;
    active = b < bins;
    if (!active) b = c = 0;
  }

  // Entry (i, j) of class c's covariance from bin b's reduced sums: R =
  // sum w z_i conj(z_j) (Im negated, the lower triangle Hermitian) times
  // `scale` (the M-step), or over `div` where it is not 0 (the Higuchi
  // init, a division as the reference's).
  __device__ float2 covariance(int b, int c, int i, int j, float scale,
                               float div) const {
    const float* s = state + b * NS + c * CL;
    const int lo = i < j ? i : j, hi = i < j ? j : i;
    const int idx = lo * M - lo * (lo - 1) / 2 + (hi - lo);
    const float re = div != 0.0f ? s[idx] / div : s[idx] * scale;
    if (i == j) return make_float2(re, 0.0f);
    const float si = s[NP + idx - (lo + 1)];
    const float im = -(div != 0.0f ? si / div : si * scale);
    return make_float2(re, i < j ? im : -im);
  }

  // The floored inverses of every group whose class is in `which` (bit c),
  // from the covariances of `scale` / `div`, laid out in bq as the E-step
  // reads them; with `out`, each lane writes its rows of its class's
  // covariance there first.
  __device__ void invert(unsigned which, int sweeps, float div,
                         float2* out, int nb) const {
    int b, c, r;
    bool active;
    group(b, c, r, active);
    active = active && ((which >> c) & 1u);
    const float* st = state + b * NS;
    const float scale =
        (float)M / fmaxf(st[c * CL + NP + NO], kEps);   // M / sum gamma fm
    if (active && out != nullptr) {
      float2* o = out + ((size_t)c * nb + first + b) * M * M;
      for (int i = r; i < M; i += kGroup)
#pragma unroll
        for (int j = 0; j < M; ++j) o[i * M + j] = covariance(b, c, i, j,
                                                             scale, div);
    }
    float* d = bq + (b * K + c) * BQ;
    const float ld = setk::jacobi_regularized_inverse_group<M, kGroup>(
        [&](int i, int j) { return covariance(b, c, i, j, scale, div); },
        sweeps, r, active, [&](int i, int j, float re, float im) {
          if (i == j) {
            d[i] = re;
          } else {
            const int o = i * M - i * (i - 1) / 2 + (j - i) - (i + 1);
            d[M + 2 * o] = re;
            d[M + 2 * o + 1] = im;
          }
        });
    if (active && r == 0) d[M + 2 * NO] = ld;
    __syncwarp();
  }
};

// One warp a block, at least one block an SM: ptxas may use every register
// the pass and the Jacobi want (201 at M = 6, K = 2, no spills).  With the
// maximum threads alone it caps them at 168 and spills (PERF.md).
template <int M, int K>
__global__ void __launch_bounds__(kLanes, 1)
em_warp_kernel(const float2* __restrict__ obs, const float* __restrict__ fm,
               int64_t fm_ls, int64_t fm_fs, int64_t fm_ts,
               const float* __restrict__ gamma0,
               const float* __restrict__ kern0, float* __restrict__ gamma,
               float* __restrict__ kern, float* __restrict__ q,
               float2* __restrict__ covar, float* __restrict__ alpha_out,
               int nb, int F, int T, int iters, int cg, int higuchi,
               int update_alpha, int sweeps) {
  using W = EmWarp<M, K>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x;
  EM_PHASE_START;
  W em;
  em.lane = lane;
  em.T = T;
  em.cg = cg != 0;
  em.first = blockIdx.x * W::P;
  em.bins = nb - em.first < W::P ? nb - em.first : W::P;
  em.bq = smem;
  em.red = em.bq + W::P * K * W::BQ;
  em.state = em.red + kLanes * kRedStride;
  const size_t plane = (size_t)nb * T;   // class stride of a (K, nb, T)
  const auto z_of = [&](int b) { return obs + (size_t)(em.first + b) * M * T; };
  const auto fm_of = [&](int b) -> const float* {
    const int j = em.first + b;
    return fm == nullptr ? nullptr : fm + (j / F) * fm_ls + (j % F) * fm_fs;
  };
  const auto at = [&](int b) { return (size_t)(em.first + b) * T; };
  int gb, gc, gr;
  bool gactive;
  em.group(gb, gc, gr, gactive);

  // max(sum fm, 1) and alpha = 1 / K a bin
#pragma unroll 1
  for (int b = 0; b < em.bins; ++b) {
    const float* f = fm_of(b);
    float part[1] = {0.0f};
    for (int t = lane; t < T; t += kLanes)
      part[0] += f == nullptr ? 1.0f : f[t * fm_ts];
    float* st = em.state + b * W::NS;
    sum_lanes(part, em.red, st + W::NV + K, lane);
    if (lane == 0) {
      st[W::NV + K] = fmaxf(st[W::NV + K], 1.0f);
#pragma unroll
      for (int c = 0; c < K; ++c) st[W::NV + c] = 1.0f / K;
    }
    __syncwarp();
  }
  EM_PHASE(3);

  float part[W::NV];
  if (K == 2 && higuchi) {
    // class 0: sum_t fm z z^H / max(sum fm, 1); class 1: exactly I
#pragma unroll 1
    for (int b = 0; b < em.bins; ++b) {
      em.template pass<kSample>(b, z_of(b), fm_of(b), fm_ts, nullptr,
                                nullptr, nullptr, nullptr, 0, part);
      EM_PHASE(0);
      sum_lanes(part, em.red, em.state + b * W::NS, lane);
      EM_PHASE(1);
    }
    if (gactive && gc == 1)
      for (int e = gr; e < W::BQ; e += kGroup)
        em.bq[(gb * K + 1) * W::BQ + e] = e < M ? 1.0f : 0.0f;
    EM_PHASE(3);
    em.invert(1u, sweeps, em.state[gb * W::NS + W::NV + K], nullptr, nb);
    EM_PHASE(2);
#pragma unroll 1
    for (int b = 0; b < em.bins; ++b) {
      em.template pass<kEstep>(b, z_of(b), fm_of(b), fm_ts, nullptr, nullptr,
                               nullptr, nullptr, 0, part);
      EM_PHASE(0);
      sum_lanes(part, em.red, em.state + b * W::NS, lane);
      EM_PHASE(1);
    }
  } else {
#pragma unroll 1
    for (int b = 0; b < em.bins; ++b) {
      em.template pass<kOperands>(b, z_of(b), fm_of(b), fm_ts,
                                  gamma0 + at(b), kern0 + at(b), nullptr,
                                  nullptr, plane, part);
      EM_PHASE(0);
      sum_lanes(part, em.red, em.state + b * W::NS, lane);
      EM_PHASE(1);
    }
  }

#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    // the M-step from each bin's sums: the groups invert their classes'
    // covariances (writing them out the last time), lane 0 updates alpha
    const bool last = it == iters - 1;
    EM_PHASE(3);
    em.invert((1u << K) - 1u, sweeps, 0.0f, last ? covar : nullptr, nb);
    EM_PHASE(2);
    if (update_alpha && lane == 0) {
      for (int b = 0; b < em.bins; ++b) {
        float* st = em.state + b * W::NS;
#pragma unroll
        for (int c = 0; c < K; ++c)
          st[W::NV + c] = st[c * W::CL + W::NP + W::NO] / st[W::NV + K];
      }
    }
    __syncwarp();
    EM_PHASE(3);
#pragma unroll 1
    for (int b = 0; b < em.bins; ++b) {
      const size_t j = em.first + b;
      if (!last) {
        em.template pass<kEstep>(b, z_of(b), fm_of(b), fm_ts, nullptr,
                                 nullptr, nullptr, nullptr, 0, part);
        EM_PHASE(0);
        sum_lanes(part, em.red, em.state + b * W::NS, lane);
      } else {
        em.template pass<kLast>(b, z_of(b), fm_of(b), fm_ts, nullptr,
                                nullptr, gamma + at(b), kern + at(b), plane,
                                part);
        EM_PHASE(0);
        const float q_part[1] = {part[W::NV - 1]};
        sum_lanes(q_part, em.red, em.state + b * W::NS + W::NV - 1, lane);
      }
      EM_PHASE(1);
      if (lane == 0) q[(size_t)it * nb + j] = em.state[b * W::NS + W::NV - 1];
    }
  }
  if (lane == 0)
    for (int b = 0; b < em.bins; ++b)
#pragma unroll
      for (int c = 0; c < K; ++c)
        alpha_out[(size_t)c * nb + em.first + b] =
            em.state[b * W::NS + W::NV + c];
}

template <int M, int K>
int launch_mk(const float2* obs, const float* fm, int64_t fm_ls,
              int64_t fm_fs, int64_t fm_ts, const float* g0, const float* k0,
              float* gamma, float* kern, float* q, float2* covar,
              float* alpha, int nb, int F, int T, int iters, int cg,
              int higuchi, int update_alpha, int sweeps, cudaStream_t st) {
  constexpr int P = bins_per_warp(K);
  em_warp_kernel<M, K><<<(nb + P - 1) / P, kLanes, em_smem_bytes(M, K), st>>>(
      obs, fm, fm_ls, fm_fs, fm_ts, g0, k0, gamma, kern, q, covar, alpha, nb,
      F, T, iters, cg, higuchi, update_alpha, sweeps);
  return cudaGetLastError();
}

template <int M>
int launch_m(const float2* obs, const float* fm, int64_t fm_ls,
             int64_t fm_fs, int64_t fm_ts, const float* g0, const float* k0,
             float* gamma, float* kern, float* q, float2* covar, float* alpha,
             int nb, int F, int T, int K, int iters, int cg, int higuchi,
             int update_alpha, int sweeps, cudaStream_t st) {
  switch (K) {
#define CASE(kk)                                                          \
  case kk:                                                                \
    return launch_mk<M, kk>(obs, fm, fm_ls, fm_fs, fm_ts, g0, k0, gamma,  \
                            kern, q, covar, alpha, nb, F, T, iters, cg,   \
                            higuchi, update_alpha, sweeps, st);
    CASE(1) CASE(2) CASE(3) CASE(4)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

// The Jacobi of jacobi_regularized_inverse_group alone, kLanes / kGroup
// matrices a warp (one a lane group), for the tests: a, inv (n, M, M)
// complex64, logdet (n) f32.
template <int M>
__global__ void __launch_bounds__(kLanes)
warp_jacobi_kernel(const float2* __restrict__ a, float2* __restrict__ inv,
                   float* __restrict__ logdet, int n, int sweeps) {
  const int lane = threadIdx.x;
  const int r = lane % kGroup;
  const int idx = blockIdx.x * (kLanes / kGroup) + lane / kGroup;
  const bool active = idx < n;
  const float2* src = a + (size_t)(active ? idx : 0) * M * M;
  float2* dst = inv + (size_t)idx * M * M;
  const float ld = setk::jacobi_regularized_inverse_group<M, kGroup>(
      [&](int i, int j) { return src[i * M + j]; }, sweeps, r, active,
      [&](int i, int j, float re, float im) {
        dst[i * M + j] = make_float2(re, im);
        if (i != j) dst[j * M + i] = make_float2(re, -im);
      });
  if (active && r == 0) logdet[idx] = ld;
}

}  // namespace

// obs: (nb, m, t) complex64 (bin = l * F + f); fm: f32 at
// [l * fm_ls + f * fm_fs + t * fm_ts], or null for all frames valid;
// gamma0, kern0: (k, nb, t) f32 operands, read unless higuchi (then they
// may be null); gamma, kern: (k, nb, t) f32, the last E-step; q: (iters,
// nb) f32 per-bin Q; covar: (k, nb, m, m) complex64; alpha: (k, nb) f32.
// 1 <= m <= 8, 1 <= k <= 4, iters >= 1; higuchi needs k == 2.
extern "C" int cacgmm_em_launch(const void* obs, const void* fm,
                                int64_t fm_ls, int64_t fm_fs, int64_t fm_ts,
                                const void* gamma0, const void* kern0,
                                void* gamma, void* kern, void* q, void* covar,
                                void* alpha, int nb, int F, int t, int m,
                                int k, int iters, int cg, int higuchi,
                                int update_alpha, int sweeps, void* stream) {
  if (nb < 1 || F < 1 || nb % F != 0 || t < 1 || m < 1 || m > 8 || k < 1 ||
      k > 4 || iters < 1 || sweeps < 0 || (higuchi && k != 2) ||
      (!higuchi && (gamma0 == nullptr || kern0 == nullptr)))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto o = static_cast<const float2*>(obs);
  auto f = static_cast<const float*>(fm);
  auto g0 = static_cast<const float*>(gamma0);
  auto k0 = static_cast<const float*>(kern0);
  auto g = static_cast<float*>(gamma);
  auto kn = static_cast<float*>(kern);
  auto qq = static_cast<float*>(q);
  auto cv = static_cast<float2*>(covar);
  auto al = static_cast<float*>(alpha);
  switch (m) {
#define CASE(mm)                                                            \
  case mm:                                                                  \
    return launch_m<mm>(o, f, fm_ls, fm_fs, fm_ts, g0, k0, g, kn, qq, cv,   \
                        al, nb, F, t, k, iters, cg, higuchi, update_alpha,  \
                        sweeps, st);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

// The launch's layout (no launch): out[0] bins a warp, out[1] lanes a
// class's Jacobi, out[2] a warp's (a block's) dynamic shared bytes.
extern "C" int cacgmm_em_layout(int m, int k, int* out) {
  if (m < 1 || m > 8 || k < 1 || k > 4) return cudaErrorInvalidValue;
  out[0] = bins_per_warp(k);
  out[1] = kGroup;
  out[2] = em_smem_bytes(m, k);
  return cudaSuccess;
}

// a, inv: (n, m, m) complex64; logdet: (n) f32.  1 <= m <= 8, sweeps >= 0.
extern "C" int warp_jacobi_launch(const void* a, void* inv, void* logdet,
                                  int n, int m, int sweeps, void* stream) {
  if (n < 1 || m < 1 || m > 8 || sweeps < 0) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto src = static_cast<const float2*>(a);
  auto dst = static_cast<float2*>(inv);
  auto ld = static_cast<float*>(logdet);
  constexpr int per_warp = kLanes / kGroup;
  const int grid = (n + per_warp - 1) / per_warp;
  switch (m) {
#define CASE(mm)                                                             \
  case mm:                                                                   \
    warp_jacobi_kernel<mm><<<grid, kLanes, 0, st>>>(src, dst, ld, n,   \
                                                    sweeps);               \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

#ifdef SETK_EM_PHASES
// the phase counters of the instrumented build: read (4 values) and zero
extern "C" int em_phase_read(unsigned long long* out) {
  int err = cudaMemcpyFromSymbol(out, g_em_phase, 4 * 8);
  if (err != cudaSuccess) return err;
  const unsigned long long zero[4] = {0, 0, 0, 0};
  return cudaMemcpyToSymbol(g_em_phase, zero, 4 * 8);
}
#endif
