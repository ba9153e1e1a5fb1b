// Kernels 20 and 21 (sm_90a): the bidirectional LSTM recurrence over a whole
// sequence, forward and BPTT, one launch a layer.
//
// Kernel 20 replaces setk_tpu/ops/pallas/lstm_seq.py _forward (:130, body
// _fwd_kernel :66).  xg_f / xg_b (T, B, 4H) f32 are the time-parallel input
// projections (gates ordered i | f | g | o), both in natural time order;
// W_h (H, 4H) f32 or bf16.  Per direction, starting from h = c = 0:
//   gates = xg[t] + round_W(h) W_h   (f32 sums)
//   c = sig(f) c + sig(i) tanh(g),   h = sig(o) tanh(c)
// with t ascending for the forward direction and T-1 .. 0 for the backward
// one.  h_t and c_t (T, B, H) f32 are written in natural time order, so the
// backward direction's h_t is its state after consuming frames T-1 .. t.
// round_W rounds h to the weight's type (round to nearest even for bf16),
// where the JAX package's _rec_matmul and the TPU kernel round it.  It has
// two variants with one contract and one C entry point each; the wrapper
// (ops/cuda/lstm_seq.py forward_variant) picks one from B, H, the weight
// type, the SM count and the shared memory a block may use:
//
// lstm_fwd_resident_kernel, the rule: a cooperative grid of one block an SM
// (256 threads), half the blocks a direction.  A block owns a contiguous
// slice of u = ceil(H / (SMs / 2)) hidden units (8 at H = 512 on 132 SMs;
// the last busy block's slice ragged, blocks past H idle) with their four
// gate columns j, H + j, 2H + j, 3H + j, copies that (H x 4u) slice of W_h
// into shared memory once (32 KB in bf16 at H = 512, 128 KB at H = 1024)
// and keeps it there for all T steps.  A step reads the whole
// processing-order previous h of its direction (B x H, written by every
// block of the direction at the step before, read back from the h output
// at frame t -/+ 1 with loads that bypass L1, rounded to W's type as they
// land in a shared tile of up to `rows` batch rows), forms its 4u gate
// columns for the tile's rows on the CUDA cores (a thread owns one unit's
// four gates for up to 8 rows and one of up to 16 shares of k, 16 k a
// share at least; the shares' partial sums are added in shared memory, in
// the tile's own space), runs the gate math for its (unit, row) pairs,
// writes h_t and c_t, and meets the grid at one grid.sync() a step, which
// orders those writes before the next step's reads.  c_prev comes back
// from the c output at the neighbouring frame the same way; a thread's
// first gate inputs are loaded at the step's start and the next step's
// gates are prefetched into L2 before the barrier.  Where the slice and one
// tile do not fit (f32 W_h above H = 891 on 132 SMs; any H whose slice
// exceeds 256 units) the stream variant runs.
//
// lstm_fwd_stream_kernel: a block owns one direction and a tile of kRows =
// 4 batch rows (grid (ceil(B / 4), 2), any B >= 1, the last tile ragged)
// and loops over T inside; thread j owns hidden unit j (H <= 1024 threads)
// and its four gate columns for the tile's rows, so the cell carry and the
// gate math stay in its registers.  A step streams the whole of W_h (2 MB a
// direction in bf16 at H = 512, L2-resident) once for the tile's 4 rows.
//
// Kernel 21, lstm_bwd_kernel, replaces lstm_seq.py _backward (:159, body
// _bwd_kernel :92): each direction walks the reverse of its processing
// order, recomputes the gates from xg[t] and the processing-order previous
// state h_prev (rounded as in the forward pass), read from the saved
// states at the neighbouring frame (t - 1 for the forward direction, t + 1
// for the backward one, zero at the direction's first frame), runs the
// chain of
// _bwd_kernel :110-121 with dh = dy + dh_carry and the cell carry dc in
// registers, writes dxg[t] (T, B, 4H) f32 and carries
// dh = round_W(dgates) W_h^T into the next step.  dW_h = h_prev^T dxg over
// T B is one matrix product outside the kernel, as on the TPU.  Its layout
// is the stream variant's: shared memory holds the rounded recurrent
// operand, k-major with the 4 rows adjacent so one 16-byte broadcast load
// serves a k: h_prev and the (4 x 4H) rounded dgates (40 KB at H = 512, 80
// KB at H = 1024, which opts in to dynamic shared memory above 48 KB).  Two
// barriers a step.
//
// Bound on the card, at the BLSTM bench shape (T = 400, B = 64, H = 512):
// kernel 20 reads 419 MB of gates and writes 210 MB of states (~0.19 ms at
// 3.35 TB/s) and does 107 GFLOP of recurrent products (bf16 operands, f32
// sums); kernel 21 moves 1.16 GB (~0.35 ms: dy, h and c of each direction,
// the gates read and their gradients written) for twice the products.
// Neither is near it: the recurrence is 400 steps in sequence.  The stream
// variant's step is one SM's read of all 2 MB of W_h from L2 on 32 of 132
// SMs; the resident variant's step is a block's 1 M multiply-adds (B = 64,
// u = 8) on one SM's 128 f32 lanes, its read of h (128 KB from L2) and the
// grid barrier: ~15 us on an H100 (SXM, 700 W), of which the product
// ~7.6, the read of h ~3.9 (L2 bandwidth, all SMs at once) and the
// barrier with its wait for the slowest block ~1.8; ~3.7 us at B = 1 and
// ~3.1 at H = 8, the floor of a step's barrier and loads
// (tools/lstm_phase_profile.py).  The step's product on the tensor cores, and
// kernel 21 on the resident design, are next (ROADMAP queue 2).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <type_traits>

namespace {

constexpr int kRows = 4;        // batch rows a block (stream, kernel 21)
constexpr int kMaxHidden = 1024;
constexpr int kResThreads = 256;  // threads of a resident block
constexpr int kResRows = 8;       // batch rows of a resident thread's tile
constexpr int kMaxSplit = 16;     // shares of k a resident item, at most
constexpr int kMaxDevices = 64;

// The recurrent weight's element type: f32, or bf16 as its raw 16 bits.
struct F32 {
  using T = float;
  __device__ static float widen(float w) { return w; }
  __device__ static float round(float x) { return x; }
  // four consecutive weights (16-byte aligned), widened
  __device__ static void load4(const float* p, float (&w)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
};

struct BF16 {
  using T = uint16_t;
  __device__ static float widen(uint16_t w) {
    return __uint_as_float((uint32_t)w << 16);
  }
  // round to nearest, ties to even, as torch and JAX convert f32 to bf16
  __device__ static float round(float x) {
    uint32_t u = __float_as_uint(x);
    if ((u & 0x7fffffffu) > 0x7f800000u) return x;  // NaN stays NaN
    u += 0x7fffu + ((u >> 16) & 1u);
    return __uint_as_float(u & 0xffff0000u);
  }
  // four consecutive weights (8-byte aligned), widened
  __device__ static void load4(const uint16_t* p, float (&w)[4]) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = __uint_as_float(v.x << 16);
    w[1] = __uint_as_float(v.x & 0xffff0000u);
    w[2] = __uint_as_float(v.y << 16);
    w[3] = __uint_as_float(v.y & 0xffff0000u);
  }
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// acc[r][g] += sum_k op[k][r] W[k][g H + j]: op is the block's rounded
// (H x kRows) operand in shared memory, k-major.
template <typename W>
__device__ __forceinline__ void rec_product(const float* op,
                                            const typename W::T* wh, int h,
                                            int j, float (&acc)[kRows][4]) {
  const typename W::T* col = wh + j;
#pragma unroll 4
  for (int k = 0; k < h; ++k) {
    const typename W::T* row = col + (size_t)k * 4 * h;
    const float w0 = W::widen(row[0]), w1 = W::widen(row[h]);
    const float w2 = W::widen(row[2 * h]), w3 = W::widen(row[3 * h]);
    const float4 v = reinterpret_cast<const float4*>(op)[k];
    const float x[kRows] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      acc[r][0] = fmaf(x[r], w0, acc[r][0]);
      acc[r][1] = fmaf(x[r], w1, acc[r][1]);
      acc[r][2] = fmaf(x[r], w2, acc[r][2]);
      acc[r][3] = fmaf(x[r], w3, acc[r][3]);
    }
  }
}

// The gate pre-activations of the tile's rows at frame t: xg[t] + op W_h.
template <typename W>
__device__ __forceinline__ void gates(const float* xg, const float* op,
                                      const typename W::T* wh, int t, int b,
                                      int b0, int nr, int h, int j,
                                      float (&acc)[kRows][4]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float* x = xg + ((size_t)t * b + b0 + r) * 4 * h + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[r][g] = r < nr ? x[g * h] : 0.0f;
  }
  rec_product<W>(op, wh, h, j, acc);
}

template <typename W>
__global__ void __launch_bounds__(kMaxHidden)
lstm_fwd_stream_kernel(const float* __restrict__ xgf,
                       const float* __restrict__ xgb,
                       const typename W::T* __restrict__ whf,
                       const typename W::T* __restrict__ whb,
                       float* __restrict__ hsf, float* __restrict__ csf,
                       float* __restrict__ hsb, float* __restrict__ csb,
                       int t_len, int b, int h) {
  extern __shared__ float smem[];
  float* hs = smem;  // (H, kRows): round_W(h), k-major
  const int dir = blockIdx.y, j = threadIdx.x;
  const float* xg = dir ? xgb : xgf;
  const typename W::T* wh = dir ? whb : whf;
  float* hs_out = dir ? hsb : hsf;
  float* cs_out = dir ? csb : csf;
  const int b0 = blockIdx.x * kRows;
  const int nr = min(kRows, b - b0);
  float c[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    c[r] = 0.0f;
    hs[j * kRows + r] = 0.0f;
  }
  __syncthreads();
  for (int s = 0; s < t_len; ++s) {
    const int t = dir ? t_len - 1 - s : s;
    float acc[kRows][4];
    gates<W>(xg, hs, wh, t, b, b0, nr, h, j, acc);
    __syncthreads();  // every thread has read hs
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= nr) continue;
      const float gi = sigmoid(acc[r][0]), gf = sigmoid(acc[r][1]);
      const float gg = tanhf(acc[r][2]), go = sigmoid(acc[r][3]);
      c[r] = gf * c[r] + gi * gg;
      const float hn = go * tanhf(c[r]);
      hs[j * kRows + r] = W::round(hn);
      const size_t o = ((size_t)t * b + b0 + r) * h + j;
      hs_out[o] = hn;
      cs_out[o] = c[r];
    }
    __syncthreads();  // the new h is in place
  }
}

template <typename W>
__global__ void __launch_bounds__(kMaxHidden)
lstm_bwd_kernel(const float* __restrict__ dyf, const float* __restrict__ dyb,
                const float* __restrict__ xgf, const float* __restrict__ xgb,
                const float* __restrict__ hsf, const float* __restrict__ hsb,
                const float* __restrict__ csf, const float* __restrict__ csb,
                const typename W::T* __restrict__ whf,
                const typename W::T* __restrict__ whb,
                const typename W::T* __restrict__ wtf,
                const typename W::T* __restrict__ wtb,
                float* __restrict__ dxf, float* __restrict__ dxb, int t_len,
                int b, int h) {
  extern __shared__ float smem[];
  float* hp_s = smem;               // (H, kRows): round_W(h_prev)
  float* dg_s = smem + h * kRows;   // (4H, kRows): round_W(dgates)
  const int dir = blockIdx.y, j = threadIdx.x, h4 = 4 * h;
  const float* dy = dir ? dyb : dyf;
  const float* xg = dir ? xgb : xgf;
  const float* hs = dir ? hsb : hsf;
  const float* cs = dir ? csb : csf;
  const typename W::T* wh = dir ? whb : whf;
  const typename W::T* wt = dir ? wtb : wtf;
  float* dx = dir ? dxb : dxf;
  const int b0 = blockIdx.x * kRows;
  const int nr = min(kRows, b - b0);
  float dh[kRows], dc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    dh[r] = 0.0f;
    dc[r] = 0.0f;
#pragma unroll
    for (int g = 0; g < 4; ++g) dg_s[(g * h + j) * kRows + r] = 0.0f;
  }
  for (int s = 0; s < t_len; ++s) {
    // the reverse of the direction's processing order
    const int t = dir ? s : t_len - 1 - s;
    // the processing-order previous frame; none at the direction's first
    const int tp = dir ? t + 1 : t - 1;
    const bool has_prev = dir ? t < t_len - 1 : t > 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      hp_s[j * kRows + r] =
          r < nr && has_prev
              ? W::round(hs[((size_t)tp * b + b0 + r) * h + j])
              : 0.0f;
    __syncthreads();  // h_prev in place; every thread has read dg_s
    float acc[kRows][4];
    gates<W>(xg, hp_s, wh, t, b, b0, nr, h, j, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= nr) continue;
      const size_t o = ((size_t)t * b + b0 + r) * h + j;
      const float gi = sigmoid(acc[r][0]), gf = sigmoid(acc[r][1]);
      const float gg = tanhf(acc[r][2]), go = sigmoid(acc[r][3]);
      const float tc = tanhf(cs[o]);
      const float dhh = dy[o] + dh[r];
      const float d_o = dhh * tc * go * (1.0f - go);
      const float dcc = dc[r] + dhh * go * (1.0f - tc * tc);
      const float d_i = dcc * gg * gi * (1.0f - gi);
      const float d_g = dcc * gi * (1.0f - gg * gg);
      const float cp =
          has_prev ? cs[((size_t)tp * b + b0 + r) * h + j] : 0.0f;
      const float d_f = dcc * cp * gf * (1.0f - gf);
      dc[r] = dcc * gf;
      float* d = dx + ((size_t)t * b + b0 + r) * h4 + j;
      d[0] = d_i;
      d[h] = d_f;
      d[2 * h] = d_g;
      d[3 * h] = d_o;
      dg_s[j * kRows + r] = W::round(d_i);
      dg_s[(h + j) * kRows + r] = W::round(d_f);
      dg_s[(2 * h + j) * kRows + r] = W::round(d_g);
      dg_s[(3 * h + j) * kRows + r] = W::round(d_o);
    }
    __syncthreads();  // dgates in place
    // dh_carry[r][j] = sum_m round_W(dgates)[r][m] W_h^T[m][j]
#pragma unroll
    for (int r = 0; r < kRows; ++r) dh[r] = 0.0f;
    const typename W::T* col = wt + j;
#pragma unroll 4
    for (int m = 0; m < h4; ++m) {
      const float w = W::widen(col[(size_t)m * h]);
      const float4 v = reinterpret_cast<const float4*>(dg_s)[m];
      dh[0] = fmaf(v.x, w, dh[0]);
      dh[1] = fmaf(v.y, w, dh[1]);
      dh[2] = fmaf(v.z, w, dh[2]);
      dh[3] = fmaf(v.w, w, dh[3]);
    }
  }
}

// ---- kernel 20, resident variant ----

// The resident variant's shape on a device: blocks a direction, the units a
// block owns at most, the f32 row stride of the h tile, its rows, and the
// dynamic shared memory (the W_h slice, then the h tile, which the
// partial sums reuse).  ops/cuda/lstm_seq.py resident_layout is the same
// arithmetic; false where the variant does not fit.
struct ResidentLayout {
  int per_dir, units, stride, rows;
  size_t w_bytes, bytes;
};

bool resident_layout(int b, int h, int w_size, int sms, size_t smem,
                     ResidentLayout* l) {
  const int per_dir = sms / 2;
  if (per_dir < 1) return false;
  const int u = (h + per_dir - 1) / per_dir;
  if (u > kResThreads) return false;
  const size_t w_bytes = ((size_t)h * 4 * u * w_size + 15) / 16 * 16;
  // a multiple of 4 floats with an odd count of 16-byte groups, so that a
  // float4 of 8 consecutive rows falls in 8 distinct bank groups
  int stride = (h + 3) / 4 * 4;
  if ((stride / 4) % 2 == 0) stride += 4;
  const size_t row_bytes = sizeof(float) * stride;
  const size_t red_bytes = sizeof(float) * kResThreads * kResRows * 4;
  if (w_bytes + red_bytes > smem) return false;
  const size_t rows_mem = (smem - w_bytes) / row_bytes;
  const size_t rows_thr = (size_t)kResRows * (kResThreads / u);
  const int rows = (int)std::min<size_t>((size_t)b,
                                         std::min(rows_mem, rows_thr));
  if (rows < 1) return false;
  l->per_dir = per_dir;
  l->units = u;
  l->stride = stride;
  l->rows = rows;
  l->w_bytes = w_bytes;
  l->bytes = w_bytes + std::max((size_t)rows * row_bytes, red_bytes);
  return true;
}

// acc[i][g] += sum_{k0 <= k < k1} hs[row_i][k] ws[k][jj][g] for the
// thread's first NR of 8 rows, row_i = rg + i gr (clamped to the tile for
// the loads; those sums are not used): hs the rounded h tile (rows x
// stride f32), ws the block's W_h slice (H x u x 4, W's type).  k0 is a
// multiple of 4.  NR < 8 where the tile has fewer than 8 row groups' rows
// (B < 8), so that a small batch does not pay for 8 rows.
template <typename W, int NR>
__device__ __forceinline__ void resident_product(
    const typename W::T* ws, const float* hs, int stride, int u, int jj,
    int rg, int gr, int rows, int k0, int k1,
    float (&acc)[kResRows][4]) {
  int off[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i)
    off[i] = min(rg + i * gr, rows - 1) * stride;
  int k = k0;
#pragma unroll 2
  for (; k + 4 <= k1; k += 4) {
    float w[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      W::load4(ws + ((size_t)(k + kk) * u + jj) * 4, w[kk]);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(hs + off[i] + k);
      const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          acc[i][g] = fmaf(x[kk], w[kk][g], acc[i][g]);
    }
  }
  for (; k < k1; ++k) {
    float w[4];
    W::load4(ws + ((size_t)k * u + jj) * 4, w);
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        acc[i][g] = fmaf(hs[off[i] + k], w[g], acc[i][g]);
  }
}

__device__ __forceinline__ void prefetch_l2(const float* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
#endif
}

// h_prev rows [b0, b0 + rows) of one direction at frame tp into the tile,
// rounded to W's type; L2 loads, since other blocks wrote them this launch
template <typename W>
__device__ __forceinline__ void load_h_tile(const float* src, float* hs,
                                            int stride, int rows, int h) {
  if ((h & 3) == 0) {
    const int h4 = h / 4;
    const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll 4
    for (int i = threadIdx.x; i < rows * h4; i += kResThreads) {
      const int r = i / h4, k = (i - r * h4) * 4;
      const float4 v = __ldcg(s4 + i);
      *reinterpret_cast<float4*>(hs + r * stride + k) = make_float4(
          W::round(v.x), W::round(v.y), W::round(v.z), W::round(v.w));
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < rows * h; i += kResThreads) {
      const int r = i / h;
      hs[r * stride + i - r * h] = W::round(__ldcg(src + i));
    }
  }
}

// part[0] + ... + part[N - 1] as a tree, so the adds do not wait on each
// other (N a power of 2)
template <int N>
__device__ __forceinline__ float tree_sum(float* part) {
  if constexpr (N == 1) {
    return part[0];
  } else {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) part[q] += part[q + N / 2];
    return tree_sum<N / 2>(part);
  }
}

// p[0] + p[items] + ... + p[(split - 1) items] for split <= N, the loads
// issued together
template <int N>
__device__ __forceinline__ float share_sum(const float* p, int items,
                                           int split) {
  float part[N];
#pragma unroll
  for (int q = 0; q < N; ++q) part[q] = q < split ? p[q * items] : 0.0f;
  return tree_sum<N>(part);
}

// xg[t] and c_prev of a thread's pairs q0 and q0 + kResThreads of the tile
// at b0 (clamped to the tile's last pair; those are not used): a[e][g]
// the gates' inputs, cp[e] c at the processing-order previous frame tp
__device__ __forceinline__ void gate_inputs(const float* xg,
                                            const float* cs_out, int t,
                                            int tp, bool has_prev, int b,
                                            int h, int b0, int j0, int nu,
                                            int pairs, int q0,
                                            float (&a)[2][4],
                                            float (&cp)[2]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int q = min(q0 + e * kResThreads, pairs - 1);
    const int r = q / nu, j = j0 + q % nu;
    const float* x = xg + ((size_t)t * b + b0 + r) * 4 * h + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) a[e][g] = x[g * h];
    cp[e] = has_prev ? __ldcg(cs_out + ((size_t)tp * b + b0 + r) * h + j)
                     : 0.0f;
  }
}

__device__ __forceinline__ void copy_inputs(const float (&pa)[2][4],
                                            const float (&pc)[2],
                                            float (&a)[2][4],
                                            float (&cp)[2]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    cp[e] = pc[e];
#pragma unroll
    for (int g = 0; g < 4; ++g) a[e][g] = pa[e][g];
  }
}

template <typename W>
__global__ void __launch_bounds__(kResThreads, 1)
lstm_fwd_resident_kernel(const float* __restrict__ xgf,
                         const float* __restrict__ xgb,
                         const typename W::T* __restrict__ whf,
                         const typename W::T* __restrict__ whb, float* hsf,
                         float* csf, float* hsb, float* csb, int t_len, int b,
                         int h, ResidentLayout l) {
  using T = typename W::T;
  extern __shared__ float smem[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int dir = blockIdx.x >= (unsigned)l.per_dir;
  const int j0 = (blockIdx.x - dir * l.per_dir) * l.units;
  const int nu = max(0, min(l.units, h - j0));   // 0: an idle block
  const int u = l.units, tid = threadIdx.x;
  const float* xg = dir ? xgb : xgf;
  const T* wh = dir ? whb : whf;
  float* hs_out = dir ? hsb : hsf;
  float* cs_out = dir ? csb : csf;
  T* ws = reinterpret_cast<T*>(smem);       // (H, u, 4): the W_h slice
  float* hs = reinterpret_cast<float*>(     // (rows, stride): round_W(h);
      reinterpret_cast<char*>(smem) + l.w_bytes);   // then partial sums
  // the slice, once: ws[k][jj][g] = W_h[k][g H + j0 + jj]
  for (int i = tid; i < h * nu * 4; i += kResThreads) {
    const int jj = i % nu, g = (i / nu) % 4, k = i / (4 * nu);
    ws[((size_t)k * u + jj) * 4 + g] =
        wh[(size_t)k * 4 * h + g * h + j0 + jj];
  }
  __syncthreads();
  for (int s = 0; s < t_len; ++s) {
    const int t = dir ? t_len - 1 - s : s;
    // the processing-order previous frame, written at step s - 1
    const int tp = dir ? t + 1 : t - 1;
    const bool has_prev = s > 0;
    // the gate inputs of the thread's first two pairs, loaded now so that
    // their latency hides behind the first tile's product
    float pa[2][4], pc[2];
    if (nu > 0)
      gate_inputs(xg, cs_out, t, tp, has_prev, b, h, 0, j0, nu,
                  nu * min(l.rows, b), tid, pa, pc);
    for (int b0 = 0; nu > 0 && b0 < b; b0 += l.rows) {
      const int rows = min(l.rows, b - b0);
      const int gr = (rows + kResRows - 1) / kResRows;  // row groups
      const int items = nu * gr;                 // (unit, row group) pairs
      // shares of k an item: as many as keep every thread busy, at most 16
      // and 16 k a share at least
      const int split =
          min(min(kResThreads / items, kMaxSplit), max(1, (h + 15) / 16));
      const int slots = (rows + gr - 1) / gr;    // rows a thread holds
      const int na = split * items;              // threads with a share
      if (has_prev) {
        load_h_tile<W>(hs_out + ((size_t)tp * b + b0) * h, hs, l.stride,
                       rows, h);
        __syncthreads();
        const int item = tid % items, ks = tid / items;
        float acc[kResRows][4] = {};
        if (ks < split) {
          const int chunk = ((h + split - 1) / split + 3) & ~3;
          const int k0 = min(h, ks * chunk), k1 = min(h, k0 + chunk);
          const int jj = item % nu, rg = item / nu;
          if (slots > 4)
            resident_product<W, 8>(ws, hs, l.stride, u, jj, rg, gr, rows, k0,
                                   k1, acc);
          else if (slots > 2)
            resident_product<W, 4>(ws, hs, l.stride, u, jj, rg, gr, rows, k0,
                                   k1, acc);
          else if (slots > 1)
            resident_product<W, 2>(ws, hs, l.stride, u, jj, rg, gr, rows, k0,
                                   k1, acc);
          else
            resident_product<W, 1>(ws, hs, l.stride, u, jj, rg, gr, rows, k0,
                                   k1, acc);
        }
        __syncthreads();   // every thread has read the tile
        if (ks < split) {
          // partial sums over the tile's space, value-major: value (slot
          // i, gate g) of thread tid = ks items + item at
          // [(4 i + g) na + tid], so that a warp's stores hit 32 banks
#pragma unroll
          for (int i = 0; i < kResRows; ++i)
            if (i < slots)
#pragma unroll
              for (int g = 0; g < 4; ++g)
                hs[(i * 4 + g) * na + tid] = acc[i][g];
        }
        __syncthreads();
        if (split > 1) {
          // each (value, item) summed over its shares into share 0's place
          const int n = slots * 4 * items;
#pragma unroll 2
          for (int v = tid; v < n; v += kResThreads) {
            const int c = v / items;
            float* p = hs + c * na + (v - c * items);
            p[0] = split <= 4 ? share_sum<4>(p, items, split)
                              : share_sum<kMaxSplit>(p, items, split);
          }
          __syncthreads();
        }
      }
      // the gate math of the tile's (unit, row) pairs, two a thread at a
      // time; the first two were loaded at the step's start
      const int pairs = nu * rows;
      for (int q0 = tid; q0 < pairs; q0 += 2 * kResThreads) {
        float a[2][4], cp[2];
        if (b0 == 0 && q0 == tid)
          copy_inputs(pa, pc, a, cp);
        else
          gate_inputs(xg, cs_out, t, tp, has_prev, b, h, b0, j0, nu, pairs,
                      q0, a, cp);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = q0 + e * kResThreads;
          if (q >= pairs) break;
          const int jj = q % nu, r = q / nu;
          if (has_prev) {
            const float* sum = hs + (r / gr) * 4 * na + (r % gr) * nu + jj;
#pragma unroll
            for (int g = 0; g < 4; ++g) a[e][g] += sum[g * na];
          }
          const float gi = sigmoid(a[e][0]), gf = sigmoid(a[e][1]);
          const float gg = tanhf(a[e][2]), go = sigmoid(a[e][3]);
          const float c = gf * cp[e] + gi * gg;
          const size_t o = ((size_t)t * b + b0 + r) * h + j0 + jj;
          hs_out[o] = go * tanhf(c);
          cs_out[o] = c;
        }
      }
      __syncthreads();   // the tile's space is free for the next tile
    }
    if (nu > 0 && s + 1 < t_len) {
      // the next step's gates of the block's units, into L2 during the
      // barrier
      const int tn = dir ? t - 1 : t + 1;
      for (int q = tid; q < b * 4; q += kResThreads) {
        const float* x =
            xg + ((size_t)tn * b + q / 4) * 4 * h + (q % 4) * h + j0;
        prefetch_l2(x);
        prefetch_l2(x + nu - 1);
      }
    }
    grid.sync();   // h_t and c_t of every block before step s + 1 reads
  }
}

// SM count and the shared memory a block may opt in to, per device, read
// once; and the largest dynamic shared memory at which a resident instance
// was found co-resident (one block an SM), per device.
struct DeviceLimits {
  int sms = 0, smem = 0;
  size_t fits[2] = {0, 0};   // F32, BF16
};
DeviceLimits g_limits[kMaxDevices];
std::mutex g_limits_mutex;

int device_limits(int* dev, DeviceLimits* out) {
  int err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 0 || *dev >= kMaxDevices) return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(g_limits_mutex);
  DeviceLimits& d = g_limits[*dev];
  if (d.sms == 0) {
    int sms = 0, smem = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 *dev);
    if (err != cudaSuccess) return err;
    d.sms = sms;
    d.smem = smem;
  }
  *out = d;
  return cudaSuccess;
}

template <typename W>
int fwd_resident(const void* xgf, const void* xgb, const void* whf,
                 const void* whb, void* hsf, void* csf, void* hsb, void* csb,
                 int t_len, int b, int h, cudaStream_t st) {
  using T = typename W::T;
  const int wi = sizeof(T) == 2;
  int dev = 0;
  DeviceLimits lim;
  int err = device_limits(&dev, &lim);
  if (err != cudaSuccess) return err;
  ResidentLayout l;
  if (!resident_layout(b, h, sizeof(T), lim.sms, lim.smem, &l))
    return cudaErrorInvalidValue;
  auto kernel = lstm_fwd_resident_kernel<W>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)l.bytes);
  if (err != cudaSuccess) return err;
  if (l.bytes > lim.fits[wi]) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kResThreads, l.bytes);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    std::lock_guard<std::mutex> lock(g_limits_mutex);
    g_limits[dev].fits[wi] = std::max(g_limits[dev].fits[wi], l.bytes);
  }
  const float* xf = static_cast<const float*>(xgf);
  const float* xb = static_cast<const float*>(xgb);
  const T* wf = static_cast<const T*>(whf);
  const T* wb = static_cast<const T*>(whb);
  float* hf = static_cast<float*>(hsf);
  float* cf = static_cast<float*>(csf);
  float* hb = static_cast<float*>(hsb);
  float* cb = static_cast<float*>(csb);
  void* args[] = {&xf, &xb, &wf, &wb, &hf, &cf, &hb, &cb, &t_len, &b, &h, &l};
  // the kernel's type named, so that the runtime's template takes the
  // function pointer
  using K = std::remove_pointer_t<decltype(kernel)>;
  err = cudaLaunchCooperativeKernel<K>(kernel, dim3(2 * l.per_dir),
                                       dim3(kResThreads), args, l.bytes, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename K>
int opt_in(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename W>
int fwd(const void* xgf, const void* xgb, const void* whf, const void* whb,
        void* hsf, void* csf, void* hsb, void* csb, int t_len, int b, int h,
        cudaStream_t st) {
  using T = typename W::T;
  const size_t bytes = sizeof(float) * kRows * h;
  int err = opt_in(lstm_fwd_stream_kernel<W>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((b + kRows - 1) / kRows, 2);
  lstm_fwd_stream_kernel<W><<<grid, h, bytes, st>>>(
      static_cast<const float*>(xgf), static_cast<const float*>(xgb),
      static_cast<const T*>(whf), static_cast<const T*>(whb),
      static_cast<float*>(hsf), static_cast<float*>(csf),
      static_cast<float*>(hsb), static_cast<float*>(csb), t_len, b, h);
  return cudaGetLastError();
}

template <typename W>
int bwd(const void* const* in, const void* whf, const void* whb,
        const void* wtf, const void* wtb, void* dxf, void* dxb, int t_len,
        int b, int h, cudaStream_t st) {
  using T = typename W::T;
  const size_t bytes = sizeof(float) * kRows * 5 * h;
  int err = opt_in(lstm_bwd_kernel<W>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((b + kRows - 1) / kRows, 2);
  auto f = [&](int i) { return static_cast<const float*>(in[i]); };
  lstm_bwd_kernel<W><<<grid, h, bytes, st>>>(
      f(0), f(1), f(2), f(3), f(4), f(5), f(6), f(7),
      static_cast<const T*>(whf), static_cast<const T*>(whb),
      static_cast<const T*>(wtf), static_cast<const T*>(wtb),
      static_cast<float*>(dxf), static_cast<float*>(dxb), t_len, b, h);
  return cudaGetLastError();
}

bool bad_shape(int t_len, int b, int h) {
  return t_len < 1 || b < 1 || h < 1 || h > kMaxHidden;
}

}  // namespace

// Kernel 20's two variants, one contract: xgf, xgb: (T, B, 4H) f32; whf,
// whb: (H, 4H) f32, or bf16 bits with `bf16`; hsf, csf, hsb, csb: (T, B,
// H) f32.  1 <= H <= 1024, B, T >= 1.
extern "C" int lstm_fwd_stream_launch(const void* xgf, const void* xgb,
                                      const void* whf, const void* whb,
                                      void* hsf, void* csf, void* hsb,
                                      void* csb, int t_len, int b, int h,
                                      int bf16, void* stream) {
  if (bad_shape(t_len, b, h)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return fwd<BF16>(xgf, xgb, whf, whb, hsf, csf, hsb, csb, t_len, b, h,
                     st);
  return fwd<F32>(xgf, xgb, whf, whb, hsf, csf, hsb, csb, t_len, b, h, st);
}

// The resident variant also needs its slice and one h tile to fit the
// current device (resident_layout) and the grid to be co-resident; it
// returns an error where either fails, and launches nothing.
extern "C" int lstm_fwd_resident_launch(const void* xgf, const void* xgb,
                                        const void* whf, const void* whb,
                                        void* hsf, void* csf, void* hsb,
                                        void* csb, int t_len, int b, int h,
                                        int bf16, void* stream) {
  if (bad_shape(t_len, b, h)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return fwd_resident<BF16>(xgf, xgb, whf, whb, hsf, csf, hsb, csb, t_len,
                              b, h, st);
  return fwd_resident<F32>(xgf, xgb, whf, whb, hsf, csf, hsb, csb, t_len, b,
                           h, st);
}

// out[0]: the current device's SM count, out[1]: the shared memory a block
// may opt in to, in bytes; what the resident variant is laid out for.
extern "C" int lstm_device_limits(int* out) {
  int dev = 0;
  DeviceLimits lim;
  const int err = device_limits(&dev, &lim);
  if (err != cudaSuccess) return err;
  out[0] = lim.sms;
  out[1] = lim.smem;
  return cudaSuccess;
}

// dyf, dyb, hsf, hsb, csf, csb: (T, B, H) f32, hs / cs the states kernel 20
// wrote; xgf, xgb, dxf, dxb: (T, B, 4H) f32; whf, whb: (H, 4H) and wtf,
// wtb: (4H, H), f32 or bf16 bits with `bf16`.
extern "C" int lstm_bwd_launch(const void* dyf, const void* dyb,
                               const void* xgf, const void* xgb,
                               const void* hsf, const void* hsb,
                               const void* csf, const void* csb,
                               const void* whf, const void* whb,
                               const void* wtf, const void* wtb, void* dxf,
                               void* dxb, int t_len, int b, int h, int bf16,
                               void* stream) {
  if (bad_shape(t_len, b, h)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const void* in[8] = {dyf, dyb, xgf, xgb, hsf, hsb, csf, csb};
  if (bf16)
    return bwd<BF16>(in, whf, whb, wtf, wtb, dxf, dxb, t_len, b, h, st);
  return bwd<F32>(in, whf, whb, wtf, wtb, dxf, dxb, t_len, b, h, st);
}
