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
// Kernel 21 replaces lstm_seq.py _backward (:159, body _bwd_kernel :92):
// each direction walks the reverse of its processing order, recomputes the
// gates from xg[t] and the processing-order previous state h_prev (rounded
// as in the forward pass), read from the saved states at the neighbouring
// frame (t - 1 for the forward direction, t + 1 for the backward one, zero
// at the direction's first frame), runs the chain of _bwd_kernel :110-121
// with dh = dy + dh_carry and the cell carry dc, writes dxg[t] (T, B, 4H)
// f32 and carries dh = round_W(dgates) W_h^T into the next step.  dW_h =
// h_prev^T dxg over T B is one matrix product outside the kernel, as on the
// TPU.  Two variants, one contract and one C entry point each; the wrapper
// (ops/cuda/lstm_seq.py backward_variant) picks one as kernel 20's does:
//
// lstm_bwd_resident_kernel, the rule: kernel 20's cooperative grid, a block
// a slice of u units, in two phases.  The gate recompute depends only on
// kernel 20's saved states, so phase 1 does it for every frame at once,
// off the serial chain, with the block's (H x 4u) column slice of W_h in
// shared memory, and parks the gates in the block's own columns of dx.
// Phase 2 holds the (u x 4H) row slice (W_h^T's columns for the block's
// units, 32 KB in bf16 at H = 512, 128 KB at H = 1024) and walks the steps:
// each reads the previous step's rounded dgates of all blocks (B x 4H of
// W's type, from a ping-pong exchange in global memory, through L2),
// forms dh for its units on the CUDA cores, runs the chain and meets the
// grid at one grid.sync().  Where the slices, the dc carry (B x u f32) and
// a tile do not fit (f32 W_h above H = 792 on 132 SMs; a very large B) the
// stream variant runs.
//
// lstm_bwd_stream_kernel, the first design: the layout of kernel 20's stream
// variant; shared memory holds the rounded recurrent operand, k-major with
// the 4 rows adjacent so one 16-byte broadcast load serves a k: h_prev and
// the (4 x 4H) rounded dgates (40 KB at H = 512, 80 KB at H = 1024, which
// opts in to dynamic shared memory above 48 KB); a step streams all of W_h
// and W_h^T from L2, with two block barriers.
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
// (tools/lstm_phase_profile.py).  Kernel 21's resident step has the same
// product (K = 4H, 4 units a thread in place of 4 gates) and reads twice
// the bytes (the dgates in bf16); its phase 1 is T of kernel 20's products
// with no barrier between them.  The step's products on the tensor cores
// are next (ROADMAP queue 2).

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
  // x rounded to this type, in its storage
  __device__ static float pack(float x) { return x; }
  // values a 16-byte load brings
  static constexpr int kVec = 4;
  // kVec consecutive values from global memory through L2, widened into
  // dst (16-byte aligned)
  __device__ static void copy_cg(const float* src, float* dst) {
    *reinterpret_cast<float4*>(dst) =
        __ldcg(reinterpret_cast<const float4*>(src));
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
  __device__ static uint16_t pack(float x) {
    return (uint16_t)(__float_as_uint(round(x)) >> 16);
  }
  static constexpr int kVec = 8;
  __device__ static void copy_cg(const uint16_t* src, float* dst) {
    const uint4 v = __ldcg(reinterpret_cast<const uint4*>(src));
    *reinterpret_cast<float4*>(dst) = widen2(v.x, v.y);
    *reinterpret_cast<float4*>(dst + 4) = widen2(v.z, v.w);
  }
  // four values (8-byte aligned), where a row's 16-byte alignment fails
  __device__ static void copy4_cg(const uint16_t* src, float* dst) {
    const uint2 v = __ldcg(reinterpret_cast<const uint2*>(src));
    *reinterpret_cast<float4*>(dst) = widen2(v.x, v.y);
  }
  // the four bf16 values of two 32-bit words, widened
  __device__ static float4 widen2(uint32_t a, uint32_t b) {
    return make_float4(__uint_as_float(a << 16),
                       __uint_as_float(a & 0xffff0000u),
                       __uint_as_float(b << 16),
                       __uint_as_float(b & 0xffff0000u));
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
lstm_bwd_stream_kernel(const float* __restrict__ dyf,
                       const float* __restrict__ dyb,
                       const float* __restrict__ xgf,
                       const float* __restrict__ xgb,
                       const float* __restrict__ hsf,
                       const float* __restrict__ hsb,
                       const float* __restrict__ csf,
                       const float* __restrict__ csb,
                       const typename W::T* __restrict__ whf,
                       const typename W::T* __restrict__ whb,
                       const typename W::T* __restrict__ wtf,
                       const typename W::T* __restrict__ wtb,
                       float* __restrict__ dxf, float* __restrict__ dxb,
                       int t_len, int b, int h) {
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

// an f32 tile's row stride for n values: a multiple of 4 floats with an
// odd count of 16-byte groups, so that a float4 of 8 consecutive rows
// falls in 8 distinct bank groups
int odd_stride(int n) {
  int stride = (n + 3) / 4 * 4;
  if ((stride / 4) % 2 == 0) stride += 4;
  return stride;
}

bool resident_layout(int b, int h, int w_size, int sms, size_t smem,
                     ResidentLayout* l) {
  const int per_dir = sms / 2;
  if (per_dir < 1) return false;
  const int u = (h + per_dir - 1) / per_dir;
  if (u > kResThreads) return false;
  const size_t w_bytes = ((size_t)h * 4 * u * w_size + 15) / 16 * 16;
  const int stride = odd_stride(h);
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
// the loads; those sums are not used): hs the rounded operand tile (rows x
// stride f32: kernel 20's h, kernel 21's dgates), ws a block's W_h slice
// (K x u x 4, W's type).  k0 is a multiple of 4.  NR < 8 where the tile
// has fewer than 8 row groups' rows (B < 8), so that a small batch does
// not pay for 8 rows.
template <typename W, int NR>
__device__ __forceinline__ void resident_product(
    const typename W::T* ws, const float* hs, int stride, int u, int jj,
    int rg, int gr, int rows, int k0, int k1, float (&acc)[kResRows][4]) {
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

// resident_product for a thread that holds `slots` of its 8 rows
template <typename W>
__device__ __forceinline__ void product_share(
    const typename W::T* ws, const float* hs, int stride, int u, int jj,
    int rg, int gr, int rows, int slots, int k0, int k1,
    float (&acc)[kResRows][4]) {
  if (slots > 4)
    resident_product<W, 8>(ws, hs, stride, u, jj, rg, gr, rows, k0, k1, acc);
  else if (slots > 2)
    resident_product<W, 4>(ws, hs, stride, u, jj, rg, gr, rows, k0, k1, acc);
  else if (slots > 1)
    resident_product<W, 2>(ws, hs, stride, u, jj, rg, gr, rows, k0, k1, acc);
  else
    resident_product<W, 1>(ws, hs, stride, u, jj, rg, gr, rows, k0, k1, acc);
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

// a thread's partial sums into the tile's space, value-major: value (slot
// i, column g) of thread tid = ks items + item at [(4 i + g) na + tid],
// so that a warp's stores hit 32 banks
__device__ __forceinline__ void store_partials(
    const float (&acc)[kResRows][4], float* part, int slots, int na) {
#pragma unroll
  for (int i = 0; i < kResRows; ++i)
    if (i < slots)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        part[(i * 4 + g) * na + threadIdx.x] = acc[i][g];
}

// each (value, item) summed over its `split` shares into share 0's place
__device__ __forceinline__ void sum_shares(float* part, int slots,
                                           int items, int na, int split) {
  const int n = slots * 4 * items;
#pragma unroll 2
  for (int v = threadIdx.x; v < n; v += kResThreads) {
    const int c = v / items;
    float* p = part + c * na + (v - c * items);
    p[0] = split <= 4 ? share_sum<4>(p, items, split)
                      : share_sum<kMaxSplit>(p, items, split);
  }
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
          product_share<W>(ws, hs, l.stride, u, item % nu, item / nu, gr,
                           rows, slots, k0, k1, acc);
        }
        __syncthreads();   // every thread has read the tile
        if (ks < split) store_partials(acc, hs, slots, na);
        __syncthreads();
        if (split > 1) {
          sum_shares(hs, slots, items, na, split);
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

// ---- kernel 21, resident variant ----

constexpr int kMinChunk = 64;   // dgates columns a phase-2 chunk, at least

// The backward resident variant's shape on a device: blocks a direction
// and the units a block owns (as kernel 20's), their groups of 4 (the row
// slice's unit stride), phase 1's h tile (rows over the flattened (t, b)
// index, f32 stride), phase 2's dgates tile (batch rows, the columns of a
// chunk, a multiple of 8, and the f32 stride), and the dynamic shared
// memory: the W_h slice (the larger of the column and the row slice), the
// dc carry (B x u f32), then the tile space, which the partial sums
// reuse.
// ops/cuda/lstm_seq.py backward_resident_layout is the same arithmetic;
// false where the variant does not fit.
struct BwdLayout {
  int per_dir, units, groups, rows1, stride1, rows2, chunk, stride2;
  size_t w_bytes, dc_bytes, bytes;
};

bool bwd_resident_layout(int b, int h, int w_size, int sms, size_t smem,
                         BwdLayout* l) {
  const int per_dir = sms / 2;
  if (per_dir < 1) return false;
  const int u = (h + per_dir - 1) / per_dir;
  if (u > kResThreads) return false;
  const int groups = (u + 3) / 4;
  const size_t w_elems =
      std::max((size_t)h * 4 * u, (size_t)4 * h * 4 * groups);
  const size_t w_bytes = (w_elems * w_size + 15) / 16 * 16;
  const size_t dc_bytes = ((size_t)b * u * sizeof(float) + 15) / 16 * 16;
  const size_t red_bytes = sizeof(float) * kResThreads * kResRows * 4;
  if (w_bytes + dc_bytes + red_bytes > smem) return false;
  const size_t budget = smem - w_bytes - dc_bytes;
  // phase 1: 8 rows a row group and a power of 2 of row groups, so that the
  // (unit, row group) items and their k shares fill the block
  const int stride1 = odd_stride(h);
  const int lim1 = (int)std::min(budget / (sizeof(float) * stride1),
                                 (size_t)kResRows * (kResThreads / u));
  int rows1 = lim1;
  if (lim1 >= kResRows) {
    int gr = 1;
    while (2 * gr * kResRows <= lim1) gr *= 2;
    rows1 = gr * kResRows;
  }
  // phase 2: as many batch rows as a thread's (unit group, row group)
  // items allow, with chunks of at least kMinChunk columns
  const int rows2 = (int)std::min(
      std::min((size_t)b, (size_t)kResRows * (kResThreads / groups)),
      budget / (sizeof(float) * (kMinChunk + 8)));
  if (rows1 < 1 || rows2 < 1) return false;
  const int chunk_max =
      (int)(budget / (sizeof(float) * rows2)) / 8 * 8 - 8;
  const int chunks = (4 * h + chunk_max - 1) / chunk_max;
  const int chunk = ((4 * h + chunks - 1) / chunks + 7) / 8 * 8;
  const int stride2 = odd_stride(chunk);
  l->per_dir = per_dir;
  l->units = u;
  l->groups = groups;
  l->rows1 = rows1;
  l->stride1 = stride1;
  l->rows2 = rows2;
  l->chunk = chunk;
  l->stride2 = stride2;
  l->w_bytes = w_bytes;
  l->dc_bytes = dc_bytes;
  l->bytes = w_bytes + dc_bytes +
             std::max(red_bytes, sizeof(float) * std::max(rows1 * stride1,
                                                          rows2 * stride2));
  return true;
}

// the phase-1 gates' inputs xg of a thread's pairs q0 and q0 + kResThreads
// of the tile at flattened row r0 (clamped to the tile's last pair)
__device__ __forceinline__ void xg_inputs(const float* xg, int h, int r0,
                                          int j0, int nu, int pairs, int q0,
                                          float (&a)[2][4]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int q = min(q0 + e * kResThreads, pairs - 1);
    const float* x = xg + (size_t)(r0 + q / nu) * 4 * h + j0 + q % nu;
#pragma unroll
    for (int g = 0; g < 4; ++g) a[e][g] = x[g * h];
  }
}

// the chain's inputs of a thread's pairs q0 and q0 + kResThreads of the
// tile at b0, frame t (clamped to the tile's last pair): the phase-1 gates
// from dx, dy, c_t and c at the processing-order previous frame tp
struct ChainIn {
  float a[2][4], dy[2], c[2], cp[2];
};

__device__ __forceinline__ void chain_inputs(const float* dx,
                                             const float* dy,
                                             const float* cs, int t, int tp,
                                             bool has_prev, int b, int h,
                                             int b0, int j0, int nu,
                                             int pairs, int q0, ChainIn& in) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int q = min(q0 + e * kResThreads, pairs - 1);
    const int r = q / nu, j = j0 + q % nu;
    const float* g = dx + ((size_t)t * b + b0 + r) * 4 * h + j;
#pragma unroll
    for (int k = 0; k < 4; ++k) in.a[e][k] = g[k * h];
    const size_t o = ((size_t)t * b + b0 + r) * h + j;
    in.dy[e] = dy[o];
    in.c[e] = cs[o];
    in.cp[e] = has_prev ? cs[((size_t)tp * b + b0 + r) * h + j] : 0.0f;
  }
}

// rows x n values of the exchange from src (row stride ld) widened into
// the f32 tile (row stride `stride`), 16 bytes a load where ld and n
// allow (n is a multiple of 8, or the rest of an ld that is a multiple of
// 4); L2 loads, since other blocks wrote them this launch
template <typename W>
__device__ __forceinline__ void load_dg_tile(const typename W::T* src,
                                             int ld, float* tile, int stride,
                                             int rows, int n) {
  if constexpr (W::kVec == 8) {
    if (ld % 8 != 0) {
      const int n4 = n / 4;
#pragma unroll 4
      for (int i = threadIdx.x; i < rows * n4; i += kResThreads) {
        const int r = i / n4, k = (i - r * n4) * 4;
        W::copy4_cg(src + (size_t)r * ld + k, tile + r * stride + k);
      }
      return;
    }
  }
  const int nv = n / W::kVec;
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * nv; i += kResThreads) {
    const int r = i / nv, k = (i - r * nv) * W::kVec;
    W::copy_cg(src + (size_t)r * ld + k, tile + r * stride + k);
  }
}

// Kernel 21's resident variant: a cooperative grid of kernel 20's shape
// (blocks [0, per_dir) the forward direction, the rest the backward one;
// a block owns units j0 .. j0 + nu - 1) in two phases.
//   Phase 1, time-parallel: with its (H x 4u) column slice of W_h in shared
//   memory, a block recomputes its units' gates at every (t, b), sig / tanh
//   applied, from xg and the saved previous states (an earlier launch's),
//   and parks them in its own columns of dx.  No block reads another's
//   columns, so no grid barrier follows.
//   Phase 2, the recurrence: the same shared memory holds the block's (u x
//   4H) row slice of W_h, stored m-major in groups of 4 units, ws[m][ug][e]
//   = W_h[j0 + 4 ug + e][m] (zero past nu), which is W_h^T's columns for
//   its units.  Step s (frame t, the reverse of the direction's processing
//   order) reads step s - 1's rounded dgates, all B x 4H, from the ping-pong
//   exchange in chunks of columns (bf16 widened into an f32 tile, 16 bytes
//   a load), forms dh[:, own] = dgates W_h^T[:, own]
//   (a thread one group of 4 units for up to 8 rows and a share of the
//   columns), runs _bwd_kernel's chain for its (unit, row) pairs with the
//   dc carry in shared memory, writes dxg[t] over the phase-1 gates and the
//   rounded copy into exchange half s & 1, and meets the grid once.  Half s
//   & 1 was last read at step s - 1, before the barrier that closed it.
template <typename W>
__global__ void __launch_bounds__(kResThreads, 1)
lstm_bwd_resident_kernel(const float* __restrict__ dyf,
                         const float* __restrict__ dyb,
                         const float* __restrict__ xgf,
                         const float* __restrict__ xgb,
                         const float* __restrict__ hsf,
                         const float* __restrict__ hsb,
                         const float* __restrict__ csf,
                         const float* __restrict__ csb,
                         const typename W::T* __restrict__ whf,
                         const typename W::T* __restrict__ whb, float* dxf,
                         float* dxb, typename W::T* exf, typename W::T* exb,
                         int t_len, int b, int h, BwdLayout l) {
  using T = typename W::T;
  extern __shared__ float smem[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int dir = blockIdx.x >= (unsigned)l.per_dir;
  const int j0 = (blockIdx.x - dir * l.per_dir) * l.units;
  const int nu = max(0, min(l.units, h - j0));   // 0: an idle block
  const int u = l.units, tid = threadIdx.x, h4 = 4 * h;
  const float* dy = dir ? dyb : dyf;
  const float* xg = dir ? xgb : xgf;
  const float* hs = dir ? hsb : hsf;
  const float* cs = dir ? csb : csf;
  const T* wh = dir ? whb : whf;
  float* dx = dir ? dxb : dxf;
  T* ex = dir ? exb : exf;
  char* base = reinterpret_cast<char*>(smem);
  T* ws = reinterpret_cast<T*>(base);                        // W_h slice
  float* dcs = reinterpret_cast<float*>(base + l.w_bytes);   // (B, u)
  char* tile = base + l.w_bytes + l.dc_bytes;
  float* part = reinterpret_cast<float*>(tile);   // partial sums, both phases

  // ---- phase 1: the gates at every (t, b), rows r = t B + b ----
  if (nu > 0) {
    for (int i = tid; i < h * nu * 4; i += kResThreads) {
      const int jj = i % nu, g = (i / nu) % 4, k = i / (4 * nu);
      ws[((size_t)k * u + jj) * 4 + g] =
          wh[(size_t)k * 4 * h + g * h + j0 + jj];
    }
    __syncthreads();
    float* ht = reinterpret_cast<float*>(tile);   // (rows1, stride1)
    const int total = t_len * b;
    // a row's previous state is row r - B (forward) or r + B (backward)
    const int shift = dir ? b : -b;
    for (int r0 = 0; r0 < total; r0 += l.rows1) {
      const int rows = min(l.rows1, total - r0);
      const int pairs = nu * rows;
      float pa[2][4];
      xg_inputs(xg, h, r0, j0, nu, pairs, tid, pa);
      // the tile's rows [lo, hi) have a previous state: r >= B forward,
      // r < (T - 1) B backward
      const int lo = dir ? 0 : min(rows, max(0, b - r0));
      const int hi = dir ? min(rows, max(0, (t_len - 1) * b - r0)) : rows;
      const bool any = hi > lo;
      // the next tile's previous states and gate inputs, into L2 during
      // this tile's product
      const int n0 = r0 + l.rows1, nrows = min(l.rows1, total - n0);
      const int p0 = max(0, n0 + shift), p1 = min(total, n0 + nrows + shift);
      for (int i = tid; i < ((p1 - p0) * h + 31) / 32; i += kResThreads)
        prefetch_l2(hs + (size_t)p0 * h + i * 32);
      for (int q = tid; q < nrows * 4; q += kResThreads) {
        const float* x = xg + (size_t)(n0 + q / 4) * h4 + (q % 4) * h + j0;
        prefetch_l2(x);
        prefetch_l2(x + nu - 1);
      }
      const int gr = (rows + kResRows - 1) / kResRows;
      const int items = nu * gr;
      const int split =
          min(min(kResThreads / items, kMaxSplit), max(1, (h + 15) / 16));
      const int slots = (rows + gr - 1) / gr;
      const int na = split * items;
      if (any) {
        // rows [0, lo) and [hi, rows) are zero
        for (int i = tid; i < (rows - hi + lo) * h; i += kResThreads) {
          const int z = i / h, r = z < lo ? z : hi + z - lo;
          ht[r * l.stride1 + i - z * h] = 0.0f;
        }
        load_h_tile<W>(hs + (size_t)(r0 + lo + shift) * h,
                       ht + lo * l.stride1, l.stride1, hi - lo, h);
        __syncthreads();
        const int item = tid % items, ks = tid / items;
        float acc[kResRows][4] = {};
        if (ks < split) {
          const int chunk = ((h + split - 1) / split + 3) & ~3;
          const int k0 = min(h, ks * chunk), k1 = min(h, k0 + chunk);
          product_share<W>(ws, ht, l.stride1, u, item % nu, item / nu, gr,
                           rows, slots, k0, k1, acc);
        }
        __syncthreads();   // every thread has read the tile
        if (ks < split) store_partials(acc, part, slots, na);
        __syncthreads();
        if (split > 1) {
          sum_shares(part, slots, items, na, split);
          __syncthreads();
        }
      }
      for (int q0 = tid; q0 < pairs; q0 += 2 * kResThreads) {
        float a[2][4];
        if (q0 == tid) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int g = 0; g < 4; ++g) a[e][g] = pa[e][g];
        } else {
          xg_inputs(xg, h, r0, j0, nu, pairs, q0, a);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = q0 + e * kResThreads;
          if (q >= pairs) break;
          const int jj = q % nu, r = q / nu;
          if (any) {
            const float* sum = part + (r / gr) * 4 * na + (r % gr) * nu + jj;
#pragma unroll
            for (int g = 0; g < 4; ++g) a[e][g] += sum[g * na];
          }
          float* o = dx + (size_t)(r0 + r) * h4 + j0 + jj;
          o[0] = sigmoid(a[e][0]);
          o[h] = sigmoid(a[e][1]);
          o[2 * h] = tanhf(a[e][2]);
          o[3 * h] = sigmoid(a[e][3]);
        }
      }
      __syncthreads();   // the tile's space is free for the next tile
    }
    // ---- the row slice: ws[m][ug][e] = W_h[j0 + 4 ug + e][m] ----
    for (int i = tid; i < 4 * l.groups * h4; i += kResThreads) {
      const int jj = i / h4, m = i - jj * h4;
      ws[((size_t)m * l.groups + jj / 4) * 4 + jj % 4] =
          jj < nu ? wh[(size_t)(j0 + jj) * h4 + m] : T(0);
    }
    __syncthreads();   // phase 1's gates and the slice in place
  }

  // ---- phase 2: the recurrence, one grid barrier a step ----
  float* gt = reinterpret_cast<float*>(tile);   // (rows2, stride2): dgates
  const int ngr = (nu + 3) / 4;         // the block's unit groups
  for (int s = 0; s < t_len; ++s) {
    // the reverse of the direction's processing order
    const int t = dir ? s : t_len - 1 - s;
    // the processing-order previous frame; none at the direction's first
    const int tp = dir ? t + 1 : t - 1;
    const bool has_prev = dir ? t < t_len - 1 : t > 0;
    const T* ex_prev = ex + (size_t)((s + 1) & 1) * b * h4;   // step s - 1
    T* ex_cur = ex + (size_t)(s & 1) * b * h4;
    for (int b0 = 0; nu > 0 && b0 < b; b0 += l.rows2) {
      const int rows = min(l.rows2, b - b0);
      const int pairs = nu * rows;
      ChainIn first;
      chain_inputs(dx, dy, cs, t, tp, has_prev, b, h, b0, j0, nu, pairs, tid,
                   first);
      const int gr = (rows + kResRows - 1) / kResRows;
      const int items = ngr * gr;   // (unit group, row group) items
      const int split = min(min(kResThreads / items, kMaxSplit),
                            max(1, (l.chunk + 15) / 16));
      const int slots = (rows + gr - 1) / gr;
      const int na = split * items;
      if (s > 0) {
        const int item = tid % items, ks = tid / items;
        float acc[kResRows][4] = {};
        for (int c0 = 0; c0 < h4; c0 += l.chunk) {
          const int n = min(l.chunk, h4 - c0);
          load_dg_tile<W>(ex_prev + (size_t)b0 * h4 + c0, h4, gt, l.stride2,
                          rows, n);
          __syncthreads();   // the chunk in place
          if (ks < split) {
            const int sc = ((n + split - 1) / split + 3) & ~3;
            const int k0 = min(n, ks * sc), k1 = min(n, k0 + sc);
            product_share<W>(ws + (size_t)c0 * l.groups * 4, gt,
                             l.stride2, l.groups, item % ngr, item / ngr, gr,
                             rows, slots, k0, k1, acc);
          }
          __syncthreads();   // every thread has read the chunk
        }
        if (ks < split) store_partials(acc, part, slots, na);
        __syncthreads();
        if (split > 1) sum_shares(part, slots, items, na, split);
        __syncthreads();   // dh of the tile's pairs in place
      }
      // _bwd_kernel :110-121 for the tile's (unit, row) pairs, two a
      // thread at a time; the first two were loaded at the tile's start
      for (int q0 = tid; q0 < pairs; q0 += 2 * kResThreads) {
        ChainIn in;
        if (q0 == tid)
          in = first;
        else
          chain_inputs(dx, dy, cs, t, tp, has_prev, b, h, b0, j0, nu, pairs,
                       q0, in);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = q0 + e * kResThreads;
          if (q >= pairs) break;
          const int jj = q % nu, r = q / nu;
          float dhh = in.dy[e];
          if (s > 0)
            dhh += part[((r / gr) * 4 + jj % 4) * na + (r % gr) * ngr +
                        jj / 4];
          const float gi = in.a[e][0], gf = in.a[e][1];
          const float gg = in.a[e][2], go = in.a[e][3];
          const float tc = tanhf(in.c[e]);
          float* dcp = dcs + (size_t)(b0 + r) * u + jj;
          const float d_o = dhh * tc * go * (1.0f - go);
          const float dcc =
              (s > 0 ? *dcp : 0.0f) + dhh * go * (1.0f - tc * tc);
          const float d_i = dcc * gg * gi * (1.0f - gi);
          const float d_g = dcc * gi * (1.0f - gg * gg);
          const float d_f = dcc * in.cp[e] * gf * (1.0f - gf);
          *dcp = dcc * gf;
          float* d = dx + ((size_t)t * b + b0 + r) * h4 + j0 + jj;
          d[0] = d_i;
          d[h] = d_f;
          d[2 * h] = d_g;
          d[3 * h] = d_o;
          T* x = ex_cur + (size_t)(b0 + r) * h4 + j0 + jj;
          x[0] = W::pack(d_i);
          x[h] = W::pack(d_f);
          x[2 * h] = W::pack(d_g);
          x[3 * h] = W::pack(d_o);
        }
      }
      __syncthreads();   // the tile's dxg and dgates written
    }
    if (nu > 0 && s + 1 < t_len) {
      // the next step's chain inputs of the block's units, into L2 during
      // the barrier: the phase-1 gates, dy and c
      const int tn = dir ? t + 1 : t - 1;
      for (int q = tid; q < b * 6; q += kResThreads) {
        const int row = q / 6, w = q % 6;
        const size_t o = (size_t)tn * b + row;
        const float* p = w < 4 ? dx + o * h4 + w * h + j0
                               : (w == 4 ? dy : cs) + o * h + j0;
        prefetch_l2(p);
        prefetch_l2(p + nu - 1);
      }
    }
    grid.sync();   // dgates of every block before step s + 1 reads them
  }
}

// SM count and the shared memory a block may opt in to, per device, read
// once; and the largest dynamic shared memory at which each resident
// kernel was found co-resident (one block an SM), per device.
struct DeviceLimits {
  int sms = 0, smem = 0;
  size_t fits[4] = {0, 0, 0, 0};   // kernel 20 F32, BF16; kernel 21 F32, BF16
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

// A resident kernel's `bytes` of dynamic shared memory opted in, and one
// block an SM checked to be co-resident at that size (once per device,
// kernel and size, `slot` of DeviceLimits::fits).
template <typename K>
int co_resident(K kernel, int dev, const DeviceLimits& lim, int slot,
                size_t bytes) {
  int err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  if (bytes > lim.fits[slot]) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kResThreads, bytes);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    std::lock_guard<std::mutex> lock(g_limits_mutex);
    g_limits[dev].fits[slot] = std::max(g_limits[dev].fits[slot], bytes);
  }
  return cudaSuccess;
}

// a cooperative launch of 2 per_dir blocks; the kernel's type named, so
// that the runtime's template takes the function pointer
template <typename K>
int launch_cooperative(K kernel, int per_dir, void** args, size_t bytes,
                       cudaStream_t st) {
  int err = cudaLaunchCooperativeKernel<std::remove_pointer_t<K>>(
      kernel, dim3(2 * per_dir), dim3(kResThreads), args, bytes, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename W>
int fwd_resident(const void* xgf, const void* xgb, const void* whf,
                 const void* whb, void* hsf, void* csf, void* hsb, void* csb,
                 int t_len, int b, int h, cudaStream_t st) {
  using T = typename W::T;
  int dev = 0;
  DeviceLimits lim;
  int err = device_limits(&dev, &lim);
  if (err != cudaSuccess) return err;
  ResidentLayout l;
  if (!resident_layout(b, h, sizeof(T), lim.sms, lim.smem, &l))
    return cudaErrorInvalidValue;
  auto kernel = lstm_fwd_resident_kernel<W>;
  err = co_resident(kernel, dev, lim, sizeof(T) == 2, l.bytes);
  if (err != cudaSuccess) return err;
  const float* xf = static_cast<const float*>(xgf);
  const float* xb = static_cast<const float*>(xgb);
  const T* wf = static_cast<const T*>(whf);
  const T* wb = static_cast<const T*>(whb);
  float* hf = static_cast<float*>(hsf);
  float* cf = static_cast<float*>(csf);
  float* hb = static_cast<float*>(hsb);
  float* cb = static_cast<float*>(csb);
  void* args[] = {&xf, &xb, &wf, &wb, &hf, &cf, &hb, &cb, &t_len, &b, &h, &l};
  return launch_cooperative(kernel, l.per_dir, args, l.bytes, st);
}

template <typename W>
int bwd_resident(const void* const* in, const void* whf, const void* whb,
                 void* dxf, void* dxb, void* exf, void* exb, int t_len,
                 int b, int h, cudaStream_t st) {
  using T = typename W::T;
  int dev = 0;
  DeviceLimits lim;
  int err = device_limits(&dev, &lim);
  if (err != cudaSuccess) return err;
  BwdLayout l;
  if (!bwd_resident_layout(b, h, sizeof(T), lim.sms, lim.smem, &l))
    return cudaErrorInvalidValue;
  auto kernel = lstm_bwd_resident_kernel<W>;
  err = co_resident(kernel, dev, lim, 2 + (sizeof(T) == 2), l.bytes);
  if (err != cudaSuccess) return err;
  const float* f[8];
  for (int i = 0; i < 8; ++i) f[i] = static_cast<const float*>(in[i]);
  const T* wf = static_cast<const T*>(whf);
  const T* wb = static_cast<const T*>(whb);
  float* df = static_cast<float*>(dxf);
  float* db = static_cast<float*>(dxb);
  T* ef = static_cast<T*>(exf);
  T* eb = static_cast<T*>(exb);
  void* args[] = {&f[0], &f[1], &f[2], &f[3], &f[4], &f[5], &f[6], &f[7],
                  &wf,   &wb,   &df,   &db,   &ef,   &eb,   &t_len, &b,
                  &h,    &l};
  return launch_cooperative(kernel, l.per_dir, args, l.bytes, st);
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
  int err = opt_in(lstm_bwd_stream_kernel<W>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((b + kRows - 1) / kRows, 2);
  auto f = [&](int i) { return static_cast<const float*>(in[i]); };
  lstm_bwd_stream_kernel<W><<<grid, h, bytes, st>>>(
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
// may opt in to, in bytes; what the resident variants are laid out for.
extern "C" int lstm_device_limits(int* out) {
  int dev = 0;
  DeviceLimits lim;
  const int err = device_limits(&dev, &lim);
  if (err != cudaSuccess) return err;
  out[0] = lim.sms;
  out[1] = lim.smem;
  return cudaSuccess;
}

// Kernel 21's two variants, one contract: dyf, dyb, hsf, hsb, csf, csb:
// (T, B, H) f32, hs / cs the states kernel 20 wrote; xgf, xgb, dxf, dxb:
// (T, B, 4H) f32; whf, whb: (H, 4H) f32, or bf16 bits with `bf16`.
// 1 <= H <= 1024, B, T >= 1.  The stream variant also takes wtf, wtb: W_h^T
// (4H, H) of W_h's type.
extern "C" int lstm_bwd_stream_launch(const void* dyf, const void* dyb,
                                      const void* xgf, const void* xgb,
                                      const void* hsf, const void* hsb,
                                      const void* csf, const void* csb,
                                      const void* whf, const void* whb,
                                      const void* wtf, const void* wtb,
                                      void* dxf, void* dxb, int t_len, int b,
                                      int h, int bf16, void* stream) {
  if (bad_shape(t_len, b, h)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const void* in[8] = {dyf, dyb, xgf, xgb, hsf, hsb, csf, csb};
  if (bf16)
    return bwd<BF16>(in, whf, whb, wtf, wtb, dxf, dxb, t_len, b, h, st);
  return bwd<F32>(in, whf, whb, wtf, wtb, dxf, dxb, t_len, b, h, st);
}

// The resident variant takes in their place exf, exb: the dgates exchange
// of each direction, (2, B, 4H) of W_h's type (scratch, no contents
// needed).  Like
// kernel 20's, it returns an error and launches nothing where its layout
// does not fit the current device (bwd_resident_layout) or the grid cannot
// be co-resident.
extern "C" int lstm_bwd_resident_launch(const void* dyf, const void* dyb,
                                        const void* xgf, const void* xgb,
                                        const void* hsf, const void* hsb,
                                        const void* csf, const void* csb,
                                        const void* whf, const void* whb,
                                        void* exf, void* exb, void* dxf,
                                        void* dxb, int t_len, int b, int h,
                                        int bf16, void* stream) {
  if (bad_shape(t_len, b, h)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const void* in[8] = {dyf, dyb, xgf, xgb, hsf, hsb, csf, csb};
  if (bf16)
    return bwd_resident<BF16>(in, whf, whb, dxf, dxb, exf, exb, t_len, b, h,
                              st);
  return bwd_resident<F32>(in, whf, whb, dxf, dxb, exf, exb, t_len, b, h,
                           st);
}

// Kernel 21's resident layout for (B, H, W_h's bytes) on a device of `sms`
// SMs and `smem` bytes of opt-in shared memory a block: out[0..7] = blocks
// a direction, units a block, phase-1 tile rows and stride, phase-2 tile
// rows, chunk columns and stride, dynamic shared memory in bytes.  Returns
// cudaErrorInvalidValue where it does not fit.
extern "C" int lstm_bwd_layout(int b, int h, int w_size, int sms, int smem,
                               int* out) {
  BwdLayout l;
  if (b < 1 || h < 1 || smem < 0 ||
      !bwd_resident_layout(b, h, w_size, sms, (size_t)smem, &l))
    return cudaErrorInvalidValue;
  const int v[8] = {l.per_dir, l.units, l.rows1, l.stride1,
                    l.rows2,   l.chunk, l.stride2, (int)l.bytes};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return cudaSuccess;
}
