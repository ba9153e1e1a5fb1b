// Kernels 20 and 21 (sm_90a): the bidirectional LSTM recurrence over a whole
// sequence, forward and BPTT, one launch a layer.
//
// Kernel 20, lstm_fwd_kernel, replaces setk_tpu/ops/pallas/lstm_seq.py
// _forward (:130, body _fwd_kernel :66).  xg_f / xg_b (T, B, 4H) f32 are the
// time-parallel input projections (gates ordered i | f | g | o), both in
// natural time order; W_h (H, 4H) f32 or bf16.  Per direction, starting
// from h = c = 0:
//   gates = xg[t] + round_W(h) W_h   (f32 sums)
//   c = sig(f) c + sig(i) tanh(g),   h = sig(o) tanh(c)
// with t ascending for the forward direction and T-1 .. 0 for the backward
// one.  h_t and c_t (T, B, H) f32 are written in natural time order, so the
// backward direction's h_t is its state after consuming frames T-1 .. t.
// round_W rounds h to the weight's type (round to nearest even for bf16),
// where the JAX package's _rec_matmul and the TPU kernel round it.
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
// T B is one matrix product outside the kernel, as on the TPU.
//
// Layout of the work: a block owns one direction and a tile of kRows = 4
// batch rows (grid (ceil(B / 4), 2), any B >= 1, the last tile ragged) and
// loops over T inside; thread j owns hidden unit j (H <= 1024 threads) and
// its four gate columns j, H + j, 2H + j, 3H + j for the tile's rows, so the
// cell carry and the gate math stay in its registers.  A step streams the
// whole of W_h (2 MB a direction in bf16 at H = 512, L2-resident) once for
// the tile's 4 rows: 4 loads feed 16 multiply-adds.  Shared memory holds the
// rounded recurrent operand, k-major with the 4 rows adjacent so one 16-byte
// broadcast load serves a k: the forward pass's h (4 H f32, 8 KB at H =
// 512), the backward pass's h_prev and its (4 x 4H) rounded dgates (40 KB at
// H = 512, 80 KB at H = 1024, which opts in to dynamic shared memory above
// 48 KB).  Two barriers a step.
//
// Bound on the card, at the BLSTM bench shape (T = 400, B = 64, H = 512):
// kernel 20 reads 419 MB of gates and writes 210 MB of states (~0.19 ms at
// 3.35 TB/s) and does 107 GFLOP of recurrent products (bf16 operands, f32
// sums); kernel 21 moves 1.16 GB (~0.35 ms: dy, h and c of each direction,
// the gates read and their gradients written) for twice the products.  This
// design does not approach either: each of the 32 blocks (B = 64) streams
// all of W_h from L2 every step, 400 steps in sequence, so a step costs the
// time one SM takes to read 2 MB from L2 and to run its 4 M multiply-adds
// on the CUDA cores.  Keeping W_h slices resident in shared memory across
// all SMs, with a grid-wide barrier a step and wgmma for the step's
// product, is the next design (ROADMAP queue 2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;        // batch rows a block
constexpr int kMaxHidden = 1024;

// The recurrent weight's element type: f32, or bf16 as its raw 16 bits.
struct F32 {
  using T = float;
  __device__ static float widen(float w) { return w; }
  __device__ static float round(float x) { return x; }
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
lstm_fwd_kernel(const float* __restrict__ xgf, const float* __restrict__ xgb,
                const typename W::T* __restrict__ whf,
                const typename W::T* __restrict__ whb,
                float* __restrict__ hsf, float* __restrict__ csf,
                float* __restrict__ hsb, float* __restrict__ csb, int t_len,
                int b, int h) {
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
  int err = opt_in(lstm_fwd_kernel<W>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((b + kRows - 1) / kRows, 2);
  lstm_fwd_kernel<W><<<grid, h, bytes, st>>>(
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

// xgf, xgb: (T, B, 4H) f32; whf, whb: (H, 4H) f32, or bf16 bits with
// `bf16`; hsf, csf, hsb, csb: (T, B, H) f32.  1 <= H <= 1024, B, T >= 1.
extern "C" int lstm_fwd_launch(const void* xgf, const void* xgb,
                               const void* whf, const void* whb, void* hsf,
                               void* csf, void* hsb, void* csb, int t_len,
                               int b, int h, int bf16, void* stream) {
  if (bad_shape(t_len, b, h)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return fwd<BF16>(xgf, xgb, whf, whb, hsf, csf, hsb, csb, t_len, b, h,
                     st);
  return fwd<F32>(xgf, xgb, whf, whb, hsf, csf, hsb, csb, t_len, b, h, st);
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
