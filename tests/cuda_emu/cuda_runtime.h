// CPU stand-in for the parts of the CUDA runtime that the kernels under
// setk_tpu_torch/csrc use, so that their sources compile with a host C++20
// compiler and run on the CPU for tests.  A launch runs the grid's blocks
// one after another; each block's threads are std::threads that meet at a
// std::barrier for __syncthreads.  __shared__ arrays become function-local
// statics: shared by a block's threads and reused by the next block, which
// matches CUDA as long as blocks run one at a time (they do here).  A warp
// shuffle exchanges through such a static between two block-wide barriers,
// so every thread of the block that has not returned must take part in it
// (a thread that returned is dropped from the barrier).
// tests/test_torch_cuda_emu.py rewrites each `kernel<<<grid, block, smem,
// stream>>>(args)` launch into `emu_launch(grid, block, smem, stream,
// kernel, args)` before compiling, and each dynamic shared array into a
// pointer to the block's buffer of `smem` bytes.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __restrict__
#define __launch_bounds__(...)
#define __shared__ static

struct float2 {
  float x, y;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
struct float4 {
  float x, y, z, w;
};

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return cudaSuccess; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <typename K>
inline int cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* emu_barrier = nullptr;
// a block's dynamic shared memory (`extern __shared__ T name[];` is
// rewritten to `T* name = reinterpret_cast<T*>(emu_dyn_smem);`)
inline char* emu_dyn_smem = nullptr;

inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline unsigned __float_as_uint(float x) {
  unsigned u;
  std::memcpy(&u, &x, sizeof u);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float x;
  std::memcpy(&x, &u, sizeof x);
  return x;
}
inline void sincospi(double x, double* s, double* c) {
  *s = std::sin(M_PI * x);
  *c = std::cos(M_PI * x);
}
inline unsigned __brev(unsigned v) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i, v >>= 1) r = (r << 1) | (v & 1u);
  return r;
}
using std::max;
using std::min;

inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  static float exchange[1024];
  exchange[threadIdx.x] = v;
  __syncthreads();
  const float got =
      exchange[(threadIdx.x & ~31u) | ((threadIdx.x & 31u) ^ lane_mask)];
  __syncthreads();
  return got;
}

template <typename K, typename... A>
void emu_launch(dim3 grid, int block, size_t smem, cudaStream_t, K kernel,
                A... args) {
  blockDim = dim3(block);
  gridDim = grid;
  std::vector<double> dyn(smem / sizeof(double) + 1);
  emu_dyn_smem = reinterpret_cast<char*>(dyn.data());
  for (unsigned by = 0; by < grid.y; ++by) {
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::barrier<> bar(block);
      emu_barrier = &bar;
      std::vector<std::thread> threads;
      for (int t = 0; t < block; ++t) {
        threads.emplace_back([&, t]() {
          threadIdx = dim3(t);
          blockIdx = dim3(bx, by);
          kernel(args...);
          bar.arrive_and_drop();  // a thread that returned early
        });
      }
      for (auto& th : threads) th.join();
    }
  }
}
