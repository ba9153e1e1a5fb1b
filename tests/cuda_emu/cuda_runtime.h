// CPU stand-in for the parts of the CUDA runtime that the kernels under
// setk_tpu_torch/csrc use, so that their sources compile with a host C++20
// compiler and run on the CPU for tests.  A launch runs the grid's blocks
// one after another; each block's threads are std::threads that meet at a
// std::barrier for __syncthreads.  __shared__ arrays become function-local
// statics: shared by a block's threads and reused by the next block, which
// matches CUDA as long as blocks run one at a time (they do here).  A warp
// shuffle exchanges through such a static between two block-wide barriers,
// so every thread of the block that has not returned must take part in it
// (a thread that returned is dropped from the barrier).  __syncwarp is the
// block's barrier too, so a kernel that calls it must keep every thread of
// the block that has not returned converged through it (a one-warp block
// makes it the warp's).
// tests/test_torch_cuda_emu.py rewrites each `kernel<<<grid, block, smem,
// stream>>>(args)` launch into `emu_launch(grid, block, smem, stream,
// kernel, args)` before compiling, and each dynamic shared array into a
// pointer to the block's buffer of `smem` bytes.
//
// Dynamic shared memory starts each block as all-ones bytes (a NaN in
// every float or double, -1 in every integer), so that a kernel that reads
// a word it did not write shows it, as the card's leftovers may.
//
// cp.async (cuda_pipeline_primitives.h, which includes this file) is a
// plain copy that checks what the card checks: a source or destination
// not aligned to the copy's size is the card's misaligned-address fault,
// which the launch's cudaGetLastError then returns.
//
// A launch that asks for more than 48 KB of dynamic shared memory runs
// only if its kernel opted in to at least that much through
// cudaFuncSetAttribute(MaxDynamicSharedMemorySize), as on the card;
// otherwise it runs nothing, and cudaGetLastError (or the cooperative
// launch) returns the card's invalid-value error.
//
// A cooperative launch (cudaLaunchCooperativeKernel) runs every thread of
// the grid at once, each block with its own barrier and its own dynamic
// shared buffer, and cooperative_groups.h's grid.sync() is one barrier over
// all of them; a kernel launched so must use neither static __shared__
// arrays nor shuffles, whose exchange is one per process.  The device's SM
// count and opt-in shared memory are what emu_set_device_attributes set
// (a test calls it through the library before a resident launch).
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <memory>
#include <thread>
#include <type_traits>
#include <utility>
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
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct uint2 {
  unsigned x, y;
};
struct uint4 {
  unsigned x, y, z, w;
};
// a load that bypasses L1 on the card; a plain load here
template <typename T>
inline T __ldcg(const T* p) {
  return *p;
}

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorMisalignedAddress = 716,
  cudaErrorCooperativeLaunchTooLarge = 720
};
// a fault a kernel met (set by any of its threads), returned and cleared
// by the next cudaGetLastError
inline std::atomic<int> emu_fault{cudaSuccess};
inline int cudaGetLastError() { return emu_fault.exchange(cudaSuccess); }
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributePreferredSharedMemoryCarveout = 9
};
enum { cudaSharedmemCarveoutMaxShared = 100 };
// each kernel's opt-in to dynamic shared memory past the default
inline constexpr std::size_t emu_smem_default = 48 * 1024;
inline std::mutex emu_optin_mutex;
inline std::map<const void*, std::size_t> emu_kernel_optin;
template <typename K>
inline int cudaFuncSetAttribute(K kernel, cudaFuncAttribute attr, int value) {
  if (attr == cudaFuncAttributeMaxDynamicSharedMemorySize) {
    std::lock_guard<std::mutex> lock(emu_optin_mutex);
    emu_kernel_optin[reinterpret_cast<const void*>(kernel)] =
        static_cast<std::size_t>(value);
  }
  return cudaSuccess;
}
// whether `kernel` may launch with `smem` bytes of dynamic shared memory
template <typename K>
inline bool emu_smem_allowed(K kernel, std::size_t smem) {
  if (smem <= emu_smem_default) return true;
  std::lock_guard<std::mutex> lock(emu_optin_mutex);
  const auto it = emu_kernel_optin.find(reinterpret_cast<const void*>(kernel));
  return it != emu_kernel_optin.end() && smem <= it->second;
}

// one emulated device, whose SM count and opt-in shared memory a test sets
inline int emu_sm_count = 6;
inline int emu_smem_optin = 232448;
extern "C" void emu_set_device_attributes(int sms, int smem_optin) {
  emu_sm_count = sms;
  emu_smem_optin = smem_optin;
}
enum cudaDeviceAttr {
  cudaDevAttrMultiProcessorCount = 16,
  cudaDevAttrMaxSharedMemoryPerBlockOptin = 97
};
inline int cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline int cudaDeviceGetAttribute(int* value, cudaDeviceAttr attr, int) {
  *value = attr == cudaDevAttrMultiProcessorCount ? emu_sm_count
                                                  : emu_smem_optin;
  return cudaSuccess;
}
template <typename K>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, K,
                                                         int,
                                                         size_t smem) {
  *blocks = smem <= (size_t)emu_smem_optin ? 1 : 0;
  return cudaSuccess;
}

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
// the calling thread's block barrier and dynamic shared memory
// (`extern __shared__ T name[];` is rewritten to
// `T* name = reinterpret_cast<T*>(emu_dyn_smem);`)
inline thread_local std::barrier<>* emu_barrier = nullptr;
inline thread_local char* emu_dyn_smem = nullptr;
// the grid's barrier during a cooperative launch
inline std::barrier<>* emu_grid_barrier = nullptr;

inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
// cuda_pipeline_primitives.h: cp.async as a plain copy that has landed
// when it returns; `zfill` trailing bytes are zeroed instead of read
inline void __pipeline_memcpy_async(void* dst, const void* src,
                                    size_t size_and_align, size_t zfill = 0) {
  if (reinterpret_cast<uintptr_t>(dst) % size_and_align != 0 ||
      reinterpret_cast<uintptr_t>(src) % size_and_align != 0)
    emu_fault = cudaErrorMisalignedAddress;
  std::memcpy(dst, src, size_and_align - zfill);
  std::memset(static_cast<char*>(dst) + size_and_align - zfill, 0, zfill);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
inline void __syncwarp(unsigned = 0xffffffffu) { __syncthreads(); }
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

inline float __shfl_sync(unsigned, float v, int src_lane) {
  static float exchange[1024];
  exchange[threadIdx.x] = v;
  __syncthreads();
  const float got = exchange[(threadIdx.x & ~31u) | (src_lane & 31)];
  __syncthreads();
  return got;
}

// the warp votes: every lane of the calling warp (as many as the block
// has) through the exchange, as the shuffles
inline unsigned __ballot_sync(unsigned, int pred) {
  static int exchange[1024];
  exchange[threadIdx.x] = pred != 0;
  __syncthreads();
  const unsigned first = threadIdx.x & ~31u;
  unsigned votes = 0;
  for (unsigned k = first; k < first + 32 && k < blockDim.x; ++k)
    votes |= (exchange[k] ? 1u : 0u) << (k - first);
  __syncthreads();
  return votes;
}

inline int __all_sync(unsigned, int pred) {
  static int exchange[1024];
  exchange[threadIdx.x] = pred != 0;
  __syncthreads();
  const unsigned first = threadIdx.x & ~31u;
  int all = 1;
  for (unsigned k = first; k < first + 32 && k < blockDim.x; ++k)
    all &= exchange[k];
  __syncthreads();
  return all;
}

inline float __fdividef(float x, float y) { return x / y; }

template <typename K, typename... A>
void emu_launch(dim3 grid, int block, size_t smem, cudaStream_t, K kernel,
                A... args) {
  if (!emu_smem_allowed(kernel, smem)) {
    emu_fault = cudaErrorInvalidValue;
    return;
  }
  blockDim = dim3(block);
  gridDim = grid;
  std::vector<double> dyn(smem / sizeof(double) + 1);
  char* dyn_smem = reinterpret_cast<char*>(dyn.data());
  for (unsigned by = 0; by < grid.y; ++by) {
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::memset(dyn_smem, 0xff, dyn.size() * sizeof(double));
      std::barrier<> bar(block);
      std::vector<std::thread> threads;
      for (int t = 0; t < block; ++t) {
        threads.emplace_back([&, t]() {
          threadIdx = dim3(t);
          blockIdx = dim3(bx, by);
          emu_barrier = &bar;
          emu_dyn_smem = dyn_smem;
          kernel(args...);
          bar.arrive_and_drop();  // a thread that returned early
        });
      }
      for (auto& th : threads) th.join();
    }
  }
}

// every thread of the grid at once; grid.sync() meets all of them
template <typename... P, std::size_t... I>
void emu_launch_cooperative(void (*kernel)(P...), dim3 grid, dim3 block,
                            void** args, size_t smem,
                            std::index_sequence<I...>) {
  blockDim = block;
  gridDim = grid;
  const unsigned blocks = grid.x * grid.y * grid.z;
  const unsigned per_block = block.x * block.y * block.z;
  std::barrier<> grid_bar(blocks * per_block);
  emu_grid_barrier = &grid_bar;
  std::vector<std::unique_ptr<std::barrier<>>> bars;
  std::vector<std::vector<double>> dyn(blocks);
  for (unsigned i = 0; i < blocks; ++i) {
    bars.push_back(std::make_unique<std::barrier<>>(per_block));
    dyn[i].resize(smem / sizeof(double) + 1);
    std::memset(dyn[i].data(), 0xff, dyn[i].size() * sizeof(double));
  }
  std::vector<std::thread> threads;
  for (unsigned i = 0; i < blocks; ++i) {
    for (unsigned t = 0; t < per_block; ++t) {
      threads.emplace_back([&, i, t]() {
        threadIdx = dim3(t % block.x, t / block.x % block.y,
                         t / (block.x * block.y));
        blockIdx = dim3(i % grid.x, i / grid.x % grid.y,
                        i / (grid.x * grid.y));
        emu_barrier = bars[i].get();
        emu_dyn_smem = reinterpret_cast<char*>(dyn[i].data());
        kernel(*static_cast<std::decay_t<P>*>(args[I])...);
        bars[i]->arrive_and_drop();
        grid_bar.arrive_and_drop();
      });
    }
  }
  for (auto& th : threads) th.join();
  emu_grid_barrier = nullptr;
}

template <typename... P>
void emu_cooperative(void (*kernel)(P...), dim3 grid, dim3 block,
                     void** args, size_t smem) {
  emu_launch_cooperative(kernel, grid, block, args, smem,
                         std::index_sequence_for<P...>{});
}

// the runtime's template form: F the kernel's function type
template <typename F>
int cudaLaunchCooperativeKernel(const F* kernel, dim3 grid, dim3 block,
                                void** args, size_t smem, cudaStream_t) {
  if (!emu_smem_allowed(kernel, smem)) return cudaErrorInvalidValue;
  emu_cooperative(kernel, grid, block, args, smem);
  return cudaSuccess;
}
