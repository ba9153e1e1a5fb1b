// Dependent-issue latencies of the SASS instructions on the OM-LSA chain
// (sm_90a), for tools/sass_floor.py.  Probe P is a kernel of one thread
// that runs a loop whose body is a chain of kBody steps, each reading the
// one before, between two reads of the SM clock: m iterations (the
// instruction cache's warm-up), m again, then 2m, all through the same
// code.  A step is one instruction, or two where a chain of one would
// fold (a few probes put a second instruction of known latency beside
// each step, see below).  Its latency is (cycles at 2m - cycles at m)
// over m times the body's steps, which sass_floor.py counts in this
// library's SASS between the kernel's clock reads.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
//        -o libsass_latency.so tools/sass_latency.cu
//
// sass_latency(p, m, out): probe p's cycles at m, m and 2m into out[0..2],
// probes in sass_floor.PROBES' order.

#include <cuda_runtime.h>

namespace {

constexpr int kBody = 64;
constexpr int kProbes = 11;

// one step of probe P on x (f32) or i (u32); a, b, ia and ib are runtime
// values the compiler cannot fold
#define STEP_F(asm_text) asm volatile(asm_text : "+f"(x) : "f"(a), "f"(b))
#define STEP_I(asm_text) asm volatile(asm_text : "+r"(i) : "r"(ia), "r"(ib))

template <int P>
__device__ __forceinline__ void step(float& x, unsigned& i, float a, float b,
                                     unsigned ia, unsigned ib) {
  if constexpr (P == 0) STEP_F("fma.rn.f32 %0, %0, %1, %2;");
  if constexpr (P == 1) STEP_F("add.rn.f32 %0, %0, %1;");
  if constexpr (P == 2) STEP_F("mul.rn.f32 %0, %0, %1;");
  // max then min: two max with one operand fold into one
  if constexpr (P == 3) STEP_F("max.f32 %0, %0, %1; min.f32 %0, %0, %2;");
  // FSETP then FSEL between x b (an FMUL beside the FSETP) and a: a
  // select between x and a value alone folds (it is idempotent)
  if constexpr (P == 4)
    STEP_F("{.reg .pred p; .reg .f32 y; setp.gt.f32 p, %0, %1; "
           "mul.rn.f32 y, %0, %2; selp.f32 %0, y, %1, p;}");
  // an FFMA after each reciprocal (two reciprocals fold into none)
  if constexpr (P == 5)
    STEP_F("rcp.approx.ftz.f32 %0, %0; fma.rn.f32 %0, %0, %1, %2;");
  if constexpr (P == 6) STEP_F("ex2.approx.ftz.f32 %0, %0;");
  if constexpr (P == 7) STEP_F("lg2.approx.ftz.f32 %0, %0;");
  if constexpr (P == 8) STEP_I("mad.lo.u32 %0, %0, %1, %2;");
  // an IMAD beside each xor (two xors fuse into one LOP3)
  if constexpr (P == 9)
    STEP_I("mad.lo.u32 %0, %0, %1, %2; xor.b32 %0, %0, %1;");
  // a shared-memory word that holds its own address
  if constexpr (P == 10) asm volatile("ld.shared.u32 %0, [%0];" : "+r"(i));
}

template <int P>
__global__ void __launch_bounds__(32)
probe_kernel(long long* out, float a, float b, unsigned ia, unsigned ib,
             int m) {
  __shared__ unsigned word;
  const unsigned self = (unsigned)__cvta_generic_to_shared(&word);
  word = self;
  __syncwarp();
  // values of the thread's own, so that the integer chains stay off the
  // uniform datapath
  float x = a + (float)threadIdx.x;
  unsigned i = P == 10 ? self : ia + threadIdx.x;
#pragma unroll 1
  for (int rep = 0; rep < 3; ++rep) {
    const int iters = rep == 2 ? 2 * m : m;
    const long long t0 = clock64();
#pragma unroll 1
    for (int k = 0; k < iters; ++k) {
#pragma unroll
      for (int j = 0; j < kBody; ++j) step<P>(x, i, a, b, ia, ib);
    }
    // the clock read does not wait for the last step: the difference of
    // two runs cancels that
    out[rep] = clock64() - t0;
  }
  // the chain's value stored, so that it is not dead code
  out[3] = (long long)__float_as_uint(x) << 32 | i;
}

template <int P>
int run(int m, long long* d) {
  probe_kernel<P><<<1, 1>>>(d, 0.75f, 0.5f, 3u, 5u, m);
  return cudaGetLastError();
}

using Run = int (*)(int, long long*);
constexpr Run kRuns[kProbes] = {run<0>, run<1>, run<2>, run<3>,
                                run<4>, run<5>, run<6>, run<7>,
                                run<8>, run<9>, run<10>};

}  // namespace

extern "C" int sass_latency_probes() { return kProbes; }

// out: 3 int64 on the host
extern "C" int sass_latency(int p, int m, long long* out) {
  if (p < 0 || p >= kProbes || m < 1) return cudaErrorInvalidValue;
  long long* d = nullptr;
  int err = cudaMalloc(&d, sizeof(long long) * 4);
  if (err != cudaSuccess) return err;
  err = kRuns[p](m, d);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpy(out, d, sizeof(long long) * 3, cudaMemcpyDeviceToHost);
  cudaFree(d);
  return err;
}
