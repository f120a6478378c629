// First-order linear recurrence on Hopper (sm_90a):
//   y[b, t, d] = a[b, t, d] * y[b, t - 1, d] + x[b, t, d],  y[b, -1, d] = 0.
//
// Replaces src/repro/kernels/chunked_scan/kernel.py::linear_scan_pallas
// (body _scan_kernel).  On the TPU the grid walks the time chunks in
// order and carries the (1, D) state in VMEM scratch from one grid step
// to the next.  GPU blocks run in no order, so here the whole time walk
// of a column stays inside one thread: one thread per (batch, lane)
// column, the state in a register, T walked in order.
//
// Bound: memory.  a and x are read once and y written once,
// 3 * B * T * D * 4 bytes over 3.35 TB/s (the SSM prefill of hymba-1.5b,
// B = 8, T = 1024, D = d_inner * state = 51,200: 5.03 GB, 1.50 ms); two
// flops per element.  Neighbouring threads own neighbouring lanes, so
// every load and store of a warp is one coalesced 128-byte line.  The
// chain through the state is serial, so each thread loads UNROLL steps
// of a and x ahead into registers before it folds them: the loads of a
// group are independent and in flight together.
//
// Float rules: compiled with --fmad=false; the step is __fmul_rn then
// __fadd_rn, the two roundings of ref.py's `a * h + b`, so the kernel
// equals the plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define UNROLL 8

__global__ void linear_scan_kernel(const float* __restrict__ a,
                                   const float* __restrict__ x,
                                   float* __restrict__ y, int t,
                                   long long d) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= d) return;
  const size_t base = (size_t)blockIdx.y * (size_t)t * (size_t)d + lane;
  const float* ap = a + base;
  const float* xp = x + base;
  float* yp = y + base;
  float h = 0.f;
  int i = 0;
  for (; i + UNROLL <= t; i += UNROLL) {
    float av[UNROLL], xv[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      av[k] = ap[(size_t)(i + k) * d];
      xv[k] = xp[(size_t)(i + k) * d];
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      h = __fadd_rn(__fmul_rn(av[k], h), xv[k]);
      yp[(size_t)(i + k) * d] = h;
    }
  }
  for (; i < t; ++i) {
    h = __fadd_rn(__fmul_rn(ap[(size_t)i * d], h), xp[(size_t)i * d]);
    yp[(size_t)i * d] = h;
  }
}

// a, x, y: (nb, t, d) float32, contiguous.
extern "C" int linear_scan_launch(const float* a, const float* x, float* y,
                                  int nb, int t, long long d,
                                  void* stream) {
  if (nb < 1 || nb > 65535 || t < 1 || d < 1)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (d + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)nb);
  linear_scan_kernel<<<grid, THREADS, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(a, x, y, t,
                                                                  d);
  return (int)cudaGetLastError();
}
