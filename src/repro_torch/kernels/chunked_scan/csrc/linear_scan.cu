// First-order linear recurrence on Hopper (sm_90a), forward and backward:
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

// Backward of the recurrence (no TPU kernel: the reference trains through
// jax.vjp of its plain associative scan).  Given g = dL/dy:
//   lam[T-1] = g[T-1],  lam[t] = g[t] + a[t+1] * lam[t+1],
//   db[t] = lam[t],  da[t] = lam[t] * y[t-1]  (da[0] = 0, as y[-1] = 0).
// The same design as the forward, walked in reverse: one thread per
// (batch, lane) column, lam and a[t+1] in registers, UNROLL steps of g, a
// and y[t-1] loaded ahead of the chain.  Bound: memory; a, y and g read
// once, da and db written once, 5 * B * T * D * 4 bytes (hymba-1.5b's
// training micro-batch, (2, 2048, 51,200): 4.19 GB, 1.25 ms at
// 3.35 TB/s); three flops per element.  Float rules as the forward:
// lam is __fmul_rn then __fadd_rn, da one __fmul_rn, the roundings of
// ref.py's linear_scan_bwd_ref, so the two agree bit for bit.
__global__ void linear_scan_bwd_kernel(const float* __restrict__ a,
                                       const float* __restrict__ y,
                                       const float* __restrict__ g,
                                       float* __restrict__ da,
                                       float* __restrict__ db, int t,
                                       long long d) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= d) return;
  const size_t base = (size_t)blockIdx.y * (size_t)t * (size_t)d + lane;
  const float* ap = a + base;
  const float* yp = y + base;
  const float* gp = g + base;
  float* dap = da + base;
  float* dbp = db + base;
  int i = t - 1;
  float lam = gp[(size_t)i * d];
  dbp[(size_t)i * d] = lam;
  dap[(size_t)i * d] = i > 0 ? __fmul_rn(lam, yp[(size_t)(i - 1) * d]) : 0.f;
  float a_next = ap[(size_t)i * d];
  --i;
  // steps i, i - 1, ..., i - UNROLL + 1, all >= 1 (step 0 has no y[-1])
  for (; i - UNROLL + 1 >= 1; i -= UNROLL) {
    float gv[UNROLL], av[UNROLL], yv[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const size_t s = (size_t)(i - k);
      gv[k] = gp[s * d];
      av[k] = ap[s * d];
      yv[k] = yp[(s - 1) * d];
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const size_t s = (size_t)(i - k);
      lam = __fadd_rn(gv[k], __fmul_rn(a_next, lam));
      dbp[s * d] = lam;
      dap[s * d] = __fmul_rn(lam, yv[k]);
      a_next = av[k];
    }
  }
  for (; i >= 1; --i) {
    const size_t s = (size_t)i;
    lam = __fadd_rn(gp[s * d], __fmul_rn(a_next, lam));
    dbp[s * d] = lam;
    dap[s * d] = __fmul_rn(lam, yp[(s - 1) * d]);
    a_next = ap[s * d];
  }
  if (i == 0) {
    lam = __fadd_rn(gp[0], __fmul_rn(a_next, lam));
    dbp[0] = lam;
    dap[0] = 0.f;
  }
}

static int grid_of(int nb, int t, long long d, dim3* grid) {
  if (nb < 1 || nb > 65535 || t < 1 || d < 1) return 1;
  const long long blocks = (d + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return 1;
  *grid = dim3((unsigned)blocks, (unsigned)nb);
  return 0;
}

// a, x, y: (nb, t, d) float32, contiguous.
extern "C" int linear_scan_launch(const float* a, const float* x, float* y,
                                  int nb, int t, long long d,
                                  void* stream) {
  dim3 grid;
  if (grid_of(nb, t, d, &grid)) return (int)cudaErrorInvalidValue;
  linear_scan_kernel<<<grid, THREADS, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(a, x, y, t,
                                                                  d);
  return (int)cudaGetLastError();
}

// a, y, g, da, db: (nb, t, d) float32, contiguous.
extern "C" int linear_scan_bwd_launch(const float* a, const float* y,
                                      const float* g, float* da, float* db,
                                      int nb, int t, long long d,
                                      void* stream) {
  dim3 grid;
  if (grid_of(nb, t, d, &grid)) return (int)cudaErrorInvalidValue;
  linear_scan_bwd_kernel<<<grid, THREADS, 0,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      a, y, g, da, db, t, d);
  return (int)cudaGetLastError();
}
