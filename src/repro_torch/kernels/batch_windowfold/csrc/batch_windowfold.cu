// Batched request-window fold on Hopper (sm_90a):
//   out[b, f] = sum_i [keys_i == qkey_b && qt0_b <= ts_i <= qt1_b] * vals[i, f]
// with rows at or past the live count read as 0 (store_windowfold).
//
// Replaces src/repro/kernels/batch_windowfold/kernel.py::
// batch_windowfold_pallas (body _bwf_kernel), computing what
// src/repro/kernels/batch_windowfold/ref.py computes.
//
// Bound: operations.  Every (request, row) pair costs three compares and
// one multiply-add per lane, B * C * (3 + F) operations over 67 TFLOP/s
// f32; the bytes (the C rows' key, ts and F values, read once) take a
// fraction of that at 3.35 TB/s.
//
// Design.  The TPU kernel accumulates a store tile after store tile into
// one output block, in grid order.  GPU blocks run in no order, so the
// store axis C is cut into chunks of CHUNK_ROWS rows, one block column
// each: pass 1 gives every (chunk, request, lane) its partial sum, taken
// over the chunk's rows in row order; pass 2 sums each (request, lane)'s
// partials in chunk order.  No float atomics, so the result is the same
// bits on every run.  A thread owns one (request, lane) output; the
// block's threads read the same row at the same time (one broadcast
// load).  Like the reference's dense product, the kernel multiplies the
// 0/1 mask by the value of every row, so a NaN or Inf value in a row that
// matches no request reaches every output of its lane (0 * NaN = NaN),
// as it does in the reference.
//
// Float rules: --fmad=false; __fmul_rn / __fadd_rn.

#include <cuda_runtime.h>
#include <stdint.h>

#define CHUNK_ROWS 4096
#define THREADS 256

__global__ void bwf_partial_kernel(const int* __restrict__ keys,
                                   const int* __restrict__ ts,
                                   const float* __restrict__ vals,
                                   const int* __restrict__ count, int c_rows,
                                   const int* __restrict__ qkey,
                                   const int* __restrict__ qt0,
                                   const int* __restrict__ qt1, int b, int f,
                                   float* partial) {
  const int chunk = blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;  // (request, lane)
  if (j >= b * f) return;
  const int bi = j / f, fi = j - bi * f;
  const int qk = qkey[bi], t0 = qt0[bi], t1 = qt1[bi];
  const int live = count ? min(*count, c_rows) : c_rows;
  const int lo = chunk * CHUNK_ROWS;
  const int hi = min(c_rows, lo + CHUNK_ROWS);
  float acc = 0.f;
  for (int i = lo; i < hi; ++i) {
    const int k = keys[i], t = ts[i];
    const float v = i < live ? vals[(size_t)i * f + fi] : 0.f;
    const float m = (k == qk && t >= t0 && t <= t1) ? 1.f : 0.f;
    acc = __fadd_rn(acc, __fmul_rn(m, v));
  }
  partial[(size_t)chunk * b * f + j] = acc;
}

__global__ void bwf_reduce_kernel(const float* __restrict__ partial,
                                  int n_chunks, int bf, float* out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= bf) return;
  float acc = 0.f;
  for (int c = 0; c < n_chunks; ++c)
    acc = __fadd_rn(acc, partial[(size_t)c * bf + j]);
  out[j] = acc;
}

extern "C" int bwf_chunk_rows() { return CHUNK_ROWS; }

// keys, ts (c_rows,) int32; vals (c_rows, f) float32; count: device int32
// scalar of live rows, or null for all rows; qkey, qt0, qt1 (b,) int32;
// out (b, f) float32; partial scratch (n_chunks * b * f) float32 with
// n_chunks = ceil(c_rows / CHUNK_ROWS).
extern "C" int bwf_launch(const int* keys, const int* ts, const float* vals,
                          const int* count, int c_rows, const int* qkey,
                          const int* qt0, const int* qt1, int b, int f,
                          float* out, float* partial, void* stream) {
  if (c_rows < 1 || b < 1 || f < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int n_chunks = (c_rows + CHUNK_ROWS - 1) / CHUNK_ROWS;
  const int bf = b * f;
  const int threads = bf < THREADS ? ((bf + 31) / 32) * 32 : THREADS;
  dim3 grid(n_chunks, (bf + threads - 1) / threads);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  bwf_partial_kernel<<<grid, threads, 0, st>>>(keys, ts, vals, count, c_rows,
                                               qkey, qt0, qt1, b, f, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwf_reduce_kernel<<<(bf + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      partial, n_chunks, bf, out);
  return (int)cudaGetLastError();
}
