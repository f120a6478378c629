// Segmented sums on Hopper (sm_90a): out[s, f] = sum of values[i, f] over
// the rows i with seg_ids[i] == s, rows with an id outside [0, S) dropped.
//
// Replaces src/repro/kernels/segagg/kernel.py::segagg_pallas (body
// _segagg_kernel), but computes what src/repro/kernels/segagg/ref.py
// computes: segment_sum after where(ok).  The TPU kernel's one-hot product
// would turn a whole segment tile NaN from one NaN row (0 * NaN = NaN);
// here a NaN reaches only its own segment, as in the reference's ref.py.
//
// Bound: memory.  Each row is read once (its id and F values) and each
// segment written once, (N * (F + 1) + S * F) * 4 bytes over 3.35 TB/s;
// a row costs F additions.
//
// Design.  Rows are not sorted by segment (the store is sorted by key,
// then time), so the sums need an order that does not depend on the
// schedule, and no float atomics.  Two passes:
//   1. one block per chunk of CHUNK rows sorts the chunk's (segment, row)
//      pairs in shared memory (bitonic sort; the pairs are unique, so the
//      result is fixed) and sums each segment's run in row order into a
//      per-chunk partial at the run's first sorted position;
//   2. one thread per (segment, lane) walks the chunks in order, skips a
//      chunk whose segment range misses its segment, finds its run by
//      binary search in the chunk's sorted ids and adds the partial.
// So every sum is taken in row order within a chunk and in chunk order
// across chunks: the same bits on every run.  A one-block-per-segment-tile
// walk over all rows was the other choice; it reads every row once per
// tile and leaves most of the card idle when S is small (600 buckets).
//
// Float rules: compiled with --fmad=false; additions are __fadd_rn.

#include <cuda_runtime.h>
#include <stdint.h>

#define CHUNK 2048
#define SORT_THREADS 512
#define COMBINE_THREADS 256

__global__ void segagg_chunk_kernel(const float* __restrict__ values,
                                    const int* __restrict__ seg, int n,
                                    int f, int s, int* chunk_seg,
                                    float* chunk_sum, int* chunk_lo,
                                    int* chunk_hi) {
  __shared__ unsigned long long keys[CHUNK];
  const unsigned long long NONE = ~0ull;
  const int c = blockIdx.x;
  const long long base = (long long)c * CHUNK;
  const int len = (int)min((long long)CHUNK, (long long)n - base);
  const int tid = threadIdx.x;

  for (int i = tid; i < CHUNK; i += blockDim.x) {
    unsigned long long k = NONE;
    if (i < len) {
      int sid = seg[base + i];
      if (sid >= 0 && sid < s)
        k = ((unsigned long long)(unsigned)sid << 32) | (unsigned)i;
    }
    keys[i] = k;
  }
  __syncthreads();

  // bitonic sort, ascending: segment first, then row within the chunk
  for (int k = 2; k <= CHUNK; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < CHUNK; i += blockDim.x) {
        int ixj = i ^ j;
        if (ixj > i) {
          unsigned long long a = keys[i], b = keys[ixj];
          bool up = (i & k) == 0;
          if ((a > b) == up) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  int* cs = chunk_seg + (size_t)c * CHUNK;
  float* csum = chunk_sum + (size_t)c * CHUNK * f;
  for (int p = tid; p < CHUNK; p += blockDim.x) {
    const unsigned long long k = keys[p];
    const bool valid = k != NONE;
    const unsigned hi = (unsigned)(k >> 32);
    cs[p] = valid ? (int)hi : s;  // s sorts after every real segment
    if (valid && (p + 1 == CHUNK || keys[p + 1] == NONE))
      chunk_hi[c] = (int)hi;
    if (p == 0) chunk_lo[c] = valid ? (int)hi : s;
    if (p == 0 && !valid) chunk_hi[c] = -1;
    const bool start = valid && (p == 0 || (unsigned)(keys[p - 1] >> 32) != hi);
    if (!start) continue;
    for (int ff = 0; ff < f; ++ff) {
      float acc = 0.f;
      for (int q = p; q < CHUNK && keys[q] != NONE &&
                      (unsigned)(keys[q] >> 32) == hi;
           ++q) {
        long long row = base + (long long)(keys[q] & 0xffffffffull);
        acc = __fadd_rn(acc, values[row * f + ff]);
      }
      csum[(size_t)p * f + ff] = acc;
    }
  }
}

__global__ void segagg_combine_kernel(const int* __restrict__ chunk_seg,
                                      const float* __restrict__ chunk_sum,
                                      const int* __restrict__ chunk_lo,
                                      const int* __restrict__ chunk_hi,
                                      int n_chunks, int f, int s,
                                      float* out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)s * f) return;
  const int sid = (int)(idx / f);
  const int ff = (int)(idx - (long long)sid * f);
  float acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    if (sid < chunk_lo[c] || sid > chunk_hi[c]) continue;
    const int* cs = chunk_seg + (size_t)c * CHUNK;
    int lo = 0, hi = CHUNK;  // first position with id >= sid
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (cs[mid] < sid)
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo < CHUNK && cs[lo] == sid)
      acc = __fadd_rn(acc, chunk_sum[((size_t)c * CHUNK + lo) * f + ff]);
  }
  out[idx] = acc;
}

// values (n, f) float32, seg (n,) int32, out (s, f) float32; scratch:
// chunk_seg (n_chunks * CHUNK) int32, chunk_sum (n_chunks * CHUNK * f)
// float32, chunk_lo / chunk_hi (n_chunks) int32, n_chunks = ceil(n / CHUNK).
extern "C" int segagg_chunk_rows() { return CHUNK; }

extern "C" int segagg_launch(const float* values, const int* seg, int n,
                             int f, int s, float* out, int* chunk_seg,
                             float* chunk_sum, int* chunk_lo, int* chunk_hi,
                             void* stream) {
  if (n < 1 || f < 1 || s < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int n_chunks = (n + CHUNK - 1) / CHUNK;
  segagg_chunk_kernel<<<n_chunks, SORT_THREADS, 0, st>>>(
      values, seg, n, f, s, chunk_seg, chunk_sum, chunk_lo, chunk_hi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)s * f;
  const unsigned blocks =
      (unsigned)((total + COMBINE_THREADS - 1) / COMBINE_THREADS);
  segagg_combine_kernel<<<blocks, COMBINE_THREADS, 0, st>>>(
      chunk_seg, chunk_sum, chunk_lo, chunk_hi, n_chunks, f, s, out);
  return (int)cudaGetLastError();
}
