// Batched request-window fold on Hopper (sm_90a):
//   out[b, f] = sum_i [keys_i == qkey_b && qt0_b <= ts_i <= qt1_b] * vals[i, f]
// with rows at or past the live count read as 0 (store_windowfold).
//
// Replaces src/repro/kernels/batch_windowfold/kernel.py::
// batch_windowfold_pallas (body _bwf_kernel), computing what
// src/repro/kernels/batch_windowfold/ref.py computes.
//
// Bound: memory.  The least work reads every live row's key, ts and F
// values once and writes the (B, F) sums; a request matches a few dozen
// rows of a store sorted by (key, ts), so the dense count of B * C
// (request, row) pairs is no longer the least work.
//
// Arithmetic (the same function, bit for bit, as the dense design before
// it).  The store axis is cut into chunks of CHUNK_ROWS rows; a
// (chunk, request, lane) partial is the fold acc = acc + m * v over the
// chunk's rows in row order from acc = +0.0 (m the 0/1 mask), and the
// result is the partials folded in chunk order.  Two facts let the kernel
// skip rows and partials without changing a bit: acc is never -0.0 (a sum
// is -0.0 only when both terms are), so adding m * v = +-0.0 from an
// unmatched row with a finite value leaves acc as it was; and an
// unmatched row with a NaN or +-Inf value makes acc NaN for good
// (0 * NaN = 0 * Inf = NaN), as the reference's dense product does.
//
// Design.
//   pass 0 (bwf_stats_kernel): one block per chunk reads its live rows
//     once, coalesced, many loads in flight, and records the lexicographic minimum and maximum
//     of (key, ts) of the chunk and of each 32-row group, which lanes hold
//     a non-finite live value in the chunk, and whether a group holds any.
//   pass 1 (bwf_partial_kernel): one block per (chunk, 256 requests), one
//     thread per request.  A request whose closed interval
//     [(qkey, qt0), (qkey, qt1)] misses the chunk's [min, max] matches no
//     row of it: its partial is +0.0, or NaN in a lane with a non-finite
//     live value, written without reading the chunk.  The others are
//     listed and dealt to the block's warps: a warp skips the groups whose
//     range its request misses and that hold no non-finite value; for up
//     to four other groups at once every lane loads one row, computes its
//     mask once and m * v for up to eight lanes; shuffles bring the rows'
//     products to the accumulators in row order.
//   pass 2 (bwf_reduce_kernel): one block per request folds each lane's
//     partials in chunk order; +0.0 partials change nothing, so each warp
//     ballots its non-zero partials and one thread adds those in order.
// No float atomics: the same bits on every run.
//
// Float rules: --fmad=false; __fmul_rn / __fadd_rn.

#include <cuda_runtime.h>
#include <stdint.h>

#define CHUNK_ROWS 4096
#define GROUP_ROWS 32
#define GROUPS (CHUNK_ROWS / GROUP_ROWS)
#define THREADS 256
#define LANES 8
#define FULL 0xffffffffu
#define KEY_MAX 0x7fffffffffffffffll
#define KEY_MIN (-KEY_MAX - 1)

// (key, ts) as one int64 in lexicographic order
__device__ __forceinline__ long long pack(int key, int ts) {
  return (long long)key * 4294967296ll +
         (long long)((unsigned)ts ^ 0x80000000u);
}

__device__ __forceinline__ int live_rows(const int* count, int c_rows) {
  return count ? max(0, min(*count, c_rows)) : c_rows;
}

// scratch layout: chunk min/max and group min/max (int64), then the
// chunk's per-lane and the groups' non-finite flags (int32), then the
// (n_chunks, B, F) partials (float32)
struct Scratch {
  long long *cmin, *cmax, *gmin, *gmax;
  int *cnf, *gnf;
  float* partial;
};

__host__ __device__ inline Scratch carve(void* base, int n_chunks, int b,
                                         int f) {
  Scratch s;
  long long* p = reinterpret_cast<long long*>(base);
  s.cmin = p;
  s.cmax = p + n_chunks;
  s.gmin = p + 2 * n_chunks;
  s.gmax = s.gmin + (size_t)n_chunks * GROUPS;
  int* q = reinterpret_cast<int*>(s.gmax + (size_t)n_chunks * GROUPS);
  s.cnf = q;
  s.gnf = q + (size_t)n_chunks * f;
  s.partial = reinterpret_cast<float*>(s.gnf + (size_t)n_chunks * GROUPS);
  return s;
}

__device__ __forceinline__ long long warp_min(long long v) {
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ long long warp_max(long long v) {
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__global__ void __launch_bounds__(THREADS)
    bwf_stats_kernel(const int* __restrict__ keys, const int* __restrict__ ts,
                     const float* __restrict__ vals,
                     const int* __restrict__ count, int c_rows, int f,
                     Scratch s) {
  __shared__ long long s_min[THREADS / 32], s_max[THREADS / 32];
  __shared__ int s_gbad[GROUPS];
  extern __shared__ int s_nf[];  // f lane flags
  const int chunk = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = chunk * CHUNK_ROWS;
  const int nrows = max(0, min(CHUNK_ROWS, live_rows(count, c_rows) - r0));
  for (int i = tid; i < f; i += THREADS) s_nf[i] = 0;
  for (int i = tid; i < GROUPS; i += THREADS) s_gbad[i] = 0;
  __syncthreads();
  // non-finite live values: the chunk's values as one flat array, eight
  // coalesced loads in flight per thread
  const float* vc = vals + (size_t)r0 * f;
  const int nv = nrows * f;
  for (int i0 = tid; i0 < nv; i0 += 8 * THREADS) {
    float x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = i0 + k * THREADS;
      x[k] = i < nv ? vc[i] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (!isfinite(x[k])) {
        const int i = i0 + k * THREADS;
        atomicOr(&s_nf[i % f], 1);
        s_gbad[(i / f) / GROUP_ROWS] = 1;
      }
    }
  }
  // key ranges: each warp's groups, all their loads in flight first
  constexpr int PER_WARP = GROUPS / (THREADS / 32);
  long long lo[PER_WARP];
#pragma unroll
  for (int k = 0; k < PER_WARP; ++k) {
    const int row = (warp + k * (THREADS / 32)) * GROUP_ROWS + lane;
    lo[k] = row < nrows ? pack(keys[r0 + row], ts[r0 + row]) : KEY_MAX;
  }
  __syncthreads();
  long long wmin = KEY_MAX, wmax = KEY_MIN;
#pragma unroll
  for (int k = 0; k < PER_WARP; ++k) {
    const int g = warp + k * (THREADS / 32);
    const bool dead = g * GROUP_ROWS + lane >= nrows;
    const long long gl = warp_min(lo[k]);
    const long long gh = warp_max(dead ? KEY_MIN : lo[k]);
    if (lane == 0) {
      const size_t gi = (size_t)chunk * GROUPS + g;
      s.gmin[gi] = gl;
      s.gmax[gi] = gh;
      s.gnf[gi] = s_gbad[g];
    }
    wmin = min(wmin, gl);
    wmax = max(wmax, gh);
  }
  if (lane == 0) {
    s_min[warp] = wmin;
    s_max[warp] = wmax;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < THREADS / 32; ++w) {
      wmin = min(wmin, s_min[w]);
      wmax = max(wmax, s_max[w]);
    }
    s.cmin[chunk] = wmin;
    s.cmax[chunk] = wmax;
  }
  for (int i = tid; i < f; i += THREADS)
    s.cnf[(size_t)chunk * f + i] = s_nf[i];
}

#define MAX_BATCH 4

__global__ void __launch_bounds__(THREADS)
    bwf_partial_kernel(const int* __restrict__ keys, const int* __restrict__ ts,
                       const float* __restrict__ vals,
                       const int* __restrict__ count, int c_rows,
                       const int* __restrict__ qkey,
                       const int* __restrict__ qt0,
                       const int* __restrict__ qt1, int b, int f, Scratch s) {
  __shared__ long long s_gmin[GROUPS], s_gmax[GROUPS];
  __shared__ int s_gnf[GROUPS];
  __shared__ int s_hit[THREADS], s_hk[THREADS], s_h0[THREADS],
      s_h1[THREADS], s_nhit;
  const int chunk = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int bi = blockIdx.y * THREADS + tid;
  const int live = live_rows(count, c_rows);
  const bool act = bi < b;
  int my_k = 0, my_t0 = 0, my_t1 = -1;
  if (act) {
    my_k = qkey[bi];
    my_t0 = qt0[bi];
    my_t1 = qt1[bi];
  }
  const long long qlo = pack(my_k, my_t0), qhi = pack(my_k, my_t1);
  const bool hit = act && qlo <= s.cmax[chunk] && qhi >= s.cmin[chunk];
  if (act && !hit) {
    // no row of the chunk matches: +0.0, or NaN where a live value of
    // the lane is not finite
    float* part = s.partial + ((size_t)chunk * b + bi) * f;
    const int* nf = s.cnf + (size_t)chunk * f;
    for (int j = 0; j < f; ++j)
      part[j] = nf[j] ? __int_as_float(0x7fc00000) : 0.f;
  }
  if (tid == 0) s_nhit = 0;
  if (!__syncthreads_or(hit)) return;
  // the block's hit requests in a list (their order varies from run to
  // run; each request's fold does not depend on it), one warp each
  if (hit) {
    const int h = atomicAdd(&s_nhit, 1);
    s_hit[h] = tid;
    s_hk[h] = my_k;
    s_h0[h] = my_t0;
    s_h1[h] = my_t1;
  }
  for (int g = tid; g < GROUPS; g += THREADS) {
    const size_t gi = (size_t)chunk * GROUPS + g;
    s_gmin[g] = s.gmin[gi];
    s_gmax[g] = s.gmax[gi];
    s_gnf[g] = s.gnf[gi];
  }
  __syncthreads();
  const int row0 = chunk * CHUNK_ROWS;
  for (int h = warp; h < s_nhit; h += THREADS / 32) {
    const int r = blockIdx.y * THREADS + s_hit[h];
    const int qk = s_hk[h], t0 = s_h0[h], t1 = s_h1[h];
    const long long lo = pack(qk, t0), hi = pack(qk, t1);
    // the groups the request visits: in its range, or holding a
    // non-finite value (its 0 * NaN must reach the fold)
    unsigned vis[GROUPS / 32];
#pragma unroll
    for (int k = 0; k < GROUPS / 32; ++k) {
      const int g = k * 32 + lane;
      vis[k] = __ballot_sync(
          FULL, s_gnf[g] || (lo <= s_gmax[g] && hi >= s_gmin[g]));
    }
    float* out = s.partial + ((size_t)chunk * b + r) * f;
    for (int f0 = 0; f0 < f; f0 += LANES) {
      const int nf = min(LANES, f - f0);
      float acc[LANES];
#pragma unroll
      for (int j = 0; j < LANES; ++j) acc[j] = 0.f;
      int k = 0;
      unsigned gm = vis[0];
      while (true) {
        // up to MAX_BATCH visited groups: every lane loads its row of
        // each before any is folded
        int rows[MAX_BATCH], nb = 0;
        while (nb < MAX_BATCH) {
          while (!gm && k + 1 < GROUPS / 32) gm = vis[++k];
          if (!gm) break;
          rows[nb++] = row0 + (k * 32 + __ffs(gm) - 1) * GROUP_ROWS + lane;
          gm &= gm - 1;
        }
        if (nb == 0) break;
        float prod[MAX_BATCH][LANES];
#pragma unroll
        for (int q = 0; q < MAX_BATCH; ++q) {
          const int row = rows[q < nb ? q : 0];
          const bool ok = q < nb && row < live;
          float m = 0.f;
          if (ok) {
            const int kk = keys[row], t = ts[row];
            m = (kk == qk && t >= t0 && t <= t1) ? 1.f : 0.f;
          }
#pragma unroll
          for (int j = 0; j < LANES; ++j)
            prod[q][j] = (ok && j < nf)
                             ? __fmul_rn(m, vals[(size_t)row * f + f0 + j])
                             : 0.f;
        }
        for (int q = 0; q < nb; ++q) {
          for (int i = 0; i < 32; ++i) {
#pragma unroll
            for (int j = 0; j < LANES; ++j) {
              if (j < nf)
                acc[j] =
                    __fadd_rn(acc[j], __shfl_sync(FULL, prod[q][j], i));
            }
          }
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < LANES; ++j)
          if (j < nf) out[f0 + j] = acc[j];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    bwf_reduce_kernel(const float* __restrict__ partial, int n_chunks, int b,
                      int f, float* out) {
  __shared__ float s_val[THREADS];
  __shared__ unsigned s_mask[THREADS / 32];
  const int bi = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  for (int j = 0; j < f; ++j) {
    float acc = 0.f;
    for (int c0 = 0; c0 < n_chunks; c0 += THREADS) {
      const int c = c0 + tid;
      const float v =
          c < n_chunks ? partial[((size_t)c * b + bi) * f + j] : 0.f;
      const unsigned m = __ballot_sync(FULL, __float_as_int(v) != 0);
      s_val[tid] = v;
      if (lane == 0) s_mask[warp] = m;
      __syncthreads();
      if (tid == 0) {
        for (int w = 0; w < THREADS / 32; ++w) {
          for (unsigned bits = s_mask[w]; bits; bits &= bits - 1)
            acc = __fadd_rn(acc, s_val[w * 32 + __ffs(bits) - 1]);
        }
      }
      __syncthreads();
    }
    if (tid == 0) out[(size_t)bi * f + j] = acc;
  }
}

extern "C" int bwf_chunk_rows() { return CHUNK_ROWS; }

// 4-byte words of the scratch buffer bwf_launch takes
extern "C" long long bwf_scratch_words(int c_rows, int b, int f) {
  const long long n = (c_rows + CHUNK_ROWS - 1) / CHUNK_ROWS;
  return 2 * (2 * n + 2 * n * GROUPS) + n * f + n * GROUPS + n * b * f;
}

// keys, ts (c_rows,) int32; vals (c_rows, f) float32; count: device int32
// scalar of live rows, or null for all rows; qkey, qt0, qt1 (b,) int32;
// out (b, f) float32; scratch: bwf_scratch_words(c_rows, b, f) words,
// 8-byte aligned.
extern "C" int bwf_launch(const int* keys, const int* ts, const float* vals,
                          const int* count, int c_rows, const int* qkey,
                          const int* qt0, const int* qt1, int b, int f,
                          float* out, void* scratch, void* stream) {
  if (c_rows < 1 || b < 1 || f < 1 || f > 8192 ||
      ((uintptr_t)scratch & 7))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int n_chunks = (c_rows + CHUNK_ROWS - 1) / CHUNK_ROWS;
  const int tiles = (b + THREADS - 1) / THREADS;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  Scratch s = carve(scratch, n_chunks, b, f);
  bwf_stats_kernel<<<n_chunks, THREADS, f * sizeof(int), st>>>(
      keys, ts, vals, count, c_rows, f, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwf_partial_kernel<<<dim3(n_chunks, tiles), THREADS, 0, st>>>(
      keys, ts, vals, count, c_rows, qkey, qt0, qt1, b, f, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bwf_reduce_kernel<<<b, THREADS, 0, st>>>(s.partial, n_chunks, b, f, out);
  return (int)cudaGetLastError();
}
