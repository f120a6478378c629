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
// then time), and the sums need an order that does not depend on the
// schedule, with no float atomics.  No sort is needed for that: every
// order that depends only on the data gives the same bits on every run.
// Two passes, per slice of at most 4 lanes (FS):
//   1. segagg_hist_kernel: a grid of (segment tile, row block).  Each warp
//      keeps a private histogram of its tile's segments in shared memory
//      and walks its own rows, 32 at a time (U batches of loads in
//      flight, the next U issued before the current ones are folded).
//      In a batch, __match_any_sync groups the lanes that hold one segment,
//      and one lane of each group adds the group's sum to the warp's
//      histogram (one writer per segment, so no atomics).  When every group
//      is one run of lanes (sorted ids, or all distinct), the sums come
//      from a segmented inclusive scan (five shuffles a lane); otherwise
//      every lane walks the 32 lanes' shuffles in order and keeps its
//      group's values (the same instructions for every lane, so the groups
//      do not diverge).  The warps' histograms are then summed in
//      warp order into a (row block, S, FS) partial.  A tile holds as many
//      segments as 24 KB per warp allows (2,048 at FS = 3), so S = 600 is
//      one tile.  A larger S takes several tiles, each keeping its own
//      segments; a first small pass (segagg_range_kernel) then records each
//      chunk's [min, max] id, and a tile skips the chunks whose ids miss
//      it without reading them (with sorted ids, the rule for time
//      buckets, a chunk is read by one or two tiles).
//   2. segagg_combine_kernel: a group of lpc lanes per (segment, lane)
//      sums the row blocks' partials, lane j taking blocks j, j + lpc, ...
//      in order, then a fixed __shfl_xor_sync tree.
// So every sum has a fixed bracketing (the scan's tree or lane order in a
// batch, batch order in a warp, warp order in a block, block order in the
// combine), set by the data alone.
//
// Float rules: compiled with --fmad=false; additions are __fadd_rn.

#include <cuda_runtime.h>
#include <stdint.h>

#define NW 4                    // warps per block of pass 1
#define THREADS (NW * 32)
#define U 8                     // batches of 32 rows loaded together
#define CH (32 * U)             // rows of a warp's step
#define MAX_FS 4                // lanes per slice
#define HIST_FLOATS 6144        // per warp: 24 KB of shared memory
#define SMS 132                 // an H100's SMs
#define SMEM_PER_SM (227 * 1024)
#define MAX_BLOCKS_PER_SM 4     // pass-1 blocks aimed at each SM
#define PARTIAL_FLOATS (4 << 20)  // scratch the partials may take: 16 MB
#define COMBINE_THREADS 256

template <int FS>
struct Batch {
  int sid[U];
  float v[U][FS];
};

template <int FS>
__device__ __forceinline__ void load_batches(const float* __restrict__ values,
                                             const int* __restrict__ seg,
                                             long long base, long long end,
                                             int ld, int f0, int lane,
                                             Batch<FS>& b) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long row = base + u * 32 + lane;
    const bool in = row < end;
    b.sid[u] = in ? __ldg(seg + row) : -1;
#pragma unroll
    for (int f = 0; f < FS; ++f)
      b.v[u][f] = in ? __ldg(values + row * ld + f0 + f) : 0.f;
  }
}

// the [min, max] of the valid ids of each chunk of CH rows (INT_MAX,
// INT_MIN when it holds none), one warp per chunk
__global__ void __launch_bounds__(256)
    segagg_range_kernel(const int* __restrict__ seg, long long n, int s,
                        long long n_chunks, int2* __restrict__ range) {
  const long long c = ((long long)blockIdx.x * 256 + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= n_chunks) return;  // warp-uniform
  int lo = 2147483647, hi = -2147483647 - 1;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long row = c * CH + u * 32 + lane;
    const int sid = row < n ? __ldg(seg + row) : -1;
    if (sid >= 0 && sid < s) {
      lo = min(lo, sid);
      hi = max(hi, sid);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) range[c] = make_int2(lo, hi);
}

template <int FS>
__global__ void __launch_bounds__(THREADS)
    segagg_hist_kernel(const float* __restrict__ values,
                       const int* __restrict__ seg, long long n, int ld,
                       int f0, int s, int st, long long rows_per_block,
                       const int2* __restrict__ range,
                       float* __restrict__ partial) {
  extern __shared__ float hist[];  // [NW][st * FS]
  const int tile = blockIdx.x;
  const long long rb = blockIdx.y;
  const int seg_lo = tile * st;
  const int seg_n = min(st, s - seg_lo);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int span = seg_n * FS;

  for (int i = tid; i < NW * span; i += THREADS) {
    const int w = i / span;
    hist[(size_t)w * st * FS + (i - w * span)] = 0.f;
  }
  __syncthreads();

  const long long r0 = rb * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  const long long per_warp = rows_per_block / NW;  // a multiple of CH
  const long long a = r0 + warp * per_warp;
  const long long z = min(r1, a + per_warp);
  float* h = hist + (size_t)warp * st * FS;

  // with several tiles, a chunk whose ids miss this tile is not read
  auto skip = [&](long long row) {
    if (range == nullptr) return false;
    const int2 r = range[row / CH];
    return r.x >= seg_lo + seg_n || r.y < seg_lo;
  };
  long long base = a;
  while (base < z && skip(base)) base += CH;
  Batch<FS> cur, nxt;
  if (base < z) load_batches<FS>(values, seg, base, z, ld, f0, lane, cur);
  while (base < z) {
    long long next = base + CH;
    while (next < z && skip(next)) next += CH;
    if (next < z) load_batches<FS>(values, seg, next, z, ld, f0, lane, nxt);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int local = cur.sid[u] - seg_lo;
      const bool valid = cur.sid[u] >= 0 && cur.sid[u] < s && local >= 0 &&
                         local < seg_n;
      if (!__any_sync(0xffffffffu, valid)) continue;
      // lanes of one segment; an invalid lane is a group of its own
      const unsigned peers =
          __match_any_sync(0xffffffffu, valid ? local : -1 - lane);
      const int first = __ffs(peers) - 1, last = 31 - __clz(peers);
      // a group that is one run of lanes (the rule when the ids come
      // sorted, and for every group of one lane)
      const bool run =
          (peers >> first) == (0xffffffffu >> (31 - last + first));
      if (__all_sync(0xffffffffu, run)) {
        // runs only: an inclusive scan inside each run (a fixed
        // Hillis-Steele bracketing), whose last lane holds the run's sum
#pragma unroll
        for (int f = 0; f < FS; ++f) {
          float acc = cur.v[u][f];
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const float y = __shfl_up_sync(0xffffffffu, acc, off);
            if (lane - off >= first) acc = __fadd_rn(y, acc);
          }
          if (valid && lane == last)
            h[local * FS + f] = __fadd_rn(h[local * FS + f], acc);
        }
      } else {
        // every lane walks the 32 lanes in order (no divergence) and keeps
        // its group's values; the group's lowest lane adds the sum
#pragma unroll
        for (int f = 0; f < FS; ++f) {
          float acc = 0.f;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const float y = __shfl_sync(0xffffffffu, cur.v[u][f], i);
            if ((peers >> i) & 1u) acc = __fadd_rn(acc, y);
          }
          if (valid && lane == first)
            h[local * FS + f] = __fadd_rn(h[local * FS + f], acc);
        }
      }
      __syncwarp();  // the next batch's leader may add to the same bin
    }
    cur = nxt;
    base = next;
  }
  __syncthreads();

  float* out = partial + ((size_t)rb * s + seg_lo) * FS;
  for (int i = tid; i < span; i += THREADS) {
    float acc = hist[i];
#pragma unroll
    for (int w = 1; w < NW; ++w)
      acc = __fadd_rn(acc, hist[(size_t)w * st * FS + i]);
    out[i] = acc;
  }
}

// lpc lanes (a power of two, at most 32) per (segment, lane of the slice):
// lane j of the group sums row blocks j, j + lpc, ... in order, then the
// group joins its sums in a fixed __shfl_xor_sync tree
__global__ void __launch_bounds__(COMBINE_THREADS)
    segagg_combine_kernel(const float* __restrict__ partial, int n_blocks,
                          int s, int fs, int ld, int f0, int lpc,
                          float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * COMBINE_THREADS + threadIdx.x;
  const long long col = t / lpc;
  const int j = (int)(t - col * lpc);
  const long long cols = (long long)s * fs;
  const bool ok = col < cols;
  float acc = 0.f;
  if (ok)
    for (int b = j; b < n_blocks; b += lpc)
      acc = __fadd_rn(acc, partial[(size_t)b * cols + col]);
  for (int off = lpc >> 1; off > 0; off >>= 1)  // uniform: lpc is
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (ok && j == 0) {
    const long long sid = col / fs;
    out[sid * ld + f0 + (col - sid * fs)] = acc;
  }
}

struct Plan {
  int fs, st, n_tiles, lpc;
  long long rows_per_block, n_blocks;
  size_t smem;
};

static long long lmin(long long a, long long b) { return a < b ? a : b; }

// the segment tile that fits the warps' histograms, the row blocks, and
// the combine's lanes per column
static Plan plan_slice(long long n, int fs, int s) {
  Plan p;
  p.fs = fs;
  p.st = (int)lmin(s, HIST_FLOATS / fs);
  p.n_tiles = (s + p.st - 1) / p.st;
  p.smem = (size_t)NW * p.st * fs * sizeof(float);
  const long long per_sm =
      lmin(MAX_BLOCKS_PER_SM, (long long)(SMEM_PER_SM / p.smem));
  const long long step = (long long)NW * 32 * U;
  // one row block per slot when S is one tile; with several tiles, as
  // many row blocks as keep the partials within PARTIAL_FLOATS (sorted
  // ids put a row block's work in one or two tiles, so fewer, larger row
  // blocks would leave most SMs idle)
  long long blocks = SMS * per_sm / p.n_tiles;
  const long long cap = PARTIAL_FLOATS / ((long long)s * fs);
  if (cap > blocks) blocks = lmin(cap, SMS * per_sm);
  blocks = lmin(blocks < 1 ? 1 : blocks, (n + step - 1) / step);
  p.rows_per_block = ((n + blocks - 1) / blocks + step - 1) / step * step;
  p.n_blocks = (n + p.rows_per_block - 1) / p.rows_per_block;
  p.lpc = 1;
  while (p.lpc < 32 && p.lpc * 8 < p.n_blocks) p.lpc <<= 1;
  return p;
}

// scratch of a slice in floats: its partials, then (with several tiles)
// the chunks' id ranges
static long long slice_floats(const Plan& p, long long n, int s) {
  const long long part = (p.n_blocks * (long long)s * p.fs + 1) / 2 * 2;
  return part + (p.n_tiles > 1 ? 2 * ((n + CH - 1) / CH) : 0);
}

// floats of scratch a call needs: the largest slice's (the slices run
// one after another and share it)
extern "C" long long segagg_scratch_floats(long long n, int f, int s) {
  if (n < 1 || f < 1 || s < 1) return 0;
  const int sizes[2] = {(int)lmin(f, MAX_FS), f % MAX_FS};
  long long most = 0;
  for (int fs : sizes) {
    if (fs == 0) continue;
    const long long need = slice_floats(plan_slice(n, fs, s), n, s);
    if (need > most) most = need;
  }
  return most;
}

template <int FS>
static cudaError_t launch_slice(const float* values, const int* seg,
                                long long n, int f, int f0, int s,
                                float* out, float* partial,
                                cudaStream_t st) {
  const Plan p = plan_slice(n, FS, s);
  int2* range = nullptr;
  if (p.n_tiles > 1) {
    const long long n_chunks = (n + CH - 1) / CH;
    range = reinterpret_cast<int2*>(
        partial + (p.n_blocks * (long long)s * FS + 1) / 2 * 2);
    segagg_range_kernel<<<(unsigned)((n_chunks * 32 + 255) / 256), 256, 0,
                          st>>>(seg, n, s, n_chunks, range);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  cudaError_t err = cudaFuncSetAttribute(
      segagg_hist_kernel<FS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      NW * HIST_FLOATS * (int)sizeof(float));
  if (err != cudaSuccess) return err;
  segagg_hist_kernel<FS><<<dim3(p.n_tiles, (unsigned)p.n_blocks), THREADS,
                           p.smem, st>>>(values, seg, n, f, f0, s, p.st,
                                         p.rows_per_block, range, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long threads = (long long)s * FS * p.lpc;
  const unsigned blocks =
      (unsigned)((threads + COMBINE_THREADS - 1) / COMBINE_THREADS);
  segagg_combine_kernel<<<blocks, COMBINE_THREADS, 0, st>>>(
      partial, (int)p.n_blocks, s, FS, f, f0, p.lpc, out);
  return cudaGetLastError();
}

// values (n, f) float32, seg (n,) int32, out (s, f) float32; partial:
// segagg_scratch_floats(n, f, s) float32 of scratch.  The lanes go in
// slices of up to MAX_FS, one after another on the stream.
extern "C" int segagg_launch(const float* values, const int* seg, long long n,
                             int f, int s, float* out, float* partial,
                             void* stream) {
  if (n < 1 || f < 1 || s < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  for (int f0 = 0; f0 < f; f0 += MAX_FS) {
    const int fs = (int)lmin(MAX_FS, f - f0);
    cudaError_t err;
    switch (fs) {
      case 1:
        err = launch_slice<1>(values, seg, n, f, f0, s, out, partial, st);
        break;
      case 2:
        err = launch_slice<2>(values, seg, n, f, f0, s, out, partial, st);
        break;
      case 3:
        err = launch_slice<3>(values, seg, n, f, f0, s, out, partial, st);
        break;
      default:
        err = launch_slice<4>(values, seg, n, f, f0, s, out, partial, st);
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
