// Decode attention partials on Hopper (sm_90a): for every batch row b and
// query head qh, the online-softmax state over the live keys [lo, hi) of
// its KV head qh / g (g = Hq / Hkv query heads per KV head):
//   s_j = (q . k_j) * d^-1/2,   m = max_j s_j,   l = sum_j exp(s_j - m),
//   o = sum_j exp(s_j - m) * v_j.
//
// Replaces src/repro/kernels/flash_decode/kernel.py::decode_partials_pallas
// (body _decode_kernel).  On the TPU the grid walks the S tiles in order
// and carries m/l/o in VMEM scratch across them, emitting at the last
// tile.  A GPU grid runs in no order, so the key axis is split instead and
// the splits' states are merged by a second pass (split-KV):
//
//   1. decode_split_kernel: one block per (split of SPLIT keys, KV head,
//      batch row).  The grid is sized from S, never from lo/hi (the host
//      reads no device tensor).  A split that lies wholly outside a live
//      row's [lo, hi) writes the merge identity (m = -1e30, l = 0, o = 0)
//      and reads no key; a split that crosses the range reads only its live
//      keys, so a NaN or Inf in a dead key never reaches the result.  The
//      block first issues every load of its live K and V rows at once
//      (cp.async, 16 bytes a lane, neighbouring lanes on neighbouring
//      bytes) into shared memory, so a block's whole tile is in flight
//      while the other blocks on the SM fold theirs.  Then NW warps take KW
//      keys each: 8 lanes cover one key row (EPL elements a lane), and the
//      four 8-lane groups of a warp take KI keys each.  The warp walks the
//      g query heads of the KV head in turn (q's slice in registers): a
//      score is a lane partial over EPL elements followed by a fixed
//      __shfl_xor_sync tree over the 8 lanes; the maximum, the sum of the
//      exponentials (one lane of a group takes each key's) and p . V join
//      the four groups in a fixed tree.  The warp states (one tile per
//      head, so no rescaling inside a warp) are merged in warp order
//      through shared memory after one __syncthreads, into a (B, Hq,
//      n_split, D + 2) float32 scratch of partials [m, l, o].
//   2. decode_merge_kernel: one block per (batch row, query head) walks its
//      splits in split order with merge_partials' arithmetic (ref.py).
//
// No float atomics and every sum has a fixed bracketing: two runs give the
// same bits.  Maxima propagate NaN (nan_max), as torch.maximum does.
//
// Bound: memory.  Each live K and V row is read once (bf16 or f32) and the
// partials written once; the math is 4 * g * d flops per key.  For
// hymba-1.5b decode (B = 8, Hkv = 5, g = 5, d = 64, ~1,040 live keys of a
// bf16 cache) that is ~10.6 MB, ~3.2 us at 3.35 TB/s.  At S = 2,048 the
// grid is 16 splits x 5 x 8 = 640 blocks (about half of them identity
// splits that exit at once) against 132 SMs.  The time goes to the folds
// (CUDA-core multiply-adds, bf16 widening and the shuffle trees, about 15
// warp instructions per key and head) more than to the loads.
//
// A row with no live key (lo >= hi) walks all S keys masked, as the TPU
// kernel does (it does not mask p after the exponential): every split
// reads its value rows (not its key rows) with scores -1e30, so m = -1e30,
// l = S, o = the sum of the S value rows (see ref.py).
//
// The cache is read in its own type (bf16 widened in registers: the values
// the TPU wrapper's float32 cast gives, without a float32 copy of the
// cache).  Compiled with --fmad=false: the dot products and p . V are
// written as explicit fused multiply-adds (__fmaf_rn), every other product
// and sum is rounded on its own (__fmul_rn, __fadd_rn).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SPLIT 128         // keys per split (one block)
#define NW 4              // warps per block
#define THREADS (NW * 32)
#define KW (SPLIT / NW)   // keys per warp
#define GROUPS 4          // 8-lane groups per warp
#define KI (KW / GROUPS)  // keys per group (at most 8)
#define MAX_D 128
#define MAX_G 16
#define MERGE_THREADS 128
#define MERGE_AHEAD 8     // splits whose loads the merge issues together
#define NEG (-1e30f)

// NaN-propagating max, like torch.maximum / jnp.max
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b != b || b > a) ? b : a;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// One lane's slice of a K or V row in shared memory: EPL elements packed
// in RW 32-bit words (two bf16 per word, or one float32).
template <typename KV, int EPL>
struct Slice {
  static constexpr int RW = EPL * (int)sizeof(KV) / 4;
  uint32_t w[RW];

  __device__ __forceinline__ float at(int e) const {
    if constexpr (sizeof(KV) == 4)
      return __uint_as_float(w[e]);
    else
      return __uint_as_float(((w[e >> 1] >> (16 * (e & 1))) & 0xffffu)
                             << 16);
  }

  // elements sub*EPL .. sub*EPL+EPL-1 of the row at p; full: the row is
  // exactly 8 * EPL elements (16-byte aligned), else masked loads
  __device__ __forceinline__ void load(const KV* p, int sub, int d,
                                       bool full) {
    const KV* src = p + sub * EPL;
    if (full) {
      if constexpr (RW % 4 == 0) {
#pragma unroll
        for (int i = 0; i < RW / 4; ++i) {
          const uint4 u = reinterpret_cast<const uint4*>(src)[i];
          w[4 * i] = u.x;
          w[4 * i + 1] = u.y;
          w[4 * i + 2] = u.z;
          w[4 * i + 3] = u.w;
        }
      } else if constexpr (RW == 2) {
        const uint2 u = *reinterpret_cast<const uint2*>(src);
        w[0] = u.x;
        w[1] = u.y;
      } else {
        w[0] = *reinterpret_cast<const unsigned int*>(src);
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) w[i] = 0u;
    if constexpr (sizeof(KV) == 4) {
      const unsigned int* s32 = reinterpret_cast<const unsigned int*>(src);
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        if (sub * EPL + e < d) w[e] = s32[e];
    } else {
      const unsigned short* s16 =
          reinterpret_cast<const unsigned short*>(src);
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        if (sub * EPL + e < d) w[e >> 1] |= (uint32_t)s16[e] << (16 * (e & 1));
    }
  }
};

// rows [a, z) of one KV head (row stride `row` elements) into shared
// memory at slots a - s0 .., 16-byte copies when vec, else elementwise
template <typename KV>
__device__ __forceinline__ void stage(KV* dst, const KV* src, size_t row,
                                      int a, int z, int s0, int d, bool vec,
                                      int tid) {
  if (vec) {
    const int cpr = d * (int)sizeof(KV) / 16;  // 16-byte chunks a row
    for (int i = tid; i < (z - a) * cpr; i += THREADS) {
      const int r = i / cpr, c = i - r * cpr;
      cp_async16(reinterpret_cast<char*>(dst + (size_t)(a - s0 + r) * d) +
                     16 * c,
                 reinterpret_cast<const char*>(src + (size_t)(a + r) * row) +
                     16 * c);
    }
  } else {
    for (int i = tid; i < (z - a) * d; i += THREADS) {
      const int r = i / d, e = i - r * d;
      dst[(size_t)(a - s0 + r) * d + e] = src[(size_t)(a + r) * row + e];
    }
  }
}

template <typename KV, int EPL>
__global__ void __launch_bounds__(THREADS)
    decode_split_kernel(const float* __restrict__ q,
                        const KV* __restrict__ k, const KV* __restrict__ v,
                        const int* __restrict__ lo,
                        const int* __restrict__ hi,
                        float* __restrict__ part, int s, int hkv, int g,
                        int d, int n_split, float scale, bool vec) {
  using Row = Slice<KV, EPL>;
  // [SPLIT][d] K, [SPLIT][d] V (cache type), then float32 [g][d] q and
  // [NW][g][d + 2] warp states
  extern __shared__ __align__(16) unsigned char smem[];
  KV* ks = reinterpret_cast<KV*>(smem);
  KV* vs = ks + (size_t)SPLIT * d;
  float* qs = reinterpret_cast<float*>(vs + (size_t)SPLIT * d);
  float* wst = qs + (size_t)g * d;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int hq = hkv * g;
  const int dp = d + 2;
  const int start = max(lo[b], 0), end = min(hi[b], s);
  const bool live = start < end;
  const int s0 = split * SPLIT, s1 = min(s0 + SPLIT, s);
  const int t0 = live ? max(s0, start) : s0;
  const int t1 = live ? min(s1, end) : s1;
  // partials of head (h*g + gi) at this split: part[(row*hq + head)
  // * n_split + split][0 .. d+1]
  float* pb = part + (((size_t)b * hq + (size_t)h * g) * n_split + split) *
                         (size_t)dp;
  const size_t head_stride = (size_t)n_split * dp;

  if (t0 >= t1) {  // a split outside a live row's range: the identity
    for (int i = tid; i < g * dp; i += THREADS) {
      const int gi = i / dp, c = i - gi * dp;
      pb[gi * head_stride + c] = c == 0 ? NEG : 0.f;
    }
    return;
  }

  // every load of the tile in flight at once
  const size_t row = (size_t)hkv * d;  // elements from one key to the next
  const size_t kv_off = (size_t)b * s * row + (size_t)h * d;
  if (live) stage<KV>(ks, k + kv_off, row, t0, t1, s0, d, vec, tid);
  stage<KV>(vs, v + kv_off, row, t0, t1, s0, d, vec, tid);
  asm volatile("cp.async.commit_group;\n" ::);
  // the g query heads of KV head h: heads h*g .. h*g+g-1
  const float* qb = q + ((size_t)b * hq + (size_t)h * g) * d;
  for (int i = tid; i < g * d; i += THREADS) qs[i] = __ldg(qb + i);

  const int warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 3, sub = lane & 7;
  const bool full = d == 8 * EPL;  // a lane's slice: one vector read
  // this warp's keys are slots [a, z) of the split; group grp takes
  // slots warp*KW + grp*KI + i, i < KI
  const int a = max(warp * KW, t0 - s0), z = min(warp * KW + KW, t1 - s0);
  const int base = warp * KW + grp * KI;
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  for (int gi = 0; gi < g; ++gi) {  // warp-uniform
    float* ws = wst + ((size_t)warp * g + gi) * dp;
    if (a >= z) {  // no key in this warp: the identity
      for (int c = lane; c < dp; c += 32) ws[c] = c == 0 ? NEG : 0.f;
      continue;
    }
    float qv[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qv[e] = sub * EPL + e < d ? qs[(size_t)gi * d + sub * EPL + e] : 0.f;
    // scores of the group's keys; every lane runs the shuffle tree
    float sc[KI];
    float mx = NEG;
#pragma unroll
    for (int i = 0; i < KI; ++i) {
      const bool in = base + i >= a && base + i < z;
      float dot = 0.f;
      if (live) {
        Row kr;
        kr.load(ks + (size_t)(base + i) * d, sub, d, full);
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = __fmaf_rn(qv[e], kr.at(e), dot);
        // fixed tree over the 8 lanes of the group: every lane of the
        // group ends with the same bits
        dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, 1));
        dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, 2));
        dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, 4));
      }
      sc[i] = live ? __fmul_rn(dot, scale) : NEG;
      if (in) mx = nan_max(mx, sc[i]);
    }
    mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    // lane sub < KI of a group takes the exponential of its key i = sub
    float x = NEG;
#pragma unroll
    for (int i = 0; i < KI; ++i)
      if (i == sub) x = sc[i];
    const float mine =
        (sub < KI && base + sub >= a && base + sub < z) ? expf(x - mx) : 0.f;
    float sum = 0.f, pv[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) pv[e] = 0.f;
#pragma unroll
    for (int i = 0; i < KI; ++i) {
      const float p = __shfl_sync(0xffffffffu, mine, (lane & ~7) | i);
      if (base + i >= a && base + i < z) {  // a dead slot is never read
        sum = __fadd_rn(sum, p);
        Row vr;
        vr.load(vs + (size_t)(base + i) * d, sub, d, full);
#pragma unroll
        for (int e = 0; e < EPL; ++e) pv[e] = __fmaf_rn(p, vr.at(e), pv[e]);
      }
    }
    // the four groups' sums, in a fixed tree
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 8));
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 16));
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      pv[e] = __fadd_rn(pv[e], __shfl_xor_sync(0xffffffffu, pv[e], 8));
      pv[e] = __fadd_rn(pv[e], __shfl_xor_sync(0xffffffffu, pv[e], 16));
    }
    if (grp == 0) {
      if (sub == 0) {
        ws[0] = mx;
        ws[1] = sum;
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        if (sub * EPL + e < d) ws[2 + sub * EPL + e] = pv[e];
    }
  }
  __syncthreads();
  // merge the warps in warp order (merge_partials' arithmetic)
  for (int i = tid; i < g * dp; i += THREADS) {
    const int gi = i / dp, c = i - gi * dp;
    const float* ws = wst + (size_t)gi * dp;
    float mm = ws[0], ll = ws[1], oo = ws[c];
    for (int w = 1; w < NW; ++w) {
      const float* x = wst + ((size_t)w * g + gi) * dp;
      const float mn = nan_max(mm, x[0]);
      const float ea = expf(mm - mn), eb = expf(x[0] - mn);
      ll = __fadd_rn(__fmul_rn(ll, ea), __fmul_rn(x[1], eb));
      if (c >= 2) oo = __fadd_rn(__fmul_rn(oo, ea), __fmul_rn(x[c], eb));
      mm = mn;
    }
    pb[gi * head_stride + c] = c == 0 ? mm : (c == 1 ? ll : oo);
  }
}

// one block per (batch row, query head): the splits merged in split order
__global__ void __launch_bounds__(MERGE_THREADS)
    decode_merge_kernel(const float* __restrict__ part, int n_split, int d,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        float* __restrict__ o_out) {
  const size_t rh = blockIdx.x;  // row * hq + head
  const int dp = d + 2;
  const float* p = part + rh * n_split * (size_t)dp;
  for (int c = threadIdx.x; c < dp; c += MERGE_THREADS) {
    float mm = p[0], ll = p[1], oo = p[c];
    for (int sp0 = 1; sp0 < n_split; sp0 += MERGE_AHEAD) {
      // the loads of MERGE_AHEAD splits in flight, then the folds in order
      float xm[MERGE_AHEAD], xl[MERGE_AHEAD], xc[MERGE_AHEAD];
#pragma unroll
      for (int i = 0; i < MERGE_AHEAD; ++i) {
        const float* x = p + (size_t)min(sp0 + i, n_split - 1) * dp;
        xm[i] = x[0];
        xl[i] = x[1];
        xc[i] = x[c];
      }
#pragma unroll
      for (int i = 0; i < MERGE_AHEAD; ++i) {
        if (sp0 + i < n_split) {
          const float mn = nan_max(mm, xm[i]);
          const float ea = expf(mm - mn), eb = expf(xm[i] - mn);
          ll = __fadd_rn(__fmul_rn(ll, ea), __fmul_rn(xl[i], eb));
          if (c >= 2)
            oo = __fadd_rn(__fmul_rn(oo, ea), __fmul_rn(xc[i], eb));
          mm = mn;
        }
      }
    }
    if (c == 0)
      m_out[rh] = mm;
    else if (c == 1)
      l_out[rh] = ll;
    else
      o_out[rh * d + (c - 2)] = oo;
  }
}

template <typename KV, int EPL>
static cudaError_t launch_split(const float* q, const void* k, const void* v,
                                const int* lo, const int* hi, float* part,
                                int nb, int s, int hkv, int g, int d,
                                int n_split, float scale, cudaStream_t st) {
  const KV* kk = static_cast<const KV*>(k);
  const KV* vv = static_cast<const KV*>(v);
  const bool vec = (d * sizeof(KV)) % 16 == 0 && ((uintptr_t)k & 15) == 0 &&
                   ((uintptr_t)v & 15) == 0;
  const size_t smem = 2 * (size_t)SPLIT * d * sizeof(KV) +
                      ((size_t)g * d + (size_t)NW * g * (d + 2)) *
                          sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<KV, EPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  decode_split_kernel<KV, EPL><<<dim3(n_split, hkv, nb), THREADS, smem,
                                 st>>>(q, kk, vv, lo, hi, part, s, hkv, g, d,
                                       n_split, scale, vec);
  return cudaGetLastError();
}

template <typename KV>
static cudaError_t launch_typed(const float* q, const void* k, const void* v,
                                const int* lo, const int* hi, float* part,
                                int nb, int s, int hkv, int g, int d,
                                int n_split, float scale, cudaStream_t st) {
  if (d <= 16)
    return launch_split<KV, 2>(q, k, v, lo, hi, part, nb, s, hkv, g, d,
                               n_split, scale, st);
  if (d <= 32)
    return launch_split<KV, 4>(q, k, v, lo, hi, part, nb, s, hkv, g, d,
                               n_split, scale, st);
  if (d <= 64)
    return launch_split<KV, 8>(q, k, v, lo, hi, part, nb, s, hkv, g, d,
                               n_split, scale, st);
  return launch_split<KV, 16>(q, k, v, lo, hi, part, nb, s, hkv, g, d,
                              n_split, scale, st);
}

extern "C" int decode_partials_max_d() { return MAX_D; }
extern "C" int decode_partials_max_g() { return MAX_G; }
extern "C" int decode_partials_split() { return SPLIT; }

// q (nb, hkv * g, d) float32; k, v (nb, s, hkv, d) float32 (kv_bf16 = 0)
// or bf16 (kv_bf16 = 1); lo, hi (nb,) int32; m, l (nb, hkv * g) and
// o (nb, hkv * g, d) float32; part (nb, hkv * g, ceil(s / SPLIT), d + 2)
// float32 scratch.  All contiguous.
extern "C" int decode_partials_launch(const float* q, const void* k,
                                      const void* v, const int* lo,
                                      const int* hi, float* m, float* l,
                                      float* o, float* part, int nb, int s,
                                      int hkv, int g, int d, int kv_bf16,
                                      float scale, void* stream) {
  if (nb < 1 || nb > 65535 || s < 1 || hkv < 1 || hkv > 65535 || g < 1 ||
      g > MAX_G || d < 1 || d > MAX_D ||
      (long long)nb * hkv * g > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int n_split = (s + SPLIT - 1) / SPLIT;
  cudaError_t err =
      kv_bf16 ? launch_typed<__nv_bfloat16>(q, k, v, lo, hi, part, nb, s, hkv,
                                            g, d, n_split, scale, st)
              : launch_typed<float>(q, k, v, lo, hi, part, nb, s, hkv, g, d,
                                    n_split, scale, st);
  if (err != cudaSuccess) return (int)err;
  decode_merge_kernel<<<nb * hkv * g, MERGE_THREADS, 0, st>>>(part, n_split,
                                                             d, m, l, o);
  return (int)cudaGetLastError();
}
