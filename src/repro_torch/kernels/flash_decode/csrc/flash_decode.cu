// Decode attention partials on Hopper (sm_90a): for every batch row b and
// query head qh, the online-softmax state over the live keys [lo, hi) of
// its KV head qh / g (g = Hq / Hkv query heads per KV head):
//   s_j = (q . k_j) * d^-1/2,   m = max_j s_j,   l = sum_j exp(s_j - m),
//   o = sum_j exp(s_j - m) * v_j.
//
// Replaces src/repro/kernels/flash_decode/kernel.py::decode_partials_pallas
// (body _decode_kernel).  On the TPU the grid walks the S tiles in order
// and carries m/l/o in VMEM scratch across them, emitting at the last
// tile; its wrapper flattens (B, H) to rows with one query head per KV
// row and pads N and S with zeros.  Here one block per (batch row, KV
// head) walks its own live range [lo, hi) in tiles of TILE keys and keeps
// the state of all g query heads of that KV head, so every K/V row is
// read from device memory once for the g heads; no padding, no ordered
// grid, no atomics (two runs give the same bits).
//
// Bound: memory.  Each live K and V row is read once (bf16 or f32) and
// the partials written once; the math is 4 * g * d flops per key.  For
// hymba-1.5b decode (B = 8, Hkv = 5, g = 5, d = 64, ~1,040 live keys of a
// bf16 cache) that is ~10.6 MB, ~3.2 us at 3.35 TB/s.  B * Hkv = 40
// blocks fill under one wave of 132 SMs, and each block walks its keys in
// order: this first design is latency-bound, far from that bound
// (splitting S across blocks, with a merge of the partials, is the
// redesign).
//
// A row with no live key (lo >= hi) walks all S keys masked, as the TPU
// kernel does (it does not mask p after the exponential): m = -1e30,
// l = S, o = the sum of the S value rows (see ref.py).
//
// The cache is read in its own type (bf16 converted in registers with
// __bfloat162float: the values the TPU wrapper's float32 cast gives,
// without a float32 copy of the cache).  Compiled with --fmad=false; the
// sums run in a fixed order within each thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128
#define TILE 32
#define MAX_D 128
#define MAX_G 16
#define PER_THREAD ((MAX_G * MAX_D + THREADS - 1) / THREADS)
#define NEG (-1e30f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// NaN-propagating max, like torch.amax / jnp.max
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b != b || b > a) ? b : a;
}

template <typename KV>
__global__ void __launch_bounds__(THREADS)
    decode_partials_kernel(const float* __restrict__ q,
                           const KV* __restrict__ k, const KV* __restrict__ v,
                           const int* __restrict__ lo,
                           const int* __restrict__ hi,
                           float* __restrict__ m_out,
                           float* __restrict__ l_out,
                           float* __restrict__ o_out, int s, int hkv, int g,
                           int d, float scale) {
  __shared__ float q_s[MAX_G * MAX_D];
  __shared__ float k_s[TILE * (MAX_D + 1)];  // rows padded: no bank conflict
  __shared__ float v_s[TILE * MAX_D];
  __shared__ float p_s[MAX_G * TILE];
  __shared__ float m_s[MAX_G], l_s[MAX_G], c_s[MAX_G];

  const int b = blockIdx.x / hkv;
  const int h = blockIdx.x - b * hkv;
  const int tid = threadIdx.x;
  const int hq = hkv * g;
  const int gd = g * d;
  const int kd = d + 1;

  // the g query heads of KV head h: heads h*g .. h*g+g-1, g*d floats
  const size_t q_off = ((size_t)b * hq + (size_t)h * g) * d;
  for (int i = tid; i < gd; i += THREADS) q_s[i] = q[q_off + i];
  if (tid < g) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  int start = max(lo[b], 0);
  int end = min(hi[b], s);
  const bool live = start < end;
  if (!live) {
    start = 0;
    end = s;
  }
  float acc[PER_THREAD];
#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r) acc[r] = 0.f;
  __syncthreads();

  const size_t row = (size_t)hkv * d;  // elements from one key to the next
  const size_t kv_off = (size_t)b * s * row + (size_t)h * d;
  const KV* kb = k + kv_off;
  const KV* vb = v + kv_off;

  for (int t0 = start; t0 < end; t0 += TILE) {
    const int n = min(TILE, end - t0);
    for (int i = tid; i < TILE * d; i += THREADS) {
      const int j = i / d;
      const int dd = i - j * d;
      float kk = 0.f, vv = 0.f;
      if (j < n) {
        const size_t off = (size_t)(t0 + j) * row + dd;
        kk = to_f32(kb[off]);
        vv = to_f32(vb[off]);
      }
      k_s[j * kd + dd] = kk;
      v_s[j * d + dd] = vv;
    }
    __syncthreads();
    // scores of the g heads against the tile's keys
    for (int i = tid; i < g * TILE; i += THREADS) {
      const int gi = i / TILE;
      const int j = i - gi * TILE;
      float sc = NEG;
      if (live && j < n) {
        const float* qr = q_s + gi * d;
        const float* kr = k_s + j * kd;
        float dot = 0.f;
        for (int dd = 0; dd < d; ++dd)
          dot = __fadd_rn(dot, __fmul_rn(qr[dd], kr[dd]));
        sc = __fmul_rn(dot, scale);
      }
      p_s[i] = sc;
    }
    __syncthreads();
    // online softmax update, one thread per query head, keys in order
    if (tid < g) {
      float* pr = p_s + tid * TILE;
      const float m_prev = m_s[tid];
      float mx = m_prev;
      for (int j = 0; j < n; ++j) mx = nan_max(mx, pr[j]);
      const float corr = expf(m_prev - mx);
      float sum = 0.f;
      for (int j = 0; j < TILE; ++j) {
        float p = 0.f;
        if (j < n) {
          p = expf(pr[j] - mx);
          sum = __fadd_rn(sum, p);
        }
        pr[j] = p;
      }
      l_s[tid] = __fadd_rn(__fmul_rn(l_s[tid], corr), sum);
      m_s[tid] = mx;
      c_s[tid] = corr;
    }
    __syncthreads();
    // o = o * corr + p . V, one thread per (head, lane)
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) {
      const int i = tid + r * THREADS;
      if (i < gd) {
        const int gi = i / d;
        const int dd = i - gi * d;
        const float* pr = p_s + gi * TILE;
        float pv = 0.f;
        for (int j = 0; j < n; ++j)
          pv = __fadd_rn(pv, __fmul_rn(pr[j], v_s[j * d + dd]));
        acc[r] = __fadd_rn(__fmul_rn(acc[r], c_s[gi]), pv);
      }
    }
    __syncthreads();
  }

  const size_t head0 = (size_t)b * hq + (size_t)h * g;
  if (tid < g) {
    m_out[head0 + tid] = m_s[tid];
    l_out[head0 + tid] = l_s[tid];
  }
#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r) {
    const int i = tid + r * THREADS;
    if (i < gd) o_out[head0 * d + i] = acc[r];
  }
}

extern "C" int decode_partials_max_d() { return MAX_D; }
extern "C" int decode_partials_max_g() { return MAX_G; }

// q (nb, hkv * g, d) float32; k, v (nb, s, hkv, d) float32 (kv_bf16 = 0)
// or bf16 (kv_bf16 = 1); lo, hi (nb,) int32; m, l (nb, hkv * g) and
// o (nb, hkv * g, d) float32.  All contiguous.
extern "C" int decode_partials_launch(const float* q, const void* k,
                                      const void* v, const int* lo,
                                      const int* hi, float* m, float* l,
                                      float* o, int nb, int s, int hkv,
                                      int g, int d, int kv_bf16, float scale,
                                      void* stream) {
  if (nb < 1 || s < 1 || hkv < 1 || g < 1 || g > MAX_G || d < 1 ||
      d > MAX_D || (long long)nb * hkv > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)(nb * hkv);
  if (kv_bf16)
    decode_partials_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        q, static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), lo, hi, m, l, o, s, hkv, g, d,
        scale);
  else
    decode_partials_kernel<float><<<blocks, THREADS, 0, st>>>(
        q, static_cast<const float*>(k), static_cast<const float*>(v), lo,
        hi, m, l, o, s, hkv, g, d, scale);
  return (int)cudaGetLastError();
}
