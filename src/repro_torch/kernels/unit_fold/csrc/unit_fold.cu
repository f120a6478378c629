// Fused unit fold of one window group on Hopper (sm_90a).
//
// Replaces src/repro/kernels/unit_fold/kernel.py::unit_fold_pallas (body
// _unit_fold_kernel).  For every unit u of a (U, R) block of rows it
// computes each member window's [start, end) frame bounds at the unit's Q
// query positions (ROWS arithmetic, the ROWS_RANGE binary search, MAXSIZE,
// EXCLUDE CURRENT_ROW) and answers every (member, query) fold of every
// leaf group, bit for bit as the plain version (ref.py) over rows padded
// to rp = next_pow2(R):
//   ADD, EW    - scan prefix of [0, e) minus (inverted by) that of [0, s):
//                the MSB-first left fold of e's aligned tree nodes, each
//                node the pairwise (balanced-tree) fold of its rows;
//   DRAWDOWN   - the two-sided tree walk over [s, e);
//   MIN, MAX   - the fold of [s, e) (order-free: any bracketing gives the
//                plain sparse table's value, NaN included).
// Rows at or past R are identity rows and INT_MAX timestamps; the kernel
// makes them itself, so the wrapper passes the rows unpadded.
//
// Bound: memory.  The least traffic is each unit's R rows read once and
// each fold written once, (U*R*(F+1) + U*Mg*Q*F)*4 bytes over 3.35 TB/s.
//
// Design.  No fold reads a node that reaches past the largest frame end
// of its unit, and a query at the unit's last row needs no structure at
// all.  Three variants, chosen by the wrapper from the shapes:
//
// * few queries per unit (serving and the replay, Q <= 4): uf_few_kernel,
//   one block per unit for every group.  The block stages the order
//   column and every group's R rows with all loads in flight, and
//   computes every member's bounds once.  Each
//   warp folds 32 rows by __shfl_down_sync at offsets 1, 2, 4, 8, 16 (four
//   ADD lanes at a time): lane i then holds, at step k, the level-k node
//   that starts at row 32c + i (the packed levels' pairing).  Only chunks
//   in [0, max e) ([min s, max e) for the walk) are folded; the nodes of
//   level < 5 that a frame's bracketing takes are kept as they pass; the
//   level-5 nodes fold on into levels 6.. in the same pairing, 32 nodes a
//   warp, one barrier per five levels.  Two lanes per (frame, lane) then
//   fold the two sides (prefix of e and of s; the walk's left and right)
//   in the reference's order, each group from its own warps.  MIN and MAX
//   are order-free: one warp per (frame, lane) reduces [s, e) directly.
// * many queries per unit (offline, Q = rp): uf_bounds_kernel computes
//   every (unit, member, query) bound once (the order column in shared
//   memory), then uf_many_kernel, one block per (unit, lane tile), builds
//   its group's structure in shared memory over [0, max e) only: packed
//   tree levels (ADD/EW scan, DRAWDOWN), levels 0-5 by shuffles without
//   barriers, then five levels per barrier; for the scans every prefix
//   P[x] by the recurrence P[x] = P[x - lowbit(x)] (+) node (the chunk
//   starts from their level >= 5 nodes, then five shuffle rounds), so a
//   query reads two prefixes; for MIN/MAX the plain version's sparse
//   table up to level floor(log2(max span)), levels 1-5 by shuffles over
//   a 64-row window per warp.  One thread per (frame, lane) answers.
// * wide: the many-query variant with each block's structure in a slice
//   of a global-memory buffer, for units whose structure does not fit
//   227 KB.
//
// GPU blocks run in no order and nothing crosses blocks: no atomics on
// floats (integer atomicMin/Max on shared frame ranges give the same
// value in any order).
//
// Float rules: compiled without --use_fast_math and with --fmad=false; the
// EW combine and its inverse use __fmul_rn/__fadd_rn/__fsub_rn and the
// full-precision expf, so every fold is the plain PyTorch version's bits.
// NaN is the system's NULL: min/max/drawdown propagate it like
// torch.minimum/maximum (a NaN result may differ in payload bits only).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define MAX_GROUPS 16
#define MAX_MEMBERS 16
#define MAX_THREADS 1024
#define BOUNDS_THREADS 512
#define BOUNDS_SMEM_ROWS 32768
#define BOUNDS_FRAMES 2048
#define FULL 0xffffffffu
#define TS_PAD 0x7fffffff

enum { FAM_ADD = 0, FAM_MIN = 1, FAM_MAX = 2, FAM_DRAWDOWN = 3, FAM_EW = 4 };
enum { KIND_SCAN = 0, KIND_SPARSE = 1, KIND_TREE = 2 };
enum { MODE_FEW = 0, MODE_MANY = 1 };

#define NEG_INF (-3.0e38f)
#define POS_INF (3.0e38f)

struct Group {
  const float* data;   // (U, R, width)
  float* out;          // (U, mg, Q, width)
  const float* ident;  // (width,)
  int family, kind, width, tile, tile_start, mg;
  float log_decay;
  int stage_off, up_off, stash_off;  // few path: float words past few_base
  int members[MAX_MEMBERS];
};

struct Params {
  const int* ts;   // (U, R) order column
  const int* q;    // (U, Q) query positions
  int* bounds;     // many path: (2, U, M, Q) starts, then ends
  float* scratch;  // wide variant: one slice per block; null: shared
  int scratch_words;
  int U, R, rp, log2rp, Q, n_groups, n_members, few_base;
  int m_rows[MAX_MEMBERS], m_pre[MAX_MEMBERS], m_maxsize[MAX_MEMBERS],
      m_exclude[MAX_MEMBERS];
  Group groups[MAX_GROUPS];
};

struct V3 {
  float a, b, c;
};

// ---------------------------------------------------------------- combines

// min/max that propagate NaN (NULL), as torch.minimum/maximum and
// jnp.minimum/maximum do; fminf/fmaxf would drop a NaN operand
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ V3 dd_combine(V3 x, V3 y) {
  bool ok = (x.a > 0.f) && (x.a > NEG_INF / 2) && (y.b < POS_INF / 2);
  float cross = ok ? __fdiv_rn(__fsub_rn(x.a, y.b), x.a) : 0.f;
  float dd = nan_max(nan_max(x.c, y.c), nan_max(cross, 0.f));
  return V3{nan_max(x.a, y.a), nan_min(x.b, y.b), dd};
}

__device__ __forceinline__ V3 ew_combine(V3 x, V3 y, float logd) {
  float scale = expf(__fmul_rn(y.c, logd));
  return V3{__fadd_rn(y.a, __fmul_rn(scale, x.a)),
            __fadd_rn(y.b, __fmul_rn(scale, x.b)), __fadd_rn(x.c, y.c)};
}

__device__ __forceinline__ float combine(int fam, float a, float b, float) {
  if (fam == FAM_ADD) return __fadd_rn(a, b);
  if (fam == FAM_MIN) return nan_min(a, b);
  return nan_max(a, b);
}

__device__ __forceinline__ V3 combine(int fam, V3 x, V3 y, float logd) {
  return fam == FAM_EW ? ew_combine(x, y, logd) : dd_combine(x, y);
}

// combine with the family fixed at compile time where the caller knows it
// (FC = FAM_ADD, FAM_DRAWDOWN, FAM_EW; -1: read at run time), so a value
// type never evaluates another family's combine
template <int FC>
__device__ __forceinline__ float comb(int fam, float a, float b, float logd) {
  if constexpr (FC == FAM_ADD)
    return __fadd_rn(a, b);
  else
    return combine(fam, a, b, logd);
}

template <int FC>
__device__ __forceinline__ V3 comb(int fam, V3 x, V3 y, float logd) {
  if constexpr (FC == FAM_EW)
    return ew_combine(x, y, logd);
  else if constexpr (FC == FAM_DRAWDOWN)
    return dd_combine(x, y);
  else
    return combine(fam, x, y, logd);
}

// a scan family's prefix difference: ADD subtracts, EW inverts the decay
__device__ __forceinline__ float invert(float e, float s, float) {
  return __fsub_rn(e, s);
}

__device__ __forceinline__ V3 invert(V3 e, V3 s, float logd) {
  float n = __fsub_rn(e.c, s.c);
  float scale = expf(__fmul_rn(n, logd));
  return V3{__fsub_rn(e.a, __fmul_rn(scale, s.a)),
            __fsub_rn(e.b, __fmul_rn(scale, s.b)), n};
}

__device__ __forceinline__ float shfl_down(float v, int off) {
  return __shfl_down_sync(FULL, v, off);
}

__device__ __forceinline__ V3 shfl_down(V3 v, int off) {
  return V3{__shfl_down_sync(FULL, v.a, off), __shfl_down_sync(FULL, v.b, off),
            __shfl_down_sync(FULL, v.c, off)};
}

__device__ __forceinline__ float shfl_idx(float v, int src) {
  return __shfl_sync(FULL, v, src);
}

__device__ __forceinline__ V3 shfl_idx(V3 v, int src) {
  return V3{__shfl_sync(FULL, v.a, src), __shfl_sync(FULL, v.b, src),
            __shfl_sync(FULL, v.c, src)};
}

__device__ __forceinline__ float shfl_xor(float v, int m) {
  return __shfl_xor_sync(FULL, v, m);
}

__device__ __forceinline__ V3 shfl_xor(V3 v, int m) {
  return V3{__shfl_xor_sync(FULL, v.a, m), __shfl_xor_sync(FULL, v.b, m),
            __shfl_xor_sync(FULL, v.c, m)};
}

// element (row, lane f) of a row-major array of w lanes; a V3 value is the
// three lanes of its row (w = 3, f = 0)
__device__ __forceinline__ void ld(float& v, const float* p, int row, int w,
                                   int f) {
  v = p[(size_t)row * w + f];
}

__device__ __forceinline__ void ld(V3& v, const float* p, int row, int w,
                                   int) {
  p += (size_t)row * w;
  v = V3{p[0], p[1], p[2]};
}

__device__ __forceinline__ void st(float* p, int row, int w, int f, float v) {
  p[(size_t)row * w + f] = v;
}

__device__ __forceinline__ void st(float* p, int row, int w, int, V3 v) {
  p += (size_t)row * w;
  p[0] = v.a;
  p[1] = v.b;
  p[2] = v.c;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ bool is_prefix(const Group& g) {
  return g.family == FAM_ADD || g.family == FAM_EW;
}

__device__ __forceinline__ bool is_minmax(const Group& g) {
  return g.family == FAM_MIN || g.family == FAM_MAX;
}

// row offset of tree level k inside the packed (2*rp - 1)-row levels
__device__ __forceinline__ int level_off(int rp, int k) {
  return 2 * rp - ((2 * rp) >> k);
}

// row offset of level k >= 5 inside the few path's levels 5.. (level 5 of
// rp >> 5 nodes first)
__device__ __forceinline__ int up_off(int rp, int k) {
  return 2 * (rp >> 5) - 2 * (rp >> k);
}

// --------------------------------------------------------------- bounds

__device__ __forceinline__ int ts_at(const int* ts, int i, int r) {
  return i < r ? ts[i] : TS_PAD;
}

// [start, end) of member m at query row qv over the unit's order column
// ts (rows >= R read INT_MAX), step for step as ref._bounds
__device__ void frame_bounds(const Params& p, int m, int qv, const int* ts,
                             int& start, int& end) {
  const int rp = p.rp, r = p.R;
  end = qv + 1;
  if (p.m_rows[m]) {
    start = max(0, qv - p.m_pre[m]);
  } else {
    int target = (int)((unsigned)ts_at(ts, clampi(qv, 0, rp - 1), r) -
                       (unsigned)p.m_pre[m]);
    int lo = 0, hi = end;
    for (int s = 0; s <= p.log2rp; ++s) {
      int mid = (lo + hi) >> 1;
      int v = ts_at(ts, clampi(mid, 0, rp - 1), r);
      bool go_right = (v < target) && (lo < hi);
      lo = go_right ? mid + 1 : lo;
      hi = (go_right || lo >= hi) ? hi : mid;
    }
    start = lo;
  }
  if (p.m_maxsize[m]) start = max(start, end - p.m_maxsize[m]);
  if (p.m_exclude[m]) {
    end = min(end, qv);
    start = min(start, end);
  }
}

// one block per (unit, tile of BOUNDS_FRAMES frames): the unit's order
// column in shared memory (read where it lies past BOUNDS_SMEM_ROWS
// rows), then the tile's (member, query) bounds
__global__ void __launch_bounds__(BOUNDS_THREADS)
    uf_bounds_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int u = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  const int mq = p.n_members * p.Q;
  const int* ts_u = p.ts + (size_t)u * p.R;
  const int* ts = ts_u;
  if (p.R <= BOUNDS_SMEM_ROWS) {
    int* s_ts = reinterpret_cast<int*>(smem_raw);
    for (int i = tid; i < p.R; i += nthr) s_ts[i] = ts_u[i];
    __syncthreads();
    ts = s_ts;
  }
  const int* q_u = p.q + (size_t)u * p.Q;
  int* st_u = p.bounds + (size_t)u * mq;
  int* en_u = st_u + (size_t)p.U * mq;
  const int hi = min(mq, (int)(blockIdx.y + 1) * BOUNDS_FRAMES);
  for (int i = blockIdx.y * BOUNDS_FRAMES + tid; i < hi; i += nthr) {
    const int m = i / p.Q;
    int s, e;
    frame_bounds(p, m, q_u[i - m * p.Q], ts, s, e);
    st_u[i] = s;
    en_u[i] = e;
  }
}

// Stage the unit's order column and every group's R rows into shared
// memory in one pass, eight loads in flight per thread before any store
// (a lone unit waits on one round trip to device memory, not several).
__device__ void stage_unit(const Params& p, int u, int* s_ts, float* s_f,
                           int tid, int nthr) {
  const int R = p.R;
  int total = R;
  for (int gi = 0; gi < p.n_groups; ++gi) total += R * p.groups[gi].width;
  for (int base = tid; base < total; base += 8 * nthr) {
    float v[8];
    float* dst[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int i = base + j * nthr;
      dst[j] = nullptr;
      if (i >= total) continue;
      if (i < R) {
        v[j] = __int_as_float(p.ts[(size_t)u * R + i]);
        dst[j] = reinterpret_cast<float*>(s_ts) + i;
        continue;
      }
      i -= R;
      int gi = 0;
      while (i >= R * p.groups[gi].width) i -= R * p.groups[gi++].width;
      const Group& g = p.groups[gi];
      v[j] = g.data[(size_t)u * R * g.width + i];
      dst[j] = s_f + g.stage_off + i;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (dst[j] != nullptr) *dst[j] = v[j];
  }
}

__device__ __forceinline__ bool at(int pos, int c, int lane) {
  return (pos >> 5) == c && (pos & 31) == lane;
}

// One warp folds the 32 rows of chunk c for NL lanes f0.. of a stacked
// group at once (a V3 group: its one 3-lane value): levels 0-4 stay in
// registers until the frames' nodes among them are kept (stash rows
// side * 5 + k of each frame), level 5 goes to the upper levels.  The
// lane's node positions are worked out once per frame for all NL lanes.
template <class T, int NL, int FC>
__device__ void few_chunk(const Params& p, const Group& g, int c, int f0,
                          int r1, const float* stage, float* up, float* stash,
                          const int* s_se, int lane) {
  constexpr bool v3 = sizeof(T) == sizeof(V3);
  const int w = g.width, fam = g.family;
  const float logd = g.log_decay;
  const int row = (c << 5) + lane;
  const int nl = v3 ? 1 : min(NL, w - f0);
  T v[NL], lv[5][NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const int f = v3 ? 0 : min(f0 + j, w - 1);
    if (row < r1)
      ld(v[j], stage, row, w, f);
    else
      ld(v[j], g.ident, 0, w, f);
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) {
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      lv[k][j] = v[j];
      v[j] = comb<FC>(fam, v[j], shfl_down(v[j], 1 << k), logd);
    }
  }
  if (lane == 0 && p.log2rp >= 5) {
#pragma unroll
    for (int j = 0; j < NL; ++j)
      if (j < nl) st(up, c, w, f0 + j, v[j]);
  }
  const int Q = p.Q, mq = p.n_members * Q, kmax = min(4, p.log2rp);
  const bool pre = is_prefix(g);
  for (int mi = 0; mi < g.mg; ++mi) {
    for (int qi = 0; qi < Q; ++qi) {
      const int i = g.members[mi] * Q + qi;
      const int s = s_se[i], e = s_se[mq + i];
      if (e <= s) continue;
      // bit side * 5 + k: this lane holds the frame's level-k node of
      // that side (prefix of e / of s; the walk's left / right)
      unsigned bits = 0;
      int l = s, r = e;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        if (k > kmax) break;
        if (pre) {
          const int mask = ~((2 << k) - 1);
          if (((e >> k) & 1) && at(e & mask, c, lane)) bits |= 1u << k;
          if (s >= 1 && ((s >> k) & 1) && at(s & mask, c, lane))
            bits |= 1u << (5 + k);
        } else {
          const bool act = l < r;
          const bool tl = act && (l & 1), tr = act && (r & 1);
          if (tl && at(l << k, c, lane)) bits |= 1u << k;
          if (tr && at((r - 1) << k, c, lane)) bits |= 1u << (5 + k);
          l = (l + (tl ? 1 : 0)) >> 1;
          r = (r - (tr ? 1 : 0)) >> 1;
        }
      }
      if (!bits) continue;
      float* sf = stash + (size_t)(mi * Q + qi) * 10 * w;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
#pragma unroll
        for (int j = 0; j < NL; ++j) {
          if (j >= nl) continue;
          if ((bits >> k) & 1) st(sf, k, w, f0 + j, lv[k][j]);
          if ((bits >> (5 + k)) & 1) st(sf, 5 + k, w, f0 + j, lv[k][j]);
        }
      }
    }
  }
}

// levels base+1 .. base+5 of the few path's upper levels, from 32
// level-base nodes per warp task
template <class T, int FC>
__device__ void fold_up(const Group& g, int rp, int log2rp, int base, int t,
                        int f, float* up, int n, int w, int lane) {
  const int idx = (t << 5) + lane;
  T v;
  if (idx < n)
    ld(v, up, up_off(rp, base) + idx, w, f);
  else
    ld(v, g.ident, 0, w, f);
  for (int k = 1; k <= 5 && base + k <= log2rp; ++k) {
    v = comb<FC>(g.family, v, shfl_down(v, 1 << (k - 1)), g.log_decay);
    const int j = idx >> k;
    if ((lane & ((1 << k) - 1)) == 0 && j < (rp >> (base + k)))
      st(up, up_off(rp, base + k) + j, w, f, v);
  }
}

// One side of a frame's fold from its nodes: the prefix of e (side 0) or
// of s (side 1) for the scan families, the walk's left (0) or right (1)
// accumulator for DRAWDOWN; the two sides run on two lanes.
template <class T, int FC>
__device__ T few_side(const Params& p, const Group& g, int s, int e, int f,
                      int side, const float* up, const float* sf, T id) {
  const int w = g.width, fam = g.family, rp = p.rp;
  const float logd = g.log_decay;
  auto node = [&](int k, int idx) {
    T v;
    if (k >= 5)
      ld(v, up, up_off(rp, k) + idx, w, f);
    else
      ld(v, sf, side * 5 + k, w, f);
    return v;
  };
  T acc = id;
  if (is_prefix(g)) {
    const int x = side ? s : e;
    if (e <= s || x < 1) return id;
    bool first = true;
    int pos = 0;
    for (int k = p.log2rp; k >= 0; --k) {
      if ((x >> k) & 1) {
        T nd = node(k, pos >> k);
        acc = first ? nd : comb<FC>(fam, acc, nd, logd);
        first = false;
        pos += 1 << k;
      }
    }
    return acc;
  }
  int l = s, r = e;
  for (int k = 0; k <= p.log2rp; ++k) {
    const bool act = l < r;
    const bool tl = act && (l & 1), tr = act && (r & 1);
    if (side == 0 && tl) acc = comb<FC>(fam, acc, node(k, l), logd);
    if (side == 1 && tr) acc = comb<FC>(fam, node(k, r - 1), acc, logd);
    l = (l + (tl ? 1 : 0)) >> 1;
    r = (r - (tr ? 1 : 0)) >> 1;
  }
  return acc;
}

// two lanes per (frame, lane f): each folds one side, the even lane
// finishes (prefix difference or inverse, or the walk's last combine)
template <class T, int FC>
__device__ void few_answer(const Params& p, const Group& g, int u,
                           const float* up, const float* stash,
                           const int* s_se, int tid, int nthr) {
  constexpr bool v3 = sizeof(T) == sizeof(V3);
  const int w = g.width, Q = p.Q, nl = v3 ? 1 : w;
  const int n2 = 2 * g.mg * Q * nl, nr = (n2 + 31) & ~31;
  for (int i = tid; i < nr; i += nthr) {
    const bool act = i < n2;
    const int it = act ? i >> 1 : 0, side = i & 1;
    const int fr = it / nl, f = it - fr * nl;
    const int mi = fr / Q, qi = fr - mi * Q;
    const int b = g.members[mi] * Q + qi;
    const int s = s_se[b], e = s_se[p.n_members * Q + b];
    T id;
    ld(id, g.ident, 0, w, f);
    const T v = few_side<T, FC>(p, g, s, e, f, side, up,
                            stash + (size_t)fr * 10 * w, id);
    const T o = shfl_xor(v, 1);
    if (act && side == 0) {
      T res;
      if (is_prefix(g))
        res = e <= s ? id : invert(v, o, g.log_decay);
      else
        res = comb<FC>(g.family, v, o, g.log_decay);
      st(g.out + (((size_t)u * g.mg + mi) * Q + qi) * w, 0, w, f, res);
    }
  }
}

// MIN/MAX need no nodes: one warp per (frame, lane) reduces [s, e)
__device__ void few_minmax(const Params& p, const Group& g, int u,
                           const float* stage, const int* s_se, int warp,
                           int nwarps, int lane) {
  const int w = g.width, Q = p.Q, n = g.mg * Q * w;
  for (int it = warp; it < n; it += nwarps) {
    const int fr = it / w, f = it - fr * w;
    const int mi = fr / Q, qi = fr - mi * Q;
    const int b = g.members[mi] * Q + qi;
    const int s = s_se[b], e = min(s_se[p.n_members * Q + b], p.R);
    const float id = g.ident[f];
    float v = id;
    for (int row = s + lane; row < e; row += 32)
      v = combine(g.family, v, stage[(size_t)row * w + f], 0.f);
#pragma unroll
    for (int o = 16; o; o >>= 1)
      v = combine(g.family, v, shfl_xor(v, o), 0.f);
    if (lane == 0)
      g.out[(((size_t)u * g.mg + mi) * Q + qi) * w + f] =
          s_se[p.n_members * Q + b] <= s ? id : v;
  }
}

#define FEW_LANES 4

__global__ void __launch_bounds__(MAX_THREADS)
    uf_few_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int u = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int R = p.R, Q = p.Q, mq = p.n_members * Q;
  int* s_ts = reinterpret_cast<int*>(smem_raw);
  int* s_se = s_ts + R;
  int* s_rng = s_se + 2 * mq;
  float* s_f = reinterpret_cast<float*>(smem_raw) + p.few_base;

  // 1. the order column and every group's rows, then every member's
  //    bounds, once per unit
  stage_unit(p, u, s_ts, s_f, tid, nthr);
  if (tid == 0) {
    s_rng[0] = 0x7fffffff;
    s_rng[1] = 0;
  }
  __syncthreads();
  const int* q_u = p.q + (size_t)u * Q;
  for (int i = tid; i < mq; i += nthr) {
    const int m = i / Q;
    int s, e;
    frame_bounds(p, m, q_u[i - m * Q], s_ts, s, e);
    s_se[i] = s;
    s_se[mq + i] = e;
    if (e > s) {
      atomicMin(&s_rng[0], s);
      atomicMax(&s_rng[1], e);
    }
  }
  __syncthreads();
  const int lo_all = s_rng[0], hi_all = min(s_rng[1], R);

  // 2. chunk folds by shuffles; the frames' low nodes are kept
  int acc = 0;
  for (int gi = 0; gi < p.n_groups; ++gi) {
    const Group& g = p.groups[gi];
    if (is_minmax(g)) continue;
    const bool v3 = g.family >= FAM_DRAWDOWN;
    const int c0 = (is_prefix(g) ? 0 : lo_all) >> 5;
    const int nc = hi_all > (c0 << 5) ? ((hi_all + 31) >> 5) - c0 : 0;
    const int nb = v3 ? 1 : (g.width + FEW_LANES - 1) / FEW_LANES;
    const int n = nc * nb;
    float* up = s_f + g.up_off;
    float* stash = s_f + g.stash_off;
    for (int t = ((warp - acc) % nwarps + nwarps) % nwarps; t < n;
         t += nwarps) {
      const int c = c0 + t / nb, f0 = (t % nb) * FEW_LANES;
      const float* stage = s_f + g.stage_off;
      if (g.family == FAM_EW)
        few_chunk<V3, 1, FAM_EW>(p, g, c, 0, hi_all, stage, up, stash, s_se,
                                 lane);
      else if (v3)
        few_chunk<V3, 1, FAM_DRAWDOWN>(p, g, c, 0, hi_all, stage, up, stash,
                                       s_se, lane);
      else
        few_chunk<float, FEW_LANES, FAM_ADD>(p, g, c, f0, hi_all, stage, up,
                                             stash, s_se, lane);
    }
    acc += n;
  }
  __syncthreads();

  // 3. levels 6.. from the level-5 nodes, five levels per barrier
  for (int base = 5; base < p.log2rp; base += 5) {
    const int n_nodes = p.rp >> base;
    int acc_up = 0;
    for (int gi = 0; gi < p.n_groups; ++gi) {
      const Group& g = p.groups[gi];
      if (is_minmax(g)) continue;
      const bool v3 = g.family >= FAM_DRAWDOWN;
      const int nl = v3 ? 1 : g.width;
      const int n = ((n_nodes + 31) >> 5) * nl;
      const int t0 = ((warp - acc_up) % nwarps + nwarps) % nwarps;
      acc_up += n;
      for (int t = t0; t < n; t += nwarps) {
        float* up = s_f + g.up_off;
        if (g.family == FAM_EW)
          fold_up<V3, FAM_EW>(g, p.rp, p.log2rp, base, t, 0, up, n_nodes, 3,
                              lane);
        else if (v3)
          fold_up<V3, FAM_DRAWDOWN>(g, p.rp, p.log2rp, base, t, 0, up,
                                    n_nodes, 3, lane);
        else
          fold_up<float, FAM_ADD>(g, p.rp, p.log2rp, base, t / nl, t % nl,
                                  up, n_nodes, g.width, lane);
      }
    }
    __syncthreads();
  }

  // 4. the folds: two lanes per (frame, lane) fold its nodes in the
  //    reference's order; a warp per (frame, lane) reduces min/max.  Each
  //    group starts on the warp after the previous group's last, so the
  //    groups' chains run side by side.
  int wc = 0;
  for (int gi = 0; gi < p.n_groups; ++gi) {
    const Group& g = p.groups[gi];
    const int rw = ((warp - wc) % nwarps + nwarps) % nwarps;
    const int rt = rw * 32 + lane;
    const int items = g.mg * Q * (g.family >= FAM_DRAWDOWN ? 1 : g.width);
    const float* up = s_f + g.up_off;
    const float* stash = s_f + g.stash_off;
    if (is_minmax(g)) {
      few_minmax(p, g, u, s_f + g.stage_off, s_se, rw, nwarps, lane);
      wc += items;
    } else {
      if (g.family == FAM_EW)
        few_answer<V3, FAM_EW>(p, g, u, up, stash, s_se, rt, nthr);
      else if (g.family == FAM_DRAWDOWN)
        few_answer<V3, FAM_DRAWDOWN>(p, g, u, up, stash, s_se, rt, nthr);
      else
        few_answer<float, FAM_ADD>(p, g, u, up, stash, s_se, rt, nthr);
      wc += (2 * items + 31) >> 5;
    }
  }
}

// ------------------------------------------------ many queries per unit

// packed tree levels of rows [0, hi): levels 0-5 by shuffles, then five
// levels per barrier (ft lanes, row-major; a V3 group is one 3-lane tile)
template <class T, int FC>
__device__ void build_tree(const Params& p, const Group& g, int u, int f0,
                           int ft, int hi, float* lvl, int tid, int nthr) {
  const int rp = p.rp, log2rp = p.log2rp, R = p.R, w = g.width;
  const int fam = g.family;
  const float logd = g.log_decay;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int nl = sizeof(T) == sizeof(V3) ? 1 : ft;
  const float* data_u = g.data + (size_t)u * R * w;
  const int n = ((hi + 31) >> 5) * nl;
  for (int t = warp; t < n; t += nwarps) {
    const int c = t / nl, f = t - c * nl;
    const int row = (c << 5) + lane;
    T v;
    if (row < R)
      ld(v, data_u, row, w, f0 + f);
    else
      ld(v, g.ident, 0, w, f0 + f);
    if (row < rp) st(lvl, row, ft, f, v);
    for (int k = 1; k <= 5 && k <= log2rp; ++k) {
      v = comb<FC>(fam, v, shfl_down(v, 1 << (k - 1)), logd);
      if ((lane & ((1 << k) - 1)) == 0 && (row >> k) < (rp >> k))
        st(lvl, level_off(rp, k) + (row >> k), ft, f, v);
    }
  }
  for (int base = 5; base < log2rp; base += 5) {
    __syncthreads();
    const int nn = min(rp >> base, (hi + (1 << base) - 1) >> base);
    const int m = ((nn + 31) >> 5) * nl;
    for (int t = warp; t < m; t += nwarps) {
      const int tt = t / nl, f = t - tt * nl;
      const int idx = (tt << 5) + lane;
      T v;
      if (idx < nn)
        ld(v, lvl, level_off(rp, base) + idx, ft, f);
      else
        ld(v, g.ident, 0, w, f0 + f);
      for (int k = 1; k <= 5 && base + k <= log2rp; ++k) {
        v = comb<FC>(fam, v, shfl_down(v, 1 << (k - 1)), logd);
        const int j = idx >> k;
        if ((lane & ((1 << k) - 1)) == 0 && j < (rp >> (base + k)))
          st(lvl, level_off(rp, base + k) + j, ft, f, v);
      }
    }
  }
}

// sparse table levels 0..J of rows [0, hi) (level j at row offset j * rp):
// levels 1-5 by shuffles over a 64-row window per warp, then one level
// per barrier
__device__ void build_sparse(const Params& p, const Group& g, int u, int f0,
                             int ft, int hi, int J, float* lvl, int tid,
                             int nthr) {
  const int rp = p.rp, R = p.R, w = g.width, fam = g.family;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const float* data_u = g.data + (size_t)u * R * w;
  const int n = ((hi + 31) >> 5) * ft, jl = min(J, 5);
  for (int t = warp; t < n; t += nwarps) {
    const int c = t / ft, f = t - c * ft;
    const int row = (c << 5) + lane;
    const float id = g.ident[f0 + f];
    float a = row < R ? data_u[(size_t)row * w + f0 + f] : id;
    float b = row + 32 < R ? data_u[(size_t)(row + 32) * w + f0 + f] : id;
    if (row < rp) lvl[(size_t)row * ft + f] = a;
    for (int j = 1; j <= jl; ++j) {
      const int src = lane + (1 << (j - 1));
      const float xa = __shfl_sync(FULL, a, src & 31);
      const float xb = __shfl_sync(FULL, b, src & 31);
      a = combine(fam, a, src < 32 ? xa : xb, 0.f);
      b = combine(fam, b, src < 32 ? xb : id, 0.f);
      if (row < rp) lvl[((size_t)j * rp + row) * ft + f] = a;
    }
  }
  for (int j = 6; j <= J; ++j) {
    __syncthreads();
    const int off = 1 << (j - 1);
    const float* prev = lvl + (size_t)(j - 1) * rp * ft;
    float* cur = lvl + (size_t)j * rp * ft;
    for (int i = tid; i < hi * ft; i += nthr) {
      const int row = i / ft, f = i - row * ft;
      const float b = row + off < rp ? prev[i + off * ft] : g.ident[f0 + f];
      cur[i] = combine(fam, prev[i], b, 0.f);
    }
  }
}

// MSB-first prefix fold of rows [0, x), x >= 1, over packed levels
template <class T, int FC>
__device__ T prefix_at(const Group& g, const float* lvl, int rp, int log2rp,
                       int ft, int f, int x) {
  T acc;
  bool first = true;
  int pos = 0;
  for (int k = log2rp; k >= 0; --k) {
    if ((x >> k) & 1) {
      T nd;
      ld(nd, lvl, level_off(rp, k) + (pos >> k), ft, f);
      acc = first ? nd : comb<FC>(g.family, acc, nd, g.log_decay);
      first = false;
      pos += 1 << k;
    }
  }
  return acc;
}

// Every scan prefix P[x], the fold of rows [0, x) for x in [1, hi], in
// the reference's MSB-first bracketing: P[x] = P[x - lowbit(x)] (+) the
// tree node of x's lowest set bit.  The chunk starts x = 32c fold their
// level >= 5 nodes, one thread each, into ``starts`` (row c); the other
// 31 prefixes of a chunk follow in five shuffle rounds (the lanes with j
// set bits take their source lane's prefix from round j - 1) and replace
// the chunk's level-0 rows, which only this warp reads (row x holds
// P[x]).  A query then reads two prefixes (``prefix_row``).
template <class T, int FC>
__device__ void build_prefixes(const Group& g, float* lvl, float* starts,
                               int rp, int log2rp, int ft, int hi, int tid,
                               int nthr) {
  const int nl = sizeof(T) == sizeof(V3) ? 1 : ft;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  for (int i = tid; i < (hi >> 5) * nl; i += nthr) {
    const int c = 1 + i / nl, f = i - (i / nl) * nl;
    st(starts, c, ft, f, prefix_at<T, FC>(g, lvl, rp, log2rp, ft, f, c << 5));
  }
  __syncthreads();
  const int n = ((hi >> 5) + 1) * nl;
  for (int t = warp; t < n; t += nwarps) {
    const int c = t / nl, f = t - c * nl;
    const int x = (c << 5) + lane;
    T v, node;
    ld(v, g.ident, 0, sizeof(T) == sizeof(V3) ? 3 : 1, 0);
    node = v;
    if (lane == 0 && c > 0) ld(v, starts, c, ft, f);
    if (lane > 0 && x <= hi) {
      const int k = __ffs(lane) - 1;
      ld(node, lvl, level_off(rp, k) + (x >> k) - 1, ft, f);
    }
    const int src = lane & (lane - 1), bits = __popc(lane);
#pragma unroll
    for (int j = 1; j <= 5; ++j) {
      const T w = shfl_idx(v, src);
      if (bits == j)
        v = (c == 0 && src == 0) ? node
                                 : comb<FC>(g.family, w, node, g.log_decay);
    }
    // every lane's node was read before the shuffles, so the warp may
    // now overwrite its chunk's rows
    if (lane > 0 && x <= hi) st(lvl, x, ft, f, v);
  }
}

// row of P[x] (x >= 1) after build_prefixes
__device__ __forceinline__ const float* prefix_row(const float* lvl,
                                                  const float* starts, int x,
                                                  int& row) {
  row = (x & 31) ? x : x >> 5;
  return (x & 31) ? lvl : starts;
}

template <class T, int FC>
__device__ T walk_at(const Group& g, const float* lvl, int rp, int log2rp,
                     int ft, int f, T id, int s, int e) {
  T rl = id, rr = id;
  int l = s, r = e;
  for (int k = 0; k <= log2rp; ++k) {
    const bool act = l < r;
    const bool tl = act && (l & 1), tr = act && (r & 1);
    const int off = level_off(rp, k);
    T nd;
    if (tl) {
      ld(nd, lvl, off + l, ft, f);
      rl = comb<FC>(g.family, rl, nd, g.log_decay);
    }
    if (tr) {
      ld(nd, lvl, off + r - 1, ft, f);
      rr = comb<FC>(g.family, nd, rr, g.log_decay);
    }
    l = (l + (tl ? 1 : 0)) >> 1;
    r = (r - (tr ? 1 : 0)) >> 1;
  }
  return comb<FC>(g.family, rl, rr, g.log_decay);
}

__global__ void __launch_bounds__(MAX_THREADS)
    uf_many_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int task = blockIdx.y;
  int gi = 0;
  while (gi + 1 < p.n_groups && task >= p.groups[gi + 1].tile_start) ++gi;
  const Group& g = p.groups[gi];
  const bool v3 = g.family >= FAM_DRAWDOWN;
  const int f0 = (task - g.tile_start) * g.tile;
  const int ft = min(g.tile, g.width - f0);
  const int rp = p.rp, log2rp = p.log2rp, Q = p.Q, mg = g.mg, w = g.width;
  const int mq_all = p.n_members * Q;
  const size_t total = (size_t)p.U * mq_all;
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31;
  int* s_red = reinterpret_cast<int*>(smem_raw);
  float* lvl = p.scratch != nullptr
                   ? p.scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                                     p.scratch_words
                   : reinterpret_cast<float*>(smem_raw) + 4;

  for (int u = blockIdx.x; u < p.U; u += gridDim.x) {
    const int* st_u = p.bounds + (size_t)u * mq_all;
    const int* en_u = st_u + total;
    // 1. the largest end and span of the group's non-empty frames
    if (tid == 0) {
      s_red[0] = 0;
      s_red[1] = 0;
    }
    __syncthreads();
    int me = 0, ms = 0;
    for (int i = tid; i < mg * Q; i += nthr) {
      const int mi = i / Q, b = g.members[mi] * Q + (i - mi * Q);
      const int s = st_u[b], e = en_u[b];
      if (e > s) {
        me = max(me, e);
        ms = max(ms, e - s);
      }
    }
    me = __reduce_max_sync(FULL, me);
    ms = __reduce_max_sync(FULL, ms);
    if (lane == 0) {
      atomicMax(&s_red[0], me);
      atomicMax(&s_red[1], ms);
    }
    __syncthreads();
    const int hi = min(s_red[0], rp);
    const int J = s_red[1] > 0 ? 31 - __clz(s_red[1]) : 0;

    // 2. the structure over [0, hi) only
    if (g.kind == KIND_SPARSE)
      build_sparse(p, g, u, f0, ft, hi, J, lvl, tid, nthr);
    else if (g.family == FAM_EW)
      build_tree<V3, FAM_EW>(p, g, u, 0, 3, hi, lvl, tid, nthr);
    else if (v3)
      build_tree<V3, FAM_DRAWDOWN>(p, g, u, 0, 3, hi, lvl, tid, nthr);
    else
      build_tree<float, FAM_ADD>(p, g, u, f0, ft, hi, lvl, tid, nthr);
    __syncthreads();
    // the scan families' chunk-start prefixes follow the packed levels
    float* starts = lvl + (size_t)2 * rp * ft;
    if (g.kind == KIND_SCAN) {
      if (v3)
        build_prefixes<V3, FAM_EW>(g, lvl, starts, rp, log2rp, 3, hi, tid,
                                   nthr);
      else
        build_prefixes<float, FAM_ADD>(g, lvl, starts, rp, log2rp, ft, hi,
                                       tid, nthr);
      __syncthreads();
    }

    // 3. queries
    float* out_u = g.out + (size_t)u * mg * Q * w;
    if (!v3) {
      for (int i = tid; i < mg * Q * ft; i += nthr) {
        const int fr = i / ft, f = i - fr * ft;
        const int mi = fr / Q, b = g.members[mi] * Q + (fr - mi * Q);
        const int s = st_u[b], e = en_u[b];
        const float id = g.ident[f0 + f];
        float res = id;
        if (e > s) {
          if (g.kind == KIND_SPARSE) {
            const int j = 31 - __clz(e - s);
            const int lo = clampi(s, 0, rp - 1);
            const int hj = clampi(e - (1 << j), 0, rp - 1);
            const float* lv = lvl + (size_t)j * rp * ft;
            res = combine(g.family, lv[(size_t)lo * ft + f],
                          lv[(size_t)hj * ft + f], 0.f);
          } else {
            int re, rs;
            const float* pe = prefix_row(lvl, starts, e, re);
            const float* ps = prefix_row(lvl, starts, max(s, 1), rs);
            res = __fsub_rn(pe[(size_t)re * ft + f],
                            s <= 0 ? id : ps[(size_t)rs * ft + f]);
          }
        }
        out_u[(size_t)fr * w + f0 + f] = res;
      }
    } else {
      V3 id;
      ld(id, g.ident, 0, 3, 0);
      for (int fr = tid; fr < mg * Q; fr += nthr) {
        const int mi = fr / Q, b = g.members[mi] * Q + (fr - mi * Q);
        const int s = st_u[b], e = en_u[b];
        V3 res;
        if (g.family == FAM_EW) {
          res = id;
          if (e > s) {
            V3 last, prev = id;
            int re, rs;
            const float* pe = prefix_row(lvl, starts, e, re);
            const float* ps = prefix_row(lvl, starts, max(s, 1), rs);
            ld(last, pe, re, 3, 0);
            if (s > 0) ld(prev, ps, rs, 3, 0);
            res = invert(last, prev, g.log_decay);
          }
        } else {
          res = walk_at<V3, FAM_DRAWDOWN>(g, lvl, rp, log2rp, 3, 0, id, s,
                                          e);
        }
        st(out_u, fr, 3, 0, res);
      }
    }
    __syncthreads();  // the next unit overwrites this one's structure
  }
}

// ------------------------------------------------------------------ launch

// Header layout (int32): U, R, rp, log2rp, Q, n_groups, n_members, mode,
// n_tasks, smem_bytes, threads, block columns, scratch words per block
// (0: shared memory), few_base; then 4 ints per member (rows, pre,
// maxsize, exclude); then GROUP_INTS per group (family, kind, width, tile,
// tile_start, mg, log_decay bits, stage_off, up_off, stash_off,
// members[MAX_MEMBERS]).  Pointers (int64): ts, q, bounds (many path),
// then data, out, ident per group, then the scratch buffer (0: shared).
#define HDR 14
#define GROUP_INTS (10 + MAX_MEMBERS)

template <class K>
static cudaError_t raise_smem(K kernel, int smem, int* cap) {
  if (smem <= *cap) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) *cap = smem;
  return err;
}

extern "C" int unit_fold_header_ints() { return HDR; }
extern "C" int unit_fold_group_ints() { return GROUP_INTS; }

extern "C" int unit_fold_launch(const int* hdr, const long long* ptrs,
                                void* stream) {
  Params p;
  p.U = hdr[0];
  p.R = hdr[1];
  p.rp = hdr[2];
  p.log2rp = hdr[3];
  p.Q = hdr[4];
  p.n_groups = hdr[5];
  p.n_members = hdr[6];
  const int mode = hdr[7], n_tasks = hdr[8], smem = hdr[9], threads = hdr[10];
  const int grid_x = hdr[11];
  p.scratch_words = hdr[12];
  p.few_base = hdr[13];
  if (p.n_groups < 1 || p.n_groups > MAX_GROUPS || p.n_members < 1 ||
      p.n_members > MAX_MEMBERS || p.U < 1 || p.R < 1 || p.Q < 1 ||
      p.rp < 2 || (1 << p.log2rp) != p.rp || p.R > p.rp ||
      (mode != MODE_FEW && mode != MODE_MANY) || p.scratch_words < 0 ||
      (long long)p.U * p.n_members * p.Q >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (threads < 32 || threads > MAX_THREADS || threads % 32 ||
      (mode == MODE_MANY &&
       (n_tasks < 1 || n_tasks > 65535 || grid_x < 1 || grid_x > p.U)))
    return (int)cudaErrorInvalidValue;
  p.ts = reinterpret_cast<const int*>(ptrs[0]);
  p.q = reinterpret_cast<const int*>(ptrs[1]);
  p.bounds = reinterpret_cast<int*>(ptrs[2]);
  p.scratch = reinterpret_cast<float*>(ptrs[3 + 3 * p.n_groups]);
  if ((p.scratch == nullptr) != (p.scratch_words == 0) ||
      (mode == MODE_MANY && p.bounds == nullptr))
    return (int)cudaErrorInvalidValue;
  for (int m = 0; m < p.n_members; ++m) {
    p.m_rows[m] = hdr[HDR + 4 * m];
    p.m_pre[m] = hdr[HDR + 4 * m + 1];
    p.m_maxsize[m] = hdr[HDR + 4 * m + 2];
    p.m_exclude[m] = hdr[HDR + 4 * m + 3];
  }
  const int* gh = hdr + HDR + 4 * p.n_members;
  for (int gi = 0; gi < p.n_groups; ++gi, gh += GROUP_INTS) {
    Group& g = p.groups[gi];
    g.data = reinterpret_cast<const float*>(ptrs[3 + 3 * gi]);
    g.out = reinterpret_cast<float*>(ptrs[4 + 3 * gi]);
    g.ident = reinterpret_cast<const float*>(ptrs[5 + 3 * gi]);
    g.family = gh[0];
    g.kind = gh[1];
    g.width = gh[2];
    g.tile = gh[3];
    g.tile_start = gh[4];
    g.mg = gh[5];
    memcpy(&g.log_decay, &gh[6], sizeof(float));
    g.stage_off = gh[7];
    g.up_off = gh[8];
    g.stash_off = gh[9];
    if (g.mg < 1 || g.mg > MAX_MEMBERS || g.tile < 1 || g.width < 1 ||
        g.family < FAM_ADD || g.family > FAM_EW ||
        (g.family >= FAM_DRAWDOWN && (g.width != 3 || g.tile != 3)))
      return (int)cudaErrorInvalidValue;
    for (int i = 0; i < g.mg; ++i) {
      g.members[i] = gh[10 + i];
      if (g.members[i] < 0 || g.members[i] >= p.n_members)
        return (int)cudaErrorInvalidValue;
    }
  }
  cudaStream_t cs = reinterpret_cast<cudaStream_t>(stream);
  // the dynamic shared-memory cap is per function: raise it once per new
  // maximum, later smaller launches reuse it
  static int few_cap = 48 * 1024, many_cap = 48 * 1024;
  cudaError_t err;
  if (mode == MODE_FEW) {
    if ((err = raise_smem(uf_few_kernel, smem, &few_cap)) != cudaSuccess)
      return (int)err;
    uf_few_kernel<<<p.U, threads, smem, cs>>>(p);
    return (int)cudaGetLastError();
  }
  if ((err = raise_smem(uf_many_kernel, smem, &many_cap)) != cudaSuccess)
    return (int)err;
  static int bounds_cap = 48 * 1024;
  const int bounds_smem = p.R <= BOUNDS_SMEM_ROWS ? p.R * 4 : 0;
  if ((err = raise_smem(uf_bounds_kernel, bounds_smem, &bounds_cap)) !=
      cudaSuccess)
    return (int)err;
  const dim3 bounds_grid(
      p.U, (p.n_members * p.Q + BOUNDS_FRAMES - 1) / BOUNDS_FRAMES);
  uf_bounds_kernel<<<bounds_grid, BOUNDS_THREADS, bounds_smem, cs>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  uf_many_kernel<<<dim3(grid_x, n_tasks), threads, smem, cs>>>(p);
  return (int)cudaGetLastError();
}
