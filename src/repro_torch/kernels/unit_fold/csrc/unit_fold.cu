// Fused unit fold of one window group on Hopper (sm_90a).
//
// Replaces src/repro/kernels/unit_fold/kernel.py::unit_fold_pallas (body
// _unit_fold_kernel).  For every unit u of a (U, rp) block of identity-
// padded rows it computes each member window's [start, end) frame bounds
// at the unit's Q query positions (ROWS arithmetic, the ROWS_RANGE binary
// search, MAXSIZE, EXCLUDE CURRENT_ROW), builds each leaf group's fold
// structure and answers the (member, query) folds:
//   scan   - packed balanced-tree levels + MSB-first prefix walk + prefix
//            difference (bitwise equal to an associative scan's bracketing)
//   sparse - sparse table, two lookups at level 31 - clz(span)
//   tree   - two-sided segment-tree walk
// over five combine families: ADD (scan), MIN and MAX (sparse),
// DRAWDOWN (tree, 3 lanes), EW (scan, 3 lanes, log(decay) a parameter).
//
// Bound: memory.  The least traffic is each unit's R real rows read once
// and each fold written once, (U*R*(F+1) + U*Mg*Q*F)*4 bytes over
// 3.35 TB/s; the arithmetic per byte is a few combines per tree level.
// The wrapper's identity padding of R rows to rp (a power of two) reads
// up to twice the rows that bound counts.
//
// Design.  The TPU kernel computed bounds at grid step 0 into scratch that
// later group steps read; GPU blocks run in no order, so nothing crosses
// blocks here and there are no atomics.  The grid is (units, lane tiles
// over all groups): each block loads its unit's order column into shared
// memory, computes the (Mg, Q) bounds of its own group's members there,
// builds its group's structure for its lane tile in shared memory, and
// writes its folds.  Stacked ADD/MIN/MAX lanes are independent, so the
// wrapper tiles them so that a block's levels fit the 227 KB a block may
// use (a wide HLL or histogram stack spreads across blocks); DRAWDOWN and
// EW lanes mix, so such a group is one tile of 3 lanes.  Structures are
// built once per block in shared memory and read by every query, so
// device memory sees only the rows in and the folds out.
//
// Wide units.  The offline engine folds every row of a unit (Q = rp), and
// a hot key's time slices can be tens of thousands of rows wide (rp up to
// 65,536 at the default 8 slices): the order column, the (Mg, Q) bounds
// and one lane's structure no longer fit 227 KB.  For such a launch the
// wrapper passes a global-memory scratch buffer, one slice per block: the
// kernel then reads the order column and the identity where they lie and
// keeps the bounds and the structure levels in its slice.  The code path
// is the same, so the bracketing, and every bit, is the same.  Blocks walk
// the units with a grid stride (blockIdx.x, + gridDim.x, ...) so the
// wrapper can bound the scratch by launching fewer block columns than
// units.
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

enum { FAM_ADD = 0, FAM_MIN = 1, FAM_MAX = 2, FAM_DRAWDOWN = 3, FAM_EW = 4 };
enum { KIND_SCAN = 0, KIND_SPARSE = 1, KIND_TREE = 2 };

#define NEG_INF (-3.0e38f)
#define POS_INF (3.0e38f)

struct Group {
  const float* data;   // (U, rp, width)
  float* out;          // (U, mg, Q, width)
  const float* ident;  // (width,)
  int family, kind, width, tile, tile_start, mg;
  float log_decay;
  int members[MAX_MEMBERS];
};

struct Params {
  const int* ts;  // (U, rp) INT_MAX-padded order column
  const int* q;   // (U, Q) query positions
  int* scratch;   // global-memory slices, one per block; null: shared
  int scratch_words;  // 4-byte words per block slice
  int U, rp, log2rp, Q, n_groups, n_members;
  int m_rows[MAX_MEMBERS], m_pre[MAX_MEMBERS], m_maxsize[MAX_MEMBERS],
      m_exclude[MAX_MEMBERS];
  Group groups[MAX_GROUPS];
};

struct V3 {
  float a, b, c;
};

// min/max that propagate NaN (NULL), as torch.minimum/maximum and
// jnp.minimum/maximum do; fminf/fmaxf would drop a NaN operand
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float comb1(int fam, float a, float b) {
  if (fam == FAM_ADD) return __fadd_rn(a, b);
  if (fam == FAM_MIN) return nan_min(a, b);
  return nan_max(a, b);
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

__device__ __forceinline__ V3 ew_invert(V3 e, V3 s, float logd) {
  float n = __fsub_rn(e.c, s.c);
  float scale = expf(__fmul_rn(n, logd));
  return V3{__fsub_rn(e.a, __fmul_rn(scale, s.a)),
            __fsub_rn(e.b, __fmul_rn(scale, s.b)), n};
}

__device__ __forceinline__ V3 comb3(int fam, V3 x, V3 y, float logd) {
  return fam == FAM_EW ? ew_combine(x, y, logd) : dd_combine(x, y);
}

__device__ __forceinline__ V3 load3(const float* p) {
  return V3{p[0], p[1], p[2]};
}

// row offset of tree level k inside the packed (2*rp - 1)-row levels
__device__ __forceinline__ int level_off(int rp, int k) {
  return 2 * rp - ((2 * rp) >> k);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// scan prefix of rows [0, e), e >= 1, lane f of a ft-wide tile
__device__ float prefix1(const float* lvl, int rp, int log2rp, int ft, int f,
                         int fam, int e) {
  float acc = 0.f;
  bool first = true;
  int pos = 0;
  for (int k = log2rp; k >= 0; --k) {
    if ((e >> k) & 1) {
      float node = lvl[(level_off(rp, k) + (pos >> k)) * ft + f];
      acc = first ? node : comb1(fam, acc, node);
      first = false;
      pos += 1 << k;
    }
  }
  return acc;
}

__device__ V3 prefix3(const float* lvl, int rp, int log2rp, float logd,
                      int e) {
  V3 acc{0.f, 0.f, 0.f};
  bool first = true;
  int pos = 0;
  for (int k = log2rp; k >= 0; --k) {
    if ((e >> k) & 1) {
      V3 node = load3(lvl + (level_off(rp, k) + (pos >> k)) * 3);
      acc = first ? node : ew_combine(acc, node, logd);
      first = false;
      pos += 1 << k;
    }
  }
  return acc;
}

__global__ void unit_fold_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int task = blockIdx.y;
  int gi = 0;
  while (gi + 1 < p.n_groups && task >= p.groups[gi + 1].tile_start) ++gi;
  const Group& g = p.groups[gi];
  const int f0 = (task - g.tile_start) * g.tile;
  const int ft = min(g.tile, g.width - f0);
  const int rp = p.rp, Q = p.Q, mg = g.mg, fam = g.family;
  const int nthr = blockDim.x, tid = threadIdx.x;

  for (int u = blockIdx.x; u < p.U; u += gridDim.x) {
    const int* ts_u = p.ts + (size_t)u * rp;
    const float* data_u = g.data + (size_t)u * rp * g.width + f0;
    const int* s_ts;
    const float* s_ident;
    int* s_start;
    float* s_lvl;
    if (p.scratch == nullptr) {
      // 1. the unit's order column and the tile's identity in shared
      //    memory, then its bounds and levels
      int* sh_ts = reinterpret_cast<int*>(smem_raw);
      s_start = sh_ts + rp;
      float* sh_ident = reinterpret_cast<float*>(s_start + 2 * mg * Q);
      s_lvl = sh_ident + ft;
      for (int i = tid; i < rp; i += nthr) sh_ts[i] = ts_u[i];
      for (int f = tid; f < ft; f += nthr) sh_ident[f] = g.ident[f0 + f];
      s_ts = sh_ts;
      s_ident = sh_ident;
    } else {
      // 1'. a wide unit: the order column and the identity are read where
      //     they lie, bounds and levels go to this block's global slice
      s_start = p.scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                                p.scratch_words;
      s_lvl = reinterpret_cast<float*>(s_start + 2 * mg * Q);
      s_ts = ts_u;
      s_ident = g.ident + f0;
    }
    int* s_end = s_start + mg * Q;
    for (int i = tid; i < rp * ft; i += nthr) {
      int row = i / ft, f = i - row * ft;
      s_lvl[i] = data_u[(size_t)row * g.width + f];
    }
    __syncthreads();

    // 2. frame bounds of the group's members at the unit's queries
    const int* q_u = p.q + (size_t)u * Q;
    const int steps = p.log2rp + 1;
    for (int i = tid; i < mg * Q; i += nthr) {
      int mi = i / Q, qi = i - mi * Q;
      int m = g.members[mi];
      int qv = q_u[qi];
      int end = qv + 1;
      int start;
      if (p.m_rows[m]) {
        start = max(0, qv - p.m_pre[m]);
      } else {
        int target = (int)((unsigned)s_ts[clampi(qv, 0, rp - 1)] -
                           (unsigned)p.m_pre[m]);
        int lo = 0, hi = end;
        for (int s = 0; s < steps; ++s) {
          int mid = (lo + hi) >> 1;
          int v = s_ts[clampi(mid, 0, rp - 1)];
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
      s_start[i] = start;
      s_end[i] = end;
    }

    // 3. build the structure (in shared memory, or the block's slice)
    const bool lanes3 = (fam == FAM_DRAWDOWN || fam == FAM_EW);
    if (g.kind == KIND_SPARSE) {
      for (int j = 1; (1 << j) <= rp; ++j) {
        const int off = 1 << (j - 1);
        const float* prev = s_lvl + (size_t)(j - 1) * rp * ft;
        float* cur = s_lvl + (size_t)j * rp * ft;
        for (int i = tid; i < rp * ft; i += nthr) {
          int row = i / ft, f = i - row * ft;
          float b = row + off < rp ? prev[i + off * ft] : s_ident[f];
          cur[i] = comb1(fam, prev[i], b);
        }
        __syncthreads();
      }
    } else {
      int n = rp;
      for (int k = 1; n > 1; ++k) {
        const float* prev = s_lvl + (size_t)level_off(rp, k - 1) * ft;
        float* cur = s_lvl + (size_t)level_off(rp, k) * ft;
        const int n2 = n >> 1;
        if (lanes3) {
          for (int i = tid; i < n2; i += nthr) {
            V3 r = comb3(fam, load3(prev + 6 * i), load3(prev + 6 * i + 3),
                         g.log_decay);
            cur[3 * i] = r.a;
            cur[3 * i + 1] = r.b;
            cur[3 * i + 2] = r.c;
          }
        } else {
          for (int i = tid; i < n2 * ft; i += nthr) {
            int row = i / ft, f = i - row * ft;
            cur[i] = comb1(fam, prev[2 * row * ft + f],
                           prev[(2 * row + 1) * ft + f]);
          }
        }
        __syncthreads();
        n = n2;
      }
    }
    __syncthreads();

    // 4. queries
    float* out_u = g.out + (size_t)u * mg * Q * g.width + f0;
    if (!lanes3) {
      for (int i = tid; i < mg * Q * ft; i += nthr) {
        int mq = i / ft, f = i - mq * ft;
        int s = s_start[mq], e = s_end[mq];
        float id = s_ident[f], res;
        if (g.kind == KIND_SPARSE) {
          int span = max(e - s, 1);
          int j = 31 - __clz(span);
          int lo = clampi(s, 0, rp - 1);
          int hi = clampi(e - (1 << j), 0, rp - 1);
          const float* lv = s_lvl + (size_t)j * rp * ft;
          res = comb1(fam, lv[lo * ft + f], lv[hi * ft + f]);
        } else {  // ADD scan
          float last = prefix1(s_lvl, rp, p.log2rp, ft, f, fam, max(e, 1));
          float prev = s <= 0 ? id
                              : prefix1(s_lvl, rp, p.log2rp, ft, f, fam,
                                        max(s, 1));
          res = __fsub_rn(last, prev);
        }
        out_u[(size_t)mq * g.width + f] = e <= s ? id : res;
      }
    } else {
      const V3 id{s_ident[0], s_ident[1], s_ident[2]};
      for (int mq = tid; mq < mg * Q; mq += nthr) {
        int s = s_start[mq], e = s_end[mq];
        V3 res;
        if (g.kind == KIND_SCAN) {  // EW
          V3 last = prefix3(s_lvl, rp, p.log2rp, g.log_decay, max(e, 1));
          V3 prev = s <= 0 ? id
                           : prefix3(s_lvl, rp, p.log2rp, g.log_decay,
                                     max(s, 1));
          res = e <= s ? id : ew_invert(last, prev, g.log_decay);
        } else {  // DRAWDOWN tree
          V3 rl = id, rr = id;
          int l = s, r = e;
          for (int k = 0; k <= p.log2rp; ++k) {
            const int off = level_off(rp, k), m_nodes = rp >> k;
            bool active = l < r;
            bool tl = active && (l & 1);
            bool tr = active && (r & 1);
            if (tl)
              rl = comb3(fam, rl,
                         load3(s_lvl + (off + clampi(l, 0, m_nodes - 1)) * 3),
                         g.log_decay);
            if (tr)
              rr = comb3(fam,
                         load3(s_lvl +
                               (off + clampi(r - 1, 0, m_nodes - 1)) * 3),
                         rr, g.log_decay);
            l = (l + (tl ? 1 : 0)) >> 1;
            r = (r - (tr ? 1 : 0)) >> 1;
          }
          res = comb3(fam, rl, rr, g.log_decay);
        }
        float* o = out_u + (size_t)mq * g.width;
        o[0] = res.a;
        o[1] = res.b;
        o[2] = res.c;
      }
    }
    __syncthreads();  // the next unit overwrites this one's structure
  }
}

// Header layout (int32): U, rp, log2rp, Q, n_groups, n_members, n_tasks,
// smem_bytes, threads, block columns, scratch words per block (0: the
// shared-memory variant); then 4 ints per member (rows, pre, maxsize,
// exclude); then GROUP_INTS per group (family, kind, width, tile,
// tile_start, mg, log_decay bits, members[MAX_MEMBERS]).  Pointers
// (int64): ts, q, then data, out, ident per group, then the scratch
// buffer (0 for the shared-memory variant).
#define HDR 11
#define GROUP_INTS (7 + MAX_MEMBERS)

extern "C" int unit_fold_launch(const int* hdr, const long long* ptrs,
                                void* stream) {
  Params p;
  p.U = hdr[0];
  p.rp = hdr[1];
  p.log2rp = hdr[2];
  p.Q = hdr[3];
  p.n_groups = hdr[4];
  p.n_members = hdr[5];
  const int n_tasks = hdr[6], smem = hdr[7], threads = hdr[8];
  const int grid_x = hdr[9];
  p.scratch_words = hdr[10];
  if (p.n_groups < 1 || p.n_groups > MAX_GROUPS || p.n_members < 1 ||
      p.n_members > MAX_MEMBERS || n_tasks < 1 || n_tasks > 65535 ||
      p.U < 1 || p.rp < 2 || (1 << p.log2rp) != p.rp || grid_x < 1 ||
      grid_x > p.U || p.scratch_words < 0)
    return (int)cudaErrorInvalidValue;
  p.ts = reinterpret_cast<const int*>(ptrs[0]);
  p.q = reinterpret_cast<const int*>(ptrs[1]);
  p.scratch = reinterpret_cast<int*>(ptrs[2 + 3 * p.n_groups]);
  if ((p.scratch == nullptr) != (p.scratch_words == 0))
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
    g.data = reinterpret_cast<const float*>(ptrs[2 + 3 * gi]);
    g.out = reinterpret_cast<float*>(ptrs[3 + 3 * gi]);
    g.ident = reinterpret_cast<const float*>(ptrs[4 + 3 * gi]);
    g.family = gh[0];
    g.kind = gh[1];
    g.width = gh[2];
    g.tile = gh[3];
    g.tile_start = gh[4];
    g.mg = gh[5];
    memcpy(&g.log_decay, &gh[6], sizeof(float));
    if (g.mg < 1 || g.mg > MAX_MEMBERS || g.tile < 1 || g.width < 1)
      return (int)cudaErrorInvalidValue;
    for (int i = 0; i < g.mg; ++i) g.members[i] = gh[7 + i];
  }
  // raise the kernel's dynamic shared-memory cap once per new maximum
  // (the attribute is per function, so later smaller launches reuse it)
  static int smem_cap = 48 * 1024;
  if (smem > smem_cap) {
    cudaError_t err = cudaFuncSetAttribute(
        unit_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_cap = smem;
  }
  unit_fold_kernel<<<dim3(grid_x, n_tasks), threads, smem,
                     reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
