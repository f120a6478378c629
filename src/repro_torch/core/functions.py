"""Aggregate feature functions as bounded-state monoids.

Every OpenMLDB window function is a *monoid* over a bounded per-row
state:

  - ``lift``      row -> state
  - ``combine``   state x state -> state           (associative)
  - ``identity``  neutral element
  - ``invert_prefix`` (optional)  prefix-difference: given segment-prefix
    folds P_end and P_start, recover the fold of rows [start, end).

Cycle binding (§4.2) is leaf-level CSE: ``avg`` re-uses the same
``sum``/``count`` leaves as plain ``sum``/``count``.  Dictionary encoding
(types.Dictionary) bounds category cardinality, which turns the
"exact-scan" functions (topN_frequency, distinct_count, avg_cate_where)
into exact bounded-state monoids over a (cardinality,)-histogram.

Every combine here is written op for op as the reference package writes
it (same operands, same order), so the fold kernels built on them give
the same bits.  Keys, codes and positions stay int32; ``_fmix32`` does
its uint32 arithmetic in int64 masked to 32 bits, because torch has no
full uint32 arithmetic.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .expr import AggCall, Expr, as_tensor, eval_scalar

__all__ = [
    "Leaf", "AddLeaf", "MinLeaf", "MaxLeaf", "DrawdownLeaf", "EWLeaf",
    "HLLLeaf", "Aggregator", "build_aggregator", "eval_scalar_fn",
    "AGG_FUNCTIONS", "floor_log2",
]

_NEG_INF = -3.0e38  # f32-safe sentinels (avoid inf arithmetic in combines)
_POS_INF = 3.0e38
_MASK32 = 0xFFFFFFFF


# --------------------------------------------------------------------------
# Leaves: the unit of state sharing (cycle binding happens at leaf level).
# --------------------------------------------------------------------------


class Leaf:
    key: str
    shape: Tuple[int, ...]
    invertible: bool = False
    # idempotent (and commutative) combines — min/max — admit
    # overlapping-range folds: sparse-table queries answer any window in
    # TWO combines instead of a log-depth tree walk, bitwise-exactly
    idempotent: bool = False

    def lift(self, env) -> torch.Tensor:
        """Per-row states: (rows, *shape)."""
        raise NotImplementedError

    def identity(self) -> torch.Tensor:
        raise NotImplementedError

    def combine(self, a, b):
        raise NotImplementedError

    def invert_prefix(self, p_end, p_start):
        raise NotImplementedError


def _masked(env, value, fill: float):
    """Apply the window-validity mask if present (rows outside a window
    or NULL rows contribute the identity)."""
    mask = env.get("__valid__")
    if mask is None:
        return value
    extra = value.dim() - mask.dim()
    if extra > 0:
        mask = mask.reshape(tuple(mask.shape) + (1,) * extra)
    return torch.where(mask, value, fill)


def _f32(v) -> torch.Tensor:
    return as_tensor(v).to(torch.float32)


@dataclasses.dataclass
class AddLeaf(Leaf):
    """Additive leaf: sum-like; covers scalar sums/counts and histograms."""

    key: str
    value_fn: Callable[[dict], torch.Tensor]
    shape: Tuple[int, ...] = ()
    invertible: bool = True

    def lift(self, env):
        return _masked(env, _f32(self.value_fn(env)), 0.0)

    def identity(self):
        return torch.zeros(self.shape, dtype=torch.float32)

    def combine(self, a, b):
        return a + b

    def invert_prefix(self, p_end, p_start):
        return p_end - p_start


@dataclasses.dataclass
class MinLeaf(Leaf):
    key: str
    value_fn: Callable[[dict], torch.Tensor] = None
    shape: Tuple[int, ...] = ()
    invertible: bool = False
    idempotent: bool = True

    def lift(self, env):
        return _masked(env, _f32(self.value_fn(env)), _POS_INF)

    def identity(self):
        return torch.full(self.shape, _POS_INF, dtype=torch.float32)

    def combine(self, a, b):
        return torch.minimum(a, b)


@dataclasses.dataclass
class MaxLeaf(Leaf):
    key: str
    value_fn: Callable[[dict], torch.Tensor] = None
    shape: Tuple[int, ...] = ()
    invertible: bool = False
    idempotent: bool = True

    def lift(self, env):
        return _masked(env, _f32(self.value_fn(env)), _NEG_INF)

    def identity(self):
        return torch.full(self.shape, _NEG_INF, dtype=torch.float32)

    def combine(self, a, b):
        return torch.maximum(a, b)


@dataclasses.dataclass
class DrawdownLeaf(Leaf):
    """Max decline percentage from a running peak (paper §4.1(3)).

    State [mx, mn, dd]: segment max, segment min, best drawdown inside the
    segment.  combine(L, R) additionally considers peaks in L with troughs
    in R — exactly the cross-term of a segment-tree merge.  Values are
    assumed positive (prices); non-positive peaks contribute no drawdown.
    """

    key: str
    value_fn: Callable[[dict], torch.Tensor] = None
    shape: Tuple[int, ...] = (3,)
    invertible: bool = False

    def lift(self, env):
        v = _f32(self.value_fn(env))
        mx = _masked(env, v, _NEG_INF)
        mn = _masked(env, v, _POS_INF)
        dd = torch.zeros_like(v)
        return torch.stack([mx, mn, dd], dim=-1)

    def identity(self):
        return torch.tensor([_NEG_INF, _POS_INF, 0.0], dtype=torch.float32)

    def combine(self, a, b):
        amx, amn, add_ = a[..., 0], a[..., 1], a[..., 2]
        bmx, bmn, bdd = b[..., 0], b[..., 1], b[..., 2]
        ok = (amx > 0) & (amx > _NEG_INF / 2) & (bmn < _POS_INF / 2)
        cross = torch.where(ok, (amx - bmn) / torch.where(ok, amx, 1.0), 0.0)
        dd = torch.maximum(torch.maximum(add_, bdd),
                           torch.clamp_min(cross, 0.0))
        return torch.stack(
            [torch.maximum(amx, bmx), torch.minimum(amn, bmn), dd], dim=-1)


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer over uint32 values held in int64.  An
    int64 product of two 32-bit values can wrap, but its low 32 bits are
    the uint32 product, so masking after each multiply is exact."""
    x = x.to(torch.int64) & _MASK32
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _MASK32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _MASK32
    return x ^ (x >> 16)


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """Exact floor(log2(x)) of positive integers (int64 result) — the
    ``31 - clz`` of a 32-bit value, which torch has no operator for."""
    x = x.to(torch.int64)
    out = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        big = x >= (1 << shift)
        out = torch.where(big, out + shift, out)
        x = torch.where(big, x >> shift, x)
    return out


@dataclasses.dataclass
class HLLLeaf(Leaf):
    """HyperLogLog distinct-count state — the mergeable-sketch leaf.

    State: (2^p,) float32 register maxima; ``combine`` = elementwise max,
    so the leaf is idempotent + commutative and rides the max stack of
    the fused fold.
    """

    key: str
    value_fn: Callable[[dict], torch.Tensor] = None
    p: int = 8
    shape: Tuple[int, ...] = ()
    invertible: bool = False
    idempotent: bool = True

    def __post_init__(self):
        self.m = 1 << self.p
        self.shape = (self.m,)

    def lift(self, env):
        code = as_tensor(self.value_fn(env)).to(torch.int64)
        h = _fmix32(code)
        idx = h >> (32 - self.p)
        rest = (h << self.p) & _MASK32
        # rank = leading zeros of the remaining 32 bits + 1, capped for 0
        lz = 31 - floor_log2(torch.clamp_min(rest, 1))
        rank = torch.where(rest != 0, lz + 1,
                           32 - self.p + 1).to(torch.float32)
        iota = torch.arange(self.m, dtype=torch.int64, device=code.device)
        oh = (idx[..., None] == iota).to(torch.float32) * rank[..., None]
        return _masked(env, oh, 0.0)

    def identity(self):
        return torch.zeros(self.shape, dtype=torch.float32)

    def combine(self, a, b):
        return torch.maximum(a, b)

    def estimate(self, regs: torch.Tensor) -> torch.Tensor:
        """Flajolet estimator + small-range linear counting (vectorized
        over any leading batch dims)."""
        from .hll import _alpha

        m = float(self.m)
        inv = torch.sum(torch.exp2(-regs), dim=-1)
        est = torch.tensor(_alpha(self.m), dtype=torch.float32) * m * m / inv
        zeros = torch.sum((regs == 0).to(torch.float32), dim=-1)
        lc = m * torch.log(m / torch.clamp_min(zeros, 1.0))
        return torch.where((est <= 2.5 * m) & (zeros > 0), lc,
                           est).to(torch.float32)


@dataclasses.dataclass
class EWLeaf(Leaf):
    """Exponentially-weighted average (paper §4.1(3), ``ew_avg``).

    For ordered rows x_1..x_n (oldest..newest) with decay d = 1/(1+alpha):
        ew = (sum_i d^(n-i) x_i) / (sum_i d^(n-i))
    State [ws, wc, n]; combine(L, R) = [R.ws + d^R.n * L.ws, ..., L.n+R.n].
    Left-prefix-invertible: W = P_end ⊖ d^(e-s)·P_start.
    """

    key: str
    value_fn: Callable[[dict], torch.Tensor] = None
    decay: float = 0.5
    shape: Tuple[int, ...] = (3,)
    invertible: bool = True

    def lift(self, env):
        v = _f32(self.value_fn(env))
        one = torch.ones_like(v)
        ws = _masked(env, v, 0.0)
        wc = _masked(env, one, 0.0)
        n = _masked(env, one, 0.0)
        return torch.stack([ws, wc, n], dim=-1)

    def identity(self):
        return torch.zeros((3,), dtype=torch.float32)

    @functools.cached_property
    def log_decay(self) -> float:
        """log(d) in float32, computed once: the CUDA fold takes the same
        value as a parameter, so kernel and plain version scale alike."""
        return float(torch.log(torch.tensor(self.decay, dtype=torch.float32)))

    def _pow(self, n):
        return torch.exp(n * self.log_decay)

    def combine(self, a, b):
        scale = self._pow(b[..., 2])
        ws = b[..., 0] + scale * a[..., 0]
        wc = b[..., 1] + scale * a[..., 1]
        return torch.stack([ws, wc, a[..., 2] + b[..., 2]], dim=-1)

    def invert_prefix(self, p_end, p_start):
        n = p_end[..., 2] - p_start[..., 2]
        scale = self._pow(n)
        ws = p_end[..., 0] - scale * p_start[..., 0]
        wc = p_end[..., 1] - scale * p_start[..., 1]
        return torch.stack([ws, wc, n], dim=-1)


# --------------------------------------------------------------------------
# Aggregators: feature functions = leaves + a finalizer.
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Aggregator:
    name: str
    leaves: List[Leaf]
    finalize: Callable[[Dict[str, torch.Tensor]], torch.Tensor]
    n_outputs: int = 1
    output_names: Optional[List[str]] = None

    @property
    def invertible(self) -> bool:
        return all(l.invertible for l in self.leaves)


def _value_fn(arg: Expr):
    return lambda env: as_tensor(eval_scalar(arg, env))


def _onehot_fn(arg: Expr, card: int, weight: Optional[Expr] = None,
               cond: Optional[Expr] = None):
    """(rows, card) one-hot (optionally value-weighted / condition-masked).

    This is the dense histogram lift that makes topN_frequency /
    distinct_count / avg_cate_where exact bounded-state monoids.
    """

    def fn(env):
        code = as_tensor(eval_scalar(arg, env)).to(torch.int32)
        iota = torch.arange(card, dtype=torch.int32, device=code.device)
        oh = (code[..., None] == iota).to(torch.float32)
        if cond is not None:
            c = as_tensor(eval_scalar(cond, env)).to(torch.float32)
            oh = oh * c[..., None]
        if weight is not None:
            w = as_tensor(eval_scalar(weight, env)).to(torch.float32)
            oh = oh * w[..., None]
        return oh

    return fn


def _safe_div(a, b):
    return a / torch.where(b == 0, 1.0, b)


def _top_k_indices(counts: torch.Tensor, n: int):
    """``jax.lax.top_k`` order: descending, ties to the lower index (a
    stable descending sort keeps equal counts in index order)."""
    vals, idx = torch.sort(counts, dim=-1, descending=True, stable=True)
    return vals[..., :n], idx[..., :n]


def build_aggregator(call: AggCall, ctx) -> Aggregator:
    """Construct the Aggregator for one AggCall.

    ``ctx`` provides ``cardinality(expr) -> int`` for histogram-state
    functions (derived from dictionary sizes / declared bounds).
    """
    fn = call.fn.lower()
    args = call.args
    params = call.params

    def fp(i):  # fingerprint of the i-th argument
        return args[i].fingerprint()

    if fn in ("sum", "count", "avg", "stddev", "variance"):
        leaves: List[Leaf] = []
        if fn != "count":
            leaves.append(AddLeaf(f"sum:{fp(0)}", _value_fn(args[0])))
        if fn != "sum":
            cnt_key = f"count:{fp(0)}"
            leaves.append(AddLeaf(cnt_key, lambda env: torch.ones_like(
                as_tensor(eval_scalar(args[0], env)), dtype=torch.float32)))
        if fn in ("stddev", "variance"):
            sq = lambda env: torch.square(  # noqa: E731
                as_tensor(eval_scalar(args[0], env)).to(torch.float32))
            leaves.append(AddLeaf(f"sumsq:{fp(0)}", sq))
        keys = [l.key for l in leaves]

        if fn in ("sum", "count"):
            fin = lambda s: s[keys[0]]  # noqa: E731
        elif fn == "avg":
            fin = lambda s: _safe_div(s[keys[0]], s[keys[1]])  # noqa: E731
        else:
            def fin(s, _v=(fn == "variance")):
                mean = _safe_div(s[keys[0]], s[keys[1]])
                var = _safe_div(s[keys[2]], s[keys[1]]) - torch.square(mean)
                var = torch.clamp_min(var, 0.0)
                return var if _v else torch.sqrt(var)
        return Aggregator(fn, leaves, fin)

    if fn in ("min", "max"):
        cls = MinLeaf if fn == "min" else MaxLeaf
        leaf = cls(f"{fn}:{fp(0)}", _value_fn(args[0]))
        sentinel = _POS_INF if fn == "min" else _NEG_INF

        def fin(s, k=leaf.key, sent=sentinel):
            v = s[k]
            return torch.where(torch.abs(v) >= abs(sent) / 2, 0.0, v)

        return Aggregator(fn, [leaf], fin)

    if fn == "distinct_count":
        card = ctx.cardinality(args[0])
        hll_p = getattr(ctx, "distinct_hll_p", None)
        if hll_p and card >= getattr(ctx, "distinct_hll_min_card", 64):
            # wide key universe: mergeable sketch instead of the exact
            # dense histogram — O(2^p) state per pre-agg bucket
            leaf = HLLLeaf(f"hll:{fp(0)}:{hll_p}", _value_fn(args[0]),
                           p=int(hll_p))
            return Aggregator(
                fn, [leaf],
                lambda s, l=leaf: l.estimate(s[l.key]))
        leaf = AddLeaf(f"hist:{fp(0)}:{card}", _onehot_fn(args[0], card),
                       shape=(card,))
        return Aggregator(
            fn, [leaf],
            lambda s, k=leaf.key: torch.sum((s[k] > 0).to(torch.float32),
                                            dim=-1))

    if fn in ("topn_frequency", "top_n_frequency", "topn_freq"):
        card = ctx.cardinality(args[0])
        top_n = int(params[0]) if params else int(args[1].value)
        leaf = AddLeaf(f"hist:{fp(0)}:{card}", _onehot_fn(args[0], card),
                       shape=(card,))

        def fin(s, k=leaf.key, n=top_n):
            vals, idx = _top_k_indices(s[k], n)
            return torch.where(vals > 0, idx, -1).to(torch.float32)

        return Aggregator(fn, [leaf], fin, n_outputs=top_n,
                          output_names=[f"top{i+1}" for i in range(top_n)])

    if fn in ("avg_cate_where", "avg_category_where", "avg_cate"):
        # avg_cate(value, category) / avg_cate_where(value, cond, category)
        if fn == "avg_cate":
            value, cond, cat = args[0], None, args[1]
        else:
            value, cond, cat = args[0], args[1], args[2]
        card = ctx.cardinality(cat)
        cfp = cat.fingerprint()
        wfp = value.fingerprint()
        xfp = cond.fingerprint() if cond is not None else ""
        s_leaf = AddLeaf(f"cate_sum:{wfp}|{xfp}|{cfp}:{card}",
                         _onehot_fn(cat, card, weight=value, cond=cond),
                         shape=(card,))
        c_leaf = AddLeaf(f"cate_cnt:{xfp}|{cfp}:{card}",
                         _onehot_fn(cat, card, cond=cond), shape=(card,))

        def fin(s, sk=s_leaf.key, ck=c_leaf.key):
            return _safe_div(s[sk], s[ck])

        return Aggregator(fn, [s_leaf, c_leaf], fin, n_outputs=card,
                          output_names=[f"cate{i}" for i in range(card)])

    if fn == "drawdown":
        leaf = DrawdownLeaf(f"dd:{fp(0)}", _value_fn(args[0]))
        return Aggregator(
            fn, [leaf],
            lambda s, k=leaf.key: torch.clamp_min(s[k][..., 2], 0.0))

    if fn == "ew_avg":
        alpha = float(params[0]) if params else float(args[1].value)
        decay = 1.0 / (1.0 + alpha)
        leaf = EWLeaf(f"ew:{fp(0)}:{decay:.6g}", _value_fn(args[0]),
                      decay=decay)
        return Aggregator(fn, [leaf],
                          lambda s, k=leaf.key: _safe_div(s[k][..., 0],
                                                          s[k][..., 1]))

    raise ValueError(f"unknown aggregate function {call.fn!r}")


AGG_FUNCTIONS = (
    "sum", "count", "avg", "min", "max", "stddev", "variance",
    "distinct_count", "topn_frequency", "avg_cate_where", "avg_cate",
    "drawdown", "ew_avg",
)


# --------------------------------------------------------------------------
# Scalar (row-level) functions — §4.1 (4)(5).
# --------------------------------------------------------------------------


def eval_scalar_fn(name: str, args: Sequence[Expr], env):
    name = name.lower()
    if name == "multiclass_label":
        return as_tensor(eval_scalar(args[0], env)).to(torch.int32)
    if name in ("continuous", "label"):
        return as_tensor(eval_scalar(args[0], env)).to(torch.float32)
    if name == "discrete":
        # feature-signature hashing; dim is a static literal
        from ..kernels.feature_hash import ops as fh_ops

        code = as_tensor(eval_scalar(args[0], env)).to(torch.int32)
        dim = int(args[1].value) if len(args) > 1 else 1 << 20
        return fh_ops.feature_hash(code, dim).to(torch.float32)
    if name == "abs":
        return torch.abs(as_tensor(eval_scalar(args[0], env)))
    if name == "log1p":
        return torch.log1p(as_tensor(eval_scalar(args[0], env)))
    if name in ("if_null", "ifnull"):
        v = as_tensor(eval_scalar(args[0], env))
        return torch.where(torch.isnan(v), eval_scalar(args[1], env), v)
    raise ValueError(f"unknown scalar function {name!r}")
