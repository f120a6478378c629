"""The staged window primitives (``core/window.py``), port against
reference, on the same numpy-seeded inputs.

``associative_scan`` is held bitwise to ``jax.lax.associative_scan`` on
every length from 1 to 33 and on 1,000, forward and reversed, in
segments, with NaN.  The other primitives are bitwise for every leaf
family except EW (``EW_RTOL``: an exp ulp of XLA against torch carried
by the fold); their batched (U, R) form equals one unit at a time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import functions as jf
from repro.core import window as jw
from repro_torch.core import functions as tf
from repro_torch.core import window as tw
from repro_torch.kernels.unit_fold import ref as uf_ref

from torch_port_cases import EW_ATOL, EW_RTOL

LENGTHS = list(range(1, 34)) + [1000]


def _leaves(kind):
    """(reference leaf, port leaf) over column ``x``."""
    jv = lambda env: jnp.asarray(env["x"])       # noqa: E731
    tv = lambda env: env["x"]                     # noqa: E731
    if kind == "add":
        return jf.AddLeaf("k", jv), tf.AddLeaf("k", tv)
    if kind == "min":
        return jf.MinLeaf("k", jv), tf.MinLeaf("k", tv)
    if kind == "max":
        return jf.MaxLeaf("k", jv), tf.MaxLeaf("k", tv)
    if kind == "drawdown":
        return jf.DrawdownLeaf("k", jv), tf.DrawdownLeaf("k", tv)
    if kind == "ew":
        return (jf.EWLeaf("k", jv, decay=2 / 3),
                tf.EWLeaf("k", tv, decay=2 / 3))
    if kind == "hist":
        jc = lambda env: jf.jax_one_hot(jnp.asarray(env["c"]), 8)  # noqa
        tc = lambda env: (env["c"][..., None]                       # noqa
                          == torch.arange(8)).to(torch.float32)
        return (jf.AddLeaf("k", jc, shape=(8,)),
                tf.AddLeaf("k", tc, shape=(8,)))
    raise ValueError(kind)


KINDS = ["add", "min", "max", "drawdown", "ew", "hist"]


def _env(n, seed, u=None, nan=True):
    rng = np.random.default_rng(seed)
    shape = (n,) if u is None else (u, n)
    x = rng.normal(3.0, 2.0, shape).astype(np.float32)
    if nan and x.size > 4:
        x.reshape(-1)[rng.integers(0, x.size, 2)] = np.nan
    c = rng.integers(0, 8, shape).astype(np.int32)
    valid = rng.random(shape) > 0.1
    return {"x": x, "c": c, "__valid__": valid}


def _j(env):
    return {k: jnp.asarray(v) for k, v in env.items()}


def _t(env):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in env.items()}


def _eq(got, want, kind="add"):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if kind == "ew":
        np.testing.assert_allclose(got, want, rtol=EW_RTOL, atol=EW_ATOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", LENGTHS)
def test_associative_scan_bitwise(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    x[rng.integers(0, n)] = np.nan
    for reverse in (False, True):
        want = jax.lax.associative_scan(jnp.add, jnp.asarray(x),
                                        reverse=reverse)
        got = tw.associative_scan(torch.add, torch.from_numpy(x),
                                  reverse=reverse)
        _eq(got, want)
    # along a later axis, batched
    xb = rng.normal(size=(2, n)).astype(np.float32)
    want = jax.lax.associative_scan(jnp.add, jnp.asarray(xb), axis=1)
    _eq(tw.associative_scan(torch.add, torch.from_numpy(xb), axis=1), want)
    # in segments, with a NaN, for every order-sensitive combine too
    flags = rng.random(n) < 0.2
    flags[0] = True
    for kind in ("add", "drawdown", "ew"):
        jl, tl = _leaves(kind)
        env = _env(n, n + 1)
        want = jw.segmented_inclusive_scan(jl, jl.lift(_j(env)),
                                           jnp.asarray(flags))
        got = tw.segmented_inclusive_scan(tl, tl.lift(_t(env)),
                                          torch.from_numpy(flags))
        _eq(got, want, kind)


def test_prefix_walk_is_the_scan_of_the_unit_fold():
    """The plain unit fold's ``_prefix_at`` and ``associative_scan`` both
    run ``prefix_walk``: every prefix of a packed level table equals the
    scan at that position."""
    rng = np.random.default_rng(5)
    rp = 64
    x = torch.from_numpy(rng.normal(size=(2, rp, 3)).astype(np.float32))
    proxy = uf_ref._StackLeaf(torch.add, torch.zeros(3))
    lvl = uf_ref._pack_levels(proxy, x)
    e = torch.arange(1, rp + 1, dtype=torch.int32).expand(2, 1, rp)
    got = uf_ref._prefix_at(proxy, lvl, uf_ref._level_offsets(rp), e, rp)
    want = tw.associative_scan(torch.add, x, axis=1)
    np.testing.assert_array_equal(got[:, 0].numpy(), want.numpy())


@pytest.mark.parametrize("n", [1, 2, 7, 64, 333])
def test_segments_and_search_match_reference(n):
    rng = np.random.default_rng(n)
    key = np.sort(rng.integers(0, 5, n)).astype(np.int32)
    ts = np.zeros(n, np.int32)
    for k in np.unique(key):
        sel = key == k
        ts[sel] = np.sort(rng.integers(-3_000, 3_000, sel.sum()))
    _eq(tw.segment_starts(torch.from_numpy(key)),
        jw.segment_starts(jnp.asarray(key)))
    _eq(tw._segment_end(torch.from_numpy(key)),
        jw._segment_end(jnp.asarray(key)))
    perm_t = tw.sorted_perm(torch.from_numpy(key[::-1].copy()),
                            torch.from_numpy(ts[::-1].copy()))
    _eq(perm_t, jw.sorted_perm(jnp.asarray(key[::-1].copy()),
                               jnp.asarray(ts[::-1].copy())))
    seg = np.array(jw.segment_starts(jnp.asarray(key)))
    targets = (ts - rng.integers(0, 2_000, n)).astype(np.int32)
    hi = np.arange(n, dtype=np.int32) + 1
    _eq(tw.first_geq(torch.from_numpy(ts), torch.from_numpy(targets),
                     torch.from_numpy(seg), torch.from_numpy(hi)),
        jw.first_geq(jnp.asarray(ts), jnp.asarray(targets),
                     jnp.asarray(seg), jnp.asarray(hi)))
    for spec in (jw.WindowSpec("w", "k", "ts", 1_000),
                 jw.WindowSpec("w", "k", "ts", 3, frame_rows=True),
                 jw.WindowSpec("w", "k", "ts", 2_000, maxsize=4,
                               instance_not_in_window=True)):
        tspec = tw.WindowSpec(**{f: getattr(spec, f) for f in
                                 spec.__dataclass_fields__})
        got = tw.window_bounds(tspec, torch.from_numpy(key),
                               torch.from_numpy(ts))
        want = jw.window_bounds(spec, jnp.asarray(key), jnp.asarray(ts))
        _eq(got[0], want[0])
        _eq(got[1], want[1])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 5, 16, 77])
def test_structures_match_reference(kind, n):
    """tree_fold, tree_levels/tree_query, sparse_levels/sparse_query
    (idempotent leaves), prefix_window_fold (invertible leaves),
    SegmentTree."""
    jl, tl = _leaves(kind)
    env = _env(n, 7 * n)
    jlift, tlift = jl.lift(_j(env)), tl.lift(_t(env))
    _eq(tw.tree_fold(tl, tlift), jw.tree_fold(jl, jlift), kind)
    rng = np.random.default_rng(n)
    start = rng.integers(0, n + 1, 40).astype(np.int32)
    end = np.minimum(start + rng.integers(0, n + 1, 40), n).astype(np.int32)
    s_t, e_t = torch.from_numpy(start), torch.from_numpy(end)
    s_j, e_j = jnp.asarray(start), jnp.asarray(end)
    got = tw.tree_query(tl, tw.tree_levels(tl, tlift), s_t, e_t)
    _eq(got, jw.tree_query(jl, jw.tree_levels(jl, jlift), s_j, e_j), kind)
    _eq(tw.SegmentTree(tl, tlift).query(s_t, e_t),
        jw.SegmentTree(jl, jlift).query(s_j, e_j), kind)
    if tl.idempotent:
        got = tw.sparse_query(tl, tw.sparse_levels(tl, tlift), s_t, e_t)
        _eq(got, jw.sparse_query(jl, jw.sparse_levels(jl, jlift), s_j, e_j))
    if tl.invertible:
        zeros = np.zeros_like(start)
        inc_t = tw.associative_scan(tl.combine, tlift)
        inc_j = jax.lax.associative_scan(jl.combine, jlift)
        _eq(inc_t, inc_j, kind)
        _eq(tw.prefix_window_fold(tl, inc_t, s_t, e_t,
                                  torch.from_numpy(zeros)),
            jw.prefix_window_fold(jl, inc_j, s_j, e_j, jnp.asarray(zeros)),
            kind)


@pytest.mark.parametrize("kind", KINDS)
def test_batched_units_equal_one_unit_at_a_time(kind):
    """Every structure over a (U, R) block gives each unit the bits it
    gets alone."""
    _, tl = _leaves(kind)
    u, r = 3, 37
    env = _t(_env(r, 11, u=u))
    lifted = tl.lift(env)
    rng = np.random.default_rng(3)
    start = torch.from_numpy(rng.integers(0, r, (u, 9)).astype(np.int32))
    end = torch.clamp(start + torch.from_numpy(
        rng.integers(0, r, (u, 9)).astype(np.int32)), max=r)
    built = {
        "tree": tw.tree_query(tl, tw.tree_levels(tl, lifted), start, end),
        "fold": tw.tree_fold(tl, lifted),
    }
    if tl.idempotent:
        built["sparse"] = tw.sparse_query(tl, tw.sparse_levels(tl, lifted),
                                          start, end)
    if tl.invertible:
        built["scan"] = tw.associative_scan(tl.combine, lifted,
                                            axis=lifted.dim() - 1
                                            - len(tl.shape))
    for i in range(u):
        one = {kk: v[i] for kk, v in env.items()}
        li = tl.lift(one)
        np.testing.assert_array_equal(
            built["tree"][i], tw.tree_query(tl, tw.tree_levels(tl, li),
                                            start[i], end[i]))
        np.testing.assert_array_equal(built["fold"][i], tw.tree_fold(tl, li))
        if "sparse" in built:
            np.testing.assert_array_equal(
                built["sparse"][i],
                tw.sparse_query(tl, tw.sparse_levels(tl, li), start[i],
                                end[i]))
        if "scan" in built:
            np.testing.assert_array_equal(
                built["scan"][i], tw.associative_scan(tl.combine, li))


def test_fold_windows_matches_reference():
    """The seed algorithm's whole-table fold: every aggregator of a
    script over a global sorted layout."""
    from repro.core.compiler import CompileContext as JCtx
    from repro.core.expr import AggCall as JCall
    from repro.core.expr import ColumnRef as JCol
    from repro_torch.core.compiler import CompileContext as TCtx
    from repro_torch.core.expr import AggCall as TCall
    from repro_torch.core.expr import ColumnRef as TCol

    rng = np.random.default_rng(9)
    n = 120
    key = np.sort(rng.integers(0, 4, n)).astype(np.int32)
    ts = np.concatenate([np.sort(rng.integers(0, 9_000, (key == k).sum()))
                         for k in range(4)]).astype(np.int32)
    x = rng.normal(3.0, 2.0, n).astype(np.float32)
    x[11] = np.nan
    fns = ["sum", "avg", "min", "max", "drawdown", "stddev"]
    jaggs = [jf.build_aggregator(JCall(f, (JCol("x"),), "w"), JCtx())
             for f in fns]
    taggs = [tf.build_aggregator(TCall(f, (TCol("x"),), "w"), TCtx())
             for f in fns]
    spec = jw.WindowSpec("w", "k", "ts", 2_000)
    tspec = tw.WindowSpec("w", "k", "ts", 2_000)
    jseg = jw.segment_starts(jnp.asarray(key))
    tseg = tw.segment_starts(torch.from_numpy(key))
    js, je = jw.window_bounds(spec, jnp.asarray(key), jnp.asarray(ts), jseg)
    ts_, te = tw.window_bounds(tspec, torch.from_numpy(key),
                               torch.from_numpy(ts), tseg)
    jflag = jnp.arange(n) == jseg
    tflag = torch.arange(n, dtype=torch.int32) == tseg
    want = jax.jit(lambda e: jw.fold_windows(jaggs, e, js, je, jseg, jflag))(
        {"x": jnp.asarray(x)})
    got = tw.fold_windows(taggs, {"x": torch.from_numpy(x)}, ts_, te, tseg,
                          tflag)
    for f, g, w in zip(fns, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)
