"""Online Preview Mode (§3.2 mode (2)), port against reference: the same
scripts over the same seeded tables through both packages' ``preview``.
``n_rows``, ``truncated``, ``violations`` and ``cache_hit`` are equal
exactly; the features bitwise, except ``ew`` at ``EW_RTOL`` / ``EW_ATOL``
and HLL estimates at ``HLL_RTOL`` (the bars of
``tests/test_torch_offline.py``).  Both caches key on the script, the
row budget and the slices' row counts, not their content; the last test
shows that quirk in both packages.
"""

import numpy as np
import pytest

from repro.core import clear_cache as jax_clear_cache
from repro.core import compile_script as jax_compile
from repro.core import preview as jax_preview_mod
from repro.data.synthetic import make_action_tables as jax_tables
from repro_torch.core import compile_script, preview as preview_mod
from repro_torch.core.preview import PreviewLimits, preview
from repro_torch.data.synthetic import make_action_tables as torch_tables

from conftest import MICRO_SQL
from torch_port_cases import ACTION_TABLES, EW_ATOL, EW_RTOL, HLL, SMOKE_SQL

HLL_RTOL = 1e-6
SCRIPTS = {"micro": (MICRO_SQL, {}), "micro-hll": (MICRO_SQL, HLL),
           "smoke": (SMOKE_SQL, {})}
SUM_SQL = """
SELECT sum(price) OVER w AS s FROM actions
WINDOW w AS (PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 5s PRECEDING AND CURRENT ROW)
"""


@pytest.fixture(autouse=True)
def empty_caches():
    """Each test starts from empty preview caches in both packages (the
    caches live for the process, and a worker runs many tests)."""
    jax_preview_mod._PREVIEW_CACHE.clear()
    preview_mod._PREVIEW_CACHE.clear()


def assert_results_equal(got, want, hll=()):
    assert (got.n_rows, got.truncated, got.violations, got.cache_hit) == (
        want.n_rows, want.truncated, want.violations, want.cache_hit)
    assert sorted(got.features) == sorted(want.features)
    for k, w in want.features.items():
        a, b = np.asarray(w), np.asarray(got.features[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k.startswith("ew"):
            np.testing.assert_allclose(b, a, rtol=EW_RTOL, atol=EW_ATOL,
                                       err_msg=k)
        elif k in hll:
            np.testing.assert_allclose(b, a, rtol=HLL_RTOL, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_preview_bounded_and_cached(script):
    sql, ctx = SCRIPTS[script]
    jt, tt = jax_tables(**ACTION_TABLES), torch_tables(**ACTION_TABLES)
    jax_clear_cache()      # the reference's plan cache ignores HLL options
    jcs = jax_compile(sql, tables=jt, **ctx)
    tcs = compile_script(sql, tables=tt, **ctx)
    limits = PreviewLimits(max_rows_per_table=100)
    hll = ("n_cat",) if ctx else ()
    for hit in (False, True):
        want = jax_preview_mod.preview(jcs, jt, limits=limits)
        got = preview(tcs, tt, limits=limits, device="cpu")
        assert got.ok and got.truncated and got.n_rows == 100
        assert got.cache_hit is hit
        assert_results_equal(got, want, hll)


def test_preview_equals_production_on_same_slice():
    """A script that passes preview gives production-identical features
    (same CompiledScript) — the deploy-safety property."""
    jt, tt = jax_tables(**ACTION_TABLES), torch_tables(**ACTION_TABLES)
    limits = PreviewLimits(max_rows_per_table=10**9)  # no truncation
    got = preview(SUM_SQL, tt, limits=limits, use_cache=False, device="cpu")
    prod = compile_script(SUM_SQL, tables=tt).offline(tt, device="cpu")
    np.testing.assert_array_equal(got.features["s"], prod["s"])
    assert_results_equal(got, jax_preview_mod.preview(
        SUM_SQL, jt, limits=limits, use_cache=False))


def test_preview_rejects_over_complex_scripts():
    items = ", ".join(f"sum(price) OVER w{i} AS f{i}" for i in range(10))
    wins = ", ".join(
        f"w{i} AS (PARTITION BY userid ORDER BY ts ROWS_RANGE BETWEEN "
        f"{i + 1}s PRECEDING AND CURRENT ROW)" for i in range(10))
    sql = f"SELECT {items} FROM actions WINDOW {wins}"
    jt, tt = jax_tables(**ACTION_TABLES), torch_tables(**ACTION_TABLES)
    limits = PreviewLimits(max_windows=4)
    got = preview(sql, tt, limits=limits, device="cpu")
    assert not got.ok and any("windows" in v for v in got.violations)
    assert_results_equal(got, jax_preview_mod.preview(sql, jt,
                                                      limits=limits))


def test_cache_key_ignores_slice_content_in_both_packages():
    """Two table sets with the same row counts and other rows: the second
    preview is a cache hit that returns the first call's features, in
    the reference and in the port alike; without the cache it differs."""
    other = dict(ACTION_TABLES, seed=ACTION_TABLES["seed"] + 1)
    limits = PreviewLimits(max_rows_per_table=100)
    out = {}
    for pkg, make, run in (
            ("jax", jax_tables, jax_preview_mod.preview),
            ("torch", torch_tables,
             lambda *a, **k: preview(*a, device="cpu", **k))):
        first = run(SUM_SQL, make(**ACTION_TABLES), limits=limits)
        second = run(SUM_SQL, make(**other), limits=limits)
        fresh = run(SUM_SQL, make(**other), limits=limits, use_cache=False)
        assert not first.cache_hit and second.cache_hit, pkg
        np.testing.assert_array_equal(second.features["s"],
                                      first.features["s"])
        assert not np.array_equal(fresh.features["s"], first.features["s"])
        out[pkg] = (first, second, fresh)
    for got, want in zip(out["torch"], out["jax"]):
        assert_results_equal(got, want)
