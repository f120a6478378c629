"""Deploy-time certifier, port against reference, and against the port's
own dynamic gate.

For every configuration of the fold-engine sweep (``SWEEP``) and the
reference's targeted cases, the same SQL over the same seeded tables is
certified by both packages, and ``to_dict()`` is compared field by
field.  The stated differences, and nothing else, are applied to the
reference's certificate first:

* **store bytes**: the port's store holds an int64 ``comp`` sort key per
  slot beside the JAX package's int32 key, ts and value lanes, so each
  table's ``bytes`` (and ``store_bytes``, ``steady_state_bytes``) is the
  reference's plus ``COMP_BYTES`` x rows;
* **retrace**: the port compiles no executable per pad class, so each
  driver's ``max_executables`` (and ``max_executables_total``) counts the
  port's §4.2 cache misses and its ``note`` says so; the pre-agg ingest
  fold has no pad class (eager ops); a new table signature re-plans
  rather than retraces.

Then the port's certificate is held to the port's gate: a column
certified bitwise matches under ``verify_consistency(bitwise=True)``;
the retrace bound equals the cache misses observed at B = 1..16; the
memory bound equals the ``nbytes`` of a CPU engine's store and of
``PreAgg.init_state("cpu")``.
"""

import copy
import json

import numpy as np
import pytest

from repro.core import certify as jax_certify
from repro.core import compile_script as jax_compile
from repro.data.synthetic import make_action_tables as jax_tables
from repro_torch.core import (DeploymentCertificate, certify,
                              compile_script, verify_consistency)
from repro_torch.core.analysis import (classify_consistency,
                                       explain_sharding, memory_bound,
                                       retrace_bound)
from repro_torch.core.analysis.consistency_rules import preagg_exact_leaf
from repro_torch.core.analysis.memory import COMP_BYTES, preagg_plane_bytes
from repro_torch.core.analysis.retrace import (pow2_classes,
                                               sharded_pad_classes)
from repro_torch.core.compiler import cache_stats, clear_cache
from repro_torch.core.functions import HLLLeaf
from repro_torch.data.synthetic import make_action_tables as torch_tables
from repro_torch.serve.engine import FeatureEngine

from test_fold_engine import (PREAGG_SAFE_AGGS, RAW_AGGS, SWEEP,
                              _int_prices, _script)

PREAGG_SQL = """
SELECT sum(price) OVER w AS s, count(price) OVER w AS c,
       max(price) OVER w AS mx
FROM actions
WINDOW w AS (PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 3000s PRECEDING AND CURRENT ROW)
OPTIONS (long_windows = "w:100s")
"""

TWO_KEYS_SQL = """
SELECT sum(price) OVER wa AS s, count(price) OVER wb AS c FROM actions
WINDOW wa AS (PARTITION BY userid ORDER BY ts
              ROWS_RANGE BETWEEN 10s PRECEDING AND CURRENT ROW),
       wb AS (PARTITION BY category ORDER BY ts
              ROWS_RANGE BETWEEN 10s PRECEDING AND CURRENT ROW)
"""

# two window groups (w unions orders, w2 does not): two fold plans
RETRACE_RAW_SQL = """
SELECT sum(price) OVER w AS s, count(price) OVER w AS c,
       max(price) OVER w2 AS m2
FROM actions
WINDOW w AS (UNION orders PARTITION BY userid ORDER BY ts
             ROWS BETWEEN 9 PRECEDING AND CURRENT ROW),
       w2 AS (PARTITION BY userid ORDER BY ts
              ROWS_RANGE BETWEEN 5s PRECEDING AND CURRENT ROW)
"""

# a long window and a raw window of one group: served with the planes,
# the raw window alone is a second group, so a second fold plan
RETRACE_PREAGG_SQL = """
SELECT sum(price) OVER w AS s, min(price) OVER w2 AS m2
FROM actions
WINDOW w AS (PARTITION BY userid ORDER BY ts
             ROWS_RANGE BETWEEN 3000s PRECEDING AND CURRENT ROW),
       w2 AS (PARTITION BY userid ORDER BY ts
              ROWS_RANGE BETWEEN 5s PRECEDING AND CURRENT ROW)
OPTIONS (long_windows = "w:100s")
"""

BY_AGG = ["sum(price)", "avg(price)", "count(price)", "min(price)",
          "max(price)", "stddev(price)", "distinct_count(category)",
          "topn_frequency(category, 3)"]
NO_PROFILE = dict(with_profile=False)
HLL = dict(distinct_hll_p=4, distinct_hll_min_card=8)


def _sweep(seed, n_aggs, frame, union, join, preagg, n_shards, maxsize):
    rng = np.random.default_rng(seed)
    pool = PREAGG_SAFE_AGGS if preagg else RAW_AGGS
    aggs = list(rng.choice(pool, size=min(n_aggs, len(pool)),
                           replace=False))
    tkw = dict(n_actions=90, n_orders=60 if union else 0, n_users=4,
               horizon_ms=12_000_000 if preagg else 60_000,
               seed=100 + seed, with_profile=join)
    return dict(sql=_script(aggs, frame, union, join, preagg, maxsize),
                tables=tkw, int_prices=preagg, preagg=preagg,
                n_shards=n_shards)


# name -> sql, table kwargs (None: no tables), compile-context kwargs,
# certify kwargs, integer prices, gate mode
CASES = {f"sweep{c[0]}": _sweep(*c) for c in SWEEP}
CASES.update({
    "preagg-by-aggregate": dict(
        sql=_script(BY_AGG, "range", False, False, True),
        tables=dict(n_actions=90, n_orders=0, n_users=4,
                    horizon_ms=12_000_000, seed=3, **NO_PROFILE),
        preagg=True),
    "c-buf": dict(
        sql=_script(["sum(price)", "count(price)"], "range", False, False,
                    False),
        tables=dict(n_actions=150, n_orders=0, n_users=2, seed=5,
                    **NO_PROFILE),
        ctx=dict(online_buffer=8)),
    "no-tables": dict(
        sql=_script(["sum(price)"], "range", False, False, False),
        tables=None),
    "no-tables-capacity": dict(
        sql=_script(["sum(price)"], "range", False, False, False),
        tables=None, cert=dict(capacity=128)),
    "two-keys": dict(sql=TWO_KEYS_SQL, tables=None),
    "preagg-sql-float": dict(
        sql=PREAGG_SQL,
        tables=dict(n_actions=120, n_orders=0, n_users=4,
                    horizon_ms=12_000_000, seed=12, **NO_PROFILE),
        preagg=True),
    "preagg-hll": dict(
        sql=_script(["count(price)", "distinct_count(category)",
                     "max(price)"], "range", False, False, True),
        tables=dict(n_actions=90, n_orders=0, n_users=4,
                    horizon_ms=12_000_000, seed=4, **NO_PROFILE),
        ctx=HLL, int_prices=True, preagg=True),
})


def _pair(case):
    """The case compiled in both packages over the same seeded tables:
    (reference script, port script, reference tables, port tables)."""
    tkw = case["tables"]
    jt = tt = None
    if tkw is not None:
        jt, tt = jax_tables(**tkw), torch_tables(**tkw)
        if case.get("int_prices"):
            jt, tt = _int_prices(jt), _int_prices(tt)
    ctx = case.get("ctx", {})
    return (jax_compile(case["sql"], tables=jt, **ctx),
            compile_script(case["sql"], tables=tt, **ctx), jt, tt)


def _normalized(cert) -> dict:
    return json.loads(cert.to_json())


def expected_port_dict(ref: dict) -> dict:
    """The reference's certificate with the stated differences applied
    (module docstring); the retrace counts and notes are dropped from
    both sides by ``_without_counts``."""
    want = copy.deepcopy(ref)
    mem = want["memory"]
    extra = 0
    for entry in mem["store"].values():
        if entry["bytes"] is not None:
            entry["bytes"] += COMP_BYTES * entry["rows"]
            extra += COMP_BYTES * entry["rows"]
    if mem["store_bytes"] is not None:
        mem["store_bytes"] += extra
        mem["steady_state_bytes"] += extra
    want["retrace"]["drivers"]["preagg_update_many"]["pad_classes"] = []
    want["retrace"]["hazards"] = [h.replace("retraces", "re-plans")
                                  for h in want["retrace"]["hazards"]]
    return want


def _without_counts(d: dict) -> dict:
    d = copy.deepcopy(d)
    r = d["retrace"]
    r.pop("max_executables_total")
    for drv in r["drivers"].values():
        drv.pop("max_executables")
        drv.pop("note", None)
    return d


@pytest.fixture(scope="module", params=sorted(CASES))
def cert_pair(request):
    case = CASES[request.param]
    jcs, tcs, jt, tt = _pair(case)
    kw = case.get("cert", {})
    return (request.param, case, jcs, tcs, jt, tt,
            jax_certify(jcs, tables=jt, **kw), certify(tcs, tables=tt, **kw))


def test_certificate_matches_reference(cert_pair):
    """Field by field, after the stated differences."""
    name, _, _, tcs, _, _, jcert, tcert = cert_pair
    got = _normalized(tcert)
    want = expected_port_dict(_normalized(jcert))
    assert _without_counts(got) == _without_counts(want), name
    # every driver of the port says what it counts
    for drv, entry in got["retrace"]["drivers"].items():
        assert entry["note"] and isinstance(entry["max_executables"], int), \
            drv
    assert explain_sharding(tcs)["eligible"] == tcs.sharded_eligible()[0]


@pytest.mark.parametrize("name", sorted(
    n for n, c in CASES.items() if c["tables"] is not None))
def test_certificate_conservative_on_the_port(name):
    """Certified bitwise ==> the port's own gate matches bitwise; raw
    sweep cases over in-buffer histories certify every column."""
    case = CASES[name]
    _, tcs, _, tt = _pair(case)
    tcert = certify(tcs, tables=tt)
    mode = "preagg" if case.get("preagg") else "raw"
    rep = verify_consistency(tcs, tt, use_preagg=case.get("preagg", False),
                             n_shards=case.get("n_shards"), bitwise=True,
                             device="cpu")
    cols = tcert.consistency["columns"]
    for col, entry in cols.items():
        assert not (entry[mode] == "bitwise" and col in rep.mismatched), (
            name, col, entry["rules"])
    if name.startswith("sweep") and mode == "raw":
        assert tcert.consistency["raw_bitwise"], name
    if name == "preagg-sql-float":
        # the flag is load-bearing: the float pre-agg sum does degrade
        assert cols["s"]["preagg"] == "tolerance" and "s" in rep.mismatched


def test_targeted_classes():
    """The reference's targeted verdicts, on the port alone."""
    _, tcs, _, tt = _pair(CASES["preagg-by-aggregate"])
    cols = certify(tcs, tables=tt).consistency["columns"]
    for i, agg in enumerate(BY_AGG):
        kind = agg.split("(")[0]
        entry = cols[f"f{i}"]
        rules = {h["rule"] for h in entry["rules"]}
        if kind in ("count", "min", "max", "distinct_count",
                    "topn_frequency"):
            assert entry["preagg"] == "bitwise", (agg, rules)
        else:
            assert entry["preagg"] == "tolerance", agg
            assert "C-PREAGG-FLOAT" in rules, agg
        assert entry["raw"] == "bitwise", agg
    _, tcs, _, tt = _pair(CASES["c-buf"])
    entry = certify(tcs, tables=tt).consistency["columns"]["f0"]
    assert entry["raw"] == "tolerance"
    assert "C-BUF" in {h["rule"] for h in entry["rules"]}
    _, tcs, _, _ = _pair(CASES["no-tables"])
    out = classify_consistency(tcs)
    assert out["evidence"] == "none"
    assert out["columns"]["f0"]["raw"] == "tolerance"
    _, tcs, _, tt = _pair(CASES["preagg-hll"])
    cert = certify(tcs, tables=tt)
    (w,) = [w for w in tcs.windows if w.preagg is not None]
    hll = [lf for lf in w.preagg.leaves.values() if isinstance(lf, HLLLeaf)]
    assert hll and all(preagg_exact_leaf(lf) for lf in hll)
    dc = cert.consistency["columns"]["f1"]
    assert dc["approximate"] and "C-HLL" in {h["rule"] for h in dc["rules"]}


def test_certificate_roundtrip_and_queries():
    _, tcs, _, tt = _pair(CASES["sweep2"])
    cert = certify(tcs, tables=tt)
    assert isinstance(cert, DeploymentCertificate)
    d = json.loads(cert.to_json())
    assert set(d) == {"certificate", "fingerprint", "features",
                      "consistency", "retrace", "sharding", "memory",
                      "rules"}
    assert d["fingerprint"] == tcs.fingerprint
    assert d["features"] == list(tcs.feature_names)
    assert cert.bitwise_columns("raw") == list(tcs.feature_names)
    assert cert.column_class("f0", "raw") == "bitwise"
    text = cert.summary()
    assert "deployment certificate" in text and "fold plans" in text
    for entry in cert.consistency["columns"].values():
        for h in entry["rules"]:
            assert h["rule"] in d["rules"], h


def test_retrace_class_enumerators():
    assert pow2_classes(1) == [1]
    assert pow2_classes(9) == [1, 2, 4, 8, 16]
    assert sharded_pad_classes(32) == [1, 2, 4, 8, 16, 32]
    assert sharded_pad_classes(100) == [1, 2, 4, 8, 16, 32, 64, 96, 128]
    assert len(sharded_pad_classes(1024)) == 6 + 31


def _requests(eng, tables, n):
    a = tables["actions"]
    rows = [a.row(40 + i) for i in range(n)]
    need = eng._need[eng.cs.script.base_table]
    keys = [eng._encode("actions", eng.key_col, r[eng.key_col])
            for r in rows]
    ts = [int(r[eng.cs.script.order_column]) for r in rows]
    values = {c: [float(eng._encode("actions", c, r[c])) for r in rows]
              for c in need}
    return keys, ts, values


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
@pytest.mark.parametrize("which", ["raw", "preagg"])
def test_retrace_bound_equals_observed_misses(which, fused):
    """Drive online_batch at B = 1..16 (with and without the pre-agg
    planes), then offline() and online_batch_fast: the §4.2 cache misses
    each driver adds equal the certificate's counts, no more and no
    fewer."""
    if which == "raw":
        sql, tkw = RETRACE_RAW_SQL, dict(n_actions=90, n_orders=60,
                                         n_users=4, seed=8, **NO_PROFILE)
    else:
        sql, tkw = RETRACE_PREAGG_SQL, dict(
            n_actions=90, n_orders=0, n_users=4, horizon_ms=12_000_000,
            seed=8, **NO_PROFILE)
    tables = torch_tables(**tkw)
    eng = FeatureEngine(sql, tables, capacity=512, fused_fold=fused,
                        use_preagg=which == "preagg", device="cpu")
    a = tables["actions"]
    eng.bulk_load("actions", a)
    if "orders" in eng._need:
        eng.bulk_load("orders", tables["orders"])
    drivers = certify(eng.cs, tables=tables, max_batch=16).retrace["drivers"]
    assert drivers["online_batch"]["pad_classes"] == pow2_classes(16)
    keys, ts, values = _requests(eng, tables, 16)
    clear_cache()
    for b in range(1, 17):
        out = eng.cs.online_batch(eng.store, keys[:b], ts[:b],
                                  {c: v[:b] for c, v in values.items()},
                                  preagg_states=eng.pre_states)
        assert all(v.shape[0] == b for v in out.values())
        eng.cs.online_batch(eng.store, keys[:b], ts[:b],
                            {c: v[:b] for c, v in values.items()})
    assert cache_stats()["misses"] == drivers["online_batch"][
        "max_executables"]
    for driver, run in (
            ("offline", lambda: eng.cs.offline(tables, device="cpu")),
            ("online_batch_fast",
             lambda: eng.cs.online_batch_fast(eng.store, keys, ts, values))):
        misses = cache_stats()["misses"]
        run()
        assert cache_stats()["misses"] - misses <= drivers[driver][
            "max_executables"], driver
    # a plan one driver built is a hit for the next: the total is tight
    assert cache_stats()["misses"] == certify(
        eng.cs, tables=tables, max_batch=16).retrace["max_executables_total"]
    if not fused:
        assert drivers["online_batch"]["max_executables"] == 0


def test_retrace_offline_classes_with_plan():
    _, tcs, _, tt = _pair(CASES["sweep2"])
    off = certify(tcs, tables=tt).retrace["drivers"]["offline"]
    assert off["unit_width_classes"] and off["max_executables"] == 1
    clear_cache()
    tcs.offline(tt, device="cpu")
    assert cache_stats()["misses"] == 1
    r2 = retrace_bound(compile_script(CASES["sweep2"]["sql"]))
    assert r2["drivers"]["offline"]["unit_width_classes"] is None
    assert not r2["bounded"]
    assert any("unit width classes unknown" in h for h in r2["hazards"])


@pytest.mark.parametrize("case", ["preagg-sql-float", "preagg-hll"])
def test_preagg_plane_bytes_exact(case):
    """The static plane bound equals the nbytes of the planes
    ``init_state`` builds (the HLL leaf's identity dtype read, not
    assumed)."""
    _, tcs, _, _ = _pair(CASES[case])
    (w,) = [w for w in tcs.windows if w.preagg is not None]
    state = w.preagg.init_state("cpu")
    actual = sum(t.nbytes for grp in ("fine", "coarse")
                 for t in state[grp].values())
    actual += state["fine_epoch"].nbytes + state["coarse_epoch"].nbytes
    assert preagg_plane_bytes(w.preagg) == actual == w.preagg.plane_bytes(
        state)
    assert memory_bound(tcs)["preagg_bytes"] == actual


@pytest.mark.parametrize("case", ["sweep0", "sweep1", "preagg-sql-float"])
def test_memory_bound_equals_store_nbytes(case):
    """The store term counts the port's resident layout: every tensor of
    a CPU engine's store (int32 keys and ts, one lane per value column,
    the int64 ``comp``, the 0-d ``count``)."""
    c = CASES[case]
    tables = torch_tables(**c["tables"])
    eng = FeatureEngine(c["sql"], tables, capacity=1000,
                        use_preagg=c.get("preagg", False), fused_fold=True,
                        device="cpu")
    actual = sum(t.nbytes for st in eng.store.tables.values()
                 for t in (st["keys"], st["ts"], st["count"], st["comp"],
                           *st["cols"].values()))
    m = memory_bound(eng.cs, capacity=1000)
    assert m["store_bytes"] == actual
    for tname, st in eng.store.tables.items():
        assert m["store"][tname]["value_columns"] == len(st["cols"])
    if eng.pre_states:
        assert m["preagg_bytes"] == sum(
            w.preagg.plane_bytes(eng.pre_states[wi])
            for wi, w in enumerate(eng.cs.windows) if w.preagg is not None)
    assert memory_bound(eng.cs, tables=None, capacity=1000)[
        "paper_model_bytes"] > 0
    assert memory_bound(compile_script(c["sql"]))["steady_state_bytes"] \
        is None
