"""Port frontend parity: the torch package parses, plans and lowers a
script exactly as the JAX package does, generates the same tables from
one seed, and rejects malformed scripts at the same position."""

import numpy as np
import pytest

from repro.core import compile_script as jax_compile
from repro.core.sql import ParseError as JaxParseError
from repro.core.sql import parse as jax_parse
from repro.data.synthetic import make_action_tables as jax_tables
from repro_torch.core import compile_script as torch_compile
from repro_torch.core.sql import ParseError as TorchParseError
from repro_torch.core.sql import parse as torch_parse
from repro_torch.data.synthetic import make_action_tables as torch_tables

from torch_port_cases import ACTION_TABLES, SMOKE_SQL


@pytest.mark.parametrize("which", ["micro", "smoke"])
def test_plan_fingerprint_and_features_match(which, micro_sql):
    sql = micro_sql if which == "micro" else SMOKE_SQL
    tj, tt = jax_tables(**ACTION_TABLES), torch_tables(**ACTION_TABLES)
    cj = jax_compile(jax_parse(sql), tables=tj)
    ct = torch_compile(torch_parse(sql), tables=tt, fused_unit_fold=True)
    assert ct.fingerprint == cj.fingerprint
    assert ct.feature_names == cj.feature_names
    assert ct.describe_plan() == cj.describe_plan()
    assert ct.required_store_columns() == cj.required_store_columns()
    assert [w.sources for w in ct.windows] == [w.sources for w in cj.windows]
    assert [w.online_buffer for w in ct.windows] == \
        [w.online_buffer for w in cj.windows]
    for wj, wt in zip(cj.windows, ct.windows):
        assert [l.key for a in wt.aggs for l in a.leaves] == \
            [l.key for a in wj.aggs for l in a.leaves]


def test_synthetic_tables_identical():
    tj, tt = jax_tables(**ACTION_TABLES), torch_tables(**ACTION_TABLES)
    assert set(tj) == set(tt)
    for name in tj:
        assert tj[name].schema.column_names == tt[name].schema.column_names
        for c, v in tj[name].columns.items():
            np.testing.assert_array_equal(tt[name].columns[c], v)
            assert tt[name].columns[c].dtype == v.dtype


BAD_SQL = [
    """SELECT sum(price) OVER w AS s FROM t
    WINDOW w AS (PARTITION BY k ORDER BY ts
                 ROWS BETWEEN 10s PRECEDING AND CURRENT ROW)""",
    """SELECT sum(price) OVER w AS s FROM t
    WINDOW w AS (PARTITION BY k ORDER BY ts
                 ROWS_RANGE BETWEEN 10s AND CURRENT ROW)""",
    """SELECT sum(price) OVER w AS s FROM t
    WINDOW w AS (PARTITION BY k ORDER BY ts
                 ROWS_RANGE BETWEEN banana PRECEDING AND CURRENT ROW)""",
    """SELECT frobnicate(price) OVER w AS s FROM t
    WINDOW w AS (PARTITION BY k ORDER BY ts
                 ROWS_RANGE BETWEEN 10s PRECEDING AND CURRENT ROW)""",
    """SELECT sum(price) OVER w AS a, avg(price) OVER w AS b FROM t
    WINDOW w AS (PARTITION BY k ORDER BY ts
                 ROWS_RANGE BETWEEN 5s PRECEDING AND CURRENT ROW),
          w AS (PARTITION BY k ORDER BY ts
                ROWS_RANGE BETWEEN 9s PRECEDING AND CURRENT ROW)""",
    "SELECT price FROM t %%%",
    """SELECT price FROM t
    LAST JOIN p ON t.k < p.k""",
]


@pytest.mark.parametrize("sql", BAD_SQL, ids=[
    "rows-interval", "missing-preceding", "bad-bound", "unknown-agg",
    "duplicate-alias", "lex", "bad-join"])
def test_parse_errors_at_same_position(sql):
    with pytest.raises(JaxParseError) as ej:
        jax_parse(sql)
    with pytest.raises(TorchParseError) as et:
        torch_parse(sql)
    assert et.value.pos is not None
    assert et.value.pos == ej.value.pos
    assert str(et.value) == str(ej.value)


def test_compiler_int_min_matches_reference():
    from repro.core import compiler as JC
    from repro_torch.core import compiler as TC

    assert TC.INT_MIN == JC.INT_MIN == -(2**31) + 2
