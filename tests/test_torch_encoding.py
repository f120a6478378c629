"""Compact row format (§7.1), port against reference: the same rows,
made from a seed with numpy, through both packages' codecs.  Encoded
bytes are equal byte for byte (tolerance: none), over every column type,
NULLs, and strings whose lengths sit at the edges of each offset width
(1-byte offsets up to a 254-byte var section, 2-byte up to 65,534,
4-byte past it); each package decodes the other's bytes to the same row.
"""

import numpy as np
import pytest

from repro.core.types import Column as JColumn
from repro.core.types import ColumnType as JType
from repro.core.types import TableSchema as JSchema
from repro.storage.encoding import CompactRowCodec as JCompact
from repro.storage.encoding import SparkRowCodec as JSpark
from repro_torch.core.types import Column, ColumnType, TableSchema
from repro_torch.storage import (CompactRowCodec, SparkRowCodec,
                                 row_size_compact, row_size_spark)

TYPES = ("int", "bigint", "float", "double", "timestamp", "bool",
         "string")
# a var section of n bytes + 1 needs 1 byte of offset up to 255, 2 up to
# 65,535, else 4
EDGE_LENGTHS = (0, 1, 254, 255, 65_534, 65_535)
ALPHABET = list("abcxyz019 _-") + ["é", "ü", "→"]


def schemas(spec):
    """(port schema, reference schema) of ``spec``: (name, type) pairs."""
    return (TableSchema("t", tuple(Column(n, ColumnType(t))
                                   for n, t in spec)),
            JSchema("t", tuple(JColumn(n, JType(t)) for n, t in spec)))


def seeded_rows(spec, n, seed, null_p=0.2):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        row = {}
        for name, t in spec:
            if rng.random() < null_p:
                row[name] = None
            elif t == "int":
                row[name] = int(rng.integers(-2**31, 2**31))
            elif t in ("bigint", "timestamp"):
                row[name] = int(rng.integers(-2**62, 2**62))
            elif t in ("float", "double"):
                row[name] = float(rng.normal(0, 1e3))
            elif t == "bool":
                row[name] = bool(rng.integers(0, 2))
            else:
                k = int(rng.integers(0, 40))
                row[name] = "".join(rng.choice(ALPHABET, k))
        rows.append(row)
    return rows


MIXED = [(f"c{i}_{t}", t) for i, t in enumerate(TYPES + TYPES[::-1])]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_bytes_equal_reference(seed):
    ts, js = schemas(MIXED)
    tc, jc = CompactRowCodec(ts), JCompact(js)
    for row in seeded_rows(MIXED, 200, seed):
        buf = tc.encode(row, field_version=seed, schema_version=seed + 7)
        assert buf == jc.encode(row, field_version=seed,
                                schema_version=seed + 7)
        back = tc.decode(buf)
        assert back == jc.decode(buf)
        for k, v in row.items():
            if v is None or not isinstance(v, float):
                assert back[k] == (int(v) if isinstance(v, bool) else v), k
            else:
                np.testing.assert_allclose(back[k], v, rtol=1e-6)
        assert tc.row_size(row) == jc.row_size(row) == len(buf)


@pytest.mark.parametrize("n_var", [1, 2])
@pytest.mark.parametrize("length", EDGE_LENGTHS)
def test_offset_width_edges(length, n_var):
    """Each offset width and its edges, NULL strings among them; decode
    infers the width from the buffer's length as the reference does."""
    spec = [("k", "int")] + [(f"s{i}", "string") for i in range(n_var)] \
        + [("t", "timestamp")]
    ts, js = schemas(spec)
    tc, jc = CompactRowCodec(ts), JCompact(js)
    body = "x" * length
    rows = [{"k": 7, "s0": body, "s1": "", "t": 123},
            {"k": None, "s0": body, "s1": None, "t": None},
            {"k": 1, "s0": None, "s1": body, "t": 5}]
    for row in rows:
        row = {k: v for k, v in row.items() if k in dict(spec)}
        buf = tc.encode(row)
        assert buf == jc.encode(row)
        var = sum(len(row[c] or "") for c, t in spec if t == "string")
        width = 1 if var + 1 <= 0xFF else 2 if var + 1 <= 0xFFFF else 4
        fixed = 4 + 8
        assert len(buf) == 6 + 1 + fixed + n_var * width + var
        assert tc.decode(buf) == jc.decode(buf) == row


def test_paper_memory_example_exact():
    """§7.1 worked example: 255 bytes against Spark's 556."""
    spec = ([(f"i{i}", "int") for i in range(20)]
            + [(f"f{i}", "float") for i in range(20)]
            + [(f"s{i}", "string") for i in range(20)]
            + [(f"t{i}", "timestamp") for i in range(5)])
    row = {}
    for i in range(20):
        row[f"i{i}"], row[f"f{i}"], row[f"s{i}"] = i, float(i), "x"
    for i in range(5):
        row[f"t{i}"] = 1_000_000 + i
    ts, js = schemas(spec)
    assert row_size_compact(ts, row) == 255
    assert row_size_spark(ts, row) == 556
    assert CompactRowCodec(ts).encode(row) == JCompact(js).encode(row)


@pytest.mark.parametrize("seed", [3, 4])
def test_spark_sizes_equal_reference(seed):
    ts, js = schemas(MIXED)
    for row in seeded_rows(MIXED, 100, seed, null_p=0.3):
        assert SparkRowCodec(ts).row_size(row) == JSpark(js).row_size(row)
