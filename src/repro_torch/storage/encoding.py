"""Compact in-memory row encoding (paper §7.1) + Spark-style comparison.

Layout (byte-exact reproduction of Figure 5):

    [ header 6B ][ null bitmap ceil(ncols/8)B ][ fixed fields ][ var offsets ][ var data ]

  * header: 1B field version, 1B schema version, 4B (uint32) total row size
  * bitmap: bit i set  <=>  column i is NULL (NULL values not stored)
  * fixed fields: basic types packed contiguously (int 4B, float 4B,
    double/bigint/timestamp 8B, bool 1B); compact offsets are computed
    once per schema (the paper's "more compact offset calculation")
  * var-length fields: per-string *end offset* only (no 32-bit length
    field); string i's length = offset_i - offset_{i-1}.  Offset width is
    the smallest of {1, 2, 4} bytes that can address the var section.

The module also reproduces the §7.1 memory-saving example (20 ints,
20 floats, 20 one-byte strings, 5 timestamps => 255B here vs 556B Spark).
Host code only (``struct``): the bytes equal the JAX package's codec
byte for byte (tests/test_torch_encoding.py).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List

from ..core.types import ColumnType, TableSchema

__all__ = ["CompactRowCodec", "SparkRowCodec", "row_size_compact",
           "row_size_spark"]

_FIXED_FMT = {
    ColumnType.INT: "<i",
    ColumnType.BIGINT: "<q",
    ColumnType.FLOAT: "<f",
    ColumnType.DOUBLE: "<d",
    ColumnType.TIMESTAMP: "<q",
    ColumnType.BOOL: "<b",
}

HEADER_BYTES = 6


def _offset_width(var_bytes_total: int, n_var: int) -> int:
    """Smallest offset width addressing the var section (paper: avoid a
    fixed 32-bit length per string)."""
    span = var_bytes_total + 1
    if span <= 0xFF:
        return 1
    if span <= 0xFFFF:
        return 2
    return 4


class CompactRowCodec:
    """Encode/decode rows of a schema into the §7.1 compact format."""

    def __init__(self, schema: TableSchema):
        self.schema = schema
        self.n_cols = len(schema.columns)
        self.bitmap_bytes = (self.n_cols + 7) // 8
        # compact fixed-field offsets, computed once per schema
        self.fixed_offsets: Dict[str, int] = {}
        off = 0
        for c in schema.fixed_columns:
            self.fixed_offsets[c.name] = off
            off += c.ctype.fixed_bytes
        self.fixed_bytes = off
        self.var_columns = schema.var_columns

    # -- encode -------------------------------------------------------------
    def encode(self, row: Dict[str, Any], field_version: int = 1,
               schema_version: int = 1) -> bytes:
        nulls = bytearray(self.bitmap_bytes)
        fixed = bytearray(self.fixed_bytes)
        var_payload = bytearray()
        var_ends: List[int] = []

        for i, c in enumerate(self.schema.columns):
            v = row.get(c.name)
            if v is None:
                nulls[i // 8] |= 1 << (i % 8)
                if c.ctype.is_var_length:
                    var_ends.append(len(var_payload))
                continue
            if c.ctype.is_var_length:
                data = v.encode() if isinstance(v, str) else bytes(v)
                var_payload.extend(data)
                var_ends.append(len(var_payload))
            else:
                off = self.fixed_offsets[c.name]
                struct.pack_into(_FIXED_FMT[c.ctype], fixed, off,
                                 _coerce(c.ctype, v))

        ow = _offset_width(len(var_payload), len(self.var_columns))
        offsets = bytearray()
        for end in var_ends:
            offsets.extend(end.to_bytes(ow, "little"))

        size = (HEADER_BYTES + self.bitmap_bytes + len(fixed) +
                len(offsets) + len(var_payload))
        header = struct.pack("<BBI", field_version & 0xFF,
                             schema_version & 0xFF, size)
        return bytes(header + nulls + fixed + offsets + var_payload)

    # -- decode -------------------------------------------------------------
    def decode(self, buf: bytes) -> Dict[str, Any]:
        fv, sv, size = struct.unpack_from("<BBI", buf, 0)
        assert size == len(buf), "row size mismatch"
        pos = HEADER_BYTES
        nulls = buf[pos: pos + self.bitmap_bytes]
        pos += self.bitmap_bytes
        fixed = buf[pos: pos + self.fixed_bytes]
        pos += self.fixed_bytes

        n_var = len(self.var_columns)
        # infer offset width from remaining length: offsets + payload.
        # The loop has no break, so the widest consistent width wins (the
        # reference codec's rule, kept so both decode the same bytes alike)
        remaining = len(buf) - pos
        ow = None
        for cand in (1, 2, 4):
            if n_var * cand <= remaining:
                payload_len = remaining - n_var * cand
                if _offset_width(payload_len, n_var) == cand:
                    ow = cand
        if ow is None:
            ow = 4
        ends = [int.from_bytes(buf[pos + i * ow: pos + (i + 1) * ow],
                               "little") for i in range(n_var)]
        var_base = pos + n_var * ow

        out: Dict[str, Any] = {}
        var_i = 0
        for i, c in enumerate(self.schema.columns):
            is_null = bool(nulls[i // 8] >> (i % 8) & 1)
            if c.ctype.is_var_length:
                if is_null:
                    out[c.name] = None
                else:
                    start = ends[var_i - 1] if var_i > 0 else 0
                    out[c.name] = buf[var_base + start:
                                      var_base + ends[var_i]].decode()
                var_i += 1
            else:
                if is_null:
                    out[c.name] = None
                else:
                    off = self.fixed_offsets[c.name]
                    (v,) = struct.unpack_from(_FIXED_FMT[c.ctype], fixed,
                                              off)
                    out[c.name] = v
        return out

    def row_size(self, row: Dict[str, Any]) -> int:
        return len(self.encode(row))


def _coerce(ctype: ColumnType, v):
    if ctype in (ColumnType.INT, ColumnType.BIGINT, ColumnType.TIMESTAMP):
        return int(v)
    if ctype in (ColumnType.FLOAT, ColumnType.DOUBLE):
        return float(v)
    if ctype is ColumnType.BOOL:
        return int(bool(v))
    return v


class SparkRowCodec:
    """Spark UnsafeRow-style sizing (the paper's comparison baseline):

    8-byte-aligned null-tracking word(s), 8 bytes per fixed field, strings
    8B-rounded data + 8B (offset,length) word.  We reproduce the paper's
    accounting: null set 16B for ~65 cols, every fixed field 8B, string of
    1 byte = 9B (8 data-aligned + 1 metadata... the paper counts 9),
    timestamps 8B.
    """

    def __init__(self, schema: TableSchema):
        self.schema = schema

    def row_size(self, row: Dict[str, Any]) -> int:
        n_cols = len(self.schema.columns)
        null_words = ((n_cols + 63) // 64) * 8
        size = null_words
        for c in self.schema.columns:
            if c.ctype.is_var_length:
                v = row.get(c.name) or ""
                data = v.encode() if isinstance(v, str) else bytes(v)
                size += 8 + len(data)  # 8B offset/len word + payload
            else:
                size += 8
        return size


def row_size_compact(schema: TableSchema, row: Dict[str, Any]) -> int:
    return CompactRowCodec(schema).row_size(row)


def row_size_spark(schema: TableSchema, row: Dict[str, Any]) -> int:
    return SparkRowCodec(schema).row_size(row)
