"""Schema / table types for the feature-computation core.

Tables are structure-of-arrays (columnar) — the device-friendly "compact format"
(DESIGN.md §3).  Strings are dictionary-encoded at ingestion into int32
codes; the per-column vocabulary lives host-side in the schema.  Timestamps
are int64-in-int32-range milliseconds (device columns stay 32-bit; synthetic and
benchmark data stay within int32 ms offsets from a base epoch).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ColumnType",
    "Column",
    "TableSchema",
    "Table",
    "Dictionary",
]


class ColumnType(enum.Enum):
    """Logical column types (mirrors OpenMLDB's basic/var-length split)."""

    INT = "int"            # int32
    BIGINT = "bigint"      # stored int64 host-side, int32 on device
    FLOAT = "float"        # float32
    DOUBLE = "double"      # float32 on device (f64 is host-only)
    TIMESTAMP = "timestamp"  # int32 milliseconds (device) / int64 (host)
    STRING = "string"      # dictionary-encoded int32 code
    BOOL = "bool"          # bool_

    @property
    def is_var_length(self) -> bool:
        return self is ColumnType.STRING

    @property
    def fixed_bytes(self) -> int:
        """On-the-wire fixed-field width for the compact row codec (§7.1)."""
        return {
            ColumnType.INT: 4,
            ColumnType.BIGINT: 8,
            ColumnType.FLOAT: 4,
            ColumnType.DOUBLE: 8,
            ColumnType.TIMESTAMP: 8,
            ColumnType.BOOL: 1,
            ColumnType.STRING: 0,  # offsets only; data lives in var section
        }[self]

    @property
    def np_dtype(self) -> np.dtype:
        return {
            ColumnType.INT: np.dtype(np.int32),
            ColumnType.BIGINT: np.dtype(np.int64),
            ColumnType.FLOAT: np.dtype(np.float32),
            ColumnType.DOUBLE: np.dtype(np.float64),
            ColumnType.TIMESTAMP: np.dtype(np.int64),
            ColumnType.STRING: np.dtype(np.int32),
            ColumnType.BOOL: np.dtype(np.bool_),
        }[self]

    @property
    def device_dtype(self) -> np.dtype:
        """dtype used on-device (x64 disabled -> 32-bit everywhere)."""
        return {
            ColumnType.INT: np.dtype(np.int32),
            ColumnType.BIGINT: np.dtype(np.int32),
            ColumnType.FLOAT: np.dtype(np.float32),
            ColumnType.DOUBLE: np.dtype(np.float32),
            ColumnType.TIMESTAMP: np.dtype(np.int32),
            ColumnType.STRING: np.dtype(np.int32),
            ColumnType.BOOL: np.dtype(np.bool_),
        }[self]


@dataclasses.dataclass(frozen=True)
class Column:
    name: str
    ctype: ColumnType
    nullable: bool = True


class Dictionary:
    """Per-column string dictionary (host side).

    Bounded-cardinality dictionary encoding is what makes the paper's
    "exact-scan" functions (topN_frequency / distinct_count /
    avg_cate_where) bounded-state monoids — see functions.py.
    """

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._code: Dict[str, int] = {}
        self._items: List[str] = []

    def encode(self, s: str) -> int:
        code = self._code.get(s)
        if code is None:
            if len(self._items) >= self.capacity:
                raise ValueError(
                    f"dictionary overflow (capacity={self.capacity}); "
                    "raise capacity or hash-bucket the column"
                )
            code = len(self._items)
            self._code[s] = code
            self._items.append(s)
        return code

    def decode(self, code: int) -> str:
        return self._items[code]

    def encode_many(self, xs: Sequence[str]) -> np.ndarray:
        return np.asarray([self.encode(x) for x in xs], dtype=np.int32)

    def __len__(self) -> int:
        return len(self._items)


@dataclasses.dataclass(frozen=True)
class TableSchema:
    name: str
    columns: Tuple[Column, ...]

    def __post_init__(self):
        names = [c.name for c in self.columns]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names in table {self.name}")

    @property
    def column_names(self) -> Tuple[str, ...]:
        return tuple(c.name for c in self.columns)

    def column(self, name: str) -> Column:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(f"{self.name} has no column {name!r}")

    def index_of(self, name: str) -> int:
        for i, c in enumerate(self.columns):
            if c.name == name:
                return i
        raise KeyError(name)

    @property
    def fixed_columns(self) -> Tuple[Column, ...]:
        return tuple(c for c in self.columns if not c.ctype.is_var_length)

    @property
    def var_columns(self) -> Tuple[Column, ...]:
        return tuple(c for c in self.columns if c.ctype.is_var_length)


class Table:
    """Columnar table: dict of 1-D numpy arrays + schema + dictionaries.

    All columns share length ``n_rows``.  ``dicts`` maps string column name
    -> Dictionary.  Null-ness is a per-column boolean mask (True = NULL),
    mirroring the codec's bitmap.
    """

    def __init__(
        self,
        schema: TableSchema,
        columns: Mapping[str, np.ndarray],
        dicts: Optional[Mapping[str, Dictionary]] = None,
        nulls: Optional[Mapping[str, np.ndarray]] = None,
    ):
        self.schema = schema
        self.columns: Dict[str, np.ndarray] = {}
        n = None
        for c in schema.columns:
            arr = np.asarray(columns[c.name])
            if n is None:
                n = arr.shape[0]
            elif arr.shape[0] != n:
                raise ValueError(f"column {c.name} length mismatch")
            self.columns[c.name] = arr.astype(c.ctype.np_dtype)
        self.n_rows = int(n or 0)
        self.dicts: Dict[str, Dictionary] = dict(dicts or {})
        self.nulls: Dict[str, np.ndarray] = {
            k: np.asarray(v, dtype=bool) for k, v in (nulls or {}).items()
        }

    @classmethod
    def from_rows(
        cls,
        schema: TableSchema,
        rows: Sequence[Mapping[str, Any]],
        dicts: Optional[Mapping[str, Dictionary]] = None,
    ) -> "Table":
        dicts = dict(dicts or {})
        cols: Dict[str, list] = {c.name: [] for c in schema.columns}
        nulls: Dict[str, list] = {c.name: [] for c in schema.columns}
        for row in rows:
            for c in schema.columns:
                v = row.get(c.name)
                is_null = v is None
                nulls[c.name].append(is_null)
                if c.ctype is ColumnType.STRING:
                    d = dicts.setdefault(c.name, Dictionary())
                    cols[c.name].append(0 if is_null else d.encode(str(v)))
                else:
                    cols[c.name].append(
                        c.ctype.np_dtype.type(0) if is_null else v
                    )
        columns = {
            c.name: np.asarray(cols[c.name], dtype=c.ctype.np_dtype)
            for c in schema.columns
        }
        null_masks = {
            k: np.asarray(v, dtype=bool)
            for k, v in nulls.items()
            if any(v)
        }
        return cls(schema, columns, dicts, null_masks)

    def device_columns(self) -> Dict[str, np.ndarray]:
        """Columns cast to their device dtypes (32-bit)."""
        out = {}
        for c in self.schema.columns:
            out[c.name] = self.columns[c.name].astype(c.ctype.device_dtype)
        return out

    def null_mask(self, name: str) -> np.ndarray:
        m = self.nulls.get(name)
        if m is None:
            return np.zeros(self.n_rows, dtype=bool)
        return m

    def row(self, i: int) -> Dict[str, Any]:
        return {c.name: self.columns[c.name][i] for c in self.schema.columns}

    def head(self, k: int = 5) -> List[Dict[str, Any]]:
        return [self.row(i) for i in range(min(k, self.n_rows))]

    def __len__(self) -> int:
        return self.n_rows

    def __repr__(self) -> str:
        return f"Table({self.schema.name!r}, rows={self.n_rows}, cols={list(self.columns)})"
