"""Deterministic synthetic event streams (the paper's MicroBench shape:
time-series stream tables with shared keys + a reference table, plus a
TalkingData-like click log for the memory benchmark)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.types import Column, ColumnType, Dictionary, Table, TableSchema

__all__ = ["ACTIONS_SCHEMA", "ORDERS_SCHEMA", "PROFILE_SCHEMA",
           "make_action_tables", "make_clicks_table", "zipf_keys"]

ACTIONS_SCHEMA = TableSchema("actions", (
    Column("userid", ColumnType.INT),
    Column("ts", ColumnType.TIMESTAMP),
    Column("price", ColumnType.FLOAT),
    Column("quantity", ColumnType.INT),
    Column("category", ColumnType.STRING),
))

ORDERS_SCHEMA = TableSchema("orders", tuple(ACTIONS_SCHEMA.columns))

PROFILE_SCHEMA = TableSchema("profile", (
    Column("userid", ColumnType.INT),
    Column("ts", ColumnType.TIMESTAMP),
    Column("age", ColumnType.FLOAT),
    Column("score", ColumnType.FLOAT),
))

_CATS = ["shoes", "hats", "bags", "tops", "toys", "food", "books",
         "phones"]


def zipf_keys(n: int, n_keys: int, alpha: float, rng) -> np.ndarray:
    """Zipf-distributed keys (the skew knob for §6.2 / §5.2 benches)."""
    if alpha <= 0:
        return rng.integers(0, n_keys, n).astype(np.int32)
    ranks = np.arange(1, n_keys + 1, dtype=np.float64)
    p = ranks ** -alpha
    p /= p.sum()
    return rng.choice(n_keys, size=n, p=p).astype(np.int32)


def make_action_tables(n_actions: int = 2000, n_orders: int = 1000,
                       n_users: int = 16, horizon_ms: int = 10_000_000,
                       zipf_alpha: float = 0.0, seed: int = 0,
                       with_profile: bool = True
                       ) -> Dict[str, Table]:
    """Actions/Orders (+Profile) with unique global timestamps
    (consistency replay stays unambiguous — see core/consistency.py)."""
    rng = np.random.default_rng(seed)
    n = n_actions + n_orders
    ts = np.sort(rng.choice(
        np.arange(1, horizon_ms, 7), size=n, replace=False))
    users = zipf_keys(n, n_users, zipf_alpha, rng)

    shared_dict = Dictionary()
    shared_dict.encode_many(_CATS)      # codes 0..len(_CATS)-1

    # fully vectorized construction (from_rows is per-row Python; at
    # benchmark sizes — hundreds of thousands of rows — that dominates)
    price = rng.uniform(1, 100, n).astype(np.float32)
    quantity = rng.integers(0, 5, n).astype(np.int32)
    category = rng.integers(0, len(_CATS), n).astype(np.int32)

    idx = rng.permutation(n)
    a_idx, o_idx = np.sort(idx[:n_actions]), np.sort(idx[n_actions:])

    def build(schema, sl):
        cols = {"userid": users[sl], "ts": ts[sl].astype(np.int64),
                "price": price[sl], "quantity": quantity[sl],
                "category": category[sl]}
        return Table(schema, cols, dicts={"category": shared_dict})

    out = {"actions": build(ACTIONS_SCHEMA, a_idx),
           "orders": build(ORDERS_SCHEMA, o_idx)}
    if with_profile:
        prows = [dict(userid=u, ts=int(rng.integers(1, horizon_ms // 2)),
                      age=float(18 + u % 50), score=float(u) * 1.5)
                 for u in range(n_users) for _ in range(2)]
        out["profile"] = Table.from_rows(PROFILE_SCHEMA, prows)
    return out


CLICKS_SCHEMA = TableSchema("clicks", (
    Column("ip", ColumnType.INT),
    Column("ts", ColumnType.TIMESTAMP),
    Column("app", ColumnType.INT),
    Column("device", ColumnType.INT),
    Column("os", ColumnType.INT),
    Column("channel", ColumnType.INT),
    Column("is_attributed", ColumnType.BOOL),
))


def make_clicks_table(n: int = 100_000, n_ips: int = 5000,
                      seed: int = 0) -> Table:
    """TalkingData-shaped click log (ip-keyed, heavy key reuse)."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(1, 4 * 86_400_000, n))
    cols = {
        "ip": zipf_keys(n, n_ips, 1.1, rng),
        "ts": ts.astype(np.int64),
        "app": rng.integers(0, 500, n).astype(np.int32),
        "device": rng.integers(0, 100, n).astype(np.int32),
        "os": rng.integers(0, 50, n).astype(np.int32),
        "channel": rng.integers(0, 200, n).astype(np.int32),
        "is_attributed": (rng.random(n) < 0.002),
    }
    return Table(CLICKS_SCHEMA, cols)
