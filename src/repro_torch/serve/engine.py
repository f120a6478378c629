"""Online serving engine on the card.

``FeatureEngine`` is the paper's online request mode as a service: a
deployed feature script + live store + pre-aggregation states behind
``request()`` / ``request_batch()``, with §8.2 memory guarding.  The
store lives on ``device`` (the card by default; ``device="cpu"`` runs
the plain versions of the kernels).  ``fused_fold=True`` folds every
window group through one unit-fold kernel launch per batch;
``fused_fold=False`` (the reference's default) folds through the staged
per-leaf build/query in plain torch, with the same bits.  ``discrete()``
runs the feature-hash kernel either way.  With ``use_preagg`` every long
window (``OPTIONS(long_windows=...)``) keeps §5.1 bucket planes, folded
on every ingest and bulk load, and requests read them
(``CompiledScript.online_batch``); a fused engine without pre-agg serves
through ``online_batch_fast``.

``offline()`` materializes the script's training features over the
tables, on the engine's device, through the same unit fold.
``submit_request()`` enqueues a request into a ``RequestBatcher`` and
``flush()`` drains the queue through the batched path.  ``latencies_ms``
holds real request completion samples only: every request of a batch
completed when its batch call returned (the call ends by copying the
features to the host, which waits for the card).

Options that are not ported yet raise ``NotImplementedError`` naming the
option: sharding, replication, checkpoints and retention / TTL
eviction.

``ServingEngine`` wraps a model's prefill/decode for batched requests —
the "online ML" consumer of the features (dense and hybrid families): the
SSM prefill runs the linear-scan kernel, every decode step the
flash-decode kernel in every layer.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.compiler import CompiledScript, compile_script
from ..core.types import Table
from ..kernels.dispatch import resolve_device
from ..models.model import decode_step, forward_prefill, init_decode_state
from ..storage.memest import MemoryGuard
from ..storage.timestore import OnlineStore
from .batcher import RequestBatcher

__all__ = ["FeatureEngine", "ServingEngine"]


def _not_ported(name: str):
    raise NotImplementedError(f"FeatureEngine option {name!r} is not "
                              f"ported to repro_torch yet")


class FeatureEngine:
    """Deployed feature script + online store (paper Figure 3, right)."""

    def __init__(self, script_sql: str, tables: Dict[str, Table],
                 capacity: int = 4096, use_preagg: bool = False,
                 ttl_ms: int = 0, time_unit: str = "ms",
                 max_memory_bytes: int = 1 << 34,
                 batch_size: int = 64, max_wait_ms: float = 5.0,
                 latency_window: int = 16384,
                 mesh=None, n_shards: Optional[int] = None,
                 retention=None, replication: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 fused_fold: bool = False, device="cuda"):
        for name, on in (("ttl_ms", ttl_ms),
                         ("mesh", mesh is not None),
                         ("n_shards", (n_shards or 0) > 1),
                         ("retention", retention is not None),
                         ("replication", replication),
                         ("checkpoint_dir", checkpoint_dir)):
            if on:
                _not_ported(name)
        self.device = resolve_device(device)
        from ..core.sql import parse

        self.cs: CompiledScript = compile_script(
            parse(script_sql, time_unit=time_unit), tables=tables,
            fused_unit_fold=fused_fold)
        self.use_preagg = use_preagg
        self.store = OnlineStore(capacity=capacity, device=self.device)
        self.guard = MemoryGuard(max_memory_bytes)
        part_cols = sorted({w.node.spec.partition_by
                            for w in self.cs.windows})
        if len(part_cols) > 1:
            raise ValueError(
                f"script partitions windows by multiple columns "
                f"{part_cols}; one shared key column is required")
        self.key_col: Optional[str] = part_cols[0] if part_cols else None
        need = self.cs.required_store_columns()
        for tname, cols in need.items():
            table = tables[tname]
            specs = {}
            for c in cols:
                dd = table.schema.column(c).ctype.device_dtype
                specs[c] = np.float32 if dd.kind == "f" else np.int32
            self.store.create_table(tname, specs)
        self._need = need
        self.pre_states = (self.cs.init_preagg_states(self.device)
                           if use_preagg else None)
        self.dicts = {name: t.dicts for name, t in tables.items()}
        self.tables = tables
        self.batcher = RequestBatcher(batch_size, max_wait_ms=max_wait_ms)
        self.n_requests = 0
        self.latencies_ms: Deque[float] = collections.deque(
            maxlen=latency_window)
        self.ingest_ms: Deque[float] = collections.deque(
            maxlen=latency_window)
        self.rows_ingested = 0

    # ------------------------------------------------------------- ingest
    def ingest(self, table: str, row: Dict[str, Any]):
        """Insert one event (Put path)."""
        self.ingest_many(table, [row])

    def ingest_many(self, table: str, rows: Sequence[Dict[str, Any]]):
        """Bulk insert of N events with one store sort-merge (and, with
        pre-agg, one batched bucket fold, ``PreAgg.update_many``)."""
        if not rows:
            return
        t0 = time.perf_counter()
        kc = self._key_col()
        keys = np.asarray([self._encode(table, kc, r[kc]) for r in rows],
                          np.int32)
        ts = np.asarray([int(r[self.cs.script.order_column])
                         for r in rows], np.int32)
        cols = {c: np.asarray([float(self._encode(table, c, r[c]))
                               for r in rows], np.float32)
                for c in self._need[table]}
        nbytes = len(rows) * (64 + 8 * len(cols))
        self.guard.charge(nbytes)
        try:
            self.store.put_many(table, keys, ts, cols)
        except Exception:
            self.guard.release(nbytes)   # nothing was stored
            raise
        if self.use_preagg:
            self.pre_states = self.cs.preagg_update_many(
                self.pre_states, table, keys, ts, cols)
        self.ingest_ms.append((time.perf_counter() - t0) * 1e3)
        self.rows_ingested += len(rows)

    def bulk_load(self, table: str, rows_table: Table):
        """LOAD DATA: ingest a whole historical table at once.  With
        pre-agg the loaded rows fold into the bucket planes too (one
        ``update_many``), or long windows would be served from empty
        planes over the loaded history."""
        cols = {c: rows_table.columns[c].astype(np.float32)
                for c in self._need[table]}
        keys = rows_table.columns[self._key_col()]
        ts = rows_table.columns[self.cs.script.order_column]
        self.store.bulk_load(table, keys, ts, cols)
        self.guard.charge(len(rows_table) * (64 + 8 * len(cols)))
        if self.use_preagg:
            self.pre_states = self.cs.preagg_update_many(
                self.pre_states, table, np.asarray(keys, np.int32),
                np.asarray(ts, np.int32), cols)

    def load_store_from(self, numpy_states: Dict[str, Dict]) -> None:
        """Take every table's store state as numpy arrays (``keys``,
        ``ts``, ``cols``, ``count``), e.g. a reference engine's
        ``{t: jax.tree.map(np.asarray, st) for t, st in
        store.tables.items()}``."""
        for table, st in numpy_states.items():
            self.store.load_state(table, st)

    # ------------------------------------------------------------ request
    def request(self, row: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Online request mode: features for one (virtually inserted)
        tuple of the base table."""
        t0 = time.perf_counter()
        key, ts, values = self._encode_request(row)
        feats = self.cs.online(self.store, key, ts, values,
                               preagg_states=self.pre_states)
        self.n_requests += 1
        self.latencies_ms.append((time.perf_counter() - t0) * 1e3)
        return feats

    def request_batch(self, rows: Sequence[Dict[str, Any]]
                      ) -> List[Dict[str, np.ndarray]]:
        """Features for B requests in one batched call: a fused engine
        without pre-agg takes the fast path (``online_batch_fast``),
        every other one ``online_batch`` (the staged fold and/or the
        pre-agg planes)."""
        if not rows:
            return []
        t0 = time.perf_counter()
        enc = [self._encode_request(r) for r in rows]
        keys = [e[0] for e in enc]
        ts = [e[1] for e in enc]
        values = {c: [e[2][c] for e in enc]
                  for c in self._need[self.cs.script.base_table]}
        if not self.use_preagg and self.cs.ctx.fused_unit_fold:
            feats = self.cs.online_batch_fast(self.store, keys, ts, values)
        else:
            feats = self.cs.online_batch(self.store, keys, ts, values,
                                         preagg_states=self.pre_states)
        dt_ms = (time.perf_counter() - t0) * 1e3
        self.n_requests += len(rows)
        # the batch wall time IS each request's real service latency
        self.latencies_ms.extend([dt_ms] * len(rows))
        return [{k: v[i] for k, v in feats.items()}
                for i in range(len(rows))]

    def submit_request(self, row: Dict[str, Any]) -> int:
        """Enqueue a request for batched execution; returns its id."""
        return self.batcher.submit(row)

    def flush(self) -> Dict[int, Dict[str, np.ndarray]]:
        """Drain the request queue through the batched path; returns
        {request_id: features}.  Only real requests are served."""
        out: Dict[int, Dict[str, np.ndarray]] = {}
        while self.batcher.queue:
            ids, payloads, n_real = self.batcher.next_batch()
            feats = self.request_batch(payloads[:n_real])
            for rid, f in zip(ids, feats):
                out[rid] = f
        return out

    # ------------------------------------------------------------- offline
    def offline(self, tables: Optional[Dict[str, Table]] = None
                ) -> Dict[str, np.ndarray]:
        """Offline (training-set) feature materialization for this
        deployment's script, on the engine's device: the same fold that
        serves the requests computes the training features."""
        return self.cs.offline(tables or self.tables, device=self.device)

    # ------------------------------------------------------------ helpers
    def _key_col(self) -> str:
        if self.key_col is None:
            raise ValueError("script has no window partition column; "
                             "store ingest needs a key")
        return self.key_col

    def _encode_request(self, row: Dict[str, Any]):
        base = self.cs.script.base_table
        key = self._encode(base, self._key_col(), row[self._key_col()])
        ts = int(row[self.cs.script.order_column])
        values = {c: float(self._encode(base, c, row[c]))
                  for c in self._need[base]}
        return key, ts, values

    def _encode(self, table: str, col: str, v):
        d = self.dicts.get(table, {}).get(col)
        if d is not None and isinstance(v, str):
            return d.encode(v)
        return v

    def latency_percentiles(self) -> Dict[str, float]:
        """Percentiles over request completion samples ({} when none)."""
        if not self.latencies_ms:
            return {}
        arr = np.asarray(self.latencies_ms)
        return {f"TP{p}": float(np.percentile(arr, p))
                for p in (50, 90, 95, 99)}

    def reset_stats(self):
        """Drop warm-up samples before measuring percentiles."""
        self.latencies_ms.clear()
        self.ingest_ms.clear()
        self.rows_ingested = 0
        self.n_requests = 0


class ServingEngine:
    """Model serving: prefill once, then batched decode steps.

    ``params`` (``models.init_params`` / ``params_from_jax``) are moved to
    ``device`` as they are; their dtype is the compute dtype.  ``dtype``
    is the cache dtype of ``init_decode_state``.  ``use_kernel`` is passed
    to the kernels (``None``: the CUDA kernels on the card, the plain
    versions on the CPU; ``False``: the plain versions anywhere, the
    reference the kernels are held against).  Logits come back as float32
    numpy arrays (the exact values of bfloat16 logits).
    """

    def __init__(self, cfg, params, max_len: int = 2048,
                 dtype=torch.bfloat16, device="cuda",
                 use_kernel: Optional[bool] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.max_len = max_len
        self.dtype = dtype
        self.use_kernel = use_kernel
        self.state = None

    def init_state(self, batch_size: int) -> Dict[str, Any]:
        """An empty decode state at this engine's capacity and dtype."""
        return init_decode_state(self.cfg, batch_size, self.max_len,
                                 dtype=self.dtype, device=self.device)

    def prefill(self, batch) -> np.ndarray:
        """Prefill ``batch["tokens"]`` (B, S); keeps the decode state
        (KV caches padded to ``max_len``) and returns the last logits."""
        logits, self.state = forward_prefill(
            self.cfg, self.params, {"tokens": self._tokens(batch["tokens"])},
            cache_capacity=self.max_len, use_kernel=self.use_kernel)
        return _host(logits)

    def decode(self, tokens: np.ndarray) -> np.ndarray:
        """One decode step for every sequence: tokens (B, 1)."""
        logits, self.state = decode_step(
            self.cfg, self.params, self.state, self._tokens(tokens),
            use_kernel=self.use_kernel)
        return _host(logits)

    def _tokens(self, tokens) -> torch.Tensor:
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.from_numpy(np.asarray(tokens))
        return tokens.to(device=self.device, dtype=torch.int32)

    def generate_greedy(self, batch, n_tokens: int) -> np.ndarray:
        """Greedy decoding: argmax over ``vocab_padded`` (padded ids are
        not masked, as in the reference) -> (B, n_tokens) int32."""
        logits = self.prefill(batch)
        out = []
        tok = np.argmax(logits, axis=-1)[:, None].astype(np.int32)
        for _ in range(n_tokens):
            out.append(tok)
            logits = self.decode(tok)
            tok = np.argmax(logits, axis=-1)[:, None].astype(np.int32)
        return np.concatenate(out, axis=1)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def _host(logits: torch.Tensor) -> np.ndarray:
    return logits.to(torch.float32).cpu().numpy()
