"""Training data pipelines.

``FeatureDataPipeline`` — the offline mode end-to-end: run a deployed
feature script over historical tables (the SAME CompiledScript the online
engine serves — consistency by construction) on the card unless the
caller asks for the CPU, assemble the dense feature matrix, and stream
shuffled batches to the trainer with host-side prefetch.  The batch
indices are drawn on the host from ``np.random.default_rng(seed)`` as in
the JAX package, so both yield the same rows in the same order; the rows
are gathered from a copy of the matrix on the pipeline's device.

``TokenPipeline`` — deterministic synthetic token batches for the LM
training examples (hash-mixed, so loss curves are reproducible without
shipping a corpus); host numpy, the JAX package's bits.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..core.compiler import CompiledScript
from ..core.types import Table
from ..kernels.dispatch import resolve_device

__all__ = ["FeatureDataPipeline", "TokenPipeline"]


class FeatureDataPipeline:
    def __init__(self, cs: CompiledScript, tables: Dict[str, Table],
                 batch_size: int, hash_dim: int = 4096,
                 prefetch: int = 2, seed: int = 0, device="cuda"):
        self.cs = cs
        self.tables = tables
        self.batch_size = batch_size
        self.hash_dim = hash_dim
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        self._features: Optional[Dict[str, np.ndarray]] = None

    def materialize(self) -> Dict[str, np.ndarray]:
        """Offline batch feature computation on the pipeline's device
        (cached)."""
        if self._features is None:
            self._features = self.cs.offline(self.tables, self.device)
        return self._features

    def feature_matrix(self) -> np.ndarray:
        """(rows, F) dense float32 matrix: multi-output features are
        flattened; NaN/inf scrubbed (sentinel-free for the model)."""
        feats = self.materialize()
        cols = []
        for name in self.cs.feature_names:
            v = np.asarray(feats[name], np.float32)
            cols.append(v[:, None] if v.ndim == 1 else v)
        mat = np.concatenate(cols, axis=1)
        return np.nan_to_num(mat, posinf=0.0, neginf=0.0)

    def batches(self, n_batches: int) -> Iterator[Dict[str, torch.Tensor]]:
        """Shuffled feature/label batches with background prefetch:
        ``features`` (batch, F) float32 and ``labels`` (batch,) int32
        tensors on the pipeline's device."""
        mat = self.feature_matrix()
        n = mat.shape[0]
        labels = (mat[:, 0] > np.median(mat[:, 0])).astype(np.int32)
        mat_dev = torch.from_numpy(mat).to(self.device)
        labels_dev = torch.from_numpy(labels).to(self.device)

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def producer():
            for _ in range(n_batches):
                idx = torch.from_numpy(
                    self.rng.integers(0, n, self.batch_size)).to(self.device)
                q.put({"features": mat_dev[idx], "labels": labels_dev[idx]})
            q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item


class TokenPipeline:
    """Deterministic pseudo-corpus: token t = mix(stream, position) with
    a learnable-structure bias (n-gram-ish repetitions) so tiny models
    show a real loss decrease."""

    def __init__(self, vocab_size: int, batch_size: int, seq_len: int,
                 seed: int = 0):
        self.vocab = vocab_size
        self.batch = batch_size
        self.seq = seq_len
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        base = rng.integers(0, self.vocab,
                            (self.batch, self.seq)).astype(np.int32)
        # inject structure: repeat the previous token with prob .5
        rep = rng.random((self.batch, self.seq)) < 0.5
        out = base.copy()
        for j in range(1, self.seq):
            out[:, j] = np.where(rep[:, j], out[:, j - 1], base[:, j])
        return {"tokens": out}

    def batches(self, n: int) -> Iterator[Dict[str, np.ndarray]]:
        for step in range(n):
            yield self.batch_at(step)
