"""Fault tolerance: checkpoints, liveness and the policies around them.

Five mechanisms, used by the sharded serving path
(``storage.replication``) and tested on their own:

  * ``CheckpointManager`` — save/restore of a nested state (dicts, lists
    and tuples of tensors or arrays) with step retention and an atomic
    commit: the leaves go to one npz per host, the structure and leaf
    count to a JSON index, and restore rejects a template whose
    structure or leaf shapes differ from the save's before pairing any
    leaf.  Its files are its own: reading a checkpoint written by the
    JAX package (whose index records a ``jax.tree_util`` treedef) is not
    a goal.
  * ``ElasticPlanner`` — given a changed host count, the largest valid
    (data, model) mesh and a description of the resharding.
  * ``StragglerMitigator`` — deadline-based backup dispatch: per-host
    step latency EMA, stragglers flagged against the median, their work
    reassigned to the fastest hosts.
  * ``HeartbeatMonitor`` — host liveness; the serving path's
    ``FailoverController`` uses shards as hosts.
  * ``most_caught_up`` — the promotion policy.

Host-side Python and numpy; only the checkpoint touches tensors (copied
to the host to save, and back to each template leaf's device and dtype
on restore).
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["CheckpointManager", "ElasticPlanner", "StragglerMitigator",
           "HeartbeatMonitor", "MeshPlan", "most_caught_up",
           "tree_flatten", "tree_unflatten", "tree_map", "tree_stacks"]


def most_caught_up(acked: Dict[int, int]) -> int:
    """Promotion policy: the replica that has applied the highest log
    offset loses the least data on promotion.  Ties break toward the
    lowest replica id, so concurrent deciders pick the same winner."""
    if not acked:
        raise ValueError("no replicas to promote")
    return min(acked, key=lambda r: (-acked[r], r))


# ------------------------------------------------------------------ trees


def _walk(t, leaves: List[Any]) -> str:
    if isinstance(t, dict):
        keys = sorted(t, key=str)
        return "{" + ", ".join(f"{k!r}: {_walk(t[k], leaves)}"
                               for k in keys) + "}"
    if isinstance(t, (list, tuple)):
        inner = ", ".join(_walk(v, leaves) for v in t)
        return f"[{inner}]" if isinstance(t, list) else f"({inner})"
    if t is None:
        return "None"
    leaves.append(t)
    return "*"


def tree_flatten(tree: Any) -> Tuple[List[Any], str]:
    """Leaves of a nested state in a fixed order, and its structure as a
    stable string.  Dicts (keys in sorted order), lists and tuples are
    nodes, ``None`` an empty node; everything else is a leaf ``*``.

    The walkers are module functions, not recursive closures: a closure
    that calls itself is a reference cycle, and one holding the leaves
    kept every tensor of the tree alive until the garbage collector ran
    (a train step's whole state, on the card)."""
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves)


def _build(t, it):
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t, key=str)}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_build(v, it) for v in t))
    if isinstance(t, (list, tuple)):
        return type(t)(_build(v, it) for v in t)
    if t is None:
        return None
    return next(it)


def tree_unflatten(template: Any, leaves: Sequence[Any]) -> Any:
    """``template``'s structure with its leaves replaced, in
    ``tree_flatten`` order, by ``leaves`` (a named tuple stays one)."""
    return _build(template, iter(leaves))


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` applied to every leaf of a nested state."""
    leaves, _ = tree_flatten(tree)
    return tree_unflatten(tree, [fn(x) for x in leaves])


def tree_stacks(tree: Any) -> List[Tuple[List[int], int]]:
    """Leaves of ``tree`` grouped as the JAX package stacks them, by their
    indices in ``tree_flatten`` order.  A list whose items share one
    structure (the model's per-layer dicts) stands for the reference's
    leading L axis: the leaves at one path in every item form one group,
    with one more stacked axis.  Returns [(indices, stacked axes)]; a
    leaf outside such a list is a group of its own with 0."""
    counter = iter(range(1 << 62))

    def walk(t) -> List[Tuple[List[int], int]]:
        if isinstance(t, dict):
            return [g for k in sorted(t, key=str) for g in walk(t[k])]
        if isinstance(t, (list, tuple)):
            items = [walk(v) for v in t]
            if isinstance(t, list) and t and len(
                    {tree_flatten(v)[1] for v in t}) == 1:
                return [([i for idx, _ in col for i in idx], col[0][1] + 1)
                        for col in zip(*items)]
            return [g for groups in items for g in groups]
        if t is None:
            return []
        return [([next(counter)], 0)]

    return walk(tree)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class CheckpointManager:
    """Save/restore of nested states with step retention and atomic
    commit (npz of leaves + JSON index of structure and leaf count)."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def save(self, step: int, state: Any, host_id: int = 0) -> Path:
        """Save this host's view of ``state`` at ``step``."""
        leaves, structure = tree_flatten(state)
        tmp = self.dir / f"step_{step:08d}.host{host_id}.tmp.npz"
        final = self.dir / f"step_{step:08d}.host{host_id}.npz"
        np.savez(tmp, **{f"leaf_{i}": _host(leaf)
                         for i, leaf in enumerate(leaves)})
        tmp.rename(final)  # atomic commit
        index = {"step": step, "n_leaves": len(leaves),
                 "structure": structure, "time": time.time()}
        (self.dir / f"step_{step:08d}.index.json").write_text(
            json.dumps(index))
        self._gc()
        return final

    def latest_step(self) -> Optional[int]:
        steps = sorted(int(p.stem.split("_")[1].split(".")[0])
                       for p in self.dir.glob("step_*.index.json"))
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                host_id: int = 0) -> Any:
        """Restore into ``template``'s structure.

        The saved structure and leaf count are checked against the
        template before any leaf is paired, and every leaf's shape after
        it: a template that drifted since the save fails loudly.  A
        tensor leaf of the template comes back as a tensor of its dtype
        on its device; any other leaf as a numpy array."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        data = np.load(self.dir / f"step_{step:08d}.host{host_id}.npz")
        leaves, structure = tree_flatten(template)
        index_path = self.dir / f"step_{step:08d}.index.json"
        saved_n = len(data.files)
        saved_structure = None
        if index_path.exists():
            index = json.loads(index_path.read_text())
            saved_n = index.get("n_leaves", saved_n)
            saved_structure = index.get("structure")
        if saved_n != len(leaves):
            raise ValueError(
                f"checkpoint step {step} holds {saved_n} leaves but the "
                f"template has {len(leaves)}: the state structure changed "
                f"since the save — restoring would zip misaligned leaves")
        if saved_structure is not None and saved_structure != structure:
            raise ValueError(
                f"checkpoint step {step} structure does not match the "
                f"template's:\n  saved:    {saved_structure}\n  template: "
                f"{structure}\nthe state structure changed since the save")
        restored = []
        for i, leaf in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            if hasattr(leaf, "shape") and tuple(arr.shape) != tuple(
                    leaf.shape):
                raise ValueError(
                    f"leaf {i}: checkpoint shape {arr.shape} != template "
                    f"{tuple(leaf.shape)}")
            if isinstance(leaf, torch.Tensor):
                arr = torch.from_numpy(np.array(arr, order="C")).to(
                    device=leaf.device, dtype=leaf.dtype)
            restored.append(arr)
        return tree_unflatten(template, restored)

    def _gc(self):
        steps = sorted(set(int(p.stem.split("_")[1].split(".")[0])
                           for p in self.dir.glob("step_*.index.json")))
        for s in steps[:-self.keep]:
            for p in self.dir.glob(f"step_{s:08d}*"):
                p.unlink()


@dataclasses.dataclass
class MeshPlan:
    data: int
    model: int
    pod: int
    dropped_hosts: Tuple[int, ...]
    resharding: str


class ElasticPlanner:
    """Recompute the mesh when hosts join or leave.

    Policy: keep TP (model axis) at the largest power-of-two divisor of
    the per-pod chip count <= the requested TP — TP stays inside a pod's
    interconnect domain — and absorb the remaining chips into DP.  The
    global batch keeps its size, re-divided over the new DP."""

    def __init__(self, chips_per_host: int = 4, tp_target: int = 16):
        self.chips_per_host = chips_per_host
        self.tp_target = tp_target

    def plan(self, healthy_hosts: Sequence[int], total_hosts: int,
             pods: int = 1) -> MeshPlan:
        chips = len(healthy_hosts) * self.chips_per_host
        per_pod = chips // pods
        tp = self.tp_target
        while tp > 1 and per_pod % tp:
            tp //= 2
        dp = per_pod // tp
        dropped = tuple(sorted(set(range(total_hosts)) -
                               set(healthy_hosts)))
        return MeshPlan(
            data=dp, model=tp, pod=pods, dropped_hosts=dropped,
            resharding=(f"params: all-gather from survivors, re-slice "
                        f"model {self.tp_target}->{tp}, data -> {dp}; "
                        f"batch: global size re-split over dp={dp}"))


class HeartbeatMonitor:
    """Host liveness bookkeeping.

    A host registers by beating; one that has never beaten counts as dead
    (an unprovisioned replica must not be treated as healthy).  ``dead``
    is the serving path's trigger: the ``FailoverController`` promotes a
    follower for every shard whose heartbeats lapse."""

    def __init__(self, n_hosts: int, timeout_s: float = 30.0):
        self.n_hosts = n_hosts
        self.timeout_s = timeout_s
        self.last_seen: Dict[int, float] = {}

    def beat(self, host_id: int, now: Optional[float] = None):
        self.last_seen[host_id] = now if now is not None else time.time()

    def healthy(self, now: Optional[float] = None) -> List[int]:
        now = now if now is not None else time.time()
        return [h for h in range(self.n_hosts)
                if now - self.last_seen.get(h, -1e18) <= self.timeout_s]

    def dead(self, now: Optional[float] = None) -> List[int]:
        """Hosts whose last heartbeat is older than the timeout
        (never-beaten hosts included)."""
        now = now if now is not None else time.time()
        return [h for h in range(self.n_hosts)
                if now - self.last_seen.get(h, -1e18) > self.timeout_s]


class StragglerMitigator:
    """Deadline-based speculative re-execution.

    A host is a straggler when its step latency EMA exceeds the median
    times ``threshold``; its work goes to the fastest non-straggler for
    the next step (a backup task) until its EMA recovers."""

    def __init__(self, n_hosts: int, threshold: float = 1.8,
                 ema: float = 0.5):
        self.n_hosts = n_hosts
        self.threshold = threshold
        self.ema = ema
        self.latency = np.zeros(n_hosts)
        self.backups: Dict[int, int] = {}

    def observe(self, host_latencies: Dict[int, float]):
        for h, lat in host_latencies.items():
            prev = self.latency[h]
            self.latency[h] = (self.ema * lat + (1 - self.ema) * prev
                               if prev > 0 else lat)

    def stragglers(self) -> List[int]:
        live = self.latency[self.latency > 0]
        if live.size == 0:
            return []
        med = float(np.median(live))
        return [h for h in range(self.n_hosts)
                if self.latency[h] > self.threshold * med]

    def plan_backups(self) -> Dict[int, int]:
        """straggler host -> backup host (fastest non-stragglers, round
        robin)."""
        slow = set(self.stragglers())
        fast = [h for h in range(self.n_hosts) if h not in slow]
        self.backups = {}
        if not fast:
            return self.backups
        order = sorted(fast, key=lambda h: self.latency[h])
        for i, s in enumerate(sorted(slow)):
            self.backups[s] = order[i % len(order)]
        return self.backups
