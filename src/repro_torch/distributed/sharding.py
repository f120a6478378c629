"""Device meshes, sharding rules for params, batches and decode caches,
and the placement of the key-sharded online store.

The mesh is single-controller, as the JAX package's is: one Python
process holds a ``Mesh`` of ``torch.device``s, every shard's tensors
live on its device, and each cross-shard step is an explicit, ordered
copy or merge made by that process (no ``torch.distributed`` process
group, no collective).  A ``Mesh`` may name one device more than once:
the multi-shard code paths then run on that one device, which is how the
CPU tests and a one-card host exercise them.

Strategy (DESIGN.md §5): TP over ``model`` (output-feature / vocab /
expert / KV-sequence dims), ZeRO-3-style weight sharding over ``data``
(a second tensor dim), DP over ``pod`` × ``data`` for the batch.  The
rules are the reference's, leaf for leaf (``auto_pspec``: skip the
stacked layer axis; ``model`` on the largest divisible dim, preferring
later dims; ``data`` on the largest remaining divisible dim of at least
``min_shard`` rows; overrides where the heuristic is wrong).  They run
over the port's trees, whose leaves may be anything with ``.shape``.
The port keeps ``"layers"`` (and ``"enc_layers"``) as a list of
per-layer dicts where the reference stacks them on a leading L axis, so
a per-layer leaf's spec is the reference's spec of the stacked leaf
without its leading L entry: the ``stacked`` skip and the overrides'
leading ``None`` both stand for that axis.  Cache leaves follow the same
rule: per-layer (B, S, Hkv, D) where the reference has (L, B, S, Hkv, D).
``named_shardings`` pairs a spec tree with its mesh; ``shard_shape``
and ``per_device_bytes`` read such specs at the level of shapes (each
device's piece of a leaf, and what a device holds of a tree:
``launch.dryrun``'s argument bytes).  ``device_put`` is their consumer,
the reference's ``jax.device_put`` onto ``NamedSharding``s: every leaf
becomes a ``Placed``, its pieces one contiguous tensor per mesh entry on
that entry's device (a leaf on ``meta`` is allocated piece by piece, as
zeros, so a tree larger than one card is never whole: the reference's
``jit(init, out_shardings=...)``); ``gather`` joins the pieces back.
``axis_pieces`` reads a placed leaf's layout along one mesh axis (the
dimension the axis splits, and the pieces along it in entry order) and
``axis_mesh`` the entries along that axis: what
``models.tensor_parallel`` computes on.  A train step on a placed state
walks a leaf's distinct ``blocks`` once (the replicas of a block are
equal, and its gradient is one sum over them), updates its pieces entry
by entry (``map_pieces``) and runs data block ``j`` on row ``j`` of the
mesh (``mesh_rows``, ``take_row``).  ``gather`` is differentiable: a
piece that requires grad gets the gradient of the part of the whole
leaf that it filled.

Feature-store sharding (paper §5 / §7.2 tablet partitioning): the online
store is *key*-partitioned, so window folds never cross shards.
``key_shard_mesh`` builds the 1-D mesh over the visible cards,
``stacked_store_sharding`` names the device of every shard along the
mesh axis, and ``place_stacked`` / ``gather_stacked`` split a
shard-stacked tree into one stacked state of one shard per device and
join such states back.  Routing (key -> shard) is the host's hash and
rebalance, owned by ``storage.timestore.ShardedOnlineStore``.  The
reference's ``shard_map_compat`` is a JAX-version shim and has no
counterpart here.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .fault import tree_flatten, tree_unflatten

__all__ = ["Mesh", "PartitionSpec", "NamedSharding", "auto_pspec",
           "megatron_overrides", "STRATEGIES", "param_pspecs",
           "batch_pspec", "cache_pspecs", "named_shardings",
           "key_shard_mesh", "stacked_store_sharding", "place_stacked",
           "gather_stacked", "canonical_device", "cuda_devices",
           "shard_shape", "per_device_bytes", "shard_slices", "Placed",
           "device_put", "gather", "entry_bytes", "axis_pieces",
           "axis_mesh", "blocks", "map_pieces", "is_placed", "mesh_rows",
           "take_row", "same_mesh", "home"]


class PartitionSpec(tuple):
    """Per-dimension mesh axis names (a name, a tuple of names, or
    ``None`` for a replicated dimension): the reference's
    ``jax.sharding.PartitionSpec`` as a plain tuple, normalized as it
    is (a one-name tuple is the name, an empty one ``None``, a list a
    tuple)."""

    def __new__(cls, *parts):
        def norm(p):
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                return None if not p else p[0] if len(p) == 1 else p
            return p
        return super().__new__(cls, (norm(p) for p in parts))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """An n-D array of ``torch.device``s with named axes: what the
    reference reads from a ``jax.sharding.Mesh`` — ``devices`` (an object
    ndarray; ``devices.flat``, ``devices.shape``), ``axis_names``,
    and ``shape`` (axis -> size).  Entries may repeat a device
    (several shards on one card, or on the CPU)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for i, d in np.ndenumerate(src):
            arr[i] = torch.device(d)
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"mesh devices of shape {arr.shape} do not "
                             f"match axes {self.axis_names}")
        self.devices = arr

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, "
                f"devices={[str(d) for d in self.devices.flat]})")


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec paired with its mesh (the reference's
    ``jax.sharding.NamedSharding``), as a record."""

    mesh: Mesh
    spec: PartitionSpec


def cuda_devices() -> List[torch.device]:
    """Every visible CUDA device, in index order."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def canonical_device(device) -> torch.device:
    """``device`` with an explicit index for CUDA (``cuda`` is the current
    card), so two names of one device compare equal."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def key_shard_mesh(n_shards: Optional[int] = None, axis: str = "shard",
                   devices: Optional[Sequence] = None) -> Mesh:
    """1-D device mesh for the key-sharded online store.

    One shard per device of ``devices`` (every visible CUDA device unless
    the caller names others, e.g. the CPU), the first ``n_shards`` of
    them.  Raises if ``n_shards`` exceeds the device count — callers
    wanting more *logical* shards than devices use
    ``ShardedOnlineStore(mesh=None)`` (the stacked layout) or a ``Mesh``
    that repeats a device."""
    devs = list(devices) if devices is not None else cuda_devices()
    n = n_shards or len(devs)
    if n > len(devs):
        raise ValueError(
            f"{n} shards > {len(devs)} devices; use mesh=None for "
            f"logical sharding on fewer devices")
    if n < 1:
        raise ValueError("no device to build a mesh over; pass devices=")
    return Mesh(devs[:n], (axis,))


def stacked_store_sharding(mesh: Mesh, axis: str = "shard"
                           ) -> List[torch.device]:
    """The device of every shard of a shard-stacked tree whose dim 0 is
    placed on the mesh axis ``axis`` (one store shard per device along
    it; on a mesh of more axes, the entry at index 0 of the others)."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r}")
    ax = mesh.axis_names.index(axis)
    along = np.moveaxis(mesh.devices, ax, 0).reshape(mesh.shape[axis], -1)
    return [along[s, 0] for s in range(along.shape[0])]


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def place_stacked(tree, devices: Sequence[torch.device]) -> Tuple:
    """Split a tree of shard-stacked tensors (dim 0 = shard, one entry per
    device) into a tuple of trees, shard s's a stacked tree of one shard
    on ``devices[s]`` (copies: no view of the input survives)."""
    return tuple(_map_leaves(
        lambda t, s=s, d=d: t[s:s + 1].to(d, copy=True), tree)
        for s, d in enumerate(devices))


def gather_stacked(parts: Sequence, device) -> Any:
    """``place_stacked``'s inverse: the per-shard trees joined on
    ``device`` along dim 0, in shard order."""
    if isinstance(parts[0], dict):
        return {k: gather_stacked([p[k] for p in parts], device)
                for k in parts[0]}
    return torch.cat([p.to(device) for p in parts])


# tensors whose name matches are always replicated (small / per-layer
# scalars / norm scales / routing tables)
_REPLICATE_RE = re.compile(
    r"(norm|mix_a|mix_s|w0|u_bonus|mu|b_dt|d_skip|w_dt|b_up|b_down)")


def auto_pspec(path: str, shape: Tuple[int, ...], mesh_shape: Dict[str, int],
               stacked: bool, min_shard: int = 128) -> PartitionSpec:
    model_n = mesh_shape.get("model", 1)
    data_n = mesh_shape.get("data", 1)
    spec = [None] * len(shape)
    if _REPLICATE_RE.search(path) or len(shape) == 0:
        return P(*spec)

    start = 1 if stacked else 0
    dims = list(range(start, len(shape)))
    # model axis: largest divisible dim, ties broken toward later dims
    model_dim = None
    best = -1
    for i in dims:
        if shape[i] % model_n == 0 and shape[i] >= max(min_shard, model_n):
            if shape[i] >= best:
                best = shape[i]
                model_dim = i
    if model_dim is not None:
        spec[model_dim] = "model"
    # data (ZeRO) axis: largest remaining divisible dim
    data_dim = None
    best = -1
    for i in dims:
        if i == model_dim:
            continue
        if shape[i] % data_n == 0 and shape[i] >= max(min_shard, data_n):
            if shape[i] > best:
                best = shape[i]
                data_dim = i
    if data_dim is not None:
        spec[data_dim] = "data"
    return P(*spec)


def _divisible(shape, spec: PartitionSpec, mesh_shape) -> bool:
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n = int(np.prod([mesh_shape.get(a, 1) for a in axes]))
        if dim % n:
            return False
    return True


def megatron_overrides(zero: bool = False) -> Dict[str, PartitionSpec]:
    """Megatron-style 1D tensor parallelism: column-parallel up
    projections, row-parallel down projections, vocab-parallel embedding.
    ``zero=True`` adds a ``data`` dim on the *unsharded* weight axis
    (ZeRO-3 weight sharding) for archs whose optimizer state exceeds a
    16-way split (llava-34b, dbrx attention).  Specs of per-layer
    tensors lead with the stacked layer axis (``None``), as the
    reference's do; ``param_pspecs`` drops it for the port's per-layer
    leaves."""
    d2 = "data" if zero else None
    return {
        r"embed$": P("model", None),
        r"lm_head$": P(None, "model"),
        r"attn/(wq|wk|wv)$": P(None, d2, "model"),
        r"attn/wo$": P(None, "model", d2),
        r"xattn/(wq|wk|wv)$": P(None, d2, "model"),
        r"xattn/wo$": P(None, "model", d2),
        r"mlp/(w_gate|w_up)$": P(None, d2, "model"),
        r"mlp/w_down$": P(None, "model", d2),
        r"moe/router$": P(None, None, None),
        r"moe/(w_gate|w_up)$": P(None, "model", "data", None),
        r"moe/w_down$": P(None, "model", None, "data"),
        r"(shared_gate|shared_up)$": P(None, d2, "model"),
        r"shared_down$": P(None, "model", d2),
        r"attn/q_down$": P(None, None, None),
        r"attn/kv_down$": P(None, None, None),
        r"attn/(q_up|k_up|v_up)$": P(None, None, "model"),
        r"rwkv/(wr|wk|wv|wg|ww|cm_k|cm_r)$": P(None, d2, "model"),
        r"rwkv/(wo|cm_v)$": P(None, "model", d2),
        r"ssm/in_proj$": P(None, d2, "model"),
        r"ssm/out_proj$": P(None, "model", d2),
    }


STRATEGIES = {
    "auto": lambda: {},
    "megatron": lambda: megatron_overrides(zero=False),
    "megatron_zero": lambda: megatron_overrides(zero=True),
    "embed_fix": lambda: {r"embed$": P("model", None),
                          r"lm_head$": P(None, "model")},
}


def _mesh_shape(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _map_with_path(fn, tree, path: Tuple[str, ...] = (),
                   per_layer: bool = False):
    """``fn(path string, leaf, per_layer)`` over a tree of dicts and
    lists.  A list stands for the reference's stacked layer axis: its
    items share the list's path (the reference's path has no index
    there) and their leaves are per-layer."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),), per_layer)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path, True) for v in tree]
    return fn("/".join(path), tree, per_layer)


def param_pspecs(cfg, params_tree, mesh,
                 overrides: Optional[Dict[str, PartitionSpec]] = None,
                 strategy: str = "auto"):
    """PartitionSpec tree matching the params tree.

    ``strategy`` selects a named override set (hillclimb knob);
    ``overrides`` takes precedence.  Overrides that violate divisibility
    fall back to the auto rule (small archs keep working)."""
    mesh_shape = _mesh_shape(mesh)
    merged = dict(STRATEGIES[strategy]())
    merged.update(overrides or {})

    def leaf_spec(pstr, leaf, per_layer):
        shape = tuple(leaf.shape)
        for pat, spec in merged.items():
            if re.search(pat, pstr):
                if per_layer:
                    spec = P(*tuple(spec)[1:])
                if _divisible(shape, spec, mesh_shape):
                    return spec
                break
        # a per-layer leaf is the stacked leaf less its skipped L axis
        return auto_pspec(pstr, shape, mesh_shape, stacked=False)

    return _map_with_path(leaf_spec, params_tree)


def batch_pspec(batch_tree, mesh):
    """Batch dim over (pod, data) where divisible; rest replicated."""
    mesh_shape = _mesh_shape(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh_shape)
    dp = int(np.prod([mesh_shape[a] for a in dp_axes]))

    def leaf_spec(_, leaf, __):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return P()
        if shape[0] % dp == 0 and shape[0] >= dp:
            return P(dp_axes, *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))

    return _map_with_path(leaf_spec, batch_tree)


def cache_pspecs(cfg, cache_tree, mesh):
    """Decode cache sharding: batch over data (if divisible), the long
    KV-sequence axis over ``model`` (context parallelism — required to
    fit 32k x 128 caches, DESIGN.md §5), heads over model for SSM/RWKV
    states.  A per-layer leaf (B, S, ...) takes the reference's rule for
    the stacked (L, B, S, ...) leaf, less the L entry."""
    mesh_shape = _mesh_shape(mesh)
    model_n = mesh_shape.get("model", 1)
    data_n = mesh_shape.get("data", 1)

    def leaf_spec(pstr, leaf, _):
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec = [None] * nd
        if nd == 0 or "len" in pstr:
            return P(*spec)
        if pstr.startswith("layers"):
            # per-layer caches: (B, S, ...) or (B, ...) (the reference's
            # stacked ones carry a leading L, so its dims are these + 1)
            if shape[0] % data_n == 0 and shape[0] >= data_n:
                spec[0] = "data"
            # KV / latent caches: seq axis = 1 when deep (>= 4096)
            if nd >= 2 and shape[1] >= 4096 and shape[1] % model_n == 0:
                spec[1] = "model"
            elif nd >= 2:
                # state caches: shard the largest model-divisible dim
                best, dim = -1, None
                for i in range(1, nd):
                    if shape[i] % model_n == 0 and \
                            shape[i] >= max(128, model_n) and \
                            shape[i] > best:
                        best, dim = shape[i], i
                if dim is not None:
                    spec[dim] = "model"
            return P(*spec)
        if pstr.startswith("enc_out"):
            if shape[0] % data_n == 0 and shape[0] >= data_n:
                spec[0] = "data"
            return P(*spec)
        return P(*spec)

    return _map_with_path(leaf_spec, cache_tree)


def named_shardings(spec_tree, mesh):
    """``NamedSharding(mesh, spec)`` for every spec of a spec tree (dicts,
    lists, tuples and named tuples of ``PartitionSpec`` leaves)."""
    if isinstance(spec_tree, PartitionSpec):
        return NamedSharding(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: named_shardings(v, mesh) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [named_shardings(v, mesh) for v in spec_tree]
    if isinstance(spec_tree, tuple):           # a named tuple stays one
        items = [named_shardings(v, mesh) for v in spec_tree]
        return (type(spec_tree)(*items) if hasattr(spec_tree, "_fields")
                else tuple(items))
    raise TypeError(f"not a spec tree node: {type(spec_tree).__name__}")


def shard_shape(shape: Sequence[int], spec: PartitionSpec,
                mesh: Mesh) -> Tuple[int, ...]:
    """One device's piece of a leaf of ``shape`` placed by ``spec``: each
    dimension divided by the product of the sizes of the mesh axes its
    spec entry names (dimensions past the spec are replicated), as
    ``jax.sharding.NamedSharding.shard_shape``.  Raises where a
    dimension does not divide."""
    mesh_shape = _mesh_shape(mesh)
    out = []
    for i, dim in enumerate(tuple(shape)):
        ax = spec[i] if i < len(spec) else None
        axes = () if ax is None else ax if isinstance(ax, tuple) else (ax,)
        n = int(np.prod([mesh_shape[a] for a in axes]))
        if dim % n:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                             f"divide into {n} shards ({spec})")
        out.append(dim // n)
    return tuple(out)


def per_device_bytes(tree, spec_tree, mesh: Mesh) -> int:
    """Bytes one device holds of ``tree`` placed by ``spec_tree`` (a spec
    tree of the same structure: dicts, lists, tuples and named tuples
    of ``PartitionSpec`` leaves): the sum over leaves of their
    ``shard_shape`` times their element size."""
    if isinstance(spec_tree, PartitionSpec):
        n = int(np.prod(shard_shape(tuple(tree.shape), spec_tree, mesh)))
        return n * tree.element_size()
    if isinstance(spec_tree, dict):
        return sum(per_device_bytes(tree[k], v, mesh)
                   for k, v in spec_tree.items())
    if isinstance(spec_tree, (list, tuple)):
        return sum(per_device_bytes(t, v, mesh)
                   for t, v in zip(tree, spec_tree, strict=True))
    raise TypeError(f"not a spec tree node: {type(spec_tree).__name__}")


def shard_slices(shape: Sequence[int], spec: PartitionSpec, mesh: Mesh,
                 index: Tuple[int, ...]) -> Tuple[slice, ...]:
    """The part of a leaf of ``shape`` placed by ``spec`` that the mesh
    entry ``index`` (an index into ``mesh.devices``) holds: along each
    dimension, block ``k`` of ``shard_shape``'s size, ``k`` the entry's
    position over the mesh axes the dimension's spec entry names (the
    first named axis major), as ``NamedSharding.devices_indices_map``.
    A dimension no axis names is whole: its entries are replicas."""
    size = shard_shape(shape, spec, mesh)
    mesh_shape = _mesh_shape(mesh)
    out = []
    for i, n in enumerate(size):
        ax = spec[i] if i < len(spec) else None
        axes = () if ax is None else ax if isinstance(ax, tuple) else (ax,)
        k = 0
        for a in axes:
            k = k * mesh_shape[a] + index[mesh.axis_names.index(a)]
        out.append(slice(k * n, (k + 1) * n))
    return tuple(out)


class Placed:
    """One leaf placed by a ``NamedSharding`` (``device_put``): its global
    ``shape`` and ``dtype``, and ``pieces``, an object array indexed like
    ``sharding.mesh.devices`` whose entry ``i`` is the contiguous tensor
    of ``shard_slices(shape, spec, mesh, i)`` on the mesh's device ``i``.
    Entries that a replicated axis tells apart hold a piece each (equal
    values), so every entry holds ``shard_shape`` of the leaf, as
    ``per_device_bytes`` counts.  A placed leaf is read through its
    pieces (``models.sharded_decode``) or whole (``gather``)."""

    def __init__(self, sharding: NamedSharding, shape, dtype,
                 pieces: np.ndarray):
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.pieces = pieces

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    def element_size(self) -> int:
        return self.pieces.flat[0].element_size()

    def __repr__(self):
        return (f"Placed({tuple(self.shape)}, {self.dtype}, {self.spec}, "
                f"pieces {self.pieces.shape})")


def same_mesh(a: Mesh, b: Mesh) -> bool:
    """Whether two meshes have the same axes and the same device at every
    entry."""
    return a is b or (a.axis_names == b.axis_names
                      and a.devices.shape == b.devices.shape
                      and all(canonical_device(d) == canonical_device(e)
                              for d, e in zip(a.devices.flat,
                                              b.devices.flat)))


def _same_layout(x: Placed, sharding: NamedSharding) -> bool:
    """Whether ``x``'s pieces are the ones ``sharding`` places: the same
    mesh entries, each holding the same block (specs that differ only
    in axes of size 1 place alike)."""
    a, b = x.mesh, sharding.mesh
    if not same_mesh(a, b):
        return False
    return x.spec == sharding.spec or all(
        shard_slices(x.shape, x.spec, a, i)
        == shard_slices(x.shape, sharding.spec, b, i)
        for i in np.ndindex(a.devices.shape))


def _place(x, sharding: NamedSharding) -> Placed:
    if isinstance(x, Placed):
        if _same_layout(x, sharding):
            return x
        x = _whole(x, x.pieces.flat[0].device)
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"device_put places tensors, got "
                        f"{type(x).__name__}")
    mesh, spec = sharding.mesh, sharding.spec
    size = shard_shape(tuple(x.shape), spec, mesh)
    pieces = np.empty(mesh.devices.shape, dtype=object)
    for i in np.ndindex(mesh.devices.shape):
        dev = mesh.devices[i]
        if x.device.type == "meta":
            pieces[i] = torch.zeros(size, dtype=x.dtype, device=dev)
        else:
            pieces[i] = torch.empty(size, dtype=x.dtype, device=dev)
            pieces[i].copy_(x[shard_slices(x.shape, spec, mesh, i)])
    return Placed(sharding, x.shape, x.dtype, pieces)


def _whole(x: Placed, device) -> torch.Tensor:
    """The whole leaf on ``device``, each block copied from its first
    entry (a replica's block once).  The copies are recorded by autograd
    where a piece requires grad, so that piece gets the gradient of its
    block; the block's other replicas get none."""
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    for entries in blocks(x):
        out[shard_slices(x.shape, x.spec, x.mesh, entries[0])].copy_(
            x.pieces[entries[0]])
    return out


def device_put(tree, shardings):
    """Every tensor of ``tree`` placed by the ``NamedSharding`` at the same
    place of ``shardings`` (a tree of the same structure: dicts, lists,
    tuples and named tuples, e.g. ``named_shardings(cache_pspecs(...),
    mesh)``): a ``Placed`` whose pieces are new tensors on their entries'
    devices, no view of the input.  A leaf on ``meta`` gives zero pieces,
    allocated one entry at a time; a ``Placed`` leaf with this sharding
    is returned as it is, one with another is placed anew from its
    pieces.  Raises where a dimension does not divide (``shard_shape``)."""
    leaves, struct = tree_flatten(tree)
    shs, sh_struct = tree_flatten(shardings)
    if struct != sh_struct:
        raise ValueError(f"tree {struct} and shardings {sh_struct} differ")
    return tree_unflatten(tree, [_place(x, s) for x, s in zip(leaves, shs)])


def gather(tree, device):
    """``device_put``'s inverse: every ``Placed`` leaf of ``tree`` as one
    whole tensor on ``device`` (each block copied once, from the first
    entry that holds it); other tensors moved to ``device``."""
    def whole(x):
        if isinstance(x, Placed):
            return _whole(x, device)
        return x.to(device) if isinstance(x, torch.Tensor) else x
    if isinstance(tree, (Placed, torch.Tensor)):
        return whole(tree)
    leaves, _ = tree_flatten(tree)
    return tree_unflatten(tree, [whole(x) for x in leaves])


def entry_bytes(tree) -> np.ndarray:
    """Bytes each mesh entry holds of the ``Placed`` leaves of ``tree``
    (their pieces' storage), an int array shaped like the mesh: what
    ``per_device_bytes`` predicts from the specs."""
    out = None
    for x in tree_flatten(tree)[0]:
        if isinstance(x, Placed):
            n = np.vectorize(lambda t: t.numel() * t.element_size(),
                             otypes=[np.int64])(x.pieces)
            out = n if out is None else out + n
    if out is None:
        raise ValueError("no placed leaf in the tree")
    return out


def _axes(entry) -> Tuple[str, ...]:
    return () if entry is None else entry if isinstance(entry, tuple) \
        else (entry,)


def axis_mesh(mesh: Mesh, axis: str = "model") -> Mesh:
    """The entries of ``mesh`` along ``axis``, at index 0 of every other
    axis (the other axes kept, at size 1): where a product on pieces
    split by ``axis`` alone runs, and where its outputs are placed.
    ``mesh`` itself where every other axis has size 1."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r}")
    if all(n == 1 for a, n in mesh.shape.items() if a != axis):
        return mesh
    ax = mesh.axis_names.index(axis)
    index = tuple(slice(None) if i == ax else slice(0, 1)
                  for i in range(mesh.devices.ndim))
    return Mesh(mesh.devices[index], mesh.axis_names)


def axis_pieces(x: Placed, axis: str = "model"
                ) -> Optional[Tuple[Optional[int], List[torch.Tensor]]]:
    """A placed leaf's layout along the mesh axis ``axis``: ``(dim,
    pieces)``, ``dim`` the dimension that ``axis`` splits (None where the
    spec names it nowhere, or where the mesh has no such axis: every
    piece is then the whole leaf) and ``pieces`` the pieces of
    ``axis_mesh``'s entries in entry order, block ``k`` of ``dim`` the
    ``k``-th.  None where another mesh axis of size > 1 splits the leaf:
    no entry along ``axis`` then holds a whole block of ``dim``."""
    mesh_shape = _mesh_shape(x.mesh)
    dim = None
    for i, entry in enumerate(x.spec):
        for a in _axes(entry):
            if a == axis:
                dim = i
            elif mesh_shape.get(a, 1) > 1:
                return None
    if axis not in mesh_shape:
        return None, [x.pieces.flat[0]]
    return dim, _along(x, axis)


def _along(x: Placed, axis: str) -> List[torch.Tensor]:
    ax = x.mesh.axis_names.index(axis)
    index = [0] * x.pieces.ndim
    out = []
    for k in range(x.pieces.shape[ax]):
        index[ax] = k
        out.append(x.pieces[tuple(index)])
    return out


@functools.lru_cache(maxsize=4096)
def _blocks(shape, spec: PartitionSpec, mesh: Mesh
            ) -> Tuple[Tuple[Tuple[int, ...], ...], ...]:
    groups: Dict[Tuple[int, ...], List[Tuple[int, ...]]] = {}
    for i in np.ndindex(mesh.devices.shape):
        key = tuple(s.start for s in shard_slices(shape, spec, mesh, i))
        groups.setdefault(key, []).append(i)
    return tuple(tuple(g) for g in groups.values())


def blocks(x: Placed) -> Tuple[Tuple[Tuple[int, ...], ...], ...]:
    """A placed leaf's distinct blocks, each as the mesh entries that hold
    it (its replicas, equal pieces) in entry order; the blocks in the
    order of their first entries.  A leaf split along every mesh axis of
    size > 1 has one entry per block; a replicated one, one block."""
    return _blocks(tuple(x.shape), x.spec, x.mesh)


def home(x) -> torch.device:
    """The device a leaf's consumer computes on: mesh entry 0's device of
    a ``Placed``, a tensor's own."""
    return x.pieces.flat[0].device if isinstance(x, Placed) else x.device


def map_pieces(fn, x: Placed, *more: Placed, shape=None) -> Placed:
    """A ``Placed`` on ``x``'s mesh and spec whose piece at each entry is
    ``fn`` of the pieces of ``x`` (and of ``more``, placed alike) at that
    entry, entry by entry: each on its own card.  Its global shape is
    ``x``'s, or ``shape``; its dtype that of ``fn``'s results."""
    arr = np.empty(x.pieces.shape, dtype=object)
    for i in np.ndindex(arr.shape):
        arr[i] = fn(x.pieces[i], *(m.pieces[i] for m in more))
    return Placed(x.sharding, x.shape if shape is None else shape,
                  arr.flat[0].dtype, arr)


def is_placed(tree) -> bool:
    """Whether ``tree`` holds ``Placed`` leaves: all of them (True) or none
    (False); a tree that mixes the two raises ``ValueError``."""
    kinds = {isinstance(x, Placed) for x in tree_flatten(tree)[0]}
    if len(kinds) > 1:
        raise ValueError("a tree with some leaves placed (device_put) and "
                         "some not: place all of them or none")
    return kinds == {True}


def mesh_rows(mesh: Mesh, axes: Sequence[str] = ()
              ) -> List[Tuple[Tuple[slice, ...], Mesh]]:
    """The rows of ``mesh`` along the mesh axes ``axes`` (the data axes of
    a train step): row ``j`` is the sub-mesh at index ``j`` of those axes
    (flattened, the first named axis major, as ``P(None, axes)`` splits
    a batch), every other axis whole; as ``(index into mesh.devices,
    sub-mesh)`` pairs keeping every axis name, the row's ``axes`` at size
    1.  One row, the mesh itself, where those axes have one entry (or
    ``axes`` is empty)."""
    missing = [a for a in axes if a not in mesh.shape]
    if missing:
        raise ValueError(f"mesh {dict(mesh.shape)} has no axes {missing}")
    sizes = [mesh.shape[a] for a in axes]
    n = int(np.prod(sizes))
    if n == 1:
        return [(tuple(slice(None) for _ in mesh.axis_names), mesh)]
    out = []
    for j in range(n):
        coord = dict(zip(axes, np.unravel_index(j, sizes)))
        index = tuple(slice(int(coord[a]), int(coord[a]) + 1)
                      if a in coord else slice(None)
                      for a in mesh.axis_names)
        out.append((index, Mesh(mesh.devices[index], mesh.axis_names)))
    return out


def take_row(x: Placed, index: Tuple[slice, ...], row: Mesh
             ) -> Optional[Placed]:
    """``x`` as placed on one row of its mesh (``mesh_rows``): the pieces
    of the row's entries, the same spec on the row's sub-mesh.  None
    where the spec splits ``x`` along an axis that the row cuts (no row
    then holds whole blocks: the leaf is read whole, ``gather``)."""
    if row is x.mesh:
        return x
    mesh_shape = _mesh_shape(x.mesh)
    cut = {a for a, n in _mesh_shape(row).items() if n < mesh_shape[a]}
    if any(a in cut for entry in x.spec for a in _axes(entry)):
        return None
    return Placed(NamedSharding(row, x.spec), x.shape, x.dtype,
                  x.pieces[index])
