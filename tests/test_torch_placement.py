"""Placement of whole trees by their specs (``distributed.sharding.
device_put`` / ``gather`` / ``Placed``), the port's counterpart of
``jax.device_put`` onto ``NamedSharding``s and of fetching a sharded
array back.

On CPU meshes (1, 2), (2, 2) and (1, 4), for the decode state (batch 4,
4,096 positions: ``cache_pspecs`` puts ``data`` on the batch and
``model`` on the sequence) and the train state (``param_pspecs`` with
the ``megatron_zero`` overrides, which split the reduced widths) of
reduced llama3-8b, hymba-1.5b and rwkv6-7b, every leaf seeded:

* ``gather(device_put(tree))`` is bitwise the tree;
* every piece is a contiguous tensor equal to its ``shard_slices``
  slice, of ``shard_shape``'s shape, on its entry's device;
* the bytes each entry holds (``entry_bytes``) equal
  ``per_device_bytes``, entry by entry;
* ``shard_slices`` splits a dimension over several axes with the first
  major, as ``jax.sharding.NamedSharding`` does.

A mesh with a ``meta`` entry puts that entry's pieces on ``meta`` and
the others' on the CPU with their values; a ``meta`` tree is allocated
piece by piece, as zeros, one new tensor per entry.  Bar: bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch
from repro_torch.configs import reduced
from repro_torch.distributed.fault import tree_flatten, tree_map
from repro_torch.distributed.sharding import (Mesh, NamedSharding,
                                              PartitionSpec as P, Placed,
                                              cache_pspecs, device_put,
                                              entry_bytes, gather,
                                              named_shardings, param_pspecs,
                                              per_device_bytes, shard_shape,
                                              shard_slices)
from repro_torch.models import model as TM
from repro_torch.train.optimizer import TrainState, adamw_init

CPU, META = torch.device("cpu"), torch.device("meta")
ARCHS = ["llama3-8b", "hymba-1.5b", "rwkv6-7b"]
MESHES = [(1, 2), (2, 2), (1, 4)]
B, S = 4, 4096


def _mesh(shape, devices=None):
    devs = np.empty(shape, dtype=object)
    for i in np.ndindex(shape):
        devs[i] = CPU if devices is None else devices[i]
    return Mesh(devs, ("data", "model"))


def _seeded(tree, seed):
    gen = torch.Generator().manual_seed(seed)

    def fill(t):
        if t.dtype.is_floating_point:
            return torch.randn(t.shape, generator=gen).to(t.dtype)
        return torch.randint(0, 1000, t.shape, generator=gen,
                             dtype=t.dtype)
    return tree_map(fill, tree)


def _cfg(arch):
    return dataclasses.replace(reduced(arch), n_layers=2)


def _decode_tree(arch, mesh, device="cpu"):
    cfg = _cfg(arch)
    state = TM.init_decode_state(cfg, B, S, dtype=torch.float32,
                                 device=device)
    if device != "meta":
        state = _seeded(state, 1)
    return state, cache_pspecs(cfg, state, mesh)


def _train_tree(arch, mesh):
    cfg = _cfg(arch)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            dtype=torch.float32, device="cpu")
    state = _seeded(adamw_init(params, with_compression=True), 2)
    p_specs = param_pspecs(cfg, params, mesh, strategy="megatron_zero")
    specs = TrainState(step=P(), params=p_specs, mu=p_specs, nu=p_specs,
                       compress_err=tree_map(lambda _: P(),
                                             state.compress_err))
    return state, specs


TREES = {"decode": _decode_tree, "train": _train_tree}


def _spec_leaves(specs, mesh):
    """The specs of a spec tree in ``tree_flatten`` order (a spec is a
    tuple, so the tree is flattened as ``NamedSharding``s)."""
    return [s.spec for s in tree_flatten(named_shardings(specs, mesh))[0]]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", sorted(TREES))
def test_device_put_then_gather_is_bitwise(which, arch, shape):
    mesh = _mesh(shape)
    tree, specs = TREES[which](arch, mesh)
    placed = device_put(tree, named_shardings(specs, mesh))
    assert type(placed) is type(tree)
    back = gather(placed, CPU)
    leaves, struct = tree_flatten(tree)
    back_leaves, back_struct = tree_flatten(back)
    assert back_struct == struct
    for a, b in zip(leaves, back_leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)
    split = 0
    for leaf, pl, spec in zip(leaves, tree_flatten(placed)[0],
                              _spec_leaves(specs, mesh)):
        assert isinstance(pl, Placed) and pl.spec == spec
        assert tuple(pl.shape) == tuple(leaf.shape)
        size = shard_shape(tuple(leaf.shape), spec, mesh)
        split += size != tuple(leaf.shape)
        for i in np.ndindex(shape):
            piece = pl.pieces[i]
            assert piece.device == mesh.devices[i]
            assert tuple(piece.shape) == size and piece.is_contiguous()
            assert torch.equal(piece,
                               leaf[shard_slices(leaf.shape, spec, mesh, i)])
            # a copy, never a view of the input
            assert piece.untyped_storage().data_ptr() != \
                leaf.untyped_storage().data_ptr()
    # the RWKV state's widths (64) are below cache_pspecs' 128 for
    # ``model``: at data 1 nothing of it splits
    assert split > 0 or (which, arch, shape[0]) == ("decode", "rwkv6-7b", 1)
    want = np.empty(shape, dtype=np.int64)
    want[...] = per_device_bytes(tree, specs, mesh)
    np.testing.assert_array_equal(entry_bytes(placed), want)


@pytest.mark.parametrize("spec,dim,block", [
    (P("data", "model"), 1, lambda d, m: m),
    (P(("data", "model")), 0, lambda d, m: d * 4 + m),
    (P(("model", "data")), 0, lambda d, m: m * 2 + d),
    (P(None, None, "data"), 2, lambda d, m: d)])
def test_shard_slices_put_the_first_named_axis_major(spec, dim, block):
    """A dimension over several axes is split in their order, the first
    major (``PartitionSpec(("data", "model"))`` gives entry (d, m) block
    d·|model| + m, as JAX's ``NamedSharding`` does); the blocks of the
    entries that differ along the dimension's axes tile it."""
    leaf_shape = (8, 16, 4)
    mesh = _mesh((2, 4))
    n = shard_shape(leaf_shape, spec, mesh)[dim]
    seen = {}
    for i in np.ndindex((2, 4)):
        sl = shard_slices(leaf_shape, spec, mesh, i)
        k = block(*i)
        assert sl[dim] == slice(k * n, (k + 1) * n)
        seen.setdefault(k, set()).add(sl[dim])
    assert sorted(seen) == list(range(leaf_shape[dim] // n))


def test_meta_entry_holds_meta_pieces():
    """A (1, 2) mesh whose second entry is ``meta``: its pieces lie on
    ``meta`` with their shapes, the CPU entry's hold their values."""
    devs = np.array([[CPU, META]], dtype=object)
    mesh = _mesh((1, 2), devs)
    tree, specs = _decode_tree("hymba-1.5b", mesh)
    placed = device_put(tree, named_shardings(specs, mesh))
    for leaf, pl, spec in zip(tree_flatten(tree)[0],
                              tree_flatten(placed)[0],
                              _spec_leaves(specs, mesh)):
        size = shard_shape(tuple(leaf.shape), spec, mesh)
        cpu, meta = pl.pieces[0, 0], pl.pieces[0, 1]
        assert meta.device == META and tuple(meta.shape) == size
        assert meta.dtype == leaf.dtype
        assert cpu.device == CPU and torch.equal(
            cpu, leaf[shard_slices(leaf.shape, spec, mesh, (0, 0))])
    k = placed["layers"][0]["attn"]["k"]
    assert k.spec == P("data", "model", None, None)
    assert tuple(k.pieces[0, 1].shape) == (B, S // 2, *k.shape[2:])


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_meta_tree_is_allocated_piece_by_piece(shape):
    """A ``meta`` decode state placed on a CPU mesh: zero pieces of
    ``shard_shape`` on the CPU, a new tensor for every entry (replicas
    too), and the bytes ``per_device_bytes`` predicts."""
    mesh = _mesh(shape)
    tree, specs = _decode_tree("llama3-8b", mesh, device="meta")
    placed = device_put(tree, named_shardings(specs, mesh))
    ptrs = set()
    n_pieces = 0
    for leaf, pl, spec in zip(tree_flatten(tree)[0],
                              tree_flatten(placed)[0],
                              _spec_leaves(specs, mesh)):
        size = shard_shape(tuple(leaf.shape), spec, mesh)
        for i in np.ndindex(shape):
            piece = pl.pieces[i]
            assert piece.device == CPU and tuple(piece.shape) == size
            assert not piece.any()
            ptrs.add(piece.untyped_storage().data_ptr())
            n_pieces += 1
    assert len(ptrs) == n_pieces
    want = np.empty(shape, dtype=np.int64)
    want[...] = per_device_bytes(tree, specs, mesh)
    np.testing.assert_array_equal(entry_bytes(placed), want)


def test_a_placed_leaf_is_kept_or_placed_anew():
    """``device_put`` of a ``Placed`` leaf: the same object where the
    sharding places it alike (a spec that differs only in an axis of
    size 1 included), new pieces with the values where it does not."""
    mesh = _mesh((1, 4))
    x = torch.arange(4 * 8 * 2, dtype=torch.float32).reshape(4, 8, 2)
    a = device_put(x, NamedSharding(mesh, P("data", "model")))
    assert device_put(a, NamedSharding(mesh, P(None, "model"))) is a
    b = device_put(a, NamedSharding(mesh, P("model")))
    assert b is not a and b.spec == P("model")
    assert tuple(b.pieces[0, 1].shape) == (1, 8, 2)
    assert torch.equal(gather(b, CPU), x)
    with pytest.raises(ValueError, match="does not divide"):
        device_put(x, NamedSharding(mesh, P(None, None, "model")))
