"""Gradient compression on a placed state (``Placed`` leaves, weights in
pieces), on CPU meshes (2, 2) and (1, 4) of CPU entries, in float32.

The reference's ``int8_compress`` and ``topk_compress``
(``src/repro/distributed/compression.py:30-72``) take one scale or one
threshold per (stacked) tensor whatever its sharding.  The port takes
the same per-tensor scale and threshold over a leaf's pieces and
compresses each piece on its card, so:

* on reduced llama3-8b (8 heads, 4 KV heads, 2 layers) placed by
  ``param_pspecs(strategy="megatron")`` (norms replicated on every
  entry; on (2, 2) every leaf has two replicas along ``data``), seeded
  numpy gradients and residuals (placed like the params, or 0-d as the
  reference cell's ``P()`` residuals): the compressed gradients and the
  new residuals, gathered, are bitwise the whole tree's, placed like the
  gradients, their replicas bitwise equal;
* a leaf whose replicas, counted as elements, would move top-k's ``k``
  and threshold keeps exactly what the whole leaf keeps;
* ``adamw_init(placed, with_compression=True)`` places the residuals
  like the params;
* one ``build_train_step(..., compress=int8_compress)`` step on the
  placed state over two data blocks against the whole tree's step: loss
  and grad norm
  at rtol 1e-4, params at ``tests/test_torch_train.py``'s
  ``_close_params`` and the residuals at its ``_close_residual``;
* a gradient / residual pair that mixes placed and whole leaves raises.
"""

import numpy as np
import pytest
import torch

from repro_torch.distributed.compression import int8_compress, topk_compress
from repro_torch.distributed.fault import tree_flatten, tree_map
from repro_torch.distributed.sharding import (Mesh, NamedSharding,
                                              PartitionSpec as P, Placed,
                                              blocks, device_put, gather,
                                              named_shardings, param_pspecs)
from repro_torch.models import params_from_jax
from repro_torch.train import optimizer as TO
from repro_torch.train import steps as TS

from test_torch_train import _close_params, _close_residual
from test_torch_train_pieces import _cfgs, _np_params, _replicas_equal

CPU = torch.device("cpu")
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1)
SCHEMES = {"int8": int8_compress, "topk": topk_compress}


def _mesh(shape):
    return Mesh(np.full(shape, CPU, dtype=object), ("data", "model"))


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs("llama3-8b")
    params = params_from_jax(tcfg, _np_params(jcfg, 5), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (4, 16)).astype(np.int32))
    return tcfg, params, tokens


def _drawn(tree, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return tree_map(lambda x: torch.from_numpy(
        (scale * rng.standard_normal(tuple(x.shape))).astype(np.float32)),
        tree)


def _same_bits(got, want, shardings):
    for x, w, sh in zip(tree_flatten(got)[0], tree_flatten(want)[0],
                        shardings):
        assert isinstance(x, Placed) and x.sharding == sh
        assert torch.equal(gather(x, CPU), w)
    _replicas_equal(got)


@pytest.mark.parametrize("residual", ["placed", "0-d"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_compression_on_pieces_is_the_whole_trees(model, scheme, shape,
                                                  residual):
    cfg, params, _ = model
    mesh = _mesh(shape)
    shardings = named_shardings(param_pspecs(cfg, params, mesh,
                                             strategy="megatron"), mesh)
    grads = _drawn(params, 1)
    err = (_drawn(params, 2, 0.01) if residual == "placed"
           else tree_map(lambda _: torch.zeros(()), params))
    err_sh = (shardings if residual == "placed" else
              tree_map(lambda _: NamedSharding(mesh, P()), params))
    placed_g = device_put(grads, shardings)
    placed_e = device_put(err, err_sh)
    assert any(len(b) > 1 for x in tree_flatten(placed_g)[0]
               for b in blocks(x))
    want_g, want_e = SCHEMES[scheme](grads, err)
    got_g, got_e = SCHEMES[scheme](placed_g, placed_e)
    flat = tree_flatten(shardings)[0]
    _same_bits(got_g, want_g, flat)
    _same_bits(got_e, want_e, flat)


def test_topk_counts_each_block_once():
    """A (8, 6) leaf split by ``model`` along its rows on a (2, 2) mesh:
    two replicas of each block.  ``k`` = 4 of its 48 elements: the
    pieces keep the whole leaf's four largest; the same threshold taken
    over every piece (96 values, k = 9) would keep five."""
    mesh = _mesh((2, 2))
    w = (torch.arange(1, 49, dtype=torch.float32)
         * (-1) ** torch.arange(48)).reshape(8, 6)
    sh = NamedSharding(mesh, P("model", None))
    x = device_put({"w": w}, {"w": sh})
    assert [len(b) for b in blocks(x["w"])] == [2, 2]
    zero = {"w": torch.zeros(())}
    want = topk_compress({"w": w}, zero)[0]["w"]
    got = topk_compress(x, device_put(zero,
                                      {"w": NamedSharding(mesh, P())}))
    assert torch.equal(gather(got[0]["w"], CPU), want)
    assert int((want != 0).sum()) == 4
    every = torch.cat([t.abs().reshape(-1) for t in x["w"].pieces.flat])
    naive = torch.topk(every, int(every.numel() * 0.1)).values[-1]
    assert int((w.abs() >= naive).sum()) == 5


def test_adamw_init_places_the_residuals(model):
    cfg, params, _ = model
    mesh = _mesh((2, 2))
    placed = device_put(params, named_shardings(param_pspecs(
        cfg, params, mesh, strategy="megatron"), mesh))
    state = TO.adamw_init(placed, with_compression=True)
    for e, p in zip(tree_flatten(state.compress_err)[0],
                    tree_flatten(placed)[0]):
        assert isinstance(e, Placed) and e.sharding == p.sharding
        assert e.dtype == torch.float32
        assert all(not t.any() for t in e.pieces.flat)


def test_int8_step_on_pieces(model):
    """One ``int8_compress`` step on the (2, 2) placed state, two data
    blocks, against the whole tree's step; the same placed params and
    moments after it, the residuals placed like them."""
    cfg, params, tokens = model
    mesh = _mesh((2, 2))
    batch = {"tokens": tokens}
    opt = TO.AdamWConfig(**OPT)
    placed = TO.adamw_init(device_put(params, named_shardings(param_pspecs(
        cfg, params, mesh, strategy="megatron"), mesh)),
        with_compression=True)
    whole = TO.adamw_init(params, with_compression=True)
    kw = dict(n_micro=2, compress=int8_compress,
              compute_dtype=torch.float32)
    new, m = TS.build_train_step(cfg, opt, dp_axes=("data",), mesh=mesh,
                                 **kw)(placed, batch)
    one, om = TS.build_train_step(cfg, opt, **kw)(whole, batch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(om[k]), rtol=1e-4)
    for field in ("params", "mu", "nu"):
        assert all(a is b for a, b in zip(
            tree_flatten(getattr(new, field))[0],
            tree_flatten(getattr(placed, field))[0]))
    for e, p in zip(tree_flatten(new.compress_err)[0],
                    tree_flatten(new.params)[0]):
        assert e.sharding == p.sharding
    _replicas_equal((new.params, new.mu, new.nu, new.compress_err))
    for field in ("params", "mu", "nu"):
        for i, (g, w) in enumerate(zip(tree_flatten(getattr(new, field))[0],
                                       tree_flatten(getattr(one, field))[0])):
            _close_params(gather(g, CPU).numpy(), w.numpy(), OPT["lr"],
                          f"{field} leaf {i}")
    for i, (g, w) in enumerate(zip(tree_flatten(new.compress_err)[0],
                                   tree_flatten(one.compress_err)[0])):
        _close_residual(gather(g, CPU).numpy(), w.numpy(),
                        f"residual leaf {i}")


def test_mixed_tree_raises(model):
    cfg, params, _ = model
    mesh = _mesh((1, 4))
    placed = device_put(params, named_shardings(param_pspecs(
        cfg, params, mesh, strategy="megatron"), mesh))
    with pytest.raises(ValueError, match="some leaves placed"):
        int8_compress(placed, tree_map(lambda _: torch.zeros(()), params))
