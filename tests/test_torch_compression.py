"""Gradient compression, port against reference, bit for bit: the same
numpy gradients and residuals (with ties, exact zeros, an all-zero
tensor, values on the int8 grid's half steps, 0-d leaves) through
``int8_compress`` / ``topk_compress`` of both packages, in the model's
two layouts: the reference stacks the per-layer leaves on a leading L
axis, the port keeps one dict per layer, and the L leaves at one path
are one tensor of the reference (one int8 scale, one top-k threshold).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as JC
from repro_torch.distributed import compression as TC
from repro_torch.distributed.fault import tree_flatten, tree_stacks

L = 3


def _grads(seed):
    """(reference tree, port tree) of the same numpy values."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((17, 8)).astype(np.float32)
    emb[3] = 0.0                                     # zeros
    emb[5, :4] = emb[6, :4] = emb[0, 0]              # ties
    w = rng.standard_normal((L, 6, 4)).astype(np.float32)
    w[1] *= 40.0                     # one layer sets the shared scale
    w[2, 0, :3] = (np.arange(3) + 0.5) * np.abs(w).max() / 127.0  # x.5
    norm = np.round(rng.standard_normal((L, 6)), 1).astype(np.float32)
    mix = np.array([0.25, -0.25, 0.25], np.float32)  # stacked 0-d leaves
    ref = {"embed": emb, "zero": np.zeros((4, 4), np.float32),
           "scalar": np.float32(0.7),                # 0-d: passes through
           "layers": {"w": w, "norm": norm, "mix": mix}}
    port = {"embed": emb, "zero": ref["zero"], "scalar": ref["scalar"],
            "layers": [{"w": w[i], "norm": norm[i], "mix": mix[i]}
                       for i in range(L)]}
    return ref, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), port)


def _residual(seed, tree_ref):
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(
        lambda a: (rng.standard_normal(np.shape(a)) * 1e-3).astype(
            np.float32), tree_ref)


def _port_layout(tree_ref):
    return {"embed": tree_ref["embed"], "zero": tree_ref["zero"],
            "scalar": tree_ref["scalar"],
            "layers": [{k: v[i] for k, v in tree_ref["layers"].items()}
                       for i in range(L)]}


def _same(got, want):
    g = tree_flatten(got)[0]
    w = tree_flatten(_port_layout(jax.tree.map(np.asarray, want)))[0]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_tree_stacks_groups_the_layer_list():
    _, port = _grads(0)
    groups = tree_stacks(port)
    leaves = tree_flatten(port)[0]
    assert sorted(i for idx, _ in groups for i in idx) == \
        list(range(len(leaves)))
    stacked = [(len(idx), depth) for idx, depth in groups]
    assert stacked.count((L, 1)) == 3 and stacked.count((1, 0)) == 3


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("with_err", [False, True], ids=["zero", "err"])
def test_int8_compress_is_the_references(seed, with_err):
    ref, port = _grads(seed)
    err_ref = _residual(seed, ref) if with_err else \
        jax.tree.map(np.zeros_like, ref)
    err_port = jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                            _port_layout(err_ref))
    want_g, want_e = JC.int8_compress(
        jax.tree.map(jnp.asarray, ref), jax.tree.map(jnp.asarray, err_ref))
    got_g, got_e = TC.int8_compress(port, err_port)
    _same(got_g, want_g)
    _same(got_e, want_e)
    assert float(got_g["scalar"]) == np.float32(0.7)


@pytest.mark.parametrize("frac", [0.1, 0.25, 0.5])
def test_topk_compress_is_the_references(frac):
    """Ties at the threshold are all kept, so a tensor may keep more
    than k elements, in both packages."""
    ref, port = _grads(3)
    err_ref = _residual(3, ref)
    err_port = jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                            _port_layout(err_ref))
    want_g, want_e = JC.topk_compress(
        jax.tree.map(jnp.asarray, ref), jax.tree.map(jnp.asarray, err_ref),
        frac=frac)
    got_g, got_e = TC.topk_compress(port, err_port, frac=frac)
    _same(got_g, want_g)
    _same(got_e, want_e)


def test_topk_keeps_every_tie():
    x = {"w": torch.tensor([3.0, 1.0, 3.0, 3.0, -3.0, 0.5])}
    g, e = TC.topk_compress(x, {"w": torch.zeros(6)}, frac=0.2)
    assert g["w"].tolist() == [3.0, 0.0, 3.0, 3.0, -3.0, 0.0]
    assert torch.equal(g["w"] + e["w"], x["w"])


def test_error_feedback_over_rounds_is_the_references():
    """Three rounds, each feeding its residual into the next."""
    ref, port = _grads(5)
    jerr = jax.tree.map(lambda a: jnp.zeros(np.shape(a), jnp.float32), ref)
    terr = jax.tree.map(lambda a: torch.zeros(a.shape), port)
    for r in range(3):
        ref_r, port_r = _grads(10 + r)
        jg, jerr = JC.int8_compress(jax.tree.map(jnp.asarray, ref_r), jerr)
        tg, terr = TC.int8_compress(port_r, terr)
        _same(tg, jg)
        _same(terr, jerr)


def test_all_zero_tensor_uses_scale_one():
    g, e = TC.int8_compress({"z": torch.zeros(5)}, {"z": torch.zeros(5)})
    assert torch.equal(g["z"], torch.zeros(5))
    assert torch.equal(e["z"], torch.zeros(5))


@pytest.mark.parametrize("scheme,frac", [("int8", 0.1), ("topk", 0.1),
                                         ("topk", 0.01), ("none", 0.1)])
def test_compression_ratio_is_the_references(scheme, frac):
    assert TC.compression_ratio(scheme, frac) == \
        JC.compression_ratio(scheme, frac)
