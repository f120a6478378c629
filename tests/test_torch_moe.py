"""The MoE family, port against reference, on the CPU in float32:
``reduced("qwen2-moe-a2.7b")`` (shared experts) and
``reduced("dbrx-132b")`` (no shared experts), and the MoE layer alone.

The JAX package's parameters go through ``params_from_jax``; data are
numpy draws from a seed.  Bars: the routed expert indices equal, ties
included; everything else at rtol 1e-4 / atol 1e-6 (the bars of
``tests/test_torch_train.py``; ``torch_model_cases`` says how caches
(atol 1e-5) and a param
after an AdamW step is held): the layer's output with and without
dropped tokens, prefill logits and caches, decode steps, the training
loss and every gradient leaf, one AdamW step.  Greedy tokens equal; two
runs of the layer bitwise equal (the combine has no float atomics).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.configs import reduced as jax_reduced
from repro.models import layers as JL
from repro_torch.configs import get, reduced
from repro_torch.models import layers as TL

import torch_model_cases as cases

ARCHS = ["qwen2-moe-a2.7b", "dbrx-132b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return cases.make_pair(request.param)


def test_params_from_jax_and_init_shapes(pair):
    cases.check_params(pair)


def test_prefill_and_decode_match_reference(pair):
    cases.check_prefill_decode(pair)


def test_generate_greedy_tokens_equal(pair):
    cases.check_greedy(pair)


def test_forward_train_loss_and_grads_match_reference(pair):
    cases.check_train_grads(pair)


def test_adamw_step_matches_reference(pair):
    cases.check_adamw_step(pair)


# ---------------------------------------------------------------- the layer


def _layer(arch, capacity_factor, seed=0):
    """The reference's MoE layer params (and the config with the given
    capacity factor) as numpy, for both packages."""
    jcfg = jax_reduced(arch)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=capacity_factor))
    tcfg = dataclasses.replace(reduced(arch), moe=dataclasses.replace(
        reduced(arch).moe, capacity_factor=capacity_factor))
    p = jax.tree.map(np.array, JL.init_moe(jax.random.PRNGKey(seed), jcfg,
                                           jnp.float32))
    return jcfg, tcfg, p, {k: torch.from_numpy(v) for k, v in p.items()}


def _reference_route(p, x, cfg):
    """The reference's routing lines (``repro/models/layers.py``
    ``moe_forward``): float32 logits, padded experts at -1e30,
    ``lax.top_k``, softmax."""
    e = cfg.moe
    logits = jnp.einsum("nd,de->ne", jnp.asarray(x, jnp.float32),
                        jnp.asarray(p["router"], jnp.float32))
    if e.n_experts_padded > e.n_experts:
        pad = jnp.arange(e.n_experts_padded) >= e.n_experts
        logits = jnp.where(pad[None, :], -1e30, logits)
    top_w, top_i = jax.lax.top_k(logits, e.top_k)
    return np.asarray(jax.nn.softmax(top_w, axis=-1)), np.asarray(top_i)


@pytest.mark.parametrize("router", ["random", "zero", "tied-columns"])
@pytest.mark.parametrize("arch", ARCHS)
def test_routed_experts_equal_the_reference(arch, router):
    """Equal expert indices, in order, and weights at rtol 1e-4 / atol
    1e-6.  ``zero``: every logit ties (the lower index wins, as in
    ``lax.top_k``; ``torch.topk`` breaks such ties otherwise);
    ``tied-columns``: pairs of experts with the same router column."""
    jcfg, tcfg, p, tp = _layer(arch, 1.25)
    ep = jcfg.moe.n_experts_padded
    if router == "zero":
        p["router"] = np.zeros_like(p["router"])
    elif router == "tied-columns":
        p["router"][:, 1::2] = p["router"][:, 0:ep - 1:2]
    tp["router"] = torch.from_numpy(p["router"])
    x = np.random.default_rng(3).standard_normal(
        (37, jcfg.d_model)).astype(np.float32)
    want_w, want_i = _reference_route(p, x, jcfg)
    got_w, got_i = TL.moe_route(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    cases.close(got_w.numpy(), want_w, "routing weights")


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5, 4.0],
                         ids=["default", "dropping", "roomy"])
@pytest.mark.parametrize("shape", [(3, 16), (5, 1)], ids=["prefill",
                                                          "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_reference(arch, shape, capacity_factor):
    """The layer on the same tokens, where the capacity drops some
    (token, expert) pairs and where it drops none."""
    jcfg, tcfg, p, tp = _layer(arch, capacity_factor, seed=1)
    x = np.random.default_rng(sum(shape)).standard_normal(
        shape + (jcfg.d_model,)).astype(np.float32)
    want = JL.moe_forward(p, jnp.asarray(x), jcfg)
    got = TL.moe_forward(tp, torch.from_numpy(x), tcfg)
    cases.close(got.numpy(), want, "moe_forward")


def test_capacity_drops_tokens_at_decode():
    """The capacity from the unpadded expert count: qwen2-moe-a2.7b (60
    experts, 64 allocated) has 683 slots per expert at a prefill of
    8 x 1,024 tokens and 1 at a decode of 8, where the reference drops
    tokens too."""
    moe = get("qwen2-moe-a2.7b").moe
    assert moe.n_experts_padded == 64 == jax_get("qwen2-moe-a2.7b").moe \
        .n_experts_padded
    assert TL.moe_capacity(moe, 8 * 1024) == 683
    assert TL.moe_capacity(moe, 8) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_moe_forward_twice_is_bitwise(dtype):
    """No float atomics in the combine: two runs give the same bits."""
    _, tcfg, _, tp = _layer("qwen2-moe-a2.7b", 1.25)
    tp = {k: v.to(dtype) for k, v in tp.items()}
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (4, 9, tcfg.d_model)).astype(np.float32)).to(dtype)
    a = TL.moe_forward(tp, x, tcfg)
    b = TL.moe_forward(tp, x, tcfg)
    assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.parametrize("scheme", ["int8", "topk"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "minicpm3-4b"])
def test_compressors_group_moe_and_mla_leaves_like_the_reference(arch,
                                                                 scheme):
    """int8 / top-k "per tensor" over the model's gradient tree: the
    reference's (L, E, d, f) expert leaves and (L, ...) MLA leaves are
    one tensor each (one int8 scale, one threshold), the port's per-layer
    leaves are grouped back to them (``fault.tree_stacks``): bitwise."""
    cases.check_compressors(cases.make_pair(arch), scheme, len(arch))
