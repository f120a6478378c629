"""Shared model parity checks of the port's family tests
(``test_torch_moe.py``, ``test_torch_mla.py``): both packages' models on
one reduced config, the port's parameters taken from the JAX package's
draw through ``params_from_jax``, the same numpy tokens through both.

Bars (those ``tests/test_torch_train.py`` states): rtol 1e-4 / atol 1e-6
on logits, the loss and every gradient leaf (caches: atol 1e-5, see
``CACHE_ATOL``), and after one AdamW
step on the moments; a param after that step at the same bar except
where Adam's normalised step turns a gradient that is ~0 against its
rounding into a step of either sign: such an element must have a first
moment within the moments' atol of 0 in the reference, and may be off by
up to 2 lr.  Greedy tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import reduced as jax_reduced
from repro.models import model as JM
from repro.serve.engine import ServingEngine as JaxServingEngine
from repro.train import optimizer as JO
from repro.train import steps as JS
from repro_torch.configs import reduced
from repro_torch.distributed.fault import tree_flatten, tree_unflatten
from repro_torch.models import model as TM
from repro_torch.models import train_state_from_jax
from repro_torch.serve.engine import ServingEngine
from repro_torch.train import optimizer as TO
from repro_torch.train import steps as TS

from torch_port_cases import per_layer

RTOL, ATOL = 1e-4, 1e-6
# caches hold O(1) values: an element that a sum cancels to near 0 keeps
# an absolute error of a few float32 ulps of its summands (2.6e-6 seen)
CACHE_ATOL = 1e-5
B, PROMPT, STEPS, CAP = 2, 12, 4, 32
TRAIN_B, TRAIN_S = 4, 20
LR = 1e-2


def make_pair(arch, **replace):
    """(jax cfg, port cfg, jax params, port params, seed) for
    ``reduced(arch)`` with ``replace`` applied to both configs; each
    check draws its data from its own generator on that seed."""
    jcfg = dataclasses.replace(jax_reduced(arch), **replace)
    tcfg = dataclasses.replace(reduced(arch), **replace)
    jparams = jax.jit(lambda key: JM.init_params(jcfg, key, jnp.float32))(
        jax.random.PRNGKey(0))
    tparams = TM.params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                                 device="cpu")
    return jcfg, tcfg, jparams, tparams, sum(map(ord, jcfg.name))


def close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def leaf_pairs(port_tree, jax_tree, cfg):
    """(port array, reference array) for every leaf, in the port's order."""
    got = tree_flatten(port_tree)[0]
    want = tree_flatten(per_layer(jax.tree.map(np.asarray, jax_tree),
                                  cfg.n_layers))[0]
    assert len(got) == len(want)
    return [(g.detach().numpy(), np.asarray(w)) for g, w in zip(got, want)]


def check_params(pair):
    """params_from_jax unstacks the L axis leaf for leaf (an MoE leaf is
    (L, E, d, f) in the reference); init_params draws the same shapes
    and dtypes."""
    jcfg, tcfg, jparams, tparams, _ = pair
    for g, w in leaf_pairs(tparams, jparams, tcfg):
        np.testing.assert_array_equal(g, w)
    fresh = TM.init_params(tcfg, torch.Generator().manual_seed(1),
                           dtype=torch.float32, device="cpu")
    assert [(tuple(t.shape), t.dtype) for t in tree_flatten(fresh)[0]] == \
        [(tuple(t.shape), t.dtype) for t in tree_flatten(tparams)[0]]
    assert tree_flatten(fresh)[1] == tree_flatten(tparams)[1]


def check_prefill_decode(pair):
    """Prefill logits and every layer's cache, then STEPS decode steps'
    logits and the caches they wrote; the empty state's cache shapes."""
    jcfg, tcfg, jparams, tparams, seed = pair
    rng = np.random.default_rng(seed + 1)
    prompt = rng.integers(0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    jlog, jst = JM.forward_prefill(jcfg, jparams,
                                   {"tokens": jnp.asarray(prompt)},
                                   cache_capacity=CAP)
    tlog, tst = TM.forward_prefill(tcfg, tparams,
                                   {"tokens": torch.from_numpy(prompt)},
                                   cache_capacity=CAP)
    assert tlog.shape == (B, tcfg.vocab_padded)
    close(tlog.numpy(), jlog, "prefill logits")

    def caches(what):
        for i, lc in enumerate(tst["layers"]):
            assert lc["attn"].keys() == jst["layers"]["attn"].keys()
            for name, t in lc["attn"].items():
                close(t.numpy(), np.asarray(jst["layers"]["attn"][name][i]),
                      f"{what}: layer {i} cache {name}", atol=CACHE_ATOL)

    caches("prefill")
    decode = jax.jit(lambda p, s, t: JM.decode_step(jcfg, p, s, t))
    for t in range(STEPS):
        tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        jlog, jst = decode(jparams, jst, jnp.asarray(tok))
        tlog, tst = TM.decode_step(tcfg, tparams, tst, torch.from_numpy(tok))
        close(tlog.numpy(), jlog, f"decode step {t}")
    np.testing.assert_array_equal(tst["len"].numpy(), jst["len"])
    caches("decode")
    empty = TM.init_decode_state(tcfg, B, CAP, dtype=torch.float32,
                                 device="cpu")
    jempty = JM.init_decode_state(jcfg, B, CAP, dtype=jnp.float32)
    for name, t in empty["layers"][0]["attn"].items():
        assert tuple(t.shape) == jempty["layers"]["attn"][name].shape[1:]


def check_greedy(pair):
    """Both ServingEngines' greedy tokens are equal."""
    jcfg, tcfg, jparams, tparams, seed = pair
    rng = np.random.default_rng(seed + 2)
    prompt = rng.integers(0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    want = JaxServingEngine(jcfg, jparams, max_len=CAP,
                            dtype=jnp.float32).generate_greedy(
        {"tokens": jnp.asarray(prompt)}, n_tokens=STEPS)
    eng = ServingEngine(tcfg, tparams, max_len=CAP, dtype=torch.float32,
                        device="cpu")
    got = eng.generate_greedy({"tokens": prompt}, n_tokens=STEPS)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert int(eng.state["len"][0]) == PROMPT + STEPS


def check_train_grads(pair):
    """forward_train's loss and every gradient leaf (remat per layer)."""
    jcfg, tcfg, jparams, tparams, seed = pair
    rng = np.random.default_rng(seed + 3)
    tokens = rng.integers(0, jcfg.vocab_size,
                          (TRAIN_B, TRAIN_S)).astype(np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: JM.forward_train(
        jcfg, p, {"tokens": jnp.asarray(tokens)})[0]))(jparams)
    leaves = [p.clone().requires_grad_() for p in tree_flatten(tparams)[0]]
    loss, aux = TM.forward_train(tcfg, tree_unflatten(tparams, leaves),
                                 {"tokens": torch.from_numpy(tokens)})
    assert aux["logits"].shape == (TRAIN_B, TRAIN_S, tcfg.vocab_padded)
    grads = torch.autograd.grad(loss, leaves)
    close(float(loss.detach()), float(jloss), "loss")
    for i, (g, w) in enumerate(leaf_pairs(tree_unflatten(tparams,
                                                         list(grads)),
                                          jgrads, tcfg)):
        close(g, w, f"gradient leaf {i}")


def check_adamw_step(pair):
    """One ``build_train_step`` step (f32 compute, weight decay on) from
    the same state: loss, grad norm, the moments and the params."""
    jcfg, tcfg, jparams, _, seed = pair
    rng = np.random.default_rng(seed + 4)
    tokens = rng.integers(0, jcfg.vocab_size,
                          (TRAIN_B, TRAIN_S)).astype(np.int32)
    opt = dict(lr=LR, warmup_steps=1, total_steps=10, weight_decay=0.1)
    jstate = JO.adamw_init(jparams)
    tstate = train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate),
                                  device="cpu")
    jstate, jm = jax.jit(JS.build_train_step(
        jcfg, JO.AdamWConfig(**opt), compute_dtype=jnp.float32))(
        jstate, {"tokens": jnp.asarray(tokens)})
    tstate, tm = TS.build_train_step(
        tcfg, TO.AdamWConfig(**opt), compute_dtype=torch.float32)(
        tstate, {"tokens": torch.from_numpy(tokens)})
    assert int(tm["step"]) == int(jm["step"]) == 1
    close(float(tm["loss"]), float(jm["loss"]), "loss")
    close(float(tm["grad_norm"]), float(jm["grad_norm"]), "grad norm")
    for field in ("mu", "nu"):
        for i, (g, w) in enumerate(leaf_pairs(getattr(tstate, field),
                                              getattr(jstate, field), tcfg)):
            close(g, w, f"{field} leaf {i}")
    mu = leaf_pairs(tstate.mu, jstate.mu, tcfg)
    for i, ((g, w), (_, m)) in enumerate(zip(
            leaf_pairs(tstate.params, jstate.params, tcfg), mu)):
        miss = ~np.isclose(g, w, rtol=RTOL, atol=ATOL)
        if miss.any():
            assert np.abs(g - w)[miss].max() <= 2 * LR, f"param leaf {i}"
            assert np.abs(m[miss]).max() <= ATOL, f"param leaf {i}"
