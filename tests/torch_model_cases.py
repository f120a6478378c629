"""Shared model parity checks of the port's family tests
(``test_torch_moe.py``, ``test_torch_mla.py``, ``test_torch_vlm_audio.py``,
``test_torch_rwkv.py``): both packages' models on one reduced config, the
port's parameters taken from the JAX package's draw through
``params_from_jax``, the same numpy tokens through both, beside seeded
numpy ``patches`` (VLM) or ``frames`` (audio) where the config has them.

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


def model_batch(cfg, rng, b, t):
    """Numpy inputs from ``rng``: (b, t) int32 tokens, then, where the
    config has them, (b, P, d) float32 ``patches`` or (b, n_frames, d)
    float32 ``frames``."""
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(
        np.int32)}
    if cfg.vlm is not None:
        batch["patches"] = rng.standard_normal(
            (b, cfg.vlm.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.encdec is not None:
        batch["frames"] = rng.standard_normal(
            (b, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)
    return batch


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


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
    """Prefill logits and every layer's cache (k/v, the MLA latent, SSM
    states, the RWKV shifts and S; audio's ``enc_out``), then STEPS decode
    steps' logits and the caches they wrote; the empty state's shapes."""
    jcfg, tcfg, jparams, tparams, seed = pair
    rng = np.random.default_rng(seed + 1)
    prompt = model_batch(jcfg, rng, B, PROMPT)
    jlog, jst = JM.forward_prefill(jcfg, jparams, as_jax(prompt),
                                   cache_capacity=CAP)
    tlog, tst = TM.forward_prefill(tcfg, tparams, as_torch(prompt),
                                   cache_capacity=CAP)
    assert tlog.shape == (B, tcfg.vocab_padded)
    close(tlog.numpy(), jlog, "prefill logits")

    def caches(what):
        want = per_layer({"layers": jax.tree.map(np.asarray, jst["layers"])},
                         tcfg.n_layers)["layers"]
        for i, (lc, wc) in enumerate(zip(tst["layers"], want)):
            got_l, got_s = tree_flatten(lc)
            want_l, want_s = tree_flatten(wc)
            assert got_s == want_s, f"{what}: layer {i} cache {got_s}"
            for j, (t, w) in enumerate(zip(got_l, want_l)):
                close(t.numpy(), w, f"{what}: layer {i} cache leaf {j}",
                      atol=CACHE_ATOL)
        assert ("enc_out" in tst) == ("enc_out" in jst)
        if "enc_out" in jst:
            close(tst["enc_out"].numpy(), jst["enc_out"], f"{what}: enc_out",
                  atol=CACHE_ATOL)

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
    jempty = jax.tree.map(np.asarray, JM.init_decode_state(
        jcfg, B, CAP, dtype=jnp.float32))
    got = [(tuple(t.shape), t.dtype) for t in tree_flatten(empty)[0]]
    want = [(w.shape, w.dtype) for w in tree_flatten(
        per_layer(jempty, tcfg.n_layers))[0]]
    assert [s for s, _ in got] == [s for s, _ in want]
    assert [str(d).split(".")[-1] for _, d in got] == \
        [str(d) for _, d in want]


def check_greedy(pair):
    """Both ServingEngines' greedy tokens are equal."""
    jcfg, tcfg, jparams, tparams, seed = pair
    rng = np.random.default_rng(seed + 2)
    prompt = model_batch(jcfg, rng, B, PROMPT)
    want = JaxServingEngine(jcfg, jparams, max_len=CAP,
                            dtype=jnp.float32).generate_greedy(
        as_jax(prompt), n_tokens=STEPS)
    eng = ServingEngine(tcfg, tparams, max_len=CAP, dtype=torch.float32,
                        device="cpu")
    got = eng.generate_greedy(prompt, n_tokens=STEPS)
    np.testing.assert_array_equal(got, np.asarray(want))
    n_prefix = 0 if tcfg.vlm is None else tcfg.vlm.n_patches
    assert int(eng.state["len"][0]) == n_prefix + PROMPT + STEPS


def check_train_grads(pair):
    """forward_train's loss and every gradient leaf (remat per layer)."""
    jcfg, tcfg, jparams, tparams, seed = pair
    rng = np.random.default_rng(seed + 3)
    batch = model_batch(jcfg, rng, TRAIN_B, TRAIN_S)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: JM.forward_train(
        jcfg, p, as_jax(batch))[0]))(jparams)
    leaves = [p.clone().requires_grad_() for p in tree_flatten(tparams)[0]]
    loss, aux = TM.forward_train(tcfg, tree_unflatten(tparams, leaves),
                                 as_torch(batch))
    n_prefix = 0 if tcfg.vlm is None else tcfg.vlm.n_patches
    assert aux["logits"].shape == (TRAIN_B, n_prefix + TRAIN_S,
                                   tcfg.vocab_padded)
    # unused leaves (an audio encoder layer's xattn) get zeros, as in JAX
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    close(float(loss.detach()), float(jloss), "loss")
    for i, (g, w) in enumerate(leaf_pairs(tree_unflatten(tparams,
                                                         list(grads)),
                                          jgrads, tcfg)):
        close(g, w, f"gradient leaf {i}")


def check_adamw_step(pair, n_micro=1):
    """One ``build_train_step`` step (f32 compute, weight decay on, the
    batch in ``n_micro`` microbatches) from the same state: loss, grad
    norm, the moments and the params."""
    jcfg, tcfg, jparams, _, seed = pair
    rng = np.random.default_rng(seed + 4)
    batch = model_batch(jcfg, rng, TRAIN_B, TRAIN_S)
    opt = dict(lr=LR, warmup_steps=1, total_steps=10, weight_decay=0.1)
    jstate = JO.adamw_init(jparams)
    tstate = train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate),
                                  device="cpu")
    jstate, jm = jax.jit(JS.build_train_step(
        jcfg, JO.AdamWConfig(**opt), n_micro=n_micro,
        compute_dtype=jnp.float32))(jstate, as_jax(batch))
    tstate, tm = TS.build_train_step(
        tcfg, TO.AdamWConfig(**opt), n_micro=n_micro,
        compute_dtype=torch.float32)(tstate, as_torch(batch))
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


def check_compressors(pair, scheme, seed):
    """int8 / top-k "per tensor" over the model's gradient tree: each of
    the reference's stacked leaves ((L, ...) under ``layers``, and
    ``enc_layers``'s own L axis) is one tensor (one int8 scale, one
    threshold); the port's per-layer leaves are grouped back to it
    (``fault.tree_stacks``): bitwise.  The gradients and residuals are
    numpy draws from ``seed``."""
    from repro.distributed import compression as JC
    from repro_torch.distributed import compression as TC

    _, tcfg, jparams, _, _ = pair
    rng = np.random.default_rng(seed)
    grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                    * rng.uniform(0.1, 10)).astype(
        np.float32), jax.tree.map(np.asarray, jparams))
    err = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-3
                                  ).astype(np.float32), grads)
    fn = {"int8": (JC.int8_compress, TC.int8_compress),
          "topk": (JC.topk_compress, TC.topk_compress)}[scheme]
    want = fn[0](jax.tree.map(jnp.asarray, grads),
                 jax.tree.map(jnp.asarray, err))
    got = fn[1](*(jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                               per_layer(t, tcfg.n_layers))
                  for t in (grads, err)))
    for g, w in zip(got, want):
        flat_g = tree_flatten(g)[0]
        flat_w = tree_flatten(per_layer(jax.tree.map(np.asarray, w),
                                        tcfg.n_layers))[0]
        assert len(flat_g) == len(flat_w)
        for a, b in zip(flat_g, flat_w):
            np.testing.assert_array_equal(a.numpy(), b)
