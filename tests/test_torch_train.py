"""Training, port against reference: the linear scan's gradient, the
training forward and its gradients, AdamW and the microbatched train
step, on the CPU in float32 (the training loops, checkpoint/resume and
the driver: ``tests/test_torch_train_loop.py``).

The same numpy inputs (the JAX package's parameters through
``params_from_jax`` / ``train_state_from_jax``, numpy tokens) go through
both packages.  Bars, each with its reason:

* scan gradient against ``jax.vjp`` of the reference's associative scan:
  rtol 1e-5 / atol 1e-6 (the port walks the recurrence in order, the
  reference brackets it as an associative scan);
* loss and every gradient leaf of ``forward_train``: rtol 1e-4 / atol
  1e-6 (the reference's SSM is an associative scan over 256-step chunks,
  the port's the sequential recurrence, and matrix products sum in
  another order; the reference's own kernel bar);
* three train steps (``test_train_steps_match_reference`` says how the
  carried trajectory and a step from the reference's own state are each
  held): loss and grad norm rtol 1e-4; params rtol 1e-4 / atol 1e-6
  (the same sums, then AdamW's division by sqrt(v), which turns a
  gradient that is ~0 against its rounding into a step of either sign:
  such an element may be off by 2 lr, see ``_close_params``).  With
  ``int8_compress`` an element next to a rounding boundary of its
  tensor's int8 grid may quantise to the neighbouring level in one
  package: its compressed gradient then moves by one quantisation step
  (``scale``), so the residual is held to one ``scale`` per element
  (``_close_residual``) and the param to 2 lr.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get as jax_get
from repro.configs import reduced as jax_reduced
from repro.distributed.compression import int8_compress as jax_int8
from repro.kernels.chunked_scan.ref import linear_scan_ref as jax_scan
from repro.models import model as JM
from repro.train import optimizer as JO
from repro.train import steps as JS
from repro_torch.configs import ARCHS, SHAPES, get, reduced
from repro_torch.distributed.compression import int8_compress
from repro_torch.distributed.fault import tree_flatten, tree_unflatten
from repro_torch.kernels import dispatch
from repro_torch.kernels.chunked_scan import linear_scan
from repro_torch.kernels.chunked_scan.ops import pad_to_chunk
from repro_torch.kernels.chunked_scan.ref import (linear_scan_bwd_ref,
                                                  linear_scan_ref)
from repro_torch.models import model as TM
from repro_torch.models import train_state_from_jax
from repro_torch.train import optimizer as TO
from repro_torch.train import steps as TS

B, S = 4, 20        # S > the reduced sliding window of 8

# (arch, layers): at 4 layers reduced hymba's layer 1 slides its window
CASES = [("hymba-1.5b", 4), ("llama3-8b", 2)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (restored after): the
    suite's parallel workers share the cores, and their thread pools
    fight over them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, n_layers):
    return (dataclasses.replace(jax_reduced(arch), n_layers=n_layers),
            dataclasses.replace(reduced(arch), n_layers=n_layers))


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}-L{n}" for a, n in CASES])
def model_pair(request):
    jcfg, tcfg = _cfgs(*request.param)
    jparams = jax.jit(lambda key: JM.init_params(jcfg, key, jnp.float32))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(sum(map(ord, jcfg.name)))
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, tcfg, jparams, tokens


def _per_layer(tree_np, cfg):
    """The reference's stacked (L, ...) leaves as the port's layout."""
    out = {k: v for k, v in tree_np.items() if k != "layers"}

    def unstack(t, i):
        if isinstance(t, dict):
            return {k: unstack(v, i) for k, v in t.items()}
        return t[i]

    out["layers"] = [unstack(tree_np["layers"], i)
                     for i in range(cfg.n_layers)]
    return out


def _pairs(port_tree, jax_tree, cfg):
    """(name, port array, reference array) for every leaf."""
    got = tree_flatten(port_tree)[0]
    want = tree_flatten(_per_layer(jax.tree.map(np.asarray, jax_tree),
                                   cfg))[0]
    names = [f"leaf {i}" for i in range(len(got))]
    assert len(got) == len(want)
    return [(n, g.detach().numpy() if isinstance(g, torch.Tensor) else g,
             np.asarray(w)) for n, g, w in zip(names, got, want)]


# ------------------------------------------------------------ scan gradient


def _scan_inputs(b, t, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.3, 1.0, (b, t, d)).astype(np.float32),
            rng.standard_normal((b, t, d)).astype(np.float32),
            rng.standard_normal((b, t, d)).astype(np.float32))


@pytest.mark.parametrize("b,t,d", [(1, 64, 8), (2, 300, 32), (3, 129, 5),
                                   (2, 1, 4), (1, 1000, 3)])
def test_scan_bwd_ref_matches_jax_vjp(b, t, d):
    """``linear_scan_bwd_ref`` against ``jax.vjp`` of the reference's
    associative scan, and the op's autograd (plain route, T not a
    multiple of the chunk) bitwise the plain backward."""
    a, x, g = _scan_inputs(b, t, d, t * 7 + d)
    y, vjp = jax.vjp(jax_scan, jnp.asarray(a), jnp.asarray(x))
    jda, jdb = vjp(jnp.asarray(g))
    ta, tx = (torch.from_numpy(v) for v in (a, x))
    da, db = linear_scan_bwd_ref(ta, linear_scan_ref(ta, tx),
                                 torch.from_numpy(g))
    np.testing.assert_allclose(da.numpy(), jda, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(db.numpy(), jdb, rtol=1e-5, atol=1e-6)
    assert bool((da[:, 0] == 0).all())

    ta.requires_grad_()
    tx.requires_grad_()
    out = linear_scan(ta, tx)
    out.backward(torch.from_numpy(g))
    assert torch.equal(ta.grad, da) and torch.equal(tx.grad, db)


def test_scan_bwd_ref_is_the_two_rounding_recurrence():
    """Bitwise against the backward recurrence written out in numpy
    float32, one multiply and one add per step."""
    a, x, g = _scan_inputs(2, 37, 6, 5)
    y = linear_scan_ref(torch.from_numpy(a), torch.from_numpy(x)).numpy()
    lam = g[:, -1].copy()
    want_db = np.empty_like(g)
    want_da = np.zeros_like(g)
    want_db[:, -1] = lam
    want_da[:, -1] = lam * y[:, -2]
    for t in range(35, -1, -1):
        lam = g[:, t] + a[:, t + 1] * lam
        want_db[:, t] = lam
        if t:
            want_da[:, t] = lam * y[:, t - 1]
    da, db = linear_scan_bwd_ref(*(torch.from_numpy(v) for v in (a, y, g)))
    np.testing.assert_array_equal(db.numpy(), want_db)
    np.testing.assert_array_equal(da.numpy(), want_da)


class _Scan64(torch.autograd.Function):
    """The plain forward and backward in float64, for gradcheck."""

    @staticmethod
    def forward(ctx, a, b):
        y = linear_scan_ref(a, b, dtype=torch.float64)
        ctx.save_for_backward(a, y)
        return y

    @staticmethod
    def backward(ctx, g):
        a, y = ctx.saved_tensors
        return linear_scan_bwd_ref(a, y, g, dtype=torch.float64)


@pytest.mark.parametrize("t", [1, 2, 9])
def test_scan_bwd_ref_gradcheck_float64(t):
    gen = torch.Generator().manual_seed(t)
    a = (torch.rand((2, t, 3), generator=gen, dtype=torch.float64) * 0.7
         + 0.3).requires_grad_()
    b = torch.randn((2, t, 3), generator=gen,
                    dtype=torch.float64).requires_grad_()
    assert torch.autograd.gradcheck(_Scan64.apply, (a, b))


@pytest.mark.parametrize("t,chunk", [(100, 128), (129, 64), (5, 16)])
def test_scan_bwd_padding_is_cut_off(t, chunk):
    """The kernel route's padding (a = 1, b = 0, gradient 0): the padded
    backward's first T steps are bitwise the unpadded backward."""
    a, x, g = (torch.from_numpy(v) for v in _scan_inputs(2, t, 4, t))
    ap, xp = pad_to_chunk(a, x, chunk)
    gp = torch.cat([g, torch.zeros((2, ap.shape[1] - t, 4))], dim=1)
    want = linear_scan_bwd_ref(a, linear_scan_ref(a, x), g)
    got = linear_scan_bwd_ref(ap, linear_scan_ref(ap, xp), gp)
    for w, p in zip(want, got):
        assert torch.equal(p[:, :t], w)


def test_scan_kernel_route_raises_on_the_cpu_under_autograd():
    a, x, _ = (torch.from_numpy(v).requires_grad_()
               for v in _scan_inputs(1, 8, 2, 0))
    with pytest.raises(dispatch.KernelUnsupportedError):
        linear_scan(a, x, use_kernel=True)


# -------------------------------------------------------------------- model


def _jax_loss_grads(jcfg, jparams, tokens):
    def loss_of(p):
        return JM.forward_train(jcfg, p, {"tokens": jnp.asarray(tokens)})[0]

    return jax.jit(jax.value_and_grad(loss_of))(jparams)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_forward_train_loss_and_grads_match_reference(model_pair, remat):
    jcfg, tcfg, jparams, tokens = model_pair
    jloss, jgrads = _jax_loss_grads(jcfg, jparams, tokens)
    tparams = TM.params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                                 device="cpu")
    leaves = tree_flatten(tparams)[0]
    for p in leaves:
        p.requires_grad_()
    loss, aux = TM.forward_train(tcfg, tparams,
                                 {"tokens": torch.from_numpy(tokens)},
                                 remat=remat)
    assert aux["logits"].shape == (B, S, tcfg.vocab_padded)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    for name, got, want in _pairs(tree_unflatten(tparams, list(grads)),
                                  jgrads, jcfg):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_remat_changes_no_bit(model_pair):
    """Rematerialisation recomputes the same ops: loss and gradients
    bitwise those of the plain layer loop."""
    _, tcfg, jparams, tokens = model_pair
    out = []
    for remat in (True, False):
        tparams = TM.params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                                     device="cpu")
        leaves = tree_flatten(tparams)[0]
        for p in leaves:
            p.requires_grad_()
        loss, _ = TM.forward_train(tcfg, tparams,
                                   {"tokens": torch.from_numpy(tokens)},
                                   remat=remat)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_loss_fn_masks_padded_vocab_like_reference():
    """Padded vocabulary columns hold huge logits: both losses ignore
    them; a label mask with zeros divides by its own count."""
    jcfg, tcfg = _cfgs("llama3-8b", 2)
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 7, tcfg.vocab_padded)).astype(
        np.float32)
    logits[..., tcfg.vocab_size:] = 1e4
    tokens = rng.integers(0, tcfg.vocab_size, (2, 7)).astype(np.int32)
    mask = rng.random((2, 7)) < 0.6
    want = JM.loss_fn(jcfg, jnp.asarray(logits), jnp.asarray(tokens),
                      jnp.asarray(mask))
    got = TM.loss_fn(tcfg, torch.from_numpy(logits),
                     torch.from_numpy(tokens), torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert 0 < float(got) < 20


def test_model_input_spec_matches_reference():
    """Every arch of the registry, every shape cell: names, shapes and
    dtypes (int32 tokens, bf16 VLM ``patches`` / audio ``frames``)."""
    for name in ARCHS:
        for shape in SHAPES:
            got = TM.model_input_spec(get(name), SHAPES[shape])
            want = JM.model_input_spec(jax_get(name), JAX_SHAPES[shape])
            assert got.keys() == want.keys()
            for k, (shp, dtype) in got.items():
                assert shp == want[k].shape
                assert str(dtype).split(".")[-1] == str(want[k].dtype)
            assert TS.train_batch_spec(get(name), SHAPES[shape]) == got


# ---------------------------------------------------------------- optimizer


def test_schedule_and_default_n_micro_match_reference():
    cfg = TO.AdamWConfig(lr=2e-3, warmup_steps=7, total_steps=40)
    jcfg = JO.AdamWConfig(lr=2e-3, warmup_steps=7, total_steps=40)
    for step in (0, 1, 3, 7, 8, 20, 40, 55):
        got = TO._schedule(cfg, torch.tensor(float(step)))
        want = JO._schedule(jcfg, jnp.float32(step))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for name in ARCHS:
        for shape in SHAPES:
            assert TS.default_n_micro(get(name), SHAPES[shape]) == \
                JS.default_n_micro(jax_get(name), JAX_SHAPES[shape])


def test_adamw_update_decays_like_the_stacked_reference(model_pair):
    """One update from a state with nonzero moments: a per-layer leaf
    counts the reference's stacked L axis (norm scales decay, 0-d mixing
    weights and top-level vectors do not)."""
    jcfg, tcfg, jparams, _ = model_pair
    rng = np.random.default_rng(5)

    def like(p):
        return rng.standard_normal(np.shape(p)).astype(np.float32)

    jstate = JO.adamw_init(jparams)
    jstate = jstate._replace(
        step=jnp.int32(3), mu=jax.tree.map(like, jstate.mu),
        nu=jax.tree.map(lambda p: np.abs(like(p)), jstate.nu))
    grads = jax.tree.map(like, jparams)
    opt = dict(lr=1e-2, weight_decay=0.5, warmup_steps=2, total_steps=10)
    want = JO.adamw_update(jstate, grads, JO.AdamWConfig(**opt))
    tstate = train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate),
                                  device="cpu")
    tgrads = TM.params_from_jax(tcfg, jax.tree.map(np.asarray, grads),
                                device="cpu")
    got = TO.adamw_update(tstate, tgrads, TO.AdamWConfig(**opt))
    assert int(got.step) == int(want.step) == 4
    for field in ("params", "mu", "nu"):
        for name, g, w in _pairs(getattr(got, field), getattr(want, field),
                                 jcfg):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{field} {name}")
    np.testing.assert_allclose(float(TO.global_norm(tgrads)),
                               float(JO.global_norm(grads)), rtol=1e-6)


# --------------------------------------------------------------- train step


def _close_params(got, want, lr, what):
    """rtol 1e-4 / atol 1e-6 per element, except where Adam's normalised
    step amplifies a gradient that is ~0 against its rounding (its sign,
    or an int8 level, went the other way): such an element may be off by
    up to one step each way (2 lr), and at most 0.1% of the elements may
    be."""
    miss = ~np.isclose(got, want, rtol=1e-4, atol=1e-6)
    if miss.any():
        assert np.abs(got - want)[miss].max() <= 2 * lr, what
        assert miss.mean() <= 0.001, (what, miss.mean())


def _close_residual(got, want, what):
    """The int8 residual x - QDQ(x) is at most half a quantisation step,
    so 2 max|residual| over the leaf is at most one step (``scale``) and
    reaches it where a level went the other way: each element within
    that, and at most 1% of them off the rtol 1e-4 / atol 1e-6 bar."""
    step = 2 * max(np.abs(got).max(), np.abs(want).max()) * (1 + 1e-6)
    assert np.abs(got - want).max() <= step + 1e-12, what
    miss = ~np.isclose(got, want, rtol=1e-4, atol=1e-6)
    assert miss.mean() <= 0.01, (what, miss.mean())


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("compress", [False, True],
                         ids=["plain", "int8"])
def test_train_steps_match_reference(model_pair, n_micro, compress):
    """Three steps on both packages from one state.  After each, the
    port's carried state and one port step from the reference's state
    before it: loss, grad norm and step of both; the params of the
    synced step at ``_close_params`` (and the residual at
    ``_close_residual``); the carried params, whose small differences
    feed back into the next step's gradients and through Adam's
    normalisation, within 2 lr per step taken, and the carried grad norm
    at rtol 1e-3 (the norm of gradients taken at params that already
    differ by up to that; measured up to 1.5e-4 with int8, 2e-5
    without)."""
    jcfg, tcfg, jparams, tokens = model_pair
    opt = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1)
    jstep = jax.jit(JS.build_train_step(
        jcfg, JO.AdamWConfig(**opt), n_micro=n_micro,
        compress=jax_int8 if compress else None,
        compute_dtype=jnp.float32))
    tstep = TS.build_train_step(
        tcfg, TO.AdamWConfig(**opt), n_micro=n_micro,
        compress=int8_compress if compress else None,
        compute_dtype=torch.float32)
    jstate = JO.adamw_init(jparams, with_compression=compress)
    tstate = train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate),
                                  device="cpu")
    rng = np.random.default_rng(9)
    for step in range(3):
        batch = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
        synced = train_state_from_jax(
            tcfg, jax.tree.map(np.asarray, jstate), device="cpu")
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(batch)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(batch)})
        synced, sm = tstep(synced, {"tokens": torch.from_numpy(batch)})
        for m, norm_rtol in ((sm, 1e-4), (tm, 1e-3)):
            assert int(m["step"]) == int(jm["step"]) == step + 1
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                       rtol=1e-4)
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(jm["grad_norm"]),
                                       rtol=norm_rtol)
        for name, g, w in _pairs(synced.params, jstate.params, jcfg):
            _close_params(g, w, opt["lr"], f"step {step} {name}")
        for name, g, w in _pairs(tstate.params, jstate.params, jcfg):
            assert np.abs(g - w).max() <= 2 * opt["lr"] * (step + 1), name
        if compress:
            for name, g, w in _pairs(synced.compress_err,
                                     jstate.compress_err, jcfg):
                _close_residual(g, w, f"step {step} residual {name}")
