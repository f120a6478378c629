"""Training on weights in pieces: the train step on a state placed by
``param_pspecs`` (``distributed.sharding.device_put``), port against
reference, on CPU meshes (1, 4) and (2, 2) of CPU entries, in float32.

The state is the reference's train cell (``launch/dryrun.py``):
``TrainState(step=P(), params=p_specs, mu=p_specs, nu=p_specs,
compress_err=P())`` with ``p_specs = param_pspecs(cfg, params, mesh,
strategy=...)``, placed by ``device_put(state, named_shardings(...))``
and stepped by ``build_train_step(cfg, n_micro, dp_axes=("data",),
mesh=mesh)`` as it is.  Reduced llama3-8b, qwen2-moe-a2.7b and
hymba-1.5b, 2 layers (8 heads and 4 KV heads where the family has GQA
groups, so that four entries split the KV heads and the head route
runs), params and tokens drawn by numpy from a seed and carried across
by ``train_state_from_jax``; one and two microbatches:

* megatron on (1, 4): heads, MLP widths, experts and the vocabulary
  split four ways, one data block; megatron on (2, 2) with two data
  blocks, each on its row's pieces; megatron_zero on (2, 2), whose layer
  leaves the ``data`` axis splits as well (gathered for their layer);
* one step against the reference's ``build_train_step`` step from the
  same state and against the port's one-device step: loss and grad norm
  at rtol 1e-4, params / ``mu`` / ``nu`` at ``tests/test_torch_train.py``'s
  ``_close_params``;
* after the step every leaf is the same ``Placed`` in the same sharding,
  the bytes per entry unchanged (= ``per_device_bytes``), replicas
  bitwise equal, and a second run from the same state bitwise the first;
* qwen2-moe-a2.7b on (2, 2) routes each data block as part of its
  microbatch (its kept pairs: ``tests/test_torch_train_moe_dp.py``;
  compression on a placed state: the ``_compression`` file beside this);
* the backward of the splits: ``spread`` sums the cards' gradients in
  entry order, ``row_sum`` hands each card the output gradient, the
  vocab-parallel embedding's and logits' gradients are the unsharded
  gradient's slices, and ``gather`` carries the gradient to the pieces
  it read.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.models import model as JM
from repro.train import optimizer as JO
from repro.train import steps as JS
from repro_torch.configs import reduced
from repro_torch.distributed.fault import tree_flatten, tree_map
from repro_torch.distributed.sharding import (Mesh, NamedSharding,
                                              PartitionSpec as P, Placed,
                                              blocks, device_put,
                                              entry_bytes, gather,
                                              named_shardings, param_pspecs,
                                              per_device_bytes)
from repro_torch.models import tensor_parallel as tp
from repro_torch.models import train_state_from_jax
from repro_torch.train import optimizer as TO
from repro_torch.train import steps as TS

from test_torch_train import _close_params, _pairs

B, S = 4, 16          # S > the reduced sliding window of 8
CPU = torch.device("cpu")
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1)
ARCHS = ["llama3-8b", "qwen2-moe-a2.7b", "hymba-1.5b"]
# case: (strategy, mesh shape, data axes of the step)
CASES = {"megatron-1x4": ("megatron", (1, 4), ("data",)),
         "megatron-2x2": ("megatron", (2, 2), ("data",)),
         "megatron_zero-2x2": ("megatron_zero", (2, 2), ("data",))}
_CACHE = {}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (restored after): the
    suite's parallel workers share the cores, and their thread pools
    fight over them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    return Mesh(np.full(shape, CPU, dtype=object), ("data", "model"))


def _cfgs(arch):
    kw = dict(n_layers=2)
    if arch != "qwen2-moe-a2.7b":                 # GQA groups: 8 / 4
        kw.update(n_heads=8, n_kv_heads=4)
    return (dataclasses.replace(jax_reduced(arch), **kw),
            dataclasses.replace(reduced(arch), **kw))


def _np_params(jcfg, seed):
    """The reference's parameter tree drawn by numpy: norms 1 + 0.1 N,
    hymba's ``log_a`` -exp(N / 2) and ``b_dt`` -4 + 0.1 N, the other
    vectors and scalars 0.1 N, every matrix N / sqrt(its second-to-last
    dimension)."""
    shapes = jax.eval_shape(lambda: JM.init_params(
        jcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(s.shape)
        stacked = "layers" in name
        if "norm" in name:
            x = 1 + 0.1 * x
        elif "log_a" in name:
            x = -np.exp(0.5 * x)
        elif "b_dt" in name:
            x = -4 + 0.1 * x
        elif len(s.shape) - stacked < 2:
            x = 0.1 * x
        else:
            x = x * s.shape[-2] ** -0.5
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _ctx(arch):
    """Configs, the reference's initial state (numpy) and the tokens."""
    if arch not in _CACHE:
        jcfg, tcfg = _cfgs(arch)
        params = _np_params(jcfg, sum(map(ord, arch)))
        state = jax.tree.map(np.asarray, JO.adamw_init(
            jax.tree.map(jnp.asarray, params)))
        tokens = np.random.default_rng(len(arch)).integers(
            0, jcfg.vocab_size, (B, S)).astype(np.int32)
        _CACHE[arch] = dict(jcfg=jcfg, tcfg=tcfg, state=state,
                            tokens=tokens, steps={})
    return _CACHE[arch]


def _reference_and_one_device(ctx, n_micro):
    """The reference's step and the port's one-device step from the
    context's state (each computed once per microbatch count)."""
    if n_micro not in ctx["steps"]:
        jcfg, tcfg = ctx["jcfg"], ctx["tcfg"]
        jnew, jm = jax.jit(JS.build_train_step(
            jcfg, JO.AdamWConfig(**OPT), n_micro=n_micro,
            compute_dtype=jnp.float32))(
            jax.tree.map(jnp.asarray, ctx["state"]),
            {"tokens": jnp.asarray(ctx["tokens"])})
        one, om = TS.build_train_step(
            tcfg, TO.AdamWConfig(**OPT), n_micro=n_micro,
            compute_dtype=torch.float32)(
            train_state_from_jax(tcfg, ctx["state"], device="cpu"),
            {"tokens": torch.from_numpy(ctx["tokens"])})
        ctx["steps"][n_micro] = (jnew, jm, one, om)
    return ctx["steps"][n_micro]


def _placed_state(ctx, mesh, strategy):
    """The reference cell's state specs over the port's state, and the
    state placed by them."""
    state = train_state_from_jax(ctx["tcfg"], ctx["state"], device="cpu")
    p_specs = param_pspecs(ctx["tcfg"], state.params, mesh,
                           strategy=strategy)
    specs = TO.TrainState(step=P(), params=p_specs, mu=p_specs, nu=p_specs,
                          compress_err=tree_map(lambda _: P(),
                                                state.compress_err))
    return device_put(state, named_shardings(specs, mesh)), specs, state


def _step(ctx, n_micro, mesh, dp_axes, state):
    return TS.build_train_step(ctx["tcfg"], TO.AdamWConfig(**OPT),
                               n_micro=n_micro, compute_dtype=torch.float32,
                               dp_axes=dp_axes, mesh=mesh)(
        state, {"tokens": torch.from_numpy(ctx["tokens"])})


def _whole(tree):
    return gather(tree, CPU)


def _replicas_equal(tree):
    for x in tree_flatten(tree)[0]:
        for entries in blocks(x):
            for e in entries[1:]:
                assert torch.equal(x.pieces[e], x.pieces[entries[0]])


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_step_matches_reference_and_one_device(arch, case, n_micro):
    strategy, shape, dp_axes = CASES[case]
    ctx = _ctx(arch)
    mesh = _mesh(shape)
    jnew, jm, one, om = _reference_and_one_device(ctx, n_micro)
    state, specs, whole = _placed_state(ctx, mesh, strategy)
    leaves = tree_flatten(state)[0]
    shardings = [x.sharding for x in leaves]
    held = entry_bytes(state)
    assert (held == per_device_bytes(whole, specs, mesh)).all()

    new, m = _step(ctx, n_micro, mesh, dp_axes, state)

    # the same Placed leaves, in the same sharding, bytes unchanged
    after = tree_flatten(new)[0]
    assert len(after) == len(leaves)
    assert all(a is b for a, b in zip(after, leaves))
    assert [x.sharding for x in after] == shardings
    assert (entry_bytes(new) == held).all()
    _replicas_equal(new)
    for want_m, what in ((jm, "reference"), (om, "one device")):
        assert int(m["step"]) == int(want_m["step"]) == 1
        np.testing.assert_allclose(float(m["loss"]), float(want_m["loss"]),
                                   rtol=1e-4, err_msg=what)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(want_m["grad_norm"]), rtol=1e-4,
                                   err_msg=what)
    for field in ("params", "mu", "nu"):
        got = _whole(getattr(new, field))
        for name, g, w in _pairs(got, getattr(jnew, field), ctx["jcfg"]):
            _close_params(g, w, OPT["lr"], f"reference {field} {name}")
        for i, (g, w) in enumerate(zip(tree_flatten(got)[0],
                                       tree_flatten(getattr(one, field))[0])):
            _close_params(g.numpy(), w.numpy(), OPT["lr"],
                          f"one device {field} leaf {i}")

    # a second run from the same state: the same bits
    again, m2 = _step(ctx, n_micro, mesh, dp_axes,
                      _placed_state(ctx, mesh, strategy)[0])
    assert torch.equal(m["loss"], m2["loss"])
    for a, b in zip(tree_flatten(new)[0], tree_flatten(again)[0]):
        for i in np.ndindex(a.pieces.shape):
            assert torch.equal(a.pieces[i], b.pieces[i])


def _record_gathers(monkeypatch):
    """The shape of every leaf that ``tensor_parallel`` gathers whole."""
    seen = []
    real = tp.gather

    def gathering(x, device):
        seen.append(tuple(x.shape))
        return real(x, device)

    monkeypatch.setattr(tp, "gather", gathering)
    return seen


@pytest.mark.parametrize("arch,case", [
    ("llama3-8b", "megatron-1x4"), ("llama3-8b", "megatron-2x2"),
    ("qwen2-moe-a2.7b", "megatron-1x4"), ("hymba-1.5b", "megatron-1x4"),
    ("llama3-8b", "megatron_zero-2x2")])
def test_routes_in_training(arch, case, monkeypatch):
    """What the placed step reads whole: nothing on megatron for the GQA
    (head route), SwiGLU, MoE, vocabulary and SSM projection leaves; of
    hymba's SSM branch only ``log_a`` (split along its channels, read
    elementwise: per layer, recomputed with it); under megatron_zero the
    layer leaves that ``data`` splits."""
    strategy, shape, dp_axes = CASES[case]
    ctx = _ctx(arch)
    mesh = _mesh(shape)
    state = _placed_state(ctx, mesh, strategy)[0]
    seen = _record_gathers(monkeypatch)
    _step(ctx, 1, mesh, dp_axes, state)
    ssm = {tuple(x.shape) for n, x in
           state.params["layers"][0].get("ssm", {}).items()
           if n == "log_a" and any(x.spec)}
    data_split = {tuple(x.shape) for x in tree_flatten(
        state.params["layers"])[0] if "data" in x.spec}
    if strategy == "megatron_zero":
        assert data_split and set(seen) == data_split
    elif ssm:
        assert set(seen) == ssm
        # forward and recompute per layer: each SSM leaf twice a layer
        assert len(seen) == 2 * ctx["tcfg"].n_layers * len(ssm)
    else:
        assert seen == []


def test_data_blocks_read_their_rows():
    """With ``dp_axes=("data",)`` on (2, 2), data block j reads the pieces
    of mesh row j: a change to row 1's replica of ``final_norm`` moves
    the loss; without data axes (one block, on row 0) it does not."""
    ctx = _ctx("llama3-8b")
    mesh = _mesh((2, 2))
    batch = {"tokens": torch.from_numpy(ctx["tokens"])}

    def loss(dp_axes, scale_row1):
        state = _placed_state(ctx, mesh, "megatron")[0]
        norm = state.params["final_norm"]
        for k in range(2):
            norm.pieces[1, k].mul_(scale_row1)
        return float(TS.loss_and_grads(ctx["tcfg"], state.params, batch, 1,
                                       torch.float32, dp_axes=dp_axes)[0])

    assert loss(("data",), 2.0) != loss(("data",), 1.0)
    assert loss(None, 2.0) == loss(None, 1.0)


def test_refusals():
    """A step built on another mesh, a tree that mixes placed and whole
    leaves, and ``devices`` for params in pieces raise ``ValueError``."""
    ctx = _ctx("qwen2-moe-a2.7b")
    mesh = _mesh((2, 2))
    state = _placed_state(ctx, mesh, "megatron")[0]
    batch = {"tokens": torch.from_numpy(ctx["tokens"])}
    with pytest.raises(ValueError, match="not the mesh"):
        TS.build_train_step(ctx["tcfg"], mesh=_mesh((1, 4)))(state, batch)
    with pytest.raises(ValueError, match="some leaves placed"):
        TO.global_norm({"a": state.params["embed"],
                        "b": torch.zeros(3)})
    with pytest.raises(ValueError, match="pass dp_axes"):
        TS.loss_and_grads(ctx["tcfg"], state.params, batch, 1,
                          torch.float32, devices=[CPU, CPU])


def test_adamw_init_places_the_moments():
    """``adamw_init`` of params in pieces: params / ``mu`` / ``nu`` placed
    like them (each piece a new tensor), step and 0-d residuals on the
    home entry's device; a step from it equals a step from
    ``device_put`` of the same state, bit for bit."""
    ctx = _ctx("llama3-8b")
    mesh = _mesh((1, 4))
    placed, specs, whole = _placed_state(ctx, mesh, "megatron")
    state = TO.adamw_init(placed.params)
    for field in ("params", "mu", "nu"):
        for x, p in zip(tree_flatten(getattr(state, field))[0],
                        tree_flatten(placed.params)[0]):
            assert isinstance(x, Placed) and x.sharding == p.sharding
            assert x.dtype == torch.float32
            assert all(a.data_ptr() != b.data_ptr() for a, b in
                       zip(x.pieces.flat, p.pieces.flat))
    assert state.step.device == CPU and state.step.dim() == 0
    assert all(e.dim() == 0 for e in tree_flatten(state.compress_err)[0])
    a, ma = _step(ctx, 1, mesh, ("data",), state)
    b, mb = _step(ctx, 1, mesh, ("data",), placed)
    assert torch.equal(ma["loss"], mb["loss"])
    assert int(ma["step"]) == int(mb["step"]) == 1
    for x, y in zip(tree_flatten(a.params)[0], tree_flatten(b.params)[0]):
        for i in np.ndindex(x.pieces.shape):
            assert torch.equal(x.pieces[i], y.pieces[i])


def test_global_norm_counts_each_block_once():
    """A replicated leaf on four entries counts once: the norm of a placed
    tree equals the whole tree's (a fixed order of f32 sums)."""
    mesh = _mesh((2, 2))
    rng = np.random.default_rng(3)
    tree = {"w": torch.from_numpy(rng.standard_normal((8, 6))
                                  .astype(np.float32)),
            "n": torch.from_numpy(rng.standard_normal(6).astype(np.float32))}
    placed = device_put(tree, {"w": NamedSharding(mesh, P("data", "model")),
                               "n": NamedSharding(mesh, P())})
    np.testing.assert_allclose(float(TO.global_norm(placed)),
                               float(TO.global_norm(tree)), rtol=1e-6)


def test_spread_and_row_sum_backward():
    """``spread``'s gradient: the entries' gradients summed in entry
    order in float32 and cast once, bit for bit; ``row_sum``'s: each part
    gets the output gradient."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)) \
        .to(torch.bfloat16).requires_grad_()
    gs = [torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
          .to(torch.bfloat16) for _ in range(4)]
    xs = tp.spread(x, [CPU] * 4)
    assert all(torch.equal(c, x) for c in xs)
    (gx,) = torch.autograd.grad(xs, [x], gs)
    want = gs[0].float()
    for g in gs[1:]:
        want = want + g.float()
    assert torch.equal(gx, want.to(torch.bfloat16))
    parts = [torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
             .to(torch.bfloat16).requires_grad_() for _ in range(4)]
    y = tp.row_sum(parts, CPU, torch.bfloat16)
    want = parts[0].float()
    for p in parts[1:]:
        want = want + p.float()
    assert torch.equal(y, want.to(torch.bfloat16))
    g = gs[0]
    for gp in torch.autograd.grad(y, parts, g):
        assert torch.equal(gp, g)


@pytest.mark.parametrize("tied", [False, True])
def test_vocab_parallel_gradients(tied):
    """The gradients of the vocab-parallel embedding and logits land on
    the pieces (each on its entry's device) and are the unsharded
    gradient's row / column blocks: the embedding's bit for bit, the
    head's within 1e-6."""
    rng = np.random.default_rng(1)
    v, d = 12, 8
    w = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, v, (2, 7)))
    g = torch.from_numpy(rng.standard_normal((2, 7, v)).astype(np.float32))
    mesh = _mesh((1, 4))
    spec = P("model", None) if tied else P(None, "model")
    head_w = w if tied else w.T.contiguous()
    placed = device_put(head_w, NamedSharding(mesh, spec))
    pieces = [t.requires_grad_() for t in placed.pieces.flat]
    whole = head_w.clone().requires_grad_()
    x = torch.from_numpy(rng.standard_normal((2, 7, d)).astype(np.float32))
    out = tp.logits(x, placed, tied)
    (gw,) = torch.autograd.grad(tp.logits(x, whole, tied), [whole], g)
    gp = torch.autograd.grad(out, pieces, g)
    cat = torch.cat(gp, dim=0 if tied else 1)
    np.testing.assert_allclose(cat.numpy(), gw.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert all(a.device == b.device for a, b in zip(gp, pieces))
    emb = device_put(w, NamedSharding(mesh, P("model", None)))
    epieces = [t.requires_grad_() for t in emb.pieces.flat]
    ew = w.clone().requires_grad_()
    ge = torch.from_numpy(rng.standard_normal((2, 7, d)).astype(np.float32))
    (gw,) = torch.autograd.grad(tp.embedding(ids, ew), [ew], ge)
    gp = torch.autograd.grad(tp.embedding(ids, emb), epieces, ge)
    assert torch.equal(torch.cat(gp), gw)


def test_gather_carries_the_gradient_to_the_pieces():
    """``gather`` of a leaf whose pieces require grad: each block's first
    entry gets that block of the gradient, the other replicas none."""
    mesh = _mesh((2, 2))
    w = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    placed = device_put(w, NamedSharding(mesh, P("model", None)))
    pieces = [t.requires_grad_() for t in placed.pieces.flat]
    g = torch.arange(24, dtype=torch.float32).reshape(4, 6) * 0.5
    grads = torch.autograd.grad(gather(placed, CPU), pieces, g,
                                allow_unused=True)
    assert torch.equal(grads[0], g[:2]) and torch.equal(grads[1], g[2:])
    assert grads[2] is None and grads[3] is None
