"""MoE trained over data blocks: the data-parallel train step
(``build_train_step(..., dp_axes=("data",), mesh=...)``) of an MoE model,
whole and in pieces, port against reference, on the CPU in float32.

The reference's ``moe_forward`` (``src/repro/models/layers.py:379-424``)
ranks the (token, expert) pairs of the whole microbatch by a stable sort
and sizes the capacity from the whole microbatch's tokens.  The port runs
a microbatch's data blocks one after another in data order and carries
each expert's pair count from block to block (``layers.BlockRouting``),
so a block keeps the pairs the whole microbatch keeps.

Reduced qwen2-moe-a2.7b (4 experts, top-2, 2 layers), params drawn by
numpy from a seed (``tests/test_torch_train_pieces.py``'s ``_np_params``)
and carried across by ``train_state_from_jax``, B = 8 x 16 tokens in 2
microbatches, twice: with the router as drawn, and with a skewed router
(column 0 of each layer's router moved along the mean of that layer's
inputs, so that ~88% of the tokens put expert 0 first and the
microbatch's capacity of 40 pairs an expert drops pairs):

* the port's DP step over 2 and 4 blocks (a repeated CPU device) against
  the reference's one-device ``build_train_step`` step from the same
  state (one jit compile, shared by both routers) and the port's
  one-device step: loss and grad norm at rtol 1e-4, params at
  ``tests/test_torch_train.py``'s ``_close_params``;
* every layer's kept (token, expert) pairs of every microbatch equal the
  one-device step's and the reference's (``moe_route`` of the one-device
  step's MoE inputs through the reference's ranking, ``_reference_kept``);
  with the skewed router a capacity sized from each block's own tokens
  keeps another set (the witness that the check can fail);
* remat on and off give the same bits (the backward's recompute reads
  the counts of the earlier blocks and adds nothing);
* the placed step on (2, 2) and (4, 1) megatron states, one data block
  per mesh row, against the port's one-device step at the same bars;
* one reduced dbrx-132b case (4 experts, top-2, no shared expert);
* ``launch.train --arch qwen2-moe-a2.7b --data-parallel 2``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as JO
from repro.train import steps as JS
from repro_torch.distributed.fault import tree_flatten, tree_map
from repro_torch.distributed.sharding import (Mesh, PartitionSpec as P,
                                              device_put, gather,
                                              named_shardings, param_pspecs)
from repro_torch.models import layers as L
from repro_torch.models import forward_train, params_from_jax
from repro_torch.models import train_state_from_jax
from repro_torch.train import optimizer as TO
from repro_torch.train import steps as TS

from test_torch_train import _close_params, _pairs
from test_torch_train_pieces import _cfgs, _np_params, _replicas_equal

B, S, N_MICRO = 8, 16, 2
CPU = torch.device("cpu")
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1)
SKEW = 4.0            # times the unit mean input added to router column 0
_CACHE = {}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (restored after): its ops
    are tiny, and with the suite's parallel workers each op's thread pool
    spins against the others' (six copies of this file on 8 cores: 408 s
    each with 8 threads, 23 s with one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Recorder:
    """Per ``forward_train`` call of ``train.steps`` (a microbatch, or a
    data block of one): per MoE layer in order, the routed experts, the
    MoE input and router (``moe_route``'s arguments) and the slots
    (``moe_dispatch``'s result).  The backward's recomputes of a layer
    run after the call returns and are not recorded."""

    def __init__(self, monkeypatch):
        self.calls, self.on = [], False
        fwd, route, disp = TS.forward_train, L.moe_route, L.moe_dispatch

        def forward(*a, **kw):
            self.calls.append([])
            self.on = True
            try:
                return fwd(*a, **kw)
            finally:
                self.on = False

        def routing(p, xf, cfg):
            if self.on:
                self.calls[-1].append({
                    "xf": xf.detach().clone(),
                    "router": p["router"].detach().clone()})
            return route(p, xf, cfg)

        def dispatch(top_i, cfg, r=None):
            out = disp(top_i, cfg, r)
            if self.on:
                self.calls[-1][-1].update(top_i=top_i.clone(), st=out[2],
                                          se=out[1], slot=out[3], cap=out[4])
            return out

        monkeypatch.setattr(TS, "forward_train", forward)
        monkeypatch.setattr(L, "moe_route", routing)
        monkeypatch.setattr(L, "moe_dispatch", dispatch)

    def kept(self, cfg, n_dp, per_block=False):
        """[microbatch][layer] -> the set of kept (token, expert) pairs,
        tokens numbered in the microbatch.  ``per_block``: as a capacity
        sized from each block's own tokens would keep them."""
        ep = cfg.moe.n_experts_padded
        out = []
        for i in range(0, len(self.calls), n_dp):
            layers = [set() for _ in self.calls[i]]
            off = 0
            for block in self.calls[i:i + n_dp]:
                for sets, r in zip(layers, block):
                    st, se, slot, cap = r["st"], r["se"], r["slot"], r["cap"]
                    if per_block:
                        _, se, st, slot, cap = L.moe_dispatch(r["top_i"],
                                                              cfg)
                    keep = slot < ep * cap
                    sets |= {(off + int(t), int(e)) for t, e in
                             zip(st[keep], se[keep])}
                off += block[0]["top_i"].shape[0]
            out.append(layers)
        return out


def _reference_kept(xf, router, cfg):
    """The kept pairs of the reference's ``moe_forward`` on these inputs:
    its routing (``lax.top_k`` of the f32 logits, padded experts at
    -1e30) and its ranking (``src/repro/models/layers.py:392-413``)."""
    e = cfg.moe
    n, k, ep = xf.shape[0], e.top_k, e.n_experts_padded
    logits = jnp.einsum("nd,de->ne", jnp.asarray(xf.numpy()),
                        jnp.asarray(router.float().numpy()))
    if ep > e.n_experts:
        logits = jnp.where(jnp.arange(ep)[None, :] >= e.n_experts, -1e30,
                           logits)
    _, top_i = jax.lax.top_k(logits, k)
    flat_expert = top_i.reshape(-1)
    flat_token = jnp.repeat(jnp.arange(n, dtype=jnp.int32), k)
    order = jnp.argsort(flat_expert)
    se, st = flat_expert[order], flat_token[order]
    grp_start = jnp.searchsorted(se, jnp.arange(ep, dtype=jnp.int32),
                                 side="left")
    rank = jnp.arange(n * k, dtype=jnp.int32) - grp_start[se]
    cap = int(math.ceil(n * k / e.n_experts * e.capacity_factor))
    keep = np.asarray(rank < cap)
    return {(int(t), int(x)) for t, x in
            zip(np.asarray(st)[keep], np.asarray(se)[keep])}


def _skew(tcfg, params_np, tokens):
    """``params_np`` with column 0 of each layer's router moved by SKEW x
    the unit mean of that layer's MoE inputs over ``tokens`` (layer by
    layer, each mean taken with the layers before it skewed)."""
    params_np = jax.tree.map(np.copy, params_np)
    router = params_np["layers"]["moe"]["router"]
    for layer in range(tcfg.n_layers):
        seen = []
        real = L.moe_route

        def routing(p, xf, cfg):
            seen.append(xf.detach())
            return real(p, xf, cfg)

        L.moe_route = routing
        try:
            forward_train(tcfg, params_from_jax(tcfg, params_np,
                                                device="cpu"),
                          {"tokens": torch.from_numpy(tokens)}, remat=False)
        finally:
            L.moe_route = real
        m = seen[layer].mean(0).numpy()
        router[layer, :, 0] += SKEW * m / np.linalg.norm(m)
    return params_np


def _ctx(arch, skewed=False):
    """Configs, the reference's initial state (numpy), the tokens, and
    (qwen2-moe) the reference's one-device step from that state."""
    key = (arch, skewed)
    if key not in _CACHE:
        jcfg, tcfg = _cfgs(arch)
        tokens = np.random.default_rng(len(arch)).integers(
            0, jcfg.vocab_size, (B, S)).astype(np.int32)
        params = _np_params(jcfg, sum(map(ord, arch)))
        if skewed:
            params = _skew(tcfg, params, tokens)
        state = jax.tree.map(np.asarray, JO.adamw_init(
            jax.tree.map(jnp.asarray, params)))
        _CACHE[key] = dict(jcfg=jcfg, tcfg=tcfg, state=state, tokens=tokens)
    return _CACHE[key]


def _reference_step(ctx):
    """The reference's one-device step, one jit compile for every state
    of the config (the same shapes)."""
    if "ref" not in ctx:
        name = ctx["jcfg"].name
        if name not in _CACHE:
            _CACHE[name] = jax.jit(JS.build_train_step(
                ctx["jcfg"], JO.AdamWConfig(**OPT), n_micro=N_MICRO,
                compute_dtype=jnp.float32))
        ctx["ref"] = _CACHE[name](jax.tree.map(jnp.asarray, ctx["state"]),
                                  {"tokens": jnp.asarray(ctx["tokens"])})
    return ctx["ref"]


def _port_step(ctx, monkeypatch=None, state=None, **dp):
    """The port's step from the context's state (whole unless ``state``),
    with its kept pairs recorded where ``monkeypatch`` is given."""
    rec = _Recorder(monkeypatch) if monkeypatch is not None else None
    if state is None:
        state = train_state_from_jax(ctx["tcfg"], ctx["state"], device="cpu")
    new, m = TS.build_train_step(ctx["tcfg"], TO.AdamWConfig(**OPT),
                                 n_micro=N_MICRO, compute_dtype=torch.float32,
                                 **dp)(state, {"tokens": torch.from_numpy(
                                     ctx["tokens"])})
    if monkeypatch is not None:
        monkeypatch.undo()
    return new, m, rec


def _one_device(ctx, monkeypatch):
    if "one" not in ctx:
        ctx["one"] = _port_step(ctx, monkeypatch)
    return ctx["one"]


def _dp_mesh(n):
    return Mesh(np.array([[CPU]] * n, dtype=object), ("data", "model"))


def _close_metrics(m, want, what):
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(want[k]), rtol=1e-4,
                                   err_msg=f"{what} {k}")


def _close_fields(new, want, what, fields=("params",)):
    for field in fields:
        for i, (g, w) in enumerate(zip(tree_flatten(getattr(new, field))[0],
                                       tree_flatten(getattr(want, field))[0])):
            _close_params(g.numpy(), w.numpy(), OPT["lr"],
                          f"{what} {field} leaf {i}")


@pytest.mark.parametrize("n_dp", [2, 4])
@pytest.mark.parametrize("skewed", [False, True], ids=["drawn", "skewed"])
def test_moe_dp_step_matches_reference(monkeypatch, skewed, n_dp):
    ctx = _ctx("qwen2-moe-a2.7b", skewed)
    jnew, jm = _reference_step(ctx)
    one, om, one_rec = _one_device(ctx, monkeypatch)
    new, m, rec = _port_step(ctx, monkeypatch, dp_axes=("data",),
                             mesh=_dp_mesh(n_dp))
    assert len(rec.calls) == N_MICRO * n_dp
    for want, what in ((jm, "reference"), (om, "one device")):
        assert int(m["step"]) == int(want["step"]) == 1
        _close_metrics(m, want, what)
    for name, g, w in _pairs(new.params, jnew.params, ctx["jcfg"]):
        _close_params(g, w, OPT["lr"], f"reference {name}")
    _close_fields(new, one, "one device")

    tcfg = ctx["tcfg"]
    kept = rec.kept(tcfg, n_dp)
    assert kept == one_rec.kept(tcfg, 1)
    for i, layers in enumerate(kept):
        for layer, pairs in enumerate(layers):
            r = one_rec.calls[i][layer]
            assert pairs == _reference_kept(r["xf"], r["router"], tcfg), \
                (i, layer)
    n_pairs = B // N_MICRO * S * tcfg.moe.top_k
    dropped = sum(n_pairs - len(p) for layers in kept for p in layers)
    if skewed:
        assert dropped > 0
        assert rec.kept(tcfg, n_dp, per_block=True) != kept


def test_remat_on_and_off_same_bits(monkeypatch):
    """The DP step's loss and gradients over 4 blocks with the skewed
    router, with each layer rematerialised and without: the same bits."""
    ctx = _ctx("qwen2-moe-a2.7b", True)
    tcfg = ctx["tcfg"]
    params = params_from_jax(tcfg, ctx["state"].params, device="cpu")
    batch = {"tokens": torch.from_numpy(ctx["tokens"])}

    def run():
        return TS.loss_and_grads(tcfg, params, batch, N_MICRO, torch.float32,
                                 devices=[CPU] * 4)

    loss, grads = run()
    real = TS.forward_train
    monkeypatch.setattr(TS, "forward_train", lambda *a, **kw: real(
        *a, **dict(kw, remat=False)))
    loss2, grads2 = run()
    assert torch.equal(loss, loss2)
    for a, b in zip(tree_flatten(grads)[0], tree_flatten(grads2)[0]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
def test_placed_moe_dp_step(monkeypatch, shape):
    """The reference's train cell (megatron specs, ZeRO-3 moments) on a
    ``shape`` mesh of CPU entries, one data block per mesh row, skewed
    router: against the port's one-device step at the bars (params, mu
    and nu), the same kept pairs, the same placed leaves after the step
    with replicas equal."""
    ctx = _ctx("qwen2-moe-a2.7b", True)
    tcfg = ctx["tcfg"]
    mesh = Mesh(np.full(shape, CPU, dtype=object), ("data", "model"))
    whole = train_state_from_jax(tcfg, ctx["state"], device="cpu")
    p_specs = param_pspecs(tcfg, whole.params, mesh, strategy="megatron")
    specs = TO.TrainState(step=P(), params=p_specs, mu=p_specs, nu=p_specs,
                          compress_err=tree_map(lambda _: P(),
                                                whole.compress_err))
    placed = device_put(whole, named_shardings(specs, mesh))
    one, om, one_rec = _one_device(ctx, monkeypatch)
    new, m, rec = _port_step(ctx, monkeypatch, state=placed,
                             dp_axes=("data",), mesh=mesh)
    assert len(rec.calls) == N_MICRO * shape[0]
    assert rec.kept(tcfg, shape[0]) == one_rec.kept(tcfg, 1)
    assert rec.kept(tcfg, shape[0], per_block=True) != one_rec.kept(tcfg, 1)
    _close_metrics(m, om, "one device")
    assert all(a is b for a, b in zip(tree_flatten(new)[0],
                                      tree_flatten(placed)[0]))
    got = TO.TrainState(*(gather(f, CPU) for f in new))
    _close_fields(got, one, "one device", ("params", "mu", "nu"))
    _replicas_equal(new)


def test_dbrx_dp_step(monkeypatch):
    """Reduced dbrx-132b (4 experts, top-2, no shared expert) over 2
    blocks against the port's one-device step: the bars and the kept
    pairs."""
    ctx = _ctx("dbrx-132b")
    one, om, one_rec = _port_step(ctx, monkeypatch)
    new, m, rec = _port_step(ctx, monkeypatch, dp_axes=("data",),
                             mesh=_dp_mesh(2))
    _close_metrics(m, om, "one device")
    _close_fields(new, one, "one device", ("params", "mu", "nu"))
    assert rec.kept(ctx["tcfg"], 2) == one_rec.kept(ctx["tcfg"], 1)


def test_launcher_moe_data_parallel(tmp_path, capsys):
    """``launch.train --arch qwen2-moe-a2.7b --data-parallel 2`` on the
    CPU: the two blocks on the repeated device, and the run within 2 lr
    per step of the one-device run."""
    from repro_torch.launch import train as LT

    args = ["--arch", "qwen2-moe-a2.7b", "--device", "cpu", "--steps", "2",
            "--batch", "4", "--seq", "16", "--n-micro", "2"]
    dp = LT.main(args + ["--data-parallel", "2",
                         "--ckpt-dir", str(tmp_path / "dp")])
    assert "data parallel over ['cpu', 'cpu']" in capsys.readouterr().out
    one = LT.main(args + ["--ckpt-dir", str(tmp_path / "one")])
    assert int(dp.step) == int(one.step) == 2
    for g, w in zip(tree_flatten(dp.params)[0], tree_flatten(one.params)[0]):
        assert float((g - w).abs().max()) <= 2 * 3e-3 * 2
