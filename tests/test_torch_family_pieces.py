"""Every family's layers on their weight pieces: RWKV6, hymba's SSM branch
and its attention with KV heads that the entries do not divide, MLA and
the audio blocks, on a parameter tree placed by ``param_pspecs(strategy=
"megatron")`` (``distributed.sharding.device_put``), on CPU meshes (1, 4)
and (2, 2) whose entries all name the CPU.

Reduced configs, 2 layers, float32, the params drawn by numpy from a seed
(``test_torch_train_pieces._np_params``) and carried across with
``params_from_jax``:

* rwkv6-7b as reduced;
* hymba-1.5b with 10 heads and 5 KV heads of 16 (``Hkv * D`` = 80 splits
  four and two ways, the heads do not: hymba-1.5b's 5 x 64 on four) and
  d = 128 (``auto_pspec`` then splits ``w_b|w_c`` along d, as at full
  width);
* minicpm3-4b as reduced (4 heads: the absorbed decode's head groups);
* whisper-tiny with 6 heads and 6 KV heads of 16 (four pieces split
  heads; two do not).

Checks:

* prefill and 4 decode steps on the placed tree against the whole tree
  at rtol/atol 1e-5; nothing gathered that a product reads -- the only
  leaf gathered is hymba's ``log_a`` (split along its channels, read
  elementwise), counted by patching ``tensor_parallel.gather``;
* hymba's ``decode_partials`` and ``linear_scan`` calls equal the whole
  tree's (one call a layer and step on all heads: the product route
  runs attention on the home entry), and so do the train step's scan
  forward and backward calls (times the data blocks on (2, 2));
* the placed prefill logits against the JAX package's ``forward_prefill``
  on the same numpy params at rtol 1e-4 / atol 1e-5;
* one train step of rwkv6-7b and hymba-1.5b on the placed train cell
  state (``dp_axes=("data",)``, two microbatches) against the port's
  one-device step: loss and grad norm at rtol 1e-4, params / ``mu`` /
  ``nu`` at ``tests/test_torch_train.py``'s ``_close_params``, the same
  placed leaves after the step, two runs bitwise;
* ``fill_placed`` for every family of the registry on ``meta``-placed
  pieces: constants exact, each normal leaf's standard deviation within
  5% of the scale ``init_params`` draws it at, ``log_a`` below 0 with
  ``log(-log_a)`` at std 0.5, no piece of a split leaf holding the whole
  leaf; a leaf it does not know raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.models import model as JM
from repro_torch.configs import ARCHS, reduced
from repro_torch.distributed.fault import tree_flatten, tree_map
from repro_torch.distributed.sharding import (Mesh, PartitionSpec as P,
                                              Placed, device_put,
                                              entry_bytes, gather,
                                              named_shardings, param_pspecs,
                                              per_device_bytes, shard_shape)
from repro_torch.kernels.chunked_scan import ops as scan_ops
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import tensor_parallel as tp
from repro_torch.train import optimizer as TO
from repro_torch.train import steps as TS

from test_torch_train import _close_params
from test_torch_train_pieces import _np_params

TOL = dict(rtol=1e-5, atol=1e-5)
JAX_TOL = dict(rtol=1e-4, atol=1e-5)
B, PROMPT, STEPS, CAP = 2, 10, 4, 16
TRAIN_B, TRAIN_S, N_MICRO = 4, 12, 2
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1)
CPU = torch.device("cpu")
FAMILIES = {"rwkv6-7b": {},
            "hymba-1.5b": dict(d_model=128, n_heads=10, n_kv_heads=5,
                               head_dim=16),
            "minicpm3-4b": {},
            "whisper-tiny": dict(d_model=96, n_heads=6, n_kv_heads=6,
                                 head_dim=16)}
MESHES = [(1, 4), (2, 2)]
_CACHE = {}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (restored after): its ops
    are tiny, and the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    return Mesh(np.full(shape, CPU, dtype=object), ("data", "model"))


def _ctx(arch):
    """Configs, the numpy params, the port's whole params and inputs."""
    if arch not in _CACHE:
        kw = dict(n_layers=2, **FAMILIES[arch])
        jcfg = dataclasses.replace(jax_reduced(arch), **kw)
        tcfg = dataclasses.replace(reduced(arch), **kw)
        params_np = _np_params(jcfg, sum(map(ord, arch)))
        rng = np.random.default_rng(len(arch))
        batch = {"tokens": rng.integers(0, tcfg.vocab_size, (B, PROMPT))
                 .astype(np.int32)}
        if tcfg.encdec is not None:
            batch["frames"] = rng.standard_normal(
                (B, tcfg.encdec.n_frames, tcfg.d_model)).astype(np.float32)
        steps = rng.integers(0, tcfg.vocab_size, (STEPS, B, 1)).astype(
            np.int32)
        _CACHE[arch] = dict(
            jcfg=jcfg, cfg=tcfg, params_np=params_np,
            params=TM.params_from_jax(tcfg, params_np, device="cpu"),
            batch=batch, steps=steps,
            train_tokens=rng.integers(0, tcfg.vocab_size,
                                      (TRAIN_B, TRAIN_S)).astype(np.int32))
    return _CACHE[arch]


def _serve(cfg, params, batch, steps):
    logits, state = TM.forward_prefill(
        cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()},
        cache_capacity=CAP)
    out = [logits]
    for t in steps:
        logits, state = TM.decode_step(cfg, params, state,
                                       torch.from_numpy(t))
        out.append(logits)
    return torch.stack(out)


def _place(cfg, params, mesh):
    specs = param_pspecs(cfg, params, mesh, strategy="megatron")
    return device_put(params, named_shardings(specs, mesh)), specs


class _Calls:
    """What the routes do, by patching: every ``Placed`` leaf that
    ``tensor_parallel`` gathers, the query heads of every
    ``decode_partials`` call, and the scan's plain forward and backward
    calls."""

    def __init__(self, monkeypatch):
        self.gathered, self.heads = [], []
        self.scans = {"linear_scan": 0, "linear_scan_bwd": 0}
        real_gather, real_partials = tp.gather, TL.decode_partials
        real_fwd, real_bwd = scan_ops.linear_scan_ref, \
            scan_ops.linear_scan_bwd_ref

        def gathering(x, device):
            self.gathered.append(x)
            return real_gather(x, device)

        def partials(q, *args, **kw):
            self.heads.append(q.shape[1])
            return real_partials(q, *args, **kw)

        def fwd(*a):
            self.scans["linear_scan"] += 1
            return real_fwd(*a)

        def bwd(*a):
            self.scans["linear_scan_bwd"] += 1
            return real_bwd(*a)

        monkeypatch.setattr(tp, "gather", gathering)
        monkeypatch.setattr(TL, "decode_partials", partials)
        monkeypatch.setattr(scan_ops, "linear_scan_ref", fwd)
        monkeypatch.setattr(scan_ops, "linear_scan_bwd_ref", bwd)

    def reset(self):
        self.gathered.clear()
        self.heads.clear()
        self.scans = dict.fromkeys(self.scans, 0)


def _unread_by_products(params):
    """The leaves that no product reads: hymba's ``log_a``."""
    return [lp["ssm"]["log_a"] for lp in params["layers"] if "ssm" in lp]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_placed_serving_matches_whole_tree(arch, shape, monkeypatch):
    ctx = _ctx(arch)
    cfg = ctx["cfg"]
    mesh = _mesh(shape)
    placed, specs = _place(cfg, ctx["params"], mesh)
    assert (entry_bytes(placed)
            == per_device_bytes(ctx["params"], specs, mesh)).all()
    calls = _Calls(monkeypatch)
    whole = _serve(cfg, ctx["params"], ctx["batch"], ctx["steps"])
    whole_calls = (list(calls.heads), dict(calls.scans))
    assert calls.gathered == []
    calls.reset()
    got = _serve(cfg, placed, ctx["batch"], ctx["steps"])
    torch.testing.assert_close(got, whole, **TOL)
    # nothing gathered that a product reads
    unread = _unread_by_products(placed)
    product_bytes = sum(x.shape.numel() * x.element_size()
                        for x in calls.gathered
                        if not any(x is u for u in unread))
    assert product_bytes == 0
    if cfg.family == "hybrid":
        # log_a once a layer and step; the scan and decode_partials calls
        # are the whole tree's (the 5 KV heads run on the home entry)
        assert len(calls.gathered) == cfg.n_layers * (1 + STEPS)
        assert (list(calls.heads), calls.scans) == whole_calls
        assert calls.heads == [cfg.n_heads] * (cfg.n_layers * STEPS)
    else:
        assert calls.gathered == []
    if arch == "whisper-tiny" and shape == (1, 4):
        # 6 heads on four entries: the product route splits heads
        assert calls.heads == [cfg.n_heads] * (cfg.n_layers * STEPS)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_placed_prefill_matches_reference(arch):
    """The placed prefill's logits against the JAX package's on the same
    numpy params, at rtol 1e-4 / atol 1e-5."""
    ctx = _ctx(arch)
    jbatch = {k: jnp.asarray(v) for k, v in ctx["batch"].items()}
    want, _ = JM.forward_prefill(ctx["jcfg"], ctx["params_np"], jbatch,
                                 cache_capacity=CAP)
    placed, _ = _place(ctx["cfg"], ctx["params"], _mesh((1, 4)))
    got, _ = TM.forward_prefill(
        ctx["cfg"], placed,
        {k: torch.from_numpy(v) for k, v in ctx["batch"].items()},
        cache_capacity=CAP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)


def _close_step(got, want, mu, what):
    """``_close_params``' bar (rtol 1e-4 / atol 1e-6; an element off by 2
    lr at most, 0.1% of a leaf), where a leaf of a few hundred elements
    has more than 0.1% off only if each element off has a first moment
    within 1e-6 of 0 in the whole tree's step: a ~0 gradient whose
    rounding Adam's normalised step turns into a step of another size
    (``torch_model_cases.check_adamw_step``'s bar; hymba's w_c, 512
    elements, has one at mu 8.7e-9)."""
    miss = ~np.isclose(got, want, rtol=1e-4, atol=1e-6)
    if miss.mean() <= 0.001:
        _close_params(got, want, OPT["lr"], what)
        return
    assert np.abs(got - want)[miss].max() <= 2 * OPT["lr"], what
    assert np.abs(mu[miss]).max() <= 1e-6, what


def _placed_state(ctx, mesh):
    state = TO.adamw_init(ctx["params"])
    p_specs = param_pspecs(ctx["cfg"], state.params, mesh,
                           strategy="megatron")
    specs = TO.TrainState(step=P(), params=p_specs, mu=p_specs, nu=p_specs,
                          compress_err=tree_map(lambda _: P(),
                                                state.compress_err))
    return device_put(state, named_shardings(specs, mesh))


def _train(ctx, state, mesh=None):
    kw = dict(dp_axes=("data",), mesh=mesh) if mesh is not None else {}
    step = TS.build_train_step(ctx["cfg"], TO.AdamWConfig(**OPT),
                               n_micro=N_MICRO, compute_dtype=torch.float32,
                               **kw)
    return step(state, {"tokens": torch.from_numpy(ctx["train_tokens"])})


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ["rwkv6-7b", "hymba-1.5b"])
def test_placed_train_step_matches_whole_tree(arch, shape, monkeypatch):
    ctx = _ctx(arch)
    cfg = ctx["cfg"]
    mesh = _mesh(shape)
    calls = _Calls(monkeypatch)
    one, om = _train(ctx, TO.adamw_init(
        tree_map(lambda t: t.clone(), ctx["params"])))
    whole_scans = dict(calls.scans)
    calls.reset()
    state = _placed_state(ctx, mesh)
    leaves = tree_flatten(state)[0]
    held = entry_bytes(state)
    new, m = _train(ctx, state, mesh)
    assert all(a is b for a, b in zip(tree_flatten(new)[0], leaves))
    assert (entry_bytes(new) == held).all()
    # the step runs the scan as often as the whole tree's (once more for
    # each further data block), and gathers nothing that a product reads
    # (log_a: forward and recompute, per layer, data block and microbatch)
    assert calls.scans == {k: v * shape[0] for k, v in whole_scans.items()}
    n_blocks = N_MICRO * shape[0]
    if cfg.family == "hybrid":
        assert whole_scans["linear_scan_bwd"] == cfg.n_layers * N_MICRO
        assert {tuple(x.shape) for x in calls.gathered} == {
            tuple(ctx["params"]["layers"][0]["ssm"]["log_a"].shape)}
        assert len(calls.gathered) == 2 * cfg.n_layers * n_blocks
    else:
        assert calls.gathered == []
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[name]), float(om[name]),
                                   rtol=1e-4, err_msg=name)
    mu = tree_flatten(one.mu)[0]
    for field in ("params", "mu", "nu"):
        got = tree_flatten(gather(getattr(new, field), CPU))[0]
        for i, (g, w) in enumerate(zip(got,
                                       tree_flatten(getattr(one, field))[0])):
            _close_step(g.numpy(), w.numpy(), mu[i].numpy(),
                        f"{field} leaf {i}")
    again, m2 = _train(ctx, _placed_state(ctx, mesh), mesh)
    assert torch.equal(m["loss"], m2["loss"])
    for a, b in zip(tree_flatten(new)[0], tree_flatten(again)[0]):
        for i in np.ndindex(a.pieces.shape):
            assert torch.equal(a.pieces[i], b.pieces[i])


# ------------------------------------------------------------- fill_placed


def _wide(arch):
    """``reduced(arch)`` at d = 1,024 (RWKV6: 16 heads of 64), so that the
    smallest leaf's draws, pooled over the layers, number 2,048 or more:
    a standard deviation estimated from them is within 5% of the scale
    at over three standard errors."""
    kw = dict(d_model=1024)
    if reduced(arch).family == "ssm":
        kw.update(n_heads=16, n_kv_heads=16, head_dim=64)
    return dataclasses.replace(reduced(arch), **kw)


def _walk(tree, path=()):
    """(path, leaf) in ``tree_flatten`` order; a list's items share its
    path, as in ``fill_placed``."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, list):
        for v in tree:
            yield from _walk(v, path)
    else:
        yield path, tree


def _init_scales(cfg, monkeypatch):
    """``init_params``' tree with every ``normal_init`` draw replaced by
    its scale (a constant tensor), and the ids of those leaves."""
    normal = set()

    def scale_of(shape, scale, generator, dtype, device):
        t = torch.full(shape, float(scale), dtype=dtype, device=device)
        normal.add(id(t))
        return t

    with monkeypatch.context() as m:
        m.setattr(TL, "normal_init", scale_of)
        tree = TM.init_params(cfg, torch.Generator().manual_seed(0),
                              dtype=torch.float32, device="cpu")
    return tree, normal


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_fill_placed_draws_every_family(arch, shape, monkeypatch):
    cfg = _wide(arch)
    mesh = _mesh(shape)
    scales, normal = _init_scales(cfg, monkeypatch)
    meta = TM.init_params(cfg, torch.Generator(), dtype=torch.float32,
                          device="meta")
    specs = param_pspecs(cfg, meta, mesh, strategy="megatron")
    placed = TM.fill_placed(cfg, device_put(meta, named_shardings(specs,
                                                                 mesh)),
                            seed=11)
    assert (entry_bytes(placed) == per_device_bytes(meta, specs, mesh)).all()
    pooled = {}
    n_split = 0
    for (path, x), (_, want) in zip(_walk(placed), _walk(scales)):
        assert isinstance(x, Placed) and x.shape == want.shape
        size = shard_shape(tuple(x.shape), x.spec, mesh)
        if size != tuple(x.shape):          # a split leaf: never whole
            n_split += 1
            assert all(tuple(t.shape) == size for t in x.pieces.flat)
            assert len({t.data_ptr() for t in x.pieces.flat}) == \
                x.pieces.size
        got = gather(x, CPU)
        if path[-1] == "log_a":
            pooled.setdefault(path, ("log_a", None, []))[2].append(got)
        elif id(want) in normal:
            pooled.setdefault(path, ("normal", float(want.flatten()[0]),
                                     []))[2].append(got)
        else:
            assert torch.equal(got, want), path
    assert n_split
    for path, (kind, scale, draws) in pooled.items():
        v = torch.cat([t.flatten() for t in draws]).double()
        if kind == "log_a":
            assert (v < 0).all(), path
            v, scale = torch.log(-v), 0.5
        assert v.numel() >= 2048, path
        assert abs(float(v.std()) / scale - 1) < 0.05, (path, float(v.std()),
                                                        scale)
        assert abs(float(v.mean())) < 0.1 * scale, path


@pytest.mark.parametrize("arch,block", [("rwkv6-7b", "rwkv"),
                                        ("hymba-1.5b", "ssm"),
                                        ("minicpm3-4b", "attn"),
                                        ("whisper-tiny", "xattn"),
                                        ("whisper-tiny", "mlp")])
def test_fill_placed_refuses_an_unknown_leaf(arch, block):
    cfg = reduced(arch)
    meta = TM.init_params(cfg, torch.Generator(), dtype=torch.float32,
                          device="meta")
    meta["layers"][1][block]["w_unknown"] = torch.empty((cfg.d_model, 4),
                                                        device="meta")
    mesh = _mesh((1, 2))
    placed = device_put(meta, named_shardings(
        param_pspecs(cfg, meta, mesh, strategy="megatron"), mesh))
    with pytest.raises(ValueError, match=f"{block}/w_unknown is not one"):
        TM.fill_placed(cfg, placed, seed=0)
