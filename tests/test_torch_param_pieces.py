"""Model weights in pieces: prefill and decode on a parameter tree placed
by ``param_pspecs`` (``distributed.sharding.device_put``), port against
reference, on CPU meshes (1, 2), (1, 4) and (2, 2) of CPU entries.

Reduced llama3-8b, dbrx-132b and qwen2-moe-a2.7b (shared experts), 2
layers each, float32; the params are drawn by numpy from a seed and
carried across with ``params_from_jax``.  Placed by ``strategy=
"megatron"`` (attention heads, MLP widths, experts and vocabulary split
over ``model``), each case's prefill logits and 4 decode steps against
the reference's ``forward_prefill`` / ``decode_step`` on the same params
and against the port's unsharded model:

* the routes taken: a GQA layer whose KV heads the ``model`` entries
  divide runs one head group per entry (``decode_partials`` once per
  entry, layer and step, on ``Hq / n`` heads) and keeps its cache in
  KV-head pieces; where they do not (reduced llama3-8b and dbrx-132b
  have 2 KV heads on (1, 4)) it takes the product route: q/k/v by
  column, attention on the home entry over a whole cache (one
  ``decode_partials`` on all heads), ``wo`` by row, nothing gathered;
  experts split over ``data`` as well ((2, 2)) are gathered whole for
  the call; no other leaf is ever gathered;
* the bytes each entry holds of the params and of the head-split cache
  equal ``per_device_bytes``;
* ``megatron_zero`` on (2, 2) (every layer leaf names ``data``: the
  gather route) and ``auto`` on (1, 2) also match; on the gather route
  the gathered caches are bitwise the unsharded model's;
* the vocab-parallel embedding and the MoE dispatch slots that reach the
  experts are bitwise the unsharded lookup and dispatch;
* ``ServingEngine`` serves the placed tree as it is (no leaf gathered):
  greedy tokens equal the unsharded engine's;
* ``fill_placed`` draws a ``meta``-placed tree piece by piece, each
  block from its own seed, replicas equal, with ``init_params``'
  distributions.

Bar: rtol/atol 1e-4 / 2e-4 on float32 logits; bitwise where stated.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import reduced as jax_reduced
from repro.models import model as JM
from repro_torch.configs import reduced
from repro_torch.distributed.fault import tree_flatten
from repro_torch.distributed.sharding import (Mesh, NamedSharding,
                                              PartitionSpec as P, Placed,
                                              axis_mesh, axis_pieces,
                                              device_put, entry_bytes,
                                              gather, named_shardings,
                                              param_pspecs,
                                              per_device_bytes,
                                              shard_shape)
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import tensor_parallel as tp
from repro_torch.serve.engine import ServingEngine

TOL = dict(rtol=1e-4, atol=2e-4)
B, PROMPT, STEPS, CAP = 2, 10, 4, 24
CPU = torch.device("cpu")
ARCHS = ["llama3-8b", "dbrx-132b", "qwen2-moe-a2.7b"]
MESHES = [(1, 2), (1, 4), (2, 2)]


def _mesh(shape):
    return Mesh(np.full(shape, CPU, dtype=object), ("data", "model"))


def _np_params(jcfg, seed):
    """The reference's parameter tree drawn by numpy: norms 1 + 0.1 N,
    every other leaf N / sqrt(its second-to-last dimension)."""
    shapes = jax.eval_shape(lambda: JM.init_params(
        jcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        x = rng.standard_normal(s.shape)
        if "norm" in jax.tree_util.keystr(path):
            return (1 + 0.1 * x).astype(np.float32)
        return (x * s.shape[-2] ** -0.5).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    arch = request.param
    jcfg, tcfg = jax_reduced(arch), reduced(arch)
    assert jcfg.n_layers == tcfg.n_layers == 2
    params_np = _np_params(jcfg, sum(map(ord, arch)))
    tparams = TM.params_from_jax(tcfg, params_np, device="cpu")
    rng = np.random.default_rng(len(arch))
    prompt = rng.integers(0, tcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    steps = rng.integers(0, tcfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    # the reference on the same params
    logits, state = JM.forward_prefill(jcfg, params_np,
                                       {"tokens": jnp.asarray(prompt)},
                                       cache_capacity=CAP)
    step = jax.jit(lambda p, s, t: JM.decode_step(jcfg, p, s, t))
    ref = [np.asarray(logits)]
    for t in steps:
        logits, state = step(params_np, state, jnp.asarray(t))
        ref.append(np.asarray(logits))
    one, one_state = _run(tcfg, tparams, prompt, steps)
    return dict(cfg=tcfg, params=tparams, prompt=prompt, steps=steps,
                ref=np.stack(ref), one=one, one_state=one_state)


def _run(cfg, params, prompt, steps):
    logits, state = TM.forward_prefill(
        cfg, params, {"tokens": torch.from_numpy(prompt)},
        cache_capacity=CAP)
    out = [logits.numpy()]
    for t in steps:
        logits, state = TM.decode_step(cfg, params, state,
                                       torch.from_numpy(t))
        out.append(logits.numpy())
    return np.stack(out), state


def _place(case, mesh, strategy):
    cfg, params = case["cfg"], case["params"]
    specs = param_pspecs(cfg, params, mesh, strategy=strategy)
    return device_put(params, named_shardings(specs, mesh)), specs


def _record(monkeypatch):
    """Every leaf ``tensor_parallel`` gathers (its shape), and every
    ``decode_partials`` call's query heads."""
    rec = {"gathered": [], "heads": []}
    real_gather, real_partials = tp.gather, TL.decode_partials

    def gathering(x, device):
        rec["gathered"].append(tuple(x.shape))
        return real_gather(x, device)

    def partials(q, *args, **kw):
        rec["heads"].append(q.shape[1])
        return real_partials(q, *args, **kw)

    monkeypatch.setattr(tp, "gather", gathering)
    monkeypatch.setattr(TL, "decode_partials", partials)
    return rec


def _kv_leaves(state):
    return [t for lc in state["layers"] for n, t in lc["attn"].items()
            if n in ("k", "v")]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_megatron_pieces_match_reference(case, shape, monkeypatch):
    cfg = case["cfg"]
    mesh = _mesh(shape)
    placed, specs = _place(case, mesh, "megatron")
    want = per_device_bytes(case["params"], specs, mesh)
    assert (entry_bytes(placed) == want).all()
    rec = _record(monkeypatch)
    got, state = _run(cfg, placed, case["prompt"], case["steps"])
    np.testing.assert_allclose(got, case["ref"], **TOL)
    np.testing.assert_allclose(got, case["one"], **TOL)

    n, data = shape[1], shape[0]
    heads = cfg.n_kv_heads % n == 0
    lp = case["params"]["layers"][0]
    expect = set()
    # KV heads the entries do not divide: the product route, no gather
    if cfg.moe is not None and data > 1:     # experts split over data too
        expect |= {tuple(lp["moe"][k].shape)
                   for k in ("w_gate", "w_up", "w_down")}
    assert set(rec["gathered"]) == expect
    calls = STEPS * cfg.n_layers * (n if heads else 1)
    assert rec["heads"] == [cfg.n_heads // (n if heads else 1)] * calls

    kv = _kv_leaves(state)
    if not heads:
        assert all(isinstance(t, torch.Tensor) for t in kv)
        return
    row = axis_mesh(mesh)
    assert all(isinstance(t, Placed) and t.spec == tp.HEAD_SPEC
               and t.pieces.shape == (1, n) for t in kv)
    meta = TM.init_decode_state(cfg, B, CAP, dtype=torch.float32,
                                device="meta")
    kv_meta = _kv_leaves(meta)
    spec_tree = [tp.HEAD_SPEC] * len(kv_meta)
    assert (entry_bytes(kv) == per_device_bytes(kv_meta, spec_tree,
                                                row)).all()
    # the pieces are the unsharded cache's KV-head blocks, bitwise for
    # layer 0 (whose K/V depend on the tokens only)
    one = case["one_state"]["layers"][0]["attn"]["k"]
    assert torch.equal(gather(state["layers"][0]["attn"]["k"], CPU), one)


@pytest.mark.parametrize("strategy,shape", [("megatron_zero", (2, 2)),
                                            ("auto", (1, 2))])
def test_gather_route_matches(case, strategy, shape, monkeypatch):
    cfg = case["cfg"]
    mesh = _mesh(shape)
    placed, specs = _place(case, mesh, strategy)
    assert (entry_bytes(placed)
            == per_device_bytes(case["params"], specs, mesh)).all()
    rec = _record(monkeypatch)
    got, state = _run(cfg, placed, case["prompt"], case["steps"])
    np.testing.assert_allclose(got, case["ref"], **TOL)
    np.testing.assert_allclose(got, case["one"], **TOL)
    assert rec["heads"] == [cfg.n_heads] * (STEPS * cfg.n_layers)
    if strategy == "megatron_zero":
        # every layer leaf names data: each is gathered whole for its
        # layer, so the layers compute the unsharded model's bits
        assert rec["gathered"]
        for a, b in zip(_kv_leaves(state), _kv_leaves(case["one_state"])):
            assert isinstance(a, torch.Tensor) and torch.equal(a, b)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_vocab_parallel_embedding_is_bitwise(shape):
    gen = torch.Generator().manual_seed(3)
    table = torch.randn((384, 64), generator=gen)
    placed = device_put(table, NamedSharding(_mesh(shape),
                                             P("model", None)))
    assert axis_pieces(placed)[0] == 0
    ids = torch.randint(0, 384, (3, 17), generator=gen)
    ids[0, :4] = torch.tensor([0, 383, 384 // shape[1] - 1,
                               384 // shape[1]])
    assert torch.equal(tp.embedding(ids, placed), F.embedding(ids, table))


def test_moe_dispatch_slots_are_bitwise(monkeypatch):
    """dbrx-132b on (1, 4): each entry gets its experts' slice of the
    dispatch buffer; joined in entry order they are the unsharded
    buffer, bit for bit, and so is the layer's output (the experts'
    products on a slice are the whole batch's, row for row)."""
    cfg = reduced("dbrx-132b")
    gen = torch.Generator().manual_seed(5)
    params = TM.init_params(cfg, gen, dtype=torch.float32, device="cpu")
    p = params["layers"][0]["moe"]
    mesh = _mesh((1, 4))
    specs = param_pspecs(cfg, params, mesh, strategy="megatron")
    placed = device_put(p, named_shardings(specs["layers"][0]["moe"], mesh))
    x = torch.randn((2, 9, cfg.d_model), generator=gen)
    seen = []
    real = TL._experts

    def experts(h, *w):
        seen.append(h.clone())
        return real(h, *w)

    monkeypatch.setattr(TL, "_experts", experts)
    want = TL.moe_forward(p, x, cfg)
    (whole,) = seen
    seen.clear()
    got = TL.moe_forward(placed, x, cfg)
    assert len(seen) == 4
    assert all(h.shape[0] == cfg.moe.n_experts_padded // 4 for h in seen)
    assert torch.equal(torch.cat(seen), whole)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("arch,shape", [("llama3-8b", (1, 2)),
                                        ("qwen2-moe-a2.7b", (1, 4))])
def test_serving_engine_takes_the_placed_tree(arch, shape, monkeypatch):
    cfg = reduced(arch)
    params = TM.init_params(cfg, torch.Generator().manual_seed(1),
                            dtype=torch.float32, device="cpu")
    mesh = _mesh(shape)
    placed = device_put(params, named_shardings(
        param_pspecs(cfg, params, mesh, strategy="megatron"), mesh))
    rec = _record(monkeypatch)
    eng = ServingEngine(cfg, placed, max_len=CAP, dtype=torch.float32)
    assert eng.device == CPU and eng.mesh is axis_mesh(mesh)
    assert all(a is b for a, b in zip(tree_flatten(eng.params)[0],
                                      tree_flatten(placed)[0]))
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    got = eng.generate_greedy({"tokens": prompt}, n_tokens=4)
    assert rec["gathered"] == []
    k0 = eng.state["layers"][0]["attn"]["k"]
    assert isinstance(k0, Placed) and k0.spec == tp.HEAD_SPEC
    one = ServingEngine(cfg, params, max_len=CAP, dtype=torch.float32,
                        device="cpu")
    np.testing.assert_array_equal(
        got, one.generate_greedy({"tokens": prompt}, n_tokens=4))
    # an empty state in KV-head pieces decodes as a whole one does
    state = eng.init_state(B)
    assert all(isinstance(t, Placed) for t in _kv_leaves(state))
    tok = torch.from_numpy(prompt[:, :1])
    a, _ = TM.decode_step(cfg, placed, state, tok)
    b, _ = TM.decode_step(cfg, params, one.init_state(B), tok)
    torch.testing.assert_close(a, b, **TOL)


@pytest.mark.parametrize("arch,shape", [("dbrx-132b", (1, 4)),
                                        ("qwen2-moe-a2.7b", (2, 2)),
                                        ("llama3-8b", (2, 2))])
def test_fill_placed_draws_piece_by_piece(arch, shape):
    cfg = reduced(arch)
    mesh = _mesh(shape)
    meta = TM.init_params(cfg, torch.Generator(), dtype=torch.float32,
                          device="meta")
    specs = param_pspecs(cfg, meta, mesh, strategy="megatron")
    shardings = named_shardings(specs, mesh)
    placed = TM.fill_placed(cfg, device_put(meta, shardings), seed=7)
    again = TM.fill_placed(cfg, device_put(meta, shardings), seed=7)
    other = TM.fill_placed(cfg, device_put(meta, shardings), seed=8)
    assert (entry_bytes(placed) == per_device_bytes(meta, specs, mesh)).all()
    drawn = TM.init_params(cfg, torch.Generator().manual_seed(0),
                           dtype=torch.float32, device="cpu")
    split = 0
    for x, y, z, ref in zip(*(tree_flatten(t)[0] for t in
                              (placed, again, other, drawn))):
        assert isinstance(x, Placed)
        size = shard_shape(tuple(x.shape), x.spec, mesh)
        split += size != tuple(x.shape)
        ptrs = {t.data_ptr() for t in x.pieces.flat}
        assert len(ptrs) == x.pieces.size
        assert all(tuple(t.shape) == size for t in x.pieces.flat)
        for i in np.ndindex(x.pieces.shape):
            assert torch.equal(x.pieces[i], y.pieces[i])
        whole = gather(x, CPU)              # replicas hold one block's draw
        if ref.std() == 0:
            assert torch.equal(whole, ref)
            continue
        assert not torch.equal(whole, gather(z, CPU))
        assert abs(float(whole.std() / ref.std()) - 1) < 0.1
    assert split


def test_fill_placed_refuses_what_it_cannot_draw():
    cfg = reduced("hymba-1.5b")
    mesh = _mesh((1, 2))
    meta = TM.init_params(cfg, torch.Generator(), dtype=torch.float32,
                          device="meta")
    meta["layers"][0]["ssm"]["w_extra"] = torch.empty(
        (cfg.d_model, 8), device="meta")
    placed = device_put(meta, named_shardings(
        param_pspecs(cfg, meta, mesh, strategy="megatron"), mesh))
    with pytest.raises(ValueError, match="is not one"):
        TM.fill_placed(cfg, placed, seed=0)
    whole = TM.init_params(reduced("llama3-8b"), torch.Generator(),
                           dtype=torch.float32, device="cpu")
    with pytest.raises(TypeError):
        TM.fill_placed(reduced("llama3-8b"), whole, seed=0)


def test_launch_config_is_the_reference_config():
    """The reduced configs the cases run are the reference's."""
    for arch in ARCHS:
        a, b = jax_reduced(arch), reduced(arch)
        assert (a.n_heads, a.n_kv_heads, a.d_model, a.vocab_padded) == \
            (b.n_heads, b.n_kv_heads, b.d_model, b.vocab_padded)
        assert dataclasses.asdict(a.moe) == dataclasses.asdict(b.moe) \
            if a.moe else b.moe is None
