"""The prefill writes into a decode state that is already placed, on the
CPU in float32, port against port and against the reference.

Reduced llama3-8b (8 heads, 4 KV heads: the head route on four
entries), hymba-1.5b (3 layers: 0 and 2 global, 1 sliding), minicpm3-4b
(MLA), rwkv6-7b (d 128 = 4 heads of 32, so ``cache_pspecs`` splits its
shifts over ``model``), qwen2-moe-a2.7b and whisper-tiny, B = 2 prompts
of ``PROMPT`` tokens (and whisper's frames) into ``CAP`` positions (4,096
or more: ``cache_pspecs`` splits the sequence; the prompt crosses the
first piece of a (1, 4) mesh), meshes whose entries all name the CPU.
The JAX package's weights go through ``params_from_jax``.

* the prefill into a state placed by ``cache_pspecs`` on (1, 4) and
  (2, 2) meshes (``device_put`` of a ``meta`` state: zero pieces), and
  on megatron params into ``init_decode_state(mesh=)``'s KV-head pieces
  (the head route), against the reference's ``forward_prefill``: logits
  and every state leaf at ``tests/test_torch_model_serving.py``'s rtol /
  atol 1e-4;
* the placed prefill bitwise the port's whole prefill (the cache_pspecs
  meshes: the same arithmetic, only the writes differ) and the head
  route's bitwise its own ``state=None`` prefill (within ``TOL`` of the
  whole params' prefill: its row sums reorder f32 additions);
* the state returned is the one handed in, every leaf the same
  ``Placed`` in its layout with ``per_device_bytes`` an entry, and no
  byte of a placed leaf gathered (``sharding._whole`` and
  ``tensor_parallel.gather`` counted);
* 4 greedy decode steps from the placed prefilled state within ``TOL``
  of the steps from the whole one, the same tokens;
* row blocks (``PREFILL_BLOCK_BYTES`` set to 1 or 2 rows' bytes) against
  the whole-batch prefill: blocks of two rows bitwise (every product is
  per row and keeps its shapes' arithmetic), blocks of one row within
  ``TOL`` (a one-row product is a matrix-vector product on the CPU,
  whose sums run in another order);
* MoE in blocks keeps the whole batch's (token, expert) pairs where the
  capacity drops pairs, which a capacity sized per block would not;
* data blocks on the rows of a (2, 2) megatron mesh, each on its row's
  pieces;
* ``state=None`` bitwise the prefill into a fresh whole state, as
  before; ``ServingEngine.prefill`` fills its own ``init_state``;
  ``build_prefill_step`` passes the state through; a state of another
  capacity raises.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.distributed import runtime
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.fault import tree_flatten, tree_map
from repro_torch.distributed.sharding import (Mesh, Placed, cache_pspecs,
                                              device_put, entry_bytes,
                                              gather, named_shardings,
                                              param_pspecs, per_device_bytes)
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import tensor_parallel as TP
from repro_torch.serve.engine import ServingEngine
from repro_torch.train import steps as TS

import torch_model_cases as cases

RTOL = ATOL = 1e-4
TOL = dict(rtol=1e-5, atol=1e-5)
B, PROMPT, CAP, STEPS = 2, 1030, 4096, 4
ARCHS = {"llama3-8b": dict(n_heads=8, n_kv_heads=4),
         "hymba-1.5b": dict(n_layers=3),
         "minicpm3-4b": {},
         "rwkv6-7b": dict(d_model=128, head_dim=32),
         "qwen2-moe-a2.7b": {},
         "whisper-tiny": {}}
# where the state lies: placed by cache_pspecs on these meshes, or
# "heads": megatron params on (1, 4) and the head route's state
WHERE = [(1, 4), (2, 2)]
CASES = [(a, w) for a in ARCHS for w in WHERE] + [("llama3-8b", "heads")]
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (restored after): its ops
    are small, and the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    return Mesh(np.full(shape, CPU, dtype=object), ("data", "model"))


_CTX = {}


def _context(arch):
    """Configs, params, the batch, the reference's prefill and the port's
    whole prefill of one arch, made once."""
    if arch not in _CTX:
        jcfg, cfg, jparams, params, seed = cases.make_pair(arch,
                                                           **ARCHS[arch])
        rng = np.random.default_rng(seed)
        batch = cases.model_batch(jcfg, rng, B, PROMPT)
        jlog, jst = JM.forward_prefill(jcfg, jparams, cases.as_jax(batch),
                                       cache_capacity=CAP)
        logits, state = TM.forward_prefill(cfg, params,
                                           cases.as_torch(batch),
                                           cache_capacity=CAP)
        _CTX[arch] = dict(cfg=cfg, params=params, batch=batch, runs={},
                          ref=(np.asarray(jlog),
                               jax.tree.map(np.asarray, jst)),
                          whole=(logits, state),
                          first=rng.integers(0, cfg.vocab_size, (B, 1))
                          .astype(np.int32))
    return _CTX[arch]


def _meta(cfg):
    return TM.init_decode_state(cfg, B, CAP, dtype=torch.float32,
                                device="meta")


def _target(ctx, where):
    """(params, an empty state placed as ``where`` says, its shardings:
    None on the head route, whose K/V only are placed)."""
    cfg = ctx["cfg"]
    if where == "heads":
        mesh = _mesh((1, 4))
        params = device_put(ctx["params"], named_shardings(param_pspecs(
            cfg, ctx["params"], mesh, strategy="megatron"), mesh))
        return params, TM.init_decode_state(
            cfg, B, CAP, dtype=torch.float32,
            mesh=TM.kv_head_mesh(cfg, params)), None
    mesh = _mesh(where)
    meta = _meta(cfg)
    shardings = named_shardings(cache_pspecs(cfg, meta, mesh), mesh)
    return ctx["params"], device_put(meta, shardings), shardings


def _prefill(ctx, where):
    """(params, the state handed in, logits, the state returned, the
    shapes gathered whole during the call), once per arch and place."""
    if where not in ctx["runs"]:
        params, state, shardings = _target(ctx, where)
        seen = []
        whole, gat = SH._whole, TP.gather

        def counting(real):
            def f(x, device):
                seen.append(tuple(x.shape))
                return real(x, device)
            return f

        SH._whole, TP.gather = counting(whole), counting(gat)
        try:
            logits, out = TM.forward_prefill(
                ctx["cfg"], params, cases.as_torch(ctx["batch"]),
                cache_capacity=CAP, state=state)
        finally:
            SH._whole, TP.gather = whole, gat
        ctx["runs"][where] = dict(params=params, state=state,
                                  shardings=shardings, logits=logits,
                                  out=out, seen=seen)
    return ctx["runs"][where]


@pytest.mark.parametrize("arch,where", CASES)
def test_placed_prefill_matches_reference(arch, where):
    """Logits and every leaf of the placed state, gathered, within the
    reference's ``forward_prefill`` at rtol / atol 1e-4."""
    ctx = _context(arch)
    run = _prefill(ctx, where)
    jlog, jst = ctx["ref"]
    np.testing.assert_allclose(run["logits"].numpy(), jlog, rtol=RTOL,
                               atol=ATOL)
    ref = {k: v for k, v in jst.items() if k != "len"}
    got = {k: v for k, v in gather(run["out"], CPU).items() if k != "len"}
    for i, (g, w) in enumerate(cases.leaf_pairs(got, ref, ctx["cfg"])):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"state leaf {i}")
    np.testing.assert_array_equal(gather(run["out"]["len"], CPU).numpy(),
                                  jst["len"])


@pytest.mark.parametrize("arch,where", CASES)
def test_placed_prefill_against_the_port(arch, where):
    """On ``cache_pspecs``' meshes bitwise the whole prefill; on the head
    route bitwise the same params' ``state=None`` prefill and within
    ``TOL`` of the whole params'."""
    ctx = _context(arch)
    run = _prefill(ctx, where)
    logits, state = ctx["whole"]
    if where == "heads":
        logits_none, state = TM.forward_prefill(
            ctx["cfg"], run["params"], cases.as_torch(ctx["batch"]),
            cache_capacity=CAP)
        assert torch.equal(run["logits"], logits_none)
        np.testing.assert_allclose(run["logits"].numpy(),
                                   ctx["whole"][0].numpy(), **TOL)
    else:
        assert torch.equal(run["logits"], logits)
    for got, want in zip(tree_flatten(gather(run["out"], CPU))[0],
                         tree_flatten(gather(state, CPU))[0]):
        assert torch.equal(got, want)


@pytest.mark.parametrize("arch,where", CASES)
def test_state_filled_in_place(arch, where):
    """The state returned is the one handed in: every leaf the same
    object (its pieces the same tensors), a ``Placed`` in its layout
    where placed, ``per_device_bytes`` an entry, and no byte of a
    placed leaf gathered whole during the prefill (nor of a params
    leaf)."""
    ctx = _context(arch)
    run = _prefill(ctx, where)
    assert run["out"] is run["state"]
    assert not run["seen"], run["seen"]
    cfg = ctx["cfg"]
    if where == "heads":
        kv = [lc["attn"][k] for lc in run["out"]["layers"] for k in "kv"]
        assert all(isinstance(x, Placed) and x.spec == TP.HEAD_SPEC
                   for x in kv)
        return
    mesh = _mesh(where)
    for x, sh in zip(tree_flatten(run["out"])[0],
                     tree_flatten(run["shardings"])[0]):
        assert isinstance(x, Placed) and SH._same_layout(x, sh)
        for entries in SH.blocks(x):               # replicas equal
            assert all(torch.equal(x.pieces[i], x.pieces[entries[0]])
                       for i in entries[1:])
    want = per_device_bytes(_meta(cfg), cache_pspecs(cfg, _meta(cfg),
                                                     mesh), mesh)
    assert (entry_bytes(run["out"]) == want).all()


def _greedy(ctx, params, state, mesh):
    cfg = ctx["cfg"]
    tok, out = torch.from_numpy(ctx["first"]), []
    with runtime.use_mesh(mesh):
        for _ in range(STEPS):
            logits, state = TM.decode_step(cfg, params, state, tok)
            out.append(logits.numpy())
            tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True).to(
                torch.int32)
    return np.stack(out)


@pytest.mark.parametrize("arch,where", CASES)
def test_decode_continues_from_placed_prefill(arch, where):
    """4 greedy steps from the placed prefilled state (under its decode
    mesh; the head route with none) within ``TOL`` of the steps from the
    whole prefilled state, the same tokens."""
    ctx = _context(arch)
    run = _prefill(ctx, where)
    whole = _greedy(ctx, ctx["params"], tree_map(torch.clone,
                                                 ctx["whole"][1]), None)
    got = _greedy(ctx, run["params"], run["out"],
                  None if where == "heads" else _mesh(where))
    np.testing.assert_allclose(got, whole, **TOL)
    vocab = ctx["cfg"].vocab_size
    np.testing.assert_array_equal(got[..., :vocab].argmax(-1),
                                  whole[..., :vocab].argmax(-1))


def _short(arch, **replace):
    """A reduced config and params for the short prompts of the block
    tests (8 rows of 40 tokens into 64 positions)."""
    cfg = dataclasses.replace(_context(arch)["cfg"], **replace)
    params = _context(arch)["params"]
    rng = np.random.default_rng(3)
    batch = cases.as_torch(cases.model_batch(cfg, rng, 8, 40))
    return cfg, params, batch


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("rows", [1, 2])
def test_row_blocks_against_whole_batch(arch, rows, monkeypatch):
    """``PREFILL_BLOCK_BYTES`` set to ``rows`` rows' bytes: 8 / ``rows``
    blocks, each written into its rows of a placed (2, 2) state; blocks
    of two rows bitwise the whole batch's logits and state, of one row
    within ``TOL``."""
    cfg, params, batch = _short(arch)
    mesh = _mesh((2, 2))
    logits, state = TM.forward_prefill(cfg, params, batch,
                                       cache_capacity=64)
    s = batch["tokens"].shape[1]
    monkeypatch.setattr(TM, "PREFILL_BLOCK_BYTES",
                        rows * TM._prefill_row_bytes(cfg, params, s))
    assert len(TM._prefill_blocks(cfg, params, 8, s)) == 8 // rows
    meta = TM.init_decode_state(cfg, 8, 64, dtype=torch.float32,
                                device="meta")
    placed = device_put(meta, named_shardings(cache_pspecs(cfg, meta, mesh),
                                              mesh))
    got, out = TM.forward_prefill(cfg, params, batch, cache_capacity=64,
                                  state=placed)
    pairs = list(zip(tree_flatten(gather(out, CPU))[0],
                     tree_flatten(state)[0]))
    if rows == 2:
        assert torch.equal(got, logits)
        assert all(torch.equal(g, w) for g, w in pairs)
    np.testing.assert_allclose(got.numpy(), logits.numpy(), **TOL)
    for g, w in pairs:
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


class _Pairs:
    """Every ``moe_dispatch`` call's kept (token, expert) pairs, tokens
    numbered from the call's first, and its routed experts."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = TL.moe_dispatch

        def dispatch(top_i, cfg, route=None):
            out = real(top_i, cfg, route)
            self.calls.append((top_i.clone(), out))
            return out

        monkeypatch.setattr(TL, "moe_dispatch", dispatch)

    def kept(self, cfg, n_layers, per_block=False):
        """[layer] -> the kept pairs of the prefill's blocks (calls in
        block-major order), tokens numbered in the batch; ``per_block``:
        as a capacity sized from each block's own tokens keeps them."""
        ep = cfg.moe.n_experts_padded
        layers = [set() for _ in range(n_layers)]
        off = 0
        for j in range(0, len(self.calls), n_layers):
            for sets, (top_i, out) in zip(layers,
                                          self.calls[j:j + n_layers]):
                _, se, st, slot, cap = (TL.moe_dispatch(top_i, cfg)
                                        if per_block else out)
                keep = slot < ep * cap
                sets |= {(off + int(t), int(e))
                         for t, e in zip(st[keep], se[keep])}
            off += self.calls[j][0].shape[0]
        return layers


def test_moe_blocks_keep_the_whole_batch_pairs(monkeypatch):
    """qwen2-moe-a2.7b at capacity factor 0.5 (the capacity drops pairs):
    a prefill in blocks of two rows keeps, layer by layer, the pairs the
    whole batch keeps, where a capacity sized per block keeps another
    set; its logits bitwise the whole batch's."""
    arch = "qwen2-moe-a2.7b"
    base = _context(arch)["cfg"]
    cfg, params, batch = _short(arch, moe=dataclasses.replace(
        base.moe, capacity_factor=0.5))
    s = batch["tokens"].shape[1]
    whole = _Pairs(monkeypatch)
    logits, _ = TM.forward_prefill(cfg, params, batch, cache_capacity=64)
    want = whole.kept(cfg, cfg.n_layers)
    assert all(len(w) < 8 * s * cfg.moe.top_k for w in want)
    monkeypatch.undo()
    monkeypatch.setattr(TM, "PREFILL_BLOCK_BYTES",
                        2 * TM._prefill_row_bytes(cfg, params, s))
    blocked = _Pairs(monkeypatch)
    got, _ = TM.forward_prefill(
        cfg, params, batch, cache_capacity=64,
        state=TM.init_decode_state(cfg, 8, 64, dtype=torch.float32,
                                   device="cpu"))
    assert len(blocked.calls) == 4 * cfg.n_layers
    assert blocked.kept(cfg, cfg.n_layers) == want
    assert blocked.kept(cfg, cfg.n_layers, per_block=True) != want
    assert torch.equal(got, logits)


def test_data_blocks_on_mesh_rows():
    """Megatron params on a (2, 2) mesh: the batch's two data blocks run
    on the two rows' pieces (each view's leaves on its row), written
    into a (2, 2) ``cache_pspecs`` state; logits and state within
    ``TOL`` of the whole prefill."""
    c = _context("llama3-8b")
    cfg = c["cfg"]
    mesh = _mesh((2, 2))
    params = device_put(c["params"], named_shardings(param_pspecs(
        cfg, c["params"], mesh, strategy="megatron"), mesh))
    blocks = TM._prefill_blocks(cfg, params, B, PROMPT)
    assert [b[0] for b in blocks] == [slice(0, 1), slice(1, 2)]
    for j, (_, view) in enumerate(blocks):
        assert all(x.mesh.shape["data"] == 1 for x in tree_flatten(view)[0])
        assert view["embed"].pieces.shape == (1, 2)
        assert view["embed"].pieces[0, 0] is params["embed"].pieces[j, 0]
    meta = _meta(cfg)
    state = device_put(meta, named_shardings(cache_pspecs(cfg, meta, mesh),
                                             mesh))
    logits, out = TM.forward_prefill(cfg, params,
                                     cases.as_torch(c["batch"]),
                                     cache_capacity=CAP, state=state)
    np.testing.assert_allclose(logits.numpy(), c["whole"][0].numpy(), **TOL)
    for g, w in zip(tree_flatten(gather(out, CPU))[0],
                    tree_flatten(c["whole"][1])[0]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_state_none_unchanged(arch):
    """``state=None`` bitwise the prefill into a fresh whole state (the
    same logits, every leaf equal, the caches padded to the capacity
    with zeros), and ``build_prefill_step`` passes a state through."""
    cfg, params, batch = _short(arch)
    logits, state = TM.forward_prefill(cfg, params, batch,
                                       cache_capacity=64)
    fresh = TM.init_decode_state(cfg, 8, 64, dtype=torch.float32,
                                 device="cpu")
    got, out = TS.build_prefill_step(cfg, cache_capacity=64)(params, batch,
                                                             fresh)
    assert out is fresh
    assert torch.equal(got, logits)
    leaves = tree_flatten(state)[0]
    assert len(leaves) == len(tree_flatten(out)[0])
    for g, w in zip(tree_flatten(out)[0], leaves):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if cfg.family != "ssm":
        k = next(iter(state["layers"][0]["attn"].values()))
        assert k.shape[1] == 64 and not k[:, 40:].any()


def test_engine_prefills_its_own_state(monkeypatch):
    """``ServingEngine.prefill`` on megatron params fills the state its
    ``init_state`` made (K/V in KV-head pieces) and keeps it; its logits
    and state bitwise ``forward_prefill(state=None)``'s."""
    c = _context("llama3-8b")
    run = _prefill(c, "heads")
    eng = ServingEngine(c["cfg"], run["params"], max_len=CAP,
                        dtype=torch.float32)
    made = []
    real = eng.init_state
    monkeypatch.setattr(eng, "init_state",
                        lambda b: made.append(real(b)) or made[-1])
    logits = eng.prefill(c["batch"])
    assert len(made) == 1 and eng.state is made[0]
    assert isinstance(eng.state["layers"][0]["attn"]["k"], Placed)
    want, state = TM.forward_prefill(c["cfg"], run["params"],
                                     cases.as_torch(c["batch"]),
                                     cache_capacity=CAP)
    np.testing.assert_array_equal(logits, want.numpy())
    for g, w in zip(tree_flatten(gather(eng.state, CPU))[0],
                    tree_flatten(gather(state, CPU))[0]):
        assert torch.equal(g, w)


def test_state_of_another_shape_raises():
    """A state whose capacity or rows differ from the call's raises."""
    cfg, params, batch = _short("llama3-8b")
    for rows, cap in ((8, 32), (4, 64)):
        state = TM.init_decode_state(cfg, rows, cap, dtype=torch.float32,
                                     device="cpu")
        with pytest.raises(ValueError, match="does not take a prefill"):
            TM.forward_prefill(cfg, params, batch, cache_capacity=64,
                               state=state)
