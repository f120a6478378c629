"""A placed decode state keeps its placement under a decode mesh, port
against port and against reference, on the CPU in float32: reduced
hymba-1.5b (3 layers: 0 and 2 global, 1 sliding a window of 8),
rwkv6-7b (d 128 = 4 heads of 32, so ``cache_pspecs`` splits its shifts
over ``model``) and whisper-tiny, B = 4 rows live to 5 / 70 / 130 / 250
of 256 positions, on (1, 4) and (2, 2) meshes whose entries all name the
CPU.

Every state leaf is a numpy draw from a seed: K/V at every position,
hymba's SSM state, RWKV6's shifts and ``S``, whisper's ``enc_out``.  The
port's per-layer state is placed by ``device_put(state,
named_shardings(cache_pspecs(...), mesh))`` (RWKV6's ``S`` in batch
blocks over ``data``, replicated over ``model``; hymba's SSM state in
channel pieces over ``model``; K/V in sequence pieces); the reference's
stacked state is the same draw.  The JAX package's weights go through
``params_from_jax``.  Four greedy steps, the tokens those of the port's
whole-state decode.

* logits within ``TOL`` of the whole-state decode (hymba and whisper:
  the attention's per-piece partial states are merged, reordered f32
  sums), bitwise for rwkv6-7b (no attention: each piece repeats the
  whole update's arithmetic on its slice); the same greedy tokens;
* logits within the reference's ``decode_step`` at ``JAX_TOL``;
* after every step every leaf a ``Placed`` in its ``cache_pspecs``
  layout, a block's replicas equal, the bytes each entry holds
  ``per_device_bytes``;
* no byte of ``S``, of the SSM state or of K/V gathered (every
  ``sharding._whole`` call counted: only ``len``, the shifts and
  ``enc_out`` are read whole);
* the state bitwise where the arithmetic repeats the whole update's:
  rwkv6-7b's every leaf, hymba's layer-0 SSM state and K/V (its inputs
  depend on the tokens only), whisper's ``enc_out``;
* ``placed_wkv_step`` / ``placed_ssm_step`` alone bitwise the whole
  update, also on a mesh with a replica axis (every replica updated) and
  with ``log_a`` in pieces on the same entries (read in place, never
  gathered); ``ssm_forward``'s whole route bitwise its one-step formula;
* hymba on params in megatron pieces beside the state in pieces, at
  ``TOL``, ``log_a`` never gathered;
* a placed state with no decode mesh is gathered and decodes bitwise as
  the whole state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.distributed import runtime
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.fault import tree_flatten
from repro_torch.distributed.sharding import (Mesh, NamedSharding, Placed,
                                              cache_pspecs, device_put,
                                              entry_bytes, gather,
                                              named_shardings, param_pspecs,
                                              per_device_bytes)
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import sharded_decode as SD

import torch_model_cases as cases

TOL = dict(rtol=1e-5, atol=1e-5)
JAX_TOL = dict(rtol=cases.RTOL, atol=cases.ATOL)
B, S, STEPS = 4, 256, 4
LENS = (5, 70, 130, 250)
MESHES = [(1, 4), (2, 2)]
ARCHS = {"hymba-1.5b": dict(n_layers=3),
         "rwkv6-7b": dict(d_model=128, head_dim=32),
         "whisper-tiny": {}}
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (restored after): its ops
    are small, and the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape, names=("data", "model")):
    return Mesh(np.full(shape, CPU, dtype=object), names)


def _draws(cfg, rng):
    """Per-layer numpy draws of every state leaf but ``len`` (and
    ``enc_out``), in the port's layout."""
    f = np.float32
    d = cfg.d_model

    def normal(*shape):
        return rng.standard_normal(shape).astype(f)

    layers = []
    for _ in range(cfg.n_layers):
        if cfg.family == "ssm":
            layers.append({"shift1": normal(B, d),
                           "S": normal(B, cfg.n_heads, cfg.head_dim,
                                       cfg.head_dim),
                           "shift2": normal(B, d)})
            continue
        kv = (B, S, cfg.n_kv_heads, cfg.head_dim)
        lc = {"attn": {"k": normal(*kv), "v": normal(*kv)}}
        if cfg.family == "hybrid":
            lc["ssm"] = normal(B, cfg.ssm.expand * d, cfg.ssm.state_dim)
        layers.append(lc)
    out = {"layers": layers}
    if cfg.encdec is not None:
        out["enc_out"] = normal(B, cfg.encdec.n_frames, d)
    return out


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v) for v in tree]
    return torch.from_numpy(tree.copy())


def _state(ctx):
    """A fresh whole decode state from the numpy draw."""
    st = _tensors(ctx["draw"])
    st["len"] = torch.tensor(LENS, dtype=torch.int32)
    return st


def _specs(ctx, mesh):
    return cache_pspecs(ctx["cfg"], _state(ctx), mesh)


def _placed_state(ctx, mesh):
    return device_put(_state(ctx), named_shardings(_specs(ctx, mesh), mesh))


def _run(ctx, state, mesh, params=None, after_step=None):
    """Logits (STEPS, B, vocab) of the greedy tokens, and the last state."""
    out = []
    with runtime.use_mesh(mesh):
        for t in ctx["tokens"]:
            logits, state = TM.decode_step(ctx["cfg"], params or
                                           ctx["params"], state,
                                           torch.from_numpy(t))
            out.append(logits.numpy())
            if after_step is not None:
                after_step(state)
    return np.stack(out), state


_CTX = {}


def _context(arch):
    """Configs, params, the state draw, the whole-state decode (its greedy
    tokens, logits and last state) of one arch, made once."""
    if arch not in _CTX:
        jcfg, cfg, jparams, params, seed = cases.make_pair(arch,
                                                           **ARCHS[arch])
        rng = np.random.default_rng(seed)
        out = dict(arch=arch, jcfg=jcfg, cfg=cfg, jparams=jparams,
                   params=params, draw=_draws(cfg, rng), pieces={})
        token = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        state, tokens, logits = _state(out), [], []
        for _ in range(STEPS):
            tokens.append(token)
            lg, state = TM.decode_step(cfg, params, state,
                                       torch.from_numpy(token))
            logits.append(lg.numpy())
            token = lg[:, :cfg.vocab_size].argmax(-1, keepdim=True).to(
                torch.int32).numpy()
        out.update(tokens=tokens, whole=np.stack(logits), whole_state=state)
        _CTX[arch] = out
    return _CTX[arch]


@pytest.fixture(scope="module", params=list(ARCHS))
def ctx(request):
    return _context(request.param)


def _pieces_run(ctx, shape):
    """(logits, last state, the states after each step) of the decode on
    the placed state (run once per arch and mesh)."""
    if shape not in ctx["pieces"]:
        seen = []
        logits, last = _run(ctx, _placed_state(ctx, _mesh(shape)),
                            _mesh(shape), after_step=seen.append)
        ctx["pieces"][shape] = (logits, last, seen)
    return ctx["pieces"][shape]


@pytest.mark.parametrize("shape", MESHES)
def test_logits_match_whole_state(ctx, shape):
    """The greedy steps on the placed state against the whole-state
    decode: rwkv6-7b bitwise, hymba and whisper (attention over sequence
    pieces) within ``TOL``; the greedy tokens are the pieces' argmax."""
    got = _pieces_run(ctx, shape)[0]
    if ctx["cfg"].family == "ssm":
        np.testing.assert_array_equal(got, ctx["whole"])
    np.testing.assert_allclose(got, ctx["whole"], **TOL)
    vocab = ctx["cfg"].vocab_size
    np.testing.assert_array_equal(got[:-1, :, :vocab].argmax(-1),
                                  np.stack(ctx["tokens"])[1:, :, 0])


def _ref_state(ctx):
    """The reference's stacked state of the same draw."""
    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return jnp.asarray(np.stack(trees))

    st = {"len": jnp.asarray(LENS, dtype=jnp.int32),
          "layers": stack(ctx["draw"]["layers"])}
    if "enc_out" in ctx["draw"]:
        st["enc_out"] = jnp.asarray(ctx["draw"]["enc_out"])
    return st


@pytest.mark.parametrize("shape", MESHES)
def test_logits_match_reference(ctx, shape):
    """The same steps within the reference's ``decode_step`` on the
    stacked state of the same draw."""
    if "ref" not in ctx:
        jcfg = ctx["jcfg"]
        state = _ref_state(ctx)
        step = jax.jit(lambda p, s, t: JM.decode_step(jcfg, p, s, t))
        out = []
        for t in ctx["tokens"]:
            logits, state = step(ctx["jparams"], state, jnp.asarray(t))
            out.append(np.asarray(logits))
        ctx["ref"] = np.stack(out)
    got = _pieces_run(ctx, shape)[0]
    np.testing.assert_allclose(got, ctx["ref"], **JAX_TOL)


@pytest.mark.parametrize("shape", MESHES)
def test_leaves_keep_their_layout(ctx, shape):
    """After every step every leaf is a ``Placed`` in its
    ``cache_pspecs`` layout with a block's replicas equal (RWKV6's ``S``
    over ``model``), and each entry holds ``per_device_bytes`` of the
    state."""
    mesh = _mesh(shape)
    specs = _specs(ctx, mesh)
    shardings = tree_flatten(named_shardings(specs, mesh))[0]
    want = per_device_bytes(_state(ctx), specs, mesh)
    steps = _pieces_run(ctx, shape)[2]
    assert len(steps) == STEPS
    for st in steps:
        leaves = tree_flatten(st)[0]
        assert len(leaves) == len(shardings)
        for x, sh in zip(leaves, shardings):
            assert isinstance(x, Placed)
            assert SH._same_layout(x, sh), (x, sh.spec)
            for entries in SH.blocks(x):           # replicas stay equal
                assert all(torch.equal(x.pieces[i], x.pieces[entries[0]])
                           for i in entries[1:])
        assert (entry_bytes(st) == want).all()


@pytest.mark.parametrize("shape", MESHES)
def test_states_never_gathered(ctx, shape, monkeypatch):
    """No byte of ``S``, of the SSM state or of K/V is gathered whole
    over the steps (every ``sharding._whole`` call counted): the leaves
    read whole are ``len``, RWKV6's shifts and whisper's ``enc_out``."""
    seen = []
    real = SH._whole

    def counting(x, device):
        seen.append(tuple(x.shape))
        return real(x, device)

    monkeypatch.setattr(SH, "_whole", counting)
    cfg = ctx["cfg"]
    _run(ctx, _placed_state(ctx, _mesh(shape)), _mesh(shape))
    allowed = {(B,), (B, cfg.d_model)}
    if cfg.encdec is not None:
        allowed.add((B, cfg.encdec.n_frames, cfg.d_model))
    assert seen and set(seen) <= allowed, set(seen)
    if cfg.family == "ssm":
        assert (B, cfg.d_model) in seen


@pytest.mark.parametrize("shape", MESHES)
def test_state_bitwise_where_arithmetic_repeats(ctx, shape):
    """rwkv6-7b's every leaf bitwise the whole decode's; hymba's layer-0
    SSM state and K/V (its inputs depend on the tokens only) too;
    whisper's ``enc_out`` returned as it came."""
    last = _pieces_run(ctx, shape)[1]
    whole = ctx["whole_state"]
    cfg = ctx["cfg"]
    if cfg.family == "ssm":
        pairs = zip(tree_flatten(last)[0], tree_flatten(whole)[0])
    elif cfg.family == "hybrid":
        pairs = [(last["layers"][0][k], whole["layers"][0][k])
                 for k in ("ssm",)]
        pairs += [(last["layers"][0]["attn"][k], whole["layers"][0]["attn"][k])
                  for k in "kv"]
    else:
        pairs = [(last["enc_out"], whole["enc_out"])]
    for got, want in pairs:
        assert torch.equal(gather(got, CPU), want)
    assert torch.equal(gather(last["len"], CPU), whole["len"])


def _draw(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("shape,names", [((1, 4), ("data", "model")),
                                         ((2, 2), ("data", "model")),
                                         ((2, 2, 1), ("rep", "data",
                                                      "model"))])
def test_placed_wkv_step_alone(shape, names):
    """``placed_wkv_step`` bitwise the whole update (``rwkv_time_mix``'s
    loop body), every replica's piece updated alike."""
    rng = np.random.default_rng(5)
    h, dh = 4, 8
    r, v = _draw(rng, B, h, 1, dh), _draw(rng, B, h, 1, dh)
    k, u = _draw(rng, B, h, dh, 1), _draw(rng, 1, h, dh, 1)
    w = torch.sigmoid(_draw(rng, B, h, dh, 1))
    s0 = _draw(rng, B, h, dh, dh)
    kv = k * v
    y_want = r @ torch.addcmul(s0, u, kv)
    s_want = torch.addcmul(kv, w, s0)
    mesh = _mesh(shape, names)
    placed = device_put(s0, NamedSharding(mesh, SH.PartitionSpec("data")))
    y, s1 = SD.placed_wkv_step(r, k, v, w, u, placed)
    assert torch.equal(y, y_want)
    assert torch.equal(gather(s1, CPU), s_want)
    assert s1.sharding == placed.sharding
    for i in np.ndindex(s1.pieces.shape):
        sl = SH.shard_slices(s1.shape, s1.spec, mesh, i)
        assert torch.equal(s1.pieces[i], s_want[sl])


@pytest.mark.parametrize("shape,names", [((1, 4), ("data", "model")),
                                         ((2, 2), ("data", "model")),
                                         ((2, 1, 2), ("rep", "data",
                                                      "model"))])
@pytest.mark.parametrize("log_a_placed", [False, True],
                         ids=["log_a-whole", "log_a-pieces"])
def test_placed_ssm_step_alone(shape, names, log_a_placed, monkeypatch):
    """``placed_ssm_step`` bitwise the whole update (``ssm_forward``'s one
    step), every replica updated alike; ``log_a`` in pieces on the same
    entries is read in place (never gathered)."""
    rng = np.random.default_rng(6)
    di, n = 16, 4
    dt = torch.nn.functional.softplus(_draw(rng, B, di))
    xi, bmat, cmat = _draw(rng, B, di), _draw(rng, B, n), _draw(rng, B, n)
    log_a = -torch.exp(_draw(rng, di, n) * 0.5)
    s0 = _draw(rng, B, di, n)
    h = ((dt[..., None] * log_a).exp_() * s0
         + (dt * xi)[..., None] * bmat[:, None, :])
    y_want = torch.einsum("bsdn,bsn->bsd", h[:, None], cmat[:, None])[:, 0]
    mesh = _mesh(shape, names)
    spec = SH.PartitionSpec("data", "model", None)
    placed = device_put(s0, NamedSharding(mesh, spec))
    la = (device_put(log_a, NamedSharding(mesh, SH.PartitionSpec("model")))
          if log_a_placed else log_a)
    seen = []
    real = SH._whole
    monkeypatch.setattr(SH, "_whole", lambda x, d: seen.append(x.shape)
                        or real(x, d))
    y, s1 = SD.placed_ssm_step(dt, xi, la, bmat, cmat, placed)
    assert not seen
    assert torch.equal(y, y_want)
    assert torch.equal(gather(s1, CPU), h)
    assert s1.sharding == placed.sharding
    for i in np.ndindex(s1.pieces.shape):
        sl = SH.shard_slices(s1.shape, s1.spec, mesh, i)
        assert torch.equal(s1.pieces[i], h[sl])


def test_whole_ssm_step_unchanged():
    """``ssm_forward``'s whole one-step route (no placed state) bitwise
    its formula: ``a = exp(dt log_a)``, ``u = (dt xi) B``, ``h = a state +
    u``, ``y = h · C + D xi``, gated, through ``out_proj``."""
    cfg = dataclasses.replace(cases.reduced("hymba-1.5b"), n_layers=1)
    p = TM.init_params(cfg, torch.Generator().manual_seed(3),
                       dtype=torch.float32, device="cpu")["layers"][0]["ssm"]
    rng = np.random.default_rng(7)
    x = _draw(rng, B, 1, cfg.d_model)
    di = cfg.ssm.expand * cfg.d_model
    state = _draw(rng, B, di, cfg.ssm.state_dim)
    y, new = TL.ssm_forward(p, x, cfg, state=state.clone())
    f = torch.nn.functional
    xz = x @ p["in_proj"]
    xi, z = xz[..., :di], xz[..., di:]
    dt = f.softplus(xi * p["w_dt"] + p["b_dt"])
    a = (dt[..., None] * p["log_a"]).exp_()
    bm, cm = x @ p["w_b"], x @ p["w_c"]
    u = (dt * xi)[..., None] * bm[:, :, None, :]
    h = a[:, 0] * state + u[:, 0]
    want = torch.einsum("bsdn,bsn->bsd", h[:, None], cm)
    want = (want + p["d_skip"] * xi) * f.silu(z)
    assert torch.equal(new, h)
    assert torch.equal(y, want @ p["out_proj"])


def test_params_in_pieces_beside_state_pieces(monkeypatch):
    """hymba on params placed by ``param_pspecs(strategy="megatron")`` on
    the (1, 4) mesh (``log_a`` split along its channels, as the SSM
    state is) with the state in pieces: within ``TOL`` of the whole
    decode, ``log_a`` never gathered."""
    c = _context("hymba-1.5b")
    mesh = _mesh((1, 4))
    cfg = c["cfg"]
    specs = param_pspecs(cfg, c["params"], mesh, strategy="megatron")
    assert specs["layers"][0]["ssm"]["log_a"][0] == "model"
    placed = device_put(c["params"], named_shardings(specs, mesh))
    seen = []
    real = SH._whole
    monkeypatch.setattr(SH, "_whole", lambda x, d: seen.append(
        tuple(x.shape)) or real(x, d))
    got, last = _run(c, _placed_state(c, mesh), mesh, params=placed)
    np.testing.assert_allclose(got, c["whole"], **TOL)
    log_a = tuple(c["params"]["layers"][0]["ssm"]["log_a"].shape)
    assert log_a not in seen
    assert isinstance(last["layers"][1]["ssm"], Placed)


def test_pieces_without_mesh_are_gathered(ctx):
    """A placed state with no decode mesh active is gathered onto the
    params' device and decodes bitwise as the whole state; every leaf
    comes back whole."""
    got, last = _run(ctx, _placed_state(ctx, _mesh((2, 2))), None)
    np.testing.assert_array_equal(got, ctx["whole"])
    assert all(isinstance(x, torch.Tensor) for x in tree_flatten(last)[0])
