"""MLA's latent cache read and written in its sequence pieces under a
decode mesh, port against port and against reference, on the CPU in
float32: reduced minicpm3-4b (2 layers, kv_rank 16 + rope 8, 4 heads),
B = 4, a latent of 4,096 positions (so ``cache_pspecs`` splits its
sequence over ``model`` and its batch over ``data``), (1, 4) and (2, 2)
meshes whose entries all name the CPU.

The latent is a numpy draw from a seed (every position, live or not),
the rows' lengths 5, 1,030, 2,500 and 4,000: on (1, 4) (chunks of
1,024) row 0 lives in chunk 0 alone, on (2, 2) (chunks of 2,048) both
rows of data block 0 do.  The reference's stacked (L, B, S, 24) latent
is the same draw; the port's per-layer latents are placed by
``device_put(state, named_shardings(cache_pspecs(...), mesh))``.  The
JAX package's weights go through ``params_from_jax``.  Four greedy
steps, the tokens those of the port's whole-cache decode.

* (a) logits within 1e-5 of the port's whole-cache decode (two f32
  orders of one softmax: per piece, then merged);
* (b) logits within the JAX reference's ``decode_step`` at
  ``tests/test_torch_mla.py``'s bars (rtol 1e-4, atol 1e-6);
* (c) after the steps every piece bitwise equal to its slice of the
  whole latent that the same writes make (the owner-or-old write), and
  layer 0's (whose latents depend on the tokens only) bitwise the
  whole-cache decode's;
* (d) the latent the same ``Placed`` pieces after every step, 0 bytes
  of it gathered (every ``sharding._whole`` call counted: only ``len``);
* (e) params in megatron pieces (``param_pspecs``, ``k_up`` / ``v_up`` by
  head group) beside the latent in sequence pieces, at (a)'s bar;
* ``sharded_mla_decode`` alone on a mesh with a replica axis: replicas
  written, never read, the output the replica-free mesh's bitwise;
* a latent in pieces with no decode mesh is gathered and decodes
  bitwise as the whole latent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.distributed import runtime
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import (Mesh, Placed, cache_pspecs,
                                              device_put, gather,
                                              named_shardings, param_pspecs,
                                              shard_slices)
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import sharded_decode as SD

import torch_model_cases as cases

TOL = dict(rtol=1e-5, atol=1e-5)
JAX_TOL = dict(rtol=cases.RTOL, atol=cases.ATOL)
B, S, STEPS = 4, 4096, 4
LENS = (5, 1030, 2500, 4000)
MESHES = [(1, 4), (2, 2)]
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


def _state(ctx):
    """A fresh whole decode state from the numpy draw."""
    return {"len": torch.tensor(LENS, dtype=torch.int32),
            "layers": [{"attn": {"latent": torch.from_numpy(lat.copy())}}
                       for lat in ctx["latent"]]}


def _placed_state(ctx, mesh):
    st = _state(ctx)
    return device_put(st, named_shardings(cache_pspecs(ctx["cfg"], st, mesh),
                                          mesh))


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


@pytest.fixture(scope="module")
def ctx():
    """Configs, params, the latent draw, the whole-cache decode (its
    greedy tokens, logits and last state)."""
    jcfg, cfg, jparams, params, seed = cases.make_pair("minicpm3-4b")
    rng = np.random.default_rng(seed)
    width = cfg.mla.kv_rank + cfg.mla.rope_dim
    out = dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
               latent=[rng.standard_normal((B, S, width)).astype(np.float32)
                       for _ in range(cfg.n_layers)])
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
    return out


@pytest.fixture(scope="module")
def pieces():
    """{mesh shape: (logits, last state, [(a layer's lat_new, pos)] in
    call order)} of the decode on the placed state."""
    return {}


def _pieces_run(ctx, pieces, shape):
    if shape not in pieces:
        mesh = _mesh(shape)
        state = _placed_state(ctx, mesh)
        writes = []
        real = TL.sharded_mla_decode

        def recording(q_abs, q_rope, cl, lat_new, pos, *a, **kw):
            writes.append((lat_new.clone(), pos.clone()))
            return real(q_abs, q_rope, cl, lat_new, pos, *a, **kw)

        TL.sharded_mla_decode = recording
        try:
            logits, last = _run(ctx, state, mesh)
        finally:
            TL.sharded_mla_decode = real
        pieces[shape] = (logits, last, writes)
    return pieces[shape]


@pytest.mark.parametrize("shape", MESHES)
def test_logits_match_whole_cache(ctx, pieces, shape):
    """(a) The greedy steps on the latent in pieces within 1e-5 of the
    whole-cache decode; the greedy tokens are the pieces' argmax too."""
    got = _pieces_run(ctx, pieces, shape)[0]
    np.testing.assert_allclose(got, ctx["whole"], **TOL)
    vocab = ctx["cfg"].vocab_size
    np.testing.assert_array_equal(got[:-1, :, :vocab].argmax(-1),
                                  np.stack(ctx["tokens"])[1:, :, 0])


@pytest.mark.parametrize("shape", MESHES)
def test_logits_match_reference(ctx, pieces, shape):
    """(b) The same steps within the reference's ``decode_step`` on the
    stacked latent of the same draw."""
    if "ref" not in ctx:
        jcfg = ctx["jcfg"]
        state = {"len": jnp.asarray(LENS, dtype=jnp.int32),
                 "layers": {"attn": {"latent": jnp.asarray(
                     np.stack(ctx["latent"]))}}}
        step = jax.jit(lambda p, s, t: JM.decode_step(jcfg, p, s, t))
        out = []
        for t in ctx["tokens"]:
            logits, state = step(ctx["jparams"], state, jnp.asarray(t))
            out.append(np.asarray(logits))
        ctx["ref"] = np.stack(out)
    got = _pieces_run(ctx, pieces, shape)[0]
    np.testing.assert_allclose(got, ctx["ref"], **JAX_TOL)


@pytest.mark.parametrize("shape", MESHES)
def test_pieces_hold_their_writes(ctx, pieces, shape):
    """(c) Every piece bitwise its slice of the whole latent that the
    steps' writes make; layer 0's bitwise the whole-cache decode's."""
    _, last, writes = _pieces_run(ctx, pieces, shape)
    cfg = ctx["cfg"]
    want = [torch.from_numpy(lat.copy()) for lat in ctx["latent"]]
    rows = torch.arange(B)
    for k, (lat_new, pos) in enumerate(writes):
        want[k % cfg.n_layers][rows, pos.long()] = lat_new[:, 0]
    for layer, lc in enumerate(last["layers"]):
        cl = lc["attn"]["latent"]
        for i in np.ndindex(cl.pieces.shape):
            sl = shard_slices(cl.shape, cl.spec, cl.mesh, i)
            assert torch.equal(cl.pieces[i], want[layer][sl]), (layer, i)
    assert torch.equal(gather(last["layers"][0]["attn"]["latent"], CPU),
                       ctx["whole_state"]["layers"][0]["attn"]["latent"])


@pytest.mark.parametrize("shape", MESHES)
def test_latent_never_gathered(ctx, shape, monkeypatch):
    """(d) After every step the latent is the same ``Placed`` pieces,
    written in place, and no byte of it was gathered whole: the only
    leaf gathered is ``len``."""
    mesh = _mesh(shape)
    state = _placed_state(ctx, mesh)
    first = [lc["attn"]["latent"] for lc in state["layers"]]
    seen = []
    real = SH._whole

    def counting(x, device):
        seen.append((tuple(x.shape), x.shape.numel() * x.element_size()))
        return real(x, device)

    def same_pieces(st):
        for lc, cl in zip(st["layers"], first):
            got = lc["attn"]["latent"]
            assert isinstance(got, Placed)
            assert all(a is b for a, b in zip(got.pieces.flat,
                                              cl.pieces.flat))

    monkeypatch.setattr(SH, "_whole", counting)
    _run(ctx, state, mesh, after_step=same_pieces)
    latent_bytes = sum(n for shp, n in seen if len(shp) == 3)
    assert latent_bytes == 0
    assert seen and all(shp == (B,) for shp, _ in seen)


@pytest.mark.parametrize("shape", MESHES)
def test_megatron_params_with_latent_pieces(ctx, shape):
    """(e) Params placed by ``param_pspecs(strategy="megatron")`` on the
    mesh (``k_up`` / ``v_up`` read by head group on their entries) with
    the latent in sequence pieces: within 1e-5 of the whole decode."""
    mesh = _mesh(shape)
    cfg = ctx["cfg"]
    specs = param_pspecs(cfg, ctx["params"], mesh, strategy="megatron")
    assert specs["layers"][0]["attn"]["k_up"][1] == "model"
    placed = device_put(ctx["params"], named_shardings(specs, mesh))
    got, last = _run(ctx, _placed_state(ctx, mesh), mesh, params=placed)
    np.testing.assert_allclose(got, ctx["whole"], **TOL)
    assert isinstance(last["layers"][1]["attn"]["latent"], Placed)


def test_replicas_written_not_read(ctx):
    """``sharded_mla_decode`` on a ("rep", "data", "model") mesh of
    (2, 1, 4): each replica's pieces are written (equal to the first's),
    and the output is the (1, 4) mesh's bitwise."""
    cfg = ctx["cfg"]
    m = cfg.mla
    rng = np.random.default_rng(3)
    h = cfg.n_heads

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    q_abs, q_rope = draw(B, 1, h, m.kv_rank), draw(B, 1, h, m.rope_dim)
    lat_new = draw(B, 1, m.kv_rank + m.rope_dim)
    pos = torch.tensor(LENS, dtype=torch.int32)
    scale = (m.nope_dim + m.rope_dim) ** -0.5
    outs = {}
    for shape, names in (((1, 4), ("data", "model")),
                         ((2, 1, 4), ("rep", "data", "model"))):
        mesh = _mesh(shape, names)
        o, cl = SD.sharded_mla_decode(
            q_abs, q_rope, torch.from_numpy(ctx["latent"][0].copy()),
            lat_new, pos, mesh, m.kv_rank, scale)
        outs[shape] = o
        assert cl.pieces.shape == shape
    rep = cl.pieces
    for i in np.ndindex(rep.shape[1:]):
        assert torch.equal(rep[(0,) + i], rep[(1,) + i])
    assert torch.equal(outs[(1, 4)], outs[(2, 1, 4)])
    assert outs[(1, 4)].shape == (B, 1, h, m.kv_rank)


def test_pieces_without_mesh_are_gathered(ctx):
    """A latent in pieces with no decode mesh active is gathered onto the
    params' device and decodes bitwise as the whole latent."""
    got, last = _run(ctx, _placed_state(ctx, _mesh((2, 2))), None)
    np.testing.assert_array_equal(got, ctx["whole"])
    assert isinstance(last["layers"][0]["attn"]["latent"], torch.Tensor)
