"""Sequence-sharded decode, port against reference, on reduced llama3-8b
and hymba-1.5b (4 layers: layer 1 slides a window of 8) in float32 on
the CPU; the JAX package's weights go through ``params_from_jax``.

* the port's (1, 1) host mesh against the reference's singleton-mesh
  ``decode_step`` (the reference's own test, ``tests/test_sharded_
  decode.py``: three tokens from an empty state);
* the port's (1, 2) and (1, 4) meshes over the CPU against the
  reference's unsharded decode, after a 12-token prompt in a cache of
  32: hymba's sliding layer has shards its live range misses;
* the cache in pieces (``distributed.sharding.Placed``, one contiguous
  tensor per mesh entry, (1, 2), (1, 4) and (2, 2) meshes), handed in
  placed or whole (placed at the first step): logits against the
  reference's unsharded decode, the gathered cache bitwise the writes
  the decode made (and layer 0's, whose K/V depend on the tokens only,
  bitwise the unsharded decode's), every other leaf returned as handed
  in (a placed one in its layout, a whole one whole);
* a cache length the axis does not divide takes the unsharded path;
* ``sharded_decode_attention`` alone: a shard with no live key adds the
  merge identity and reads one key row of its chunk (the kernel's rule
  for an empty row would read every value row), the new token is
  written by its owner only.

Bar: rtol/atol 2e-4 on logits (the reference's own,
``tests/test_sharded_decode.py``); caches bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.distributed import runtime as jax_runtime
from repro.models import model as JM
from repro_torch.configs import reduced
from repro_torch.distributed import runtime
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import (Mesh, NamedSharding, Placed,
                                              cache_pspecs, device_put,
                                              gather, named_shardings)
from repro_torch.kernels.flash_decode import ref as fd_ref
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as TM
from repro_torch.models import sharded_decode as SD

TOL = dict(rtol=2e-4, atol=2e-4)
B, PROMPT, STEPS, CAP = 2, 12, 6, 32
CPU = torch.device("cpu")
CASES = [("llama3-8b", 2), ("hymba-1.5b", 4)]


def _mesh(n, data=1):
    return Mesh(np.array([[CPU] * n] * data, dtype=object),
                ("data", "model"))


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}-L{n}" for a, n in CASES])
def pair(request):
    arch, n_layers = request.param
    jcfg = dataclasses.replace(jax_reduced(arch), n_layers=n_layers)
    tcfg = dataclasses.replace(reduced(arch), n_layers=n_layers)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tparams = TM.params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                                 device="cpu")
    rng = np.random.default_rng(sum(map(ord, arch)) + n_layers)
    prompt = rng.integers(0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    steps = rng.integers(0, jcfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, prompt, steps


@pytest.fixture(scope="module")
def ref_unsharded(pair):
    """The reference's unsharded decode of the pair's steps after its
    prompt (one jit for every case of the pair)."""
    jcfg, _, jparams, _, prompt, steps = pair
    return _ref_decode(jcfg, jparams, steps, prompt)


def _port_decode(tcfg, tparams, tokens, mesh, prompt=None, cap=CAP):
    if prompt is None:
        state = TM.init_decode_state(tcfg, B, cap, dtype=torch.float32,
                                     device="cpu")
    else:
        _, state = TM.forward_prefill(
            tcfg, tparams, {"tokens": torch.from_numpy(prompt)},
            cache_capacity=cap)
    out = []
    with runtime.use_mesh(mesh):
        for t in tokens:
            logits, state = TM.decode_step(tcfg, tparams, state,
                                           torch.from_numpy(t))
            out.append(logits.numpy())
    return np.stack(out)


def _ref_decode(jcfg, jparams, tokens, prompt=None, cap=CAP):
    if prompt is None:
        state = JM.init_decode_state(jcfg, B, cap, dtype=jnp.float32)
    else:
        _, state = JM.forward_prefill(jcfg, jparams,
                                      {"tokens": jnp.asarray(prompt)},
                                      cache_capacity=cap)
    step = jax.jit(lambda p, s, t: JM.decode_step(jcfg, p, s, t))
    out = []
    for t in tokens:
        logits, state = step(jparams, state, jnp.asarray(t))
        out.append(np.asarray(logits))
    return np.stack(out)


def _count_shard_calls(monkeypatch):
    calls = []
    real = SD.sharded_decode_attention

    def counting(*args, **kw):
        calls.append(args[6].shape["model"])
        return real(*args, **kw)

    monkeypatch.setattr("repro_torch.models.layers.sharded_decode_attention",
                        counting)
    return calls


def test_singleton_mesh_matches_reference_singleton_mesh(pair, monkeypatch):
    jcfg, tcfg, jparams, tparams, _, _ = pair
    toks = [np.full((B, 1), t, np.int32) for t in (3, 7, 11)]
    with jax_runtime.use_mesh(jax.make_mesh((1, 1), ("data", "model")),
                              decode_axis="model"):
        want = _ref_decode(jcfg, jparams, toks)
    calls = _count_shard_calls(monkeypatch)
    got = _port_decode(tcfg, tparams, toks, make_host_mesh())
    assert calls and set(calls) == {1}
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_sequence_shards_match_reference_unsharded(pair, ref_unsharded, n,
                                                  monkeypatch):
    jcfg, tcfg, jparams, tparams, prompt, steps = pair
    want = ref_unsharded
    calls = _count_shard_calls(monkeypatch)
    got = _port_decode(tcfg, tparams, steps, _mesh(n), prompt)
    assert len(calls) == STEPS * tcfg.n_layers and set(calls) == {n}
    np.testing.assert_allclose(got, want, **TOL)
    # and the port's own unsharded decode
    np.testing.assert_allclose(got, _port_decode(tcfg, tparams, steps, None,
                                                 prompt), **TOL)


def test_sliding_layer_misses_whole_shards(pair):
    """At the 4-shard mesh every layer has shards past its live range at
    every decode step, and hymba's sliding layer (window 8) also leaves
    the first shard behind once its window has passed it."""
    _, tcfg = pair[:2]
    windows = [w for w in TM._windows(tcfg) if w]
    assert bool(windows) == (tcfg.family == "hybrid")
    behind = set()
    for pos in range(PROMPT, PROMPT + STEPS):
        p = torch.full((B,), pos, dtype=torch.int32)
        for w in [0] + windows:
            live = [bool(SD.chunk_range(p, sh * CAP // 4, CAP // 4, w)[2]
                         .any()) for sh in range(4)]
            assert not all(live) and any(live)
            if not live[0]:
                behind.add(w)
    assert behind == set(windows)


def test_indivisible_cache_takes_the_unsharded_path(pair, monkeypatch):
    jcfg, tcfg, jparams, tparams, prompt, steps = pair
    calls = _count_shard_calls(monkeypatch)
    got = _port_decode(tcfg, tparams, steps, _mesh(4), prompt, cap=30)
    assert calls == []
    np.testing.assert_array_equal(
        got, _port_decode(tcfg, tparams, steps, None, prompt, cap=30))
    np.testing.assert_allclose(
        got, _ref_decode(jcfg, jparams, steps, prompt, cap=30), **TOL)


@pytest.mark.parametrize("window", [0, 5])
def test_dead_shards_add_the_identity_and_read_one_key(window, monkeypatch):
    """Rows whose live range misses a shard: the merged output equals one
    softmax over the live keys, and each dead (row, shard) hands the
    partials call, on its piece of the cache, the chunk's first key (the
    plain version, like the kernel, reads every value row of an empty
    range).  The new token lands in its owner's piece, in place; every
    other slot keeps its bits (NaN poison included)."""
    rng = np.random.default_rng(window)
    b, s, hkv, g, d, n = 3, 64, 2, 3, 16, 4
    q = torch.from_numpy(rng.normal(size=(b, 1, hkv * g, d))
                         .astype(np.float32))
    ck = torch.from_numpy(rng.normal(size=(b, s, hkv, d)).astype(np.float32))
    cv = torch.from_numpy(rng.normal(size=(b, s, hkv, d)).astype(np.float32))
    kn = torch.from_numpy(rng.normal(size=(b, 1, hkv, d)).astype(np.float32))
    vn = torch.from_numpy(rng.normal(size=(b, 1, hkv, d)).astype(np.float32))
    pos = torch.tensor([3, 20, 40], dtype=torch.int32)
    # the slots past every row's position are poison in the served cache:
    # a read of them would show
    bad_k, bad_v = ck.clone(), cv.clone()
    bad_k[:, 41:], bad_v[:, 41:] = float("nan"), float("nan")
    mesh = _mesh(n)
    sh = NamedSharding(mesh, SD.decode_cache_spec(b, mesh))
    pk, pv = device_put((bad_k, bad_v), (sh, sh))
    seen = []
    real = SD.decode_partials

    def recording(q_, k_, v_, lo, hi, use_kernel=None):
        seen.append((k_, lo.clone(), hi.clone()))
        return real(q_, k_, v_, lo, hi, use_kernel=use_kernel)

    monkeypatch.setattr(SD, "decode_partials", recording)
    out, ck2, cv2 = SD.sharded_decode_attention(
        q, pk, pv, kn, vn, pos, mesh, window=window)
    assert ck2 is pk and cv2 is pv                # written in place
    rows = torch.arange(b)
    for placed, whole, new in ((ck2, bad_k, kn), (cv2, bad_v, vn)):
        want = whole.clone()
        want[rows, pos.long()] = new[:, 0]
        torch.testing.assert_close(gather(placed, CPU), want, rtol=0,
                                   atol=0, equal_nan=True)
    ck[rows, pos.long()], cv[rows, pos.long()] = kn[:, 0], vn[:, 0]
    keys = torch.arange(s)
    hi = (pos + 1)[:, None]
    lo = torch.clamp(hi - window, min=0) if window else torch.zeros_like(hi)
    mask = (keys[None, :] >= lo) & (keys[None, :] < hi)
    want = fd_ref.decode_attention_ref(q[:, 0], ck, cv, mask)
    assert bool(out.isfinite().all())
    torch.testing.assert_close(out[:, 0], want, rtol=2e-5, atol=2e-5)
    assert len(seen) == n
    s_loc = s // n
    n_dead = 0
    for sh_i, (k_, lo_s, hi_s) in enumerate(seen):
        assert k_ is ck2.pieces[0, sh_i] and k_.shape[1] == s_loc
        for i in range(b):
            live = max(int(lo[i]), sh_i * s_loc) < min(int(hi[i]),
                                                       (sh_i + 1) * s_loc)
            assert 0 <= int(lo_s[i]) < int(hi_s[i]) <= s_loc
            if live:
                assert int(lo_s[i]) == max(int(lo[i]) - sh_i * s_loc, 0)
                assert int(hi_s[i]) == min(int(hi[i]) - sh_i * s_loc, s_loc)
            else:
                n_dead += 1
                assert (int(lo_s[i]), int(hi_s[i])) == (0, 1)
    assert n_dead > 0


def _decode_specs(tcfg, state, mesh):
    """``cache_pspecs`` of the state with the GQA K/V at the decode's own
    spec (at 32 positions ``cache_pspecs`` leaves the sequence whole)."""
    specs = cache_pspecs(tcfg, state, mesh)
    kv = SD.decode_cache_spec(B, mesh)
    for lc in specs["layers"]:
        lc["attn"] = {"k": kv, "v": kv}
    return specs


@pytest.mark.parametrize("handed", ["pieces", "whole"])
@pytest.mark.parametrize("data,n", [(1, 2), (1, 4), (2, 2)],
                         ids=["1x2", "1x4", "2x2"])
def test_cache_in_pieces_matches_reference_unsharded(pair, ref_unsharded,
                                                     data, n, handed,
                                                     monkeypatch):
    jcfg, tcfg, jparams, tparams, prompt, steps = pair
    mesh = _mesh(n, data)
    _, state = TM.forward_prefill(
        tcfg, tparams, {"tokens": torch.from_numpy(prompt)},
        cache_capacity=CAP)
    before = [{k: lc["attn"][k].clone() for k in ("k", "v")}
              for lc in state["layers"]]
    if handed == "pieces":
        state = device_put(state, named_shardings(
            _decode_specs(tcfg, state, mesh), mesh))
        handed_k = state["layers"][0]["attn"]["k"]
        assert isinstance(handed_k, Placed) and isinstance(state["len"],
                                                           Placed)
    # the leaves besides K/V, as handed in: placed ones come back so
    handed_in = [state["len"]] + [v for lc in state["layers"]
                                  for k, v in lc.items() if k != "attn"]
    writes = []
    real = SD.sharded_decode_attention

    def recording(q, ck, cv, kn, vn, pos, *args, **kw):
        writes.append((kn[:, 0].clone(), vn[:, 0].clone(), pos.clone()))
        return real(q, ck, cv, kn, vn, pos, *args, **kw)

    monkeypatch.setattr("repro_torch.models.layers.sharded_decode_attention",
                        recording)
    got = []
    with runtime.use_mesh(mesh):
        for t in steps:
            logits, state = TM.decode_step(tcfg, tparams, state,
                                           torch.from_numpy(t))
            got.append(logits.numpy())
    got = np.stack(got)
    np.testing.assert_allclose(got, ref_unsharded, **TOL)
    assert len(writes) == STEPS * tcfg.n_layers
    if handed == "pieces":                      # read and written in place
        assert state["layers"][0]["attn"]["k"] is handed_k
    handed_out = [state["len"]] + [v for lc in state["layers"]
                                   for k, v in lc.items() if k != "attn"]
    for was, got in zip(handed_in, handed_out, strict=True):
        if isinstance(was, Placed):
            assert isinstance(got, Placed)
            assert SH._same_layout(got, was.sharding)
        else:
            assert isinstance(got, torch.Tensor)
    rows = torch.arange(B)
    for layer, (lc, want) in enumerate(zip(state["layers"], before)):
        for j, name in enumerate(("k", "v")):
            placed = lc["attn"][name]
            assert isinstance(placed, Placed) and placed.pieces.shape == \
                (data, n)
            for kn_vn_pos in writes[layer::tcfg.n_layers]:
                want[name][rows, kn_vn_pos[2].long()] = kn_vn_pos[j]
            assert torch.equal(gather(placed, CPU), want[name]), (layer, name)
    # layer 0's K/V depend on the tokens only: bitwise the unsharded
    # decode's cache
    _, one = TM.forward_prefill(tcfg, tparams,
                                {"tokens": torch.from_numpy(prompt)},
                                cache_capacity=CAP)
    for t in steps:
        _, one = TM.decode_step(tcfg, tparams, one, torch.from_numpy(t))
    for name in ("k", "v"):
        assert torch.equal(gather(state["layers"][0]["attn"][name], CPU),
                           one["layers"][0]["attn"][name])
