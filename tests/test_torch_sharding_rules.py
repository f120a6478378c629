"""Sharding rules and mesh builders, port against reference: the port's
``distributed.sharding`` and ``launch.mesh`` beside the JAX package's.

For every config of the registry at full width, from shapes only (the
reference's ``jax.eval_shape`` trees), the reference's ``param_pspecs``
(every ``STRATEGIES`` entry), ``cache_pspecs`` and ``batch_pspec`` and the
port's on the same shapes, at the production meshes (16, 16) and
(2, 16, 16).  The port keeps layers as a list of per-layer dicts: each
per-layer leaf's spec must equal the reference's spec of the stacked
leaf less its leading L entry (which the reference leaves ``None``).
The reference takes a stand-in mesh (``axis_names`` and
``devices.shape``), the port its own ``Mesh`` of CPU entries.  Also
``auto_pspec`` on the reference's own cases, ``key_shard_mesh`` past the
device count, and both packages' host and production meshes.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES
from repro.configs import get as jax_get
from repro.distributed import sharding as JS
from repro.launch import mesh as JL
from repro.models import model as JM
from repro_torch.configs import ARCHS
from repro_torch.distributed import sharding as TS
from repro_torch.launch import mesh as TL
from repro_torch.models import model as TM

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
STACKS = ("layers", "enc_layers")
CPU = torch.device("cpu")


def _meshes(name):
    shape, axes = MESHES[name]
    ref = types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))
    port = TS.Mesh(np.full(shape, CPU, dtype=object), axes)
    return ref, port


def _shape(x):
    return types.SimpleNamespace(shape=tuple(x.shape))


def _per_layer(tree):
    """The reference's stacked shape tree in the port's layout: under
    ``layers`` / ``enc_layers`` one dict per layer, leaves less L."""
    def unstack(t, i):
        if isinstance(t, dict):
            return {k: unstack(v, i) for k, v in t.items()}
        return types.SimpleNamespace(shape=tuple(t.shape)[1:])

    def n_layers(t):
        while isinstance(t, dict):
            t = next(iter(t.values()))
        return t.shape[0]

    out = {}
    for k, v in tree.items():
        if k in STACKS:
            out[k] = [unstack(v, i) for i in range(n_layers(v))]
        elif isinstance(v, dict):
            out[k] = jax.tree.map(_shape, v)
        else:
            out[k] = _shape(v)
    return out


def _flat(tree, path=()):
    """{path: leaf} of a dict tree (lists kept as leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


def _assert_specs(port, ref):
    """Every reference spec against the port's: equal off the stacks,
    equal less the (None) L entry on every layer of a stack."""
    ref_flat, port_flat = _flat(ref), _flat(port)
    assert set(port) == set(ref)
    n = 0
    for path, want in ref_flat.items():
        want = tuple(want)
        if path[0] in STACKS:
            layers = port[path[0]]
            assert want[0] is None, (path, want)
            for i, layer in enumerate(layers):
                got = _flat(layer)[path[1:]]
                assert isinstance(got, TS.PartitionSpec)
                assert tuple(got) == want[1:], (path, i, got, want)
                n += 1
        else:
            got = port_flat[path]
            assert isinstance(got, TS.PartitionSpec)
            assert tuple(got) == want, (path, got, want)
            n += 1
    return n


@pytest.fixture(scope="module", params=sorted(ARCHS))
def shapes(request):
    """The reference's full-width param and decode-cache shape trees."""
    cfg = jax_get(request.param)
    params = jax.eval_shape(
        lambda: JM.init_params(cfg, jax.random.PRNGKey(0)))
    shape = SHAPES["decode_32k"]
    cache = jax.eval_shape(lambda: JM.init_decode_state(
        cfg, shape.global_batch, shape.seq_len, dtype=jnp.bfloat16))
    return cfg, params, cache


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_param_pspecs_equal_the_references(shapes, mesh):
    cfg, params, _ = shapes
    ref_mesh, port_mesh = _meshes(mesh)
    tree = _per_layer(params)
    for strategy in TS.STRATEGIES:
        ref = JS.param_pspecs(cfg, params, ref_mesh, strategy=strategy)
        got = TS.param_pspecs(ARCHS[cfg.name], tree, port_mesh,
                              strategy=strategy)
        assert _assert_specs(got, ref) >= len(_flat(ref))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cache_and_batch_pspecs_equal_the_references(shapes, mesh):
    cfg, _, cache = shapes
    ref_mesh, port_mesh = _meshes(mesh)
    ref = JS.cache_pspecs(cfg, cache, ref_mesh)
    got = TS.cache_pspecs(ARCHS[cfg.name], _per_layer(cache), port_mesh)
    _assert_specs(got, ref)
    # the port's own decode state has the tree the specs were taken on
    small = TM.init_decode_state(ARCHS[cfg.name], 2, 8, device="meta")
    assert sorted(_flat(TS.cache_pspecs(ARCHS[cfg.name], small,
                                        port_mesh))) == sorted(_flat(got))
    for shape in SHAPES.values():
        jspec = JM.model_input_spec(cfg, shape)
        tspec = {k: torch.empty(s, dtype=dt, device="meta") for k, (s, dt)
                 in TM.model_input_spec(ARCHS[cfg.name], shape).items()}
        want = JS.batch_pspec(jspec, ref_mesh)
        have = TS.batch_pspec(tspec, port_mesh)
        assert sorted(have) == sorted(want)
        for k in want:
            assert isinstance(have[k], TS.PartitionSpec)
            assert tuple(have[k]) == tuple(want[k]), (shape.name, k)


def test_strategies_and_overrides_are_the_references():
    assert list(TS.STRATEGIES) == list(JS.STRATEGIES)
    for name in JS.STRATEGIES:
        ref, got = JS.STRATEGIES[name](), TS.STRATEGIES[name]()
        assert list(got) == list(ref)
        for pat in ref:
            assert tuple(got[pat]) == tuple(ref[pat]), (name, pat)


@pytest.mark.parametrize("path,shape,stacked", [
    ("embed", (128256, 4096), False),
    ("layers/mlp/w_gate", (32, 4096, 14336), True),
    ("layers/norm1", (32, 4096), True),
    ("layers/ssm/w_b", (32, 64, 16), True),
    ("x", (30, 18), False),
    ("layers/attn/wq", (32, 4096, 4096), True),
    ("lm_head", (4096, 128256), False),
])
def test_auto_pspec_rules(path, shape, stacked):
    """The reference's cases (``tests/test_distributed.py``) and two more,
    at (16, 16) and at a (2, 4) mesh."""
    for mesh in ({"data": 16, "model": 16}, {"data": 2, "model": 4}):
        want = JS.auto_pspec(path, shape, mesh, stacked=stacked)
        got = TS.auto_pspec(path, shape, mesh, stacked=stacked)
        assert tuple(got) == tuple(want)
        if stacked:      # the port's per-layer leaf: the same, less L
            assert tuple(TS.auto_pspec(path, shape[1:], mesh,
                                       stacked=False)) == tuple(want)[1:]


def test_named_shardings_pair_specs_with_the_mesh():
    _, port_mesh = _meshes("16x16")
    tree = _per_layer(jax.eval_shape(
        lambda: JM.init_params(jax_get("llama3-8b"), jax.random.PRNGKey(0))))
    specs = TS.param_pspecs(ARCHS["llama3-8b"], tree, port_mesh)
    named = TS.named_shardings(specs, port_mesh)
    flat_s, flat_n = _flat(specs), _flat(named)
    assert sorted(flat_s) == sorted(flat_n)
    for path, spec in flat_s.items():
        if isinstance(spec, list):
            for s, n in zip(spec, flat_n[path]):
                assert all(v.mesh is port_mesh for v in _flat(n).values())
                assert [v.spec for v in _flat(n).values()] == \
                    list(_flat(s).values())
        else:
            assert flat_n[path] == TS.NamedSharding(port_mesh, spec)


def test_key_shard_mesh_and_store_placement():
    tail = "devices; use mesh=None for logical sharding on fewer devices"
    n = jax.device_count()
    with pytest.raises(ValueError) as want:
        JS.key_shard_mesh(n + 1)
    assert str(want.value) == f"{n + 1} shards > {n} {tail}"
    with pytest.raises(ValueError) as got:
        TS.key_shard_mesh(2, devices=[CPU])
    assert str(got.value) == f"2 shards > 1 {tail}"
    if not torch.cuda.is_available():
        # every visible CUDA device by default: none here
        with pytest.raises(ValueError, match="no device"):
            TS.key_shard_mesh()
        with pytest.raises(ValueError, match="shards > 0 devices"):
            TS.key_shard_mesh(1)
    mesh = TS.key_shard_mesh(3, devices=[CPU] * 4)
    assert mesh.axis_names == ("shard",) and dict(mesh.shape) == \
        {"shard": 3}
    assert TS.stacked_store_sharding(mesh) == [CPU] * 3
    grid = TS.Mesh(np.array([[CPU, torch.device("meta")]] * 2,
                            dtype=object), ("shard", "model"))
    assert TS.stacked_store_sharding(grid, "model") == \
        [CPU, torch.device("meta")]
    with pytest.raises(ValueError, match="no axis"):
        TS.stacked_store_sharding(grid, "data")


def test_place_and_gather_stacked_round_trip():
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.arange(3, dtype=torch.int32)}}
    parts = TS.place_stacked(tree, [CPU] * 3)
    assert len(parts) == 3 and parts[1]["a"].shape == (1, 4)
    assert parts[2]["b"]["c"].tolist() == [2]
    assert parts[0]["a"].data_ptr() != tree["a"].data_ptr()
    back = TS.gather_stacked(parts, CPU)
    assert torch.equal(back["a"], tree["a"])
    assert torch.equal(back["b"]["c"], tree["b"]["c"])


def test_host_and_production_meshes_are_the_references():
    ref, got = JL.make_host_mesh(), TL.make_host_mesh()
    assert got.axis_names == ref.axis_names
    assert got.devices.shape == ref.devices.shape
    assert dict(got.shape) == dict(ref.shape)
    assert list(got.devices.flat) == [CPU]
    for multi_pod in (False, True):
        with pytest.raises(ValueError) as want:
            JL.make_production_mesh(multi_pod=multi_pod)
        if torch.cuda.device_count() >= (512 if multi_pod else 256):
            continue
        with pytest.raises(ValueError) as have:
            TL.make_production_mesh(multi_pod=multi_pod)
        msg = str(want.value).replace(str(jax.device_count()),
                                      str(torch.cuda.device_count()), 1)
        assert str(have.value) == msg
