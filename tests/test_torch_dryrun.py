"""The port's dry run (``repro_torch.launch.dryrun``) and its placement
from specs (``distributed.sharding.shard_shape`` / ``per_device_bytes``)
against the JAX package.

The reference's dry run compiles for 512 virtual devices and must never
be imported by a test; what it would place is read from its own
sharding rules instead: ``param_pspecs`` / ``cache_pspecs`` /
``batch_pspec`` over its ``jax.eval_shape`` trees on the stand-in mesh of
``tests/test_torch_sharding_rules.py``, each leaf's per-device shape
from ``jax.sharding.NamedSharding(AbstractMesh, spec).shard_shape``.
The port's ``memory.argument_bytes`` must equal those bytes exactly,
except one stated layout difference in the train state: the port holds
one 0-d compression residual per per-layer leaf where the reference
holds one per stacked leaf, 4 bytes each.

The cells run every config at reduced width (``configs.reduced``) and at
the registry's shape names with reduced lengths (the dry run's step runs
on ``meta``, whose cost is Python time per op: the RWKV6 loop over time
would take minutes at 32,768 positions); the decode caches keep 4,096+
positions, where ``cache_pspecs`` shards the sequence axis.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import reduced as j_reduced
from repro.distributed import sharding as JS
from repro.models import model as JM
from repro.train import optimizer as JO
from repro_torch.configs import ARCHS, ShapeSpec, reduced
from repro_torch.configs.registry import get as t_get
from repro_torch.distributed import sharding as TS
from repro_torch.distributed.fault import tree_flatten
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as TL

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SHAPES = {"train_4k": ShapeSpec("train_4k", 64, 32, "train"),
          "prefill_32k": ShapeSpec("prefill_32k", 128, 32, "prefill"),
          "decode_32k": ShapeSpec("decode_32k", 4096, 32, "decode"),
          "long_500k": ShapeSpec("long_500k", 8192, 1, "decode")}
META = torch.device("meta")


@pytest.fixture
def reduced_cells(monkeypatch):
    """The dry run over reduced configs and shapes."""
    monkeypatch.setattr(dryrun, "get", reduced)
    monkeypatch.setattr(dryrun, "SHAPES", SHAPES)


def _ref_mesh(name):
    shape, axes = MESHES[name]
    return (types.SimpleNamespace(axis_names=axes, devices=np.empty(shape)),
            AbstractMesh(shape, axes))


def _ref_bytes(tree, specs, amesh):
    """Per-device bytes of a reference tree under its specs."""
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        shard = NamedSharding(amesh, spec).shard_shape(tuple(leaf.shape))
        total += int(np.prod(shard)) * np.dtype(leaf.dtype).itemsize
    return total


def _ref_argument_bytes(arch, shape, mesh_name):
    """What the reference's dry run places as arguments, per device."""
    cfg = j_reduced(arch)
    ref_mesh, amesh = _ref_mesh(mesh_name)
    params = jax.eval_shape(lambda: JM.init_params(
        cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16))
    p_specs = JS.param_pspecs(cfg, params, ref_mesh)
    if shape.kind == "decode":
        cache = jax.eval_shape(lambda: JM.init_decode_state(
            cfg, shape.global_batch, shape.seq_len))
        tok = jax.ShapeDtypeStruct((shape.global_batch, 1), jnp.int32)
        return _ref_bytes((params, cache, tok),
                          (p_specs, JS.cache_pspecs(cfg, cache, ref_mesh),
                           JS.batch_pspec(tok, ref_mesh)), amesh), 0
    batch = JM.model_input_spec(cfg, shape)
    b_specs = JS.batch_pspec(batch, ref_mesh)
    if shape.kind == "prefill":
        return _ref_bytes((params, batch), (p_specs, b_specs), amesh), 0
    state = jax.eval_shape(JO.adamw_init, params)
    s_specs = type(state)(
        step=JS.P(), params=p_specs, mu=p_specs, nu=p_specs,
        compress_err=jax.tree_util.tree_map(lambda _: JS.P(),
                                            state.compress_err))
    n_err = len(jax.tree_util.tree_leaves(state.compress_err))
    return _ref_bytes((state, batch), (s_specs, b_specs), amesh), n_err


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reduced_cells_ok_or_skip_and_argument_bytes(arch, reduced_cells):
    cfg = reduced(arch)
    for mesh_name in MESHES:
        for name, shape in SHAPES.items():
            rec = dryrun.dryrun_cell(arch, name, mesh_name == "2x16x16")
            assert rec["mesh"] == mesh_name and rec["arch"] == arch
            if name not in cfg.applicable_shapes():
                assert rec["status"] == "SKIP"
                assert j_reduced(arch).applicable_shapes() == \
                    cfg.applicable_shapes()
                continue
            assert rec["status"] == "OK", rec
            assert rec["n_devices"] == (512 if "2x" in mesh_name else 256)
            want, n_ref_err = _ref_argument_bytes(arch, shape, mesh_name)
            got = rec["memory"]["argument_bytes"]
            if shape.kind == "train":
                params = dryrun.init_params(cfg, torch.Generator(),
                                            device=META)
                n_err = len(tree_flatten(params)[0])
                want += 4 * (n_err - n_ref_err)
                assert rec["n_micro"] >= 1
            assert got == want, (name, mesh_name)
            assert rec["flops_loop_aware"] > 0
            assert rec["hbm_bytes_loop_aware"] > 0
            assert rec["collectives"]["total"] == 0.0
            assert rec["loops"] == [] and rec["unknown_loops"] == []
            for key in ("temp_bytes", "peak_bytes"):
                assert rec["memory"][key] is None
            for key in ("lower_s", "compile_s", "hlo_lines"):
                assert rec[key] is None
            assert "null" in rec["notes"]


def test_train_flops_are_one_microbatch_times_n_micro(reduced_cells,
                                                      monkeypatch):
    """The train step is counted over one microbatch and multiplied by
    ``n_micro``, as the reference's loop multiplier does."""
    from repro_torch.launch import dryrun as D

    one = D.dryrun_cell("llama3-8b", "train_4k", False)
    monkeypatch.setattr(D, "default_n_micro", lambda cfg, shape: 4)
    four = D.dryrun_cell("llama3-8b", "train_4k", False)
    assert four["n_micro"] == 4 and one["n_micro"] == 1
    # a quarter of the batch per microbatch, four of them: the same
    # matmul FLOPs (the update has none)
    assert four["flops_loop_aware"] == pytest.approx(
        one["flops_loop_aware"], rel=1e-12)


def test_sharded_decode_counts_each_chunk_once(reduced_cells):
    """On the (16, 16) mesh the cache's 32 rows split into 16 data blocks
    and its 4,096 positions into 16 chunks: one ``decode_partials`` per
    entry (256 a layer) over its chunk, whose keys sum to the unsharded
    call's, and whose bytes are the 16 whole-batch chunk calls that the
    clipped-whole-cache route counted (each row's q read and partials
    written once per chunk)."""
    from repro_torch.kernels.flash_decode.ops import cost

    plain = dryrun.dryrun_cell("llama3-8b", "decode_32k", False)
    shard = dryrun.dryrun_cell("llama3-8b", "decode_32k", False,
                               sharded_decode=True)
    kp, ks = plain["kernels"]["decode_partials"], \
        shard["kernels"]["decode_partials"]
    assert ks["calls"] == 256 * kp["calls"]
    assert ks["flops"] == kp["flops"]
    cfg, shape = reduced("llama3-8b"), SHAPES["decode_32k"]
    b, s = shape.global_batch, shape.seq_len
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    per_chunk = cost(b, *heads, b * s // 16, 2).nbytes
    assert cost(b // 16, *heads, b // 16 * s // 16, 2).nbytes * 16 == \
        per_chunk
    assert ks["bytes"] == 16 * per_chunk * cfg.n_layers
    assert shard["memory"] == plain["memory"]


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
def test_each_step_is_counted_once_across_meshes(reduced_cells, monkeypatch,
                                                 shape_name):
    """The second mesh's cell reuses the first's count of the step, and
    that count is what a fresh count on the second mesh gives."""
    monkeypatch.setattr(dryrun, "_COSTS", {})
    first = dryrun.dryrun_cell("hymba-1.5b", shape_name, False)
    second = dryrun.dryrun_cell("hymba-1.5b", shape_name, True)
    assert len(dryrun._COSTS) == 1
    dryrun._COSTS.clear()
    fresh = dryrun.dryrun_cell("hymba-1.5b", shape_name, True)
    for key in ("flops_loop_aware", "hbm_bytes_loop_aware", "kernels",
                "memory", "collectives"):
        assert second[key] == fresh[key], key
    assert first["flops_loop_aware"] * 256 == \
        pytest.approx(second["flops_loop_aware"] * 512, rel=1e-12)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_shard_shape_matches_named_sharding(mesh_name):
    shape, axes = MESHES[mesh_name]
    amesh = AbstractMesh(shape, axes)
    port_mesh = TL.make_production_mesh(multi_pod=len(shape) == 3,
                                        device="meta")
    assert port_mesh.devices.shape == shape
    assert {d.type for d in port_mesh.devices.flat} == {"meta"}
    P = TS.PartitionSpec
    cases = [((4096, 512), P("model", "data")),
             ((32, 512, 128), P(None, ("data", "model"))),
             ((64, 7), P(tuple(a for a in ("pod", "data") if a in axes),
                         None)),
             ((5, 4096), P(None, "model")),
             ((3,), P()), ((), P()), ((48, 16, 32), P("data"))]
    for leaf, spec in cases:
        want = NamedSharding(amesh, jax.sharding.PartitionSpec(*spec)) \
            .shard_shape(leaf)
        assert TS.shard_shape(leaf, spec, port_mesh) == tuple(want)
    with pytest.raises(ValueError):
        TS.shard_shape((10, 3), P("model"), port_mesh)


def test_per_device_bytes_walks_trees():
    mesh = TL.make_production_mesh(device="meta")
    P = TS.PartitionSpec
    tree = {"a": torch.empty((32, 64), dtype=torch.bfloat16, device=META),
            "l": [torch.empty((16,), device=META)] * 2,
            "t": (torch.empty((), dtype=torch.int32, device=META),)}
    specs = {"a": P("data", "model"), "l": [P("model"), P()], "t": (P(),)}
    assert TS.per_device_bytes(tree, specs, mesh) == \
        2 * 4 * 2 + 4 * 1 + 16 * 4 + 4


def test_cli_writes_one_record_per_cell(tmp_path, reduced_cells, capsys):
    rc = dryrun.main(["--arch", "hymba-1.5b", "--shape", "decode_32k",
                      "--both-meshes", "--out", str(tmp_path)])
    assert rc == 0
    files = sorted(p.name for p in tmp_path.glob("*.json"))
    assert files == ["hymba-1.5b__decode_32k__16x16.json",
                     "hymba-1.5b__decode_32k__2x16x16.json"]
    for f in files:
        rec = json.loads((tmp_path / f).read_text())
        assert rec["status"] == "OK" and rec["kernels"]
    # an existing record is kept, and a SKIP cell is a record too
    rc = dryrun.main(["--arch", "llama3-8b", "--shape", "long_500k",
                      "--out", str(tmp_path)])
    assert rc == 0
    rec = json.loads((tmp_path / "llama3-8b__long_500k__16x16.json")
                     .read_text())
    assert rec["status"] == "SKIP"
    assert "skip existing" not in capsys.readouterr().out
    assert dryrun.main(["--arch", "hymba-1.5b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    assert "[skip existing]" in capsys.readouterr().out


def test_full_width_decode_cell_on_meta():
    """One full-size cell, as ``chip_smoke.py`` runs it: llama3-8b at
    decode_32k on the 16 x 16 mesh of meta entries, in seconds."""
    rec = dryrun.dryrun_cell("llama3-8b", "decode_32k", False)
    cfg = t_get("llama3-8b")
    assert rec["status"] == "OK"
    assert rec["kernels"]["decode_partials"]["calls"] == cfg.n_layers
    # weights once + the whole bf16 cache, per device (ZeRO + TP specs)
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["flops_loop_aware"] * 256 > 2 * 8.0e9 * 128
