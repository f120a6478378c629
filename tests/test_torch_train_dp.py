"""The data-parallel train step (``build_train_step(..., dp_axes=("data",),
mesh=...)``), port against reference, on the CPU in float32.

On reduced llama3-8b and hymba-1.5b (2 layers; hymba's layer 1 slides a
window) with one and two microbatches, one step on a (2, 1) CPU mesh —
every microbatch's rows in two data blocks, each block's forward and
backward apart, their losses and gradients averaged in data order — is
held, from the same state (the JAX package's, through
``train_state_from_jax``), to the reference's ``build_train_step`` step
and to the port's one-device step: loss and grad norm at rtol 1e-4, the
params at ``tests/test_torch_train.py``'s ``_close_params`` (rtol 1e-4 /
atol 1e-6 but for elements where Adam's normalised step turns a ~0
gradient's rounding into a step of either sign, 2 lr each, at most
0.1% of them).  The tokens are drawn as ``tests/test_torch_train.py``
draws them (seeded by the config's name).  On another draw (that seed
+ 1) one element of hymba's 256-element (64, 4) leaf falls outside
rtol 1e-4 / atol 1e-6 by ~3e-6 — in the one-device step as in the DP
step, against the reference — which is 0.39% of that leaf, above
``_close_params``' 0.1% cap: the cap counts a single Adam rounding
flip in a small leaf as a miss, whichever route takes the step.  The
leaf is ``layers[1]["ssm"]["w_b"]``, the element (59, 0), with one and
with two microbatches, and the cause is summation order: its gradient
is a sum that nearly cancels (port 2.4278e-07, reference 2.4381e-07,
against a median |g| of 4.6e-4 over the leaf), and the 1.0e-9 between
them is the float32 rounding that every element of the leaf carries
(up to 2.8e-9 there); bracketing the port's scan as the reference's
associative scan moves it by 3e-11 only.  After the clip (global norm
2.516), Adam's first step lr g / (|g| + eps) at |g| ~ 10 eps turns it
into 3.3e-6 of the param (lr eps dg / (|g| + eps)^2 = 3.5e-6).  The
blocks are the batch's rows in order (none reordered); the data
devices are the mesh's entries along the data axis; MoE under more
than one block raises.
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
from repro_torch.distributed.fault import tree_flatten
from repro_torch.distributed.sharding import Mesh
from repro_torch.models import init_params, train_state_from_jax
from repro_torch.train import optimizer as TO
from repro_torch.train import steps as TS

from test_torch_train import _close_params, _pairs

B, S = 4, 20
CPU, META = torch.device("cpu"), torch.device("meta")
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1)


def _dp_mesh(n=2):
    return Mesh(np.array([[CPU]] * n, dtype=object), ("data", "model"))


@pytest.fixture(scope="module", params=["llama3-8b", "hymba-1.5b"])
def arch_pair(request):
    jcfg = dataclasses.replace(jax_reduced(request.param), n_layers=2)
    tcfg = dataclasses.replace(reduced(request.param), n_layers=2)
    jparams = jax.jit(lambda key: JM.init_params(jcfg, key, jnp.float32))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(sum(map(ord, jcfg.name)))
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, tcfg, jparams, tokens


@pytest.mark.parametrize("n_micro", [1, 2])
def test_dp_step_matches_reference_and_one_device(arch_pair, n_micro):
    jcfg, tcfg, jparams, tokens = arch_pair
    jstate = JO.adamw_init(jparams)
    jnew, jm = jax.jit(JS.build_train_step(
        jcfg, JO.AdamWConfig(**OPT), n_micro=n_micro,
        compute_dtype=jnp.float32))(jstate, {"tokens": jnp.asarray(tokens)})

    def port(**dp):
        state = train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate),
                                     device="cpu")
        step = TS.build_train_step(tcfg, TO.AdamWConfig(**OPT),
                                   n_micro=n_micro,
                                   compute_dtype=torch.float32, **dp)
        return step(state, {"tokens": torch.from_numpy(tokens)})

    dp_state, dp_m = port(dp_axes=("data",), mesh=_dp_mesh())
    one_state, one_m = port()
    for m, what in ((jm, "reference"), (one_m, "one device")):
        assert int(dp_m["step"]) == int(m["step"]) == 1
        np.testing.assert_allclose(float(dp_m["loss"]), float(m["loss"]),
                                   rtol=1e-4, err_msg=what)
        np.testing.assert_allclose(float(dp_m["grad_norm"]),
                                   float(m["grad_norm"]), rtol=1e-4,
                                   err_msg=what)
    for name, g, w in _pairs(dp_state.params, jnew.params, jcfg):
        _close_params(g, w, OPT["lr"], f"reference {name}")
    for i, (g, w) in enumerate(zip(tree_flatten(dp_state.params)[0],
                                   tree_flatten(one_state.params)[0])):
        _close_params(g.numpy(), w.numpy(), OPT["lr"], f"one device leaf {i}")


@pytest.mark.parametrize("n_micro", [1, 2])
def test_dp_blocks_are_the_rows_in_order(monkeypatch, n_micro):
    """Every microbatch's rows reach ``forward_train`` as two contiguous
    blocks, in data order, microbatch after microbatch: the batch's rows
    in order, none reordered or repeated."""
    cfg = dataclasses.replace(reduced("llama3-8b"), n_layers=1)
    seen = []
    real = TS.forward_train

    def recording(cfg_, params, batch, **kw):
        seen.append(batch["tokens"].clone())
        return real(cfg_, params, batch, **kw)

    monkeypatch.setattr(TS, "forward_train", recording)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         dtype=torch.float32, device="cpu")
    tokens = torch.arange(8 * 5, dtype=torch.int32).reshape(8, 5) % 200
    TS.loss_and_grads(cfg, params, {"tokens": tokens}, n_micro,
                      torch.float32, devices=[CPU, CPU])
    assert len(seen) == 2 * n_micro
    assert all(t.shape[0] == 8 // (2 * n_micro) for t in seen)
    assert torch.equal(torch.cat(seen), tokens)


def test_dp_devices_follow_the_data_axis():
    """The block devices are the mesh's entries along the data axes (the
    first named axis major) at index 0 of the others."""
    mesh = Mesh(np.array([[CPU, META], [META, CPU], [CPU, CPU]],
                         dtype=object), ("data", "model"))
    assert TS.dp_devices(mesh, ("data",)) == [CPU, META, CPU]
    assert TS.dp_devices(mesh, ("model",)) == [CPU, META]
    assert TS.dp_devices(mesh, ("data", "model")) == list(
        mesh.devices.flat)
    assert TS.dp_devices(mesh, ("model", "data")) == list(
        mesh.devices.T.flat)
    with pytest.raises(ValueError, match="no axes"):
        TS.dp_devices(mesh, ("pod",))


def test_moe_under_data_parallelism_raises():
    cfg = dataclasses.replace(reduced("qwen2-moe-a2.7b"), n_layers=2)
    with pytest.raises(ValueError, match="moe_capacity"):
        TS.build_train_step(cfg, dp_axes=("data",), mesh=_dp_mesh())
    # one data block is the one-device step
    TS.build_train_step(cfg, dp_axes=("data",), mesh=_dp_mesh(1))


def test_launcher_data_parallel_flag(tmp_path, capsys):
    """``launch.train --data-parallel 2`` on the CPU: the two blocks on the
    repeated device, said so, and the run within 2 lr per step of the
    one-device run (the carried bar of ``tests/test_torch_train.py``)."""
    from repro_torch.launch import train as LT

    args = ["--arch", "llama3-8b", "--device", "cpu", "--steps", "2",
            "--batch", "4", "--seq", "16", "--n-micro", "2"]
    dp = LT.main(args + ["--data-parallel", "2",
                         "--ckpt-dir", str(tmp_path / "dp")])
    out = capsys.readouterr().out
    assert "the 2 data blocks all run on cpu" in out
    assert "data parallel over ['cpu', 'cpu']" in out
    one = LT.main(args + ["--ckpt-dir", str(tmp_path / "one")])
    assert int(dp.step) == int(one.step) == 2
    for g, w in zip(tree_flatten(dp.params)[0], tree_flatten(one.params)[0]):
        assert float((g - w).abs().max()) <= 2 * 3e-3 * 2
