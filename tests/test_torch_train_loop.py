"""Training loops of the port on the CPU: the reference's loss-falls
test, checkpoint/resume against a run that never stopped, and the
training driver (``python -m repro_torch.launch.train``).  The parity of
the pieces with the JAX package is ``tests/test_torch_train.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.distributed.fault import CheckpointManager as JaxCheckpointManager
from repro.launch import train as jax_launch_train
from repro.models import model as JM
from repro.train import optimizer as JO
from repro_torch.configs import reduced
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed.compression import int8_compress
from repro_torch.distributed.fault import CheckpointManager, tree_flatten
from repro_torch.launch import train as launch_train
from repro_torch.models import model as TM
from repro_torch.models import train_state_from_jax
from repro_torch.train import optimizer as TO
from repro_torch.train import steps as TS
from torch_port_cases import per_layer

S = 20              # > the reduced sliding window of 8


def _cfgs(arch, n_layers):
    return (dataclasses.replace(jax_reduced(arch), n_layers=n_layers),
            dataclasses.replace(reduced(arch), n_layers=n_layers))


def test_tiny_training_reduces_loss():
    """The reference's test (``tests/test_models.py``) on the port: 25
    AdamW steps on structured tokens cut the loss by more than 0.3."""
    cfg = reduced("llama3-8b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            dtype=torch.float32, device="cpu")
    state = TO.adamw_init(params)
    step = TS.build_train_step(
        cfg, TO.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=100,
                            weight_decay=0.0),
        n_micro=1, compute_dtype=torch.float32)
    pipe = TokenPipeline(cfg.vocab_size, batch_size=16, seq_len=64)
    losses = []
    for batch in pipe.batches(25):
        state, metrics = step(state, {"tokens": torch.from_numpy(
            batch["tokens"])})
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses


def _run(step_fn, state, pipe, lo, hi):
    for i in range(lo, hi):
        state, _ = step_fn(state, {"tokens": torch.from_numpy(
            pipe.batch_at(i)["tokens"])})
    return state


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "int8"])
def test_checkpoint_resume_equals_a_continuous_run(tmp_path, compress):
    """3 steps, save, restore into a fresh state, 2 more: bitwise the 5
    steps of one run (params, moments, residual, step)."""
    cfg = _cfgs("hymba-1.5b", 4)[1]
    step_fn = TS.build_train_step(
        cfg, TO.AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=5),
        n_micro=2, compress=int8_compress if compress else None,
        compute_dtype=torch.float32)
    pipe = TokenPipeline(cfg.vocab_size, batch_size=4, seq_len=S)

    def fresh():
        return TO.adamw_init(TM.init_params(
            cfg, torch.Generator().manual_seed(0), dtype=torch.float32,
            device="cpu"), with_compression=compress)

    whole = _run(step_fn, fresh(), pipe, 0, 5)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, _run(step_fn, fresh(), pipe, 0, 3))
    resumed = mgr.restore(fresh())
    assert isinstance(resumed, TO.TrainState) and int(resumed.step) == 3
    resumed = _run(step_fn, resumed, pipe, 3, 5)
    for a, b in zip(tree_flatten(whole)[0], tree_flatten(resumed)[0]):
        assert torch.equal(a, b)


def _launch_both(tmp_path, monkeypatch, args):
    """Both packages' launchers on one reduced config from the same initial
    weights (the port's ``init_params`` returns the reference's draw
    through ``params_from_jax``); returns (port state, reference state
    restored from its last checkpoint, reference config)."""
    jcfg = jax_reduced(args[1])
    tcfg = reduced(args[1])
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    monkeypatch.setattr(launch_train, "init_params",
                        lambda cfg, gen, dtype, device: TM.params_from_jax(
                            tcfg, jax.tree.map(np.asarray, jparams),
                            device=device))
    tdir, jdir = tmp_path / "port", tmp_path / "reference"
    port = launch_train.main(args + ["--device", "cpu", "--ckpt-dir",
                                     str(tdir)])
    jax_launch_train.main(args + ["--ckpt-dir", str(jdir)])
    return port, tdir, jdir, jcfg, jparams


def test_launcher_runs_and_resumes_on_the_cpu(tmp_path, monkeypatch,
                                              capsys):
    """``python -m repro_torch.launch.train`` on a reduced config: 4
    steps with checkpoints at 2 and 4; with the step-4 checkpoint removed
    ``--resume`` continues from step 2 and, as the reference's launcher
    does, feeds the token stream from batch 0 again.  The port's resumed
    run equals the reference launcher's resumed run leaf by leaf (params,
    moments; both start from the reference's weights) at rtol 1e-4 /
    atol 1e-6, the bar of ``tests/test_torch_train.py``, a param element
    allowed up to 2 lr per step taken (at most 0.1% of a leaf: Adam turns
    a gradient ~0 against its rounding into a step of either sign); and
    it differs from the run that never stopped (which saw batches 2 and
    3)."""
    args = ["--arch", "hymba-1.5b", "--steps", "4", "--batch", "4",
            "--seq", "16", "--n-micro", "2", "--ckpt-every", "2"]
    first, tdir, jdir, jcfg, jparams = _launch_both(tmp_path, monkeypatch,
                                                    args)
    assert int(first.step) == 4
    for d in (tdir, jdir):
        for p in d.glob("step_00000004*"):
            p.unlink()
    again, _, _, _, _ = _launch_both(tmp_path, monkeypatch,
                                     args + ["--resume"])
    out = capsys.readouterr().out
    assert out.count("resumed from step 2") == 2
    assert "done at step 4" in out
    want = JaxCheckpointManager(str(jdir)).restore(
        JO.adamw_init(jparams))
    assert int(again.step) == int(want.step) == 4
    lr_steps = 3e-3 * 4                 # the default lr, steps taken
    for field in ("params", "mu", "nu"):
        got = tree_flatten(getattr(again, field))[0]
        ref = tree_flatten(per_layer(jax.tree.map(
            np.asarray, getattr(want, field)), jcfg.n_layers))[0]
        assert len(got) == len(ref)
        for i, (g, w) in enumerate(zip(got, ref)):
            g = g.numpy()
            miss = ~np.isclose(g, w, rtol=1e-4, atol=1e-6)
            assert field == "params" or not miss.any(), (field, i)
            if miss.any():
                assert np.abs(g - w)[miss].max() <= 2 * lr_steps, i
                assert miss.mean() <= 0.001, (i, miss.mean())
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_flatten(first)[0], tree_flatten(again)[0]))


def test_train_constructors_default_to_the_card():
    """Without a card, the default device raises instead of moving to
    the CPU; ``adamw_init`` follows its params' device."""
    jcfg, tcfg = _cfgs("llama3-8b", 2)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable")
    state_np = jax.tree.map(np.asarray, JO.adamw_init(jparams))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_state_from_jax(tcfg, state_np)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "llama3-8b", "--steps", "1"])
    cpu = train_state_from_jax(tcfg, state_np, device="cpu")
    assert TO.adamw_init(cpu.params).step.device.type == "cpu"
