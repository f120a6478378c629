"""Fault-tolerance policies of the port (``distributed.fault``) against
the reference: checkpoints (round trip, retention, rejection of a
drifted shape or structure), the elastic re-plan, straggler backups,
heartbeats and the promotion policy.  The port's checkpoint writes its
own index (a structure string, not a ``jax.tree_util`` treedef), so its
tests check behaviour, and the policies are held to the reference's
decisions on the same inputs."""

import numpy as np
import pytest
import torch

from repro.distributed.fault import ElasticPlanner as JaxPlanner
from repro.distributed.fault import StragglerMitigator as JaxStraggler
from repro.distributed.fault import most_caught_up as jax_most_caught_up
from repro_torch.distributed.fault import (CheckpointManager, ElasticPlanner,
                                           HeartbeatMonitor,
                                           StragglerMitigator,
                                           most_caught_up, tree_flatten,
                                           tree_map)


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"w": np.arange(12.0).reshape(3, 4),
             "opt": {"mu": np.ones((3, 4)), "step": np.int32(7)}}
    mgr.save(7, state)
    mgr.save(9, state)
    assert mgr.latest_step() == 9
    restored = mgr.restore(state)
    np.testing.assert_array_equal(restored["w"], state["w"])
    assert restored["opt"]["step"] == 7
    mgr.save(11, state)                       # retention gc
    assert mgr.latest_step() == 11
    with pytest.raises(FileNotFoundError):
        _ = np.load(tmp_path / "step_00000007.host0.npz")


def test_checkpoint_tensor_leaves_keep_dtype_and_device(tmp_path):
    """Tensor leaves of the template come back as tensors of the
    template's dtype and device (what cold recovery installs)."""
    mgr = CheckpointManager(str(tmp_path))
    state = {"tables": {"t": {"keys": torch.arange(6, dtype=torch.int32),
                              "comp": torch.arange(6, dtype=torch.int64),
                              "cols": {"v": torch.ones(6)}}},
             "pre": None, "ids": [torch.zeros(2), torch.ones(2)]}
    mgr.save(3, state)
    got = mgr.restore(state)
    assert got["pre"] is None
    for a, b in zip(tree_flatten(got)[0], tree_flatten(state)[0]):
        assert isinstance(a, torch.Tensor) and a.dtype == b.dtype
        assert a.device == b.device and torch.equal(a, b)
    doubled = tree_map(lambda x: x * 2, state)
    assert torch.equal(doubled["ids"][1], 2 * torch.ones(2))


def test_checkpoint_keeps_0d_tensor_leaves_and_named_tuples(tmp_path):
    """A 0-d tensor leaf (a train step counter, a mixing weight) comes
    back 0-d, and a named tuple node as the same named tuple."""
    from repro_torch.train.optimizer import TrainState

    mgr = CheckpointManager(str(tmp_path))
    state = TrainState(step=torch.tensor(5, dtype=torch.int32),
                       params={"w": torch.ones(3), "mix": torch.tensor(.5)},
                       mu=[torch.zeros(()), torch.ones(2)], nu=None,
                       compress_err=(torch.zeros(()),))
    mgr.save(5, state)
    got = mgr.restore(state)
    assert isinstance(got, TrainState) and got.nu is None
    for a, b in zip(tree_flatten(got)[0], tree_flatten(state)[0]):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": np.ones((2, 2))})
    with pytest.raises(ValueError):
        mgr.restore({"w": np.ones((3, 3))})


def test_checkpoint_structure_mismatch_rejected(tmp_path):
    """The saved structure and leaf count are checked before any leaf is
    paired: a drifted template fails loudly."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"w": np.ones((2, 2)), "b": np.zeros(2)})
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"w": np.ones((2, 2))})            # leaf count drift
    with pytest.raises(ValueError, match="structure"):
        mgr.restore({"w": np.ones((2, 2)),             # renamed key, same
                     "bias": np.zeros(2)})             # ...leaf count
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(
            {"w": np.ones(1)})


@pytest.mark.parametrize("healthy", [64, 60, 37, 1])
def test_elastic_replan(healthy):
    plans = [cls(chips_per_host=4, tp_target=16).plan(
        list(range(healthy)), 64) for cls in (ElasticPlanner, JaxPlanner)]
    for f in ("data", "model", "pod", "dropped_hosts", "resharding"):
        assert getattr(plans[0], f) == getattr(plans[1], f), f
    if healthy == 64:
        assert (plans[0].data, plans[0].model) == (16, 16)
    if healthy == 60:
        assert plans[0].model * plans[0].data == 240
        assert plans[0].dropped_hosts == (60, 61, 62, 63)
        assert "re-slice" in plans[0].resharding


def test_straggler_mitigation():
    ms = [cls(n_hosts=8, threshold=1.5)
          for cls in (StragglerMitigator, JaxStraggler)]
    for m in ms:
        m.observe({h: 1.0 for h in range(8)})
        assert m.stragglers() == []
        m.observe({7: 5.0, 3: 2.6})
    assert ms[0].stragglers() == ms[1].stragglers() == [3, 7]
    backups = ms[0].plan_backups()
    assert backups == ms[1].plan_backups()
    assert 7 in backups and backups[7] != 7


def test_heartbeat():
    hb = HeartbeatMonitor(4, timeout_s=10)
    for h in range(4):
        hb.beat(h, now=100.0)
    assert hb.healthy(now=105.0) == [0, 1, 2, 3]
    assert hb.healthy(now=115.0) == []
    hb.beat(2, now=114.0)
    assert hb.healthy(now=115.0) == [2]


def test_heartbeat_dead_includes_never_beaten():
    hb = HeartbeatMonitor(3, timeout_s=10)
    hb.beat(0, now=100.0)
    assert hb.dead(now=105.0) == [1, 2]
    assert hb.dead(now=111.0) == [0, 1, 2]
    hb.beat(1, now=110.0)
    assert hb.dead(now=111.0) == [0, 2]
    assert sorted(hb.dead(now=111.0) + hb.healthy(now=111.0)) == [0, 1, 2]


@pytest.mark.parametrize("acked", [{0: 5, 1: 9, 2: 9}, {3: 0, 1: 0},
                                   {4: 2}])
def test_most_caught_up_policy(acked):
    assert most_caught_up(acked) == jax_most_caught_up(acked)
    with pytest.raises(ValueError):
        most_caught_up({})
