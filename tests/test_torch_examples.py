"""The port's examples (``examples/torch_*.py``) run to their end on the
CPU, and the quickstart's offline features equal the reference's.

The quickstart compiles the same SQL over the same seeded tables as
``examples/quickstart.py``; its ``offline()`` features are held to the
reference's ``cs.offline`` column by column, bitwise: ROADMAP's contract
asks bitwise where the reduction order is pinned (counts, the LAST JOIN
column, the row-wise product, distinct counts, top-n codes) and allows
a stated tolerance elsewhere, but the float sum and the category
averages of this script come out bitwise too (the port copies the
reference's scan bracketing), so no column takes one.  The
online-serving example streams fewer events than its default
(``--events``), and the training example takes 10 steps of a smaller
model (``--steps`` etc.; 10 is the first step that writes the
checkpoint it restores), with its checkpoints under ``tmp_path``.
"""

import pathlib
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))

import quickstart as ref_quickstart  # noqa: E402
import torch_offline_training  # noqa: E402
import torch_online_serving  # noqa: E402
import torch_quickstart  # noqa: E402

def test_quickstart_runs_and_matches_reference_offline(capsys):
    from repro.core import compile_script, parse
    from repro.data.synthetic import make_action_tables

    assert torch_quickstart.SQL == ref_quickstart.SQL
    got = torch_quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "BITWISE-EQUAL" in out and "== 5." in out
    tables = make_action_tables(n_actions=400, n_orders=250, n_users=8,
                                horizon_ms=2_000_000)
    want = compile_script(parse(ref_quickstart.SQL),
                          tables=tables).offline(tables)
    assert set(got) == set(want)
    for name in want:
        a, b = np.asarray(want[name]), np.asarray(got[name])
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    # the module's own offline() is the same computation
    again = torch_quickstart.offline("cpu")
    for name in got:
        np.testing.assert_array_equal(again[name], got[name])


def test_online_serving_runs(capsys):
    n_requests, scored = torch_online_serving.main(
        ["--device", "cpu", "--events", "30"])
    assert n_requests == 10 and scored == n_requests
    assert "== done: 10 feature requests" in capsys.readouterr().out


def test_offline_training_runs_with_checkpoints(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    losses = torch_offline_training.main([
        "--device", "cpu", "--ckpt-dir", str(ckpt), "--steps", "10",
        "--batch", "8", "--seq", "16", "--d-model", "32", "--layers", "1"])
    assert len(losses) == 10 and losses[-1] < losses[0]
    assert any(ckpt.glob("step_00000010.*"))
    out = capsys.readouterr().out
    assert "resumed at step 11" in out


@pytest.mark.parametrize("module", [torch_quickstart, torch_online_serving,
                                    torch_offline_training])
def test_examples_default_to_the_card(module, tmp_path):
    """Without ``--device`` an example runs on the card: here, with no
    card, it raises instead of moving to the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--ckpt-dir", str(tmp_path)]
                    if module is torch_offline_training else [])
