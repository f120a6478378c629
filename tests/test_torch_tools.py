"""The port's CI gates (``tools/torch_*.py``) against the reference's
(``tools/check_*.py``, ``tools/analyze_plan.py``), on the CPU.

Each port gate's ``main()`` returns 0 and prints, line for line, what
the reference gate prints on the same tables (the recovery gate's
``recover ...ms`` wall time aside); a control whose online side serves
one perturbed feature makes the consistency gate return 1; the port's
certifier CLI gives the reference CLI's certificate (after the stated
differences of ``tests/test_torch_analysis.py``) on the quickstart's SQL,
read statically from the reference's and the port's example alike.
"""

import contextlib
import io
import json
import pathlib
import re
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools import analyze_plan, check_consistency, check_recovery  # noqa
from tools import check_replay  # noqa: E402
from tools import torch_analyze_plan, torch_check_consistency  # noqa: E402
from tools import torch_check_recovery, torch_check_replay  # noqa: E402
from tools import torch_common  # noqa: E402

from test_torch_analysis import _without_counts, expected_port_dict  # noqa


def _run(fn, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(**kw)
    return rc, buf.getvalue()


def _masked(text):
    return re.sub(r"recover [0-9.]+ms", "recover <t>ms", text)


# each gate at its CLI's own sizes (``--bitwise``, 4 shards, 90 actions)
GATES = {
    "replay": (check_replay.main, torch_check_replay.main,
               dict(n_actions=90)),
    "consistency": (check_consistency.main, torch_check_consistency.main,
                    dict(n_shards=4, bitwise=True)),
    "recovery": (check_recovery.main, torch_check_recovery.main,
                 dict(n_shards=4)),
}


@pytest.mark.parametrize("gate", ["replay", "consistency", "recovery"])
def test_port_gate_prints_the_reference_report(gate):
    ref, port, kw = GATES[gate]
    rc_ref, out_ref = _run(ref, **kw)
    rc, out = _run(port, device="cpu", **kw)
    assert rc == rc_ref == 0
    assert _masked(out) == _masked(out_ref)
    assert "BITWISE-EQUAL" in out
    if gate == "consistency":
        assert out.count("BITWISE-EQUAL") == 4
        assert "raw-fused (S=4)" in out


def test_port_gates_default_sizes_pass():
    """The sizes the gates are held to the reference at are the CLIs' own
    (each ``main()``'s defaults, the port's as the reference's)."""
    import inspect

    for ref, port, kw in GATES.values():
        want = inspect.signature(ref).parameters
        got = inspect.signature(port).parameters
        for name, value in kw.items():
            if name != "bitwise":
                assert got[name].default == want[name].default == value
        assert got["device"].default == "cuda"


def test_perturbed_feature_fails_the_gate(monkeypatch):
    """Control: the online side serves one feature of one row off by one
    ulp; the raw bitwise gate must fail and the CLI return 1."""
    from repro_torch.core import consistency as C

    real = C.replay_online

    def perturbed(*args, **kwargs):
        out = real(*args, **kwargs)
        col = out["s"].copy()
        col[7] = np.nextafter(col[7], np.float32(np.inf))
        return dict(out, s=col)

    monkeypatch.setattr(C, "replay_online", perturbed)
    rc, out = _run(torch_check_consistency.main, n_shards=2, bitwise=False,
                   device="cpu")
    assert rc == 1
    assert "BITWISE-EQUAL" not in out.splitlines()[0]


def test_common_helpers():
    n, flags = torch_common.tail_int_argv(["--bitwise", "7"], 4, "--bitwise")
    assert n == 7 and flags == {"bitwise": True}
    assert torch_common.device_argv(["3", "--device", "cpu"]) == \
        ("cpu", ["3"])
    assert torch_common.device_argv(["3"]) == ("cuda", ["3"])
    with pytest.raises(SystemExit):
        torch_common.device_argv(["--device"])
    assert (torch_common.RAW_SQL, torch_common.PREAGG_SQL) == \
        (check_consistency.RAW_SQL, check_consistency.PREAGG_SQL)
    from repro_torch.data.synthetic import make_action_tables

    t = torch_common.int_prices(make_action_tables(
        n_actions=20, n_orders=0, n_users=2, seed=0, with_profile=False))
    p = t["actions"].columns["price"]
    assert p.dtype == np.float32 and np.array_equal(p, np.floor(p))


def test_analyze_plan_certificate_matches_reference(tmp_path):
    """The quickstart's SQL through both CLIs: the same certificate
    after the stated differences; the port reads its own example and the
    reference's statically, to the same SQL; ``--cross-check`` passes on
    the CPU."""
    ref_json, port_json = tmp_path / "ref.json", tmp_path / "port.json"
    ex = ROOT / "examples"
    assert torch_analyze_plan.load_sql(ex / "torch_quickstart.py") == \
        analyze_plan.load_sql(ex / "quickstart.py")
    assert analyze_plan.main([str(ex / "quickstart.py"), "--json",
                              str(ref_json), "--n-actions", "60"]) == 0
    rc, out = _run(torch_analyze_plan.main, argv=[
        str(ex / "torch_quickstart.py"), "--json", str(port_json),
        "--n-actions", "60", "--cross-check", "--device", "cpu"])
    assert rc == 0 and "conservative-consistent" in out
    got = json.loads(port_json.read_text())
    want = expected_port_dict(json.loads(ref_json.read_text()))
    assert _without_counts(got) == _without_counts(want)
    for name in ("torch_online_serving.py", "torch_offline_training.py"):
        ref_name = name.replace("torch_", "")
        assert torch_analyze_plan.load_sql(ex / name) == \
            analyze_plan.load_sql(ex / ref_name)
