"""A whole run of each driver kind at tiny sizes on the CPU (the
harness's look for a card skipped), sound and with each planted fault:
the check comes out correct, and not correct under every fault; and the
control (the reference in float8 in the program's place) fails the
check."""

import pytest
import torch

from port_bench import cell as cells
from port_bench import judge
from port_bench.faults import plant
from port_bench.tests import tiny

CELLS = sorted(tiny.CASES)
PAIRS = [(name, fault) for name in CELLS
         for fault in sorted(tiny.tiny_cell(name).driver.FAULTS)]


def _f32(name):
    """The tiny cell computing in f32: its sound gaps are rounding, far
    under any limit the cell states."""
    c = tiny.tiny_cell(name, seed=2**31 + 11)
    c.cfg["compute_dtype"] = "float32"
    return c


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = cells.execute(_f32(name), 0.0)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name,fault", PAIRS)
def test_fault_is_not_correct(name, fault):
    c = _f32(name)
    with plant(c.driver, fault):
        r = cells.execute(c, 0.0)
    assert not r["correct"], r["checks"]


def test_unknown_fault_is_refused():
    c = tiny.tiny_cell("hymba-1.5b.train")
    with pytest.raises(ValueError):
        with plant(c.driver, "no_such_fault"):
            pass


@pytest.mark.parametrize("name", CELLS)
def test_control_hooks_judge_each_variant(name):
    """``control.py``'s path: the reference once, then the program passes
    and the control fails the cell's limits."""
    c = _f32(name)
    ref = c.driver.control_reference(c)
    got = {}
    for variant in ("program", "control"):
        nums, _ = c.driver.control_numbers(c, variant, ref)
        got[variant] = judge.passed(judge.checks(nums, c.entry["limits"]))
    assert got == {"program": True, "control": False}


def test_train_control_is_not_correct():
    from port_bench.drivers import train
    c = tiny.tiny_cell("hymba-1.5b.train", seed=2**31 + 12)
    ref = train.reference_readings(c)
    nums = train.compare(c, train.reference_readings(c, fp8=True), ref)
    assert not judge.passed(judge.checks(nums, c.entry["limits"])), nums


def test_prefill_control_is_not_correct():
    from port_bench.drivers import prefill
    from port_bench.reference import common as C
    c = tiny.tiny_cell("minicpm3-4b.prefill", seed=2**31 + 13)
    params = prefill.reference_weights(c)
    nums = prefill.new_numbers()
    for i, k in enumerate(c.traffic["classes"]):
        tok = torch.from_numpy(prefill.prompts(c, i, k["rows"], k["seq"]))
        ref = c.ref.prefill(c.cfg, params, tok)
        got = c.ref.prefill(c.cfg, params, tok, C.Precision(fp8=True))
        prefill.fold(nums, c.cfg["vocab_size"], got[0], ref[0],
                     dict(C.flat(got[1])), ref[1])
    assert not judge.passed(judge.checks(nums, c.entry["limits"])), nums


def test_prefill_state_leaf_left_uncompared_is_an_error():
    """A leaf of the program's state that the reference does not return
    (an RWKV shift, say) raises rather than going unchecked."""
    from port_bench.drivers import prefill
    from port_bench.reference import common as C
    c = tiny.tiny_cell("minicpm3-4b.prefill")
    params = prefill.reference_weights(c)
    tok = torch.from_numpy(prefill.prompts(c, 0, 2, 16))
    lg, st = c.ref.prefill(c.cfg, params, tok)
    got = dict(C.flat(st), **{"layers.0.shift1": torch.zeros(2, 4)})
    with pytest.raises(ValueError, match="shift1"):
        prefill.fold(prefill.new_numbers(), c.cfg["vocab_size"], lg, lg,
                     got, st)
