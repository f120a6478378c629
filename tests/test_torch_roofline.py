"""The port's roofline (``repro_torch.roofline``) against the JAX
package's: ``report`` (``model_flops``, ``cell_report``, ``make_table``)
over both registries, and ``analyze_step``'s count of one eager step
against ``repro.roofline.analyze_hlo`` of the same step's compiled HLO.

``model_flops`` is plain Python over the configs: bitwise for every
(arch, shape).  The report's terms differ only by the peaks (the H100's
in the port, the reference's own there): the reference's module is given
the port's peaks for the comparison.  The step FLOPs (matmul-class ops,
2 x |result| x |contracted|) must agree within 1% on reduced configs in
float32: llama3-8b prefill, decode and a two-microbatch train step (equal
to the FLOP), hymba-1.5b's three steps (prefill and decode equal to the
FLOP; the train step counts 131,072 FLOPs, 0.17%, above the HLO's: a
gap inside the bar that is not traced to its op), and the
reference's own two loop cases (``tests/test_hlo_and_serve.py``) as
Python loops.  Bytes are not compared: eager torch materialises every op
that XLA fuses (``roofline.trace_analyzer``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import reduced as j_reduced
from repro.models import model as JM
from repro.roofline import analyze_hlo
from repro.roofline import report as JR
from repro.train import optimizer as JO
from repro.train import steps as JS
from repro_torch.configs import ARCHS, SHAPES, reduced
from repro_torch.kernels import dispatch
from repro_torch.kernels.batch_windowfold import ops as bwf_ops
from repro_torch.kernels.chunked_scan import ops as ls_ops
from repro_torch.kernels.feature_hash import ops as fh_ops
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.segagg import ops as seg_ops
from repro_torch.models import model as TM
from repro_torch.roofline import StepCounter, analyze_step
from repro_torch.roofline import report as TR
from repro_torch.train import optimizer as TO
from repro_torch.train import steps as TS

B, S, CAP = 2, 32, 64
META = torch.device("meta")


# ---------------------------------------------------------------- report


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_bitwise(arch):
    assert set(SHAPES) == set(J_SHAPES)
    for shape in sorted(SHAPES):
        assert TR.model_flops(arch, shape) == JR.model_flops(arch, shape), \
            shape


def _records():
    return [
        {"arch": "llama3-8b", "shape": "decode_32k", "mesh": "16x16",
         "n_devices": 256, "status": "OK", "n_micro": None,
         "flops_loop_aware": 1.609e10, "hbm_bytes_loop_aware": 6.53e9,
         "collectives": {"total": 2.5e7},
         "memory": {"peak_bytes": None, "temp_bytes": None}},
        {"arch": "hymba-1.5b", "shape": "train_4k", "mesh": "16x16",
         "n_devices": 256, "status": "OK", "n_micro": 4,
         "flops_loop_aware": 3.1e13, "hbm_bytes_loop_aware": 9.0e11,
         "collectives": {"total": 0.0}, "memory": {}},
        {"arch": "llama3-8b", "shape": "long_500k", "mesh": "16x16",
         "status": "SKIP", "reason": "quadratic attention"},
        {"arch": "qwen3-8b", "shape": "prefill_32k", "mesh": "2x16x16",
         "n_devices": 512, "status": "OK", "flops_loop_aware": 2.0e13,
         "hbm_bytes_loop_aware": 1.0e12, "collectives": {"total": 0.0}},
    ]


def _h100_peaks(monkeypatch, peak):
    monkeypatch.setattr(JR, "PEAK_FLOPS", peak)
    monkeypatch.setattr(JR, "HBM_BW", TR.HBM_BW)
    monkeypatch.setattr(JR, "ICI_BW", TR.NVLINK_BW)


def test_cell_report_and_table_match_reference(tmp_path, monkeypatch):
    for i, rec in enumerate(_records()):
        (tmp_path / f"{i}.json").write_text(json.dumps(rec))
    _h100_peaks(monkeypatch, TR.PEAK_FLOPS)
    recs = TR.load_records(str(tmp_path))
    assert recs == JR.load_records(str(tmp_path))
    for rec in recs:
        assert TR.cell_report(rec) == JR.cell_report(rec)
    for mesh in ("16x16", "2x16x16"):
        assert TR.make_table(str(tmp_path), mesh) == \
            JR.make_table(str(tmp_path), mesh)
    assert "| llama3-8b | decode_32k |" in TR.make_table(str(tmp_path))


def test_float32_record_takes_the_float32_peak(monkeypatch):
    rec = dict(_records()[0], dtype="float32")
    _h100_peaks(monkeypatch, TR.PEAK_FLOPS_F32)
    assert TR.cell_report(rec) == JR.cell_report(rec)
    assert TR.cell_report(rec)["t_compute_s"] == \
        rec["flops_loop_aware"] / 67e12


def test_h100_peaks():
    assert (TR.PEAK_FLOPS, TR.PEAK_FLOPS_F32, TR.HBM_BW, TR.NVLINK_BW) == \
        (989e12, 67e12, 3.35e12, 450e9)


# ---------------------------------------------------- analyze_step vs HLO


def _hlo_flops(fn, *args):
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()).flops


def _steps(arch, kind):
    """(reference HLO FLOPs, the port's StepCost) of one reduced step in
    float32 (the port on the CPU: its kernels' plain versions)."""
    jc, tc = j_reduced(arch), reduced(arch)
    pj = jax.eval_shape(lambda: JM.init_params(
        jc, jax.random.PRNGKey(0), dtype=jnp.float32))
    pt = TM.init_params(tc, torch.Generator().manual_seed(0),
                        dtype=torch.float32, device="cpu")
    tok_j = jax.ShapeDtypeStruct((B, S), jnp.int32)
    tok_t = torch.zeros((B, S), dtype=torch.int32)
    if kind == "prefill":
        ref = _hlo_flops(lambda p, b: JM.forward_prefill(
            jc, p, b, cache_capacity=CAP), pj, {"tokens": tok_j})
        got = analyze_step(TM.forward_prefill, tc, pt, {"tokens": tok_t},
                           cache_capacity=CAP)
    elif kind == "decode":
        cj = jax.eval_shape(lambda: JM.init_decode_state(
            jc, B, CAP, dtype=jnp.float32))
        ref = _hlo_flops(lambda p, c, t: JM.decode_step(jc, p, c, t), pj,
                         cj, jax.ShapeDtypeStruct((B, 1), jnp.int32))
        ct = TM.init_decode_state(tc, B, CAP, dtype=torch.float32,
                                  device="cpu")
        got = analyze_step(TM.decode_step, tc, pt, ct,
                           torch.zeros((B, 1), dtype=torch.int32))
    else:
        ref = _hlo_flops(JS.build_train_step(jc, n_micro=2,
                                             compute_dtype=jnp.float32),
                         jax.eval_shape(JO.adamw_init, pj),
                         {"tokens": tok_j})
        got = analyze_step(TS.build_train_step(
            tc, n_micro=2, compute_dtype=torch.float32),
            TO.adamw_init(pt), {"tokens": tok_t})
    return ref, got


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ["llama3-8b", "hymba-1.5b"])
def test_step_flops_match_hlo(arch, kind):
    ref, got = _steps(arch, kind)
    assert ref > 0
    assert got.flops == pytest.approx(ref, rel=0.01)
    if arch == "llama3-8b" or kind != "train":
        assert got.flops == ref
    assert got.loops == [] and got.unknown_loops == []
    assert set(got.as_dict()) == {"flops", "hbm_bytes", "collectives",
                                  "loops", "unknown_loops"}
    assert got.collectives["total"] == 0.0
    names = set(got.kernels)
    if kind == "decode":
        assert names == {"decode_partials"}
    elif arch == "hymba-1.5b":
        assert names == ({"linear_scan"} if kind == "prefill"
                         else {"linear_scan", "linear_scan_bwd"})
    # one record per layer call: the launches on the card
    calls = {k: v["calls"] for k, v in got.kernels.items()}
    n_layers = reduced(arch).n_layers
    if kind == "decode":
        assert calls == {"decode_partials": n_layers}
    if arch == "hymba-1.5b" and kind == "train":
        # 2 microbatches x (forward + remat recompute); backward once each
        assert calls == {"linear_scan": 4 * n_layers,
                         "linear_scan_bwd": 2 * n_layers}


def test_loop_cases_as_python_loops():
    """The reference's two loop cases (a 12-trip scan; 5 inside 3), as
    the eager loops the port runs: every iteration is counted."""
    def f(x):
        for _ in range(12):
            x = x @ x
        return x.sum()

    def g(x):
        for _ in range(3):
            for _ in range(5):
                x = x @ x
        return x.sum()

    for fn, n, trips in ((f, 128, 12), (g, 64, 15)):
        cost = analyze_step(fn, torch.randn(n, n))
        assert cost.flops == pytest.approx(trips * 2 * n ** 3, rel=0.01)
        assert cost.flops == trips * 2 * n ** 3
        assert not cost.unknown_loops


def test_views_are_free_and_materialised_ops_count_bytes():
    x = torch.randn(16, 32)
    cost = analyze_step(lambda: x.t().reshape(32, 16)[:4].unsqueeze(0))
    assert cost.hbm_bytes == 0 and cost.flops == 0
    cost = analyze_step(lambda: x + 1.0)
    assert cost.hbm_bytes == 2 * x.numel() * 4


# ------------------------------------------------ the kernels' own records


def test_decode_partials_on_meta_reports_its_formula_only():
    b, s, hq, hkv, d = 8, 2048, 25, 5, 64
    q = torch.empty((b, hq, d), device=META)
    k = torch.empty((b, s, hkv, d), dtype=torch.bfloat16, device=META)
    v = torch.empty_like(k)
    with StepCounter() as counter:
        m, l, o = fd_ops.decode_partials(q, k, v)
    cost = counter.result()
    want = fd_ops.cost(b, hq, hkv, d, b * s, 2)
    assert cost.flops == want.flops == 4 * d * b * s * hq
    assert cost.hbm_bytes == want.nbytes
    assert cost.kernels == {"decode_partials": {
        "calls": 1, "flops": float(want.flops), "bytes": float(want.nbytes)}}
    assert (m.shape, l.shape, o.shape) == ((b, hq), (b, hq), (b, hq, d))
    assert m.device.type == "meta" and o.dtype == torch.float32


def _kernel_calls(device):
    """One call of every kernel's public op on ``device``."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn((2, 4, 8), generator=gen)
    k = torch.randn((2, 16, 2, 8), generator=gen)
    a = torch.rand((2, 12, 5), generator=gen)
    x = torch.randn((2, 12, 5), generator=gen, requires_grad=True)
    codes = torch.randint(0, 1000, (37,), generator=gen, dtype=torch.int32)
    vals = torch.randn((40, 3), generator=gen)
    seg = torch.randint(0, 6, (40,), generator=gen, dtype=torch.int32)
    keys = torch.sort(torch.randint(0, 4, (40,), generator=gen,
                                    dtype=torch.int32)).values
    ts = torch.arange(40, dtype=torch.int32)
    qk = torch.tensor([0, 1, 3], dtype=torch.int32)
    t0 = torch.tensor([0, 5, 9], dtype=torch.int32)
    t1 = torch.tensor([20, 30, 39], dtype=torch.int32)
    to = (lambda t: t.to(device)) if device == "cpu" else \
        (lambda t: torch.empty_like(t, device=META)
         .requires_grad_(t.requires_grad))
    ys = to(x)
    calls = {
        "decode_partials": lambda: fd_ops.decode_partials(to(q), to(k),
                                                          to(k)),
        "linear_scan": lambda: ls_ops.linear_scan(to(a), ys).sum()
        .backward(),
        "feature_hash": lambda: fh_ops.feature_hash(to(codes), 1 << 10),
        "segagg": lambda: seg_ops.segagg(to(vals), to(seg), 6),
        "batch_windowfold": lambda: bwf_ops.batch_windowfold(
            to(keys), to(ts), to(vals), to(qk), to(t0), to(t1)),
    }
    return calls


@pytest.mark.parametrize("name", ["decode_partials", "linear_scan",
                                  "feature_hash", "segagg",
                                  "batch_windowfold"])
def test_kernel_records_equal_on_cpu_and_meta(name):
    """Each kernel's public op reports the same record on the CPU (its
    plain version, whose ops are not counted again) and on ``meta`` (no
    computation), and returns outputs of the same shapes and dtypes."""
    outs, costs = {}, {}
    for device in ("cpu", "meta"):
        with StepCounter() as counter:
            outs[device] = _kernel_calls(device)[name]()
        costs[device] = counter.result()
    cpu, meta = costs["cpu"], costs["meta"]
    assert cpu.kernels == meta.kernels and cpu.kernels
    assert cpu.flops == meta.flops and cpu.hbm_bytes == meta.hbm_bytes
    # only the record (and, for the scan, the loss's own sum) is counted
    recorded = sum(r["bytes"] for r in cpu.kernels.values())
    assert cpu.hbm_bytes >= recorded
    a, b = outs["cpu"], outs["meta"]
    if a is not None:
        for x, y in zip(*(o if isinstance(o, tuple) else (o,)
                          for o in (a, b))):
            assert x.shape == y.shape and x.dtype == y.dtype
    if name == "linear_scan":
        assert cpu.kernels["linear_scan_bwd"]["calls"] == 1


def test_kernel_cost_without_counter_is_inert():
    """Without a counter a record goes nowhere; a ``None`` cost (a call
    that launches nothing) records nothing and hides no op."""
    with dispatch.kernel_cost("x", dispatch.KernelCost(1, 2, 3)):
        pass
    with StepCounter() as counter:
        with dispatch.kernel_cost("x", None):
            torch.ones(3) + 1
    assert counter.result().kernels == {}
    assert counter.result().hbm_bytes > 0


def test_chip_smoke_bounds_use_the_kernels_cost():
    """The bounds ``chip_smoke.py`` prints are the kernels' ``cost``: the
    formulas it held before the move, at its shapes."""
    n = 8 * 1024 * 51_200
    assert ls_ops.cost(n) == (3 * n * 4, 2 * n, 0)
    assert ls_ops.cost(n, True) == (5 * n * 4, 3 * n, 0)
    assert fh_ops.cost(1 << 20) == (8 << 20, 12 << 20, 0)
    assert seg_ops.cost(1000, 3, 600) == (1000 * 16 + 600 * 12, 3000, 0)
    live, b, hq, hkv, d = 8269, 8, 25, 5, 64
    c = fd_ops.cost(b, hq, hkv, d, live, 2)
    assert c.nbytes == (live * hkv * d * 2 * 2 + b * hq * d * 4
                        + b * hq * (d + 2) * 4)
    assert c.ops == live * (hq // hkv) * hkv * 4 * d
    assert bwf_ops.cost(999, 256, 2).nbytes == 999 * 16 + 256 * 12 + \
        256 * 2 * 4
    assert np.isclose(bwf_ops.cost(10, 2, 3).flops, 2 * 2 * 10 * 3)


def test_index_put_counts_the_written_slice_only():
    """A cache update at indices moves what it writes, not the cache."""
    cache = torch.zeros((4, 1024, 2, 8))
    rows, pos = torch.arange(4), torch.tensor([3, 5, 7, 9])
    new = torch.ones((4, 2, 8))

    def write():
        cache[rows, pos] = new

    cost = analyze_step(write)
    assert cost.hbm_bytes == 2 * new.numel() * 4 + 2 * 4 * 8
    assert cache[2, 7].sum() == 16
