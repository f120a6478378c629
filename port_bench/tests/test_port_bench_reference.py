"""The plain references against the program's plain path (CPU, f32, the
program's ``reduced`` widths), the weights' layout against the
program's parameter tree, and the chunked scan against a step loop."""

import numpy as np
import pytest
import torch

from port_bench import weights
from port_bench.reference import common as C
from port_bench.reference import hybrid, mla
from port_bench.tests.tiny import cfg_of
from port_bench import cell as cells


def _setup(config: str, ref):
    from repro_torch.configs import get, reduced
    base = cells.read_json(cells.BENCH_DIR / "configs" / f"{config}.json")
    arch = reduced(get(base["arch"]).name)
    cfg = cfg_of(arch, base)
    params = weights.draw(ref.layout(cfg), 3, torch.float32, "cpu")
    return arch, cfg, params


def _tokens(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg["vocab_size"], (b, s),
                                         dtype=np.int32))


@pytest.mark.parametrize("config,ref", [("hymba-1.5b", hybrid),
                                        ("minicpm3-4b", mla)])
def test_layout_is_the_programs_tree(config, ref):
    """At the full sizes (shapes only) and at the reduced ones."""
    from repro_torch.configs import get
    from repro_torch.models import init_params
    base = cells.read_json(cells.BENCH_DIR / "configs" / f"{config}.json")
    arch = get(base["arch"])
    prog = init_params(arch, None, dtype=torch.float32, device="meta")
    specs = ref.layout(base)

    def shapes(tree):
        if isinstance(tree, dict) and not weights._is_spec(tree):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree[0]) if weights._is_spec(tree) else tuple(
            tree.shape)

    assert shapes(specs) == shapes(prog)
    _, _, params = _setup(config, ref)
    assert set(dict(C.flat(params))) == {
        k for k, _ in C.flat(init_params(
            _setup(config, ref)[0], torch.Generator().manual_seed(0),
            dtype=torch.float32, device="cpu"))}


def test_hybrid_loss_and_grads_match_the_program():
    from repro_torch.models import forward_train
    arch, cfg, params = _setup("hymba-1.5b", hybrid)
    tok = _tokens(cfg, 2, 24)
    prog = {k: v.clone().requires_grad_() for k, v in C.flat(params)}
    tree = _unflat(params, prog)
    loss_p, _ = forward_train(arch, tree, {"tokens": tok}, remat=False)
    gp = torch.autograd.grad(loss_p, list(prog.values()))
    ref = {k: v.clone().requires_grad_() for k, v in C.flat(params)}
    with C.exact_float32():
        loss_r = hybrid.loss(cfg, _unflat(params, ref), tok)
    gr = torch.autograd.grad(loss_r, list(ref.values()))
    assert abs(float(loss_p.detach() - loss_r.detach())) < 1e-5 * float(
        loss_r.detach())
    for k, a, b in zip(prog, gp, gr):
        assert torch.allclose(a, b, rtol=2e-4, atol=2e-6 * float(
            b.abs().max()) + 1e-9), k


@pytest.mark.parametrize("config,ref", [("hymba-1.5b", hybrid),
                                        ("minicpm3-4b", mla)])
def test_prefill_logits_and_state_match_the_program(config, ref):
    from repro_torch.serve.engine import ServingEngine
    arch, cfg, params = _setup(config, ref)
    tok = _tokens(cfg, 2, 40, seed=1)
    eng = ServingEngine(arch, params, max_len=40, dtype=torch.float32,
                        device="cpu")
    got = torch.from_numpy(eng.prefill({"tokens": tok.numpy()}))
    with C.exact_float32():
        lg, states = ref.prefill(cfg, params, tok)
    assert torch.allclose(got, lg, rtol=1e-4, atol=1e-5)
    leaves = dict(C.flat(eng.state))
    want = dict(C.flat(states))
    assert set(leaves) == set(want)
    for name, t in leaves.items():
        assert torch.allclose(t.to(torch.float32), want[name].to(
            torch.float32), rtol=1e-4, atol=1e-5), name


def test_chunked_scan_is_the_recurrence():
    g = torch.Generator().manual_seed(0)
    la = -torch.rand((2, 150, 5), generator=g) * 0.5
    u = torch.randn((2, 150, 5), generator=g)
    h, want = torch.zeros(2, 5), []
    for t in range(150):
        h = torch.exp(la[:, t]) * h + u[:, t]
        want.append(h)
    assert torch.allclose(hybrid.scan(la, u), torch.stack(want, 1),
                          rtol=1e-5, atol=1e-5)


def test_weights_repeat_from_the_seed():
    _, cfg, _ = _setup("minicpm3-4b", mla)
    lay = mla.layout(cfg)
    a = weights.draw(lay, 2**33 + 5, torch.bfloat16, "cpu")
    b = weights.draw_group(lay, 2**33 + 5, ("layers", 1), torch.bfloat16,
                           "cpu")
    for (k, x), (_, y) in zip(C.flat(a["layers"][1]), C.flat(b)):
        assert torch.equal(x, y), k
    c = weights.draw(lay, 2**33 + 6, torch.bfloat16, "cpu")
    assert not torch.equal(a["embed"], c["embed"])


def test_control_quantizes_to_float8():
    x = torch.randn(64, 64)
    q = C.Precision(fp8=True).q(x)
    assert not torch.equal(q, x)
    assert torch.allclose(q, x, rtol=0.07, atol=x.abs().max() * 2 ** -9)
    assert torch.equal(C.Precision().q(x), x)


def _unflat(template, flat):
    """``template`` with its leaves replaced by ``flat`` (path -> tensor)."""
    def walk(t, prefix):
        if isinstance(t, dict):
            return {k: walk(v, f"{prefix}{k}.") for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, f"{prefix}{i}.") for i, v in enumerate(t)]
        return flat[prefix[:-1]]
    return walk(template, "")
