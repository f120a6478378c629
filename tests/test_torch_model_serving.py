"""Model serving, port against reference: the dense and hybrid families
(``reduced("llama3-8b")``, ``reduced("hymba-1.5b")``) in float32 on the
CPU.  The JAX package's parameters go through ``params_from_jax``; the
same numpy tokens go through both packages' ``forward_prefill`` and
``decode_step`` and both ``ServingEngine``s.

Tolerance rtol/atol 1e-4 on logits and caches: the port's SSM scan is
the sequential recurrence and the reference's an associative scan, and
matrix products sum in another order (the reference's own kernel bar,
``tests/test_kernels.py``).  Greedy tokens must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import reduced as jax_reduced
from repro.models import model as JM
from repro.serve.engine import ServingEngine as JaxServingEngine
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import dispatch
from repro_torch.models import model as TM
from repro_torch.serve.engine import ServingEngine

RTOL = ATOL = 1e-4
B, PROMPT, STEPS, CAP = 2, 12, 6, 32

# (arch, layers): reduced hymba has 2 layers, both global (layer 0 and
# the last); at 4 layers layer 1 slides its window of 8 over the prompt
# of 12 and over every decode step
CASES = [("hymba-1.5b", 2), ("hymba-1.5b", 4), ("llama3-8b", 2)]


def _cfgs(arch, n_layers):
    return (dataclasses.replace(jax_reduced(arch), n_layers=n_layers),
            dataclasses.replace(reduced(arch), n_layers=n_layers))


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}-L{n}" for a, n in CASES])
def model_pair(request):
    jcfg, tcfg = _cfgs(*request.param)
    jparams = jax.jit(lambda key: JM.init_params(jcfg, key, jnp.float32))(
        jax.random.PRNGKey(0))
    tparams = TM.params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                                 device="cpu")
    rng = np.random.default_rng(sum(map(ord, jcfg.name)) + jcfg.n_layers)
    prompt = rng.integers(0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    steps = rng.integers(0, jcfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, prompt, steps


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def test_configs_are_the_references():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    for name in ARCHS:
        assert dataclasses.asdict(ARCHS[name]) == \
            dataclasses.asdict(JAX_ARCHS[name])
        assert dataclasses.asdict(reduced(name)) == \
            dataclasses.asdict(jax_reduced(name))
        assert ARCHS[name].n_params() == JAX_ARCHS[name].n_params()


def test_layer_flags_match(model_pair):
    jcfg, tcfg = model_pair[:2]
    np.testing.assert_array_equal(TM._layer_flags(tcfg),
                                  JM._layer_flags(jcfg))


def test_params_from_jax_and_init_shapes(model_pair):
    """params_from_jax unstacks the L axis; init_params draws the same
    shapes and dtypes."""
    jcfg, tcfg, jparams, tparams = model_pair[:4]
    jl = jax.tree.map(np.asarray, jparams)["layers"]
    for i, lp in enumerate(tparams["layers"]):
        flat_t = dict(_flatten(lp))
        flat_j = dict(_flatten(jl))
        assert flat_t.keys() == flat_j.keys()
        for k, v in flat_t.items():
            np.testing.assert_array_equal(v.numpy(), flat_j[k][i])
    fresh = TM.init_params(tcfg, torch.Generator().manual_seed(1),
                           dtype=torch.float32, device="cpu")
    assert _shapes(fresh) == _shapes(tparams)


def _shapes(tree):
    return {k: (tuple(v.shape), v.dtype) for k, v in _flatten(tree)}


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_prefill_and_decode_match_reference(model_pair):
    """Prefill logits, KV caches and SSM states, then STEPS decode steps
    whose positions 12..17 cross the reduced window of 8."""
    jcfg, tcfg, jparams, tparams, prompt, steps = model_pair
    jlog, jst = JM.forward_prefill(jcfg, jparams,
                                   {"tokens": jnp.asarray(prompt)},
                                   cache_capacity=CAP)
    tlog, tst = TM.forward_prefill(tcfg, tparams,
                                   {"tokens": torch.from_numpy(prompt)},
                                   cache_capacity=CAP)
    _close(tlog.numpy(), jlog, "prefill logits")
    assert tlog.shape == (B, tcfg.vocab_padded)
    np.testing.assert_array_equal(tst["len"].numpy(), jst["len"])
    for i, lc in enumerate(tst["layers"]):
        for kv in ("k", "v"):
            _close(lc["attn"][kv].numpy(),
                   np.asarray(jst["layers"]["attn"][kv][i]), f"cache {kv}")
        if tcfg.family == "hybrid":
            _close(lc["ssm"].numpy(), np.asarray(jst["layers"]["ssm"][i]),
                   "ssm state")
    decode = jax.jit(lambda p, s, t: JM.decode_step(jcfg, p, s, t))
    for t, tok in enumerate(steps):
        jlog, jst = decode(jparams, jst, jnp.asarray(tok))
        tlog, tst = TM.decode_step(tcfg, tparams, tst, torch.from_numpy(tok))
        _close(tlog.numpy(), jlog, f"decode step {t}")
    np.testing.assert_array_equal(tst["len"].numpy(), jst["len"])
    last = tst["layers"][-1]["attn"]["k"].numpy()
    _close(last, np.asarray(jst["layers"]["attn"]["k"][-1]), "decoded cache")


def test_generate_greedy_tokens_equal(model_pair):
    jcfg, tcfg, jparams, tparams, prompt, _ = model_pair
    want = JaxServingEngine(jcfg, jparams, max_len=CAP,
                            dtype=jnp.float32).generate_greedy(
        {"tokens": jnp.asarray(prompt)}, n_tokens=STEPS)
    eng = ServingEngine(tcfg, tparams, max_len=CAP, dtype=torch.float32,
                        device="cpu")
    got = eng.generate_greedy({"tokens": prompt}, n_tokens=STEPS)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert int(eng.state["len"][0]) == PROMPT + STEPS
    empty = eng.init_state(B)
    assert [t.shape for t in empty["layers"][0]["attn"].values()] == \
        [t.shape for t in eng.state["layers"][0]["attn"].values()]


def test_cpu_serving_launches_no_kernel(model_pair):
    """On the CPU the engine runs the plain versions (no launch counted);
    forcing the kernels there raises."""
    tcfg, tparams, prompt = model_pair[1], model_pair[3], model_pair[4]
    dispatch.reset_launch_counts()
    ServingEngine(tcfg, tparams, max_len=CAP, dtype=torch.float32,
                  device="cpu").generate_greedy({"tokens": prompt}, 2)
    assert dispatch.launch_counts() == {}
    forced = ServingEngine(tcfg, tparams, max_len=CAP, dtype=torch.float32,
                           device="cpu", use_kernel=True)
    with pytest.raises(dispatch.KernelUnsupportedError):
        forced.generate_greedy({"tokens": prompt}, 2)


def test_params_from_jax_takes_bf16_leaves():
    """The reference's default parameter dtype is bfloat16 (numpy arrays
    of ml_dtypes' bfloat16): the same bits in torch.bfloat16."""
    jcfg, tcfg = _cfgs("llama3-8b", 2)
    jparams = jax.tree.map(np.asarray, jax.jit(
        lambda key: JM.init_params(jcfg, key, jnp.bfloat16))(
        jax.random.PRNGKey(1)))
    got = TM.params_from_jax(tcfg, jparams, device="cpu")
    assert got["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["layers"][1]["attn"]["wq"].float().numpy(),
        jparams["layers"]["attn"]["wq"][1].astype(np.float32))


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = reduced("llama3-8b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params, max_len=16)


@pytest.mark.parametrize("ctor", ["init_params", "params_from_jax",
                                  "init_decode_state"])
def test_model_constructors_default_to_the_card(ctor):
    """Like every entry point of the port, the model's constructors run on
    the card unless the caller passes ``device="cpu"``: without a card the
    default raises (``dispatch.resolve_device``)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = reduced("llama3-8b")
    args = {"init_params": (cfg, torch.Generator().manual_seed(0)),
            "params_from_jax": (cfg, {}),
            "init_decode_state": (cfg, 1, 8)}[ctor]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(TM, ctor)(*args)


def test_launch_serve_runs_on_cpu(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--device", "cpu", "--arch", "hymba-1.5b",
                       "--requests", "16", "--batch-size", "8"]) == 16
    assert "[serve] 16 requests" in capsys.readouterr().out


def test_launch_serve_times_each_request_alone(monkeypatch, capsys):
    """``launch.serve`` asks for one request's features at a time, as the
    reference's does: one latency sample per request, each from a
    single-row ``request``, and ``request_batch`` never called."""
    from repro_torch.launch import serve
    from repro_torch.serve.engine import FeatureEngine

    engines, rows = [], []
    real_init, real_request = FeatureEngine.__init__, FeatureEngine.request

    def init(self, *args, **kw):
        real_init(self, *args, **kw)
        engines.append(self)

    def request(self, row):
        rows.append(row)
        return real_request(self, row)

    def request_batch(self, *args, **kw):
        raise AssertionError("launch.serve called request_batch")

    monkeypatch.setattr(FeatureEngine, "__init__", init)
    monkeypatch.setattr(FeatureEngine, "request", request)
    monkeypatch.setattr(FeatureEngine, "request_batch", request_batch)
    assert serve.main(["--device", "cpu", "--requests", "16",
                       "--batch-size", "8"]) == 16
    (eng,) = engines
    assert len(rows) == 16 and all(isinstance(r, dict) for r in rows)
    assert eng.n_requests == 16 and len(eng.latencies_ms) == 16
    assert "[serve] 16 requests" in capsys.readouterr().out
