"""MLA attention and the dense configs that came with it, port against
reference, on the CPU in float32: ``reduced("minicpm3-4b")`` (MLA: the
prefill expands K/V per head, the decode is absorbed attention over the
latent cache), ``reduced("qwen3-8b")`` (qk-norm) and
``reduced("granite-3-8b")``; the config modules of every family since
this slice, and both launchers' ``--arch``.

The JAX package's parameters go through ``params_from_jax``; tokens are
numpy draws from a seed.  Bars: rtol 1e-4 / atol 1e-6 (the bars of
``tests/test_torch_train.py``; ``torch_model_cases`` says how caches
(atol 1e-5) and a param
after an AdamW step is held) on prefill logits and caches (the MLA
latent), decode steps, the training loss and every gradient leaf, one
AdamW step; greedy tokens equal.  Inside the port, the absorbed decode
against the expanded prefill over the same tokens: rtol/atol 1e-5 (two
float32 orders of the same attention).
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get as jax_get
from repro.models import model as JM
from repro_torch.configs import SHAPES, get
from repro_torch.models import model as TM
from repro_torch.train import steps as TS

import torch_model_cases as cases

ARCHS = ["minicpm3-4b", "qwen3-8b", "granite-3-8b"]
MODULES = {"qwen3-8b": "qwen3_8b", "granite-3-8b": "granite_3_8b",
           "minicpm3-4b": "minicpm3_4b",
           "qwen2-moe-a2.7b": "qwen2_moe_a2_7b", "dbrx-132b": "dbrx_132b",
           "llava-next-34b": "llava_next_34b", "whisper-tiny": "whisper_tiny",
           "rwkv6-7b": "rwkv6_7b"}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return cases.make_pair(request.param)


def test_params_from_jax_and_init_shapes(pair):
    cases.check_params(pair)


def test_prefill_and_decode_match_reference(pair):
    cases.check_prefill_decode(pair)


def test_generate_greedy_tokens_equal(pair):
    cases.check_greedy(pair)


def test_forward_train_loss_and_grads_match_reference(pair):
    cases.check_train_grads(pair)


def test_adamw_step_matches_reference(pair):
    cases.check_adamw_step(pair)


def test_absorbed_decode_equals_expanded_prefill():
    """The logits of decode step t (absorbed attention over the latent
    cache) equal the last logits of a prefill over the prompt plus
    those t tokens (K/V expanded per head), as ``chip_smoke.py`` holds
    them on the card at full size."""
    _, tcfg, _, tparams, seed = cases.make_pair("minicpm3-4b")
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, tcfg.vocab_size, (3, 9)).astype(np.int32)
    extra = rng.integers(0, tcfg.vocab_size, (3, 5)).astype(np.int32)
    _, state = TM.forward_prefill(tcfg, tparams,
                                  {"tokens": torch.from_numpy(prompt)},
                                  cache_capacity=24)
    for t in range(extra.shape[1]):
        got, state = TM.decode_step(tcfg, tparams, state,
                                    torch.from_numpy(extra[:, t:t + 1]))
        seq = np.concatenate([prompt, extra[:, :t + 1]], axis=1)
        want, _ = TM.forward_prefill(tcfg, tparams,
                                     {"tokens": torch.from_numpy(seq)})
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {t}")


@pytest.mark.parametrize("name", sorted(MODULES))
def test_config_modules_and_input_specs(name):
    """``repro_torch.configs.<module>.CONFIG`` is the registry's config,
    as in the reference; the input specs of every shape cell (int32
    tokens, bf16 VLM ``patches`` / audio ``frames``) equal the
    reference's."""
    mod = importlib.import_module(f"repro_torch.configs.{MODULES[name]}")
    ref = importlib.import_module(f"repro.configs.{MODULES[name]}")
    assert mod.CONFIG is get(name)
    assert dataclasses.asdict(mod.CONFIG) == dataclasses.asdict(ref.CONFIG)
    for shape in SHAPES:
        got = TM.model_input_spec(get(name), SHAPES[shape])
        want = JM.model_input_spec(jax_get(name), JAX_SHAPES[shape])
        assert got.keys() == want.keys()
        for k, (shp, dtype) in got.items():
            assert shp == want[k].shape
            assert str(dtype).split(".")[-1] == str(want[k].dtype)
        assert TS.train_batch_spec(get(name), SHAPES[shape]) == got


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "minicpm3-4b",
                                  "dbrx-132b", "rwkv6-7b"])
def test_launchers_take_the_family(arch, tmp_path, capsys):
    """``--arch`` of both port launchers takes the MoE, MLA and RWKV6
    families (reduced configs, on the CPU), as the reference's do.  (VLM
    and audio need modality inputs, which neither package's launchers
    feed.)"""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train

    assert launch_serve.main(["--device", "cpu", "--arch", arch,
                              "--requests", "8", "--batch-size", "4"]) == 8
    state = launch_train.main(["--device", "cpu", "--arch", arch,
                               "--steps", "2", "--batch", "2", "--seq", "8",
                               "--ckpt-dir", str(tmp_path)])
    assert int(state.step) == 2
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out and "done at step 2" in out
