"""The RWKV6 family (attention-free: WKV6 time mix with a data-dependent
decay, relu² channel mix), port against reference, on the CPU in
float32: ``reduced("rwkv6-7b")`` and its two mixes alone.

The JAX package's parameters go through ``params_from_jax``; tokens and
activations are numpy draws from a seed.  Bars: rtol 1e-4 / atol 1e-6
(the bars of ``tests/test_torch_train.py``; ``torch_model_cases`` says
how caches (atol 1e-5: the shifts and the float32 S) and a param after
an AdamW step are held) on prefill logits and states, decode steps, the
training loss and every gradient leaf, one AdamW step; greedy tokens
equal.  Inside the port, a decode step after a prefill over n tokens
against a prefill over the n + 1: rtol/atol 1e-5 (the same recurrence
cut at another step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.models import layers as JL
from repro_torch.configs import reduced
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

import torch_model_cases as cases

ARCH = "rwkv6-7b"


@pytest.fixture(scope="module")
def pair():
    return cases.make_pair(ARCH)


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


# ---------------------------------------------------------------- the mixes


def _mix_params(seed=0):
    jcfg = jax_reduced(ARCH)
    p = jax.tree.map(np.array, JL.init_rwkv(jax.random.PRNGKey(seed), jcfg,
                                            jnp.float32))
    # token-shift lerps and the base decay off their constant defaults,
    # so that each of the five lerps and the decay are exercised
    rng = np.random.default_rng(seed)
    p["mu"] = rng.uniform(0, 1, p["mu"].shape).astype(np.float32)
    p["mu_cm"] = rng.uniform(0, 1, p["mu_cm"].shape).astype(np.float32)
    p["w0"] = rng.uniform(-3, 1, p["w0"].shape).astype(np.float32)
    return jcfg, reduced(ARCH), p, {k: torch.from_numpy(v)
                                    for k, v in p.items()}


@pytest.mark.parametrize("lengths", [(7, 5), (6, 1)], ids=["chunks",
                                                           "decode"])
def test_time_mix_matches_reference_with_carried_state(lengths):
    """Two calls, the second from the first's (shift, S): outputs and
    both states (the second call of one step is a decode step)."""
    jcfg, tcfg, p, tp = _mix_params(1)
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal((3, n, jcfg.d_model)).astype(np.float32)
          for n in lengths]
    jstate = tstate = None
    for i, x in enumerate(xs):
        want, jstate = JL.rwkv_time_mix(p, jnp.asarray(x), jcfg,
                                        state=jstate)
        got, tstate = TL.rwkv_time_mix(tp, torch.from_numpy(x), tcfg,
                                       state=tstate)
        cases.close(got.numpy(), np.asarray(want), f"time mix call {i}")
        for name, g, w in zip(("shift", "S"), tstate, jstate):
            cases.close(g.numpy(), np.asarray(w), f"call {i}: {name}",
                        atol=cases.CACHE_ATOL)
    assert tstate[1].dtype == torch.float32


@pytest.mark.parametrize("lengths", [(7, 5), (6, 1)], ids=["chunks",
                                                           "decode"])
def test_channel_mix_matches_reference_with_carried_shift(lengths):
    jcfg, _, p, tp = _mix_params(3)
    rng = np.random.default_rng(4)
    jshift = tshift = None
    for i, n in enumerate(lengths):
        x = rng.standard_normal((3, n, jcfg.d_model)).astype(np.float32)
        want, jshift = JL.rwkv_channel_mix(p, jnp.asarray(x), shift=jshift)
        got, tshift = TL.rwkv_channel_mix(tp, torch.from_numpy(x),
                                          shift=tshift)
        cases.close(got.numpy(), np.asarray(want), f"channel mix call {i}")
        np.testing.assert_array_equal(tshift.numpy(), np.asarray(jshift))


def test_decode_after_prefill_equals_a_longer_prefill(pair):
    """prefill(n) then a decode step of token n + 1 gives the last logits
    of a prefill over the n + 1 tokens, for n = 9 .. 12."""
    _, tcfg, _, tparams, seed = pair
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, tcfg.vocab_size, (3, 9)).astype(np.int32)
    extra = rng.integers(0, tcfg.vocab_size, (3, 4)).astype(np.int32)
    _, state = TM.forward_prefill(tcfg, tparams,
                                  {"tokens": torch.from_numpy(prompt)})
    for t in range(extra.shape[1]):
        got, state = TM.decode_step(tcfg, tparams, state,
                                    torch.from_numpy(extra[:, t:t + 1]))
        seq = np.concatenate([prompt, extra[:, :t + 1]], axis=1)
        want, _ = TM.forward_prefill(tcfg, tparams,
                                     {"tokens": torch.from_numpy(seq)})
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {t}")


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compressors_group_rwkv_leaves_like_the_reference(pair, scheme):
    """Each of the reference's (L, ...) ``rwkv`` leaves is one tensor for
    int8 / top-k (one scale, one threshold): ``fault.tree_stacks``
    groups the port's per-layer leaves back to it, and the compressors
    are bitwise the reference's."""
    from repro_torch.distributed.fault import tree_stacks

    stacked = [len(i) for i, s in tree_stacks(pair[3]) if s == 1]
    assert stacked == [pair[0].n_layers] * (2 + 13)  # norm1, norm2, 13 rwkv
    cases.check_compressors(pair, scheme, 12)
