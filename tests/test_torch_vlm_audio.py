"""The VLM and audio families, port against reference, on the CPU in
float32: ``reduced("llava-next-34b")`` (a dense GQA decoder behind a
prefix of 8 patch embeddings) and ``reduced("whisper-tiny")`` (a
bidirectional encoder over 16 frame embeddings, a decoder with
cross-attention, layer norms and a tanh-GELU MLP) and their primitives
(their config modules: ``test_torch_mla.py``).

The JAX package's parameters go through ``params_from_jax``; tokens,
patches and frames are numpy draws from a seed.  Bars: rtol 1e-4 / atol
1e-6 (the bars of ``tests/test_torch_train.py``; ``torch_model_cases``
says how caches (atol 1e-5) and a param after an AdamW step are held) on
prefill logits and caches (``enc_out`` included), decode steps, the
training loss and every gradient leaf, one AdamW step (also in two
microbatches, which cut ``patches`` / ``frames`` with the tokens); greedy
tokens equal.  The erf form of GELU must miss the bar the tanh form
meets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

import torch_model_cases as cases

ARCHS = ["llava-next-34b", "whisper-tiny"]


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


@pytest.mark.parametrize("n_micro", [1, 2])
def test_adamw_step_matches_reference(pair, n_micro):
    """Two microbatches cut every batch input by rows, ``patches`` /
    ``frames`` with the tokens, as the reference's reshape does."""
    cases.check_adamw_step(pair, n_micro=n_micro)


# ------------------------------------------------------------ primitives


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    """f32 mean and variance, ``rsqrt``, ``y * scale + bias`` in f32,
    cast back: rtol 1e-4 / atol 1e-6 in f32; in bf16 within one bf16 ulp
    (rtol 2^-7: the f32 values differ in their last bits, and one in 720
    rounds to the neighbouring bf16)."""
    x, scale, bias = _x((3, 5, 48), 0, 3.0) + 1.5, _x((48,), 1), _x((48,), 2)
    want = JL.layer_norm(jnp.asarray(x, dtype), jnp.asarray(scale, dtype),
                         jnp.asarray(bias, dtype))
    got = TL.layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                        torch.from_numpy(scale).to(getattr(torch, dtype)),
                        torch.from_numpy(bias).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    rtol, atol = ((2 ** -7, 0) if dtype == "bfloat16"
                  else (cases.RTOL, cases.ATOL))
    cases.close(got.float().numpy(), np.asarray(want, np.float32),
                "layer_norm", rtol=rtol, atol=atol)


def test_gelu_mlp_is_the_tanh_form():
    """``jax.nn.gelu`` is the tanh approximation: the port matches it at
    the bar, and the same MLP with the erf form (``F.gelu``'s default)
    misses that bar on these inputs."""
    d, f = 32, 64
    x, w_up, b_up = _x((2, 7, d), 3), _x((d, f), 4, 0.4), _x((f,), 5)
    w_down, b_down = _x((f, d), 6, f ** -0.5), _x((d,), 7)
    args = (x, w_up, b_up, w_down, b_down)
    want = np.asarray(JL.gelu_mlp(*map(jnp.asarray, args)))
    targs = [torch.from_numpy(a) for a in args]
    cases.close(TL.gelu_mlp(*targs).numpy(), want, "gelu_mlp")
    erf = F.gelu(targs[0] @ targs[1] + targs[2]) @ targs[3] + targs[4]
    assert not np.allclose(erf.numpy(), want, rtol=cases.RTOL,
                           atol=cases.ATOL)


@pytest.mark.parametrize("sk,chunk", [(12, 8), (16, 1024)])
def test_noncausal_chunked_attention_matches_reference(sk, chunk):
    """The encoder's and the cross-attention's attention: no mask, and
    (at 12 keys in chunks of 8) the last chunk padded with zero keys that
    nothing masks, in both packages."""
    q, k, v = _x((2, 5, 4, 16), 8), _x((2, sk, 2, 16), 9), _x((2, sk, 2, 16),
                                                                10)
    want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=False, chunk=chunk)
    got = TL.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=False,
                               chunk=chunk)
    cases.close(got.numpy(), np.asarray(want), "non-causal attention")


def test_encoder_and_cross_attention_match_reference():
    """``_run_encoder`` (the layers non-causal over frames, then the
    ``enc_norm`` layer norm) and one decoder layer's ``_cross_gqa`` over
    its output (no rope), alone."""
    jcfg, tcfg, jparams, tparams, seed = cases.make_pair("whisper-tiny")
    frames = _x((2, jcfg.encdec.n_frames, jcfg.d_model), seed)
    want = JM._run_encoder(jcfg, jparams, jnp.asarray(frames))
    got = TM._run_encoder(tcfg, tparams, torch.from_numpy(frames))
    cases.close(got.numpy(), np.asarray(want), "encoder output")
    h = _x((2, 3, jcfg.d_model), seed + 1)
    xattn = jax.tree.map(lambda a: a[1], jparams["layers"]["xattn"])
    want_x, _ = JM._cross_gqa(jcfg, xattn, jnp.asarray(h), want)
    got_x = TM._cross_gqa(tcfg, tparams["layers"][1]["xattn"],
                          torch.from_numpy(h), got)
    cases.close(got_x.numpy(), np.asarray(want_x), "cross-attention")


def test_vlm_embeds_patches_before_tokens():
    """``_embed_inputs``: the patches, cast to the embedding's dtype,
    then the tokens' embeddings; the label mask False over the
    patches."""
    jcfg, tcfg, jparams, tparams, seed = cases.make_pair("llava-next-34b")
    batch = cases.model_batch(jcfg, np.random.default_rng(seed), 2, 5)
    want_x, want_m = JM._embed_inputs(jcfg, jparams, cases.as_jax(batch))
    got_x, got_m = TM._embed_inputs(tcfg, tparams, cases.as_torch(batch))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert not got_m[:, :jcfg.vlm.n_patches].any()


# ------------------------------------------------------------------ trees


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compressors_group_encoder_leaves_like_the_reference(scheme):
    """The reference stacks ``layers`` and ``enc_layers`` on separate L
    axes: ``fault.tree_stacks`` groups the port's per-layer leaves of
    each list back to them, and int8 / top-k over whisper-tiny's
    gradient tree are bitwise the reference's."""
    from repro_torch.distributed.fault import tree_flatten, tree_stacks

    pair = cases.make_pair("whisper-tiny")
    jcfg, _, _, tparams, _ = pair
    n_leaves = len(tree_flatten(tparams["layers"][0])[0])
    assert [len(i) for i, s in tree_stacks(tparams) if s == 1] == \
        [jcfg.encdec.n_enc_layers] * n_leaves + [jcfg.n_layers] * n_leaves
    cases.check_compressors(pair, scheme, 11)
