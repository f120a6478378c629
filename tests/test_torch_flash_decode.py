"""Decode-attention partials, port against reference on the same numpy
inputs: the port's plain ``decode_partials`` (the version the CUDA kernel
is held against on the card) against the reference's Pallas kernel in
interpret mode (one query head per KV head, live range [0, length)),
against ``sharded_decode._partials_gqa`` (GQA grouping, live range
[lo, hi)), and the partial-merge monoid across shards; and the CUDA
kernel's split-KV schedule (``decode_partials_split_ref``: splits of the
key axis, the identity outside a live range, merged in split order)
against all three.

rtol/atol 1e-4, the reference's own bar (``tests/test_kernels.py``):
the sums are taken in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import ops as jax_ops
from repro.kernels.flash_decode.kernel import decode_partials_pallas
from repro.models.sharded_decode import _partials_gqa
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_decode import (decode_attention,
                                              decode_attention_ref,
                                              decode_partials,
                                              finalize_partials,
                                              merge_partials)
from repro_torch.kernels.flash_decode.ref import (decode_partials_ref,
                                                  decode_partials_split_ref)

RTOL = ATOL = 1e-4


def _qkv(b, hq, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("b,h,s,d", [(1, 2, 128, 32), (2, 4, 700, 64),
                                     (3, 1, 1024, 128)])
def test_plain_matches_pallas(b, h, s, d):
    """g = 1, lo = 0: k/v laid out per (batch, head) row as the
    reference's ops.py lays them out for the Pallas kernel."""
    q, k, v = _qkv(b, h, h, s, d, s)
    lens = np.random.default_rng(s + 1).integers(1, s + 1, b).astype(
        np.int32)
    m, l, o = decode_partials_pallas(
        jnp.asarray(q.reshape(b * h, d)),
        jnp.asarray(np.moveaxis(k, 2, 1).reshape(b * h, s, d)),
        jnp.asarray(np.moveaxis(v, 2, 1).reshape(b * h, s, d)),
        jnp.asarray(np.repeat(lens, h)), interpret=True)
    got = decode_partials(*_t(q, k, v), hi=torch.from_numpy(lens))
    _close(got, (np.asarray(m).reshape(b, h), np.asarray(l).reshape(b, h),
                 np.asarray(o).reshape(b, h, d)))
    mask = np.arange(s)[None, :] < lens[:, None]
    want = jax_ops.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(mask))
    _close([decode_attention(*_t(q, k, v), hi=torch.from_numpy(lens))],
           [want])
    _close([decode_attention_ref(*_t(q, k, v, mask))], [want])


@pytest.mark.parametrize("g", [2, 5])
@pytest.mark.parametrize("s,window", [(64, 0), (300, 40), (1100, 1024)])
def test_gqa_live_range_matches_partials_gqa(g, s, window):
    """Query head h reads KV head h // g; lo > 0 is the sliding window's
    horizon, as the model's decode computes it."""
    b, hkv, d = 3, 2, 32
    q, k, v = _qkv(b, hkv * g, hkv, s, d, s + g)
    hi = np.array([s, s // 2 + 1, 1], np.int32)
    lo = (np.maximum(hi - window, 0) if window else
          np.zeros_like(hi)).astype(np.int32)
    want = _partials_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(lo), jnp.asarray(hi), d ** -0.5)
    got = decode_partials(*_t(q, k, v, lo, hi))
    _close(got, want)
    assert (lo > 0).any() == bool(window and s > window)


def test_merge_over_four_shards_equals_the_whole():
    """Shard partials merged with the monoid equal one partial over the
    whole cache; a shard with no live key (the last, for rows whose live
    range ends early) merges in without effect."""
    b, hq, hkv, s, d = 3, 8, 2, 512, 64
    q, k, v = _qkv(b, hq, hkv, s, d, 7)
    lo = np.array([0, 100, 200], np.int32)
    hi = np.array([s, s - 30, 300], np.int32)
    qt, kt, vt = _t(q, k, v)
    whole = decode_partials(qt, kt, vt, *_t(lo, hi))
    c = s // 4
    acc = None
    for i in range(4):
        part = decode_partials(qt, kt[:, i * c:(i + 1) * c],
                               vt[:, i * c:(i + 1) * c],
                               *_t(np.clip(lo - i * c, 0, c),
                                   np.clip(hi - i * c, 0, c)))
        acc = part if acc is None else merge_partials(acc, part)
    _close([finalize_partials(*acc)], [finalize_partials(*whole).numpy()])
    _close(acc[:2], [w.numpy() for w in whole[:2]])


def test_empty_row_follows_the_tpu_kernel():
    """No live key: m = -1e30, l = S and o = the sum of the S value rows,
    as ``decode_partials_pallas`` returns them (``_partials_gqa`` would
    give l = 0); a live row beside it is unaffected."""
    b, h, s, d = 2, 2, 256, 16
    q, k, v = _qkv(b, h, h, s, d, 3)
    lens = np.array([0, 40], np.int32)
    m, l, o = decode_partials_pallas(
        jnp.asarray(q.reshape(b * h, d)),
        jnp.asarray(np.moveaxis(k, 2, 1).reshape(b * h, s, d)),
        jnp.asarray(np.moveaxis(v, 2, 1).reshape(b * h, s, d)),
        jnp.asarray(np.repeat(lens, h)), interpret=True)
    got = decode_partials(*_t(q, k, v), hi=torch.from_numpy(lens))
    _close(got, (np.asarray(m).reshape(b, h), np.asarray(l).reshape(b, h),
                 np.asarray(o).reshape(b, h, d)))
    assert bool((got[0][0] == -1e30).all())
    assert bool((got[1][0] == s).all())
    np.testing.assert_allclose(got[2][0].numpy(), v[0].sum(0), rtol=RTOL,
                               atol=ATOL)
    # lo >= hi is empty too
    again = decode_partials(*_t(q, k, v), lo=torch.tensor([9, 0]),
                            hi=torch.tensor([9, 40]))
    for x, y in zip(again, got):
        assert torch.equal(x, y)


def test_bf16_cache_reads_as_float32():
    """A bf16 cache gives what its float32 cast gives (the kernel
    converts in registers)."""
    q, k, v = _t(*_qkv(2, 10, 2, 96, 64, 11))
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    hi = torch.tensor([96, 50], dtype=torch.int32)
    for x, y in zip(decode_partials(q, kb, vb, hi=hi),
                    decode_partials(q, kb.float(), vb.float(), hi=hi)):
        assert torch.equal(x, y)


def test_kernel_on_a_cpu_tensor_raises():
    q, k, v = _t(*_qkv(1, 2, 2, 8, 4, 0))
    with pytest.raises(dispatch.KernelUnsupportedError):
        decode_partials(q, k, v, use_kernel=True)


SPLIT = 128         # keys per split of the CUDA kernel (csrc SPLIT)
S_SPLIT = 512
# (lo, hi): on split boundaries, inside splits, across several, hi = S,
# one key, and no live key (lo >= hi)
RANGES = [(0, 128), (128, 384), (5, 140), (130, 260), (0, S_SPLIT),
          (400, S_SPLIT), (100, 101), (30, 30), (90, 12)]


def _split_case(seed, hq=10, hkv=2, d=32):
    b = len(RANGES)
    q, k, v = _qkv(b, hq, hkv, S_SPLIT, d, seed)
    lo = np.array([r[0] for r in RANGES], np.int32)
    hi = np.array([r[1] for r in RANGES], np.int32)
    return q, k, v, lo, hi


@pytest.mark.parametrize("split", [SPLIT, 64, 7])
def test_split_schedule_matches_partials_gqa(split):
    """Live rows against ``_partials_gqa``; every row (the empty ones
    included: l = S exactly) against the one-pass plain version."""
    q, k, v, lo, hi = _split_case(split)
    got = decode_partials_split_ref(*_t(q, k, v, lo, hi), split)
    whole = decode_partials_ref(*_t(q, k, v, lo, hi))
    _close(got, [w.numpy() for w in whole])
    live = lo < hi
    want = _partials_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(lo), jnp.asarray(hi), 32 ** -0.5)
    _close([x[live] for x in got], [np.asarray(w)[live] for w in want])
    assert bool((got[1][~torch.from_numpy(live)] == S_SPLIT).all())
    assert bool((got[0][~torch.from_numpy(live)] == -1e30).all())
    np.testing.assert_allclose(got[2][7].numpy(),
                               np.repeat(v[7].sum(0), 5, axis=0),
                               rtol=RTOL, atol=ATOL)


def test_split_schedule_matches_pallas():
    """g = 1 and live ranges [0, length) as the Pallas kernel takes them:
    lengths on and inside split boundaries, the whole cache, one key and
    none."""
    b, h, d = 6, 2, 32
    q, k, v = _qkv(b, h, h, S_SPLIT, d, 21)
    lens = np.array([128, 256, 77, S_SPLIT, 1, 0], np.int32)
    m, l, o = decode_partials_pallas(
        jnp.asarray(q.reshape(b * h, d)),
        jnp.asarray(np.moveaxis(k, 2, 1).reshape(b * h, S_SPLIT, d)),
        jnp.asarray(np.moveaxis(v, 2, 1).reshape(b * h, S_SPLIT, d)),
        jnp.asarray(np.repeat(lens, h)), interpret=True)
    got = decode_partials_split_ref(*_t(q, k, v, np.zeros_like(lens), lens),
                                    SPLIT)
    _close(got, (np.asarray(m).reshape(b, h), np.asarray(l).reshape(b, h),
                 np.asarray(o).reshape(b, h, d)))


def test_split_schedule_nan_in_a_live_key_propagates():
    """A NaN in a live key turns its KV head's g query heads NaN (m, l
    and o), as in both references; the other KV head is untouched."""
    q, k, v, lo, hi = _split_case(3)
    k[2, 40, 1, 5] = np.nan            # row 2 lives in [5, 140): KV head 1
    got = decode_partials_split_ref(*_t(q, k, v, lo, hi), SPLIT)
    want = _partials_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(lo), jnp.asarray(hi), 32 ** -0.5)
    for x, w in zip(got, want):
        np.testing.assert_array_equal(np.isnan(x.numpy()),
                                      np.isnan(np.asarray(w)))
    assert bool(got[0][2, 5:].isnan().all() and got[2][2, 5:].isnan().all())
    assert not bool(got[0][2, :5].isnan().any())
    _close(got, [w.numpy() for w in decode_partials_ref(
        *_t(q, k, v, lo, hi))])


def test_split_schedule_dead_keys_do_not_reach_the_result():
    """NaN and Inf in the keys and values past ``hi`` (and before ``lo``)
    of live rows: the result is finite and equals both references on the
    clean cache (the keys are masked; the dead values are not read)."""
    q, k, v, lo, hi = _split_case(4)
    clean_k, clean_v = k.copy(), v.copy()
    for r, (a, z) in enumerate(RANGES):
        if a < z:
            k[r, z:, :, ::2], k[r, z:, :, 1::2] = np.nan, np.inf
            v[r, z:, :, ::2], v[r, z:, :, 1::2] = -np.inf, np.nan
            k[r, :a], v[r, :a] = np.nan, np.inf
    live = lo < hi
    got = decode_partials_split_ref(*_t(q, k, v, lo, hi), SPLIT)
    assert all(bool(torch.isfinite(x[torch.from_numpy(live)]).all())
               for x in got)
    want = decode_partials_split_ref(*_t(q, clean_k, clean_v, lo, hi),
                                     SPLIT)
    for x, w in zip(got, want):
        assert torch.equal(x[torch.from_numpy(live)],
                           w[torch.from_numpy(live)])
    _close([x[live] for x in decode_partials(*_t(q, k, v, lo, hi))],
           [w[live].numpy() for w in want])
    ref = _partials_gqa(jnp.asarray(q), jnp.asarray(clean_k),
                        jnp.asarray(clean_v), jnp.asarray(lo),
                        jnp.asarray(hi), 32 ** -0.5)
    _close([x[live] for x in got], [np.asarray(w)[live] for w in ref])
