"""Fused unit fold, port against reference, on the same numpy inputs.

The JAX side runs as its own kernel tests run it on the CPU: the Pallas
kernel in interpret mode (``use_pallas=True, interpret=True``) and the
XLA reference (``use_pallas=False``).  The port runs its plain version
on CPU tensors.  Every fold is bitwise equal, except the EW lanes, held
at ``EW_RTOL``/``EW_ATOL``: XLA and torch may give ``exp``/``log`` bits
an ulp apart, and the EW fold carries that through its decay products.
The CUDA kernel itself is held to the plain version on the card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import compile_script as jax_compile
from repro.core.lowering import windows as JW
from repro.kernels.unit_fold import ops as jax_uf
from repro_torch.core import compile_script as torch_compile
from repro_torch.core.functions import floor_log2
from repro_torch.core.lowering import windows as TW
from repro_torch.kernels import dispatch
from repro_torch.kernels.unit_fold import ops as torch_uf
from repro_torch.kernels.unit_fold import ref as torch_ref

from torch_port_cases import (EDGE_SQL, EW_ATOL, EW_RTOL, FAMILY_SQL, HLL,
                              SOLO_SQL, SQLS, unit_block as _block)

def _group(compile_fn, sql, **ctx):
    cs = compile_fn(sql, **ctx)
    (members,) = (JW if compile_fn is jax_compile else TW).group_windows(
        cs.windows)
    specs = [m.node.spec for m in members]
    leaves, member_keys = {}, []
    uniq = (JW if compile_fn is jax_compile else TW).unique_leaves
    for m in members:
        member_keys.append(tuple(uniq(m.aggs)))
        for k, leaf in uniq(m.aggs).items():
            leaves.setdefault(k, leaf)
    return members, specs, leaves, member_keys


def _fold_both(sql, env_np, queries=None, use_pallas=True, ctx=None):
    ctx = ctx or {}
    _, specs_j, leaves_j, mk_j = _group(jax_compile, sql, **ctx)
    members, specs_t, leaves_t, mk_t = _group(
        torch_compile, sql, fused_unit_fold=True, **ctx)
    env_j = {k: jnp.asarray(v) for k, v in env_np.items()}
    env_t = {k: torch.from_numpy(v.copy()) for k, v in env_np.items()}
    qj = None if queries is None else jnp.asarray(queries)
    qt = None if queries is None else torch.from_numpy(queries.copy())
    # jitted, as every production driver runs it (one compile instead of
    # one eager dispatch per primitive)
    want = jax.jit(lambda e, q: jax_uf.unit_fold(
        specs_j, leaves_j, e, q, order_by="ts", member_keys=mk_j,
        use_pallas=use_pallas, interpret=True))(env_j, qj)
    got = torch_uf.unit_fold(specs_t, leaves_t, env_t, qt, order_by="ts",
                             member_keys=mk_t)
    return members, want, got


def _assert_parity(members, want, got):
    n = 0
    for mi, m in enumerate(members):
        for k in TW.unique_leaves(m.aggs):
            a = np.asarray(want[mi][k])
            b = got[mi][k].numpy()
            assert a.shape == b.shape, k
            if k.startswith("ew:"):
                np.testing.assert_allclose(b, a, rtol=EW_RTOL, atol=EW_ATOL,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(b, a, err_msg=k)
            n += 1
    assert n > 0


@pytest.mark.parametrize("use_pallas,ctx", [
    (True, {}), (False, {}), (True, HLL)],
    ids=["pallas-interpret", "xla-ref", "hll-pallas-interpret"])
def test_every_family_bitwise(use_pallas, ctx):
    env = _block(3, 21, seed=0, n_valid=[21, 17, 9])
    _assert_parity(*_fold_both(FAMILY_SQL, env, use_pallas=use_pallas,
                               ctx=ctx))


@pytest.mark.parametrize("u", [1, 7, 8, 9])
def test_unit_counts(u):
    env = _block(u, 13, seed=u, n_valid=[13 - (i % 3) for i in range(u)])
    _assert_parity(*_fold_both(EDGE_SQL, env))


def test_single_member_group():
    _assert_parity(*_fold_both(SOLO_SQL, _block(3, 9, seed=5)))


@pytest.mark.parametrize("which", ["edge", "family"])
def test_single_query(which):
    u, r = 9, 11
    env = _block(u, r, seed=11, n_valid=[r - (i % 4) for i in range(u)])
    q = np.asarray([[3 + (i % 5)] for i in range(u)], np.int32)
    _assert_parity(*_fold_both(SQLS[which], env, queries=q))


def test_empty_unit():
    env = _block(8, 8, seed=3, n_valid=[0 if i == 2 else 8
                                        for i in range(8)])
    _assert_parity(*_fold_both(EDGE_SQL, env))


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["pallas-interpret", "xla-ref"])
def test_null_rows_propagate(use_pallas):
    """NaN is the system's NULL: a NULL price in a valid row reaches the
    folds over it in both packages alike (min/max/drawdown propagate it);
    one in an invalid slot (unit 2) is masked and reaches nothing."""
    env = _block(3, 21, seed=4, n_valid=[21, 17, 9],
                 nan_rows=[(0, 20), (1, 6), (2, 15)])
    members, want, got = _fold_both(FAMILY_SQL, env, use_pallas=use_pallas)
    _assert_parity(members, want, got)
    nan_keys = {k for mi, m in enumerate(members)
                for k in TW.unique_leaves(m.aggs)
                if torch.isnan(got[mi][k][:2]).any()}
    assert {k.split(":")[0] for k in nan_keys} >= {"min", "max", "dd"}, \
        nan_keys
    assert not any(torch.isnan(got[mi][k][2]).any()
                   for mi, m in enumerate(members)
                   for k in TW.unique_leaves(m.aggs))


@pytest.mark.parametrize("span", [1, 2, 3, 7, 8, 1023, 1024, 2**31 - 1])
def test_floor_log2_is_31_minus_clz(span):
    got = int(floor_log2(torch.tensor([span], dtype=torch.int32))[0])
    assert got == 31 - (32 - span.bit_length())


def test_plan_groups_and_families():
    _, specs, leaves, mk = _group(torch_compile, FAMILY_SQL,
                                  fused_unit_fold=True, **HLL)
    plan = torch_ref.build_plan(specs, leaves, "ts", member_keys=mk)
    fams = [(g.kind, g.family) for g in plan.groups]
    assert fams == [("scan", "add"), ("sparse", "min"), ("sparse", "max"),
                    ("tree", "drawdown"), ("scan", "ew")]


def test_forcing_kernel_on_cpu_raises():
    _, specs, leaves, _ = _group(torch_compile, EDGE_SQL,
                                 fused_unit_fold=True)
    env = {k: torch.from_numpy(v) for k, v in _block(2, 8, 1).items()}
    with pytest.raises(dispatch.KernelUnsupportedError):
        torch_uf.unit_fold(specs, leaves, env, order_by="ts",
                           use_kernel=True)


def test_kernel_lane_tiles_fit_shared_memory():
    """The kernel's host-side launch plan: a wide stacked group (HLL, 256
    lanes) is tiled across blocks so each block's structure fits shared
    memory; 3-lane drawdown/EW groups stay whole; the header's tile
    offsets are the prefix sums of the groups' tile counts."""
    from repro_torch.kernels.unit_fold import kernel as K

    _, specs, leaves, mk = _group(torch_compile, FAMILY_SQL,
                                  fused_unit_fold=True, distinct_hll_p=8,
                                  distinct_hll_min_card=8)
    plan = torch_ref.build_plan(specs, leaves, "ts", member_keys=mk)
    rp, nq = 1024, 1
    tiles = K.lane_tiles(plan, rp, nq)
    widths = {g.family: (g.width, t) for g, t in zip(plan.groups, tiles)}
    assert widths["max"][0] == 257 and widths["max"][1] < 257
    assert widths["drawdown"] == (3, 3) and widths["ew"] == (3, 3)
    for g, t in zip(plan.groups, tiles):
        assert K.smem_bytes(g.kind, rp, len(g.members_ix), nq, t) \
            <= K.SMEM_LIMIT
    hdr, words, n_tasks = K._header(plan, rp, nq, r_real=600)
    assert n_tasks == sum(-(-g.width // t)
                          for g, t in zip(plan.groups, tiles))
    assert words == 0 and 0 < hdr[7] <= K.SMEM_LIMIT
    rows = np.asarray(torch_ref.member_rows(plan.specs, 600))
    np.testing.assert_array_equal(
        hdr[K._HDR:K._HDR + 4 * len(plan.specs)].reshape(-1, 4), rows)
    # ROWS members clip to the real row count, RANGE members to 2^30
    assert (rows[rows[:, 0] == 1, 1] <= 600).all()
