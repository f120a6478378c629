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


def _plan(sql, **ctx):
    _, specs, leaves, mk = _group(torch_compile, sql, fused_unit_fold=True,
                                  **ctx)
    return torch_ref.build_plan(specs, leaves, "ts", member_keys=mk)


def test_kernel_lane_tiles_fit_shared_memory():
    """The kernel's host-side launch plan at many queries per unit: a
    wide stacked group (HLL, 257 lanes) is tiled across blocks so each
    block's structure fits half an SM's shared memory; 3-lane
    drawdown/EW groups stay whole; the header's tile
    offsets are the prefix sums of the groups' tile counts; ROWS members
    clip to the real row count, RANGE members to 2^30."""
    from repro_torch.kernels.unit_fold import kernel as K

    plan = _plan(FAMILY_SQL, distinct_hll_p=8, distinct_hll_min_card=8)
    rp = 1024
    tiles = K.lane_tiles(plan, rp)
    widths = {g.family: (g.width, t) for g, t in zip(plan.groups, tiles)}
    assert widths["max"][0] == 257 and widths["max"][1] < 257
    assert widths["drawdown"] == (3, 3) and widths["ew"] == (3, 3)
    for g, t in zip(plan.groups, tiles):
        assert K.many_smem_bytes(g.kind, rp, t) \
            <= K.SMEM_LIMIT // 2
    hdr, mode, words, n_tasks = K._header(plan, rp, rp)
    assert mode == "shared" and words == 0
    assert n_tasks == sum(-(-g.width // t)
                          for g, t in zip(plan.groups, tiles))
    assert 0 < hdr[9] <= K.SMEM_LIMIT
    r = 600
    hdr, _, _, _ = K._header(plan, r, r)
    rows = np.asarray(torch_ref.member_rows(plan.specs, r))
    np.testing.assert_array_equal(
        hdr[K._HDR:K._HDR + 4 * len(plan.specs)].reshape(-1, 4), rows)
    assert (rows[rows[:, 0] == 1, 1] <= r).all()
    assert (rows[rows[:, 0] == 0, 1] <= 2**30).all()


@pytest.mark.parametrize("r,rp", [(1, 2), (2, 2), (3, 4), (257, 512),
                                  (513, 1024), (1024, 1024)])
def test_padded_rows_is_the_plain_layouts_rp(r, rp):
    from repro_torch.kernels.unit_fold import kernel as K

    assert K.padded_rows(r) == rp
    ts = torch.zeros((1, r), dtype=torch.int32)
    assert torch_uf.pad_rows([torch.zeros(1)], [torch.zeros((1, r, 1))],
                             ts)[1].shape[1] == rp


def test_few_layout_offsets():
    """The few variant's shared memory: the order column, the bounds and
    two ints come first (a multiple of 4 words), then per group its
    staged rows, and but for min/max its upper levels and ten kept nodes
    per frame, each region after the last."""
    from repro_torch.kernels.unit_fold import kernel as K

    plan = _plan(FAMILY_SQL)
    r, q = 37, 2
    base, offs, nbytes = K.few_layout(plan, r, q)
    assert base % 4 == 0 and base >= r + 2 * len(plan.specs) * q + 2
    n_up = 2 * (K.padded_rows(r) >> 5) - 1
    end = 0
    for g, (stage, up, stash) in zip(plan.groups, offs):
        nodes = g.family not in ("min", "max")
        assert stage == end and up == stage + r * g.width
        assert stash == up + n_up * g.width * nodes
        end = stash + len(g.members_ix) * q * 10 * g.width * nodes
    assert nbytes == 4 * (base + end)
    assert K.few_layout(plan, r, K.FEW_QUERIES + 1) is None
    assert K.few_layout(plan, 1 << 15, 1) is None       # past the limit


@pytest.mark.parametrize("r,q,want", [
    (513, 1, "few"), (257, 4, "few"), (2048, 2048, "shared"),
    (4096, 4096, "shared"), (8192, 8192, "wide"), (32768, 32768, "wide")])
def test_variant_choice(r, q, want):
    """The serving window of the smoke script (one query per unit) takes
    the few variant; offline units (Q = rp) shared memory while the
    min/max sparse table fits (rp up to 4,096), then the wide variant."""
    from repro_torch.kernels.unit_fold import kernel as K

    sql = ("SELECT sum(price) OVER w AS s, min(price) OVER w AS mn, "
           "max(price) OVER w AS mx FROM actions WINDOW w AS (PARTITION "
           "BY uid ORDER BY ts ROWS_RANGE BETWEEN 60s PRECEDING AND "
           "CURRENT ROW)")
    assert K.variant(_plan(sql), r, q) == want


def test_wide_stacks_take_the_many_variant_at_one_query():
    """A group too wide for the few variant's staged rows (the family
    script's 98 ADD lanes at 600 rows) folds one query per unit in the
    many-query variant."""
    from repro_torch.kernels.unit_fold import kernel as K

    plan = _plan(FAMILY_SQL)
    assert K.few_layout(plan, 600, 1) is None
    assert K.variant(plan, 600, 1) == "shared"


@pytest.mark.parametrize("kind,rp,words", [
    ("tree", 1024, 2047), ("scan", 1024, 2048 + 32 + 1),
    ("scan", 16, 32 + 0 + 1), ("sparse", 1024, 11 * 1024)])
def test_structure_words(kind, rp, words):
    from repro_torch.kernels.unit_fold import kernel as K

    assert K.structure_words(kind, rp) == words
    assert K.many_smem_bytes(kind, rp, 3) == 4 * (4 + 3 * words)


def test_header_kinds_and_launch_threads():
    """Every group builds its plan kind's structure (min/max the plain
    version's sparse table) and the header says so."""
    from repro_torch.kernels.unit_fold import kernel as K

    plan = _plan(FAMILY_SQL)
    kinds = {g.family: g.kind for g in plan.groups}
    assert kinds == {"add": "scan", "min": "sparse", "max": "sparse",
                     "drawdown": "tree", "ew": "scan"}
    for q in (1, 1024):
        hdr, _, _, _ = K._header(plan, 1024, q)
        gh = hdr[K._HDR + 4 * len(plan.specs):].reshape(
            len(plan.groups), K._GROUP_INTS)
        assert [int(k) for k in gh[:, 1]] == [
            torch_ref.KINDS[g.kind] for g in plan.groups]
    assert (K.launch_threads("few"), K.launch_threads("shared"),
            K.launch_threads("wide")) == (512, 1024, 1024)


def test_header_of_the_few_variant():
    """Mode 0, the groups' region offset and shared-memory bytes from
    ``few_layout``, each group's three offsets in its descriptor."""
    from repro_torch.kernels.unit_fold import kernel as K

    plan = _plan(FAMILY_SQL)
    hdr, mode, words, n_tasks = K._header(plan, 37, 1)
    base, offs, nbytes = K.few_layout(plan, 37, 1)
    assert mode == "few" and words == 0 and n_tasks == len(plan.groups)
    assert (hdr[7], hdr[9], hdr[13]) == (0, nbytes, base)
    gh = hdr[K._HDR + 4 * len(plan.specs):].reshape(len(plan.groups), -1)
    np.testing.assert_array_equal(gh[:, 7:10], np.asarray(offs))
    assert K._header(plan, 37, 1) is K._header(plan, 37, 1)   # cached


def _lanes(sql, family, u, r, seed):
    """A group's lifted (U, rp, F) lanes (identity-padded) and its plan
    group, for the kernel-arithmetic tests below."""
    plan = _plan(sql)
    grp = next(g for g in plan.groups if g.family == family)
    env = {k: torch.from_numpy(v) for k, v in _block(
        u, r, seed=seed, nan_rows=[(0, r // 3)]).items()}
    ident = torch_ref.group_identity(grp)
    data, _ = torch_uf.pad_rows([ident], [torch_ref.lift_group(
        grp, env, (u, r))], env["ts"].to(torch.int32))
    return grp, data[0], ident


@pytest.mark.parametrize("family", ["add", "ew"])
def test_prefix_recurrence_is_the_msb_first_fold(family):
    """The many-query variant's prefixes: P[x] = P[x - lowbit(x)] (+) the
    node of x's lowest set bit, with the chunk starts P[32c] folded from
    their level >= 5 nodes, gives every scan prefix of the plain version
    (``_prefix_at``, the reference's bracketing) bit for bit."""
    grp, data, _ = _lanes(FAMILY_SQL, family, 2, 100, seed=8)
    rp = data.shape[1]
    lvl = torch_ref._pack_levels(grp.proxy, data)
    offs = torch_ref._level_offsets(rp)
    xs = torch.arange(1, rp + 1, dtype=torch.int32).expand(2, 1, rp)
    want = torch_ref._prefix_at(grp.proxy, lvl, offs, xs, rp)[:, 0]
    pre = {}
    for x in range(1, rp + 1):
        low = x & -x
        k = low.bit_length() - 1
        node = lvl[:, offs[k] + (x >> k) - 1]
        if x % 32 == 0 or x == low:
            # a chunk start (or a lone node): the MSB-first fold itself
            pre[x] = torch_ref._prefix_at(
                grp.proxy, lvl, offs, torch.full((2, 1, 1), x,
                                                 dtype=torch.int32),
                rp)[:, 0, 0]
        else:
            pre[x] = grp.proxy.combine(pre[x - low], node)
    got = torch.stack([pre[x] for x in range(1, rp + 1)], 1)
    nan = got.isnan()
    assert torch.equal(nan, want.isnan())
    assert torch.equal(got[~nan], want[~nan])


@pytest.mark.parametrize("family", ["min", "max"])
def test_min_max_reduction_equals_the_sparse_table(family):
    """The few variant folds min/max as a plain reduction of [s, e) (any
    order): the plain version's sparse-table lookups give the same
    values, NULL (NaN) included."""
    grp, data, ident = _lanes(FAMILY_SQL, family, 2, 70, seed=9)
    rp = data.shape[1]
    rng = np.random.default_rng(3)
    e = rng.integers(1, 71, (2, 1, 9)).astype(np.int32)
    s = np.minimum(e, rng.integers(0, 71, (2, 1, 9))).astype(np.int32)
    starts, ends = torch.from_numpy(s), torch.from_numpy(e)
    want = torch_ref._sparse_group(grp, data, ident, starts, ends, rp)
    red = torch.amin if family == "min" else torch.amax
    for ui in range(2):
        for qi in range(9):
            a, b = int(s[ui, 0, qi]), int(e[ui, 0, qi])
            got = ident if a >= b else red(data[ui, a:b], dim=0)
            assert torch.equal(got.isnan(), want[ui, 0, qi].isnan())
            nan = got.isnan()
            assert torch.equal(got[~nan], want[ui, 0, qi][~nan])


@pytest.mark.parametrize("which", ["family", "edge"])
def test_prelift_once_equals_per_unit_lift(which):
    """The reference lifts narrow groups per unit and wide ones once over
    the flat rows (its ``PRELIFT_MIN_WIDTH``, an XLA layout choice); the
    port lifts every group once (``prelift_blocks``) and gathers the
    lanes.  Lifts are row-local, so both give the same bits."""
    _, specs, leaves, mk = _group(torch_compile, SQLS[which],
                                  fused_unit_fold=True)
    env = _block(3, 11, seed=4, n_valid=[11, 6, 1])
    env_t = {k: torch.from_numpy(v.copy()) for k, v in env.items()}
    flat = {k: v.reshape(-1) for k, v in env_t.items()}
    idx = torch.arange(3 * 11).reshape(3, 11)
    got = torch_uf.unit_fold_blocks(specs, leaves, flat, idx, order_by="ts",
                                    member_keys=mk)
    want = torch_uf.unit_fold(specs, leaves, env_t, order_by="ts",
                              member_keys=mk)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert torch.equal(g[k].isnan(), w[k].isnan()), k
            assert torch.equal(g[k].nan_to_num(), w[k].nan_to_num()), k


@pytest.mark.parametrize("which", ["family", "edge", "solo"])
def test_per_unit_names_match_reference(which):
    """The reference's per-unit names — ``unit_bounds_each`` /
    ``unit_bounds_all`` (bounds bitwise), ``unit_fold_ref`` and
    ``unit_fold_ref_data`` (every leaf of every member, through
    ``unstack_group``) — on one unit at a time of a padded block, every
    row queried and one row queried."""
    from repro.kernels.unit_fold import ref as JR

    sql = SQLS[which]
    r = 21 if which == "family" else 13
    env = _block(3, r, seed=2, n_valid=[r, r - 4, 5])
    _, specs_j, leaves_j, mk_j = _group(jax_compile, sql)
    members, specs_t, leaves_t, mk_t = _group(torch_compile, sql,
                                              fused_unit_fold=True)
    plan_j = JR.build_plan(specs_j, leaves_j, "ts", member_keys=mk_j)
    plan_t = torch_ref.build_plan(specs_t, leaves_t, "ts", member_keys=mk_t)
    n = 0
    for u in range(3):
        env_j = {k: jnp.asarray(v[u]) for k, v in env.items()}
        env_t = {k: torch.from_numpy(v[u].copy()) for k, v in env.items()}
        for q in (np.arange(r, dtype=np.int32), np.asarray([3], np.int32)):
            qj, qt = jnp.asarray(q), torch.from_numpy(q)
            (sj, ej), (st, et) = (
                JR.unit_bounds_all(specs_j, env_j["ts"], qj, r),
                torch_ref.unit_bounds_all(specs_t, env_t["ts"], qt, r))
            np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
            np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
            each = torch_ref.unit_bounds_each(specs_t, env_t["ts"], qt, r)
            assert [t.shape for t in each[0]] == [q.shape] * len(specs_t)
            want = JR.unit_fold_ref(plan_j, env_j, qj)
            got = torch_ref.unit_fold_ref(plan_t, env_t, qt)
            data = [torch_ref.lift_group(g, env_t, (r,))
                    for g in plan_t.groups]
            got_data = torch_ref.unit_fold_ref_data(plan_t, data,
                                                    env_t["ts"], qt)
            for mi in range(len(members)):
                for k, a in want[mi].items():
                    a = np.asarray(a)
                    for b in (got[mi][k].numpy(), got_data[mi][k].numpy()):
                        assert a.shape == b.shape, k
                        if k.startswith("ew:"):
                            np.testing.assert_allclose(
                                b, a, rtol=EW_RTOL, atol=EW_ATOL, err_msg=k)
                        else:
                            np.testing.assert_array_equal(b, a, err_msg=k)
                        n += 1
    assert n > 0
