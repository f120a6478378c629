"""The port's kernels on the card, against their plain versions.

Every test here needs a CUDA device (marker ``gpu``) and skips without
one.  The file imports neither JAX nor the JAX package, so it also runs
on a GPU host that has only PyTorch and Triton:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_gpu.py

Bitwise everywhere, except the EW lanes at ``EW_RTOL``/``EW_ATOL`` (an
``expf`` ulp carried by the fold).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import compile_script
from repro_torch.core.lowering import windows as TW
from repro_torch.data.synthetic import make_action_tables
from repro_torch.kernels import dispatch
from repro_torch.kernels.feature_hash import ops as fh_ops
from repro_torch.kernels.feature_hash.ref import feature_hash_ref
from repro_torch.kernels.unit_fold import ops as uf_ops
from repro_torch.serve.engine import FeatureEngine

from torch_port_cases import (EW_ATOL, EW_RTOL, SMOKE_SQL, SQLS,
                              require_cuda, unit_block)


def _group(sql, **ctx):
    cs = compile_script(sql, fused_unit_fold=True, **ctx)
    (members,) = TW.group_windows(cs.windows)
    return ([m.node.spec for m in members], TW.group_leaf_set(members),
            [tuple(TW.unique_leaves(m.aggs)) for m in members])


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["family", "edge", "solo", "hll"])
@pytest.mark.parametrize("q1", [False, True], ids=["all-rows", "one-query"])
def test_unit_fold_kernel_matches_plain(which, q1):
    """``hll`` stacks a 256-register sketch with max(price): at rp = 1024
    its sparse table spans several lane tiles, one block each."""
    dev = require_cuda()
    if which == "hll":
        specs, leaves, mk = _group(SQLS["family"], distinct_hll_p=8,
                                   distinct_hll_min_card=8)
        u, r = 5, 600
    else:
        specs, leaves, mk = _group(SQLS[which])
        u, r = 9, 37
    # NULL (NaN) prices: at a unit's last row, mid-unit, and in an invalid
    # slot, which the mask must hide
    env = {k: torch.from_numpy(v).to(dev) for k, v in
           unit_block(u, r, seed=2, n_valid=[r, 0] + [20] * (u - 2),
                      nan_rows=[(0, r - 1), (2, 10), (3, 30)]).items()}
    q = (torch.tensor([[i % r] for i in range(u)], dtype=torch.int32,
                      device=dev) if q1 else None)
    before = dispatch.launch_counts().get("unit_fold", 0)
    got = uf_ops.unit_fold(specs, leaves, env, q, order_by="ts",
                           member_keys=mk, use_kernel=True)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["unit_fold"] == before + 1
    want = uf_ops.unit_fold(specs, leaves, env, q, order_by="ts",
                            member_keys=mk, use_kernel=False)
    for g, w in zip(got, want):
        for k in w:
            tol = ((EW_RTOL, EW_ATOL) if k.startswith("ew:") else (0, 0))
            torch.testing.assert_close(g[k], w[k], rtol=tol[0], atol=tol[1],
                                       equal_nan=True, msg=k)


@pytest.mark.gpu
def test_feature_hash_kernel_matches_plain():
    dev = require_cuda()
    pytest.importorskip("triton")
    rng = np.random.default_rng(1)
    codes = rng.integers(-2**31, 2**31, 1 << 16).astype(np.int32)
    codes[:4] = [0, -1, 2**31 - 1, -2**31]
    codes = torch.from_numpy(codes).to(dev)
    got = fh_ops.feature_hash(codes, 1 << 20, use_kernel=True)
    assert torch.equal(got.cpu(), feature_hash_ref(codes.cpu(), 1 << 20))


@pytest.mark.gpu
def test_engine_on_card_matches_cpu_engine():
    require_cuda()
    tables = make_action_tables(n_actions=3000, n_orders=1500, n_users=10,
                                horizon_ms=600_000, seed=3,
                                with_profile=False)
    actions = tables["actions"]
    engines = [FeatureEngine(SMOKE_SQL, tables, capacity=5000,
                             fused_fold=True, device=d)
               for d in ("cuda", "cpu")]
    for eng in engines:
        eng.bulk_load("orders", tables["orders"])
        eng.ingest_many("actions", [actions.row(i) for i in range(2000)])
    rows = [dict(actions.row(2000 + i)) for i in range(37)]
    dispatch.reset_launch_counts()
    gpu = engines[0].request_batch(rows)
    counts = dispatch.launch_counts()
    assert counts.get("unit_fold", 0) == 2
    assert counts.get("feature_hash", 0) == 1
    cpu = engines[1].request_batch(rows)
    for a, b in zip(gpu, cpu):
        for k in a:
            if k == "ew":
                np.testing.assert_allclose(a[k], b[k], rtol=EW_RTOL,
                                           atol=EW_ATOL)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
