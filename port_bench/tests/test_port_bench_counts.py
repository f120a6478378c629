"""The benchmark's FLOP and byte counts against hand arithmetic."""

import pytest

from port_bench import cell as cells
from port_bench.counts import flops


def _cfg(name):
    return cells.read_json(cells.BENCH_DIR / "configs" / f"{name}.json")


def test_keys_seen_causal_and_windowed():
    assert flops.keys_seen(4, 0) == 1 + 2 + 3 + 4
    assert flops.keys_seen(6, 3) == 1 + 2 + 3 + 3 + 3 + 3
    assert flops.keys_seen(3, 8) == 6


def test_hymba_windows_and_weights():
    cfg = _cfg("hymba-1.5b")
    fam = flops.family(cfg)
    w = fam.windows(cfg)
    assert [i for i, x in enumerate(w) if x == 0] == [0, 16, 31]
    assert set(w) == {0, 1024}
    d, f, hq, hkv, di, n = 1600, 5504, 25 * 64, 5 * 64, 3200, 16
    layer = (2 * d * hq + 2 * d * hkv + d * 2 * di + 2 * d * n + di * d
             + 3 * d * f)
    assert fam.layer_weights(cfg) == layer
    # sliding layers see min(t + 1, 1024) keys, global ones t + 1
    pairs = 3 * (4096 * 4097 // 2) + 29 * (1024 * 1025 // 2 + 3072 * 1024)
    want = 2 * 4 * (4096 * (32 * layer + d * 32001) + pairs * 2 * hq)
    assert flops.forward_flops(cfg, 4, 4096) == want
    assert flops.train_flops(cfg, 4, 4096) == 3 * want


def test_minicpm3_mla_widths():
    cfg = _cfg("minicpm3-4b")
    fam = flops.family(cfg)
    d, f, h = 2560, 6400, 40
    attn = (d * 768 + 768 * h * 96 + d * 288 + 256 * h * 64 + 256 * h * 64
            + h * 64 * d)
    assert fam.layer_weights(cfg) == attn + 3 * d * f
    # q.k over nope + rope = 96, p.v over v_dim = 64, not d / heads = 64
    assert fam.attention_width(cfg) == h * 96 + h * 64
    assert fam.windows(cfg) == [0] * 62
    assert flops.forward_flops(cfg, 1, 8) == 2 * (
        8 * (62 * (attn + 3 * d * f) + d * 73448) + 62 * 36 * h * 160)


def test_prefill_counts_the_head_at_the_last_position():
    """A prefill returns the last position's logits only, so its head
    counts once a row; a training step's at every position."""
    cfg = _cfg("minicpm3-4b")
    head = 2560 * 73448
    assert flops.forward_flops(cfg, 2, 8) - flops.prefill_flops(
        cfg, 2, 8) == 2 * 2 * 7 * head
    assert flops.train_flops(cfg, 2, 8) == 3 * flops.forward_flops(cfg, 2, 8)


def test_scan_bytes():
    cfg = _cfg("hymba-1.5b")
    n = flops.scan_elements(cfg, 1, 4096)
    assert n == 4096 * 3200 * 16
    assert flops.scan_bytes(n) == 3 * 4 * n
    assert flops.scan_bytes(n, backward=True) == 5 * 4 * n


def test_unknown_family_is_refused():
    """A family is found by its file, ``counts/<family>.py``."""
    with pytest.raises(ValueError, match="counts/rwkv.py"):
        flops.train_flops(dict(_cfg("minicpm3-4b"), reference="rwkv"), 1, 8)
