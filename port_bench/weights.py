"""Weights drawn from the run's seed, on the device, one large draw per
group (the embedding, the head, each layer), from a layout that a
reference module gives (``reference.<family>.layout``).  The same seed
gives the same tensors, so a reference can draw any group again after the
program's state is freed."""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and len(x) == 3 and isinstance(x[0], tuple)


def _specs(tree, prefix=()) -> Iterator[Tuple[tuple, tuple]]:
    if _is_spec(tree):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _specs(tree[k], prefix + (k,))
    else:
        raise TypeError(f"layout node {prefix}: {type(tree).__name__}")


def groups(layout: Dict) -> List[tuple]:
    """The draw groups of a layout in order: each top-level leaf, then
    ("layers", i) for every layer."""
    out = [(k,) for k in sorted(layout) if k != "layers"]
    return out + [("layers", i) for i in range(len(layout["layers"]))]


def generator(seed: int, tag, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, tag...)."""
    tag = tag if isinstance(tag, (tuple, list)) else (tag,)
    words = [int(seed) % (1 << 64)] + [
        int(t) if isinstance(t, (int, np.integer))
        else int.from_bytes(str(t).encode()[:8].ljust(8, b"\0"), "little")
        for t in tag]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return g


def draw_group(layout: Dict, seed: int, group: tuple, dtype,
               device) -> object:
    """One group's tensors (a tensor, or a layer's dict tree)."""
    node = layout[group[0]] if len(group) == 1 else layout["layers"][group[1]]
    specs = list(_specs(node))
    n = sum(int(np.prod(shape)) for _, (shape, kind, _) in specs
            if kind != "const")
    raw = None
    if n:
        raw = torch.randn((n,), generator=generator(seed, group, device),
                          dtype=torch.float32, device=device)
    out: Dict = {}
    lo = 0
    for path, (shape, kind, value) in specs:
        if kind == "const":
            t = torch.full(shape, value, dtype=dtype, device=device)
        else:
            size = int(np.prod(shape))
            t = raw[lo:lo + size].reshape(shape) * value
            lo += size
            if kind == "neg_exp":
                t = -torch.exp(t)
            elif kind != "normal":
                raise ValueError(f"unknown draw {kind!r}")
            t = t.to(dtype)
        if not path:
            return t
        cur = out
        for k in path[:-1]:
            cur = cur.setdefault(k, {})
        cur[path[-1]] = t
    return out


def draw(layout: Dict, seed: int, dtype, device) -> Dict:
    """The whole parameter tree."""
    params: Dict = {"layers": []}
    for g in groups(layout):
        t = draw_group(layout, seed, g, dtype, device)
        if g[0] == "layers":
            params["layers"].append(t)
        else:
            params[g[0]] = t
    return params



def numels(layout: Dict) -> Dict[str, int]:
    """Elements of every leaf, by its path (``layers.<i>.<name>...``)."""
    out = {}
    for g in groups(layout):
        node = layout[g[0]] if len(g) == 1 else layout["layers"][g[1]]
        for path, (shape, _, _) in _specs(node):
            out[".".join(map(str, g + path))] = int(np.prod(shape))
    return out
