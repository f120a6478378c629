"""Compilation cache (§4.2) — shared by every lowering driver.

Keys carry the script fingerprint plus the driver's shape/plan
signature; hits skip rebuilding the cached plan or program.
Re-exported through ``core.compiler``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

__all__ = ["cached", "cache_stats", "clear_cache"]

_CACHE: Dict[Tuple, Any] = {}
_STATS = {"hits": 0, "misses": 0}


def cache_stats() -> Dict[str, int]:
    return dict(_STATS)


def clear_cache():
    _CACHE.clear()
    _STATS["hits"] = 0
    _STATS["misses"] = 0


def cached(key, builder):
    fn = _CACHE.get(key)
    if fn is None:
        _STATS["misses"] += 1
        fn = builder()
        _CACHE[key] = fn
    else:
        _STATS["hits"] += 1
    return fn
