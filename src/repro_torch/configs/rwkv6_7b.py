"""Config module for --arch rwkv6-7b (see registry for the exact published numbers + provenance)."""

from .registry import get

CONFIG = get("rwkv6-7b")
