"""Config module for --arch qwen2-moe-a2.7b (see registry for the exact published numbers + provenance)."""

from .registry import get

CONFIG = get("qwen2-moe-a2.7b")
