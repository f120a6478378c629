"""Config module for --arch qwen3-8b (see registry for the exact published numbers + provenance)."""

from .registry import get

CONFIG = get("qwen3-8b")
