"""Config module for --arch llama3-8b (see registry for the exact published numbers + provenance)."""

from .registry import get

CONFIG = get("llama3-8b")
