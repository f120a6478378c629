"""Config module for --arch llava-next-34b (see registry for the exact published numbers + provenance)."""

from .registry import get

CONFIG = get("llava-next-34b")
