"""Config module for --arch granite-3-8b (see registry for the exact published numbers + provenance)."""

from .registry import get

CONFIG = get("granite-3-8b")
