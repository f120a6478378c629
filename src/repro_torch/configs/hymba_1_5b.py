"""Config module for --arch hymba-1.5b (see registry for the exact published numbers + provenance)."""

from .registry import get

CONFIG = get("hymba-1.5b")
