"""Config module for --arch minicpm3-4b (see registry for the exact published numbers + provenance)."""

from .registry import get

CONFIG = get("minicpm3-4b")
