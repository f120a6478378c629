"""Config module for --arch dbrx-132b (see registry for the exact published numbers + provenance)."""

from .registry import get

CONFIG = get("dbrx-132b")
