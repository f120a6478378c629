"""Config module for --arch whisper-tiny (see registry for the exact published numbers + provenance)."""

from .registry import get

CONFIG = get("whisper-tiny")
