"""Arch configs: the registry of every architecture (data only) and one
module per architecture the port serves (``hymba_1_5b``, ``llama3_8b``,
``qwen3_8b``, ``granite_3_8b``, ``minicpm3_4b``, ``qwen2_moe_a2_7b``,
``dbrx_132b``)."""

from .base import ArchConfig, ShapeSpec, SHAPES  # noqa: F401
from .registry import ARCHS, get, reduced  # noqa: F401
