"""Arch configs: the registry of every architecture (data only) and one
module per architecture the port serves (``hymba_1_5b``, ``llama3_8b``)."""

from .base import ArchConfig, ShapeSpec, SHAPES  # noqa: F401
from .registry import ARCHS, get, reduced  # noqa: F401
