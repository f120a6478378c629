"""Distribution runtime context for model code.

Model layers are mesh-agnostic by default.  The sequence-sharded decode
(``models.sharded_decode``) and ``model.decode_step``'s placed state
read the active mesh and its decode axis from here (``decode_mesh``);
a driver sets them around the decode steps (``use_mesh``).  The mesh is
the port's ``distributed.sharding.Mesh``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

__all__ = ["set_mesh", "get_mesh", "decode_axis", "decode_mesh",
           "use_mesh"]

_MESH = None
_DECODE_AXIS: Optional[str] = None


def set_mesh(mesh, decode_axis: Optional[str] = "model"):
    global _MESH, _DECODE_AXIS
    _MESH = mesh
    _DECODE_AXIS = decode_axis


def get_mesh():
    return _MESH


def decode_axis() -> Optional[str]:
    return _DECODE_AXIS


def decode_mesh():
    """The active mesh where it has the decode axis (an active decode
    mesh), else None."""
    if _MESH is None or _DECODE_AXIS is None \
            or _DECODE_AXIS not in _MESH.shape:
        return None
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh, decode_axis: Optional[str] = "model"):
    global _MESH, _DECODE_AXIS
    prev = (_MESH, _DECODE_AXIS)
    _MESH, _DECODE_AXIS = mesh, decode_axis
    try:
        yield
    finally:
        _MESH, _DECODE_AXIS = prev
