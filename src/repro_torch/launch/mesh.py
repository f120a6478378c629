"""Production mesh construction.

A FUNCTION, not a module-level constant: importing this module never
touches the device state.  The meshes are the port's single-controller
``distributed.sharding.Mesh`` over the visible CUDA devices.
"""

from __future__ import annotations

import numpy as np
import torch

from ..distributed.sharding import Mesh, cuda_devices

__all__ = ["make_production_mesh", "make_host_mesh"]


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> Mesh:
    """Single pod: (data=16, model=16) = 256 cards.  Multi-pod: a leading
    ``pod`` axis of 2 (512 cards); DP spans pod x data, TP stays inside a
    pod, so the only cross-pod collective is the gradient all-reduce.
    Raises, as ``jax.make_mesh`` does, when fewer CUDA devices are
    visible.  With ``device`` (``"meta"`` for a dry run) every entry names
    that one device instead: the mesh's shape and axes without the
    cards."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = int(np.prod(shape))
    if device is not None:
        return Mesh(np.full(shape, torch.device(device), dtype=object), axes)
    devs = cuda_devices()
    if len(devs) < need:
        raise ValueError(f"Number of devices {len(devs)} must be >= the "
                         f"product of mesh_shape {shape}")
    return Mesh(np.asarray(devs[:need], dtype=object).reshape(shape), axes)


def make_host_mesh() -> Mesh:
    """1-device mesh over the CPU for smoke tests (same axis names)."""
    return Mesh(np.asarray([[torch.device("cpu")]], dtype=object),
                ("data", "model"))
