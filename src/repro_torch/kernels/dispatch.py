"""Kernel dispatch policy — one place deciding kernel vs plain version.

* ``use_kernel=None`` follows the tensor: a CUDA tensor launches the
  hand-written kernel, a CPU tensor runs the plain PyTorch version;
* ``use_kernel=True`` forces the kernel, and raises
  :class:`KernelUnsupportedError` for a tensor that is not on a CUDA
  device (there is no fallback: a kernel that cannot run is an error);
* ``use_kernel=False`` runs the plain version wherever the tensor lies
  (the reference the kernels are held against).

Every kernel wrapper counts its launches here, one per launch and
nowhere else, so a run can show that its main path went through the
kernels.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["KernelUnsupportedError", "resolve", "count_launch",
           "launch_counts", "reset_launch_counts"]

_LAUNCHES: Dict[str, int] = {}


class KernelUnsupportedError(RuntimeError):
    """A hand-written CUDA/Triton kernel was forced on a tensor that is
    not on a CUDA device.  Raised at dispatch time, before any launch."""


def resolve(use_kernel: Optional[bool], tensor: torch.Tensor) -> bool:
    """True when the kernel runs for ``tensor``, False for the plain
    version (see the module docstring for the policy)."""
    on_cuda = tensor.device.type == "cuda"
    if use_kernel is None:
        return on_cuda
    if use_kernel and not on_cuda:
        raise KernelUnsupportedError(
            f"use_kernel=True requests the CUDA kernel, but the input lies "
            f"on '{tensor.device}'. Pass use_kernel=None to follow the "
            f"tensor's device, or use_kernel=False for the plain PyTorch "
            f"version.")
    return bool(use_kernel)


def count_launch(name: str) -> None:
    _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()
