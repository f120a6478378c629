"""Build hand-written CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled on
first use with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the
root of the checkout, then loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds).  The library name carries a hash of the
source and flags, so an edited source never loads a stale build.

Float rules for every kernel: no ``--use_fast_math`` and ``--fmad=false``,
so ``a*b+c`` is never contracted into an FMA and ``expf``/``logf`` keep
full precision — the kernels must reproduce the plain PyTorch versions
bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, List

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "nvcc_path", "library_path",
           "load_library"]

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the port's kernels")


def library_path(source: pathlib.Path) -> pathlib.Path:
    """Where the shared library of ``source`` is built (its ``nvcc`` log
    lies beside it with the suffix ``.log``)."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:12]}.so"


def load_library(source: pathlib.Path) -> ctypes.CDLL:
    """Build ``source`` if no library of this source and flags exists
    (into a temporary file, renamed when ``nvcc`` succeeds, so a failed
    or concurrent build never leaves a broken library) and load it."""
    out = library_path(source)
    lib = _LIBS.get(str(out))
    if lib is not None:
        return lib
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd: List[str] = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                          str(source)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for "
                               f"{source.name}:\n{proc.stdout}")
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(proc.stdout)
    lib = ctypes.CDLL(str(out))
    _LIBS[str(out)] = lib
    return lib
