"""Faults planted in the program under a run, to show that the check
sees them (``tests/test_port_bench_faults.py`` at tiny sizes on the CPU,
``control.py`` at a cell's own size on the card).  Never used by a run
of ``run.py``.

Each traffic kind's driver module names the faults its cells can have in
``FAULTS``: fault name -> a function that gives the patches planting it,
(module, attribute, replacement) each.  The names in use:

  state_unchanged   the step returns its state as it came
  half_batch        half of the batch left out
  answer_altered    an answer altered where it is produced
"""

from __future__ import annotations

import contextlib
from typing import Iterator


@contextlib.contextmanager
def plant(driver, fault: str) -> Iterator[None]:
    """``fault`` of the driver module ``driver`` planted while the block
    runs."""
    faults = getattr(driver, "FAULTS", {})
    if fault not in faults:
        raise ValueError(f"no fault {fault!r} in {driver.__name__} "
                         f"(it has {sorted(faults)})")
    patches = faults[fault]()
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
