"""Scalar select-item lowering and output assembly.

Scalar items (row-level expressions, §4.1(4)(5)) evaluate against an
environment of base columns plus LAST-JOINed columns; the driver builds
that env and calls the evaluator, then assembles outputs in SELECT
order.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..expr import as_tensor, eval_scalar
from ..plan import FeaturePlan, FeatureScript

__all__ = ["eval_scalar_items", "select_outputs"]


def eval_scalar_items(plan: FeaturePlan, env: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """Evaluate every scalar select item against ``env``."""
    return {item.name: as_tensor(eval_scalar(item.expr, env))
            for item in plan.scalar_items}


def select_outputs(script: FeatureScript, out: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Preserve SELECT order (the Output plan node's contract)."""
    return {it.name: out[it.name] for it in script.select}
