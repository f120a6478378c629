"""Roofline analysis of the port's steps: ``analyze_step`` counts one
eager step (the counterpart of the reference's ``analyze_hlo``) and
``report`` turns dry-run records into the three-term roofline table."""

from .trace_analyzer import StepCost, StepCounter, analyze_step  # noqa: F401

__all__ = ["analyze_step", "StepCost", "StepCounter"]
