"""Expression IR for feature scripts.

A small, closed expression language: column references, literals, unary and
binary arithmetic/comparison/boolean operators, scalar function calls, and
aggregate calls bound to a named window.  The compiler evaluates scalar
expressions vectorized over rows with torch; aggregate calls are routed
through the monoid machinery (functions.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

__all__ = [
    "Expr", "ColumnRef", "Literal", "BinaryOp", "UnaryOp", "FuncCall",
    "AggCall", "eval_scalar", "collect_columns", "as_tensor",
]


class Expr:
    """Base class; nodes are frozen dataclasses."""

    def fingerprint(self) -> str:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ColumnRef(Expr):
    name: str
    table: Optional[str] = None  # None = base table / window scope

    def fingerprint(self) -> str:
        return f"col({self.table or ''}.{self.name})"


@dataclasses.dataclass(frozen=True)
class Literal(Expr):
    value: Any

    def fingerprint(self) -> str:
        return f"lit({self.value!r})"


_BINOPS = {
    "+": torch.add, "-": torch.sub, "*": torch.mul, "/": torch.div,
    ">": torch.gt, ">=": torch.ge,
    "<": torch.lt, "<=": torch.le,
    "=": torch.eq, "==": torch.eq, "!=": torch.ne,
    "and": torch.logical_and, "or": torch.logical_or,
}


def as_tensor(v) -> torch.Tensor:
    """A literal becomes a 0-dim tensor; a 0-dim tensor takes part in
    type promotion like a scalar, as JAX's weakly typed literals do, so
    ``int32 column * 2`` stays int32 and ``f32 column * 2`` stays f32."""
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(v)


@dataclasses.dataclass(frozen=True)
class BinaryOp(Expr):
    op: str
    lhs: Expr
    rhs: Expr

    def fingerprint(self) -> str:
        return f"({self.lhs.fingerprint()}{self.op}{self.rhs.fingerprint()})"


@dataclasses.dataclass(frozen=True)
class UnaryOp(Expr):
    op: str  # "-" | "not"
    operand: Expr

    def fingerprint(self) -> str:
        return f"({self.op}{self.operand.fingerprint()})"


@dataclasses.dataclass(frozen=True)
class FuncCall(Expr):
    """Scalar (row-level) function call, e.g. multiclass_label(col)."""

    name: str
    args: Tuple[Expr, ...]

    def fingerprint(self) -> str:
        a = ",".join(x.fingerprint() for x in self.args)
        return f"{self.name}({a})"


@dataclasses.dataclass(frozen=True)
class AggCall(Expr):
    """Aggregate function over a named window: fn(args) OVER window."""

    fn: str
    args: Tuple[Expr, ...]
    window: str
    # static params (e.g. top_n, smoothing factor) extracted from literal args
    params: Tuple[Any, ...] = ()

    def fingerprint(self) -> str:
        a = ",".join(x.fingerprint() for x in self.args)
        p = ",".join(repr(x) for x in self.params)
        return f"{self.fn}({a};{p})@{self.window}"


def collect_columns(e: Expr, out=None) -> set:
    """All column names referenced by an expression tree."""
    if out is None:
        out = set()
    if isinstance(e, ColumnRef):
        out.add(e.name)
    elif isinstance(e, BinaryOp):
        collect_columns(e.lhs, out)
        collect_columns(e.rhs, out)
    elif isinstance(e, UnaryOp):
        collect_columns(e.operand, out)
    elif isinstance(e, (FuncCall, AggCall)):
        for a in e.args:
            collect_columns(a, out)
    return out


def eval_scalar(e: Expr, env):
    """Evaluate a scalar expression against ``env``: name -> tensor.

    Works elementwise over rows (all arrays share a leading row dim) and
    equally over single scalars (online request mode) — the same code path
    serves both, which is the consistency-by-construction property.
    """
    if isinstance(e, ColumnRef):
        if e.table is not None:
            qualified = f"{e.table}.{e.name}"
            if qualified in env:
                return env[qualified]
        try:
            return env[e.name]
        except KeyError as err:
            raise KeyError(f"unknown column {e.name!r}") from err
    if isinstance(e, Literal):
        return e.value
    if isinstance(e, BinaryOp):
        lhs = eval_scalar(e.lhs, env)
        rhs = eval_scalar(e.rhs, env)
        try:
            return _BINOPS[e.op](as_tensor(lhs), rhs)
        except KeyError as err:
            raise ValueError(f"unknown operator {e.op!r}") from err
    if isinstance(e, UnaryOp):
        v = eval_scalar(e.operand, env)
        v = as_tensor(v)
        return torch.logical_not(v) if e.op == "not" else torch.neg(v)
    if isinstance(e, FuncCall):
        from . import functions  # local import to avoid a cycle

        return functions.eval_scalar_fn(e.name, e.args, env)
    raise TypeError(f"cannot scalar-evaluate {type(e).__name__}")
