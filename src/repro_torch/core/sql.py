"""OpenMLDB-flavoured SQL parser -> FeatureScript.

Supported grammar (case-insensitive keywords):

    SELECT item [, item ...]
    FROM table
    [LAST JOIN table [ORDER BY col] ON left.k = right.k [, ...]]
    WINDOW name AS ( [UNION t1 [, t2 ...]]
                     PARTITION BY col ORDER BY col
                     (ROWS | ROWS_RANGE) BETWEEN bound PRECEDING
                         AND CURRENT ROW
                     [MAXSIZE n] [EXCLUDE CURRENT_ROW] )
          [, name AS (...)]
    [OPTIONS ( key = "value" [, ...] )]

    item   := expr [AS name] | fn(args) OVER wname [AS name]
    bound  := integer | interval (e.g. 3s, 100d, 5m, 2h, 250ms)

This is deliberately a closed subset: enough to express every feature in
the paper's Figure 1 / Table 1 examples plus the benchmark scripts, while
keeping the parser small and auditable.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from .expr import (AggCall, BinaryOp, ColumnRef, Expr, FuncCall, Literal,
                   UnaryOp)
from .functions import AGG_FUNCTIONS
from .plan import FeatureScript, LastJoinSpec, SelectItem
from .window import WindowSpec, parse_interval_ms

__all__ = ["parse", "ParseError"]


class ParseError(ValueError):
    """Parse failure with the source position of the offending token.

    ``pos`` is a character offset into the script text; every parser
    error path sets it, so malformed scripts fail with a locatable
    diagnostic instead of an internal error.
    """

    def __init__(self, msg: str, pos: Optional[int] = None):
        if pos is not None:
            msg = f"{msg} (at position {pos})"
        super().__init__(msg)
        self.pos = pos


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>--[^\n]*)
  | (?P<interval>\d+(?:\.\d+)?(?:ms|[smhd])\b)
  | (?P<number>\d+(?:\.\d+)?)
  | (?P<string>'[^']*'|"[^"]*")
  | (?P<name>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op><=|>=|!=|==|=|<|>|\(|\)|,|\.|\*|\+|-|/)
    """,
    re.VERBOSE,
)

_KEYWORDS = {
    "select", "from", "window", "as", "partition", "by", "order", "rows",
    "rows_range", "between", "preceding", "and", "current", "row", "union",
    "maxsize", "last", "join", "on", "over", "options", "exclude",
    "current_row", "or", "not", "where",
}


def _tokenize(text: str) -> Tuple[List[Tuple[str, str]], List[int]]:
    out: List[Tuple[str, str]] = []
    positions: List[int] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise ParseError(f"lex error at {text[pos:pos+24]!r}", pos=pos)
        start = pos
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        val = m.group()
        if kind == "name" and val.lower() in _KEYWORDS:
            out.append(("kw", val.lower()))
        else:
            out.append((kind, val))
        positions.append(start)
    out.append(("eof", ""))
    positions.append(len(text))
    return out, positions


class _Parser:
    def __init__(self, text: str, time_unit: str = "ms"):
        self.toks, self.poss = _tokenize(text)
        self.i = 0
        if time_unit not in ("ms", "s"):
            raise ParseError("time_unit must be 'ms' or 's'")
        # device timestamps are int32 in *dataset units*; second-resolution
        # datasets span 68 years, ms-resolution ones ~24 days (DESIGN §3)
        self._unit_div = 1000 if time_unit == "s" else 1

    def _interval(self, text: str) -> int:
        ms = parse_interval_ms(text)
        return max(1, ms // self._unit_div)

    # -- token helpers -----------------------------------------------------
    def peek(self, k=0) -> Tuple[str, str]:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, val: Optional[str] = None) -> Optional[str]:
        k, v = self.peek()
        if k == kind and (val is None or v == val):
            self.i += 1
            return v
        return None

    def cur_pos(self, k: int = 0) -> int:
        return self.poss[min(self.i + k, len(self.poss) - 1)]

    def expect(self, kind: str, val: Optional[str] = None) -> str:
        got = self.accept(kind, val)
        if got is None:
            k, v = self.peek()
            raise ParseError(f"expected {val or kind}, got {v!r}",
                             pos=self.cur_pos())
        return got

    def name(self) -> str:
        return self.expect("name")

    # -- expressions (precedence climbing) ----------------------------------
    def expr(self) -> Expr:
        return self._or()

    def _or(self) -> Expr:
        e = self._and()
        while self.accept("kw", "or"):
            e = BinaryOp("or", e, self._and())
        return e

    def _and(self) -> Expr:
        e = self._cmp()
        while self.accept("kw", "and"):
            e = BinaryOp("and", e, self._cmp())
        return e

    def _cmp(self) -> Expr:
        e = self._add()
        k, v = self.peek()
        if k == "op" and v in ("<", "<=", ">", ">=", "=", "==", "!="):
            self.next()
            return BinaryOp(v, e, self._add())
        return e

    def _add(self) -> Expr:
        e = self._mul()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("+", "-"):
                self.next()
                e = BinaryOp(v, e, self._mul())
            else:
                return e

    def _mul(self) -> Expr:
        e = self._unary()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("*", "/"):
                self.next()
                e = BinaryOp(v, e, self._unary())
            else:
                return e

    def _unary(self) -> Expr:
        if self.accept("op", "-"):
            return UnaryOp("-", self._unary())
        if self.accept("kw", "not"):
            return UnaryOp("not", self._unary())
        return self._atom()

    def _atom(self) -> Expr:
        k, v = self.peek()
        if k == "number":
            self.next()
            return Literal(float(v) if "." in v else int(v))
        if k == "interval":
            self.next()
            return Literal(self._interval(v))
        if k == "string":
            self.next()
            return Literal(v[1:-1])
        if self.accept("op", "("):
            e = self.expr()
            self.expect("op", ")")
            return e
        if k == "name":
            self.next()
            # qualified column  table.col
            if self.accept("op", "."):
                col = self.name()
                return ColumnRef(col, table=v)
            # function call
            if self.peek() == ("op", "("):
                self.next()
                args: List[Expr] = []
                if not self.accept("op", ")"):
                    args.append(self.expr())
                    while self.accept("op", ","):
                        args.append(self.expr())
                    self.expect("op", ")")
                return FuncCall(v.lower(), tuple(args))
            return ColumnRef(v)
        raise ParseError(f"unexpected token {v!r}", pos=self.cur_pos())

    # -- statement ----------------------------------------------------------
    def parse_script(self) -> FeatureScript:
        self.expect("kw", "select")
        items = [self._select_item()]
        while self.accept("op", ","):
            items.append(self._select_item())
        self.expect("kw", "from")
        base = self.name()

        last_joins: List[LastJoinSpec] = []
        while self.peek() == ("kw", "last"):
            last_joins.append(self._last_join())

        windows: Dict[str, WindowSpec] = {}
        if self.accept("kw", "window"):
            while True:
                wpos = self.cur_pos()
                name, spec = self._window_def()
                if name in windows:
                    raise ParseError(
                        f"duplicate window alias {name!r}", pos=wpos)
                windows[name] = spec
                if not self.accept("op", ","):
                    break

        options: Dict[str, str] = {}
        if self.accept("kw", "options"):
            self.expect("op", "(")
            while True:
                key = self.name()
                self.expect("op", "=")
                k, v = self.next()
                options[key] = v[1:-1] if k == "string" else v
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")

        self.expect("eof")

        # resolve OVER windows / infer order column
        order_col = "ts"
        for spec in windows.values():
            order_col = spec.order_by
            break
        if self._unit_div != 1:
            options.setdefault("time_unit", "s")
        select = tuple(
            SelectItem(n or f"f{i}", e) for i, (n, e) in enumerate(items))
        return FeatureScript(base_table=base, select=select, windows=windows,
                             last_joins=tuple(last_joins), options=options,
                             order_column=order_col)

    def _select_item(self) -> Tuple[Optional[str], Expr]:
        item_pos = self.cur_pos()
        e = self.expr()
        # fn(...) OVER w
        if self.accept("kw", "over"):
            wname = self.name()
            if not isinstance(e, FuncCall):
                raise ParseError("OVER must follow a function call",
                                 pos=item_pos)
            if e.name not in AGG_FUNCTIONS:
                raise ParseError(
                    f"{e.name!r} is not an aggregate function",
                    pos=item_pos)
            params = tuple(a.value for a in e.args if isinstance(a, Literal))
            e = AggCall(fn=e.name, args=e.args, window=wname, params=params)
        name = None
        if self.accept("kw", "as"):
            name = self.name()
        elif isinstance(e, ColumnRef):
            name = e.name
        return name, e

    def _last_join(self) -> LastJoinSpec:
        self.expect("kw", "last")
        self.expect("kw", "join")
        right = self.name()
        order_by = None
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            e = self._atom()
            order_by = e.name if isinstance(e, ColumnRef) else str(e)
        self.expect("kw", "on")
        cpos = self.cur_pos()
        cond = self.expr()
        if not (isinstance(cond, BinaryOp) and cond.op in ("=", "==")
                and isinstance(cond.lhs, ColumnRef)
                and isinstance(cond.rhs, ColumnRef)):
            raise ParseError("LAST JOIN condition must be left.k = right.k",
                             pos=cpos)
        lhs, rhs = cond.lhs, cond.rhs
        if rhs.table == right or lhs.table not in (None, right):
            left_key, right_key = lhs.name, rhs.name
        else:
            left_key, right_key = rhs.name, lhs.name
        return LastJoinSpec(right_table=right, left_key=left_key,
                            right_key=right_key, order_by=order_by)

    def _window_def(self) -> Tuple[str, WindowSpec]:
        name = self.name()
        self.expect("kw", "as")
        self.expect("op", "(")
        unions: List[str] = []
        if self.accept("kw", "union"):
            unions.append(self.name())
            while self.accept("op", ","):
                unions.append(self.name())
        self.expect("kw", "partition")
        self.expect("kw", "by")
        part = self.name()
        self.expect("kw", "order")
        self.expect("kw", "by")
        order = self.name()

        frame_rows = bool(self.accept("kw", "rows"))
        if not frame_rows:
            self.expect("kw", "rows_range")
        self.expect("kw", "between")
        bpos = self.cur_pos()
        k, v = self.next()
        if k == "interval":
            preceding = self._interval(v)
            if frame_rows:
                raise ParseError("ROWS frame takes a row count, not an "
                                 "interval", pos=bpos)
        elif k == "number":
            preceding = int(float(v))
        else:
            raise ParseError(f"bad frame bound {v!r}", pos=bpos)
        self.expect("kw", "preceding")
        self.expect("kw", "and")
        self.expect("kw", "current")
        self.expect("kw", "row")

        maxsize = 0
        exclude = False
        while True:
            if self.accept("kw", "maxsize"):
                maxsize = int(float(self.expect("number")))
            elif self.accept("kw", "exclude"):
                self.expect("kw", "current_row")
                exclude = True
            else:
                break
        self.expect("op", ")")
        return name, WindowSpec(
            name=name, partition_by=part, order_by=order,
            preceding=preceding, frame_rows=frame_rows,
            union_tables=tuple(unions), maxsize=maxsize,
            instance_not_in_window=exclude)


def parse(text: str, time_unit: str = "ms") -> FeatureScript:
    """Parse an OpenMLDB-flavoured feature script into a FeatureScript.

    ``time_unit`` declares the resolution of the dataset's order column
    (device timestamps are int32): "ms" for short-horizon streams, "s" for
    long-horizon (multi-year) data.  Interval literals are scaled.
    """
    return _Parser(text, time_unit=time_unit).parse_script()
