"""In-memory columnar tables and vectorised SQL-expression evaluation.

Replaces the reference's re-entrant DuckDB queries for filtered search: the
synthesized ``SELECT CAST(<filter> AS UTINYINT), CAST(<idsel> AS BIGINT) FROM
<table>`` (src/faiss_extension.cpp:939-944) and ``SELECT <idsel> FROM <table>
WHERE <filter>`` (:986-989) become two explicit evaluation entry points over
registered numpy columns.

Expression language (vectorised over columns):
  literals, identifiers (column names; ``rowid`` = 0..n-1), ``+ - * / %``,
  comparisons ``< <= > >= = == != <>``, ``AND OR NOT``, parentheses, unary
  minus.  SQL spellings (``=``, ``<>``, case-insensitive AND/OR/NOT) are
  normalised before parsing with Python's ast module; evaluation walks the
  tree with numpy semantics.
"""

from __future__ import annotations

import ast
import itertools
import re
import threading
from typing import Mapping

import numpy as np

from ..errors import filter_query_error


def _normalise_segment(seg: str) -> str:
    """Operator/keyword rewriting for a segment known to contain no string
    literals."""
    out = []
    i = 0
    n = len(seg)
    while i < n:
        c = seg[i]
        two = seg[i:i + 2]
        if two in ("<=", ">=", "!=", "=="):
            out.append(two)
            i += 2
        elif two == "<>":
            out.append("!=")
            i += 2
        elif c == "=":
            out.append("==")
            i += 1
        else:
            out.append(c)
            i += 1
    s = "".join(out)
    s = re.sub(r"\bAND\b", "and", s, flags=re.IGNORECASE)
    s = re.sub(r"\bOR\b", "or", s, flags=re.IGNORECASE)
    s = re.sub(r"\bNOT\b", "not ", s, flags=re.IGNORECASE)
    return s


def _normalise(expr: str) -> str:
    """SQL spelling → Python spelling.  Quoted string literals pass through
    untouched (the reference evaluates filters as real SQL where literals
    are opaque)."""
    parts = []
    i = 0
    n = len(expr)
    seg_start = 0
    while i < n:
        c = expr[i]
        if c in "'\"":
            parts.append(_normalise_segment(expr[seg_start:i]))
            quote = c
            j = i + 1
            while j < n and expr[j] != quote:
                j += 1
            parts.append(expr[i:min(j + 1, n)])
            i = j + 1
            seg_start = i
        else:
            i += 1
    parts.append(_normalise_segment(expr[seg_start:]))
    return "".join(parts)


_BIN_OPS = {
    ast.Add: np.add, ast.Sub: np.subtract, ast.Mult: np.multiply,
    ast.Div: np.true_divide, ast.Mod: np.mod, ast.FloorDiv: np.floor_divide,
}
_CMP_OPS = {
    ast.Lt: np.less, ast.LtE: np.less_equal, ast.Gt: np.greater,
    ast.GtE: np.greater_equal, ast.Eq: np.equal, ast.NotEq: np.not_equal,
}


class _Evaluator(ast.NodeVisitor):
    def __init__(self, columns: Mapping[str, np.ndarray], nrows: int):
        self.columns = columns
        self.nrows = nrows

    def visit_Expression(self, node):
        return self.visit(node.body)

    def visit_Name(self, node):
        name = node.id
        if name in self.columns:
            return self.columns[name]
        if name.lower() == "rowid":
            return np.arange(self.nrows, dtype=np.int64)
        raise filter_query_error(f"unknown column {name}")

    def visit_Constant(self, node):
        return node.value

    def visit_BinOp(self, node):
        op = _BIN_OPS.get(type(node.op))
        if op is None:
            raise filter_query_error(f"unsupported operator {node.op}")
        return op(self.visit(node.left), self.visit(node.right))

    def visit_UnaryOp(self, node):
        v = self.visit(node.operand)
        if isinstance(node.op, ast.USub):
            return np.negative(v)
        if isinstance(node.op, ast.UAdd):
            return v
        if isinstance(node.op, ast.Not):
            return np.logical_not(v)
        raise filter_query_error(f"unsupported unary operator {node.op}")

    def visit_Compare(self, node):
        left = self.visit(node.left)
        result = None
        for op, comp in zip(node.ops, node.comparators):
            fn = _CMP_OPS.get(type(op))
            if fn is None:
                raise filter_query_error(f"unsupported comparison {op}")
            right = self.visit(comp)
            part = fn(left, right)
            result = part if result is None else np.logical_and(result, part)
            left = right
        return result

    def visit_BoolOp(self, node):
        fn = np.logical_and if isinstance(node.op, ast.And) else np.logical_or
        vals = [self.visit(v) for v in node.values]
        out = vals[0]
        for v in vals[1:]:
            out = fn(out, v)
        return out

    def generic_visit(self, node):
        raise filter_query_error(
            f"unsupported expression element {type(node).__name__}")


def _as_columns(table) -> dict[str, np.ndarray]:
    """Accept dict-of-arrays, structured array, or pandas DataFrame."""
    if isinstance(table, dict):
        return {k: np.asarray(v) for k, v in table.items()}
    if hasattr(table, "dtype") and getattr(table.dtype, "names", None):
        return {n: np.asarray(table[n]) for n in table.dtype.names}
    if hasattr(table, "columns") and hasattr(table, "__getitem__"):
        return {str(c): np.asarray(table[c]) for c in table.columns}
    raise filter_query_error(f"unsupported table object {type(table).__name__}")


_DATABASE_IDS = itertools.count()


class Database:
    """Named columnar tables + expression evaluation over them."""

    def __init__(self):
        #: process-unique id: caches key on it, never on id(self), which
        #: CPython reuses after a Database is collected.
        self.uid = next(_DATABASE_IDS)
        self._tables: dict[str, dict[str, np.ndarray]] = {}
        self._versions: dict[str, int] = {}
        self._vcounter = 0
        self._lock = threading.Lock()

    def register(self, name: str, table) -> None:
        cols = _as_columns(table)
        lens = {v.shape[0] for v in cols.values()}
        if len(lens) > 1:
            raise filter_query_error(
                f"columns of table {name} have differing lengths {lens}")
        with self._lock:
            self._tables[name] = cols
            self._vcounter += 1
            self._versions[name] = self._vcounter

    def unregister(self, name: str) -> None:
        with self._lock:
            self._tables.pop(name, None)
            self._versions.pop(name, None)

    def table_version(self, name: str) -> int:
        """Monotonic per-registration version: re-registering a table (even
        with identical contents) bumps it, so caches keyed on
        (table, version, expr) can never serve results for stale data."""
        with self._lock:
            if name not in self._tables:
                raise filter_query_error(f"unknown table {name}")
            return self._versions[name]

    def _table(self, name: str) -> dict[str, np.ndarray]:
        with self._lock:
            if name not in self._tables:
                raise filter_query_error(f"unknown table {name}")
            return self._tables[name]

    def eval_expr(self, tablename: str, expr: str) -> np.ndarray:
        cols = self._table(tablename)
        nrows = next(iter(cols.values())).shape[0] if cols else 0
        try:
            tree = ast.parse(_normalise(expr), mode="eval")
        except SyntaxError as e:
            raise filter_query_error(f"cannot parse expression {expr}: {e}") \
                from None
        out = _Evaluator(cols, nrows).visit(tree)
        return np.broadcast_to(np.asarray(out), (nrows,))

    def eval_filter_pair(self, tablename: str, filter_expr: str,
                         idselector: str):
        """The __faiss_create_mask input: (CAST(filter AS UTINYINT),
        CAST(idsel AS BIGINT)) for every row (src/faiss_extension.cpp:939-944)."""
        flags = self.eval_expr(tablename, filter_expr)
        ids = self.eval_expr(tablename, idselector)
        return flags.astype(np.uint8), ids.astype(np.int64)

    def eval_filter_ids(self, tablename: str, filter_expr: str,
                        idselector: str) -> np.ndarray:
        """SELECT idsel FROM table WHERE filter (src/faiss_extension.cpp:986-989)."""
        flags = self.eval_expr(tablename, filter_expr)
        ids = self.eval_expr(tablename, idselector).astype(np.int64)
        return ids[np.asarray(flags, dtype=bool)]


_DEFAULT = Database()


def default_database() -> Database:
    return _DEFAULT


def register_table(name: str, table) -> None:
    """Register a table in the default database (the analogue of the table
    already existing in the DuckDB session)."""
    _DEFAULT.register(name, table)
