"""SQL statement dispatcher: the reference's SQL surface without DuckDB.

The reference registers its operators as DuckDB functions and users drive
them with SQL (README.md:55-71, test/sql/*.test).  This module accepts the
same statement shapes against the standalone engine:

    CALL faiss_create('name', 8, 'Flat');
    CALL faiss_create('name', 8, 'Flat', metric_type='L2');
    CALL faiss_create_params('h', 8, 'HNSW16', map{'efConstruction': 32});
    CALL faiss_manual_train((SELECT emb FROM t), 'name');
    CALL faiss_add((SELECT emb FROM t), 'name');
    CALL faiss_add((SELECT id, emb FROM t), 'name');
    CALL faiss_save('name', '/path'); CALL faiss_load('n2', '/path');
    CALL faiss_destroy('name');
    SELECT faiss_search('name', 10, emb) FROM queries;
    SELECT UNNEST(faiss_search('name', 10, emb)) FROM queries;
    SELECT faiss_search_filter('n', 10, emb, 'id%2==0', 'id', 't') FROM q;
    SELECT faiss_search_filter_set(...) FROM q;

Restrictions (documented deviation): table arguments must be simple
``SELECT col[, col] FROM table`` projections over registered tables; search
queries must be ``SELECT [cols,] <faiss fn>(args) FROM table``.  Vector
columns are table columns holding (n, d) arrays.  This is the thin SQL/CLI
adapter of SURVEY.md §7's architecture stance, not a general SQL engine.

Search results come back as a pandas-free list of row dicts with the
reference's result schema: rank INT, label BIGINT, distance FLOAT
(src/faiss_extension.cpp:640-662), flattened when UNNEST is used.

A copy of ``duckdb_faiss_ext_tpu/sql/dispatch.py``.  Two routes of the JAX
package wait for parts of the port: ``faiss_to_gpu`` / ``faiss_to_device``
(device placement) and ``faiss_range_search`` raise "… is not yet
available in duckdb_faiss_ext_tpu_torch".
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np

from .. import api
from ..catalog import Catalog
from ..errors import InvalidInputError, not_available
from .engine import Database, default_database

_CALL_RE = re.compile(r"^\s*CALL\s+(\w+)\s*\((.*)\)\s*;?\s*$",
                      re.IGNORECASE | re.DOTALL)
_SELECT_RE = re.compile(
    r"^\s*SELECT\s+(.*?)\s+FROM\s+(\w+)\s*;?\s*$",
    re.IGNORECASE | re.DOTALL)
_FN_RE = re.compile(
    r"(UNNEST\s*\(\s*)?(faiss_search(?:_filter(?:_set)?)?|faiss_range_search)"
    r"\s*\((.*)\)"
    r"(\s*\))?\s*$",
    re.IGNORECASE | re.DOTALL)
_SUBQ_RE = re.compile(
    r"^\s*\(\s*SELECT\s+(.*?)\s+FROM\s+(\w+)\s*\)\s*$",
    re.IGNORECASE | re.DOTALL)


def _split_args(s: str) -> list[str]:
    """Split a comma-separated argument list respecting (), {}, and quotes."""
    out, depth, cur, quote = [], 0, [], None
    for ch in s:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
            continue
        if ch in "'\"":
            quote = ch
            cur.append(ch)
        elif ch in "({[":
            depth += 1
            cur.append(ch)
        elif ch in ")}]":
            depth -= 1
            cur.append(ch)
        elif ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    last = "".join(cur).strip()
    if last:
        out.append(last)
    return out


_MAP_RE = re.compile(r"^\s*(?:map\s*)?\{(.*)\}\s*$", re.IGNORECASE | re.DOTALL)


def _parse_literal(tok: str):
    tok = tok.strip()
    if tok.startswith("'") and tok.endswith("'"):
        return tok[1:-1]
    if tok.startswith('"') and tok.endswith('"'):
        return tok[1:-1]
    m = _MAP_RE.match(tok)
    if m:
        items = _split_args(m.group(1))
        result = {}
        for item in items:
            if not item:
                continue
            key, _, value = item.partition(":")
            result[str(_parse_literal(key))] = str(_parse_literal(value))
        return result
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok  # bare identifier


class Connection:
    """A session against one catalog + one table registry — the analogue of
    a DuckDB connection with the extension loaded."""

    def __init__(self, catalog: Catalog | None = None,
                 database: Database | None = None):
        self.catalog = catalog if catalog is not None else Catalog()
        self.database = database if database is not None else \
            default_database()
        #: session mask registry for __faiss_create_mask (the reference
        #: stashes the bitmap on the index entry, :898; ours is per-session)
        self.masks: dict = {}

    # -- table management (stand-in for CREATE TABLE / inserts) ------------
    def register(self, name: str, table) -> None:
        self.database.register(name, table)

    # -- statement execution ----------------------------------------------
    def execute(self, sql: str):
        sql = sql.strip()
        m = _CALL_RE.match(sql)
        if m:
            return self._execute_call(m.group(1).lower(), m.group(2))
        m = _SELECT_RE.match(sql)
        if m:
            return self._execute_select(m.group(1), m.group(2))
        raise InvalidInputError(f"Cannot parse statement: {sql[:80]}")

    # -- CALL ... ----------------------------------------------------------
    def _table_arg(self, tok: str):
        """Resolve '(SELECT col[, col] FROM table)' into numpy data."""
        m = _SUBQ_RE.match(tok)
        if not m:
            raise InvalidInputError(
                f"Expected (SELECT ... FROM table) argument, got: {tok}")
        cols = [c.strip() for c in _split_args(m.group(1))]
        tab = self.database._table(m.group(2))
        arrays = []
        for c in cols:
            if c not in tab:
                raise InvalidInputError(
                    f"unknown column {c} in table {m.group(2)}")
            arrays.append(tab[c])
        if len(arrays) == 1:
            return np.asarray(arrays[0])
        if len(arrays) == 2:
            return (np.asarray(arrays[0]), np.asarray(arrays[1]))
        raise InvalidInputError(
            "table argument must project 1 (vectors) or 2 (id, vectors) "
            "columns")

    def _execute_call(self, fn: str, argstr: str):
        toks = _split_args(argstr)
        named = {}
        pos = []
        for t in toks:
            nm = re.match(r"^(\w+)\s*=\s*(.+)$", t, re.DOTALL)
            if nm and not t.strip().startswith("("):
                named[nm.group(1)] = _parse_literal(nm.group(2))
            else:
                pos.append(t)

        if fn in ("faiss_create", "faiss_create_params"):
            name = _parse_literal(pos[0])
            dim = int(_parse_literal(pos[1]))
            desc = _parse_literal(pos[2])
            params = _parse_literal(pos[3]) if len(pos) > 3 else None
            if fn == "faiss_create" and params is not None:
                raise InvalidInputError(
                    "faiss_create takes 3 positional arguments; use "
                    "faiss_create_params for a parameter map")
            return api.faiss_create_params(name, dim, desc, params,
                                           catalog=self.catalog, **named)
        if fn == "faiss_add":
            data = self._table_arg(pos[0])
            return api.faiss_add(data, _parse_literal(pos[1]),
                                 catalog=self.catalog)
        if fn == "faiss_manual_train":
            data = self._table_arg(pos[0])
            return api.faiss_manual_train(data, _parse_literal(pos[1]),
                                          catalog=self.catalog)
        if fn == "faiss_save":
            return api.faiss_save(_parse_literal(pos[0]),
                                  _parse_literal(pos[1]),
                                  catalog=self.catalog)
        if fn == "faiss_load":
            return api.faiss_load(_parse_literal(pos[0]),
                                  _parse_literal(pos[1]),
                                  catalog=self.catalog)
        if fn == "faiss_destroy":
            return api.faiss_destroy(_parse_literal(pos[0]),
                                     catalog=self.catalog)
        if fn in ("faiss_to_gpu", "faiss_move_gpu", "faiss_to_device"):
            raise not_available(fn)
        if fn == "__faiss_create_mask":
            # CALL __faiss_create_mask((SELECT flag, id FROM t), 'key')
            # (SelBind..SelFinalise, src/faiss_extension.cpp:822-901).
            flags, ids = self._table_arg(pos[0])
            self.masks[_parse_literal(pos[1])] = api.create_mask(flags, ids)
            return None
        raise InvalidInputError(f"Unknown function: {fn}")

    # -- SELECT ... --------------------------------------------------------
    def _execute_select(self, proj: str, table: str):
        m = _FN_RE.search(proj)
        if not m:
            raise InvalidInputError(
                "SELECT must invoke faiss_search / faiss_search_filter / "
                "faiss_search_filter_set")
        unnest = m.group(1) is not None
        fn = m.group(2).lower()
        arg_src = m.group(3)
        if m.group(1) is not None:
            # strip the UNNEST's closing paren captured inside args
            arg_src = arg_src.rstrip()
            if arg_src.endswith(")"):
                arg_src = arg_src[:-1]
        passthrough = proj[:m.start()].rstrip().rstrip(",").strip()
        toks = _split_args(arg_src)

        tab = self.database._table(table)
        name = _parse_literal(toks[0])
        if fn == "faiss_range_search":
            raise not_available(fn)
        k = int(_parse_literal(toks[1]))
        qcol = toks[2].strip()
        literal_rows = None
        if qcol.startswith("[") and qcol.endswith("]"):
            # Literal query vector, e.g. faiss_search('n', 2, [0.1, 0.2])
            # (test/sql/faiss7.test uses this shape): search ONCE and
            # replicate the result row per table row.
            vec = [float(v) for v in _split_args(qcol[1:-1])]
            queries = np.asarray(vec, np.float32)[None, :]
            literal_rows = (next(iter(tab.values())).shape[0] if tab else 1)
        elif qcol in tab:
            queries = np.asarray(tab[qcol], dtype=np.float32)
        else:
            raise InvalidInputError(f"unknown column {qcol} in table {table}")

        if fn == "faiss_search":
            params = _parse_literal(toks[3]) if len(toks) > 3 else None
            res = api.faiss_search(name, k, queries, params,
                                   catalog=self.catalog)
        else:
            filt = _parse_literal(toks[3])
            idsel = _parse_literal(toks[4])
            tname = _parse_literal(toks[5])
            params = _parse_literal(toks[6]) if len(toks) > 6 else None
            f = (api.faiss_search_filter if fn == "faiss_search_filter"
                 else api.faiss_search_filter_set)
            res = f(name, k, queries, filt, idsel, tname, params,
                    catalog=self.catalog, database=self.database)

        if literal_rows is not None:
            res = np.broadcast_to(res, (literal_rows,) + res.shape[1:])

        extra_cols = []
        if passthrough:
            for c in _split_args(passthrough):
                c = c.strip()
                if c not in tab:
                    raise InvalidInputError(
                        f"unknown column {c} in table {table}")
                extra_cols.append((c, np.asarray(tab[c])))

        rows: list[dict[str, Any]] = []
        nq = res.shape[0]
        for qi in range(nq):
            if unnest:
                for r in range(k):
                    row = {c: v[qi] for c, v in extra_cols}
                    row.update(rank=int(res["rank"][qi, r]),
                               label=int(res["label"][qi, r]),
                               distance=float(res["distance"][qi, r]))
                    rows.append(row)
            else:
                row = {c: v[qi] for c, v in extra_cols}
                row["result"] = res[qi]
                rows.append(row)
        return rows


def connect(catalog: Catalog | None = None,
            database: Database | None = None) -> Connection:
    return Connection(catalog, database)
