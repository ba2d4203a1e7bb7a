"""Minimal SQL tier: in-memory tables + filter-expression evaluation.

The reference lives inside DuckDB and re-enters SQL to evaluate filter
expressions (src/faiss_extension.cpp:946-948).  Standalone, the two-phase
plan is explicit: registered columnar tables and a vectorised expression
evaluator covering the expression subset the reference's filtered search
uses ('id%2==0', 'column0>100', 'rowid', arithmetic/comparison/boolean
operators).
"""

from .engine import Database, default_database, register_table

__all__ = ["Database", "default_database", "register_table"]
