"""Interactive SQL shell for the engine (the reference's `duckdb` shell
analogue, README.md:27-39).

    python -m duckdb_faiss_ext_tpu_torch

Indexes live on the card (``config.device``); ``--cpu`` runs the shell on
the CPU with the kernels' plain versions.

Extra dot-commands beyond the SQL surface:
    .tables                       list registered tables
    .indexes                      list catalog indexes
    .stats                        per-index metadata + op timings
    .read_csv <table> <path>      register a CSV as a table: column0 is the
                                  id, remaining columns become the vector
                                  column 'data' (matches the reference's
                                  test corpus layout, test/sql/training.csv)
    .quit
"""

from __future__ import annotations

import sys

import numpy as np

from .catalog import GLOBAL_CATALOG
from .errors import InvalidInputError
from .sql.dispatch import connect
from .utils.config import set_device


def load_csv_table(con, name: str, path: str) -> None:
    raw = np.loadtxt(path, delimiter=",", dtype=np.float64)
    if raw.ndim == 1:
        raw = raw[None, :]
    con.register(name, {
        "column0": raw[:, 0].astype(np.int64),
        "id": raw[:, 0].astype(np.int64),
        "data": raw[:, 1:].astype(np.float32),
    })
    print(f"registered table {name}: {raw.shape[0]} rows, "
          f"vector dim {raw.shape[1] - 1}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--cpu" in argv:
        set_device("cpu")
    con = connect(catalog=GLOBAL_CATALOG)
    print("duckdb_faiss_ext_tpu_torch shell — SQL statements or .help")
    while True:
        try:
            line = input("D ").strip()
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        if not line:
            continue
        try:
            if line.startswith("."):
                cmd, *rest = line.split()
                if cmd in (".quit", ".exit"):
                    return 0
                if cmd == ".help":
                    print(__doc__)
                elif cmd == ".tables":
                    print(sorted(con.database._tables))
                elif cmd == ".indexes":
                    print(con.catalog.names())
                elif cmd == ".stats":
                    from .api import faiss_stats

                    import json as _json
                    print(_json.dumps(
                        faiss_stats(catalog=con.catalog), indent=2,
                        default=str))
                elif cmd == ".read_csv" and len(rest) == 2:
                    load_csv_table(con, rest[0], rest[1])
                else:
                    print(f"unknown command {line}")
                continue
            result = con.execute(line)
            if result is None:
                print("OK")
            elif isinstance(result, list):
                for row in result[:100]:
                    print(row)
                if len(result) > 100:
                    print(f"... ({len(result)} rows)")
        except InvalidInputError as e:
            print(f"Invalid Input Error: {e}")
        except Exception as e:  # noqa: BLE001 — shell must not die
            print(f"Error: {type(e).__name__}: {e}")


if __name__ == "__main__":
    sys.exit(main())
