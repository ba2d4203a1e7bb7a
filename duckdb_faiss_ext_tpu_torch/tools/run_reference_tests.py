"""Execute the reference's SQLLogicTest suite against this engine.

    python -m duckdb_faiss_ext_tpu_torch.tools.run_reference_tests \\
        /path/to/reference/test/sql [--cpu]

Prints per-file block counts and exits non-zero on any failure."""

from __future__ import annotations

import argparse
import glob
import os
import sys

from ..sql.logictest import run_file
from ._cli import add_device_flag, select_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", help="directory of the reference's .test files "
                                 "(its test/sql)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    select_device(args)

    files = sorted(glob.glob(os.path.join(args.root, "*.test")))
    if not files:
        print(f"no .test files found under {args.root}", file=sys.stderr)
        return 2
    total = passed = 0
    rc = 0
    for path in files:
        try:
            results = run_file(path, args.root)
        except Exception as e:  # noqa: BLE001 — per-file isolation
            print(f"FAIL {os.path.basename(path)}: runner error: "
                  f"{type(e).__name__}: {e}")
            rc = 1
            continue
        fails = [(line, kind, f) for line, kind, f in results if f]
        total += len(results)
        passed += len(results) - len(fails)
        print(("PASS" if not fails else "FAIL"),
              f"{os.path.basename(path)}: "
              f"{len(results) - len(fails)}/{len(results)}")
        for line, kind, f in fails:
            print(f"   line {line} {kind}: {f}")
            rc = 1
    print(f"TOTAL {passed}/{total}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
