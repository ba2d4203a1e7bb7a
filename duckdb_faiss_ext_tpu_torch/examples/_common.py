"""The flags the examples share: the tools' device flag and ``--n``."""

from __future__ import annotations

import argparse

from ..tools._cli import add_device_flag, select_device  # noqa: F401


def parser(doc: str, n: int) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=n, help="corpus rows")
    add_device_flag(ap)
    return ap
