"""Flags and helpers the command-line tools share."""

from __future__ import annotations

from ..utils.config import set_device


def add_device_flag(ap) -> None:
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain torch versions); the "
                         "CUDA card otherwise, and no card is an error")


def select_device(args) -> None:
    """The card unless ``--cpu``; raises when the card is asked for and
    torch sees none."""
    set_device("cpu" if args.cpu else "cuda")


def parse_kv(text: str | None) -> dict | None:
    """'a=1,b=2' → {'a': '1', 'b': '2'}; None stays None."""
    if not text:
        return None
    return dict(kv.split("=", 1) for kv in text.split(","))
