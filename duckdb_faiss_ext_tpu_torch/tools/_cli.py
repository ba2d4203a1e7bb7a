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


#: (name, module under ops/, counter) of every kernel wrapper's launch
#: count: each adds one where it launches its kernel, never on the CPU
COUNTERS = (
    ("K1", "flat_topk", "LAUNCHES"),
    ("K6", "ivf_list_scan", "TOPK_LAUNCHES"),
    ("K6 raw", "ivf_list_scan", "LAUNCHES"),
    ("K7", "ivf_pairs", "TOPK_LAUNCHES"),
    ("K7 raw", "ivf_pairs", "LAUNCHES"),
    ("K10", "ivf_pairs_mega", "TOPK_LAUNCHES"),
    ("K10 raw", "ivf_pairs_mega", "LAUNCHES"),
    ("K8", "ivf_pq_scan", "LAUNCHES"),
    ("K2", "ivf_sq_scan", "TOPK_LAUNCHES"),
    ("K2 raw", "ivf_sq_scan", "LAUNCHES"),
    ("K3", "ivf_sq_pairs", "LAUNCHES"),
    ("K9", "ivf_sq_pairs_mega", "LAUNCHES"),
    ("K5", "sq_spill", "LAUNCHES"),
    ("K5 rescore", "sq_spill", "RESCORE_LAUNCHES"),
)


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel."""
    import importlib

    return {name: getattr(importlib.import_module(
        f"duckdb_faiss_ext_tpu_torch.ops.{mod}"), attr)
        for name, mod, attr in COUNTERS}


def launches_since(before: dict) -> dict:
    """The kernels launched since ``before`` (a ``launch_counts()``), with
    their counts."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def describe_launches(launched: dict) -> str:
    return (", ".join(f"{k} {v}" for k, v in launched.items())
            or "no kernel launch")
