"""Versioned index checkpoint format.

The analogue of faiss::write_index / read_index as the reference uses them
(src/faiss_extension.cpp:199,234).  Format: a single .npz holding every array
of the index graph's state_dict (nested dicts flattened with '/'-joined keys)
plus a JSON header with the factory description, metric, and lifecycle flags.
Rebuilding goes back through the factory parser, so a loaded index has the
same graph shape as a freshly created one.

Lifecycle rule mirrored from the reference: a loaded, already-trained index
is immutable (isMutable = needs_training, src/faiss_extension.cpp:238;
rationale src/include/index.hpp:20-25).  Index state is not tied to any
database persistence (design note src/faiss_extension.cpp:183-187).
"""

from __future__ import annotations

import json

import numpy as np

from ..catalog import IndexEntry
from ..errors import InvalidInputError
from ..factory import build_index
from ..metrics import resolve_metric

FORMAT_VERSION = 1
_MAGIC = "dfx-tpu-index"


def _flatten(tree: dict, prefix: str, out: dict) -> None:
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            _flatten(value, path, out)
        else:
            out[path] = np.asarray(value)


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def save_index(entry: IndexEntry, path: str) -> None:
    index = entry.index
    header = {
        "magic": _MAGIC,
        "version": FORMAT_VERSION,
        "factory": index.factory_desc,
        "d": index.d,
        "metric": index.metric.name,
        "metric_arg": index.metric_arg,
        "is_trained": bool(index.is_trained),
    }
    arrays: dict[str, np.ndarray] = {}
    _flatten(index.state_dict(), "state", arrays)
    arrays["__header__"] = np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8)
    # Write through a file object so the exact path is used (np.savez would
    # otherwise append ".npz").
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_index(path: str) -> IndexEntry:
    try:
        with np.load(path, allow_pickle=False) as npz:
            arrays = {k: npz[k] for k in npz.files}
    except (OSError, ValueError) as e:
        raise InvalidInputError(f"Could not read index file {path}: {e}") \
            from None
    header_arr = arrays.pop("__header__", None)
    if header_arr is None:
        raise InvalidInputError(f"File {path} is not a saved index")
    header = json.loads(header_arr.tobytes().decode())
    if header.get("magic") != _MAGIC:
        raise InvalidInputError(f"File {path} is not a saved index")
    if header.get("version", 0) > FORMAT_VERSION:
        raise InvalidInputError(
            f"Index file {path} has unsupported version {header['version']}")

    metric = resolve_metric(header["metric"])
    index = build_index(int(header["d"]), header["factory"], metric,
                        float(header.get("metric_arg", 0.0)))
    state = _unflatten(arrays).get("state", {})
    index.load_state(state)

    # Loaded trained index → immutable (src/faiss_extension.cpp:238).
    needs_training = not index.is_trained
    return IndexEntry(index=index, needs_training=needs_training,
                      is_mutable=needs_training)
