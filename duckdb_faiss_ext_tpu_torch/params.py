"""Hierarchical string→string parameter maps.

The reference passes search/create parameters as DuckDB ``MAP(VARCHAR,
VARCHAR)`` values, resolved by linear scan (src/maputils.cpp:10-31), with
hierarchical dotted prefixes that recurse through composite indexes: an IVF
index consumes ``nprobe`` and forwards every ``quantiser.``-prefixed key to its
coarse quantizer with the prefix stripped (src/faiss_extension.cpp:675-689).

We model this as a thin immutable view over a plain dict with prefix scoping.
All values are strings (as in SQL) and parsed on demand; a failed parse raises
InvalidInputError, mirroring the reference's stoi catch-and-rethrow
(src/faiss_extension.cpp:682,695).
"""

from __future__ import annotations

from typing import Iterator, Mapping

from .errors import InvalidInputError


class ParamMap(Mapping[str, str]):
    def __init__(self, raw: Mapping[str, object] | None = None, _prefix: str = ""):
        self._raw = {str(k): str(v) for k, v in (raw or {}).items()}
        self._prefix = _prefix

    # Mapping interface over the *current scope* (prefix stripped).
    def __getitem__(self, key: str) -> str:
        return self._raw[self._prefix + key]

    def __iter__(self) -> Iterator[str]:
        p = self._prefix
        for k in self._raw:
            if k.startswith(p):
                yield k[len(p):]

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def scoped(self, prefix: str) -> "ParamMap":
        """Sub-map for a nested index, e.g. ``params.scoped('quantiser.')``."""
        return ParamMap(self._raw, self._prefix + prefix)

    def get_str(self, key: str, default: str | None = None) -> str | None:
        return self._raw.get(self._prefix + key, default)

    def get_int(self, key: str, default: int | None = None) -> int | None:
        v = self.get_str(key)
        if v is None:
            return default
        try:
            return int(v)
        except ValueError:
            raise InvalidInputError(
                f"Invalid integer value for parameter {key}: {v}"
            ) from None

    def get_float(self, key: str, default: float | None = None) -> float | None:
        v = self.get_str(key)
        if v is None:
            return default
        try:
            return float(v)
        except ValueError:
            raise InvalidInputError(
                f"Invalid float value for parameter {key}: {v}"
            ) from None

    def __repr__(self) -> str:  # pragma: no cover
        return f"ParamMap({dict(self)!r}, prefix={self._prefix!r})"


EMPTY = ParamMap()


def as_params(params: Mapping[str, object] | ParamMap | None) -> ParamMap:
    if params is None:
        return EMPTY
    if isinstance(params, ParamMap):
        return params
    return ParamMap(params)
