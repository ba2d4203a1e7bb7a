"""Exception types mirroring the reference extension's observable error API.

The reference (duckdb-faiss-ext) surfaces every user-facing failure as a DuckDB
``InvalidInputException`` with a specific message; several of those messages are
asserted verbatim by its SQLLogicTests (e.g. test/sql/faiss4.test:22).  We keep
the same message text so parity tests can assert it.

Reference: src/faiss_extension.cpp:151,194,261,350,401,445,486,524.
"""

from __future__ import annotations


class InvalidInputError(ValueError):
    """Equivalent of DuckDB's InvalidInputException (the only error kind the
    reference extension throws)."""


def index_already_exists(name: str) -> InvalidInputError:
    # src/faiss_extension.cpp:151
    return InvalidInputError(f"Index {name} already exists.")


def index_not_found(name: str) -> InvalidInputError:
    # src/faiss_extension.cpp:194,230,261,345,...
    return InvalidInputError(f"Could not find index {name}.")


def unknown_metric(metric: str) -> InvalidInputError:
    # src/faiss_extension.cpp:90
    return InvalidInputError(f"Unknown metric type: {metric}")


def unknown_named_parameter(key: str) -> InvalidInputError:
    # src/faiss_extension.cpp:117
    return InvalidInputError(f"Unknown named parameter: {key}")


def need_list_type() -> InvalidInputError:
    # src/faiss_extension.cpp:270
    return InvalidInputError("Need list type for embeddings vectors")


def bad_vector_length(dimension: int, got: int, at_index: int) -> InvalidInputError:
    # src/faiss_extension.cpp:280
    return InvalidInputError(
        f"All list vectors need to have length {dimension}, got {got} at index {at_index}"
    )


def add_with_ids_unsupported() -> InvalidInputError:
    # src/faiss_extension.cpp:524 (asserted by test/sql/faiss4.test:22)
    return InvalidInputError(
        "Unable to add data: This type of index does not support adding with IDs. "
        "Consider prefixing the index string with IDMap when creating the index."
    )


def add_error(msg: str) -> InvalidInputError:
    # src/faiss_extension.cpp:528
    return InvalidInputError(f"Unable to add data: {msg}")


def no_device_ingest(name: str) -> InvalidInputError:
    # faiss_add_device has no reference analogue
    return InvalidInputError(
        f"index {name} does not support device-resident ingest "
        f"(IVF with Flat/SQ8/SQ4 storage, Flat, HNSW and NSG do, "
        f"also under IDMap)")


def immutable_add() -> InvalidInputError:
    # src/faiss_extension.cpp:486
    return InvalidInputError(
        "Attempted to add to an immutable index. Indexes are marked immutable if they are "
        "loaded from disk and don't need training."
    )


def immutable_train() -> InvalidInputError:
    # src/faiss_extension.cpp:350
    return InvalidInputError(
        "Attempted to train to an immutable index. Indexes are marked immutable if they are "
        "loaded from disk and don't need training."
    )


def mixing_labels(with_labels_now: bool) -> InvalidInputError:
    # src/faiss_extension.cpp:445,449
    if with_labels_now:
        return InvalidInputError(
            "Tried to insert data with labels, when index was previously added without labels. "
            "Cannot mix index data with and without labels"
        )
    return InvalidInputError(
        "Tried to insert data without labels, when index was previously added with labels. "
        "Cannot mix index data with and without labels"
    )


class TrainingTooSmallError(InvalidInputError):
    """Raised by trainable models when n_points < n_clusters; the API layer
    re-formats it with the reference's wrapper text (with the index name on
    the add path, without on the manual-train path —
    src/faiss_extension.cpp:401,593)."""

    def __init__(self, n_points: int, n_clusters: int):
        self.n_points = n_points
        self.n_clusters = n_clusters
        super().__init__(
            f"Number of training points ({n_points}) should be at least as "
            f"large as number of clusters ({n_clusters})"
        )


def too_few_training_points(err: TrainingTooSmallError,
                            name: str | None = None) -> InvalidInputError:
    # src/faiss_extension.cpp:401 (manual train, no name) and :593 (add path,
    # "Index %s needs ..."); both wrap the FAISS nx >= k complaint.
    prefix = f"Index {name} needs" if name else "Index needs"
    return InvalidInputError(
        f"{prefix} to be trained, but amount of datapoints is too small. "
        f"Considere adding more data. ({err})"
    )


def training_error(msg: str) -> InvalidInputError:
    # src/faiss_extension.cpp:406,598
    return InvalidInputError(f"Error occured while training index: {msg}")


def search_error(msg: str) -> InvalidInputError:
    # src/faiss_extension.cpp:635
    return InvalidInputError(f"Error occured while searching: {msg}")


def filter_query_error(msg: str) -> InvalidInputError:
    # src/faiss_extension.cpp:951,998 (typo "uable" is part of the reference API)
    return InvalidInputError(f"uable to execute filter query: {msg}")


def not_available(what: str) -> InvalidInputError:
    # A part of the JAX package this port does not have yet.
    return InvalidInputError(
        f"{what} is not yet available in duckdb_faiss_ext_tpu_torch")
