"""The port's multi-process tier (parallel/multihost.py, native/) against
the JAX package's: hash partitioning and the host merge equal to the JAX
package's, the native merge equal to its numpy plain version, the
partitioned index equal to one index, and the two-process gloo demo run
as a subprocess on the CPU under a time limit, on a port picked free at
run time.  Distances: rtol 1e-6 for the merges (the same floats moved),
1e-5 for the partitioned index against one index (K1's plain version on
other row blocks)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu.parallel import multihost as jmh
from duckdb_faiss_ext_tpu_torch.native import (library_path, load_native,
                                               merge_topk_reference)
from duckdb_faiss_ext_tpu_torch.parallel import multihost as pmh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = dt.config.device
    dt.set_device("cpu")
    yield
    dt.config.device = prev


@pytest.mark.parametrize("ids", [np.arange(100_000),
                                 np.random.default_rng(1).integers(
                                     0, 2**62, 50_000),
                                 np.arange(2**40, 2**40 + 5000) * 3])
@pytest.mark.parametrize("nparts", [2, 8])
def test_hash_partition_matches_jax(ids, nparts):
    ids = np.asarray(ids, np.int64)
    parts = pmh.hash_partition(ids, nparts)
    np.testing.assert_array_equal(parts, jmh.hash_partition(ids, nparts))
    counts = np.bincount(parts, minlength=nparts)
    assert counts.min() > ids.size / nparts * 0.9
    owned = sum(pmh.local_rows(ids, nparts, p).astype(int)
                for p in range(nparts))
    assert (owned == 1).all()


def _sorted_lists(rng, s, nq, k, descending, holes=True):
    d = np.sort(rng.random((s, nq, k)).astype(np.float32), axis=2)
    if descending:
        d = d[:, :, ::-1].copy()
    labels = rng.integers(0, 10_000, (s, nq, k)).astype(np.int64)
    if holes:
        labels[0, :, 3:] = -1                 # shard 0 found only 3
        d[0, :, 3:] = -np.inf if descending else np.inf
    return d, labels


@pytest.mark.parametrize("metric,descending", [("L2", False),
                                               ("INNER_PRODUCT", True)])
def test_merge_host_topk_matches_jax(metric, descending):
    rng = np.random.default_rng(9)
    d, labels = _sorted_lists(rng, 4, 6, 5, descending)
    got = pmh.merge_host_topk(d, labels, metric)
    want = jmh.merge_host_topk(d, labels, metric)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("s,nq,k,descending,ties", [
    (3, 4, 6, False, False), (8, 16, 10, True, False), (1, 5, 4, False, False),
    (5, 7, 3, True, True), (64, 2, 8, False, True)])
def test_native_merge_matches_numpy(s, nq, k, descending, ties):
    """The native S-way merge equals the numpy plain version, ties to the
    lower shard included."""
    rng = np.random.default_rng(s * 100 + k)
    d, labels = _sorted_lists(rng, s, nq, k, descending, holes=s > 1)
    if ties:
        d = np.round(d * 4) / 4          # many equal distances across shards
        d = np.sort(d, axis=2)[:, :, ::-1] if descending else np.sort(d, 2)
        d = np.ascontiguousarray(d)
        labels[labels < 0] = 0
    got = load_native().merge_topk(d, labels, descending)
    want = merge_topk_reference(d, labels, descending)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_merge_k_below_the_lists():
    rng = np.random.default_rng(4)
    d, labels = _sorted_lists(rng, 4, 3, 8, False, holes=False)
    got = pmh.merge_host_topk(d, labels, "L2", k=3)
    want = merge_topk_reference(d, labels, False, k=3)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].shape == (3, 3)


def test_native_library_named_by_source_hash():
    assert library_path().name.startswith("libdfx_native_")
    assert library_path().parent.name == "build"
    load_native()
    assert library_path().exists()


def test_partitioned_index_matches_single_and_jax():
    import duckdb_faiss_ext_tpu as dfx  # noqa: F401  (the JAX package)
    from duckdb_faiss_ext_tpu.factory import build_index as jbuild
    from duckdb_faiss_ext_tpu.metrics import resolve_metric as jmetric
    from duckdb_faiss_ext_tpu_torch.factory import build_index
    from duckdb_faiss_ext_tpu_torch.metrics import resolve_metric

    rng = np.random.default_rng(3)
    d, n, nq, k = 16, 2000, 6, 8
    xb = rng.standard_normal((n, d)).astype(np.float32)
    ids = np.arange(n, dtype=np.int64) * 3 + 11
    xq = rng.standard_normal((nq, d)).astype(np.float32)
    metric = resolve_metric("L2")
    single = build_index(d, "IDMap,Flat", metric)
    single.add_with_ids(xb, ids)
    ref = single.search(xq, k)
    part = pmh.PartitionedIndex([build_index(d, "IDMap,Flat", metric)
                                 for _ in range(4)])
    part.add_with_ids(xb, ids)
    assert part.ntotal == n
    got = part.search(xq, k)
    np.testing.assert_allclose(got.distances, ref.distances, rtol=1e-5)
    np.testing.assert_array_equal(got.labels, ref.labels)
    jpart = jmh.PartitionedIndex([jbuild(d, "IDMap,Flat", jmetric("L2"))
                                  for _ in range(4)])
    jpart.add_with_ids(xb, ids)
    want = jpart.search(xq, k)
    np.testing.assert_allclose(got.distances, want.distances, rtol=1e-5)
    np.testing.assert_array_equal(got.labels, want.labels)
    # Each member holds its hash partition.
    for p, member in enumerate(part.members):
        np.testing.assert_array_equal(
            np.sort(member.row_labels()),
            np.sort(ids[pmh.hash_partition(ids, 4) == p]))


def test_partitioned_index_add_and_errors():
    from duckdb_faiss_ext_tpu_torch.factory import build_index
    from duckdb_faiss_ext_tpu_torch.metrics import resolve_metric

    with pytest.raises(ValueError, match="at least one member"):
        pmh.PartitionedIndex([])
    m = resolve_metric("L2")
    with pytest.raises(ValueError, match="dimensions differ"):
        pmh.PartitionedIndex([build_index(8, "IDMap,Flat", m),
                              build_index(16, "IDMap,Flat", m)])
    part = pmh.PartitionedIndex([build_index(8, "IDMap,Flat", m)
                                 for _ in range(3)])
    xb = np.random.default_rng(0).standard_normal((300, 8)).astype(np.float32)
    part.add(xb)
    res = part.search(xb[:5], 1)
    np.testing.assert_array_equal(res.labels[:, 0], np.arange(5))


def test_init_multihost_is_a_noop_without_an_address():
    pmh.init_multihost()
    assert pmh.local_rows(np.arange(10)).all()   # one process owns all


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_demo():
    """The demo's two gloo ranks each search their hash half; the native
    merge of their k-lists equals one process's search."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, DFX_DEMO_PORT=str(_free_port()))
    out = subprocess.run(
        [sys.executable, "-m",
         "duckdb_faiss_ext_tpu_torch.parallel.multihost_demo", "--cpu",
         "--n", "20000", "--d", "32", "--timeout", "100"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "MULTIHOST OK" in out.stdout, out.stdout[-2000:]
