"""Device-resident ingest of Flat storage (``FlatIndex.add_device``,
through ``faiss_add_device``), the graph build's int32 reverse lists and
its reachability rule, and the graph tier's spans and counters, on the
CPU.

* ``Flat``, ``HNSW32`` and ``IDMap,HNSW32`` filled by ``faiss_add_device``
  in chunks hold the same rows and labels as the host path, and answer
  bit for bit as it does; a chunk past ``expected_total`` raises, and an
  index without device ingest is refused by name;
* a device-ingested ``IDMap,HNSW32`` saves its rows and graph, loads
  without a rebuild, and loads into the JAX package with the same keys;
* ``augment_graph`` against the one-sort rule it replaced, byte for byte,
  on k-NN lists with repeats, -1 and self-edges;
* past ``graph_max`` the clustered build's prune leaves room for reverse
  edges: fewer rows no adjacency row names than under the forward-only
  rule, and the walk seeds from a denser scan, so that a cluster the
  graph does not link to the rest is still entered;
* an HNSW search's spans nest under one root, the build's stages inside
  the first search's dispatch; a sharded walk is spanned and counted too.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import duckdb_faiss_ext_tpu as dfx
import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu_torch.models.hnsw import HNSWIndex
from duckdb_faiss_ext_tpu_torch.ops import graph as graph_ops
from duckdb_faiss_ext_tpu_torch.utils import profiling

from benchmark import spans
from benchmark.reference.hnsw import unreachable_share

D = 16


@pytest.fixture(autouse=True)
def cpu_one_thread():
    """The port on the CPU, on one torch thread: the test workers share
    the cores."""
    prev, threads = dt.config.device, torch.get_num_threads()
    dt.set_device("cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    dt.config.device = prev


def rows(n, d=D, seed=0, centers=32):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32) * 4
    return (c[rng.integers(0, centers, n)]
            + rng.standard_normal((n, d)).astype(np.float32) * 0.3)


def create(cat, name, factory, threshold=500):
    dt.faiss_create_params(name, D, factory, {"ann_threshold": str(threshold)},
                           catalog=cat, metric_type="L2")
    return cat.get(name).index


def fill_both(factory, xb, ids=None, chunk=700):
    """(host catalog, device catalog): one filled by faiss_add, the other
    by faiss_add_device in chunks sized by expected_total."""
    host, dev = dt.Catalog(), dt.Catalog()
    create(host, "i", factory)
    create(dev, "i", factory)
    dt.faiss_add(xb if ids is None else (ids, xb), "i", catalog=host)
    for s in range(0, len(xb), chunk):
        dt.faiss_add_device(torch.from_numpy(xb[s:s + chunk]), "i",
                            None if ids is None else ids[s:s + chunk],
                            expected_total=len(xb) if s == 0 else None,
                            catalog=dev)
    return host, dev


@pytest.mark.parametrize("factory", ["Flat", "HNSW32", "IDMap,HNSW32"])
def test_add_device_answers_as_the_host_path(factory):
    xb = rows(3000, seed=1)
    ids = (np.arange(3000, dtype=np.int64) * 7 + 11
           if factory.startswith("IDMap") else None)
    host, dev = fill_both(factory, xb, ids)
    before = profiling.counters()["models.rows_device_adds"]
    hi, di = host.get("i").index, dev.get("i").index
    assert di.ntotal == hi.ntotal == 3000
    inner = getattr(di, "inner", di)
    assert inner.device_vectors().shape == (3000, D)   # no capacity bucket
    assert inner.vectors().tobytes() == xb.tobytes()
    if ids is not None:
        np.testing.assert_array_equal(di.row_labels(), ids)
    xq = rows(40, seed=2)
    for params in ({"efSearch": "32"}, {"exact": "true"}):
        want = dt.faiss_search("i", 7, xq, params, catalog=host)
        got = dt.faiss_search("i", 7, xq, params, catalog=dev)
        assert got.tobytes() == want.tobytes()
    if factory != "Flat":
        assert inner.graph.tobytes() == getattr(hi, "inner", hi).graph.tobytes()
        assert not inner.graph.flags.writeable
    # a chunk past the buffer that expected_total sized
    extra = rows(5, seed=3)
    with pytest.raises(dt.InvalidInputError, match="pass the 3000"):
        dt.faiss_add_device(torch.from_numpy(extra), "i",
                            None if ids is None else ids[:5], catalog=dev)
    assert profiling.counters()["models.rows_device_adds"] == before
    assert di.ntotal == 3000


def test_expected_total_sizes_the_buffer_once():
    cat = dt.Catalog()
    idx = create(cat, "f", "HNSW32")
    xb = rows(1000, seed=4)
    dt.faiss_add_device(torch.from_numpy(xb[:300]), "f", expected_total=1000,
                        catalog=cat)
    buf = idx.device_vectors()
    assert buf.shape == (1000, D) and idx.ntotal == 300
    dt.faiss_add(xb[300:600], "f", catalog=cat)          # host rows, in place
    dt.faiss_add_device(xb[600:], "f", catalog=cat)       # numpy, moved there
    assert idx.device_vectors() is buf and idx.ntotal == 1000
    assert idx.vectors().tobytes() == xb.tobytes()
    np.testing.assert_array_equal(idx.reconstruct(777), xb[777])
    with pytest.raises(dt.InvalidInputError, match="pass the 1000"):
        dt.faiss_add_device(torch.from_numpy(xb[:1]), "f", catalog=cat)
    with pytest.raises(dt.InvalidInputError, match="must be"):
        dt.faiss_add_device(torch.zeros(3, D + 1), "f", catalog=cat)


def test_device_ingest_refusals():
    cat = dt.Catalog()
    dt.faiss_create("pq", D, "PQ4", catalog=cat)
    with pytest.raises(dt.InvalidInputError,
                       match="Flat, HNSW and NSG do, also under IDMap"):
        dt.faiss_add_device(torch.zeros(4, D), "pq", catalog=cat)
    dt.faiss_create("flat", D, "Flat", catalog=cat)
    dt.faiss_add(rows(10), "flat", catalog=cat)
    with pytest.raises(dt.InvalidInputError, match="holds no host rows"):
        dt.faiss_add_device(torch.zeros(4, D), "flat", catalog=cat)
    dt.faiss_create("flat2", D, "Flat", catalog=cat)
    with pytest.raises(dt.InvalidInputError, match="adding with IDs"):
        dt.faiss_add_device(torch.zeros(4, D), "flat2", np.arange(4),
                            catalog=cat)
    for name in ("idm", "idm2"):
        dt.faiss_create(name, D, "IDMap,HNSW32", catalog=cat)
    with pytest.raises(dt.InvalidInputError, match="without ids"):
        dt.faiss_add_device(torch.zeros(4, D), "idm", catalog=cat)
    with pytest.raises(dt.InvalidInputError, match="does not match"):
        dt.faiss_add_device(torch.zeros(4, D), "idm2", np.arange(3),
                            catalog=cat)
    dt.faiss_create("idpq", D, "IDMap,PQ4", catalog=cat)
    with pytest.raises(dt.InvalidInputError,
                       match="IDMap over .* Flat, HNSW and NSG do"):
        dt.faiss_add_device(torch.zeros(4, D), "idpq", np.arange(4),
                            catalog=cat)
    dt.faiss_create("flat3", D, "Flat", catalog=cat)
    for layout in ({"lmax": 64}, {"spill_capacity": 1024}):
        with pytest.raises(dt.InvalidInputError, match="IVF list layout"):
            dt.faiss_add_device(torch.zeros(4, D), "flat3", catalog=cat,
                                **layout)
    assert cat.get("flat3").index.ntotal == 0


@pytest.mark.parametrize("factory", ["Flat", "HNSW32", "IDMap,HNSW32"])
def test_a_device_ingested_index_refuses_a_placement(factory):
    """Rows that faiss_add_device took have no host copy to place from:
    faiss_to_device is refused and leaves them, and the graph, as they
    were; putting the index back on its device is a no-op."""
    from duckdb_faiss_ext_tpu_torch.parallel import sharded

    xb = rows(1500, seed=12)
    ids = (np.arange(1500, dtype=np.int64) * 3 + 5
           if factory.startswith("IDMap") else None)
    host, dev = fill_both(factory, xb, ids)
    xq = rows(20, seed=13)
    want = dt.faiss_search("i", 5, xq, {"efSearch": "32"}, catalog=host)
    assert dt.faiss_search("i", 5, xq, {"efSearch": "32"},
                           catalog=dev).tobytes() == want.tobytes()
    inner = getattr(dev.get("i").index, "inner", dev.get("i").index)
    with pytest.raises(dt.InvalidInputError, match="cannot be placed"):
        dt.faiss_to_device("i", sharded.make_mesh(2), catalog=dev)
    inner.set_placement(None)
    assert inner.vectors().tobytes() == xb.tobytes()
    assert inner.device_vectors().shape == (1500, D)
    assert dt.faiss_search("i", 5, xq, {"efSearch": "32"},
                           catalog=dev).tobytes() == want.tobytes()


def test_save_load_carries_the_graph(tmp_path):
    """A device-ingested IDMap,HNSW32 saves its rows, labels and graph;
    the port loads it without a rebuild, and the JAX package reads the
    same keys."""
    xb = rows(3000, seed=5)
    ids = np.arange(3000, dtype=np.int64)[::-1] * 3
    _, dev = fill_both("IDMap,HNSW32", xb, ids)
    xq = rows(24, seed=6)
    want = dt.faiss_search("i", 5, xq, {"efSearch": "32"}, catalog=dev)
    graph = dev.get("i").index.inner.graph.copy()
    path = str(tmp_path / "h.dfx")
    dt.faiss_save("i", path, catalog=dev)
    builds = profiling.counters()["models.graph_builds"]
    cat = dt.Catalog()
    dt.faiss_load("l", path, catalog=cat)
    loaded = cat.get("l").index
    assert loaded.inner.graph.tobytes() == graph.tobytes()
    got = dt.faiss_search("l", 5, xq, {"efSearch": "32"}, catalog=cat)
    assert got.tobytes() == want.tobytes()
    assert profiling.counters()["models.graph_builds"] == builds
    jcat = dfx.Catalog()
    dfx.faiss_load("j", path, catalog=jcat)
    jidx = jcat.get("j").index
    np.testing.assert_array_equal(np.asarray(jidx._labels), ids)
    np.testing.assert_array_equal(np.asarray(jidx.inner._xb), xb)
    adj, indexed = jidx.inner._graph[:2]
    assert indexed == 3000
    np.testing.assert_array_equal(np.asarray(adj), graph)


def one_sort_augment(knn: torch.Tensor, degree: int, fkeep=None):
    """The rule ``augment_graph`` kept before its reverse lists went
    blocked: one stable sort of every edge by (destination, rank)."""
    n, kd = knn.shape
    fkeep = max(1, min(degree, degree if fkeep is None else fkeep))
    dst = knn.reshape(-1).long()
    keep = dst >= 0
    src = torch.arange(n).repeat_interleave(kd)[keep]
    rank = torch.arange(kd).repeat(n)[keep]
    dst = dst[keep]
    order = torch.sort(dst * kd + rank, stable=True)[1]
    dst, src = dst[order], src[order]
    pos = torch.arange(dst.shape[0]) - torch.searchsorted(
        dst, torch.arange(n))[dst]
    slot = pos < degree
    rev = torch.full((n, degree), -1, dtype=torch.long)
    rev[dst[slot], pos[slot]] = src[slot]
    fwd = knn.long()
    cand = torch.cat([fwd[:, :fkeep], rev, fwd[:, fkeep:]], 1)
    cand = cand.masked_fill(cand == torch.arange(n)[:, None], -1)
    keep_mask = graph_ops.first_occurrence(cand) & (cand >= 0)
    w = cand.shape[1]
    col = torch.arange(w).expand(n, w)
    take = torch.sort(torch.where(keep_mask, col, w + 1), dim=1,
                      stable=True)[1][:, :degree]
    return torch.where(keep_mask.gather(1, take), cand.gather(1, take),
                       -1).to(torch.int32)


@pytest.mark.parametrize("n,kd,deg,fkeep,block", [
    (500, 24, 16, None, 64), (500, 24, 16, 8, 64), (333, 40, 32, 16, 100),
    (64, 8, 16, 3, 1 << 18), (1200, 16, 8, 4, 256)])
def test_blocked_augment_is_the_one_sort_rule(monkeypatch, n, kd, deg, fkeep,
                                              block):
    """Repeats within a row, -1 holes and self-edges, a few hubs that many
    rows name, and blocks that do not divide the rows."""
    rng = np.random.default_rng(n + kd)
    hubs = rng.integers(0, n, 4)
    knn = rng.integers(0, n, (n, kd))
    at_hub = rng.random((n, kd)) < 0.2
    knn[at_hub] = hubs[rng.integers(0, 4, at_hub.sum())]
    knn[rng.random((n, kd)) < 0.1] = -1
    selfs = rng.random(n) < 0.3
    knn[selfs, rng.integers(0, kd, selfs.sum())] = np.nonzero(selfs)[0]
    knn[:, 1] = np.where(rng.random(n) < 0.2, knn[:, 0], knn[:, 1])
    knn = torch.from_numpy(knn.astype(np.int32))
    monkeypatch.setattr(graph_ops, "AUGMENT_BLOCK", block)
    got = graph_ops.augment_graph(knn, deg, fkeep)
    assert got.dtype == torch.int32
    assert got.numpy().tobytes() == one_sort_augment(
        knn, deg, fkeep).numpy().tobytes()


def test_clustered_prune_leaves_room_for_reverse_edges(monkeypatch):
    """At 20,000 rows past a lowered graph_max: the clustered build's
    rule leaves fewer rows that no adjacency row names than keeping every
    forward edge does (which the exact build keeps), and none here."""
    xb = torch.from_numpy(rows(20_000, d=8, seed=7, centers=256))
    knn = graph_ops.build_knn_graph_clustered(xb, 20_000, 32, "L2")
    knn = graph_ops.nn_descent_round(xb, knn, "L2", 8)
    deg = 16
    forward = unreachable_share(graph_ops.augment_graph(knn, deg).numpy(),
                                "cpu")
    rule = unreachable_share(graph_ops.augment_graph(
        knn, deg, graph_ops.clustered_fkeep(deg)).numpy(), "cpu")
    assert graph_ops.clustered_fkeep(deg) == deg - deg // 4
    assert forward > 0.005 and rule < forward / 10, (forward, rule)
    calls = []
    real = graph_ops.augment_graph
    monkeypatch.setattr(graph_ops, "augment_graph",
                        lambda k, d, f=None: calls.append(f) or real(k, d, f))
    graph_ops.build_graph(xb[:600], 600, 8, "L2")
    graph_ops.build_graph(xb[:600], 600, 8, "L2", exact_max=100)
    assert calls == [None, 6]


def test_a_cluster_apart_is_found_from_a_seed_inside_it():
    """Rows 1-8 form a cluster that no edge links to the rest: a walk
    whose strided seed scan passes them by returns none of them, one that
    samples a row of theirs returns them all."""
    n = 4096
    xb = torch.from_numpy(rows(n, d=D, seed=3, centers=1))
    xb[1:9] += 50.0
    apart = torch.arange(1, 9)
    rest = torch.cat([torch.tensor([0]), torch.arange(9, n)])
    graph = torch.empty((n, 2), dtype=torch.int32)
    for ring in (apart, rest):               # two rings, no edge between
        graph[ring, 0] = ring.roll(-1).int()
        graph[ring, 1] = ring.roll(1).int()
    xq = xb[1:9] + 0.01
    for nseed, found in ((n // 64, 0), (n // 4, 8)):
        _, pos = graph_ops.graph_search(xb, graph, xq, n, 8, "L2", pool=16,
                                        width=2, nseed=nseed)
        got = ((pos >= 1) & (pos <= 8)).sum(1)
        assert (got == found).all(), (nseed, got)
    assert graph_ops.clustered_seeds(8_841_823) == 138_153
    assert graph_ops.clustered_seeds(100_000) == graph_ops.WALK_SEEDS


def test_the_walk_takes_the_clustered_seeds_past_graph_max(monkeypatch):
    seen = []
    real = graph_ops.graph_search
    monkeypatch.setattr(graph_ops, "graph_search",
                        lambda *a, **k: seen.append(k["nseed"]) or real(*a,
                                                                        **k))
    monkeypatch.setattr(graph_ops, "clustered_seeds", lambda n: 12345)
    xb = rows(3000, seed=4)
    for graph_max in (5000, 1000):
        monkeypatch.setattr(HNSWIndex, "graph_max", graph_max)
        cat = dt.Catalog()
        create(cat, "i", "HNSW8")
        dt.faiss_add(xb, "i", catalog=cat)
        dt.faiss_search("i", 5, xb[:4], catalog=cat)
    assert seen == [graph_ops.WALK_SEEDS, 12345]


def test_the_clustered_build_drops_the_knn_graph(monkeypatch):
    """The clustered k-NN graph is gone before the second NN-descent
    round: a round holds its input and its output, never a third graph."""
    import weakref

    xb = torch.from_numpy(rows(3000, d=8, seed=14, centers=64))
    first, alive = [], []
    real_knn, real_round = (graph_ops.build_knn_graph_clustered,
                            graph_ops.nn_descent_round)

    def knn(*a, **k):
        out = real_knn(*a, **k)
        first.append(weakref.ref(out))
        return out

    def descent(x, g, *a, **k):
        alive.append(first[0]() is not None)
        return real_round(x, g, *a, **k)

    monkeypatch.setattr(graph_ops, "build_knn_graph_clustered", knn)
    monkeypatch.setattr(graph_ops, "nn_descent_round", descent)
    graph_ops.build_graph(xb, 3000, 8, "L2", exact_max=1000,
                          refine_rounds=3)
    assert alive == [True, False, False]


def tree(path) -> list:
    """The port's spans of a Chrome trace as nested (name, children)."""
    ev = json.loads(path.read_text())["traceEvents"]
    sp = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                 if e.get("cat") == "user_annotation"
                 and spans.layer_of(e["name"])),
                key=lambda t: (t[0], -t[1]))
    roots, stack = [], []
    for s, e, name in sp:
        while stack and not (s >= stack[-1][0] and e <= stack[-1][1]):
            stack.pop()
        node = (name, [])
        (stack[-1][2][1] if stack else roots).append(node)
        stack.append((s, e, node))
    return roots


def names(nodes) -> list:
    return [(n, names(c)) if c else n for n, c in nodes]


@pytest.mark.parametrize("case", ["warm", "cold", "clustered"])
def test_a_graph_search_nests_its_spans(tmp_path, monkeypatch, case):
    if case == "clustered":
        monkeypatch.setattr(HNSWIndex, "graph_max", 1000)
    cat = dt.Catalog()
    create(cat, "g", "IDMap,HNSW16")
    xb = rows(2000, seed=8)
    dt.faiss_add_device(torch.from_numpy(xb), "g", np.arange(2000) + 5,
                        catalog=cat)
    xq = rows(3, seed=9)
    if case == "warm":
        dt.faiss_search("g", 5, xq, {"efSearch": "16"}, catalog=cat)
    before = profiling.counters()
    path = tmp_path / "trace.json"
    with profiling.trace(str(path)):
        dt.faiss_search("g", 5, xq, {"efSearch": "16"}, catalog=cat)
    after = profiling.counters()
    stages = (["models.graph_knn", "models.graph_descent",
               "models.graph_augment"] if case == "clustered"
              else [("models.graph_knn", ["kernels.flat_topk"]),
                    "models.graph_augment"])
    build = ([] if case == "warm" else
             [("api.hnsw_graph_build", [("models.graph_build", stages)])])
    assert names(tree(path)) == [("api.faiss_search", [
        "api.args",
        ("models.dispatch", build + ["api.upload", "models.graph_walk"]),
        "api.fetch", "models.labels", "api.format"])]
    assert after["models.graph_walks"] - before["models.graph_walks"] == 1
    assert (after["models.graph_builds"]
            - before.get("models.graph_builds", 0)) == (case != "warm")


def test_a_sharded_walk_is_spanned_and_counted(tmp_path):
    """Under a placement the per-shard walks and their merge run inside
    one ``models.graph_walk`` span, counted as one walk."""
    from duckdb_faiss_ext_tpu_torch.parallel import sharded

    cat = dt.Catalog()
    create(cat, "s", "HNSW16")
    dt.faiss_add(rows(2000, seed=10), "s", catalog=cat)
    dt.faiss_to_device("s", sharded.make_mesh(2), catalog=cat)
    xq = rows(3, seed=11)
    dt.faiss_search("s", 5, xq, {"efSearch": "16"}, catalog=cat)   # builds
    before = profiling.counters()["models.graph_walks"]
    path = tmp_path / "trace.json"
    with profiling.trace(str(path)):
        dt.faiss_search("s", 5, xq, {"efSearch": "16"}, catalog=cat)
    assert profiling.counters()["models.graph_walks"] == before + 1
    flat = json.dumps(names(tree(path)))
    assert flat.count('"models.graph_walk"') == 1
    assert "models.graph_build" not in flat
