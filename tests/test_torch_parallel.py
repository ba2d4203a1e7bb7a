"""The port's placement tier (parallel/, faiss_to_device) against the JAX
package's, on the CPU: the port's mesh repeats the CPU device where the
JAX package has 8 virtual CPU devices (tests/conftest.py).

Each family of tests/test_parallel.py is placed 8 ways in both packages:
the JAX index (trained by the JAX package where k-means is involved) is
carried into the port with ``from_reference`` before either is placed, so
both hold the same centroids and codes.  The port's placed search must
give the JAX package's placed labels, and its own unplaced labels and
distances exactly.  Tolerance against the JAX package: distances within
1e-4 relative and 1e-4 of the larger of the batch's largest |distance| and
|q|² absolute (the JAX sharded IVF scan sums (x - q)² where the port's
list scans expand the square, as tests/test_parallel.py allows 3e-4);
labels equal.
"""

import re

import numpy as np
import pytest
import torch

import duckdb_faiss_ext_tpu as dfx
import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu import errors as jerrors
from duckdb_faiss_ext_tpu.ops.selectors import SetSelector as JSetSelector
from duckdb_faiss_ext_tpu.parallel import sharded as jsh
from duckdb_faiss_ext_tpu_torch.io.convert import from_reference
from duckdb_faiss_ext_tpu_torch.ops.flat_search import finalize_scores
from duckdb_faiss_ext_tpu_torch.parallel import sharded as psh
from duckdb_faiss_ext_tpu_torch.parallel.placement import (Mesh, RowBlocks,
                                                           default_mesh)

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

RTOL = 1e-4


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = dt.config.device
    dt.set_device("cpu")
    yield
    dt.config.device = prev


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: many small ops, which torch's
    thread pool slows when test workers share the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def assert_agree(got, want, xq):
    """Distances within RTOL of the batch's scale, labels equal."""
    wd, gd = want["distance"], got["distance"]
    finite = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), finite)
    scale = max(float(np.abs(wd[finite]).max()) if finite.any() else 1.0,
                float((xq * xq).sum(1).max()))
    np.testing.assert_allclose(gd[finite], wd[finite], rtol=RTOL,
                               atol=RTOL * scale)
    np.testing.assert_array_equal(got["label"], want["label"])


def assert_same(got, want):
    """The port placed against the port unplaced: the same arithmetic on
    the same rows, so equal results."""
    np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_array_equal(got["distance"], want["distance"])


class Pair:
    """One index in both packages: the JAX one built and filled, the port's
    carried from it."""

    def __init__(self, name, desc, data, metric="L2", params=None):
        self.name, self.jcat, self.pcat = name, dfx.Catalog(), dt.Catalog()
        dfx.faiss_create_params(name, data[1].shape[1] if isinstance(
            data, tuple) else data.shape[1], desc, params or {},
            metric_type=metric, catalog=self.jcat)
        dfx.faiss_add(data, name, catalog=self.jcat)
        self.pcat.put(name, from_reference(self.jcat.get(name)))

    def search(self, k, xq, params=None, jsel=None, psel=None):
        return (dfx.faiss_search(self.name, k, xq, params, catalog=self.jcat,
                                 selector=jsel),
                dt.faiss_search(self.name, k, xq, params, catalog=self.pcat,
                                selector=psel))

    def place(self, n=8, batch_axis=1):
        dfx.faiss_to_device(self.name, jsh.make_mesh(n, batch_axis=batch_axis),
                            catalog=self.jcat)
        dt.faiss_to_device(self.name, psh.make_mesh(n, batch_axis=batch_axis),
                           catalog=self.pcat)

    def index(self):
        return self.pcat.get(self.name).index

    def check(self, k, xq, params=None, jsel=None, psel=None):
        """Search unplaced, place both 8 ways, search again: the port placed
        equals the port unplaced and agrees with the JAX package placed."""
        _, before = self.search(k, xq, params, jsel, psel)
        self.place()
        jafter, after = self.search(k, xq, params, jsel, psel)
        assert_same(after, before)
        assert_agree(after, jafter, xq)
        return after


def _clustered(n, d, seed, spread=0.3, ncent=8):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncent, d)).astype(np.float32) * 4
    return (centers[rng.integers(0, ncent, n)]
            + rng.standard_normal((n, d)).astype(np.float32) * spread)


# --- the sharded functions -------------------------------------------------

@pytest.mark.parametrize("metric,n_dev,batch_axis", [
    ("L2", 8, 2), ("INNER_PRODUCT", 8, 1), ("L2", 4, 4)])
def test_sharded_flat_search_matches_jax(metric, n_dev, batch_axis):
    """K1's plain version on every row block, merged, against the JAX
    package's shard_map scan (tests/test_parallel.py's first two cases)."""
    rng = np.random.default_rng(31)
    d, cap, n, nq, k = 32, 1024, 1000, 16, 7
    xb = np.zeros((cap, d), np.float32)
    xb[:n] = rng.standard_normal((n, d)).astype(np.float32)
    xq = rng.standard_normal((nq, d)).astype(np.float32)
    mesh = jsh.make_mesh(n_dev, batch_axis=batch_axis)
    nshards = n_dev // batch_axis
    fn = jsh.sharded_flat_search_fn(mesh, k=k, metric=metric,
                                    chunk=cap // nshards)
    jd, jp = fn(jax.device_put(xb, NamedSharding(mesh, P("shard", None))),
                jnp.int32(n),
                jax.device_put(xq, NamedSharding(mesh, P("batch", None))),
                jnp.float32(0.0))
    blocks = RowBlocks(psh.make_mesh(n_dev, batch_axis=batch_axis), xb, "cpu")
    s, p = psh.sharded_flat_search(blocks, n, torch.from_numpy(xq), k, metric)
    pd, pp = finalize_scores(s, p, metric)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))


def test_merge_ties_go_to_the_lower_shard():
    """Equal scores: the lower shard first, then the order within it (the
    JAX package's lax.top_k over the shard-major (nq, S·k) block)."""
    parts = [(torch.tensor([[3.0, 1.0]]), torch.tensor([[5, 7]])),
             (torch.tensor([[3.0, 2.0]]), torch.tensor([[1, 9]])),
             (torch.tensor([[float("-inf"), float("-inf")]]),
              torch.tensor([[-1, -1]]))]
    s, p = psh.merge_shard_topk(parts, 5, 1, "cpu")
    assert p.tolist() == [[5, 1, 9, 7, -1]]
    assert s[0, :4].tolist() == [3.0, 3.0, 2.0, 1.0]


@pytest.mark.parametrize("spherical", [False, True])
def test_sharded_kmeans_step_matches_jax(spherical):
    rng = np.random.default_rng(31)
    d, n, k = 8, 512, 4
    x = rng.standard_normal((n, d)).astype(np.float32)
    cents = rng.standard_normal((k, d)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[::7] = False
    mesh = jsh.make_mesh(8, batch_axis=2)
    step = jsh.sharded_kmeans_step_fn(mesh, k=k, spherical=spherical,
                                      precision=jax.lax.Precision.HIGHEST)
    want = np.asarray(step(
        jax.device_put(x, NamedSharding(mesh, P(("shard", "batch"), None))),
        jax.device_put(valid, NamedSharding(mesh, P(("shard", "batch")))),
        jnp.asarray(cents)))
    got = psh.sharded_kmeans_step(psh.make_mesh(8, batch_axis=2),
                                  torch.from_numpy(x), torch.from_numpy(valid),
                                  torch.from_numpy(cents), spherical=spherical)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_multichip_dryrun():
    psh.multichip_dryrun(8)


def test_sharded_ivf_search_matches_jax():
    """The raw sharded IVF search over LPT-free sub-layouts against the JAX
    package's sharded_ivf_search_fn (4 list shards x 2 query shards)."""
    from duckdb_faiss_ext_tpu_torch.ops.ivf_list_scan import ivf_list_search

    rng = np.random.default_rng(77)
    d, nlist, lmax, nq, k, nprobe = 16, 16, 128, 8, 5, 6
    counts = rng.integers(20, lmax, nlist).astype(np.int32)
    lists = np.zeros((nlist, lmax, d), np.float32)
    row_pos = np.full((nlist, lmax), -1, np.int32)
    nxt = 0
    for li in range(nlist):
        lists[li, :counts[li]] = rng.standard_normal(
            (counts[li], d)).astype(np.float32)
        row_pos[li, :counts[li]] = np.arange(nxt, nxt + counts[li])
        nxt += counts[li]
    cents = rng.standard_normal((nlist, d)).astype(np.float32)
    xq = rng.standard_normal((nq, d)).astype(np.float32)
    jmesh = jsh.make_mesh(8, batch_axis=2)
    fn = jsh.sharded_ivf_search_fn(jmesh, k=k, nprobe=nprobe, metric="L2",
                                   precision=jax.lax.Precision.HIGHEST)
    jd, jp = fn(
        jax.device_put(lists, NamedSharding(jmesh, P("shard", None, None))),
        jax.device_put(counts, NamedSharding(jmesh, P("shard"))),
        jax.device_put(row_pos, NamedSharding(jmesh, P("shard", None))),
        jnp.asarray(cents),
        jax.device_put(xq, NamedSharding(jmesh, P("batch", None))),
        jnp.float32(0.0))
    mesh = psh.make_mesh(8, batch_axis=2)
    ident = np.arange(nlist, dtype=np.int32)
    subs = psh.shard_lists(mesh, ident, lists, counts, row_pos, cents)
    s, p = psh.sharded_ivf_search(
        mesh, torch.from_numpy(cents), torch.from_numpy(xq), nprobe=nprobe,
        k=k, metric="L2", scan=lambda sh, dev, q, probe, kk: ivf_list_search(
            subs[sh][dev].payload, subs[sh][dev].counts,
            subs[sh][dev].row_pos, probe, q, None, k=kk, metric="L2"))
    pd, pp = finalize_scores(s, p, "L2")
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("seed,nlist,nshards", [(3, 64, 8), (5, 48, 4),
                                                (7, 4096, 4)])
def test_balanced_list_partition_matches_jax(seed, nlist, nshards):
    """The LPT perm list for list, on a front-loaded skew (a few huge lists
    first, a long tail): equal group cardinality, every list once, the
    spread far below a contiguous split."""
    rng = np.random.default_rng(seed)
    counts = np.concatenate([rng.integers(4000, 7500, 8),
                             rng.integers(100, 2000, nlist - 8)])
    perm = psh.balanced_list_partition(counts, nshards)
    np.testing.assert_array_equal(perm,
                                  jsh.balanced_list_partition(counts, nshards))
    assert perm.dtype == np.int32
    assert sorted(perm.tolist()) == list(range(nlist))
    npl = nlist // nshards
    loads = np.array([counts[perm[s * npl:(s + 1) * npl]].sum()
                      for s in range(nshards)], np.float64)
    contig = np.array([counts[s * npl:(s + 1) * npl].sum()
                       for s in range(nshards)], np.float64)
    assert loads.max() / loads.mean() < 1.3
    assert loads.max() < contig.max()


# --- faiss_to_device: Flat ---------------------------------------------------

def test_shard_entry_flat():
    rng = np.random.default_rng(31)
    xb = rng.standard_normal((500, 16)).astype(np.float32)
    pair = Pair("sh", "Flat", xb)
    _, before = pair.search(3, xb[:2])
    dfx.faiss_to_device("sh", catalog=pair.jcat)
    dt.faiss_to_device("sh", catalog=pair.pcat)   # every local device
    blocks = pair.index().device_vectors()
    assert isinstance(blocks, RowBlocks) and blocks.nshards == 1
    jafter, after = pair.search(3, xb[:2])
    assert_same(after, before)
    assert_agree(after, jafter, xb[:2])


@pytest.mark.parametrize("desc,metric", [("Flat", "L2"),
                                         ("IDMap,Flat", "INNER_PRODUCT"),
                                         ("Flat", "L1")])
def test_faiss_to_device_flat_families(desc, metric):
    """Placed 8 ways, filtered, after an add that fits the buffer and after
    one that grows it (the placement is sticky), and through range search
    and the rerank parameter, which read the blocks."""
    rng = np.random.default_rng(5)
    xb = rng.standard_normal((900, 16)).astype(np.float32)
    xq = xb[:6] + 0.01
    ids = np.arange(900, dtype=np.int64) * 3
    data = (ids, xb) if desc.startswith("IDMap") else xb
    pair = Pair("f", desc, data, metric=metric)
    keep = (ids if desc.startswith("IDMap") else np.arange(900))[::2]
    pair.check(5, xq)
    pair.check(5, xq, jsel=JSetSelector(keep), psel=dt.SetSelector(keep))
    for extra in (50, 600):        # fits the 1024 buffer, then grows it
        rows = rng.standard_normal((extra, 16)).astype(np.float32)
        more_ids = ids.max() + 3 * (1 + np.arange(extra))
        more = (more_ids, rows) if desc.startswith("IDMap") else rows
        dfx.faiss_add(more, "f", catalog=pair.jcat)
        dt.faiss_add(more, "f", catalog=pair.pcat)
        ids = np.concatenate([ids, more_ids])
        jres, pres = pair.search(5, xq)
        assert_agree(pres, jres, xq)
    inner = pair.index()
    inner = getattr(inner, "inner", inner)
    assert isinstance(inner.device_vectors(), RowBlocks)
    assert inner.device_vectors().shape[0] % 8 == 0
    radius = 10.0 if metric == "INNER_PRODUCT" else 4.0
    jr = dfx.faiss_range_search("f", radius, xq, catalog=pair.jcat)
    pr = dt.faiss_range_search("f", radius, xq, catalog=pair.pcat)
    np.testing.assert_array_equal(pr["lims"], jr["lims"])
    np.testing.assert_array_equal(np.sort(pr["label"]), np.sort(jr["label"]))


def test_flat_rerank_param_reads_the_blocks():
    rng = np.random.default_rng(6)
    xb = rng.standard_normal((700, 16)).astype(np.float32)
    cat = dt.Catalog()
    dt.faiss_create("r", 16, "Flat", metric_type="L2", catalog=cat)
    dt.faiss_add(xb, "r", catalog=cat)
    dt.set_precision("fast")
    try:
        before = dt.faiss_search("r", 5, xb[:4], {"rerank": "true"},
                                 catalog=cat)
        dt.faiss_to_device("r", psh.make_mesh(8), catalog=cat)
        after = dt.faiss_search("r", 5, xb[:4], {"rerank": "true"},
                                catalog=cat)
    finally:
        dt.set_precision("parity")
    assert_same(after, before)


def test_to_device_integer_index():
    """The reference's faiss_to_gpu(name, device) form: 0 is the CPU here
    (cuda:0 on a card); out of range gives the JAX package's error."""
    rng = np.random.default_rng(0)
    xb = rng.standard_normal((64, 8)).astype(np.float32)
    pair = Pair("dev0", "Flat", xb)
    dfx.faiss_to_device("dev0", 0, catalog=pair.jcat)
    dt.faiss_to_device("dev0", 0, catalog=pair.pcat)
    jres, pres = pair.search(3, xb[:4])
    assert (pres["label"][:, 0] == np.arange(4)).all()
    assert_agree(pres, jres, xb[:4])
    assert default_mesh(0).devices.tolist() == [[torch.device("cpu")]]
    with pytest.raises(dt.InvalidInputError,
                       match=re.escape("Invalid device index: 99 (1 devices "
                                       "available)")):
        dt.faiss_to_device("dev0", 99, catalog=pair.pcat)
    with pytest.raises(jerrors.InvalidInputError, match="Invalid device"):
        dfx.faiss_to_device("dev0", 99, catalog=pair.jcat)


def test_default_mesh_forms():
    """None, an int, a device, a string and an iterable (a device may
    repeat) all give a (shard x 1) mesh."""
    cpu = torch.device("cpu")
    for arg, shards in ((None, 1), (0, 1), (cpu, 1), ("cpu", 1),
                        ([0, "cpu", cpu], 3)):
        mesh = default_mesh(arg)
        assert mesh.shape == {"shard": shards, "batch": 1}
        assert all(d == cpu for d in mesh.devices.reshape(-1))
    mesh = psh.make_mesh(8, batch_axis=2)
    assert mesh.shape == {"shard": 4, "batch": 2}
    assert mesh.shard_devices(0) == [cpu]


# --- faiss_to_device: IVF ----------------------------------------------------

def test_faiss_to_device_ivf():
    """Lists placed 8 ways: results unchanged; adds keep working and the
    placement sticks."""
    xb = _clustered(2000, 16, 8)
    pair = Pair("shivf", "IVF8,Flat", xb)
    pair.check(5, xb[:4], {"nprobe": "8"})
    assert pair.index()._shard_mesh.shape == {"shard": 8, "batch": 1}
    dfx.faiss_add(xb[:100], "shivf", catalog=pair.jcat)
    dt.faiss_add(xb[:100], "shivf", catalog=pair.pcat)
    jres, pres = pair.search(5, xb[:4], {"nprobe": "8"})
    assert_agree(pres, jres, xb[:4])


def test_faiss_to_device_ivfpq():
    xb = _clustered(3000, 16, 21)
    Pair("shivfpq", "IVF8,PQ4", xb).check(5, xb[:6], {"nprobe": "8"})


@pytest.mark.parametrize("kind", ["set", "bitmap"])
def test_faiss_to_device_ivf_filtered(kind):
    """The per-(list, slot) masks built on every shard's device."""
    rng = np.random.default_rng(33)
    n = 2000
    xb = rng.standard_normal((n, 16)).astype(np.float32)
    keep = np.arange(0, n, 3, dtype=np.int64)
    if kind == "set":
        jsel, psel = JSetSelector(keep), dt.SetSelector(keep)
    else:
        flags = np.zeros(n, np.uint8)
        flags[keep] = 1
        jsel = dfx.create_mask(flags, np.arange(n))
        psel = dt.create_mask(flags, np.arange(n))
    out = Pair("shivf_f", "IVF8,Flat", xb).check(
        5, xb[:6], {"nprobe": "8"}, jsel, psel)
    assert np.all(out["label"] % 3 == 0)


def test_faiss_to_device_ivfpq_filtered():
    rng = np.random.default_rng(34)
    xb = rng.standard_normal((3000, 16)).astype(np.float32)
    keep = np.arange(0, 3000, 2, dtype=np.int64)
    out = Pair("shpq_f", "IVF8,PQ4", xb).check(
        5, xb[:6], {"nprobe": "8"}, JSetSelector(keep), dt.SetSelector(keep))
    assert np.all(out["label"] % 2 == 0)


@pytest.mark.parametrize("storage", ["SQ8", "SQ4", "SQfp16", "SQbf16"])
def test_faiss_to_device_ivfsq(storage):
    """Parity mode: every shard runs the decode scan over its sub-layout."""
    xb = _clustered(3000, 16, 22)
    Pair(f"shivfsq{storage}", f"IVF8,{storage}", xb).check(
        5, xb[:6], {"nprobe": "8"})


@pytest.mark.parametrize("storage", ["SQ8", "SQ4", "SQ6"])
def test_faiss_to_device_ivfsq_int8(storage):
    """On the int8 path every shard runs K2's plain version (or K3's at a
    pair-tile batch) with its exact rerank, as the unplaced layout path
    does: equal to it.  The JAX package's sharded scan decodes in fp32:
    distances agree within the tolerance, labels where the int8 pool
    holds the true neighbours (all of them on this data)."""
    xb = _clustered(3000, 32, 23)
    pair = Pair(f"shsq8_{storage}", f"IVF8,{storage}", xb)
    xq = xb[:300] + 0.05
    dt.set_sq_dot("int8")
    try:
        ix = pair.index()
        ix.PAIRS_MIN_WORK = 0           # b512 takes the pair tiles (K3)
        for nq in (6, 300):
            _, before = pair.search(5, xq[:nq], {"nprobe": "4"})
            paths = [ix._last_scan_path]
            if nq == 6:
                pair.place()
            jafter, after = pair.search(5, xq[:nq], {"nprobe": "4"})
            paths.append(ix._last_scan_path)
            assert paths == (["per-query"] * 2 if nq == 6 else
                             [f"pairs-{storage.lower()}"] * 2), paths
            assert_same(after, before)
            assert_agree(after, jafter, xq[:nq])
    finally:
        dt.set_sq_dot("auto")


def test_faiss_to_device_ivf_pairs():
    """A batch the static rule sends to the pair tiles: each shard runs
    K7's plain version on its lists."""
    xb = _clustered(3000, 16, 24)
    pair = Pair("shpairs", "IVF8,Flat", xb)
    ix = pair.index()
    ix.PAIRS_MIN_WORK = 0
    xq = xb[:300] + 0.01
    pair.check(5, xq, {"nprobe": "3"})
    assert ix._last_scan_path == "pairs-flat"


def test_faiss_to_device_ivfrq():
    xb = _clustered(3000, 16, 23, spread=0.2)
    Pair("shivfrq", "IVF8,RQ4x4", xb).check(5, xb[:6], {"nprobe": "8"})


def test_faiss_to_device_soar():
    """SOAR's duplicated rows ride the sharded layout; the duplicates drop
    after the merge."""
    rng = np.random.default_rng(29)
    xb = rng.standard_normal((3000, 16)).astype(np.float32)
    out = Pair("shsoar", "IVF8,Flat", xb, params={"soar_lambda": "1.0"}) \
        .check(5, xb[:6], {"nprobe": "8"})
    for row in out["label"]:
        live = row[row >= 0]
        assert len(set(live)) == len(live)


def test_faiss_to_device_imi():
    rng = np.random.default_rng(30)
    xb = rng.standard_normal((2500, 16)).astype(np.float32)
    Pair("shimi", "IMI2x2,Flat", xb).check(5, xb[:6], {"nprobe": "16"})


def test_faiss_to_device_ivf_skewed():
    """A heavily skewed corpus: results as unplaced, and the recorded
    _shard_perm (the JAX package's perm) balances the shards' Σcounts."""
    rng = np.random.default_rng(9)
    d, n = 16, 4000
    xb = np.concatenate([
        rng.standard_normal((n - 256, d)).astype(np.float32) * 0.2,
        rng.standard_normal((256, d)).astype(np.float32) * 4 + 8])
    pair = Pair("shskew", "IVF16,Flat", xb)
    pair.check(5, xb[:8], {"nprobe": "16"})
    ix = pair.index()
    np.testing.assert_array_equal(
        ix._shard_perm, pair.jcat.get("shskew").index._shard_perm)
    counts = ix._counts()
    npl = counts.shape[0] // 8
    loads = np.array([counts[ix._shard_perm[s * npl:(s + 1) * npl]].sum()
                      for s in range(8)], np.float64)
    assert loads.max() / max(loads.mean(), 1.0) < 1.5


def test_ivf_shard_count_shrinks_to_a_divisor():
    """nlist 12 over 8 devices: 6 shards (the largest divisor), as in the
    JAX package."""
    xb = _clustered(1500, 16, 40)
    pair = Pair("shrink", "IVF12,Flat", xb)
    pair.check(5, xb[:5], {"nprobe": "5"})
    assert pair.index()._shard_mesh.shape == {"shard": 6, "batch": 1}
    assert pair.jcat.get("shrink").index._shard_mesh.shape["shard"] == 6


@pytest.mark.parametrize("case", ["metric", "device_resident", "axes"])
def test_ivf_shard_over_refusals(case):
    """The JAX package's three refusals, with its texts."""
    xb = _clustered(1000, 16, 41)
    metric = "L1" if case == "metric" else "L2"
    pair = Pair("ref", "IVF4,Flat", xb, metric=metric)
    ix = pair.index()
    if case == "device_resident":
        cat = dt.Catalog()
        dt.faiss_create("dr", 16, "IVF4,Flat", metric_type="L2",
                        catalog=cat)
        dt.faiss_train_device(torch.from_numpy(xb), "dr", catalog=cat)
        dt.faiss_add_device(torch.from_numpy(xb), "dr", catalog=cat,
                            expected_total=xb.shape[0])
        ix = cat.get("dr").index
        match = "a device-resident index cannot be re-sharded"
    elif case == "metric":
        match = ("IVF indexes with metric L1 cannot be sharded over devices "
                 r"\(only L2 and INNER_PRODUCT\)")
    else:
        match = "IVF sharding needs a mesh with 'shard' and 'batch' axes"

    class OneAxis:
        shape = {"shard": 2}
        devices = np.array([torch.device("cpu")] * 2, dtype=object)

    with pytest.raises(dt.InvalidInputError, match=match):
        ix.shard_over(OneAxis() if case == "axes" else psh.make_mesh(2))


# --- faiss_to_device: codecs and wrappers -----------------------------------

@pytest.mark.parametrize("desc", ["PQ4", "SQ8", "SQ4", "SQfp16", "RQ2x4",
                                  "LSH16"])
def test_faiss_to_device_codec_families(desc):
    """Row-placed codes: every shard runs the family's own scan."""
    rng = np.random.default_rng(33)
    xb = rng.standard_normal((900, 16)).astype(np.float32)
    pair = Pair(f"shc_{desc}", desc, xb)
    pair.check(4, xb[:5])
    keep = np.arange(0, 900, 2)
    pair.check(4, xb[:5], jsel=JSetSelector(keep), psel=dt.SetSelector(keep))


@pytest.mark.parametrize("desc", ["PCA8,Flat", "PQ4,RFlat", "ITQ8,LSH16",
                                  "IDMap2,OPQ4,IVF4,PQ4"])
def test_faiss_to_device_wrapped_composites(desc):
    """shard_entry unwraps IDMap / PreTransform / RefineFlat down to the
    storage-owning index."""
    rng = np.random.default_rng(34)
    n = 800
    xb = rng.standard_normal((n, 16)).astype(np.float32)
    data = ((np.arange(n, dtype=np.int64), xb) if desc.startswith("IDMap")
            else xb)
    Pair("shw_" + re.sub(r"\W", "_", desc), desc, data).check(
        4, xb[:5], {"nprobe": "4"})


@pytest.mark.parametrize("desc", ["PQ4", "SQ8", "RQ2x4"])
def test_untrained_shard_then_train(desc):
    """faiss_to_device before training (create → to_gpu → train): the
    placement sticks and the codes are placed once they exist; the result
    equals the same flow unplaced."""
    rng = np.random.default_rng(35)
    xb = rng.standard_normal((500, 16)).astype(np.float32)
    out = []
    for placed in (True, False):
        cat = dt.Catalog()
        dt.faiss_create("ut", 16, desc, metric_type="L2", catalog=cat)
        if placed:
            dt.faiss_to_device("ut", psh.make_mesh(8), catalog=cat)
        dt.faiss_add(xb, "ut", catalog=cat)
        out.append(dt.faiss_search("ut", 3, xb[:4], catalog=cat))
        if placed:
            codes = cat.get("ut").index._device_state()[0]
            assert isinstance(codes, RowBlocks) and codes.nshards == 8
    assert (out[0]["label"][:, 0] == np.arange(4)).sum() >= 3
    assert_same(out[0], out[1])


def test_refine_store_sharded():
    """RefineFlat places both parts: the compressed base and the raw fp32
    store its rerank gathers from."""
    rng = np.random.default_rng(36)
    xb = rng.standard_normal((640, 16)).astype(np.float32)
    pair = Pair("rfsh", "PQ4,RFlat", xb)
    pair.check(3, xb[:4])
    ix = pair.index()
    assert ix.refine.device_vectors().nshards == 8
    assert ix.base._device_state()[0].nshards == 8


def test_placement_is_not_saved(tmp_path):
    rng = np.random.default_rng(37)
    xb = rng.standard_normal((300, 16)).astype(np.float32)
    cat = dt.Catalog()
    dt.faiss_create("sv", 16, "IVF4,Flat", metric_type="L2", catalog=cat)
    dt.faiss_add(xb, "sv", catalog=cat)
    dt.faiss_to_device("sv", psh.make_mesh(4), catalog=cat)
    placed = dt.faiss_search("sv", 3, xb[:4], {"nprobe": "4"}, catalog=cat)
    path = str(tmp_path / "sv.dfx")
    dt.faiss_save("sv", path, catalog=cat)
    dt.faiss_load("sv2", path, catalog=cat)
    assert cat.get("sv2").index._shard_mesh is None
    assert_same(dt.faiss_search("sv2", 3, xb[:4], {"nprobe": "4"},
                                catalog=cat), placed)


def test_mesh_rejects_an_empty_grid():
    with pytest.raises(ValueError):
        Mesh([])
