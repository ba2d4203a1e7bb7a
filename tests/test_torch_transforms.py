"""The port's vector transforms and PreTransform wrapper against the JAX
package's.

Search parity: a JAX index with transform prefixes is trained and filled,
carried into the port with ``from_reference`` (its trained matrices and
inner state), and searched through both packages on the CPU with the same
numpy queries.  Tolerance: distances rtol 1e-5, atol 1e-5 of the larger of
the batch's largest |distance| and |q|² (fp32 sums in another order);
labels equal wherever neighbouring distances are further apart than that.

Training cannot match the JAX package bit for bit (eigenvector signs of
``torch.linalg.eigh``, the port's k-means generator inside OPQ), so it is
held to invariants: PCA spans the same subspace (|A_jaxᵀ·A_port| is a
signed permutation to 1e-4) with the same eigenvalues (projected variances
to 1e-4 relative); OPQ's reconstruction MSE and ITQ's binarization loss
within 5% of the JAX package's; RR's matrix byte-equal.  Checkpoints load
across both packages in both directions with equal results.
"""

import numpy as np
import pytest
import torch

import duckdb_faiss_ext_tpu as dfx
import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu import transforms as jtf
from duckdb_faiss_ext_tpu_torch import transforms as ptf
from duckdb_faiss_ext_tpu_torch.io.convert import from_reference


@pytest.fixture(autouse=True)
def port_on_cpu():
    prev = dt.config.device
    dt.set_device("cpu")
    yield
    dt.config.device = prev


@pytest.fixture
def pcat():
    return dt.Catalog()


def _data(n, d, seed=0):
    """Anisotropic rows, so that PCA has structure to find."""
    rng = np.random.default_rng(seed)
    scales = np.linspace(3.0, 0.1, d).astype(np.float32)
    return rng.standard_normal((n, d)).astype(np.float32) * scales[None, :]


def assert_agree(got, want, xq):
    wd, gd = want["distance"], got["distance"]
    finite = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), finite)
    np.testing.assert_array_equal(got["label"][~finite],
                                  want["label"][~finite])
    scale = max(float(np.abs(wd[finite]).max()) if finite.any() else 1.0,
                float((xq * xq).sum(1).max()))
    tol = 1e-5 * scale
    np.testing.assert_allclose(gd[finite], wd[finite], rtol=1e-5, atol=tol)
    signed = np.where(finite, wd, np.inf)
    gap = np.abs(np.diff(signed, axis=1)) > 2 * tol
    separated = finite.copy()
    separated[:, 1:] &= gap
    separated[:, :-1] &= gap
    np.testing.assert_array_equal(got["label"][separated],
                                  want["label"][separated])


def _carried(catalog, pcat, factory, metric, xb, name="t"):
    dfx.faiss_create(name, xb.shape[1], factory, metric_type=metric,
                     catalog=catalog)
    dfx.faiss_add(xb, name, catalog=catalog)
    pcat.put(name, from_reference(catalog.get(name)))


FACTORIES = [
    ("PCA16,Flat", 32, "L2", None), ("PCAR16,IVF16,Flat", 32, "L2", "4"),
    ("PCAW8,SQ8", 32, "L2", None), ("OPQ8,IVF16,PQ8", 32, "L2", "6"),
    ("OPQ4_16,IVF16,PQ4", 32, "INNER_PRODUCT", "6"),
    ("RR,Flat", 32, "L2", None), ("RR8,Flat", 16, "INNER_PRODUCT", None),
    ("Pad12,PQ4", 10, "L2", None), ("L2norm,Flat", 32, "INNER_PRODUCT",
                                    None),
    ("ITQ,Flat", 16, "L2", None), ("ITQ8,Flat", 16, "L2", None),
    ("PCA16,IVF8,SQ8", 32, "L2", "3"), ("IDMap,PCA8,Flat", 16, "L2", None),
]


@pytest.mark.parametrize("factory,d,metric,nprobe", FACTORIES)
def test_search_matches_jax(catalog, pcat, factory, d, metric, nprobe):
    xb = _data(1200, d, seed=1)
    if factory.startswith("IDMap"):
        ids = np.arange(1200, dtype=np.int64) * 7 + 1
        dfx.faiss_create("t", d, factory, metric_type=metric,
                         catalog=catalog)
        dfx.faiss_add((ids, xb), "t", catalog=catalog)
        pcat.put("t", from_reference(catalog.get("t")))
    else:
        _carried(catalog, pcat, factory, metric, xb)
    xq = _data(16, d, seed=2)
    params = {"nprobe": nprobe} if nprobe else None
    want = dfx.faiss_search("t", 10, xq, params, catalog=catalog)
    got = dt.faiss_search("t", 10, xq, params, catalog=pcat)
    assert_agree(got, want, xq)
    assert_agree(dt.faiss_search_batched("t", 10, xq, params, batch_size=5,
                                         catalog=pcat), got, xq)


@pytest.mark.parametrize("factory,d", [
    ("PCA16,Flat", 32), ("OPQ4_16,IVF16,PQ4", 32), ("ITQ8,LSH16", 16),
    ("RR8,Flat", 16), ("Pad12,PQ4", 10)])
def test_checkpoints_cross_load(catalog, pcat, tmp_path, factory, d):
    """A JAX checkpoint loads in the port and a port checkpoint in the JAX
    package, with equal results."""
    xb = _data(1000, d, seed=3)
    xq = _data(8, d, seed=4)
    params = {"nprobe": "16"} if "IVF" in factory else None
    dfx.faiss_create("j", d, factory, metric_type="L2", catalog=catalog)
    dfx.faiss_add(xb, "j", catalog=catalog)
    want = dfx.faiss_search("j", 5, xq, params, catalog=catalog)
    jpath = str(tmp_path / "j.dfx")
    dfx.faiss_save("j", jpath, catalog=catalog)
    dt.faiss_load("p", jpath, catalog=pcat)
    got = dt.faiss_search("p", 5, xq, params, catalog=pcat)
    assert_agree(got, want, xq)
    ppath = str(tmp_path / "p.dfx")
    dt.faiss_save("p", ppath, catalog=pcat)
    dfx.faiss_load("j2", ppath, catalog=catalog)
    back = dfx.faiss_search("j2", 5, xq, params, catalog=catalog)
    np.testing.assert_array_equal(back["label"], want["label"])
    np.testing.assert_array_equal(back["distance"], want["distance"])


# --- training invariants -----------------------------------------------------

def test_pca_same_subspace_and_eigenvalues():
    x = _data(3000, 12, seed=5)
    j, p = jtf.PCAMatrix(12, 6), ptf.PCAMatrix(12, 6)
    j.train(x)
    p.train(x)
    prod = np.abs(j.A.T @ p.A)
    np.testing.assert_allclose(prod, np.eye(6), atol=1e-4)
    np.testing.assert_allclose(p.apply(x).var(0), j.apply(x).var(0),
                               rtol=1e-4)
    np.testing.assert_allclose(p.mean, j.mean, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["PCAR", "PCAW"])
def test_pca_variants_match_jax(kind):
    """PCAR: the same seeded rotation after the projection, so the same
    projector A·Aᵀ; PCAW: unit variance and the same scaled subspace."""
    x = _data(4000, 10, seed=6)
    kw = ({"random_rotation": True} if kind == "PCAR" else {"whiten": True})
    j, p = jtf.PCAMatrix(10, 5, **kw), ptf.PCAMatrix(10, 5, **kw)
    j.train(x)
    p.train(x)
    if kind == "PCAR":
        np.testing.assert_allclose(p.A @ p.A.T, j.A @ j.A.T, atol=1e-4)
    else:
        np.testing.assert_allclose(p.apply(x).var(0), np.ones(5), rtol=0.1)
        np.testing.assert_allclose(np.abs(j.A.T @ p.A),
                                   np.abs(j.A.T @ j.A), rtol=1e-3,
                                   atol=1e-4)


@pytest.mark.parametrize("d_in,d_out", [(16, 16), (12, 24), (12, 6)])
def test_random_rotation_byte_equal(d_in, d_out):
    j = jtf.RandomRotationMatrix(d_in, d_out)
    p = ptf.RandomRotationMatrix(d_in, d_out)
    assert p.A.dtype == np.float32
    np.testing.assert_array_equal(p.A, j.A)
    x = _data(200, d_in, seed=7)
    y = p.apply(x)
    assert y.shape == (200, d_out)
    if d_out >= d_in:
        np.testing.assert_allclose(np.linalg.norm(y, axis=1),
                                   np.linalg.norm(x, axis=1), rtol=1e-4)


def test_opq_reconstruction_mse_within_5_percent(catalog, pcat):
    x = _data(2000, 16, seed=8)
    mse = []
    for mod, cat in ((dfx, catalog), (dt, pcat)):
        mod.faiss_create("o", 16, "OPQ4,PQ4", metric_type="L2", catalog=cat)
        mod.faiss_add(x, "o", catalog=cat)
        index = cat.get("o").index
        rec = np.stack([index.reconstruct(i) for i in range(0, 2000, 5)])
        mse.append(float(((rec - x[::5]) ** 2).sum(1).mean()))
    assert abs(mse[1] - mse[0]) <= 0.05 * mse[0], mse


def test_itq_binarization_loss_within_5_percent():
    x = _data(3000, 16, seed=9)
    loss = []
    for mod in (jtf, ptf):
        t = mod.ITQTransform(16, 8)
        t.train(x)
        v = (x - t.mean) @ t.A
        loss.append(float(((np.sign(v) - v) ** 2).sum(1).mean()))
    assert abs(loss[1] - loss[0]) <= 0.05 * loss[0], loss


# --- the JAX package's transform cases, on the port ----------------------------

def test_pca_orthonormal_and_variance_order():
    x = _data(3000, 12, seed=1)
    t = ptf.PCAMatrix(12, 6)
    t.train(x)
    np.testing.assert_allclose(t.A.T @ t.A, np.eye(6), atol=1e-4)
    assert np.all(np.diff(t.apply(x).var(axis=0)) <= 1e-3)


def test_pcaw_reverse_roundtrip():
    """reverse uses the pseudo-inverse: whitened columns are not
    orthonormal, so Aᵀ would mis-scale."""
    x = _data(4000, 10, seed=8)
    t = ptf.PCAMatrix(10, 10, whiten=True)
    t.train(x)
    np.testing.assert_allclose(t.reverse(t.apply(x[:50])), x[:50],
                               rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("desc", ["RR,Flat", "ITQ,Flat", "Pad16,Flat"])
def test_distance_preserving_transforms_match_flat(pcat, desc):
    """RR and ITQ (d_out = d_in) are centering plus an orthogonal map, Pad
    adds zero dimensions: search equals plain Flat's."""
    d = 10
    xb = _data(800, d, seed=4)
    dt.faiss_create("tr", d, desc, metric_type="L2", catalog=pcat)
    dt.faiss_create("plain", d, "Flat", metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "tr", catalog=pcat)
    dt.faiss_add(xb, "plain", catalog=pcat)
    a = dt.faiss_search("tr", 5, xb[:8], catalog=pcat)
    b = dt.faiss_search("plain", 5, xb[:8], catalog=pcat)
    np.testing.assert_array_equal(a["label"], b["label"])
    np.testing.assert_allclose(a["distance"], b["distance"], rtol=1e-4,
                               atol=1e-4)


def test_pretransform_reconstruct_and_range(pcat):
    xb = _data(600, 12, seed=7)
    dt.faiss_create("ptr", 12, "RR,Flat", metric_type="L2", catalog=pcat)
    dt.faiss_add(xb, "ptr", catalog=pcat)
    np.testing.assert_allclose(pcat.get("ptr").index.reconstruct(5), xb[5],
                               rtol=1e-4, atol=1e-5)
    res = dt.faiss_range_search("ptr", 0.5, xb[:3], catalog=pcat)
    for q in range(3):
        assert q in res["label"][res["lims"][q]:res["lims"][q + 1]]


@pytest.mark.parametrize("desc,d", [
    ("PCA16,Flat", 8), ("OPQ3_8,Flat", 8), ("Pad8,Flat", 10),
    ("ITQ16,LSH", 8)])
def test_dimension_errors_match_jax(desc, d):
    msgs = []
    for mod in (dfx, dt):
        with pytest.raises(mod.InvalidInputError) as exc:
            mod.build_index(d, desc, mod.resolve_metric("L2"))
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_transforms_stay_fp32_in_fast_mode():
    """Training and apply run under full_fp32: the TF32 flag is off inside
    and restored after, in fast mode too."""
    x = _data(500, 16, seed=3)
    dt.set_precision("fast")
    try:
        t = ptf.PCAMatrix(16, 8)
        seen = []
        orig = ptf.VectorTransform._rows

        def spy(self, x, fn):
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            return orig(self, x, lambda c: (seen.append(
                torch.backends.cuda.matmul.allow_tf32), fn(c))[1])

        ptf.VectorTransform._rows = spy
        try:
            t.train(x)
            t.apply(x)
        finally:
            ptf.VectorTransform._rows = orig
        assert seen and not any(seen[1::2])
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        dt.set_precision("parity")
