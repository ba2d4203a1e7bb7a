"""The port's edge modules on the CPU:

* ``utils.transfer.fetch_results``: one packed copy, bit-exact against the
  JAX package's for NaN payloads, infinities, signed zeros and denormal
  distances, positions whose bits are denormal floats, and k = 0;
* ``utils.transfer.upload_queries``: fp32 and contiguous whatever the
  input's dtype and layout, equal to the rows given;
* ``utils.profiling.trace``: writes a Chrome trace of the block;
* the five examples (duckdb_faiss_ext_tpu_torch/examples/) at a small size
  with ``--cpu``: exit 0 and their output lines.
"""

import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import duckdb_faiss_ext_tpu_torch as dt
from duckdb_faiss_ext_tpu.utils.transfer import \
    fetch_results as jax_fetch_results
from duckdb_faiss_ext_tpu_torch.utils.profiling import trace
from duckdb_faiss_ext_tpu_torch.utils.transfer import (fetch_results,
                                                       upload_queries)


@pytest.fixture(autouse=True)
def cpu_device():
    """The CPU, on one torch thread: the test workers share the cores."""
    prev, threads = dt.config.device, torch.get_num_threads()
    dt.set_device("cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    dt.config.device = prev
    dt.set_precision("parity")
    dt.set_sq_dot("auto")


def _odd_floats():
    """NaNs with payloads and both signs, infinities, signed zeros,
    denormals and ordinary values, as float32 bits."""
    bits = np.array([0x7FC00001, 0xFFC12345, 0x7F800001, 0x7F800000,
                     0xFF800000, 0x00000000, 0x80000000, 0x00000001,
                     0x807FFFFF, 0x00400000, 0x3F800000, 0xC2C80000],
                    np.uint32)
    return bits.view(np.float32)


@pytest.mark.parametrize("k", [0, 1, 12])
def test_fetch_results_bit_exact(k):
    vals = _odd_floats()
    d = np.resize(vals, (3, k)).astype(np.float32)
    p = np.resize(np.array([0, 1, 7, -1, 2**31 - 1, 123456], np.int32),
                  (3, k))
    gd, gp = fetch_results(torch.from_numpy(d), torch.from_numpy(p))
    wd, wp = (np.asarray(t) for t in jax_fetch_results(jnp.asarray(d),
                                                       jnp.asarray(p)))
    assert gd.dtype == np.float32 and gp.dtype == np.int32
    assert gd.shape == gp.shape == (3, k)
    assert gd.tobytes() == d.tobytes() == np.ascontiguousarray(wd).tobytes()
    assert gp.tobytes() == p.tobytes() == np.ascontiguousarray(wp).tobytes()


def test_fetch_results_small_positions_not_flushed():
    """1..1000 as float bits are denormals; they come back as integers."""
    p = torch.arange(1, 1001, dtype=torch.int32)[None, :]
    _, gp = fetch_results(torch.zeros((1, 1000)), p)
    np.testing.assert_array_equal(gp[0], np.arange(1, 1001))


def test_fetch_results_int64_positions_and_views():
    """int64 positions narrow to int32; a non-contiguous distance view is
    packed as its values."""
    d = torch.arange(24, dtype=torch.float32).reshape(4, 6)[:, ::2]
    gd, gp = fetch_results(d, torch.arange(12).reshape(4, 3))
    np.testing.assert_array_equal(gd, d.numpy())
    assert gp.dtype == np.int32 and gp.tolist() == [[0, 1, 2], [3, 4, 5],
                                                    [6, 7, 8], [9, 10, 11]]


@pytest.mark.parametrize("dtype,order", [(np.float32, "C"),
                                         (np.float64, "C"),
                                         (np.float32, "F")])
def test_upload_queries(dtype, order):
    xq = np.asarray(np.random.default_rng(0).standard_normal((5, 7)),
                    dtype=dtype, order=order)
    got = upload_queries(xq, "cpu")
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert got.device.type == "cpu" and got.shape == (5, 7)
    np.testing.assert_array_equal(got.numpy(), xq.astype(np.float32))


def test_upload_queries_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises((RuntimeError, AssertionError)):
        upload_queries(np.zeros((2, 3), np.float32), "cuda")


def test_models_upload_through_transfer(monkeypatch):
    """A Flat search's queries go through upload_queries."""
    from duckdb_faiss_ext_tpu_torch.models import flat

    seen = []

    def spy(xq, device):
        seen.append((xq.shape, torch.device(device).type))
        return upload_queries(xq, device)

    monkeypatch.setattr(flat, "upload_queries", spy)
    cat = dt.Catalog()
    xb = np.random.default_rng(1).standard_normal((50, 4)).astype(np.float32)
    dt.faiss_create("u", 4, "Flat", metric_type="L2", catalog=cat)
    dt.faiss_add(xb, "u", catalog=cat)
    res = dt.faiss_search("u", 2, xb[:3], catalog=cat)
    assert res["label"][:, 0].tolist() == [0, 1, 2]
    assert seen and seen[0][1] == "cpu" and seen[0][0][1] == 4


def test_trace_writes_a_chrome_trace(tmp_path):
    cat = dt.Catalog()
    xb = np.random.default_rng(2).standard_normal((200, 8)).astype(
        np.float32)
    dt.faiss_create("t", 8, "Flat", catalog=cat)
    dt.faiss_add(xb, "t", catalog=cat)
    path = tmp_path / "sub" / "trace.json"
    with trace(str(path)) as prof:
        dt.faiss_search("t", 3, xb[:4], catalog=cat)
    events = json.loads(path.read_text())["traceEvents"]
    assert len(events) > 0
    assert any("aten::" in str(e.get("name", "")) for e in events)
    assert prof.key_averages()


EXAMPLES = [
    ("knn_classify", ["--n", "900"],
     r"k-NN majority-vote accuracy: (1\.000|0\.9\d\d)"),
    ("duckdb_knn_classify", ["--n", "600"],
     r"duckdb is not installed|sentiment accuracy over 200 test rows"),
    ("compression_pipeline", ["--n", "4000"],
     r"OPQ16,IVF64,PQ16,RFlat\s+(0\.9\d\d|1\.000)"),
    ("quality_tuning", ["--n", "12000"],
     r"SOAR and anisotropic quantization lift recall"),
    ("serving_modes", ["--n", "8000"],
     r"autotune \(IVF512\):\noperating points"),
]


@pytest.mark.parametrize("name,args,expect", EXAMPLES,
                         ids=[e[0] for e in EXAMPLES])
def test_example_runs_on_the_cpu(name, args, expect, capsys):
    import importlib

    mod = importlib.import_module(f"duckdb_faiss_ext_tpu_torch.examples.{name}")
    assert mod.main(args + ["--cpu"]) == 0
    out = capsys.readouterr().out
    assert re.search(expect, out), out
