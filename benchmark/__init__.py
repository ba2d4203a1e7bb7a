"""The benchmark of ``duckdb_faiss_ext_tpu_torch`` (the PyTorch / CUDA port).

One command runs one cell once, from the root of a checkout::

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Everything is found by the names in ``BENCHMARK.json``:

* ``configs/<config>.json``: a deployment (index factory, metric, sizes,
  precision mode, the limits of the comparison that decides ``correct``);
  its ``family`` names ``systems/<family>.py`` (how the port builds and
  serves it), ``work/<family>.py`` (the bytes and operations one call
  needs) and ``reference/<family>.py`` (the plain PyTorch reference); its
  ``generator`` names ``data/<generator>.py`` (the seeded data);
* ``traffic/<cell>.json``: the mix one cell sends (batch, pool);
* ``metrics/<metric>.py``: one reader a metric, ``read(run)`` returning a
  number or None.

No module here imports JAX or the JAX package; nothing under
``reference/`` imports the port.
"""
