"""Examples of the port, each runnable as
``python -m duckdb_faiss_ext_tpu_torch.examples.<name>`` on the card (or
with ``--cpu`` on the CPU), the JAX package's examples/ on the port:

* ``knn_classify`` — k-NN majority-vote classification over an index;
* ``duckdb_knn_classify`` — the same through DuckDB SQL with the faiss_*
  UDFs registered by ``sql.register_duckdb`` (needs the duckdb package);
* ``compression_pipeline`` — OPQ → IVF → PQ → RFlat against a Flat oracle;
* ``quality_tuning`` — SOAR, anisotropic PQ, RQ and the graph walk at a
  fixed candidate budget;
* ``serving_modes`` — precision modes, reranks, the int8 SQ scan, batched
  serving and autotuning.

Each takes ``--n`` (corpus rows) so that it also runs at a small size.
"""
