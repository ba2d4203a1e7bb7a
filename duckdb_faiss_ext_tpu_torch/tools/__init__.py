"""Command-line tools of the port, each runnable as
``python -m duckdb_faiss_ext_tpu_torch.tools.<name>`` on the card (or with
``--cpu`` on the CPU), with the flags and outputs of the JAX package's
tools of the same names:

* ``create_index`` / ``create_trec`` — the reference's go/cmd/create_index
  and go/cmd/create_trec: build, train, add and save an index from an
  embedding file; run a query set at k = 1000 and write a TREC run file;
* ``marco_mini`` — the frozen synthetic accuracy-conformance flow
  (generate → create_index → faiss_load → create_trec → score);
* ``conformance`` — recall against a Flat oracle, optionally a TREC file;
* ``benchmark_filtered`` — the three filtered-search strategies
  (go/main_test.go:18-51);
* ``autotune`` — the search-knob sweep and its operating points;
* ``run_reference_tests`` — the reference's SQLLogicTest files;
* ``marco_device`` / ``marco_trec`` — IVF4096,SQ8 over the 8,841,823 x
  1536 MS MARCO stand-in built on the card, and its k = 1000 TREC run;
* ``marco_graph`` — the SQ-coded graph build and walk at that scale;
* ``marco_corpus`` — the stand-in corpus those tools and chip_smoke.py
  draw.
"""
