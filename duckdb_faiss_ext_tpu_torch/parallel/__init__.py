"""Placement over several devices and several processes: the mesh, row
blocks, the sharded searches with their k·S merge, and the partitioned
multi-process search.

The counterpart of ``duckdb_faiss_ext_tpu/parallel/``.  The reference is
single-node; this tier partitions an index's storage over a grid of
devices, runs the port's single-device search (its CUDA kernels on a
card) on every shard, and merges the shards' k candidates a query.
"""
