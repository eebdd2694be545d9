"""Data sources of the port: the synthetic batches the benchmarks and
smoke tests train on (tpudl.data.synthetic). The Parquet layer waits for
its ROADMAP item."""
