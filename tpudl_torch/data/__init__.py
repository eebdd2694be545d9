"""Data sources of the port: the synthetic batches the benchmarks and
smoke tests train on (tpudl.data.synthetic) and the CV augmenter with its
native kernel (tpudl.data.augment, tpudl.native). The Parquet layer waits
for its ROADMAP item."""
