"""``etl_s``: the port's ETL calls by the benchmark's clock, each ended by a
synchronise: ``csr.from_edges``, ``partition.partition_1d``,
``blocks.build_bfs_layout`` and the placement on the device."""


def read(run):
    return sum(run.etl.values())
