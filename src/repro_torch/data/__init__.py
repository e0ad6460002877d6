"""Data plane of the port: the `DataSource` registry and the prefetching
`ShardedLoader`, the counterpart of `repro.data`.

    from repro_torch.data import (Cursor, DataSource, ShardedLoader,
                                  get_source, list_sources,
                                  register_source, write_file_corpus)

Sources are deterministic, seekable batch stores selected by name
(`zipf_sparse`, `lm_markov`, `file_sparse`, user-registered); the loader
fronts one with per-host shard ownership (chunk-aligned file ranges via
the `owned_shards` seam and `ShardAssignment`, stride interleaving for
synthetic sources), conformance to the rank count, prefetch onto the
card, and a resumable `Cursor`. `DPMREngine.fit`, `fit_sgd` and
`evaluate` take a loader (or a source name and spec) directly.
"""
from repro_torch.data.loader import Cursor, ShardedLoader
from repro_torch.data.ownership import ShardAssignment, reassign_state
from repro_torch.data.sources import (
    DataSource,
    FileSparseSource,
    LMMarkovSource,
    ZipfSparseSource,
    get_source,
    list_sources,
    register_source,
    write_file_corpus,
)

__all__ = [
    "Cursor", "DataSource", "FileSparseSource", "LMMarkovSource",
    "ShardAssignment", "ShardedLoader", "ZipfSparseSource", "get_source",
    "list_sources", "reassign_state", "register_source",
    "write_file_corpus",
]
