"""`DataSource` — deterministic, seekable batch stores selected by name.

The counterpart of `repro.data.sources`, cut to what the single-card
trainer reads: the `DataSource` base, the registry and the synthetic Zipf
corpus. Batches are host-side numpy dicts, bit-identical to the
reference's for the same spec and index; the engine moves them to its
device. `ShardedLoader`, host shard ownership (`owned_shards`), the file
sources and `lm_markov` come with later slices (ROADMAP queue A).

    from repro_torch.data import get_source

    src = get_source("zipf_sparse", batch_size=512, num_batches=8,
                     num_features=1 << 14)
    b = src.batch(3)            # same dict every time it is asked for
"""
from __future__ import annotations

from collections.abc import Callable, Iterator

import numpy as np

from repro_torch.data import sparse_corpus


class DataSource:
    """A deterministic, seekable batch store.

    Attributes
    ----------
    name:         registered name (set for built-ins; informational)
    batch_size:   samples per batch (axis 0 of every leaf)
    num_batches:  batches per epoch, or None for an unbounded stream
    """

    name: str = "base"
    batch_size: int = 0
    num_batches: int | None = None

    def batch(self, index: int) -> dict[str, np.ndarray]:
        """The batch at `index` — MUST be a pure function of the index."""
        raise NotImplementedError

    def iter_batches(self, start: int = 0,
                     limit: int | None = None) -> Iterator[dict]:
        """Plain host-side iteration (no sharding, no prefetch)."""
        i = start
        while limit is None or i < start + limit:
            if self.num_batches is not None and i >= self.num_batches:
                return
            yield self.batch(i)
            i += 1

    def _check_index(self, index: int) -> None:
        if index < 0 or (self.num_batches is not None
                         and index >= self.num_batches):
            raise IndexError(
                f"batch index {index} out of range for {self.name!r} "
                f"source with num_batches={self.num_batches}")


_REGISTRY: dict[str, Callable[..., DataSource]] = {}


def register_source(name: str, factory: Callable[..., DataSource] = None):
    """Register a source factory (`factory(**spec) -> DataSource`), or use
    as a class decorator:

        @register_source("mine")
        class Mine(DataSource): ...
    """
    if factory is not None:
        _REGISTRY[name] = factory
        return factory

    def _decorate(cls):
        _REGISTRY[name] = cls
        return cls

    return _decorate


def get_source(name: str, **spec) -> DataSource:
    """Instantiate a registered source from its name + spec kwargs."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown data source {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None
    return factory(**spec)


@register_source("zipf_sparse")
class ZipfSparseSource(DataSource):
    """Synthetic Zipf CTR corpus (`sparse_corpus.make_batch` per index).

    `start` offsets the index space — the idiom for carving a held-out test
    range out of the same stream (`start=1000, num_batches=3`).
    """

    name = "zipf_sparse"

    def __init__(self, spec: sparse_corpus.CorpusSpec = None, *,
                 batch_size: int = 512, num_batches: int | None = None,
                 start: int = 0, **spec_kw):
        if spec is not None and spec_kw:
            raise TypeError("pass either spec= or CorpusSpec fields, not both")
        self.spec = spec if spec is not None \
            else sparse_corpus.CorpusSpec(**spec_kw)
        self.batch_size = int(batch_size)
        self.num_batches = None if num_batches is None else int(num_batches)
        self.start = int(start)

    def batch(self, index: int) -> dict[str, np.ndarray]:
        self._check_index(index)
        return sparse_corpus.make_batch(
            self.spec, self.batch_size,
            seed=sparse_corpus.batch_seed(self.spec, self.start + index))
