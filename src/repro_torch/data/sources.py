"""`DataSource` — deterministic, seekable batch stores selected by name:
the counterpart of `repro.data.sources`.

Batches are host-side numpy dicts, bit-identical to the reference's for
the same spec and index; a `ShardedLoader` (`data/loader.py`) or the
engine moves them to the device.

    from repro_torch.data import get_source, list_sources

    src = get_source("zipf_sparse", batch_size=512, num_batches=8,
                     num_features=1 << 14)
    b = src.batch(3)            # same dict every time it is asked for

Built-ins:

  zipf_sparse   synthetic Zipf CTR corpus (`sparse_corpus.make_batch`)
  lm_markov     synthetic Markov LM stream (`pipeline.LMDataset`),
                optionally with encoder frames for encdec families
  file_sparse   chunk files on disk, the paper's HDFS sample shards.
                `write_file_corpus` writes any source into `.npz` chunks
                and a `manifest.json`, in the reference's format, so
                either package reads a corpus the other wrote;
                `FileSparseSource` reads them back through a small
                chunk cache.

`batch(index)` must be a pure function of the index: resumable cursors,
host ownership and prefetch in `data/loader.py` rest on it.
"""
from __future__ import annotations

from collections.abc import Callable, Iterator
import json
import os
import threading

import numpy as np

from repro_torch.data import sparse_corpus
from repro_torch.data.ownership import ShardAssignment
from repro_torch.data.pipeline import LMDataConfig, LMDataset, encdec_batch


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

    def owned_shards(self, host: int, num_hosts: int
                     ) -> ShardAssignment | None:
        """The global `ShardAssignment` dividing this corpus over
        `num_hosts` hosts (`host` is validated against it).

        File-backed sources return chunk-aligned contiguous ranges, so a
        host opens only its own chunk files; synthetic sources have no
        files to own and declare the `stride` interleaving (host h reads
        batches h, h+H, ...). Unbounded streams return None — ownership
        needs a bounded corpus to divide."""
        if self.num_batches is None:
            return None
        a = ShardAssignment.strided(self.num_batches, num_hosts)
        a._check_host(host)
        return a

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


def list_sources() -> list[str]:
    return sorted(_REGISTRY)


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


# ---------------------------------------------------------------------------
# built-in: synthetic Markov LM stream (dense face)
# ---------------------------------------------------------------------------


@register_source("lm_markov")
class LMMarkovSource(DataSource):
    """Markov-chain LM batches; `batch(i)` == `LMDataset.batch(i)` (and, with
    `encdec_d_model` set, `pipeline.encdec_batch` — whisper-style frames)."""

    name = "lm_markov"

    def __init__(self, *, vocab_size: int, seq_len: int, batch_size: int,
                 seed: int = 0, num_batches: int | None = None,
                 encdec_d_model: int = 0):
        self._ds = LMDataset(LMDataConfig(vocab_size, seq_len, batch_size,
                                          seed=seed))
        self.batch_size = int(batch_size)
        self.num_batches = None if num_batches is None else int(num_batches)
        self.encdec_d_model = int(encdec_d_model)

    def batch(self, index: int) -> dict[str, np.ndarray]:
        self._check_index(index)
        if self.encdec_d_model:
            return encdec_batch(self._ds, index, self.encdec_d_model)
        return self._ds.batch(index)


# ---------------------------------------------------------------------------
# built-in: sharded packed-CSR chunk files on disk (the paper's HDFS shards)
# ---------------------------------------------------------------------------

_MANIFEST = "manifest.json"
_FORMAT = "dpmr_file_sparse_v1"


def _shard_path(directory: str, shard: int) -> str:
    return os.path.join(directory, f"chunk_{shard:05d}.npz")


def write_file_corpus(directory: str, source: DataSource,
                      num_batches: int | None = None,
                      batches_per_chunk: int = 8) -> dict:
    """Materialize `source` into sharded chunk files under `directory`.

    Each chunk file holds `batches_per_chunk` consecutive batches with every
    leaf stacked along a new axis 0 (so a chunk of padded-CSR batches is
    ids (n,B,K) / vals (n,B,K) / labels (n,B)); `manifest.json` records the
    geometry. Returns the manifest dict.
    """
    n = num_batches if num_batches is not None else source.num_batches
    if n is None:
        raise ValueError("write_file_corpus needs num_batches for an "
                         "unbounded source")
    os.makedirs(directory, exist_ok=True)
    keys = None
    num_chunks = -(-n // batches_per_chunk)
    for c in range(num_chunks):
        lo, hi = c * batches_per_chunk, min(n, (c + 1) * batches_per_chunk)
        chunk = [source.batch(i) for i in range(lo, hi)]
        keys = sorted(chunk[0])
        np.savez(_shard_path(directory, c),
                 **{k: np.stack([b[k] for b in chunk]) for k in keys})
    manifest = {
        "format": _FORMAT,
        "batch_size": int(source.batch_size),
        "num_batches": int(n),
        "batches_per_chunk": int(batches_per_chunk),
        "num_chunks": int(num_chunks),
        "keys": keys,
        # duck-typed sources only promise batch/batch_size/num_batches
        "source": getattr(source, "name", type(source).__name__),
    }
    tmp = os.path.join(directory, _MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(directory, _MANIFEST))
    return manifest


@register_source("file_sparse")
class FileSparseSource(DataSource):
    """Read-side of `write_file_corpus`: seekable batches out of chunk files.

    Random access loads the containing chunk into a small LRU cache
    (`cache_chunks` slots, default 2 so two interleaved readers — e.g. two
    prefetching loaders sharing one source, do not thrash; guarded by a
    lock because a ShardedLoader's prefetch thread calls `batch` from a
    background thread). Sequential reads touch each file once; seeking
    (resume) costs one chunk read.

    `owned_shards` divides the corpus into contiguous, chunk-aligned
    per-host ranges: host h of H owns a balanced ⌈C/H⌉-or-⌊C/H⌋ chunk
    range and never opens the rest. `read_stats` counts actual chunk-file
    opens, so tests can assert the locality claim.
    """

    name = "file_sparse"

    def __init__(self, directory: str, cache_chunks: int = 2):
        self.directory = directory
        with open(os.path.join(directory, _MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format") != _FORMAT:
            raise ValueError(f"{directory}: not a {_FORMAT} corpus "
                             f"({self.manifest.get('format')!r})")
        self.batch_size = int(self.manifest["batch_size"])
        self.num_batches = int(self.manifest["num_batches"])
        self.batches_per_chunk = int(self.manifest["batches_per_chunk"])
        self.num_chunks = int(self.manifest["num_chunks"])
        self.cache_chunks = max(1, int(cache_chunks))
        self._lock = threading.Lock()
        self._cache: dict[int, dict[str, np.ndarray]] = {}
        self._chunk_loads = 0
        self._chunks_touched: set = set()

    def owned_shards(self, host: int, num_hosts: int) -> ShardAssignment:
        """Chunk-aligned contiguous ownership computed from the manifest."""
        a = ShardAssignment.chunk_aligned(
            self.num_chunks, num_hosts,
            batches_per_chunk=self.batches_per_chunk,
            num_batches=self.num_batches)
        a._check_host(host)
        return a

    @property
    def read_stats(self) -> dict[str, int]:
        """Chunk-file I/O since construction: `chunk_loads` counts every
        np.load (cache misses included re-reads), `unique_chunks` the
        distinct files touched — the number a host under chunk ownership
        keeps at ⌈C/H⌉ instead of C."""
        with self._lock:
            return {"chunk_loads": self._chunk_loads,
                    "unique_chunks": len(self._chunks_touched)}

    def batch(self, index: int) -> dict[str, np.ndarray]:
        self._check_index(index)
        chunk, off = divmod(index, self.batches_per_chunk)
        with self._lock:
            arrs = self._cache.pop(chunk, None)
            if arrs is None:
                with np.load(_shard_path(self.directory, chunk)) as z:
                    arrs = {k: z[k] for k in self.manifest["keys"]}
                self._chunk_loads += 1
                self._chunks_touched.add(chunk)
            self._cache[chunk] = arrs        # most recently used last
            while len(self._cache) > self.cache_chunks:
                self._cache.pop(next(iter(self._cache)))
            # copies, not views: a consumer mutating its batch in place must
            # not corrupt the cache (batch(index) purity is what resume
            # exactness rests on)
            return {k: v[off].copy() for k, v in arrs.items()}
