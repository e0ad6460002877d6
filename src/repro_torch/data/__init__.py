"""Data plane of the port: the `DataSource` registry and the Zipf corpus."""
from repro_torch.data.sources import (
    DataSource,
    ZipfSparseSource,
    get_source,
    register_source,
)

__all__ = ["DataSource", "ZipfSparseSource", "get_source",
           "register_source"]
