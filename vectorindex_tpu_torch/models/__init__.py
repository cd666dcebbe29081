"""Index families of the port (so far: the exact flat index, IVF-Flat and
IVF-PQ)."""

from vectorindex_tpu_torch.models.base import (  # noqa: F401
    IndexStats,
    SearchResult,
    VectorIndex,
)
from vectorindex_tpu_torch.models.filters import JournalFilter  # noqa: F401
from vectorindex_tpu_torch.models.flat import FlatIndex  # noqa: F401
from vectorindex_tpu_torch.models.ivf import (  # noqa: F401
    IVFConfig,
    IVFIndex,
    IVFPQConfig,
    IVFPQIndex,
)
