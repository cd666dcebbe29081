"""Index families of the port (the exact flat index, IVF-Flat, IVF-PQ,
HNSW and their sharded forms), the acceleration seam (`accel`) and
`load_index`, which opens any index either package persisted."""

from vectorindex_tpu_torch.models.base import (  # noqa: F401
    IndexStats,
    SearchResult,
    VectorIndex,
)
from vectorindex_tpu_torch.models.filters import JournalFilter  # noqa: F401
from vectorindex_tpu_torch.models.flat import FlatIndex  # noqa: F401
from vectorindex_tpu_torch.models.hnsw import HNSWConfig, HNSWIndex  # noqa: F401
from vectorindex_tpu_torch.models.ivf import (  # noqa: F401
    IVFConfig,
    IVFIndex,
    IVFPQConfig,
    IVFPQIndex,
)
from vectorindex_tpu_torch.models.sharded import (  # noqa: F401
    ShardedFlatIndex,
    ShardedHNSWIndex,
)
from vectorindex_tpu_torch.models import accel  # noqa: F401
from vectorindex_tpu_torch.persistence.json_snapshot import (  # noqa: F401
    PersistedIndex,
    PersistedRecord,
    load_snapshot,
    save_snapshot,
)
from vectorindex_tpu_torch.utils.errors import ErrorBuilder, IndexErrorKind


def load_index(path: str, device="cuda"):
    """Open any persisted index, dispatching on format and `type`: JSON
    snapshots (flat / hnsw / ivf / ivfpq / sharded_flat / sharded_hnsw) and
    binary INDEXTPU containers (flat / hnsw through the container tier,
    ivf / ivfpq through the durable loader)."""
    import json

    with open(path, "rb") as f:
        magic = f.read(8)
    if magic == b"INDEXTPU":
        return _load_container_index(path, device)
    with open(path) as f:
        t = json.load(f).get("type")
    cls = {c.TYPE: c for c in (FlatIndex, ShardedFlatIndex, ShardedHNSWIndex, HNSWIndex,
                               IVFIndex, IVFPQIndex)}.get(t)
    if cls is None:
        raise (
            ErrorBuilder(IndexErrorKind.INVALID_CONFIGURATION)
            .message(f"unknown snapshot type {t!r}")
            .build()
        )
    return cls.load(path, device=device)


def _load_container_index(path: str, device="cuda"):
    """Dispatch a binary container by its META section; one without META
    holds a durable IVF(-PQ) layout. A META that does not parse is
    CORRUPT_DATA."""
    from vectorindex_tpu_torch.persistence.container import Container, SectionType
    from vectorindex_tpu_torch.persistence.container_index import read_meta

    meta = None
    with Container.open(path) as c:
        if c.find(SectionType.META) >= 0:
            meta = read_meta(c)
    t = (meta or {}).get("type")
    if t == "flat":
        return FlatIndex.load_container(path, device=device)
    if t == "hnsw":
        return HNSWIndex.load_container(path, device=device)
    return IVFIndex.load_durable(path, device=device)
