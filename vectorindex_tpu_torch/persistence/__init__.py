"""Persistence tiers of the port: JSON snapshots (byte-compatible with the
JAX package), the binary container (persistence/container, its native core
persistence/native/container.cpp), the Flat and HNSW container layouts
(container_index) and the durable IVF container with its journal
(durable). Files of every tier load in either package."""

from vectorindex_tpu_torch.persistence.container import Container, SectionType  # noqa: F401
from vectorindex_tpu_torch.persistence.container_index import (  # noqa: F401
    load_flat_container,
    load_hnsw_container,
    save_flat_container,
    save_hnsw_container,
)
from vectorindex_tpu_torch.persistence.durable import (  # noqa: F401
    REC_INSERT,
    REC_META,
    REC_REMOVE,
    REC_UPDATE,
    append_journal,
    load_ivf_container,
    save_ivf_container,
)
from vectorindex_tpu_torch.persistence.json_snapshot import (  # noqa: F401
    PersistedIndex,
    PersistedRecord,
    load_snapshot,
    save_snapshot,
)
