"""The port's binary container (vectorindex_tpu_torch.persistence.container)
and its Flat / HNSW layouts (persistence/container_index), as
tests/test_container.py checks the JAX package's, and against the JAX
package: a container written by either package opens in the other with
equal sections and loads an index that searches as the writer's did.

Tolerances: sections and graphs are compared bit for bit; flat ids and
scores are equal (both packages compute the f32 distance block of the same
rows); HNSW ids are equal on integer-valued rows, where both packages build
the same graph field by field.
"""

import os
import struct

import numpy as np
import pytest
import torch

from vectorindex_tpu.models.flat import FlatIndex as JFlatIndex
from vectorindex_tpu.models.hnsw import HNSWConfig as JHNSWConfig
from vectorindex_tpu.models.hnsw import HNSWIndex as JHNSWIndex
from vectorindex_tpu.persistence.container import Container as JContainer
from vectorindex_tpu.utils.config import Metric as JMetric
from vectorindex_tpu_torch.models import FlatIndex, HNSWConfig, HNSWIndex, load_index
from vectorindex_tpu_torch.persistence import container as pc
from vectorindex_tpu_torch.persistence.container import Container, SectionType
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.errors import IndexError, IndexErrorKind

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
HNSW_CFG = dict(m=8, ef_construction=48, build_chunk=64)  # test_torch_hnsw's JAX shapes


def _ids(res):
    return [[r.id for r in row] for row in res]


def _scores(res):
    return [[r.score for r in row] for row in res]


# ---------------------------------------------------------------------------
# the container (mirrors tests/test_container.py)
# ---------------------------------------------------------------------------


def test_create_write_read_roundtrip(tmp_path):
    p = str(tmp_path / "c.vx")
    cents = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    ids = np.arange(100, dtype=np.int32)
    with Container.create(p) as c:
        c.add_array(SectionType.CENTROIDS, cents)
        c.add_array(SectionType.IDS, ids)
        c.add_blob(SectionType.IDMAP, b'{"hello": 1}')
        c.sync()
    with Container.open(p) as c:
        np.testing.assert_array_equal(c.read_array(SectionType.CENTROIDS, verify=True), cents)
        np.testing.assert_array_equal(c.read_array(SectionType.IDS), ids)
        assert c.read_blob(SectionType.IDMAP) == b'{"hello": 1}'
        assert c.generation == 1
        c.verify_all()


def test_shape_reconstruction(tmp_path):
    p = str(tmp_path / "c.vx")
    a = np.arange(24, dtype=np.float32).reshape(6, 4)
    with Container.create(p) as c:
        c.add_array(SectionType.VECS, a)
    with Container.open(p) as c:
        got = c.read_array(SectionType.VECS)
        assert got.shape == (6, 4)
        np.testing.assert_array_equal(got, a)
        t = c.read_tensor(SectionType.VECS)
    assert torch.equal(t, torch.from_numpy(a))  # owns its memory past close


def _stomp(path, offset, data):
    with open(path, "r+b") as f:
        f.seek(offset)
        f.write(data)


@pytest.mark.parametrize(
    "offset, data, kind",
    [(0, b"XXXXXXXX", IndexErrorKind.CORRUPT_DATA),  # magic
     (16, struct.pack("<Q", 999999), IndexErrorKind.CHECKSUM_MISMATCH),  # generation: header CRC
     (8, struct.pack("<I", 99), IndexErrorKind.VERSION_MISMATCH)],
    ids=["corrupt_magic_rejected", "corrupt_header_crc_rejected", "bad_version_rejected"],
)
def test_corrupt_header_rejected(tmp_path, offset, data, kind):
    p = str(tmp_path / "c.vx")
    with Container.create(p) as c:
        c.add_array(SectionType.IDS, np.arange(4, dtype=np.int32))
    _stomp(p, offset, data)
    with pytest.raises(IndexError) as ei:
        Container.open(p)
    assert ei.value.kind == kind


def test_corrupt_section_data_detected(tmp_path):
    p = str(tmp_path / "c.vx")
    with Container.create(p) as c:
        c.add_array(SectionType.VECS, np.ones(64, dtype=np.float32))
        c.sync()
    _stomp(p, os.path.getsize(p) - 16, b"\xde\xad\xbe\xef")  # section payload
    with Container.open(p) as c:
        with pytest.raises(IndexError) as ei:
            c.read_array(SectionType.VECS, verify=True)
        assert ei.value.kind == IndexErrorKind.CHECKSUM_MISMATCH


def test_durable_append_and_growth(tmp_path):
    p = str(tmp_path / "c.vx")
    with Container.create(p) as c:
        idx = c.add_array(SectionType.IDS, np.arange(8, dtype=np.int32), capacity_bytes=64)
        for i in range(5):  # past capacity: grow-with-copy relocation
            c.append(idx, np.arange(8 * (i + 1), 8 * (i + 2), dtype=np.int32))
        c.sync()
    with Container.open(p) as c:
        np.testing.assert_array_equal(c.read_array(SectionType.IDS), np.arange(48, dtype=np.int32))


_SEC_DESC_SIZE = 64
_HDR_SIZE = 256
_OFF_OFFSET = 8  # VCSection.offset
_OFF_NBYTES = 16  # VCSection.nbytes


def _patch_descriptor(path, sec_idx, raw_desc=None, nbytes=None, offset=None):
    """Rewrite a section's TOC descriptor in the file: a crash where the TOC
    page never reached the disk and the WAL did."""
    raw = bytearray(open(path, "rb").read())
    base = _HDR_SIZE + sec_idx * _SEC_DESC_SIZE
    if raw_desc is not None:
        raw[base: base + _SEC_DESC_SIZE] = raw_desc
    if nbytes is not None:
        struct.pack_into("<Q", raw, base + _OFF_NBYTES, nbytes)
    if offset is not None:
        struct.pack_into("<Q", raw, base + _OFF_OFFSET, offset)
    open(path, "wb").write(bytes(raw))


def test_wal_replay_recovers_unpublished_append(tmp_path):
    """Data and WAL commit written, the section length not published: a
    writable open rolls the length forward."""
    p = str(tmp_path / "c.vx")
    with Container.create(p) as c:
        idx = c.add_array(SectionType.IDS, np.arange(4, dtype=np.int32), capacity_bytes=4096)
        c.append(idx, np.arange(4, 8, dtype=np.int32))
        c.sync()
    _patch_descriptor(p, idx, nbytes=16)  # the pre-append length
    with Container.open(p, writable=True) as c:
        np.testing.assert_array_equal(c.read_array(SectionType.IDS), np.arange(8, dtype=np.int32))


def test_wal_reset(tmp_path):
    p = str(tmp_path / "c.vx")
    with Container.create(p) as c:
        idx = c.add_array(SectionType.IDS, np.arange(4, dtype=np.int32), capacity_bytes=4096)
        c.append(idx, np.arange(4, dtype=np.int32))
        c.wal_reset()
        assert c.wal_replay() == 0


def test_generation_counter(tmp_path):
    p = str(tmp_path / "c.vx")
    with Container.create(p) as c:
        assert c.generation == 1
        c.bump_generation()
        c.sync()
    with Container.open(p) as c:
        assert c.generation == 2


def test_multiple_sections_same_type(tmp_path):
    p = str(tmp_path / "c.vx")
    with Container.create(p) as c:
        c.add_array(SectionType.CODES, np.zeros(4, dtype=np.uint8))
        c.add_array(SectionType.CODES, np.ones(4, dtype=np.uint8))
    with Container.open(p) as c:
        np.testing.assert_array_equal(c.read_array(SectionType.CODES, 0), np.zeros(4, np.uint8))
        np.testing.assert_array_equal(c.read_array(SectionType.CODES, 1), np.ones(4, np.uint8))


def test_missing_section_raises(tmp_path):
    p = str(tmp_path / "c.vx")
    with Container.create(p):
        pass
    with Container.open(p) as c:
        with pytest.raises(IndexError):
            c.read_array(SectionType.CENTROIDS)


def test_compact_reclaims_dead_space(tmp_path):
    p, q = str(tmp_path / "big.vx"), str(tmp_path / "small.vx")
    with Container.create(p) as c:
        idx = c.add_array(SectionType.IDS, np.arange(8, dtype=np.int32), capacity_bytes=64)
        for i in range(6):  # repeated growth leaves relocated dead regions
            c.append(idx, np.arange(8 * (i + 1), 8 * (i + 2), dtype=np.int32))
        c.add_blob(SectionType.META, b"meta")
        c.bump_generation()
        c.sync()
    with Container.open(p, writable=True) as c:
        gen = c.generation
        c.compact_to(q).close()
    assert os.path.getsize(q) < os.path.getsize(p)
    with Container.open(q) as c2:
        np.testing.assert_array_equal(c2.read_array(SectionType.IDS), np.arange(56, dtype=np.int32))
        assert c2.read_blob(SectionType.META) == b"meta"
        assert c2.generation == gen + 1
        c2.verify_all()


def test_readonly_replay_rolls_forward_without_writing(tmp_path):
    """A committed, unpublished append is visible after a read-only open
    with replay, and the replay leaves the file as it was."""
    p = str(tmp_path / "ro.vx")
    with Container.create(p) as c:
        idx = c.add_array(SectionType.VECS, np.zeros((4, 8), np.float32), capacity_bytes=1024)
        c.append(idx, np.ones((4, 8), np.float32))
    _patch_descriptor(p, idx, nbytes=4 * 8 * 4)
    before = open(p, "rb").read()
    with Container.open(p, writable=False, replay=True) as c:
        flat = c.read_array(SectionType.VECS)
        assert flat.size == 64
        np.testing.assert_array_equal(flat.reshape(-1)[32:], np.ones(32, np.float32))
    assert open(p, "rb").read() == before


def test_replay_does_not_trust_stale_wal_length(tmp_path):
    """Replay scans WAL records by CRC; a zeroed TOC WAL length hides no
    committed append."""
    p = str(tmp_path / "wl.vx")
    with Container.create(p) as c:
        idx = c.add_array(SectionType.IDS, np.arange(8, dtype=np.int32), capacity_bytes=256)
        c.append(idx, np.arange(8, 16, dtype=np.int32))
    _patch_descriptor(p, 0, nbytes=0)
    _patch_descriptor(p, idx, nbytes=8 * 4)
    with Container.open(p, writable=False, replay=True) as c:
        np.testing.assert_array_equal(c.read_array(SectionType.IDS), np.arange(16, dtype=np.int32))


def test_replay_follows_relocation_across_lost_toc_sync(tmp_path):
    """A relocation and a crash before the TOC offset syncs: the WAL RELOC
    record redirects replay; a writable open repairs the file."""
    p = str(tmp_path / "rl.vx")
    with Container.create(p) as c:
        idx = c.add_array(SectionType.IDS, np.arange(8, dtype=np.int32), capacity_bytes=64)
        c.append(idx, np.arange(8, 16, dtype=np.int32))  # fills capacity
        c.sync()
    saved = open(p, "rb").read()[_HDR_SIZE + idx * _SEC_DESC_SIZE: _HDR_SIZE + (idx + 1) * _SEC_DESC_SIZE]
    with Container.open(p, writable=True) as c:
        c.append(idx, np.arange(16, 64, dtype=np.int32))  # forces relocation
    _patch_descriptor(p, idx, raw_desc=saved)
    with Container.open(p, writable=False, replay=True) as c:
        np.testing.assert_array_equal(c.read_array(SectionType.IDS), np.arange(64, dtype=np.int32))
    with Container.open(p, writable=True, replay=True):
        pass
    with Container.open(p, writable=False, replay=False) as c:
        np.testing.assert_array_equal(c.read_array(SectionType.IDS), np.arange(64, dtype=np.int32))


def test_wal_reset_cannot_resurrect_stale_records(tmp_path):
    p = str(tmp_path / "rs.vx")
    with Container.create(p) as c:
        idx = c.add_array(SectionType.IDS, np.arange(8, dtype=np.int32), capacity_bytes=256)
        c.append(idx, np.arange(8, 16, dtype=np.int32))
        c.wal_reset()
    with Container.open(p, writable=False, replay=True) as c:
        assert c.wal_replay() == 0


def test_readonly_mutations_rejected(tmp_path):
    p = str(tmp_path / "rd.vx")
    with Container.create(p) as c:
        c.add_array(SectionType.IDS, np.arange(8, dtype=np.int32))
    with Container.open(p, writable=False) as c:
        with pytest.raises(IndexError):
            c.append(SectionType.IDS, np.arange(4, dtype=np.int32))
        gen = c.generation
        c.bump_generation()  # ignored on read-only handles
        assert c.generation == gen


# ---------------------------------------------------------------------------
# Flat and HNSW containers (mirrors tests/test_container.py's index cases)
# ---------------------------------------------------------------------------


def test_flat_container_roundtrip(tmp_path):
    x = np.random.default_rng(4).standard_normal((40, 12)).astype(np.float32)
    idx = FlatIndex(12, device=CPU)
    for i in range(40):
        idx.insert(f"v{i}", x[i], {"i": i})
    idx.remove("v7")
    idx.remove("v2")
    p = str(tmp_path / "flat.vx")
    idx.save_container(p)
    loaded = FlatIndex.load_container(p, device=CPU)
    assert loaded.count == 38 and loaded._free == idx._free  # reuse order kept
    r = loaded.search(x[3], 1)[0]
    assert r.id == "v3" and r.metadata == {"i": 3}
    assert not loaded.contains("v7")
    for got in (loaded, idx):  # mutations after the load take the same slots
        got.insert("new", x[7])
        got.insert("new2", x[2])
    assert loaded._idmap.lookup("new") == idx._idmap.lookup("new")
    assert loaded.search(x[7], 1)[0].id == "new"


def test_flat_container_persists_norm_cache(tmp_path):
    """The NORMS_SQ section pre-warms the device mirror: bit for bit what a
    recompute gives, searchable at once, dropped by a later mutation."""
    x = np.random.default_rng(11).standard_normal((32, 8)).astype(np.float32)
    idx = FlatIndex(8, device=CPU)
    idx.insert_batch([f"v{i}" for i in range(32)], x)
    p = str(tmp_path / "flat_norms.vx")
    idx.save_container(p)
    with Container.open(p) as c:
        sqn = np.array(c.read_array(SectionType.NORMS_SQ, verify=True))
    np.testing.assert_allclose(sqn, np.einsum("nd,nd->n", x, x), rtol=1e-6)

    loaded = FlatIndex.load_container(p, device=CPU)
    assert loaded._dev is not None
    warm = [t.clone() for t in loaded._dev]
    loaded._dev = None
    for a, b in zip(warm, loaded._sync_device()):  # a recompute: equal bits
        assert torch.equal(a, b)
    assert (warm[1][32:] == 0).all()
    assert loaded.search(x[5], 1)[0].id == "v5"
    loaded.insert("new", x[5] * 2.0)
    assert loaded._dev is None
    assert loaded.search(x[5] * 2.0, 1)[0].id == "new"


def _hnsw_pair(x, metric=Metric.L2):
    """The same integer-valued rows built by both packages (equal graphs)."""
    ids = [f"v{i}" for i in range(len(x))]
    j = JHNSWIndex(x.shape[1], JMetric(metric.value), JHNSWConfig(**HNSW_CFG))
    j.insert_batch(ids, x)
    j._ensure_built()
    t = HNSWIndex(x.shape[1], metric, HNSWConfig(**HNSW_CFG), device=CPU)
    t.insert_batch(ids, x)
    t._ensure_built()
    return j, t


def _graph(idx):
    return (idx._entry, idx._levels[: idx._next_slot].tolist(), idx._lookup0.tolist(),
            [(list(l.node_ids), l.nbrs[: l.count].tolist()) for l in idx._layers])


@pytest.fixture(scope="module")
def int_rows():
    return np.random.default_rng(5).integers(-8, 9, (300, 16)).astype(np.float32)


def test_hnsw_container_roundtrip_no_rebuild(tmp_path, int_rows, monkeypatch):
    """The graph itself is restored: equal tables, backings and results, and
    no construction step runs at load or at the first search."""
    x = int_rows
    idx = HNSWIndex(16, Metric.COSINE, HNSWConfig(**HNSW_CFG), device=CPU)
    idx.insert_batch([f"v{i}" for i in range(300)], x)
    p = str(tmp_path / "hnsw.vx")
    idx.save_container(p)
    monkeypatch.setattr(HNSWIndex, "_build_chunk", lambda *a: pytest.fail("graph rebuilt"))
    loaded = HNSWIndex.load_container(p, device=CPU)
    assert _graph(loaded) == _graph(idx) and not loaded._pending
    assert [l.nbrs.shape for l in loaded._layers] == [l.nbrs.shape for l in idx._layers]
    assert np.array_equal(loaded._graph_vecs, idx._graph_vecs)  # cosine rows normalised alike
    assert loaded.config == idx.config and loaded._r2 == idx._r2
    q = x[:16] + 0.25
    ra, rb = idx.batch_search(q, 5), loaded.batch_search(q, 5)
    assert _ids(ra) == _ids(rb) and _scores(ra) == _scores(rb)


def test_hnsw_container_tombstones_and_growth(tmp_path):
    x = np.random.default_rng(6).standard_normal((120, 16)).astype(np.float32)
    idx = HNSWIndex(16, Metric.INNER_PRODUCT, HNSWConfig(m=4, ef_construction=24, build_chunk=32),
                    device=CPU)
    idx.insert_batch([f"v{i}" for i in range(120)], x)
    idx.remove("v3")
    p = str(tmp_path / "h2.vx")
    idx.save_container(p)
    loaded = HNSWIndex.load_container(p, device=CPU)
    assert not loaded.contains("v3")
    assert all(r.id != "v3" for r in loaded.search(x[3], 10))
    for got in (loaded, idx):  # inserts continue after the load, as on the live index
        got.insert("w0", x[3] + 4.0)
        got.insert_batch([f"w{i}" for i in range(1, 80)], x[:79] * 0.5)
        assert got.search(x[3] + 4.0, 1)[0].id == "w0"
    assert _graph(loaded) == _graph(idx)


# ---------------------------------------------------------------------------
# the two packages read each other's files
# ---------------------------------------------------------------------------


def _sections(open_fn, path):
    """Every section but the WAL as (type, nth, bytes, shape)."""
    out = []
    with open_fn(path) as c:
        for typ in SectionType:
            if typ == SectionType.WAL:
                continue
            for nth in range(8):
                if c.find(typ, nth) < 0:
                    break
                a = c.read_array(typ, nth)
                out.append((int(typ), nth, a.tobytes(), a.shape))
    return sorted(out)


def test_flat_container_crosses_packages(tmp_path):
    """A flat (f32) container of either package loads in the other with
    equal sections (META aside: the port's adds keys); ids and scores equal
    (integer-valued rows: every distance is exact in both packages)."""
    x = np.random.default_rng(7).integers(-8, 9, (300, 16)).astype(np.float32)
    q = x[:8] + 0.5
    j = JFlatIndex(16)
    j.insert_batch(list(range(300)), x, [{"i": i} for i in range(300)])
    j.remove(11)
    jp = str(tmp_path / "j.vx")
    j.save_container(jp)
    t = FlatIndex.load_container(jp, device=CPU)
    tp = str(tmp_path / "t.vx")
    t.save_container(tp)
    meta = int(SectionType.META)
    strip = lambda secs: [s for s in secs if s[0] != meta]  # noqa: E731
    assert strip(_sections(JContainer.open, jp)) == strip(_sections(Container.open, tp))
    assert _sections(JContainer.open, tp) == _sections(Container.open, tp)
    j2 = JFlatIndex.load_container(tp)
    for got in (t.batch_search(q, 10), j2.batch_search(q, 10)):
        want = j.batch_search(q, 10)
        assert _ids(got) == _ids(want) and _scores(got) == _scores(want)
        assert got[0][0].metadata == want[0][0].metadata


def test_hnsw_container_crosses_packages(tmp_path, int_rows):
    """HNSW over integer-valued rows: both packages build the same graph and
    write equal sections (META aside); each package's container loads in
    the other with the writer's graph field by field and the same search
    ids."""
    j, t = _hnsw_pair(int_rows)
    assert _graph(j) == _graph(t)
    jp, tp = str(tmp_path / "j.vx"), str(tmp_path / "t.vx")
    j.save_container(jp)
    t.save_container(tp)
    meta = int(SectionType.META)
    strip = lambda secs: [s for s in secs if s[0] != meta]  # noqa: E731
    assert strip(_sections(JContainer.open, jp)) == strip(_sections(Container.open, tp))
    from_j = HNSWIndex.load_container(jp, device=CPU)
    from_t = JHNSWIndex.load_container(tp)
    assert _graph(from_j) == _graph(t) and _graph(from_t) == _graph(j)
    q = int_rows[:12] + 0.5
    want = _ids(j.batch_search(q, 10))
    assert _ids(from_j.batch_search(q, 10)) == want == _ids(from_t.batch_search(q, 10))


def test_flat_bf16_container_keeps_storage_dtype(tmp_path):
    """The JAX flat container drops storage_dtype and reloads bf16 as f32;
    the port's keeps it, so the same queries score as before the save."""
    x = np.random.default_rng(0).standard_normal((600, 16)).astype(np.float32)
    idx = FlatIndex(16, storage_dtype=torch.bfloat16, device=CPU)
    idx.insert_batch(list(range(600)), x)
    p = str(tmp_path / "bf16.vx")
    idx.save_container(p)
    loaded = load_index(p, device=CPU)
    assert isinstance(loaded, FlatIndex) and loaded.storage_dtype == torch.bfloat16
    q = x[:4] + 0.05
    want, got = idx.batch_search(q, 5), loaded.batch_search(q, 5)
    assert _ids(got) == _ids(want) and _scores(got) == _scores(want)


def test_bf16_section_roundtrip(tmp_path):
    """bf16 (tag 8): a torch.bfloat16 tensor's bits are written raw and come
    back as uint16 bits or as a bf16 tensor, in either package."""
    p = str(tmp_path / "bf16.vx")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    with Container.create(p) as c:
        c.add_array(SectionType.VECS, xb)
    with Container.open(p) as c:
        bits = c.read_array(SectionType.VECS)
        assert bits.dtype == np.uint16 and bits.shape == (16, 8)
        assert bits.tobytes() == xb.view(torch.int16).numpy().tobytes()
        got = c.read_tensor(SectionType.VECS)
        assert got.dtype == torch.bfloat16 and torch.equal(got, xb)
    import ml_dtypes  # the JAX side only

    with JContainer.open(p) as c:
        jx = c.read_array(SectionType.VECS)
        assert jx.dtype == np.dtype(ml_dtypes.bfloat16)
        np.testing.assert_array_equal(jx.astype(np.float32), xb.float().numpy())


# ---------------------------------------------------------------------------
# the native library's build
# ---------------------------------------------------------------------------


def test_container_builds_under_build_from_the_ports_own_source(tmp_path, monkeypatch):
    """container.cpp is the port's own copy; the library is built with g++
    into build/container/<hash of source and flags>/, never into a package,
    and a failed build raises with the compiler's output."""
    assert pc.CONTAINER_SRC.is_relative_to(os.path.join(ROOT, "vectorindex_tpu_torch"))
    assert "vc_check_bounds" in pc.CONTAINER_SRC.read_text()  # the port's bounds checks
    lib = pc.load_library()
    path = pc.library_path()
    assert lib._name == str(path) and path.exists()
    assert path.is_relative_to(os.path.join(ROOT, "build", "container"))
    assert not path.is_relative_to(os.path.join(ROOT, "vectorindex_tpu_torch"))
    assert not path.is_relative_to(os.path.join(ROOT, "vectorindex_tpu"))
    src = tmp_path / "container.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(pc, "CONTAINER_SRC", src)
    monkeypatch.setattr(pc, "BUILD_ROOT", tmp_path / "out")
    assert pc.library_path() != path  # keyed by the source
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pc._build()
    assert not list((tmp_path / "out").rglob("*.so"))
