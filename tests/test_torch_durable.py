"""The port's durable IVF container (vectorindex_tpu_torch.persistence.durable)
as tests/test_durable.py checks the JAX package's, against the JAX package
(a container written by either package loads in the other), and
models.load_index.

Tolerances: within the port, a reloaded index gives the live index's ids
and scores exactly. Across packages the two search through different
routes with f32 sums in other orders: ids must be equal except at a rank
whose JAX distance lies within RTOL/ATOL (rtol=2e-4, atol=2e-5) of a
neighbouring rank's (utils/parity), distances within the same tolerance.
"""

import json

import numpy as np
import pytest
import torch

from vectorindex_tpu.models.ivf import IVFConfig as JIVFConfig
from vectorindex_tpu.models.ivf import IVFIndex as JIVFIndex
from vectorindex_tpu.models.ivf import IVFPQConfig as JIVFPQConfig
from vectorindex_tpu.models.ivf import IVFPQIndex as JIVFPQIndex
from vectorindex_tpu.persistence import durable as jdurable
from vectorindex_tpu.persistence.container import Container as JContainer
from vectorindex_tpu_torch.models import (
    FlatIndex,
    HNSWConfig,
    HNSWIndex,
    IVFConfig,
    IVFIndex,
    IVFPQConfig,
    IVFPQIndex,
    ShardedFlatIndex,
    load_index,
)
from vectorindex_tpu_torch.persistence import durable
from vectorindex_tpu_torch.persistence.container import Container, SectionType
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.errors import IndexError, IndexErrorKind
from vectorindex_tpu_torch.utils.parity import ATOL, RTOL, ids_match_up_to_ties

torch.set_num_threads(1)

CPU = "cpu"
K = 10


def _data(n=300, d=16, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _ids(res):
    return [[r.id for r in row] for row in res]


def _scores(res):
    return [[r.score for r in row] for row in res]


def _assert_same_as_jax(got, want):
    """got: the port's rows for K; want: the JAX package's for K + 1 (L2)."""
    assert [len(r) for r in got] == [min(K, len(r)) for r in want]
    for g_row, w_row in zip(got, want):
        wd = np.array([[r.score for r in w_row]], dtype=np.float64) ** 2
        gd = np.array([[r.score for r in g_row]], dtype=np.float64) ** 2
        np.testing.assert_allclose(gd, wd[:, : len(g_row)], rtol=RTOL, atol=ATOL)
        assert ids_match_up_to_ties([[r.id for r in g_row]], [[r.id for r in w_row]], wd,
                                    len(g_row))


def _same_index(a, b):
    """b reloaded from a: the same lists in the same order, slots, free
    list, ids and metadata."""
    assert type(a) is type(b) and a.config == b.config and a.storage_dtype == b.storage_dtype
    assert a._store._lists_ids == b._store._lists_ids
    assert a._slot_list == b._slot_list and a._free == b._free
    assert a._next_slot == b._next_slot and dict(a._idmap.items()) == dict(b._idmap.items())
    assert {s: m for s, m in a._metadata.items() if m is not None} == \
        {s: m for s, m in b._metadata.items() if m is not None}
    assert sorted(a._vectors) == sorted(b._vectors)
    assert all(np.array_equal(a._vectors[s], b._vectors[s]) for s in a._vectors)


# ---------------------------------------------------------------------------
# mirrors tests/test_durable.py
# ---------------------------------------------------------------------------


def test_container_roundtrip_trained(tmp_path):
    x = _data()
    idx = IVFIndex(16, config=IVFConfig(nlist=8, nprobe=8), device=CPU)
    idx.insert_batch([f"v{i}" for i in range(300)], x, [{"i": i} for i in range(300)])
    idx.optimize()
    p = str(tmp_path / "ivf.vx")
    idx.enable_durable(p)
    idx.close_durable()
    idx2 = IVFIndex.load_durable(p, device=CPU)
    assert idx2.count == 300 and idx2.trained
    _same_index(idx, idx2)
    q = x[:6] + 0.1
    a, b = idx.batch_search(q, 5), idx2.batch_search(q, 5)
    assert _ids(a) == _ids(b) and _scores(a) == _scores(b)
    assert idx2.search(x[5], k=1)[0].metadata == {"i": 5}


def test_journal_replays_post_checkpoint_mutations(tmp_path):
    x = _data(400)
    idx = IVFIndex(16, config=IVFConfig(nlist=8, nprobe=8), device=CPU)
    idx.insert_batch(list(range(300)), x[:300])
    idx.optimize()
    p = str(tmp_path / "ivf.vx")
    idx.enable_durable(p)
    idx.insert_batch(list(range(300, 350)), x[300:350])  # journaled, no checkpoint
    idx.remove(10)
    idx.update(20, vector=x[399])
    idx.insert(360, x[360], metadata={"single": True})
    idx.close_durable()
    idx2 = IVFIndex.load_durable(p, device=CPU)
    assert idx2.count == 350
    assert idx2.search(x[320], k=1)[0].id == 320
    assert not idx2.contains(10)
    assert idx2.search(x[399], k=1)[0].id == 20
    _same_index(idx, idx2)
    q = x[::40] + 0.05
    assert _ids(idx.batch_search(q, K)) == _ids(idx2.batch_search(q, K))


def test_checkpoint_truncates_journal_and_bumps_generation(tmp_path):
    x = _data(200)
    idx = IVFIndex(16, config=IVFConfig(nlist=4, nprobe=4), device=CPU)
    idx.insert_batch(list(range(150)), x[:150])
    idx.optimize()
    p = str(tmp_path / "ivf.vx")
    idx.enable_durable(p)
    with Container.open(p) as c:
        gen = c.generation
    idx.insert_batch(list(range(150, 200)), x[150:])
    idx.checkpoint()
    idx.remove(3)  # journaled into the new container
    idx.close_durable()
    with Container.open(p) as c:
        assert c.generation == gen + 1
        journal = c.read_array(SectionType.FREELIST)
        assert 0 < journal.size < 64  # the checkpoint took the inserts
    assert not (tmp_path / "ivf.vx.checkpoint").exists()
    idx2 = IVFIndex.load_durable(p, device=CPU)
    assert idx2.count == 199
    assert idx2.search(x[170], k=1)[0].id == 170
    _same_index(idx, idx2)


def test_untrained_container_roundtrip(tmp_path):
    x = _data(50)
    idx = IVFIndex(16, config=IVFConfig(nlist=4), device=CPU)
    idx.insert_batch(list(range(50)), x)
    p = str(tmp_path / "u.vx")
    idx.enable_durable(p)
    idx.close_durable()
    idx2 = IVFIndex.load_durable(p, device=CPU)
    assert idx2.count == 50 and not idx2.trained
    assert idx2.search(x[3], k=1)[0].id == 3


@pytest.mark.parametrize("host_rerank", [False, True], ids=["device_tier", "host_tier"])
def test_ivfpq_container_restores_codebooks(tmp_path, host_rerank):
    """Codebooks restored bit for bit (codes are encoded again at the first
    search); the host-rerank tier's config survives the reload."""
    rng = np.random.default_rng(5)
    centers = rng.standard_normal((8, 16)).astype(np.float32) * 2
    x = (centers[rng.integers(0, 8, 400)] + 0.2 * rng.standard_normal((400, 16))).astype(np.float32)
    idx = IVFPQIndex(16, config=IVFPQConfig(nlist=4, nprobe=4, m=4, ks=16, host_rerank=host_rerank),
                     device=CPU)
    idx.insert_batch(list(range(400)), x)
    idx.optimize()
    p = str(tmp_path / "pq.vx")
    idx.enable_durable(p)
    idx.close_durable()
    idx2 = IVFIndex.load_durable(p, device=CPU)
    assert isinstance(idx2, IVFPQIndex) and idx2.pq_trained
    assert idx2.config == idx.config and idx2.config.host_rerank == host_rerank
    assert torch.equal(idx2._books.centroids, idx._books.centroids)
    assert torch.equal(idx2._books.sqnorms, idx._books.sqnorms)
    q = x[:8] + 0.01
    a, b = idx.batch_search(q, 5), idx2.batch_search(q, 5)
    assert _ids(a) == _ids(b) and _scores(a) == _scores(b)


def test_journal_replay_prunes_reused_free_slots(tmp_path):
    """A post-checkpoint insert that reuses a checkpointed free slot leaves
    the free list on recovery (else the next insert overwrites it)."""
    d = 8
    idx = IVFIndex(d, config=IVFConfig(nlist=2, nprobe=2), device=CPU)
    va, vb, vc_, vd = [np.full(d, float(i), np.float32) for i in range(1, 5)]
    idx.insert("a", va)
    idx.insert("b", vb)
    idx.remove("b")  # slot 1 freed, in the checkpoint's TOMBSTONES
    p = str(tmp_path / "fl.vx")
    idx.enable_durable(p)
    idx.insert("c", vc_)  # reuses slot 1, journaled
    idx.close_durable()
    idx2 = IVFIndex.load_durable(p, device=CPU)
    assert 1 not in idx2._free
    idx2.insert("d", vd)
    assert idx2.search(vc_, k=1)[0].id == "c" and idx2.search(vd, k=1)[0].id == "d"
    assert not (set(idx2._free) & set(idx2._vectors))


def test_journal_preserves_post_checkpoint_metadata(tmp_path):
    d = 8
    x = _data(20, d)
    idx = IVFIndex(d, config=IVFConfig(nlist=2, nprobe=2), device=CPU)
    idx.insert_batch([f"v{i}" for i in range(10)], x[:10])
    p = str(tmp_path / "md.vx")
    idx.enable_durable(p)
    idx.insert("j1", x[10], metadata={"tag": "journaled"})
    idx.insert_batch(["j2", "j3"], x[11:13], metadatas=[{"n": 2}, {"n": 3}])
    idx.update("v0", metadata={"patched": True})  # metadata only
    idx.close_durable()
    idx2 = IVFIndex.load_durable(p, device=CPU)
    assert idx2.search(x[10], k=1)[0].metadata == {"tag": "journaled"}
    assert idx2.search(x[12], k=1)[0].metadata == {"n": 3}
    assert idx2.search(x[0], k=1)[0].metadata == {"patched": True}


def test_journal_capacity_is_the_references_and_an_append_past_it_raises(tmp_path):
    """The WAL holds JOURNAL_CAPACITY bytes (1 << 22, ~65k mutations); an
    append past the WAL raises instead of losing the record."""
    assert durable.JOURNAL_CAPACITY == 1 << 22
    idx = IVFIndex(8, config=IVFConfig(nlist=2, nprobe=2), device=CPU)
    idx.insert("a", np.ones(8, np.float32))
    p = str(tmp_path / "cap.vx")
    durable.save_ivf_container(idx, p, journal_capacity=256)  # 8 WAL records
    with Container.open(p, writable=True) as c:
        with pytest.raises(IndexError) as ei:
            for i in range(8):
                durable.append_journal(c, durable.REC_META, 0, -1, None, ext_id="a",
                                       metadata={"i": i})
        assert ei.value.kind == IndexErrorKind.IO_ERROR


# ---------------------------------------------------------------------------
# the reference faults the port does not copy
# ---------------------------------------------------------------------------


def test_durable_bf16_keeps_storage_dtype(tmp_path):
    """The JAX durable container drops storage_dtype (a bf16 index reloads
    as f32); the port's keeps it and reloads to equal results."""
    x = _data(600)
    idx = IVFIndex(16, config=IVFConfig(nlist=8), storage_dtype=torch.bfloat16, device=CPU)
    idx.insert_batch(list(range(600)), x)
    idx.optimize()
    p = str(tmp_path / "bf16.vx")
    idx.enable_durable(p)
    idx.close_durable()
    idx2 = IVFIndex.load_durable(p, device=CPU)
    assert idx2.storage_dtype == torch.bfloat16
    q = x[:8] + 0.05
    a, b = idx.batch_search(q, K), idx2.batch_search(q, K)
    assert _ids(a) == _ids(b) and _scores(a) == _scores(b)


def _spill_index(x):
    idx = IVFPQIndex(16, config=IVFPQConfig(nlist=8, nprobe=2, m=4, ks=16, spill_eps=0.5,
                                            rerank_c=32), device=CPU)
    idx.insert_batch(list(range(len(x))), x)
    idx.optimize()
    return idx


def test_durable_spill_keeps_spill_eps_and_no_duplicates(tmp_path):
    """The JAX durable container drops spill_eps but keeps both copies of
    each spilled row, so its reload returns ids twice; the port's reloads
    each slot's primary and spill lists, with dedup on."""
    x = _data(600)
    idx = _spill_index(x)
    assert idx._slot_spill
    p = str(tmp_path / "spill.vx")
    idx.enable_durable(p)
    idx.close_durable()
    idx2 = IVFIndex.load_durable(p, device=CPU)
    assert idx2.config.spill_eps == 0.5 and idx2._slot_spill == idx._slot_spill
    _same_index(idx, idx2)
    q = x[:8]
    a, b = idx.batch_search(q, K), idx2.batch_search(q, K)
    assert _ids(a) == _ids(b) and _scores(a) == _scores(b)
    assert all(len(set(row)) == len(row) == K for row in _ids(b))


def test_durable_spill_replays_updates_and_removes_and_refuses_inserts(tmp_path):
    """A spill index journals updates and removes (the spill copy moves or
    goes as on the live index) and refuses journaled inserts, as the JAX
    package does."""
    x = _data(600)
    idx = _spill_index(x)
    p = str(tmp_path / "spill_j.vx")
    idx.enable_durable(p)
    with pytest.raises(IndexError) as ei:
        idx.insert(1000, x[0])
    assert ei.value.kind == IndexErrorKind.INVALID_CONFIGURATION
    spilled = sorted(idx._slot_spill)[:4]
    idx.remove(spilled[0])
    idx.update(spilled[1], vector=x[7] + 0.3)
    idx.update(5, vector=x[spilled[2]] * 1.01)
    idx.close_durable()
    idx2 = IVFIndex.load_durable(p, device=CPU)
    _same_index(idx, idx2)
    assert idx2._slot_spill == idx._slot_spill
    q = x[:8] + 0.05
    assert _ids(idx.batch_search(q, K)) == _ids(idx2.batch_search(q, K))


# ---------------------------------------------------------------------------
# the two packages read each other's containers
# ---------------------------------------------------------------------------


def _sections(open_fn, path):
    out = {}
    with open_fn(path) as c:
        for typ in (SectionType.CENTROIDS, SectionType.VECS, SectionType.IDS,
                    SectionType.LISTS_DESC, SectionType.CODEBOOKS, SectionType.TOMBSTONES):
            if c.find(typ) >= 0:
                a = c.read_array(typ)
                out[typ.name] = (a.shape, a.tobytes())
        out["META"] = json.loads(c.read_blob(SectionType.META))
    return out


def _dense(secs):
    """The rows of a container's lists, list after list (the JAX package
    writes its packed layout with gaps, the port without)."""
    if "LISTS_DESC" not in secs:
        return secs["VECS"], secs["IDS"]
    desc = np.frombuffer(secs["LISTS_DESC"][1], np.int32).reshape(-1, 2)
    rows = durable._csr_rows(desc[:, 0], desc[:, 1])
    v = np.frombuffer(secs["VECS"][1], np.float32).reshape(secs["VECS"][0])[rows]
    i = np.frombuffer(secs["IDS"][1], np.int32)[rows]
    return v.tobytes(), i.tobytes(), desc[:, 1].tobytes()


@pytest.mark.parametrize("kind", ["ivf", "ivf_untrained", "pq16"])
def test_durable_container_crosses_packages(tmp_path, kind):
    """IVF (trained and untrained, f32) and IVF-PQ pq16: the JAX package's
    container (with a journal) loads in the port, the port's in the JAX
    package; sections agree (the lists' rows in order, centroids,
    codebooks, free slots) and the searches match up to ties."""
    x = _data(600, 32, seed=2)
    q = x[::75] + 0.05
    if kind == "pq16":
        j = JIVFPQIndex(32, config=JIVFPQConfig(nlist=8, nprobe=2, m=16, ks=256, rerank_c=512))
    else:
        j = JIVFIndex(32, config=JIVFConfig(nlist=8, nprobe=2))
    j.insert_batch(list(range(560)), x[:560])
    if kind != "ivf_untrained":
        j.optimize()
    jp = str(tmp_path / "j.vx")
    j.enable_durable(jp)
    if kind != "pq16":
        j.insert_batch(list(range(560, 600)), x[560:])
    j.remove(7)
    j.update(8, metadata={"m": 8})
    j.close_durable()

    t = IVFIndex.load_durable(jp, device=CPU)
    assert type(t).__name__ == type(j).__name__ and t.count == j.count
    assert t._store._lists_ids == [list(l) for l in j._store._lists_ids]
    assert t.search(x[8], 1)[0].metadata == {"m": 8}
    _assert_same_as_jax(t.batch_search(q, K), j.batch_search(q, K + 1))
    tp = str(tmp_path / "t.vx")
    t.enable_durable(tp)
    t.close_durable()
    a, b = _sections(Container.open, tp), _sections(JContainer.open, tp)
    assert a == b
    jc = str(tmp_path / "jc.vx")  # the JAX package's checkpoint of its live state
    jdurable.save_ivf_container(j, jc)
    want = _sections(JContainer.open, jc)
    assert _dense(a) == _dense(want)
    for name in ("CENTROIDS", "CODEBOOKS", "TOMBSTONES"):
        assert a.get(name) == want.get(name)
    j2 = JIVFIndex.load_durable(tp)
    assert type(j2) is type(j) and [list(l) for l in j2._store._lists_ids] == t._store._lists_ids
    if kind == "pq16":
        assert np.array_equal(np.asarray(j2._books.centroids), t._books.centroids.numpy())
    _assert_same_as_jax(t.batch_search(q, K), j2.batch_search(q, K + 1))


# ---------------------------------------------------------------------------
# load_index
# ---------------------------------------------------------------------------


def test_load_index_dispatches_every_format(tmp_path):
    """JSON snapshots of flat, hnsw, ivf, ivfpq and sharded_flat and binary
    containers by their META; a META that does not parse is CORRUPT_DATA;
    an unknown snapshot type is INVALID_CONFIGURATION."""
    x = _data(300)
    flat = FlatIndex(16, device=CPU)
    hnsw = HNSWIndex(16, config=HNSWConfig(m=4, ef_construction=24, build_chunk=32), device=CPU)
    ivf = IVFIndex(16, config=IVFConfig(nlist=4), device=CPU)
    pq = IVFPQIndex(16, config=IVFPQConfig(nlist=4, m=4, ks=16), device=CPU)
    for idx in (flat, hnsw, ivf, pq):
        idx.insert_batch(list(range(300)), x)
    pq.optimize()
    for idx in (flat, hnsw, ivf, pq):
        p = str(tmp_path / f"{idx.TYPE}.json")
        idx.save(p)
        assert type(load_index(p, device=CPU)) is type(idx)
    flat.save_container(str(tmp_path / "flat.vx"))
    hnsw.save_container(str(tmp_path / "hnsw.vx"))
    ivf.enable_durable(str(tmp_path / "ivf.vx"))
    ivf.close_durable()
    pq.enable_durable(str(tmp_path / "pq.vx"))
    pq.close_durable()
    for name, cls in (("flat", FlatIndex), ("hnsw", HNSWIndex), ("ivf", IVFIndex),
                      ("pq", IVFPQIndex)):
        got = load_index(str(tmp_path / f"{name}.vx"), device=CPU)
        assert type(got) is cls and got.count == 300
    bad = str(tmp_path / "bad.vx")
    with Container.create(bad) as c:
        c.add_blob(SectionType.META, b"{not json")
    with pytest.raises(IndexError) as ei:
        load_index(bad, device=CPU)
    assert ei.value.kind == IndexErrorKind.CORRUPT_DATA
    sharded = ShardedFlatIndex(16, n_devices=2, device=CPU)
    sharded.insert_batch(list(range(300)), x)
    sharded.save(str(tmp_path / "sharded.json"))
    got = load_index(str(tmp_path / "sharded.json"), device=CPU)
    assert type(got) is ShardedFlatIndex and got.count == 300
    unknown = tmp_path / "unknown.json"
    unknown.write_text(json.dumps({"type": "sharded_ivf", "records": []}))
    with pytest.raises(IndexError) as ei:
        load_index(str(unknown), device=CPU)
    assert ei.value.kind == IndexErrorKind.INVALID_CONFIGURATION
