"""The port's benchmark library (vectorindex_tpu_torch.bench: datagen, cache,
synth, timing, harness) against the JAX package's bench subpackage, on the
same seeded numpy inputs, on the CPU.

Tolerances:
  - corpus and query generators, *vecs files, the CSR layout of pack_ivf
    (starts, lengths, row_ids, order, probe_cap, sqnorms, vecs on the first
    d columns): exactly equal, byte for byte.
  - trained_quantizer: the two packages' k-means draw from different
    generators, so only the port's own argmin is exact; its inertia must
    lie within 10% of the JAX quantizer's.
  - pq_csr_state: codes and corrections equal the port's own encode of the
    returned books exactly; the JAX encode of the same books gives the same
    codes except where the two chosen entries' f64 distances lie within
    1e-5 (relative) of each other (a near-tie summed in another order).
  - exact truth and brute_force_topk: ids equal the JAX functions' up to
    near-ties of the f64 distances (utils/parity, rtol=2e-4, atol=2e-5).
  - time_loop: its outputs equal a direct loop's exactly (same calls, same
    order of the sums).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorindex_tpu.bench import cache as jcache
from vectorindex_tpu.bench import datagen as jdatagen
from vectorindex_tpu.bench import harness as jharness
from vectorindex_tpu.bench import synth as jsynth
from vectorindex_tpu.ops import pq as jpq
from vectorindex_tpu.utils.config import Metric as JMetric
from vectorindex_tpu_torch.bench import cache, datagen, harness, synth, timing
from vectorindex_tpu_torch.ops import dtypes, pq
from vectorindex_tpu_torch.ops import ivf as tivf
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.parity import ids_match_up_to_ties

torch.set_num_threads(1)

N, D, NLIST = 4000, 32, 16
CPU = "cpu"


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("VECTORINDEX_BENCH_CACHE", str(tmp_path / "bc"))


# -- datagen and the corpus generators: byte-equal --


@pytest.mark.parametrize(
    "name, call",
    [
        ("generate", lambda m: m.generate(N, D, seed=3)),
        ("generate_raw", lambda m: m.generate(N, D, seed=3, normalized=False)),
        ("queries_from", lambda m: m.queries_from(m.generate(500, D), 40, noise=0.01, seed=5)),
        ("generate_clustered", lambda m: m.generate_clustered(N, D, n_clusters=NLIST, seed=4)),
        ("generate_clustered_raw",
         lambda m: m.generate_clustered(N, D, n_clusters=NLIST, seed=4, normalized=False)),
    ],
)
def test_datagen_is_byte_equal(name, call):
    a, b = call(jdatagen), call(datagen)
    assert a.dtype == b.dtype == np.float32
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize(
    "name, call",
    [
        ("clustered_corpus", lambda m: m.clustered_corpus(N, D, NLIST, seed=6)),
        ("lowdim_corpus", lambda m: m.lowdim_corpus(N, D, dz=8, seed=7)),
        ("lowdim_queries", lambda m: m.lowdim_queries(m.lowdim_corpus(50, D, seed=7)[1], 33, seed=9)),
    ],
)
def test_synth_generators_are_byte_equal(name, call):
    a, b = call(jsynth), call(synth)
    a, b = (a,) if isinstance(a, np.ndarray) else a, (b,) if isinstance(b, np.ndarray) else b
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and u.tobytes() == v.tobytes()


def test_vecs_files_cross_packages(tmp_path):
    x = datagen.generate(37, 12, seed=1)
    for writer, reader, tag in ((jdatagen, datagen, "j"), (datagen, jdatagen, "t")):
        path = str(tmp_path / f"{tag}.fvecs")
        writer.write_fvecs(path, x)
        np.testing.assert_array_equal(reader.read_fvecs(path), x)
        np.testing.assert_array_equal(reader.read_fvecs(path, max_rows=5), x[:5])
    ints = np.random.default_rng(2).integers(0, 1000, (9, 7)).astype(np.int32)
    rows = np.concatenate([np.full((9, 1), 7, np.int32), ints], axis=1)
    rows.tofile(str(tmp_path / "g.ivecs"))
    b = np.random.default_rng(3).integers(0, 256, (6, 10)).astype(np.uint8)
    with open(tmp_path / "g.bvecs", "wb") as f:
        for r in b:
            f.write(np.int32(10).tobytes() + r.tobytes())
    for mod in (jdatagen, datagen):
        np.testing.assert_array_equal(mod.read_ivecs(str(tmp_path / "g.ivecs")), ints)
        np.testing.assert_array_equal(mod.read_bvecs(str(tmp_path / "g.bvecs")), b.astype(np.float32))
    empty = tmp_path / "e.fvecs"
    empty.write_bytes(b"")
    assert datagen.read_fvecs(str(empty)).shape == jdatagen.read_fvecs(str(empty)).shape == (0, 0)


# -- cache: tests/test_bench_cache.py's cases on the port's cache --


def test_cache_round_trip_and_build_s():
    calls = {"n": 0}

    def build():
        calls["n"] += 1
        return {"a": np.arange(6, dtype=np.float32).reshape(2, 3)}

    art, was_cached = cache.cached("rt_v1", build)
    assert not was_cached and calls["n"] == 1
    assert "build_s" in art and float(art["build_s"]) >= 0.0
    art2, was_cached2 = cache.cached("rt_v1", build)
    assert was_cached2 and calls["n"] == 1
    np.testing.assert_array_equal(art2["a"], art["a"])
    assert float(art2["build_s"]) == float(art["build_s"])


def test_cache_big_arrays_become_mmap_sidecars(monkeypatch):
    monkeypatch.setattr(cache, "_MMAP_THRESHOLD", 1024)
    big = np.arange(4096, dtype=np.float32).reshape(64, 64)
    art, was_cached = cache.cached("mm_v1", lambda: {"x": big, "s": np.float64(7.0)})
    assert not was_cached and isinstance(art["x"], np.memmap)
    np.testing.assert_array_equal(np.asarray(art["x"]), big)
    assert os.path.exists(os.path.join(cache.cache_dir(), "mm_v1__x.npy"))
    art2, was_cached2 = cache.cached("mm_v1", lambda: pytest.fail("rebuilt"))
    assert was_cached2 and isinstance(art2["x"], np.memmap)
    np.testing.assert_array_equal(np.asarray(art2["x"]), big)
    assert float(art2["s"]) == 7.0
    with pytest.raises((ValueError, OSError)):
        art2["x"][0, 0] = 1.0


def test_cache_small_arrays_stay_in_npz(monkeypatch):
    monkeypatch.setattr(cache, "_MMAP_THRESHOLD", 1 << 30)
    art, _ = cache.cached("sm_v1", lambda: {"x": np.ones((64, 64), dtype=np.float32)})
    assert not isinstance(art["x"], np.memmap)
    assert not os.path.exists(os.path.join(cache.cache_dir(), "sm_v1__x.npy"))


def test_cache_missing_sidecar_invalidates_and_rebuilds(monkeypatch):
    monkeypatch.setattr(cache, "_MMAP_THRESHOLD", 1024)
    big = np.ones((64, 64), dtype=np.float32)
    cache.cached("inv_v1", lambda: {"x": big})
    os.remove(os.path.join(cache.cache_dir(), "inv_v1__x.npy"))
    calls = {"n": 0}

    def rebuild():
        calls["n"] += 1
        return {"x": 2.0 * big}

    art, was_cached = cache.cached("inv_v1", rebuild)
    assert not was_cached and calls["n"] == 1
    np.testing.assert_array_equal(np.asarray(art["x"]), 2.0 * big)


def test_cache_keeps_the_packages_apart():
    """A JAX artifact under the same key is not the port's, and the port's
    directory lies inside the one both packages compute."""
    jcache.cached("quantizer_v1", lambda: {"c": np.zeros(3, np.float32)})
    art, was_cached = cache.cached("quantizer_v1", lambda: {"c": np.ones(3, np.float32)})
    assert not was_cached and (art["c"] == 1).all()
    assert os.path.dirname(cache.cache_dir()) == jcache.cache_dir()
    art_j, was_cached_j = jcache.cached("quantizer_v1", lambda: pytest.fail("rebuilt"))
    assert was_cached_j and (art_j["c"] == 0).all()


# -- synth: pack_ivf, trained_quantizer, pq_csr_state --


@pytest.fixture(scope="module")
def clustered():
    x, centers, assign = jsynth.clustered_corpus(N, D, NLIST, seed=11)
    return x, centers, assign


def _np(a):
    return None if a is None else (a.float() if a.dtype == torch.bfloat16 else a).numpy()


@pytest.mark.parametrize("case", ["bf16", "f32", "spill", "no_vecs"])
def test_pack_ivf_layout_equals_the_reference(clustered, case):
    x, centers, assign = clustered
    src = None
    kw = {}
    if case == "spill":
        x = datagen.generate(N, D, seed=12)  # i.i.d. rows: many lie between two lists
        src, assign, frac = tivf.spill_assign(x, x[:NLIST], eps=0.3)
        assert frac > 0.1
        kw["src"] = src
    if case == "no_vecs":
        kw["with_vecs"] = False
    if case == "f32":
        want = jsynth.pack_ivf(x, assign, NLIST, storage_dtype=jnp.float32, **kw)
        got = synth.pack_ivf(x, assign, NLIST, storage_dtype=torch.float32, device=CPU, **kw)
    else:
        want = jsynth.pack_ivf(x, assign, NLIST, **kw)
        got = synth.pack_ivf(x, assign, NLIST, device=CPU, **kw)
    (ja, jorder, jcap), (ta, torder, tcap) = want, got
    assert tcap == jcap and torder.dtype == np.int32
    np.testing.assert_array_equal(torder, jorder)
    for name in ("starts", "lengths", "row_ids"):
        np.testing.assert_array_equal(_np(getattr(ta, name)), np.asarray(getattr(ja, name)), name)
    if case == "no_vecs":
        assert ta.vecs is None and ta.sqnorms is None
        return
    assert ta.vecs.dtype == (torch.float32 if case == "f32" else torch.bfloat16)
    assert ta.vecs.shape[1] == D  # no lane padding
    np.testing.assert_array_equal(_np(ta.vecs), np.asarray(ja.vecs.astype(jnp.float32))[:, :D])
    np.testing.assert_array_equal(_np(ta.sqnorms), np.asarray(ja.sqnorms))
    if case == "spill":
        assert (np.bincount(torder) >= 1).all() and len(torder) > N


def test_trained_quantizer_argmin_and_inertia(clustered):
    x = clustered[0]
    kw = dict(seed=3, train_sample=2048, iters=10, batch_size=512, assign_chunk=1500)
    tc, ta = synth.trained_quantizer(x, NLIST, device=CPU, **kw)
    jc, ja = jsynth.trained_quantizer(x, NLIST, **kw)
    assert tc.shape == (NLIST, D) and tc.dtype == np.float32 and ta.dtype == np.int32
    d2 = ((x[:, None, :].astype(np.float64) - tc[None].astype(np.float64)) ** 2).sum(-1)
    best = d2.min(axis=1)
    assert (d2[np.arange(N), ta] <= best + 1e-5 * np.maximum(best, 1.0)).all()
    j_inertia = ((x - jc[ja]) ** 2).sum()
    t_inertia = ((x - tc[ta]) ** 2).sum()
    assert abs(t_inertia - j_inertia) <= 0.10 * j_inertia


@pytest.mark.parametrize("u4", [False, True], ids=["u8", "u4"])
def test_pq_csr_state_codes(clustered, u4):
    x, centers, assign = clustered
    arrays, order, _ = synth.pack_ivf(x, assign, NLIST, with_vecs=False, device=CPU)
    m = 8
    books, codes, tcorr = synth.pq_csr_state(
        x, assign, centers, arrays, order, m=m, u4=u4, iters=4, train_sample=2048, seed=5,
        encode_chunk=1500, device=CPU,
    )
    assert books.ks == (16 if u4 else 256)
    live = arrays.row_ids >= 0
    total = arrays.row_ids.shape[0]
    assert codes.shape == (total, m // 2 if u4 else m) and tcorr.shape == (total,)
    assert (codes[~live] == 0).all() and (tcorr[~live] == 0).all()
    rows = torch.nonzero(live).squeeze(1)
    lists = torch.repeat_interleave(torch.arange(NLIST), arrays.lengths.long())
    cent = torch.from_numpy(centers)
    res = pq.residuals(torch.from_numpy(x[order]), cent, lists)
    own = pq.pq_encode(res, books)
    want = dtypes.pack_u4(own) if u4 else own
    np.testing.assert_array_equal(codes[rows].numpy(), want.numpy())
    np.testing.assert_array_equal(tcorr[rows].numpy(), pq.pq_row_corrections(own, lists, cent, books).numpy())
    # the JAX encode of the same books: equal but at f64 near-ties
    jb = jpq.PQCodebooks(jnp.asarray(books.centroids.numpy()), jnp.asarray(books.sqnorms.numpy()))
    jcodes = np.asarray(jpq.pq_encode(jnp.asarray(res.numpy()), jb))
    diff = np.argwhere(jcodes != own.numpy())
    sub = res.numpy().reshape(res.shape[0], m, -1).astype(np.float64)
    cb = books.centroids.numpy().astype(np.float64)
    for i, j in diff:
        da = ((sub[i, j] - cb[j, own[i, j]]) ** 2).sum()
        db = ((sub[i, j] - cb[j, jcodes[i, j]]) ** 2).sum()
        assert abs(da - db) <= 1e-5 * max(da, db, 1e-6), (i, j, da, db)
    assert len(diff) <= 0.001 * jcodes.size


# -- exact truth and brute force --


def _f64_dist(q, x, metric):
    q, x = q.astype(np.float64), x.astype(np.float64)
    if metric in (Metric.L2,):
        return ((q[:, None, :] - x[None]) ** 2).sum(-1)
    if metric == Metric.INNER_PRODUCT:
        return -(q @ x.T)
    if metric == Metric.COSINE:
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        xn = x / np.linalg.norm(x, axis=1, keepdims=True)
        return 1.0 - qn @ xn.T
    if metric == Metric.MANHATTAN:
        return np.abs(q[:, None, :] - x[None]).sum(-1)
    return np.abs(q[:, None, :] - x[None]).max(-1)


def _same_up_to_ties(got, want, q, x, metric, k):
    ref = np.sort(_f64_dist(q, x, metric), axis=1)[:, : k + 1]
    assert ids_match_up_to_ties(got, want, ref, k)


@pytest.fixture(scope="module")
def truth_data():
    x = datagen.generate(3001, D, seed=21, normalized=False)
    q = datagen.queries_from(x, 24, noise=0.1, seed=22)
    return x, q


def test_exact_truth_matches_the_reference(truth_data):
    x, q = truth_data
    k = 10
    want = np.asarray(jsynth.exact_truth(q, x, k, batch=16))
    got = synth.exact_truth(q, x, k, batch=16, device=CPU)
    assert got.shape == (24, k)
    _same_up_to_ties(got, want, q, x, Metric.L2, k)
    chunked = synth.exact_truth_chunked(q, x, k, row_chunk=1100, device=CPU)  # 3001 % 1100 != 0
    _same_up_to_ties(chunked, np.asarray(jsynth.exact_truth_chunked(q, x, k, row_chunk=1100)),
                     q, x, Metric.L2, k)
    np.testing.assert_array_equal(chunked, got)  # the chunked merge keeps (score, id) order


def test_truth_keeps_score_id_order_on_ties():
    """All rows but one tie: the k smallest ids come first. 257 rows is the
    smallest all-tied corpus on which the JAX brute_force_topk (np.argsort's
    quicksort) returns other ids ([248 .. 252] at k=5)."""
    x = np.zeros((257, 4), np.float32)
    x[2] = 1.0
    q = np.zeros((2, 4), np.float32)
    want = np.array([0, 1, 3, 4, 5])[None].repeat(2, 0)
    np.testing.assert_array_equal(synth.exact_truth_chunked(q, x, 5, row_chunk=3, device=CPU), want)
    np.testing.assert_array_equal(synth.exact_truth(q, x, 5, device=CPU), want)
    np.testing.assert_array_equal(
        harness.brute_force_topk(x, q, 5, Metric.L2, device=CPU, row_chunk=3), want)


@pytest.mark.parametrize("metric", list(Metric), ids=lambda m: m.value)
def test_brute_force_topk_matches_the_reference(truth_data, metric):
    x, q = truth_data
    k = 10
    want = jharness.brute_force_topk(x, q, k, JMetric(metric.value))
    got = harness.brute_force_topk(x, q, k, metric, device=CPU, row_chunk=1000)
    assert got.shape == (24, k)
    _same_up_to_ties(got, want, q, x, metric, k)


def test_recall_at_k_matches_the_reference():
    rng = np.random.default_rng(0)
    found, truth = rng.integers(0, 30, (12, 10)), rng.integers(0, 30, (12, 10))
    assert synth.recall_at_k(found, truth) == jsynth.recall_at_k(found, truth)


# -- harness --


def test_bench_harness_flat():
    from vectorindex_tpu_torch.models import FlatIndex

    res = harness.bench_index(
        lambda: FlatIndex(16, device=CPU), "flat", 500, 16, 5, 20, Metric.L2, trials=1,
        device=CPU,
    )
    assert res.recall_avg == 1.0
    assert res.qps > 0
    run = harness.make_run([res], device=CPU)
    assert run.schema_version == 1
    assert run.results[0]["index"] == "flat"
    assert run.host["devices"] == ["cpu"] and run.host["torch"] == torch.__version__


def test_result_dataclasses_have_the_reference_fields():
    import dataclasses

    for ours, ref in ((harness.BenchResult, jharness.BenchResult),
                      (harness.BenchRun, jharness.BenchRun)):
        assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]
        assert [f.default for f in dataclasses.fields(ours)] == [f.default for f in dataclasses.fields(ref)]


# -- timing and the card requirement --


def test_time_loop_outputs_equal_a_direct_loop():
    qpool = torch.from_numpy(datagen.generate(5 * 8, D, seed=2))
    x = torch.from_numpy(datagen.generate(300, D, seed=3))

    def fn(q, x):
        g = q @ x.T
        return g.sum(), torch.argmax(g, dim=1).sum().to(torch.int32)

    sec, out, samples = timing.time_loop(fn, qpool, 8, 5, repeats=2, args=(x,),
                                         return_samples=True, device=CPU)
    assert len(samples) == 2 and sec > 0 and sec == timing._median(samples)
    want = [fn(qpool[i * 8 : (i + 1) * 8], x) for i in range(5)]
    s0, s1 = want[0]
    for a, b in want[1:]:
        s0, s1 = s0 + a, s1 + b
    assert out[0] == s0.numpy() and out[1] == s1.numpy()
    with pytest.raises(ValueError):
        timing.time_loop(fn, qpool, 8, 6, args=(x,), device=CPU)
    assert timing.time_host(lambda: fn(qpool[:8], x), repeats=2, device=CPU) > 0
    assert timing._median([3.0, 1.0, 2.0, 10.0]) == jtiming_median([3.0, 1.0, 2.0, 10.0])


def jtiming_median(xs):
    from vectorindex_tpu.bench import timing as jtiming

    return jtiming._median(xs)


def test_no_card_raises_everywhere():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: nothing to refuse")
    x = np.zeros((4, 2), np.float32)
    for call in (
        lambda: timing.time_loop(lambda q: (q.sum(),), x, 1, 1),
        lambda: timing.time_host(lambda: None),
        lambda: harness.brute_force_topk(x, x, 1, Metric.L2),
        lambda: harness.host_metadata(),
        lambda: synth.exact_truth(x, x, 1),
        lambda: synth.pack_ivf(x, np.zeros(4, np.int32), 2),
    ):
        with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
            call()
