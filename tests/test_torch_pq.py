"""The port's PQ building blocks (vectorindex_tpu_torch.ops: dtypes, dedup,
ivf.spill_assign, pq, ivf_pq) against the JAX package's, on the same seeded
numpy inputs, on the CPU.

Tolerances:
  - u4 packing, int8 codes, dedup masks, visited bitsets, spill_assign and
    PQ codes: exactly equal (codes on data built from the codebooks with
    noise far below the codebooks' gaps, so no encode is a near-tie).
  - LUTs, row corrections, decoded vectors, ADC values: rtol=1e-5 and
    atol=1e-5 (f32 sums in another order).
  - ivf_search_pq / rerank_rows: ids equal up to near-ties of the JAX
    distances (utils/parity, rtol=2e-4, atol=2e-5), distances within the
    same tolerance.
  - Training draws random seeds the port cannot replay: the port's books
    must reach a distortion within 10% of the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorindex_tpu.ops import dedup as jdedup
from vectorindex_tpu.ops import dtypes as jdtypes
from vectorindex_tpu.ops import ivf as jivf
from vectorindex_tpu.ops import ivf_pq as jivf_pq
from vectorindex_tpu.ops import pq as jpq
from vectorindex_tpu.ops import rng as jrng
from vectorindex_tpu.utils.config import Metric as JMetric
from vectorindex_tpu_torch.ops import dedup, dtypes, ivf as tivf, ivf_pq, pq, rng
from vectorindex_tpu_torch.ops.topk import INVALID_ID
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.parity import ATOL, RTOL, ids_match_up_to_ties

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def T(a):
    """A torch tensor of a copy (JAX hands out read-only numpy views)."""
    return torch.from_numpy(np.array(a))


def _books(m, ks, dsub, seed):
    """Codebooks from numpy in both packages (the same f32 centroids)."""
    cents = np.random.default_rng(seed).standard_normal((m, ks, dsub)).astype(np.float32)
    jb = jpq.PQCodebooks(jnp.asarray(cents), jnp.sum(jnp.square(jnp.asarray(cents)), axis=-1))
    return cents, jb, pq.books_from_centroids(T(cents))


def _near_codes(cents, n, seed, noise=1e-3):
    """(x [n, m·dsub], codes [n, m]): rows at codebook entries plus noise far
    below the gaps between entries, so every code is unambiguous."""
    m, ks, dsub = cents.shape
    rng_ = np.random.default_rng(seed)
    codes = rng_.integers(0, ks, (n, m))
    x = cents[np.arange(m)[None, :], codes].reshape(n, m * dsub)
    return (x + noise * rng_.standard_normal(x.shape)).astype(np.float32), codes


# -- ops/dtypes --


def test_u4_pack_layout_and_round_trip():
    codes = np.random.default_rng(0).integers(0, 16, (7, 10)).astype(np.uint8)
    packed = dtypes.pack_u4(T(codes))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jdtypes.pack_u4(jnp.asarray(codes))))
    assert packed.dtype == torch.uint8 and packed.shape == (7, 5)
    assert int(packed[0, 0]) == int(codes[0, 0]) | (int(codes[0, 1]) << 4)  # even index low
    np.testing.assert_array_equal(dtypes.unpack_u4(packed).numpy(), codes)
    with pytest.raises(ValueError):
        dtypes.pack_u4(T(codes[:, :3]))


@pytest.mark.parametrize("axis", [None, 1])
def test_int8_and_half_helpers_match(axis):
    x = np.random.default_rng(1).standard_normal((6, 9)).astype(np.float32) * 3
    x[2] = 0.5  # a constant row: the affine degenerate range, per axis
    for tfn, jfn in ((dtypes.quantize_symmetric_i8, jdtypes.quantize_symmetric_i8),
                     (dtypes.quantize_affine_i8, jdtypes.quantize_affine_i8)):
        got, want = tfn(T(x), axis=axis), jfn(jnp.asarray(x), axis=axis)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    q, s = dtypes.quantize_symmetric_i8(T(x), axis=axis)
    np.testing.assert_allclose(dtypes.dequantize_symmetric_i8(q, s).numpy(),
                               np.asarray(jdtypes.dequantize_symmetric_i8(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()))))
    q, s, zp = dtypes.quantize_affine_i8(T(x), axis=axis)
    np.testing.assert_allclose(np.abs(dtypes.dequantize_affine_i8(q, s, zp).numpy() - x).max(), 0.0,
                               atol=float(s.max()))
    for tfn, jfn in ((dtypes.f32_to_bf16, jdtypes.f32_to_bf16), (dtypes.f32_to_f16, jdtypes.f32_to_f16)):
        np.testing.assert_array_equal(tfn(T(x)).float().numpy(),
                                      np.asarray(jfn(jnp.asarray(x)).astype(jnp.float32)))


# -- ops/dedup --


def test_dedup_mask_and_candidates_match():
    ids = np.array([[7, 3, 7, 3, 5, INVALID_ID], [1, 1, 1, 2, 2, 9], [4, 4, 4, 4, 4, 4]], np.int32)
    missing = np.zeros(ids.shape, bool)
    missing[0, 5] = True
    got = dedup.dedup_mask(T(ids), T(missing))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdedup.dedup_mask(jnp.asarray(ids), jnp.asarray(missing))))
    np.testing.assert_array_equal(got[1].numpy(), [False, True, True, False, True, False])
    dists = np.random.default_rng(2).random(ids.shape).astype(np.float32)
    gd, gi = dedup.dedup_candidates(T(dists), T(ids))
    jd, ji = jdedup.dedup_candidates(jnp.asarray(dists), jnp.asarray(ids))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(jd))


def test_visited_bitsets_match():
    ids = np.array([[0, 31, 32, 33, -1, 31], [63, 5, 5, 64, 100, 0]], np.int32)
    bits = dedup.visited_init(2, 101)
    jbits = jdedup.visited_init(2, 101)
    assert bits.shape == tuple(jbits.shape)
    was, bits = dedup.visited_test_and_mark(bits, T(ids))
    jwas, jbits = jdedup.visited_test_and_mark(jbits, jnp.asarray(ids))
    np.testing.assert_array_equal(was.numpy(), np.asarray(jwas))
    np.testing.assert_array_equal(bits.numpy().view(np.uint32), np.asarray(jbits))
    probe = np.array([[31, 30, -5], [64, 65, 100]], np.int32)
    np.testing.assert_array_equal(dedup.visited_test(bits, T(probe)).numpy(),
                                  np.asarray(jdedup.visited_test(jbits, jnp.asarray(probe))))


# -- ops/ivf.spill_assign --


def test_spill_assign_matches():
    rng_ = np.random.default_rng(3)
    x = rng_.standard_normal((700, 8)).astype(np.float32)
    cent = rng_.standard_normal((12, 8)).astype(np.float32)
    cent[5] = cent[4]  # an exact tie: the lower list id comes first
    got = tivf.spill_assign(x, cent, eps=0.2, chunk=256)
    want = jivf.spill_assign(x, cent, eps=0.2, chunk=256)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2] and 0.0 < got[2] < 1.0


# -- ops/pq with injected books --


@pytest.mark.parametrize("m, ks", [(4, 256), (8, 16)], ids=["u8", "u4"])
def test_encode_decode_luts_and_corrections_match(m, ks):
    d, kc = 16, 5
    cents, jb, tb = _books(m, ks, d // m, seed=m)
    coarse = np.random.default_rng(4).standard_normal((kc, d)).astype(np.float32)
    r, codes_true = _near_codes(cents, 300, seed=5)
    assign = np.random.default_rng(6).integers(0, kc, 300)
    x = coarse[assign] + r
    codes = pq.pq_encode_residual(T(x), T(coarse), T(assign), tb, chunk=128)
    jcodes = jpq.pq_encode_residual(jnp.asarray(x), jnp.asarray(coarse), jnp.asarray(assign), jb, chunk=128)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(codes.numpy(), codes_true)
    np.testing.assert_array_equal(pq.pq_encode(T(r), tb).numpy(), codes_true)
    if ks <= 16:
        np.testing.assert_array_equal(pq.pq_encode_u4(T(r), tb).numpy(),
                                      np.asarray(jpq.pq_encode_u4(jnp.asarray(r), jb)))
    np.testing.assert_allclose(pq.pq_decode(codes, tb).numpy(),
                               np.asarray(jpq.pq_decode(jcodes, jb)), **TOL)
    np.testing.assert_allclose(pq.residuals(T(x), T(coarse), T(assign)).numpy(),
                               np.asarray(jpq.residuals(jnp.asarray(x), jnp.asarray(coarse), jnp.asarray(assign))), **TOL)

    q = np.random.default_rng(7).standard_normal((5, d)).astype(np.float32)
    lists = np.random.default_rng(8).integers(0, kc, (5, 3)).astype(np.int32)
    for name in ("pq_lut_l2", "pq_lut_ip", "pq_lut_q_l2"):
        np.testing.assert_allclose(getattr(pq, name)(T(q), tb).numpy(),
                                   np.asarray(getattr(jpq, name)(jnp.asarray(q), jb)), **TOL)
    np.testing.assert_allclose(
        pq.pq_lut_residual_l2(T(q), T(coarse), T(lists), tb).numpy(),
        np.asarray(jpq.pq_lut_residual_l2(jnp.asarray(q), jnp.asarray(coarse), jnp.asarray(lists), jb)),
        **TOL)
    np.testing.assert_allclose(
        pq.pq_row_corrections(codes, T(assign), T(coarse), tb, chunk=128).numpy(),
        np.asarray(jpq.pq_row_corrections(jcodes, jnp.asarray(assign.astype(np.int32)), jnp.asarray(coarse), jb, chunk=128)),
        **TOL)


def test_adc_strategies_agree_with_jax():
    cents, jb, tb = _books(4, 16, 4, seed=9)
    codes = np.random.default_rng(10).integers(0, 16, (1000, 4)).astype(np.uint8)
    q = np.random.default_rng(11).standard_normal((3, 16)).astype(np.float32)
    lut = pq.pq_lut_l2(T(q), tb)
    want = np.asarray(jpq.adc_scan(jnp.asarray(codes), jnp.asarray(lut.numpy()), strategy="gather", chunk=256))
    for strategy in ("auto", "gather", "onehot"):
        got = pq.adc_scan(T(codes), lut, strategy=strategy, chunk=256)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    packed = dtypes.pack_u4(T(codes))
    np.testing.assert_allclose(pq.adc_scan_u4(packed, lut, chunk=256).numpy(), want, **TOL)
    # ADC equals the distance to the decoded vectors
    dec = pq.pq_decode(T(codes), tb).numpy()
    np.testing.assert_allclose(want, ((q[:, None, :] - dec[None]) ** 2).sum(-1), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        pq.adc_scan(T(codes), lut, strategy="nope")


def test_decomposition_identity():
    """base + Σ qlut + t_row equals the fused residual-LUT ADC value (the
    identity K9/K10's callers rely on), in the port and against JAX."""
    kc, d = 6, 16
    cents, jb, tb = _books(4, 16, 4, seed=12)
    coarse = np.random.default_rng(13).standard_normal((kc, d)).astype(np.float32)
    rng_ = np.random.default_rng(14)
    q = rng_.standard_normal((3, d)).astype(np.float32)
    lists = rng_.integers(0, kc, (3, 2))
    codes = rng_.integers(0, 16, (3, 2, 4))
    lut_full = pq.pq_lut_residual_l2(T(q), T(coarse), T(lists), tb)  # [3, 2, m, ks]
    fused = torch.gather(lut_full, 3, T(codes)[..., None])[..., 0].sum(-1)
    qlut = pq.pq_lut_q_l2(T(q), tb)
    qsum = torch.gather(qlut[:, None].expand_as(lut_full), 3, T(codes)[..., None])[..., 0].sum(-1)
    base = ((q[:, None, :] - coarse[lists]) ** 2).sum(-1)
    tval = pq.pq_row_corrections(T(codes.reshape(-1, 4)).to(torch.uint8), T(lists.reshape(-1)),
                                 T(coarse), tb).reshape(3, 2)
    np.testing.assert_allclose(fused.numpy(), base + qsum.numpy() + tval.numpy(), atol=1e-3, rtol=1e-4)
    jfull = jpq.pq_lut_residual_l2(jnp.asarray(q), jnp.asarray(coarse), jnp.asarray(lists.astype(np.int32)), jb)
    np.testing.assert_allclose(lut_full.numpy(), np.asarray(jfull), **TOL)


def _distortion(x, books):
    return float(((pq.pq_decode(pq.pq_encode(T(x), books), books).numpy() - x) ** 2).sum(-1).mean())


def test_training_distortion_within_10pct_of_jax():
    x = np.random.default_rng(15).standard_normal((1500, 16)).astype(np.float32)
    jb = jpq.pq_train(jrng.make_key(0), jnp.asarray(x), m=4, ks=16, iters=8)
    jdist = _distortion(x, pq.books_from_centroids(T(jb.centroids)))
    tb = pq.pq_train(rng.make_generator(0, 1), T(x), m=4, ks=16, iters=8)
    assert tb.centroids.shape == (4, 16, 4)
    np.testing.assert_allclose(tb.sqnorms.numpy(), (tb.centroids.numpy() ** 2).sum(-1), rtol=1e-5)
    assert abs(_distortion(x, tb) - jdist) <= 0.1 * jdist
    again = pq.pq_train(rng.make_generator(0, 1), T(x), m=4, ks=16, iters=8)
    assert torch.equal(again.centroids, tb.centroids)  # deterministic per (seed, stream)
    pp = pq.pq_train(rng.make_generator(0, 1), T(x), m=4, ks=16, iters=8, seeding="pp")
    assert abs(_distortion(x, pp) - jdist) <= 0.1 * jdist
    # streaming: init on the first chunk, update over the rest
    st = pq.pq_stream_init(rng.make_generator(1), T(x[:500]), m=4, ks=16)
    for s in range(500, 1500, 250):
        st = pq.pq_stream_update(st, T(x[s : s + 250]))
    assert _distortion(x, pq.pq_stream_finalize(st)) < 0.8 * float((x * x).sum(-1).mean())
    with pytest.raises(ValueError):
        pq.pq_train(rng.make_generator(0), T(x[:10]), m=4, ks=16)


# -- ops/ivf_pq: the gather route and rerank_rows --


@pytest.fixture(scope="module")
def pq_store():
    rng_ = np.random.default_rng(16)
    n, d, kc, m = 1100, 16, 6, 4
    coarse = rng_.standard_normal((kc, d)).astype(np.float32)
    assign = rng_.choice(kc, n, p=[0.35, 0.25, 0.15, 0.1, 0.1, 0.05])
    x = (coarse[assign] + 0.3 * rng_.standard_normal((n, d))).astype(np.float32)
    js = jivf.IVFListStore(kc, d)
    ts = tivf.IVFListStore(kc, d, device="cpu")
    js.append_batch(assign, np.arange(n), x)
    ts.append_batch(assign, np.arange(n), x)
    ja, ta = js.sync_device(), ts.sync_device()
    np.testing.assert_array_equal(ta.row_ids.numpy(), np.asarray(ja.row_ids))
    starts, lengths = np.asarray(ja.starts), np.asarray(ja.lengths)
    row_list = np.zeros(ja.row_ids.shape[0], np.int32)
    for l in range(kc):
        row_list[starts[l] : starts[l] + lengths[l]] = l
    cents, jb, tb = _books(m, 256, d // m, seed=17)
    codes = np.asarray(jpq.pq_encode_residual(ja.vecs, jnp.asarray(coarse), jnp.asarray(row_list), jb))
    slot_rows = np.full(n, -1, np.int32)
    rid = np.asarray(ja.row_ids)
    slot_rows[rid[rid >= 0]] = np.nonzero(rid >= 0)[0]
    cap = tivf.probe_cap_for(ts.max_length)
    return dict(x=x, coarse=coarse, ja=ja, ta=ta, jb=jb, tb=tb, codes=codes, cap=cap,
                kc=kc, slot_rows=slot_rows, row_list=row_list)


@pytest.mark.parametrize("metric, u4, extra", [
    (Metric.L2, False, {}),
    (Metric.INNER_PRODUCT, False, {"allow": True}),
    (Metric.L2, True, {"disabled": True}),
], ids=["l2-u8", "ip-u8-allow", "l2-u4-disabled"])
def test_ivf_search_pq_and_rerank_rows_match_jax(pq_store, metric, u4, extra):
    f = pq_store
    q = np.random.default_rng(18).standard_normal((9, 16)).astype(np.float32)
    codes = f["codes"]
    jb, tb = f["jb"], f["tb"]
    if u4:
        _, jb, tb = _books(4, 16, 4, seed=19)
        codes = np.asarray(jdtypes.pack_u4(jpq.pq_encode_residual(
            f["ja"].vecs, jnp.asarray(f["coarse"]), jnp.asarray(f["row_list"]), jb)))
    n_pad = f["ja"].row_ids.shape[0]
    allow = np.random.default_rng(20).random(n_pad) < 0.3 if extra.get("allow") else None
    disabled = np.zeros(f["kc"], bool)
    disabled[[0, 3]] = True
    kw = dict(nprobe=3, probe_cap=f["cap"], k=12, packed_u4=u4, query_chunk=4)
    jd, ji = jivf_pq.ivf_search_pq(
        jnp.asarray(q), jnp.asarray(f["coarse"]), f["ja"], jnp.asarray(codes), jb,
        metric=JMetric(metric.value), row_allow=None if allow is None else jnp.asarray(allow),
        disabled_lists=jnp.asarray(disabled) if extra.get("disabled") else None, **kw)
    td, ti = ivf_pq.ivf_search_pq(
        T(q), T(f["coarse"]), f["ta"], T(codes), tb, metric=metric,
        row_allow=None if allow is None else T(allow),
        disabled_lists=T(disabled) if extra.get("disabled") else None, **kw)
    jd, ji = np.asarray(jd), np.asarray(ji)
    finite = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td.numpy()), finite)
    np.testing.assert_allclose(td.numpy()[finite], jd[finite], rtol=RTOL, atol=ATOL)
    assert ids_match_up_to_ties(ti.numpy(), ji, np.where(finite, jd, np.inf), 12)
    if allow is not None:
        rows = f["slot_rows"][ti.numpy()[finite]]
        assert allow[rows].all()
    # exact rerank of the candidates by internal id
    jr = jivf_pq.rerank_rows(jnp.asarray(q), jnp.asarray(ji), jnp.asarray(f["slot_rows"]),
                             f["ja"].vecs, f["ja"].sqnorms, k=5, metric=JMetric(metric.value))
    tr = ivf_pq.rerank_rows(T(q), ti, T(f["slot_rows"]), f["ta"].vecs, f["ta"].sqnorms, k=5,
                            metric=metric)
    jrd = np.asarray(jr[0])
    np.testing.assert_allclose(tr[0].numpy(), jrd, rtol=RTOL, atol=ATOL)
    assert ids_match_up_to_ties(tr[1].numpy(), np.asarray(jr[1]), jrd, 5)
