"""The port's fused flat scan (vectorindex_tpu_torch.kernels.scan_fused)
against the JAX package's.

On the CPU the port's wrappers run the plain PyTorch versions of K1/K2; the
JAX side runs its Pallas kernels in interpret mode, as tests/test_scan_fused.py
does, and its strict path as the oracle. Tolerance for distances: rtol=2e-4,
atol=2e-5 (f32 sums in another order). Ids must be equal, except at a rank
whose JAX distance lies within that tolerance of a neighbouring rank's. The
CUDA kernels themselves are compared with these plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorindex_tpu.kernels import scan_fused as jfused
from vectorindex_tpu.ops.scan import scan_topk_strict as jstrict
from vectorindex_tpu.utils.config import Metric as JMetric
from vectorindex_tpu_torch.kernels import scan_fused as sf
from vectorindex_tpu_torch.ops.topk import INVALID_ID
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.parity import ATOL, RTOL, ids_match_up_to_ties

torch.set_num_threads(1)

METRICS = [Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE]


def _port(q, x, valid, metric, k):
    xp, sqp, vp = sf.pad_corpus(
        torch.from_numpy(x), None, None if valid is None else torch.from_numpy(valid)
    )
    d, i, e = sf.scan_topk_fused(torch.from_numpy(q), xp, sqp, vp, metric=metric, k=k)
    return d.numpy(), i.numpy(), e.numpy()


def _jax_fused(q, x, valid, metric, k):
    xp, sqp, vp = jfused.pad_corpus(
        jnp.asarray(x), None, None if valid is None else jnp.asarray(valid)
    )
    out = jfused.scan_topk_fused(
        jnp.asarray(q), xp, sqp, vp, metric=JMetric(metric.value), k=k, interpret=True
    )
    return tuple(np.asarray(a) for a in out)


def _jax_strict(q, x, valid, metric, k):
    xj = jnp.asarray(x)
    sq = jnp.einsum("nd,nd->n", xj, xj)
    inv = jnp.where(sq > 0, jax.lax.rsqrt(jnp.maximum(sq, 1e-30)), 0.0)
    vm = None if valid is None else jnp.asarray(valid)
    d, i = jstrict(jnp.asarray(q), xj, sq, inv, vm, metric=JMetric(metric.value), k=k)
    return np.asarray(d), np.asarray(i)


def _data(seed, n, d, b):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, d)).astype(np.float32),
        rng.standard_normal((n, d)).astype(np.float32),
        rng,
    )


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
def test_exact_rows_match_jax(metric):
    q, x, _ = _data(11, 9000, 64, 13)
    k = 10
    sd, si, ex = _port(q, x, None, metric, k)
    td, ti = _jax_strict(q, x, None, metric, k + 1)
    jd, ji, jex = _jax_fused(q, x, None, metric, k)
    assert ex.any()
    np.testing.assert_allclose(sd[ex], td[ex, :k], rtol=RTOL, atol=ATOL)
    assert ids_match_up_to_ties(si[ex], ti[ex], td[ex], k)
    both = ex & jex
    assert both.any()
    np.testing.assert_allclose(sd[both], jd[both], rtol=RTOL, atol=ATOL)
    assert ids_match_up_to_ties(si[both], ji[both], td[both], k)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
def test_tombstones_and_filters(metric):
    q, x, rng = _data(12, 6000, 32, 9)
    valid = np.ones(len(x), bool)
    valid[rng.choice(len(x), len(x) // 3, replace=False)] = False
    k = 5
    sd, si, ex = _port(q, x, valid, metric, k)
    td, ti = _jax_strict(q, x, valid, metric, k + 1)
    assert not np.isin(si[si != INVALID_ID], np.nonzero(~valid)[0]).any()
    assert ex.any()
    assert ids_match_up_to_ties(si[ex], ti[ex], td[ex], k)


def test_planted_bin_collision_is_flagged():
    """Five near-identical best rows in one residue class: K1 keeps three
    per class, so the count pass must flag the query, never return a
    silently wrong exact=True row."""
    q, x, rng = _data(13, 4096, 16, 1)
    x *= 10.0
    base = q[0] + 1e-3 * rng.standard_normal(16).astype(np.float32)
    for j in range(5):
        x[7 + j * sf.C] = base + 1e-4 * j
    sd, si, ex = _port(q, x, None, Metric.L2, 4)
    assert not ex[0]
    jd, ji, jex = _jax_fused(q, x, None, Metric.L2, 4)
    assert not jex[0]


def test_strict_tie_contract():
    """Duplicate rows: ties break by ascending id (TopK.swift:8-30)."""
    q, x, rng = _data(16, 4000, 16, 1)
    x *= 5.0
    dup = [17, 1200, 2305, 3999]
    x[dup] = q[0]
    sd, si, ex = _port(q, x, None, Metric.L2, 4)
    assert ex[0] and list(si[0]) == dup
    jd, ji, jex = _jax_fused(q, x, None, Metric.L2, 4)
    assert jex[0] and list(ji[0]) == dup


def test_k_exceeds_valid_count():
    q, x, _ = _data(15, 6, 16, 2)
    sd, si, ex = _port(q, x, None, Metric.L2, 10)
    jd, ji, jex = _jax_fused(q, x, None, Metric.L2, 10)
    assert ex.all() and jex.all()
    np.testing.assert_array_equal(si, ji)
    assert (si[:, 6:] == INVALID_ID).all() and np.isinf(sd[:, 6:]).all()
    np.testing.assert_allclose(sd[:, :6], jd[:, :6], rtol=RTOL, atol=ATOL)


def test_few_live_rows_in_one_class_are_not_declared_exact():
    """Four live rows, all in class 0, and k=10: K1 keeps three per class,
    so tau is +inf with only 3 candidates. The query is exact only once all
    4 live rows are found, so it must be flagged (the JAX package's
    n_valid <= k rule declares it exact and drops a row)."""
    q, x, _ = _data(18, 4 * sf.C, 16, 2)
    valid = np.zeros(len(x), bool)
    valid[[0, sf.C, 2 * sf.C, 3 * sf.C]] = True
    sd, si, ex = _port(q, x, valid, Metric.L2, 10)
    assert not ex.any()
    assert (np.isfinite(sd).sum(1) == 3).all()
    # four live rows in four classes are all found, and exact
    valid[:] = False
    valid[[0, 1, 2, sf.C + 3]] = True
    sd, si, ex = _port(q, x, valid, Metric.L2, 10)
    td, ti = _jax_strict(q, x, valid, Metric.L2, 10)
    assert ex.all()
    np.testing.assert_array_equal(si[:, :4], ti[:, :4])
    np.testing.assert_allclose(sd[:, :4], td[:, :4], rtol=RTOL, atol=ATOL)
    assert (si[:, 4:] == INVALID_ID).all() and np.isinf(sd[:, 4:]).all()


@pytest.mark.parametrize("d", [48, 37])
def test_small_batch_ragged_d(d):
    q, x, _ = _data(14, 5000, d, 3)
    sd, si, ex = _port(q, x, None, Metric.L2, 7)
    td, ti = _jax_strict(q, x, None, Metric.L2, 8)
    assert sd.shape == (3, 7) and ex.any()
    np.testing.assert_allclose(sd[ex], td[ex, :7], rtol=RTOL, atol=ATOL)
    assert ids_match_up_to_ties(si[ex], ti[ex], td[ex], 7)


def test_k_above_candidate_cap_is_not_exact():
    q, x, _ = _data(17, 2048, 8, 2)
    sd, si, ex = _port(q, x, None, Metric.L2, 600)
    assert sd.shape == (2, 600) and not ex.any()
    assert (si[:, 2 * sf.C :] == INVALID_ID).all()
    # with no more live rows than the cap, padding is the exact answer
    sd, si, ex = _port(q, x[:300], None, Metric.L2, 600)
    assert ex.all() and (si[:, 300:] == INVALID_ID).all()


def _integer_case(seed, n, d, b, dead=0.2):
    """Integer-valued data: every distance is exact in f32 and float64, so
    ties are real ties and the oracle can compare exactly."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    q = rng.integers(-3, 4, size=(b, d)).astype(np.float32)
    valid = rng.random(n) >= dead
    tied = [r for r in (5, 5 + sf.C, 5 + 3 * sf.C, 5 + 4 * sf.C) if r < n]
    x[tied] = q[0]  # exact ties in one class
    valid[tied] = True
    sq = (x.astype(np.float64) ** 2).sum(1)
    bias = np.where(valid, sq, np.inf)
    dist = bias[None, :] - 2.0 * (q.astype(np.float64) @ x.T.astype(np.float64))
    t = (lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)))
    return dist, (t(q), t(x), t(bias))


@pytest.mark.parametrize("chunk", [sf.REF_CHUNK, 2 * sf.C], ids=["one-chunk", "chunked"])
def test_bin_candidates_ref_matches_numpy_oracle(chunk, monkeypatch):
    monkeypatch.setattr(sf, "REF_CHUNK", chunk)
    n, b = 4 * sf.C + 3 * sf.C, 3
    dist, (q, x, bias) = _integer_case(21, n, 8, b)
    got_d, got_i = sf.bin_candidates_ref(q, x, bias, None, metric=Metric.L2)
    want_d = np.full((b, sf.TIERS, sf.C), np.inf)
    want_i = np.full((b, sf.TIERS, sf.C), INVALID_ID)
    for qi in range(b):
        for c in range(sf.C):
            rows = np.arange(c, n, sf.C)
            rows = rows[np.isfinite(dist[qi, rows])]
            order = np.lexsort((rows, dist[qi, rows]))[: sf.TIERS]
            want_d[qi, : len(order), c] = dist[qi, rows[order]]
            want_i[qi, : len(order), c] = rows[order]
    np.testing.assert_array_equal(got_d.numpy(), want_d.astype(np.float32))
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    # the planted ties in class 5 come back in row order
    assert list(got_i[0, :, 5].numpy()) == [5, 5 + sf.C, 5 + 3 * sf.C]


@pytest.mark.parametrize("chunk", [sf.REF_CHUNK, sf.C], ids=["one-chunk", "chunked"])
def test_count_below_ref_matches_numpy(chunk, monkeypatch):
    monkeypatch.setattr(sf, "REF_CHUNK", chunk)
    dist, (q, x, bias) = _integer_case(22, 3 * sf.C, 8, 4)
    # thresholds at real distance values, so ties at tau are exercised
    tau = np.array([np.sort(dist[i][np.isfinite(dist[i])])[7 * i + 1] for i in range(4)])
    lt, le = sf.count_below_ref(q, x, bias, None, torch.from_numpy(tau.astype(np.float32)), metric=Metric.L2)
    np.testing.assert_array_equal(lt.numpy(), (dist < tau[:, None]).sum(1))
    np.testing.assert_array_equal(le.numpy(), (dist <= tau[:, None]).sum(1))
    assert (le.numpy() > lt.numpy()).all()


def test_cpu_tensors_take_the_plain_versions():
    _, (q, x, bias) = _integer_case(23, 2 * sf.C, 8, 2)
    sf.reset_launches()
    d1, i1 = sf.bin_candidates(q, x, bias, None, metric=Metric.L2)
    d2, i2 = sf.bin_candidates_ref(q, x, bias, None, metric=Metric.L2)
    assert torch.equal(d1, d2) and torch.equal(i1, i2)
    tau = d1[:, 0, 0].contiguous()
    assert all(torch.equal(a, b) for a, b in zip(
        sf.count_below(q, x, bias, None, tau, metric=Metric.L2),
        sf.count_below_ref(q, x, bias, None, tau, metric=Metric.L2)))
    assert not any(sf.LAUNCHES.values())


@pytest.mark.parametrize(
    "bad, err",
    [
        (lambda q, x, b: (q.double(), x, b, None), TypeError),
        (lambda q, x, b: (q, x.half(), b, None), TypeError),
        (lambda q, x, b: (q, x[:-1], b[:-1], None), ValueError),
        (lambda q, x, b: (q[:, :4], x, b, None), ValueError),
        (lambda q, x, b: (q, x.T.contiguous().T, b, None), ValueError),
        (lambda q, x, b: (q, x, b.double(), None), ValueError),
    ],
    ids=["q-dtype", "x-dtype", "rows", "dim", "strided", "bias"],
)
def test_wrappers_reject_what_the_kernels_do_not_take(bad, err):
    _, (q, x, bias) = _integer_case(24, sf.C, 8, 2)
    with pytest.raises(err):
        sf.bin_candidates(*bad(q, x, bias), metric=Metric.L2)
    with pytest.raises(ValueError):
        sf.bin_candidates(q, x, bias, None, metric=Metric.COSINE)  # no colscale


@pytest.mark.parametrize(
    "d, dtype, want",
    [(2400, torch.bfloat16, "wgmma"), (2401, torch.bfloat16, "wgmma"), (7264, torch.bfloat16, "wgmma"),
     (7265, torch.bfloat16, "wgmma"), (7264, torch.float32, "fma"),
     (7265, torch.float32, "fma"), (128, torch.float32, "fma"), (8, torch.bfloat16, "wgmma"),
     (100, torch.bfloat16, "wgmma"), (128, torch.bfloat16, "wgmma"),
     (1024, torch.bfloat16, "wgmma"), (16384, torch.bfloat16, "wgmma"),
     (16384, torch.float32, "fma")],
)
@pytest.mark.parametrize("nq", [8, 256])
def test_scan_design_routes_by_width_and_dtype(d, dtype, want, nq):
    """bf16 takes the tensor cores (the wgmma design) and f32 the CUDA cores
    (the FMA design) at every width, as the JAX package takes K1/K2 at every
    width: each design's plans fit there (wgmma_plan's for bf16, fma_plan's
    for K1 and K2 on f32). The first designs, kept for timing, keep their
    limits: the first tensor-core design's grid raises past its smallest
    CTA (d > 2,400) and the first FMA design's past its query block
    (d > FMA_MAX_D)."""
    assert sf.scan_design(d, dtype) == want
    n = 1 << 20
    if want == "wgmma":
        p = sf.wgmma_plan(nq, n, d)
        assert p.smem <= sf.MAX_SMEM_BYTES
        assert (p.splits - 1) * p.tiles_per_split < n // sf.C <= p.splits * p.tiles_per_split
        if d <= 2400:
            # the first tensor-core design, kept for timing, covers its route
            qw, cw, tps, splits, per = sf._grid(nq, n, d, mma=True)
            assert qw > 0 and sf._mma_smem(d, qw, cw, tps) <= sf.MAX_SMEM_BYTES
            assert (splits - 1) * per < n // sf.C <= splits * per
        else:
            with pytest.raises(ValueError, match="shared-memory"):
                sf._grid(nq, n, d, mma=True)
        return
    for kernel in ("bin_candidates", "count_below"):
        p = sf.fma_plan(nq, n, d, dtype, kernel)
        assert p.smem <= sf.MAX_SMEM_BYTES
        assert (p.splits - 1) * p.tiles_per_split < n // sf.C <= p.splits * p.tiles_per_split
    if d > sf.FMA_MAX_D:
        with pytest.raises(ValueError, match="shared-memory"):
            sf._grid(nq, n, d, mma=False)
    else:
        assert sf._grid(nq, n, d, mma=False)[3] >= 1
