"""The port's IVF-PQ ADC probe kernels and probed search
(vectorindex_tpu_torch.kernels.adc_probe) against the JAX package's.

On the CPU the port's wrappers run the plain PyTorch versions of K9/K10;
the JAX side runs its Pallas kernels in interpret mode, as
tests/test_adc_probe_kernel.py does. Both packages get the same seeded
numpy inputs (injected codebooks, the JAX package's codes and row
corrections) and hold the same CSR rows.

Tolerances:
  - K9/K10 partial distances: finite entries within rtol=atol=1e-5 (the
    TPU kernel contracts a one-hot matrix with the LUT, the port adds the
    m entries in order), +inf positions identical.
  - ivf_search_pq_probe against ivf_search_pq_pallas: ids equal except at
    near-ties of the JAX distances (utils/parity, rtol=2e-4, atol=2e-5);
    distances within rtol=atol=1e-5.
The CUDA kernel is compared with these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorindex_tpu.kernels.adc_probe as jap
from vectorindex_tpu.ops import dtypes as jdtypes
from vectorindex_tpu.ops import ivf as jivf
from vectorindex_tpu.ops import pq as jpq
from vectorindex_tpu.utils.config import Metric as JMetric
from vectorindex_tpu_torch.kernels import adc_probe as ap
from vectorindex_tpu_torch.kernels.scan_fused import MAX_SMEM_BYTES
from vectorindex_tpu_torch.ops import ivf as tivf
from vectorindex_tpu_torch.ops import pq
from vectorindex_tpu_torch.ops.dtypes import pack_u4
from vectorindex_tpu_torch.ops.topk import INVALID_ID
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.parity import ids_match_up_to_ties

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
CONFIGS = {"u8": (4, 256), "u4": (8, 16)}  # (m, ks) at d = 16


def T(a):
    return torch.from_numpy(np.array(a))


def _store(x, assign, ids, kc):
    """The same lists in both packages → (jax arrays, port arrays, CSR list
    id of every row (0 for dead rows), probe_cap)."""
    js = jivf.IVFListStore(kc, x.shape[1])
    ts = tivf.IVFListStore(kc, x.shape[1], device="cpu")
    js.append_batch(assign, ids, x)
    ts.append_batch(assign, ids, x)
    ja, ta = js.sync_device(), ts.sync_device()
    np.testing.assert_array_equal(ta.row_ids.numpy(), np.asarray(ja.row_ids))
    row_list = np.zeros(ja.row_ids.shape[0], np.int32)
    for l, (s, n) in enumerate(zip(np.asarray(ja.starts), np.asarray(ja.lengths))):
        row_list[s : s + n] = l
    return ja, ta, row_list, tivf.probe_cap_for(ts.max_length)


def _pq_state(ja, coarse, row_list, m, ks, seed):
    """Injected books and the JAX package's codes (packed for ks ≤ 16) and
    row corrections of every CSR row."""
    cents = np.random.default_rng(seed).standard_normal((m, ks, 16 // m)).astype(np.float32)
    jb = jpq.PQCodebooks(jnp.asarray(cents), jnp.sum(jnp.square(jnp.asarray(cents)), axis=-1))
    codes = jpq.pq_encode_residual(ja.vecs, jnp.asarray(coarse), jnp.asarray(row_list), jb)
    tcorr = np.asarray(jpq.pq_row_corrections(codes, jnp.asarray(row_list), jnp.asarray(coarse), jb))
    if ks <= 16:
        codes = jdtypes.pack_u4(codes)
    return jb, pq.books_from_centroids(T(cents)), np.asarray(codes), tcorr


@pytest.fixture(scope="module")
def f():
    rng = np.random.default_rng(0)
    n, d, kc = 1100, 16, 6
    coarse = rng.standard_normal((kc, d)).astype(np.float32)
    assign = rng.choice(kc, n, p=[0.35, 0.25, 0.15, 0.1, 0.1, 0.05])  # one list > 256 rows
    x = (coarse[assign] + 0.3 * rng.standard_normal((n, d))).astype(np.float32)
    ja, ta, row_list, cap = _store(x, assign, np.arange(n), kc)
    out = dict(x=x, coarse=coarse, ja=ja, ta=ta, cap=cap, kc=kc, row_list=row_list)
    for name, (m, ks) in CONFIGS.items():
        out[name] = _pq_state(ja, coarse, row_list, m, ks, seed=m)
    out["q"] = rng.standard_normal((18, d)).astype(np.float32)
    return out


def test_port_codes_and_corrections_equal_the_inputs(f):
    """The port's encoder and row corrections give the codes and tcorr the
    JAX package gave for this store (checked once, then fed to both)."""
    for name, (m, ks) in CONFIGS.items():
        _, tb, codes, tcorr = f[name]
        c = pq.pq_encode_residual(f["ta"].vecs, T(f["coarse"]), T(f["row_list"]), tb)
        tc = pq.pq_row_corrections(c, T(f["row_list"]), T(f["coarse"]), tb)
        if ks <= 16:
            c = pack_u4(c)
        np.testing.assert_array_equal(c.numpy(), codes)
        np.testing.assert_allclose(tc.numpy(), tcorr, **TOL)


@pytest.mark.parametrize("b", [6, 18], ids=["B6-rankseg", "B18-pair"])
@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT], ids=lambda m: m.value)
@pytest.mark.parametrize("name", ["u8", "u4"])
def test_kernel_plain_versions_match_jax(f, name, metric, b):
    m, ks = CONFIGS[name]
    jb, _, codes, tcorr = f[name]
    if metric == Metric.INNER_PRODUCT:
        tcorr = np.zeros_like(tcorr)
    q = f["q"][:b]
    lut_fn = jpq.pq_lut_q_l2 if metric == Metric.L2 else jpq.pq_lut_ip
    lut = np.asarray(lut_fn(jnp.asarray(q), jb))
    _, pls = jivf.ivf_select(jnp.asarray(q), jnp.asarray(f["coarse"]), nprobe=4,
                             metric=JMetric(metric.value))
    sr = np.array(f["ja"].starts[pls])
    lr = np.array(f["ja"].lengths[pls])
    lr[0, 1] = 0  # an empty probe
    kw = dict(nprobe=4, probe_cap=f["cap"], m=m, ks=ks, packed_u4=ks <= 16)
    want = np.asarray(jap.adc_probe_scores(jnp.asarray(lut), jnp.asarray(sr), jnp.asarray(lr),
                                           jnp.asarray(codes), jnp.asarray(tcorr), interpret=True, **kw))
    args = (T(lut), T(sr), T(lr), T(codes), T(tcorr))
    ap.reset_launches()
    for fn in (ap.adc_probe_scores, ap.adc_probe_scores_rankseg,
               ap.adc_probe_scores_ref, ap.adc_probe_scores_rankseg_ref):
        got = fn(*args, **kw).numpy()
        finite = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), finite)
        np.testing.assert_allclose(got[finite], want[finite], **TOL)
    assert set(ap.LAUNCHES.values()) == {0}  # CPU tensors take the plain versions
    assert ap.adc_rankseg_fits(b) == jap.adc_rankseg_fits(b)


def _epilogue_case(f, name, metric):
    """The JAX fixture's kernel inputs at B=6, nprobe=4, with an empty probe
    and a disabled list (live 0, base +inf), a coarse term and a 30% allow
    mask in CSR row order."""
    m, ks = CONFIGS[name]
    jb, _, codes, tcorr = f[name]
    if metric == Metric.INNER_PRODUCT:
        tcorr = np.zeros_like(tcorr)
    q = f["q"][:6]
    lut_fn = jpq.pq_lut_q_l2 if metric == Metric.L2 else jpq.pq_lut_ip
    lut = np.asarray(lut_fn(jnp.asarray(q), jb))
    base, pls = jivf.ivf_select(jnp.asarray(q), jnp.asarray(f["coarse"]), nprobe=4,
                                metric=JMetric(metric.value))
    base = np.array(base)
    sr = np.array(f["ja"].starts[pls])
    lr = np.array(f["ja"].lengths[pls])
    lr[0, 1] = 0  # an empty probe
    lr[2, 3], base[2, 3] = 0, np.inf  # a disabled list
    allow = np.random.default_rng(1).random(f["ja"].row_ids.shape[0]) < 0.3
    kw = dict(nprobe=4, probe_cap=f["cap"], m=m, ks=ks, packed_u4=ks <= 16)
    return (lut, sr, lr, codes, tcorr), base, allow, kw


@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT], ids=lambda m: m.value)
@pytest.mark.parametrize("name", ["u8", "u4"])
def test_plain_epilogue_equals_add_then_mask(f, name, metric):
    """base and row_allow in the plain versions (and the CPU wrappers) give
    exactly partial + base[:, :, None], then the allow mask the search
    applied after the kernel before they existed; the JAX kernel's partials
    with the same two steps agree within TOL."""
    args, base, allow, kw = _epilogue_case(f, name, metric)
    targs = tuple(T(a) for a in args)
    b, cap = base.shape[0], kw["probe_cap"]
    partial = ap.adc_probe_scores_ref(*targs, **kw)
    want = (partial.reshape(b, 4, cap) + T(base)[:, :, None]).reshape(b, -1)
    slot_of = torch.clamp(T(args[1]).long()[:, :, None] + torch.arange(cap), 0, len(allow) - 1)
    want = torch.where(T(allow)[slot_of].reshape(b, -1), want, float("inf"))
    ap.reset_launches()
    for fn in (ap.adc_probe_scores_ref, ap.adc_probe_scores, ap.adc_probe_scores_rankseg):
        assert torch.equal(fn(*targs, **kw, base=T(base), row_allow=T(allow)), want)
    assert set(ap.LAUNCHES.values()) == {0}
    assert torch.isinf(want[2, 3 * cap : 4 * cap]).all() and torch.isinf(want[0, cap : 2 * cap]).all()
    jp = np.asarray(jap.adc_probe_scores(*(jnp.asarray(a) for a in args), interpret=True, **kw))
    jd = (jp.reshape(b, 4, cap) + base[:, :, None]).reshape(b, -1)
    jd = np.where(allow[slot_of.numpy()].reshape(b, -1), jd, np.inf)
    finite = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(want.numpy()), finite)
    np.testing.assert_allclose(want.numpy()[finite], jd[finite], **TOL)


def test_epilogue_input_checks_and_first_design_needs_the_card(f):
    args, base, allow, kw = _epilogue_case(f, "u8", Metric.L2)
    targs = tuple(T(a) for a in args)
    ok = ap.adc_probe_scores(*targs, **kw, base=torch.cat([T(base), T(base)], 1)[:, :4])
    assert torch.equal(ok, ap.adc_probe_scores(*targs, **kw, base=T(base)))  # strided rows
    for bad in (dict(base=T(base).double()), dict(base=T(base)[:, :3].contiguous()),
                dict(base=T(base).t().contiguous().t()),
                dict(row_allow=T(allow).to(torch.uint8)), dict(row_allow=T(allow)[:-1])):
        with pytest.raises(ValueError):
            ap.adc_probe_scores(*targs, **kw, **bad)
    with pytest.raises(ValueError, match="CUDA"):
        ap.adc_probe_scores_v1(*targs, **kw)


@pytest.mark.parametrize("b", [1, 8, 16, 17, 256])
def test_probe_plan_fills_a_wave(b):
    """The launch plan keeps about one CTA an SM (PLAN_CTAS of the H100's
    132; two where the LUT is smaller than a probe's codes) busy where the
    batch has that many (query, probe) pairs, shares each LUT load among as
    many probes as that allows, and is a G the kernel takes (a warp or more
    of its 256 threads a probe)."""
    for nprobe, cap, m, ks, packed in ((32, 512, 16, 256, False), (32, 1024, 32, 16, True),
                                       (8, 512, 16, 256, False), (16, 16384, 8, 256, False)):
        g = ap.probe_plan(b, nprobe, cap, m, ks, packed)
        aim = ap.PLAN_CTAS if 4 * m * ks >= cap * (m // 2 if packed else m) else 2 * ap.PLAN_CTAS
        ctas = b * -(-nprobe // g)
        assert ctas >= min(ap.PLAN_CTAS, b * nprobe)
        assert g in (1, 2, 4, 8) and g <= nprobe
        assert ap.probe_smem(m, ks) <= MAX_SMEM_BYTES
        if g > 1:  # fewer probes a CTA would not raise the CTAs past the aim
            assert b * -(-nprobe // g) >= aim
        if g < min(nprobe, ap.MAX_PROBES):  # more would fall short of it
            assert b * -(-nprobe // (2 * g)) < aim
    # the main paths' plans (scripts/ab_adc_probe_torch.py): pq16 shares its
    # 16 KB LUT between two probes at B=8, pq32x4 its 2 KB one not at all
    if b == 8:
        assert ap.probe_plan(8, 32, 512, 16, 256, False) == 2
        assert ap.probe_plan(8, 32, 1024, 32, 16, True) == 1
    if b == 256:
        assert ap.probe_plan(256, 32, 512, 16, 256, False) == 8


def test_probe_plan_refuses_a_lut_that_cannot_fit():
    with pytest.raises(ValueError, match="shared memory"):
        ap.probe_plan(8, 32, 512, 64, 1024, False)  # 256 KB of LUT
    ap.probe_plan(8, 32, 512, 56, 1024, False)  # 224 KB + the barrier fits
    lut = torch.zeros((1, 64, 1024))
    sr = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="shared-memory"):
        ap.adc_probe_scores(lut, sr, sr, torch.zeros((256, 64), dtype=torch.uint8),
                            torch.zeros(256), nprobe=1, probe_cap=256, m=64, ks=1024)


def test_kernel_input_checks(f):
    m, ks = CONFIGS["u8"]
    _, _, codes, tcorr = f["u8"]
    lut = torch.zeros((2, m, ks))
    sr = torch.zeros((2, 3), dtype=torch.int32)
    kw = dict(nprobe=3, probe_cap=f["cap"], m=m, ks=ks)
    ok = (lut, sr, sr, T(codes), T(tcorr))
    assert ap.adc_probe_scores(*ok, **kw).shape == (2, 3 * f["cap"])
    for bad, kwx in [
        ((lut.double(), sr, sr, T(codes), T(tcorr)), {}),
        ((lut, sr.long(), sr, T(codes), T(tcorr)), {}),
        ((lut, sr, sr, T(codes)[:, :2], T(tcorr)), {}),
        ((lut, sr, sr, T(codes), T(tcorr)[:-1]), {}),
        (ok, {"probe_cap": 100}),
        (ok, {"packed_u4": True}),  # ks=256 cannot pack
    ]:
        with pytest.raises(ValueError):
            ap.adc_probe_scores(*bad, **{**kw, **kwx})


def _jax_search(f, name, q, metric, **kw):
    jb, _, codes, tcorr = f[name]
    if metric == Metric.INNER_PRODUCT:
        tcorr = np.zeros_like(tcorr)
    for key in ("row_allow", "disabled_lists"):
        if kw.get(key) is not None:
            kw[key] = jnp.asarray(kw[key])
    d, i = jap.ivf_search_pq_pallas(
        jnp.asarray(q), jnp.asarray(f["coarse"]), f["ja"], jnp.asarray(codes), jnp.asarray(tcorr),
        jb, metric=JMetric(metric.value), packed_u4=CONFIGS[name][1] <= 16, interpret=True, **kw)
    return np.asarray(d), np.asarray(i)


def _port_search(f, name, q, metric, **kw):
    _, tb, codes, tcorr = f[name]
    if metric == Metric.INNER_PRODUCT:
        tcorr = np.zeros_like(tcorr)
    for key in ("row_allow", "disabled_lists"):
        if kw.get(key) is not None:
            kw[key] = T(kw[key])
    d, i = ap.ivf_search_pq_probe(
        T(q), T(f["coarse"]), f["ta"], T(codes), T(tcorr), tb, metric=metric,
        packed_u4=CONFIGS[name][1] <= 16, **kw)
    return d.numpy(), i.numpy()


def _assert_search_equal(got, want, k):
    (td, ti), (jd, ji) = got, want
    finite = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), finite)
    np.testing.assert_array_equal(ti[~finite], ji[~finite])
    np.testing.assert_allclose(td[finite], jd[finite], **TOL)
    assert ids_match_up_to_ties(ti, ji, np.where(finite, jd, np.inf), k)


@pytest.mark.parametrize("name, metric, b, kw", [
    ("u8", Metric.L2, 6, dict(rerank_c=0)),
    ("u8", Metric.L2, 18, dict(rerank_c=64)),
    ("u4", Metric.INNER_PRODUCT, 6, dict(rerank_c=64, allow=True)),
    ("u4", Metric.L2, 18, dict(rerank_c=0, allow=True)),
    ("u8", Metric.INNER_PRODUCT, 18, dict(rerank_c=64, disabled=True)),
], ids=["u8-l2-k10-adc", "u8-l2-k9-rerank", "u4-ip-k10-allow", "u4-l2-k9-allow-adc",
        "u8-ip-k9-disabled"])
def test_search_matches_jax(f, name, metric, b, kw):
    kw = dict(kw)
    if kw.pop("allow", False):
        kw["row_allow"] = np.random.default_rng(1).random(f["ja"].row_ids.shape[0]) < 0.3
    if kw.pop("disabled", False):
        dis = np.zeros(f["kc"], bool)
        dis[[0, 2]] = True
        kw["disabled_lists"] = dis
    q = f["q"][:b]
    common = dict(nprobe=f["kc"] if "disabled_lists" in kw else 3, probe_cap=f["cap"], k=10)
    ap.reset_launches()
    got = _port_search(f, name, q, metric, **common, **kw)
    want = _jax_search(f, name, q, metric, **common, **kw)
    _assert_search_equal(got, want, 10)
    assert (got[1][:, :10] != INVALID_ID).all()
    if "row_allow" in kw:
        rid = np.asarray(f["ja"].row_ids)
        allowed = set(rid[kw["row_allow"] & (rid >= 0)].tolist())
        assert set(got[1].ravel().tolist()) <= allowed
    if "disabled_lists" in kw:
        rid = np.asarray(f["ja"].row_ids)
        members = rid[np.isin(f["row_list"], [0, 2]) & (rid >= 0)]
        assert not set(got[1].ravel().tolist()) & set(members.tolist())


def test_spill_dedup_matches_jax_and_fills_every_row():
    """Spilled copies share an internal id: with dedup every row holds k
    distinct ids, with and without the rerank, as in the JAX package."""
    rng = np.random.default_rng(2)
    kc, d = 6, 16
    coarse = 0.5 * rng.standard_normal((kc, d)).astype(np.float32)
    x = rng.standard_normal((700, d)).astype(np.float32)
    src, assign, frac = jivf.spill_assign(x, coarse, eps=0.2)
    assert frac > 0.2
    ja, ta, row_list, cap = _store(x[src], assign, src, kc)
    g = dict(coarse=coarse, ja=ja, ta=ta, kc=kc, row_list=row_list, u4=_pq_state(ja, coarse, row_list, 8, 16, 5))
    q = rng.standard_normal((18, d)).astype(np.float32)
    for rerank_c in (0, 64):
        kw = dict(nprobe=3, probe_cap=cap, k=10, rerank_c=rerank_c, dedup=True)
        got = _port_search(g, "u4", q, Metric.L2, **kw)
        if rerank_c == 0:  # the ADC-ranked case, where a duplicate once left a hole
            _assert_search_equal(got, _jax_search(g, "u4", q, Metric.L2, **kw), 10)
        assert all(len(set(row)) == 10 and INVALID_ID not in row for row in got[1].tolist())
    # without dedup the copies crowd the top-k
    dup = _port_search(g, "u4", q, Metric.L2, nprobe=3, probe_cap=cap, k=10, rerank_c=64)[1]
    assert any(len(set(row)) < 10 for row in dup.tolist())


def test_candidates_rerank_source_and_errors(f):
    _, tb, codes, tcorr = f["u8"]
    jb = f["u8"][0]
    q = f["q"]
    kw = dict(nprobe=3, probe_cap=f["cap"], c=40)
    cd, rows, iids = ap.pq_probe_candidates(T(q), T(f["coarse"]), f["ta"], T(codes), T(tcorr), tb, **kw)
    jcd, jrows, jiids = jap.pq_probe_candidates(
        jnp.asarray(q), jnp.asarray(f["coarse"]), f["ja"], jnp.asarray(codes), jnp.asarray(tcorr),
        jb, interpret=True, **kw)
    np.testing.assert_allclose(cd.numpy(), np.asarray(jcd), **TOL)
    assert ids_match_up_to_ties(iids.numpy(), np.asarray(jiids), np.asarray(jcd), 40)
    rid = f["ta"].row_ids.numpy()
    np.testing.assert_array_equal(rid[rows.numpy()], iids.numpy())
    # an id-keyed rerank source (original row order) reranks like the CSR rows
    sq = T((f["x"] ** 2).sum(-1))
    args = (T(q), T(f["coarse"]), f["ta"], T(codes), T(tcorr), tb)
    kw = dict(nprobe=3, probe_cap=f["cap"], k=10, rerank_c=64)
    by_row = ap.ivf_search_pq_probe(*args, **kw)
    by_id = ap.ivf_search_pq_probe(*args, rerank_vecs=T(f["x"]), rerank_sqnorms=sq, **kw)
    np.testing.assert_array_equal(by_id[1].numpy(), by_row[1].numpy())
    np.testing.assert_allclose(by_id[0].numpy(), by_row[0].numpy(), **TOL)
    # rerank_vecs without its sqnorms is a ValueError (the JAX package fails
    # with a TypeError deep inside)
    with pytest.raises(ValueError, match="rerank_sqnorms"):
        ap.ivf_search_pq_probe(*args, rerank_vecs=T(f["x"]), **kw)
    with pytest.raises(ValueError, match="L2 and IP"):
        ap.ivf_search_pq_probe(*args, metric=Metric.COSINE, **kw)
    # fewer probed slots than k: padded with (+inf, INVALID_ID)
    d, i = ap.ivf_search_pq_probe(*args, nprobe=1, probe_cap=256, k=300)
    assert d.shape == (18, 300) and (i[:, 256:] == INVALID_ID).all()
