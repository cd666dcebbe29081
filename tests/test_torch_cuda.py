"""CUDA kernels of vectorindex_tpu_torch against their plain PyTorch versions.

Needs an NVIDIA GPU (marker `cuda`); without one every test skips. This
file imports neither JAX nor tests/conftest.py's JAX setup, so on a machine
with a card and no JAX it runs as (`-o markers=...` registers the marker
that --noconftest skips)

    python -m pytest --noconftest -p no:cacheprovider \
        -o "markers=cuda: needs an NVIDIA GPU" -m cuda tests/test_torch_cuda.py

Tolerance: the kernels against their plain versions on the card, 0 (K1/K2
and their plain versions sum each dot product as one f32 FMA chain over d;
K3/K4/K5 and theirs as one chain of separately rounded products and sums;
K6-K10 and theirs add the m LUT entries in order, each add rounded);
an index on the card against the same index on the host, rtol=2e-4,
atol=2e-5 (f32 sums in another order; bf16 products are exact in f32).
"""

import numpy as np
import pytest
import torch

import vectorindex_tpu_torch.models.flat as tflat
from vectorindex_tpu_torch.kernels import adc as fa
from vectorindex_tpu_torch.kernels import adc_probe as ap
from vectorindex_tpu_torch.kernels import ivf_probe as kp
from vectorindex_tpu_torch.kernels import scan_fused as sf
from vectorindex_tpu_torch.models.ivf import IVFConfig, IVFIndex, IVFPQConfig, IVFPQIndex
from vectorindex_tpu_torch.ops import ivf as tivf
from vectorindex_tpu_torch.ops import pq, scoring
from vectorindex_tpu_torch.ops.topk import INVALID_ID, topk
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.parity import ATOL, RTOL, ids_match_up_to_ties

METRICS = [Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d, b", [(128, 8), (100, 13)])
def test_kernels_match_plain_versions(metric, dtype, d, b, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(d * b)
    x = torch.randn(8192, d, generator=gen, device=cuda_device).to(dtype)
    valid = torch.rand(8192, generator=gen, device=cuda_device) >= 0.125
    q = torch.randn(b, d, generator=gen, device=cuda_device)
    xp, sqp, vp = sf.pad_corpus(x, None, valid)
    qk, bias, cs, _ = sf.kernel_inputs(q, sqp, vp, metric)
    sf.reset_launches()
    kd, ki = sf.bin_candidates(qk, xp, bias, cs, metric=metric)
    torch.cuda.synchronize()
    rd, ri = sf.bin_candidates_ref(qk, xp, bias, cs, metric=metric)
    # both sum each dot product as one f32 FMA chain over d in order (cuBLAS
    # f32 GEMM, TF32 off, for the plain version): equal bit for bit
    assert torch.equal(kd, rd) and torch.equal(ki, ri)
    finite = torch.isfinite(kd)
    assert (ki[~finite] == INVALID_ID).all()
    cls = torch.arange(sf.C, device=cuda_device).expand_as(ki)
    assert ((ki % sf.C == cls) | ~finite).all()  # a row's class is row mod C
    kk = 10
    sd, _ = topk(kd.view(b, -1), kk, ids=ki.view(b, -1))
    tau = sd[:, kk - 1].contiguous()
    lt, le = sf.count_below(qk, xp, bias, cs, tau, metric=metric)
    torch.cuda.synchronize()
    assert (le >= kk).all()  # K2 recomputes K1's floats bit for bit
    rlt, rle = sf.count_below_ref(qk, xp, bias, cs, tau, metric=metric)
    assert torch.equal(lt, rlt) and torch.equal(le, rle)
    assert sf.LAUNCHES == {"bin_candidates": 1, "count_below": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_index_routes_through_the_kernels(dtype, cuda_device, monkeypatch):
    monkeypatch.setattr(tflat, "LARGE_SCAN_THRESHOLD", 1024)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3000, 32)).astype(np.float32)
    q = rng.standard_normal((9, 32)).astype(np.float32)
    on_card = tflat.FlatIndex(32, Metric.L2, storage_dtype=dtype, device=cuda_device)
    on_host = tflat.FlatIndex(32, Metric.L2, storage_dtype=dtype, device="cpu")
    for idx in (on_card, on_host):
        idx.insert_batch(list(range(len(x))), x)
        for i in range(0, len(x), 5):
            idx.remove(i)
    sf.reset_launches()
    got = on_card.batch_search(q, 10)
    assert sf.LAUNCHES == {"bin_candidates": 1, "count_below": 1}
    want = on_host.batch_search(q, 11)
    wd = np.array([[r.score**2 for r in row] for row in want])
    gd = np.array([[r.score**2 for r in row] for row in got])
    np.testing.assert_allclose(gd, wd[:, :10], rtol=RTOL, atol=ATOL)
    gi = np.array([[r.id for r in row] for row in got])
    wi = np.array([[r.id for r in row] for row in want])
    assert ids_match_up_to_ties(gi, wi, wd, 10)


@pytest.mark.cuda
def test_wrappers_raise_instead_of_falling_back(cuda_device):
    x = torch.randn(512, 16, device=cuda_device)
    bias = torch.zeros(512, device=cuda_device)
    with pytest.raises(ValueError, match="one device"):
        sf.bin_candidates(torch.randn(2, 16), x, bias, None, metric=Metric.INNER_PRODUCT)
    with pytest.raises(ValueError):
        sf.bin_candidates(torch.randn(2, 16, device=cuda_device), x, bias, None,
                          metric=Metric.MANHATTAN)


@pytest.mark.cuda
def test_f32_gram_refuses_tf32(cuda_device, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    q = torch.randn(2, 8, device=cuda_device)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        scoring.inner_product_block(q, q)


def _skewed_store(d, dtype, device, seed=0, nlist=24):
    """Lists of skewed lengths (some empty, one long) in the CSR layout."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 400, nlist)
    lengths[[2, 9]] = 0
    lengths[5] = 3000
    assign = np.repeat(np.arange(nlist), lengths)
    x = rng.standard_normal((len(assign), d)).astype(np.float32)
    store = tivf.IVFListStore(nlist, d, device=device)
    store.append_batch(assign, np.arange(len(x)), x)
    cent = np.stack([x[assign == i].mean(0) if lengths[i] else np.zeros(d) for i in range(nlist)])
    return store.sync_device(dtype), tivf.probe_cap_for(store.max_length), cent.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [128, 100])
def test_ivf_kernels_match_plain_versions(metric, dtype, d, cuda_device):
    arrays, cap, cent = _skewed_store(d, dtype, cuda_device, seed=d)
    rng = np.random.default_rng(d + 1)
    nprobe = 8
    allow = torch.from_numpy(rng.random(arrays.row_ids.shape[0]) < 0.1).to(cuda_device)
    sq_deny = torch.where(allow, arrays.sqnorms, float("inf")).contiguous()
    kp.reset_launches()
    for b, sqn in ((8, sq_deny), (20, arrays.sqnorms)):
        q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(cuda_device)
        _, pl = tivf.ivf_select(q, torch.from_numpy(cent).to(cuda_device), nprobe=nprobe, metric=metric)
        pl = pl.long()
        args = (q, arrays.starts[pl].contiguous(), arrays.lengths[pl].contiguous(), arrays.vecs, sqn)
        kw = dict(nprobe=nprobe, probe_cap=cap, metric=metric)
        for fn, ref in ((kp.ivf_probe_scores, kp.ivf_probe_scores_ref),
                        (kp.ivf_probe_scores_rankmajor, kp.ivf_probe_scores_rankmajor_ref)):
            got = fn(*args, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, ref(*args, **kw))
        got = kp.ivf_probe_topc_rankmajor(*args, **kw)
        torch.cuda.synchronize()
        for a, r in zip(got, kp.ivf_probe_topc_rankmajor_ref(*args, **kw)):
            assert torch.equal(a, r)
    assert kp.LAUNCHES == {"ivf_probe_topc": 2, "ivf_probe_scores": 2, "ivf_probe_scores_rankmajor": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_ivf_index_on_card_matches_host(dtype, cuda_device):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6000, 32)).astype(np.float32)
    on_host = IVFIndex(32, Metric.L2, IVFConfig(nlist=32, nprobe=6), storage_dtype=dtype, device="cpu")
    on_host.insert_batch(list(range(len(x))), x)
    on_host.optimize()
    state = {
        "dimension": 32, "metric": "l2", "storage_dtype": str(dtype).removeprefix("torch."),
        "config": {"nlist": 32, "nprobe": 6, "train_iters": 20, "seed": 42},
        "vectors": on_host._vectors, "metadata": on_host._metadata,
        "ids": list(on_host._idmap.items()), "free": on_host._free,
        "next_slot": on_host._next_slot, "centroids": on_host._centroids,
        "lists": on_host._store._lists_ids,
    }
    on_card = IVFIndex.from_state(state, device=cuda_device)
    q = x[rng.choice(len(x), 20, replace=False)] + 0.1 * rng.standard_normal((20, 32)).astype(np.float32)
    allow = list(range(0, len(x), 4))
    kp.reset_launches()
    for b, kw, name in ((8, {}, "ivf_probe_topc"), (8, dict(allow_ids=allow), "ivf_probe_topc"),
                        (20, {}, "ivf_probe_scores"), (20, dict(allow_ids=allow), "ivf_probe_scores")):
        before = kp.LAUNCHES[name]
        got = on_card.batch_search(q[:b], 10, **kw)
        assert kp.LAUNCHES[name] == before + 1
        want = on_host.batch_search(q[:b], 11, **kw)
        wd = np.array([[r.score**2 for r in row] for row in want])
        gd = np.array([[r.score**2 for r in row] for row in got])
        np.testing.assert_allclose(gd, wd[:, :10], rtol=RTOL, atol=ATOL)
        assert ids_match_up_to_ties([[r.id for r in row] for row in got],
                                    [[r.id for r in row] for row in want], wd, 10)
    got = on_card.batch_search(q[:4], 600)  # serving batch, k beyond K3: K5
    assert kp.LAUNCHES["ivf_probe_scores_rankmajor"] == 1
    want = on_host.batch_search(q[:4], 600)
    assert [[r.id for r in row][:50] for row in got] == [[r.id for r in row][:50] for row in want]


@pytest.mark.cuda
def test_ivf_class_crowding_falls_back_to_k4(cuda_device):
    """Five equal rows in one class defeat K3's three tiers: the proof fails
    and the batch re-runs through K4."""
    d = 16
    x = 100.0 + np.random.default_rng(0).standard_normal((1280, d)).astype(np.float32)
    x[[0, 256, 512, 768, 1024]] = 1.0
    store = tivf.IVFListStore(2, d, device=cuda_device)
    store.append_batch(np.zeros(len(x), int), np.arange(len(x)), x)
    arrays = store.sync_device()
    cent = torch.zeros((2, d), device=cuda_device)
    q = torch.ones((1, d), device=cuda_device)
    kp.reset_launches()
    _, ids = kp.ivf_search_flat_probe(q, cent, arrays, nprobe=1,
                                      probe_cap=tivf.probe_cap_for(store.max_length), k=5)
    assert kp.LAUNCHES == {"ivf_probe_topc": 1, "ivf_probe_scores": 1, "ivf_probe_scores_rankmajor": 0}
    assert sorted(ids[0].tolist()) == [0, 256, 512, 768, 1024]


@pytest.mark.cuda
@pytest.mark.parametrize("m, ks", [(16, 256), (32, 16)], ids=["u8-pq16", "u4-pq32x4"])
@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT], ids=lambda m: m.value)
def test_adc_kernels_match_plain_versions(m, ks, metric, cuda_device):
    d = 96
    arrays, cap, cent = _skewed_store(d, torch.float32, cuda_device, seed=m)
    gen = torch.Generator(device=cuda_device).manual_seed(m + ks)
    packed = ks <= 16
    n_rows = arrays.row_ids.shape[0]
    codes = torch.randint(0, ks, (n_rows, m), generator=gen, device=cuda_device).to(torch.uint8)
    if packed:
        codes = pq.pack_u4(codes)
    books = pq.books_from_centroids(torch.randn(m, ks, d // m, generator=gen, device=cuda_device))
    tcorr = torch.randn(n_rows, generator=gen, device=cuda_device)
    if metric == Metric.INNER_PRODUCT:
        tcorr = torch.zeros_like(tcorr)
    ap.reset_launches()
    for b in (8, 32):
        q = torch.randn(b, d, generator=gen, device=cuda_device)
        lut = (pq.pq_lut_q_l2 if metric == Metric.L2 else pq.pq_lut_ip)(q, books).contiguous()
        _, pl = tivf.ivf_select(q, torch.from_numpy(cent).to(cuda_device), nprobe=8)
        pl = pl.long()
        args = (lut, arrays.starts[pl].contiguous(), arrays.lengths[pl].contiguous(), codes, tcorr)
        kw = dict(nprobe=8, probe_cap=cap, m=m, ks=ks, packed_u4=packed)
        for fn, ref in ((ap.adc_probe_scores, ap.adc_probe_scores_ref),
                        (ap.adc_probe_scores_rankseg, ap.adc_probe_scores_rankseg_ref)):
            got = fn(*args, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, ref(*args, **kw))
    assert ap.LAUNCHES == {"adc_probe_scores": 2, "adc_probe_scores_rankseg": 2}
    # 'auto' over a whole code array launches the full-corpus ADC kernel K6
    fa.reset_launches()
    full = pq.adc_scan(codes if not packed else pq.unpack_u4(codes), lut)
    assert fa.LAUNCHES["adc_scan_u8"] == 1 and full.shape == (32, n_rows)


@pytest.mark.cuda
@pytest.mark.parametrize("spill", [0.0, 0.2], ids=["pq16", "pq32x4-spill"])
def test_ivfpq_index_on_card_matches_host(spill, cuda_device):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((6000, 32)).astype(np.float32)
    m, ks = (8, 256) if spill == 0.0 else (16, 16)
    cfg = IVFPQConfig(nlist=32, nprobe=6, m=m, ks=ks, rerank_c=512, spill_eps=spill, pq_iters=5)
    on_host = IVFPQIndex(32, Metric.L2, cfg, device="cpu")
    on_host.insert_batch(list(range(len(x))), x)
    on_host.optimize()
    state = {
        "dimension": 32, "metric": "l2", "storage_dtype": "float32",
        "config": cfg.__dict__, "vectors": on_host._vectors, "metadata": on_host._metadata,
        "ids": list(on_host._idmap.items()), "free": on_host._free,
        "next_slot": on_host._next_slot, "centroids": on_host._centroids,
        "lists": on_host._store._lists_ids, "slot_list": on_host._slot_list,
        "slot_spill": on_host._slot_spill, "books": on_host._books.centroids.numpy(),
    }
    on_card = IVFPQIndex.from_state(state, device=cuda_device)
    q = x[rng.choice(len(x), 20, replace=False)] + 0.1 * rng.standard_normal((20, 32)).astype(np.float32)
    allow = list(range(0, len(x), 4))
    ap.reset_launches()
    for b, kw, name in ((8, {}, "adc_probe_scores_rankseg"),
                        (8, dict(allow_ids=allow), "adc_probe_scores_rankseg"),
                        (20, {}, "adc_probe_scores")):
        before = ap.LAUNCHES[name]
        got = on_card.batch_search(q[:b], 10, **kw)
        assert ap.LAUNCHES[name] == before + 1
        want = on_host.batch_search(q[:b], 11, **kw)
        wd = np.array([[r.score**2 for r in row] for row in want])
        gd = np.array([[r.score**2 for r in row] for row in got])
        np.testing.assert_allclose(gd, wd[:, :10], rtol=RTOL, atol=ATOL)
        gi = [[r.id for r in row] for row in got]
        assert ids_match_up_to_ties(gi, [[r.id for r in row] for row in want], wd, 10)
        assert all(len(set(row)) == 10 for row in gi)


@pytest.mark.cuda
@pytest.mark.parametrize("m, ks", [(8, 256), (16, 256), (16, 16), (32, 16)],
                         ids=["pq8x8", "pq16", "pq16x4", "pq32x4"])
def test_full_corpus_adc_kernels_match_plain_versions(m, ks, cuda_device):
    """K6 and K8 (u8 codes) or K7 (packed u4) against their plain versions
    over a ragged row count, at query blocks that fill and that do not fill
    a CTA; K8's distances are K6's at K8's rows, K7's equal K6's on the
    unpacked codes."""
    gen = torch.Generator(device=cuda_device).manual_seed(m * ks)
    n = 20_000 + 77
    codes = torch.randint(0, ks, (n, m), generator=gen, device=cuda_device).to(torch.uint8)
    fa.reset_launches()
    for b in (8, 13):
        lut = torch.rand(b, m, ks, generator=gen, device=cuda_device)
        k6 = fa.adc_scan_u8(codes, lut)
        torch.cuda.synchronize()
        assert torch.equal(k6, fa.adc_scan_u8_ref(codes, lut))
        if ks <= 16:
            packed = pq.pack_u4(codes)
            k7 = fa.adc_scan_u4(packed, lut)
            torch.cuda.synchronize()
            assert torch.equal(k7, fa.adc_scan_u4_ref(packed, lut)) and torch.equal(k7, k6)
        for k in (10, 600):
            kd, ki = fa.adc_topk_fused(codes, lut, k)
            torch.cuda.synchronize()
            rd, ri = fa.adc_topk_fused_ref(codes, lut, k)
            assert kd.shape == (b, min(k, 512)) and torch.equal(kd, rd) and torch.equal(ki, ri)
            assert torch.equal(kd, torch.gather(k6, 1, ki.long()))
            assert (ki < n).all()
    assert fa.LAUNCHES == {"adc_scan_u8": 2, "adc_scan_u4": 2 if ks <= 16 else 0, "adc_topk_fused": 4}
    with pytest.raises(ValueError):
        fa.adc_scan_u4(codes, torch.rand(2, m, ks, device=cuda_device))  # unpacked width


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_range_search_on_card_matches_host(dtype, cuda_device):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3000, 32)).astype(np.float32)
    q = rng.standard_normal((4, 32)).astype(np.float32)
    on_card = tflat.FlatIndex(32, Metric.L2, storage_dtype=dtype, device=cuda_device)
    on_host = tflat.FlatIndex(32, Metric.L2, storage_dtype=dtype, device="cpu")
    meta = [{"even": i % 2 == 0} for i in range(len(x))]
    for idx in (on_card, on_host):
        idx.insert_batch(list(range(len(x))), x, meta)
        for i in range(0, len(x), 7):
            idx.remove(i)
    for qi, kw in ((q[0], {}), (q[1], dict(filter=lambda md: md["even"])), (q[2], dict(max_results=5))):
        got = on_card.range_search(qi, 6.5, **kw)
        want = on_host.range_search(qi, 6.5, **kw)
        assert 0 < len(got) == len(want)
        wd = np.array([[r.score**2 for r in want]])
        np.testing.assert_allclose([[r.score**2 for r in got]], wd, rtol=RTOL, atol=ATOL)
        assert ids_match_up_to_ties([[r.id for r in got]], [[r.id for r in want]], wd, len(want))
