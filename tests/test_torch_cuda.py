"""CUDA kernels of vectorindex_tpu_torch against their plain PyTorch versions.

Needs an NVIDIA GPU (marker `cuda`); without one every test skips. This
file imports neither JAX nor tests/conftest.py's JAX setup, so on a machine
with a card and no JAX it runs as (`-o markers=...` registers the marker
that --noconftest skips)

    python -m pytest --noconftest -p no:cacheprovider \
        -o "markers=cuda: needs an NVIDIA GPU" -m cuda tests/test_torch_cuda.py

Tolerance: the kernels against their plain versions on the card, 0 (K1/K2
on f32 corpora and their plain versions sum each dot product as one f32 FMA
chain over d; K3/K4/K5 and theirs as one chain of separately rounded
products and sums; K6-K10 and theirs add the m LUT entries in order, each
add rounded). K1/K2/K11 on bf16 corpora run on the tensor cores, whose sum
order is not cuBLAS's: 0 on integer-valued data (every partial sum exact),
else the tensor-core rule of utils/parity (each distance within
2 d 2^-23 sum_k |q_k x_k|, scaled by the metric, of the exact one; counts
within the rows that close to tau). An index on the card against the same
index on the host, rtol=2e-4, atol=2e-5 (f32 sums in another order; bf16
products are exact in f32).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

import vectorindex_tpu_torch.models.flat as tflat
from vectorindex_tpu_torch.kernels import adc as fa
from vectorindex_tpu_torch.kernels import adc_probe as ap
from vectorindex_tpu_torch.kernels import ivf_probe as kp
from vectorindex_tpu_torch.kernels import scan_fused as sf
from vectorindex_tpu_torch.models.ivf import IVFConfig, IVFIndex, IVFPQConfig, IVFPQIndex
from vectorindex_tpu_torch.ops import ivf as tivf
from vectorindex_tpu_torch.ops import pq, scoring
from vectorindex_tpu_torch.ops import rerank as rr
from vectorindex_tpu_torch.ops.topk import INVALID_ID, topk
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils import parity
from vectorindex_tpu_torch.utils.telemetry import TELEM
from vectorindex_tpu_torch.utils.parity import ATOL, RTOL, ids_match_up_to_ties

METRICS = [Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scan_case(data, metric, d, b, device, n=8192):
    """(q_kernel, x_pad, bias, colscale) of a seeded case: f32 or bf16
    gaussian rows, or integer-valued bf16 rows and queries in [-8, 8]
    (every partial sum of d <= 128 products exact in f32), 1/8 dead."""
    gen = torch.Generator(device=device).manual_seed(d * b)
    if data == "bf16-int":
        x = torch.randint(-8, 9, (n, d), generator=gen, device=device).float()
        q = torch.randint(-8, 9, (b, d), generator=gen, device=device).float()
    else:
        x = torch.randn(n, d, generator=gen, device=device)
        q = torch.randn(b, d, generator=gen, device=device)
    valid = torch.rand(n, generator=gen, device=device) >= 0.125
    xp, sqp, vp = sf.pad_corpus(x.to(torch.float32 if data == "f32" else torch.bfloat16), None, valid)
    qk, bias, cs, _ = sf.kernel_inputs(q, sqp, vp, metric)
    if data == "bf16-int":
        qk = q  # the kernel function on integer queries: cosine's normalisation would break exactness
    return qk, xp, bias, cs


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
@pytest.mark.parametrize("data", ["f32", "bf16-int", "bf16-gauss"])
@pytest.mark.parametrize("d, b", [(128, 8), (100, 13), (128, 256)])
def test_kernels_match_plain_versions(metric, data, d, b, cuda_device):
    qk, xp, bias, cs = _scan_case(data, metric, d, b, cuda_device)
    sf.reset_launches()
    kd, ki = sf.bin_candidates(qk, xp, bias, cs, metric=metric)
    torch.cuda.synchronize()
    rd, ri = sf.bin_candidates_ref(qk, xp, bias, cs, metric=metric)
    if data == "bf16-gauss":
        ok, err = parity.tensor_core_candidates_ok(kd, ki, rd, ri, qk, xp, bias, cs, metric)
        assert ok, f"K1 outside the tensor-core tolerance (max |err| {err})"
    else:
        # f32: one FMA chain each (cuBLAS f32 GEMM, TF32 off, for the plain
        # version); integer bf16: every sum exact. Equal bit for bit
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
    if data == "bf16-gauss":
        near = parity.count_near(qk, xp, bias, cs, tau, metric).to(lt.dtype)
        assert ((lt - rlt).abs() <= near).all() and ((le - rle).abs() <= near).all()
    else:
        assert torch.equal(lt, rlt) and torch.equal(le, rle)
    assert sf.LAUNCHES["bin_candidates"] == 1 and sf.LAUNCHES["count_below"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
@pytest.mark.parametrize("d, b", [(128, 8), (100, 13), (128, 256)])
def test_k1_and_k2_compute_the_same_floats(metric, d, b, cuda_device):
    """On gaussian bf16 rows (tensor cores): every K1 candidate counts itself
    at or below its own distance, and no row lies below K1's smallest."""
    qk, xp, bias, cs = _scan_case("bf16-gauss", metric, d, b, cuda_device)
    kd, ki = sf.bin_candidates(qk, xp, bias, cs, metric=metric)
    sd, _ = torch.sort(kd.view(b, -1), dim=1)
    n_fin = int(torch.isfinite(sd).sum(dim=1).min())
    for rank in sorted({0, 9, 99, n_fin - 1}):
        tau = sd[:, rank].contiguous()
        lt, le = sf.count_below(qk, xp, bias, cs, tau, metric=metric)
        assert (le >= (sd <= tau[:, None]).sum(dim=1)).all(), f"rank {rank}"
        if rank == 0:
            assert (lt == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT], ids=lambda m: m.value)
@pytest.mark.parametrize("data", ["bf16-int", "bf16-gauss"])
@pytest.mark.parametrize("tile", [512, 4096])
def test_tree_kernel_matches_plain_version(metric, data, tile, cuda_device):
    """K11 against its plain version (bit for bit on integer rows, the
    tensor-core rule on gaussian rows); K2 on its tau proves it or flags."""
    b = 13
    qk, xp, bias, _ = _scan_case(data, metric, 128, b, cuda_device)
    sf.reset_launches()
    kd, ki = sf.bin_candidates_tree(qk, xp, bias, metric=metric, tile=tile)
    torch.cuda.synchronize()
    rd, ri = sf.bin_candidates_tree_ref(qk, xp, bias, metric=metric, tile=tile)
    if data == "bf16-gauss":
        ok, err = parity.tensor_core_candidates_ok(kd, ki, rd, ri, qk, xp, bias, None, metric)
        assert ok, f"K11 outside the tensor-core tolerance (max |err| {err})"
    else:
        assert torch.equal(kd, rd) and torch.equal(ki, ri)
    assert sf.LAUNCHES["bin_candidates_tree"] == 1
    sd, _ = topk(kd.view(b, -1), 10, ids=ki.view(b, -1))
    lt, le = sf.count_below(qk, xp, bias, None, sd[:, 9].contiguous(), metric=metric)
    assert (le >= 10).all()  # K2 recomputes K11's floats bit for bit


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
    assert sf.LAUNCHES == {"bin_candidates": 1, "count_below": 1, "bin_candidates_tree": 0,
                           "bin_candidates_fma": 0}
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
    assert kp.LAUNCHES == {"ivf_probe_topc": 2, "ivf_probe_scores": 2, "ivf_probe_scores_rankmajor": 2,
                           "ivf_probe_topc_v1": 0, "ivf_probe_scores_v1": 0}


def _chip_skewed_store(d, dtype):
    """chip_smoke.skewed_store: 256 skewed lists (8 empty, one of 12,000
    rows, probe_cap 16,384), ~262k rows on the card."""
    import chip_smoke

    arrays, cap, centers, _ = chip_smoke.skewed_store(d, dtype, d)
    return arrays, cap, centers


def _probe_args(arrays, centers, q, nprobe, metric, sqn):
    _, pl = tivf.ivf_select(q, centers, nprobe=nprobe, metric=metric)
    pl = pl.long()
    return (q, arrays.starts[pl].contiguous(), arrays.lengths[pl].contiguous(), arrays.vecs, sqn)


def _assert_designs_equal(args, kw, b, what):
    """K4, K5 and K3 equal their plain versions and their first designs bit
    for bit on one set of inputs."""
    for fn, ref, sentinel in ((kp.ivf_probe_scores, kp.ivf_probe_scores_ref, False),
                              (kp.ivf_probe_scores_rankmajor, kp.ivf_probe_scores_rankmajor_ref, True)):
        got = fn(*args, **kw)
        v1 = kp.ivf_probe_scores_v1(*args, deny_sentinel=sentinel, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, ref(*args, **kw)), f"{fn.__name__} B={b} {what}"
        assert torch.equal(got, v1), f"{fn.__name__} against v1, B={b} {what}"
    got = kp.ivf_probe_topc_rankmajor(*args, **kw)
    v1 = kp.ivf_probe_topc_v1(*args, **kw)
    torch.cuda.synchronize()
    for a, r, o in zip(got, kp.ivf_probe_topc_rankmajor_ref(*args, **kw), v1):
        assert torch.equal(a, r) and torch.equal(a, o), f"K3 B={b} {what}"


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [128, 100, 264], ids=["d128", "d100-unvectorised", "d264-kslices"])
def test_ivf_redesigned_kernels_match_plain_and_first_designs(metric, dtype, d, cuda_device):
    """The list-major K4/K5 and the one-launch K3 against their plain
    versions and first designs, bit for bit, at B = 1, 8, 17 and 256 on
    chip_smoke's skewed store (K3/K5 with a 10% deny sentinel); d = 100
    stages bf16 rows by plain loads, d = 264 takes several k-slices."""
    arrays, cap, centers = _chip_skewed_store(d, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    allow = torch.rand(arrays.sqnorms.shape[0], generator=gen, device=cuda_device) < 0.1
    sq_deny = torch.where(allow, arrays.sqnorms, float("inf")).contiguous()
    kw = dict(nprobe=16, probe_cap=cap, metric=metric)
    for b in (1, 8, 17, 256):
        q = torch.randn(b, d, generator=gen, device=cuda_device)
        for sqn, what in ((arrays.sqnorms, "all allowed"), (sq_deny, "10% allowed")):
            _assert_designs_equal(_probe_args(arrays, centers, q, 16, metric, sqn), kw, b, what)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_ivf_every_query_probing_one_list(dtype, cuda_device):
    """B=256 queries whose 16 probes all fall on the 12,000-row list and on
    one 0-live copy of it (a disabled list): runs of 4,096 pairs of one
    start, cut into groups; all designs equal the plain versions."""
    arrays, cap, centers = _chip_skewed_store(128, dtype)
    big = int(torch.argmax(arrays.lengths))
    q = torch.randn(256, 128, generator=torch.Generator(device=cuda_device).manual_seed(3),
                    device=cuda_device)
    starts = torch.full((256, 16), int(arrays.starts[big]), dtype=torch.int32, device=cuda_device)
    lives = torch.full_like(starts, int(arrays.lengths[big]))
    lives[:, 5] = 0
    kw = dict(nprobe=16, probe_cap=cap, metric=Metric.L2)
    args = (q, starts, lives, arrays.vecs, arrays.sqnorms)
    _assert_designs_equal(args, kw, 256, "one list")
    args8 = (q[:8], starts[:8], lives[:8], arrays.vecs, arrays.sqnorms)
    _assert_designs_equal(args8, kw, 8, "one list")
    # a serving batch skips the grouping; grouped, its run of 128 pairs splits into 8 groups
    got = kp._launch_scores(*args8, cap, Metric.L2, False, grouped=True)
    assert torch.equal(got, kp.ivf_probe_scores_ref(*args8, **kw))


@pytest.mark.cuda
def test_ivf_k3_is_one_launch_and_its_counters_reset(cuda_device):
    """K3 puts one kernel on the card per call (the profiler's count), and
    back-to-back calls at B = 8, 3 and 8, and at chunks of 256 rows to a
    whole probe_cap, give the same results as single calls: the folding
    CTAs leave every arrival counter at 0."""
    from torch.profiler import ProfilerActivity, profile

    arrays, cap, centers = _chip_skewed_store(128, torch.bfloat16)
    q = torch.randn(8, 128, generator=torch.Generator(device=cuda_device).manual_seed(5),
                    device=cuda_device)
    kw = dict(nprobe=16, probe_cap=cap, metric=Metric.L2)
    a8 = _probe_args(arrays, centers, q, 16, Metric.L2, arrays.sqnorms)
    a3 = tuple(t[:3] for t in a8[:3]) + a8[3:]
    kp.ivf_probe_topc_rankmajor(*a8, **kw)  # build and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        first = kp.ivf_probe_topc_rankmajor(*a8, **kw)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA and "topc" in e.name]
    assert len(names) == 1 and "topc_kernel" in names[0], names
    mid = kp.ivf_probe_topc_rankmajor(*a3, **kw)
    last = kp.ivf_probe_topc_rankmajor(*a8, **kw)
    torch.cuda.synchronize()
    for a, b, r in zip(first, last, kp.ivf_probe_topc_rankmajor_ref(*a8, **kw)):
        assert torch.equal(a, b) and torch.equal(a, r)
    for a, r in zip(mid, kp.ivf_probe_topc_rankmajor_ref(*a3, **kw)):
        assert torch.equal(a, r)
    for chunk in (256, 1024, cap):  # 64 chunks a pair down to one: both fold levels
        got = kp._launch_topc(*a8, 16, cap, Metric.L2, chunk_rows=chunk)
        for a, r in zip(got, first):
            assert torch.equal(a, r), chunk
    torch.cuda.synchronize()
    assert not kp._ARRIVALS[q.device].any()


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
    assert kp.LAUNCHES == {"ivf_probe_topc": 1, "ivf_probe_scores": 1, "ivf_probe_scores_rankmajor": 0,
                           "ivf_probe_topc_v1": 0, "ivf_probe_scores_v1": 0}
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
    assert ap.LAUNCHES == {"adc_probe_scores": 2, "adc_probe_scores_rankseg": 2, "adc_probe_scores_v1": 0}
    # 'auto' over a whole code array launches the full-corpus ADC kernel K6
    fa.reset_launches()
    full = pq.adc_scan(codes if not packed else pq.unpack_u4(codes), lut)
    assert fa.LAUNCHES["adc_scan_u8"] == 1 and full.shape == (32, n_rows)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8, 16, 17, 256])
@pytest.mark.parametrize("m, ks", [(16, 256), (8, 256), (32, 16)], ids=["u8-pq16", "u8-m8", "u4-pq32x4"])
def test_adc_probe_kernel_equals_plain_on_the_skewed_store(m, ks, b, cuda_device):
    """K9/K10 against the plain version on chip_smoke's skewed store (empty
    lists, a 12,000-row list, probe_cap 16,384): L2 and IP, starts as
    stored and shifted off the 16-row units, without and with base (rows
    strided) and row_allow; the first design against the plain version too."""
    import chip_smoke

    arrays, cap, centers = _chip_skewed_store(96, torch.float32)
    gen = torch.Generator(device=cuda_device).manual_seed(m * b + ks)
    packed = ks <= 16
    n_rows = arrays.row_ids.shape[0]
    codes = torch.randint(0, ks, (n_rows, m), generator=gen, device=cuda_device).to(torch.uint8)
    if packed:
        codes = pq.pack_u4(codes)
    books = pq.books_from_centroids(torch.randn(m, ks, 96 // m, generator=gen, device=cuda_device))
    allow = torch.rand(n_rows, generator=gen, device=cuda_device) < 0.1
    kw = dict(nprobe=16, probe_cap=cap, m=m, ks=ks, packed_u4=packed)
    ap.reset_launches()
    for metric, lut_fn in ((Metric.L2, pq.pq_lut_q_l2), (Metric.INNER_PRODUCT, pq.pq_lut_ip)):
        tcorr = torch.randn(n_rows, generator=gen, device=cuda_device)
        if metric == Metric.INNER_PRODUCT:
            tcorr = torch.zeros_like(tcorr)
        q = torch.randn(b, 96, generator=gen, device=cuda_device)
        starts, lives = chip_smoke.probe_tables(q, centers, arrays, 16, metric)
        base = torch.randn(b, 32, generator=gen, device=cuda_device)[:, :16]  # strided rows
        for shift in (0, 3):
            args = (lut_fn(q, books).contiguous(), (starts + shift).contiguous(),
                    torch.clamp(lives - shift, min=0).contiguous(), codes, tcorr)
            chip_smoke.check_adc_kernels(ap, args, kw, f"{metric.value} shift {shift}", base, allow)
            v1 = ap.adc_probe_scores_v1(*args, **kw)
            torch.cuda.synchronize()
            assert torch.equal(v1, ap.adc_probe_scores_ref(*args, **kw))
    assert ap.LAUNCHES == {"adc_probe_scores": 8, "adc_probe_scores_rankseg": 8, "adc_probe_scores_v1": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 256])
def test_adc_probe_every_launch_plan_equals_plain(b, cuda_device):
    """Every plan the A/B sweeps (1, 2, 4 or 8 probes a CTA) gives the
    plain version's bits."""
    import chip_smoke

    arrays, cap, centers = _chip_skewed_store(96, torch.float32)
    gen = torch.Generator(device=cuda_device).manual_seed(b)
    n_rows = arrays.row_ids.shape[0]
    codes = torch.randint(0, 256, (n_rows, 16), generator=gen, device=cuda_device).to(torch.uint8)
    books = pq.books_from_centroids(torch.randn(16, 256, 6, generator=gen, device=cuda_device))
    q = torch.randn(b, 96, generator=gen, device=cuda_device)
    starts, lives = chip_smoke.probe_tables(q, centers, arrays, 16, Metric.L2)
    args = (pq.pq_lut_q_l2(q, books).contiguous(), starts, lives, codes,
            torch.randn(n_rows, generator=gen, device=cuda_device))
    kw = dict(nprobe=16, probe_cap=cap, m=16, ks=256, packed_u4=False)
    base = torch.randn(b, 16, generator=gen, device=cuda_device)
    allow = torch.rand(n_rows, generator=gen, device=cuda_device) < 0.5
    assert chip_smoke.check_adc_plans(ap, args, kw, base, allow, f"B={b}") == 4


@pytest.mark.cuda
def test_ivfpq_search_on_card_makes_no_extra_pass(cuda_device):
    """On a CUDA index the coarse term and the allow mask are K10's
    epilogue: a filtered search launches one K10 and no operator writes a
    [B, nprobe * probe_cap] tensor but the kernel's output and the top-C
    sort."""
    import chip_smoke

    rng = np.random.default_rng(8)
    x = rng.standard_normal((6000, 32)).astype(np.float32)
    idx = IVFPQIndex(32, Metric.L2, IVFPQConfig(nlist=32, nprobe=6, m=8, ks=256, rerank_c=512,
                                                 pq_iters=5), device=cuda_device)
    idx.insert_batch(list(range(len(x))), x)
    idx.optimize()
    q = x[:8] + 0.1 * rng.standard_normal((8, 32)).astype(np.float32)
    allow = list(range(0, len(x), 3))
    idx.batch_search(q, 10, allow_ids=allow)  # packs and encodes
    slots = 8 * 6 * tivf.probe_cap_for(idx._store.max_length)
    ap.reset_launches()
    ops = chip_smoke.big_ops(lambda: idx.batch_search(q, 10, allow_ids=allow), slots)
    assert ops <= {"empty", "sort"}, ops
    assert ap.LAUNCHES == {"adc_probe_scores": 0, "adc_probe_scores_rankseg": 1, "adc_probe_scores_v1": 0}


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
    assert fa.LAUNCHES == {"adc_scan_u8": 2, "adc_scan_u4": 2 if ks <= 16 else 0, "adc_topk_fused": 4,
                           "adc_scan_u8_v1": 0, "adc_scan_u4_v1": 0, "adc_topk_fused_v1": 0}
    with pytest.raises(ValueError):
        fa.adc_scan_u4(codes, torch.rand(2, m, ks, device=cuda_device))  # unpacked width


@pytest.mark.cuda
@pytest.mark.parametrize("ks", [16, 200, 256])
@pytest.mark.parametrize("m", [7, 8, 16, 32])
def test_scan_redesign_matches_plain_and_first_design(m, ks, cuda_device):
    """K6 and K7 (queries on the lanes, tiles out by bulk copies) against
    their plain versions and their first designs (adc_scan_*_v1) bit for
    bit: B = 1, 17, 64; n ragged with n % 4 != 0 (plain stores), n % 4 == 0
    (bulk copies, ragged last tile) and n below one tile; codes read from
    one row in (an odd m leaves them unaligned). Plain stores in place of
    bulk copies, and one query a lane instead of two, give the same floats; K7 equals K6 on the unpacked codes and K8's
    distances equal K6's at K8's rows."""
    gen = torch.Generator(device=cuda_device).manual_seed(m * ks)
    fa.reset_launches()
    for n in (20_000 + 77, 20_000 + 4, 300):
        codes = torch.randint(0, ks, (n + 1, m), generator=gen, device=cuda_device).to(torch.uint8)
        for c in (codes[:n], codes[1:]):
            packed = pq.pack_u4(c) if ks <= 16 and m % 2 == 0 else None
            for b in (1, 17, 64):
                lut = torch.rand(b, m, ks, generator=gen, device=cuda_device)
                k6 = fa.adc_scan_u8(c, lut)
                torch.cuda.synchronize()
                ref = fa.adc_scan_u8_ref(c, lut)
                assert torch.equal(k6, ref), (n, b)
                assert torch.equal(fa.adc_scan_u8_v1(c, lut), ref)
                for kw in (dict(bulk=False), dict(ql=1)):
                    assert torch.equal(fa.scan_launch(c, lut, False, **kw), ref), kw
                if packed is not None:
                    k7 = fa.adc_scan_u4(packed, lut)
                    torch.cuda.synchronize()
                    assert torch.equal(k7, fa.adc_scan_u4_ref(packed, lut)) and torch.equal(k7, k6)
                    assert torch.equal(fa.adc_scan_u4_v1(packed, lut), k7)
                if ks == 256 and m == 8 and n > 300:
                    kd, ki = fa.adc_topk_fused(c, lut, 10)
                    assert torch.equal(kd, torch.gather(k6, 1, ki.long()))
    assert fa.LAUNCHES["adc_scan_u8"] == 3 * 2 * 3 * 3
    assert fa.LAUNCHES["adc_scan_u8_v1"] == 3 * 2 * 3


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


@pytest.mark.cuda
@pytest.mark.parametrize("m, ks", [(8, 256), (16, 256), (16, 16), (32, 16)],
                         ids=["pq8x8", "pq16", "pq16x4", "pq32x4"])
@pytest.mark.parametrize("b", [1, 13, 16, 17, 256])
def test_k8_designs_match_the_plain_version(m, ks, b, cuda_device):
    """K8 (queries on the lanes) and its first design (adc_topk_fused_v1)
    against the plain version bit for bit over a ragged row count, at
    batches below, at, and past a query block; distances equal K6's at the
    rows returned."""
    gen = torch.Generator(device=cuda_device).manual_seed(b * m + ks)
    n = 20_000 + 77
    codes = torch.randint(0, ks, (n, m), generator=gen, device=cuda_device).to(torch.uint8)
    lut = torch.rand(b, m, ks, generator=gen, device=cuda_device)
    k6 = fa.adc_scan_u8(codes, lut)
    fa.reset_launches()
    for k in (10, 512):
        rd, ri = fa.adc_topk_fused_ref(codes, lut, k)
        for fn in (fa.adc_topk_fused, fa.adc_topk_fused_v1):
            kd, ki = fn(codes, lut, k)
            torch.cuda.synchronize()
            assert torch.equal(kd, rd) and torch.equal(ki, ri), fn.__name__
            assert torch.equal(kd, torch.gather(k6, 1, ki.long())) and (ki < n).all()
    assert fa.LAUNCHES["adc_topk_fused"] == 2 and fa.LAUNCHES["adc_topk_fused_v1"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 200, 256, 300])
def test_k8_short_corpus_never_reads_past_n(n, cuda_device):
    """n < 256 and a ragged last tile: rows >= n are never returned, and
    fewer than k rows pad with (+inf, INVALID_ID)."""
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    codes = torch.randint(0, 256, (n, 8), generator=gen, device=cuda_device).to(torch.uint8)
    lut = torch.rand(17, 8, 256, generator=gen, device=cuda_device)
    for fn in (fa.adc_topk_fused, fa.adc_topk_fused_v1):
        kd, ki = fn(codes, lut, 512)
        rd, ri = fa.adc_topk_fused_ref(codes, lut, 512)
        assert torch.equal(kd, rd) and torch.equal(ki, ri)
        live = ki != INVALID_ID
        assert (ki[live] < n).all() and int(live.sum(dim=1).max()) == min(n, 512)
        assert torch.isinf(kd[~live]).all()


@pytest.mark.cuda
def test_k8_class_crowding_keeps_three_rows_of_one_class(cuda_device):
    """A query whose three nearest rows share a class (c, c + 256, c + 512)
    gets all three back, as from the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    codes = torch.randint(0, 256, (3000, 8), generator=gen, device=cuda_device).to(torch.uint8)
    lut = torch.rand(17, 8, 256, generator=gen, device=cuda_device) + 1.0
    c = 37
    codes[[c, c + 256, c + 512]] = lut[5].argmin(dim=1).to(torch.uint8)
    for fn in (fa.adc_topk_fused, fa.adc_topk_fused_v1):
        kd, ki = fn(codes, lut, 10)
        rd, ri = fa.adc_topk_fused_ref(codes, lut, 10)
        assert torch.equal(kd, rd) and torch.equal(ki, ri)
        assert ki[5, :3].tolist() == [c, c + 256, c + 512]


def _wide_flat(dim, cuda_device, rows=3000, nq=9, round_q=True):
    """A bf16 L2 FlatIndex of capacity 2^17 with `rows` seeded gaussian rows
    of width dim, nq queries near some of them, and the exact (f64) squared
    distances [nq, rows], with q rounded to bf16 in the product where the
    path does (K1/K2 do, the strict path does not), and their f32
    tolerance: a distance the index sums in f32 over d terms (the dot
    product, ||x||^2 and ||q||^2) is within 2 d 2^-24 (2 sum_k |q_k x_k| +
    ||x||^2 + ||q||^2) of the exact one."""
    rng = np.random.default_rng(dim)
    x = rng.standard_normal((rows, dim)).astype(np.float32)
    q = x[rng.choice(rows, nq, replace=False)] + 0.5 * rng.standard_normal((nq, dim)).astype(np.float32)
    idx = tflat.FlatIndex(dim, Metric.L2, capacity=1 << 17, storage_dtype=torch.bfloat16,
                          device=cuda_device)
    idx.insert_batch(list(range(rows)), x)
    xb = torch.from_numpy(x).to(cuda_device).bfloat16().double()
    qf = torch.from_numpy(q).to(cuda_device).double()
    qd = qf.bfloat16().double() if round_q else qf
    xsq, qsq = (xb * xb).sum(1), (qf * qf).sum(1, keepdim=True)
    dist = xsq[None, :] - 2.0 * (qd @ xb.T) + qsq
    tol = 2.0 * dim * 2.0**-24 * (2.0 * (qd.abs() @ xb.abs().T) + xsq[None, :] + qsq)
    return idx, q, dist, tol


def _assert_exact_top_k(got, dist, tol, k=10):
    """Each returned squared distance is within tol of the exact one at its
    row, each returned row lies no further than the exact k-th distance by
    more than the two rows' tolerances, and every query has k distinct rows."""
    gi = torch.tensor([[r.id for r in row] for row in got], device=dist.device)
    gd = torch.tensor([[r.score**2 for r in row] for row in got], dtype=torch.float64,
                      device=dist.device)
    assert gi.shape == (dist.shape[0], k)
    ed, et = dist.gather(1, gi), tol.gather(1, gi)
    assert ((gd - ed).abs() <= et).all()
    sd, order = torch.sort(dist, dim=1, stable=True)
    kth_tol = tol.gather(1, order[:, k - 1 : k])
    assert (ed <= sd[:, k - 1 : k] + et + kth_tol).all()
    assert all(len(set(row)) == k for row in gi.tolist())


@pytest.mark.cuda
def test_wide_bf16_flat_index_runs_k1_k2_on_the_cuda_cores(cuda_device):
    """d = 2,416 bf16 is past the tensor-core CTA (d <= 2,400): K1 and K2
    both run the FMA design, the top-10 is exact (against f64 brute force
    over the bf16 rows, within the f32 tolerance of _wide_flat) and no query
    needs the strict path."""
    idx, q, dist, tol = _wide_flat(2416, cuda_device)
    assert sf.scan_design(2416, torch.bfloat16) == "fma"
    sf.reset_launches()
    TELEM.reset()
    TELEM.enable()
    try:
        got = idx.batch_search(q, 10)
    finally:
        TELEM.disable()
    assert sf.DESIGN_LAUNCHES == {"mma": {"bin_candidates": 0, "count_below": 0},
                                  "fma": {"bin_candidates": 1, "count_below": 1}}
    counters = TELEM.snapshot()["counters"]
    assert counters.get("flat.verify_fallback", 0) == 0 and counters["kernel.scan_fused.calls"] == 1
    _assert_exact_top_k(got, dist, tol)


@pytest.mark.cuda
def test_bf16_flat_index_past_the_fma_limit_takes_the_strict_path(cuda_device):
    """Past d = 7,264 no kernel design fits: at capacity 2^17 and B=32
    (B x capacity = VERIFIED_MIN_BLOCK) the index takes the verified scan
    (ops/scan.scan_topk_verified), no K1/K2 launch, and no query needs the
    strict path."""
    idx, q, dist, tol = _wide_flat(7300, cuda_device, rows=600, nq=32, round_q=False)
    assert sf.scan_design(7300, torch.bfloat16) == "strict"
    sf.reset_launches()
    TELEM.reset()
    TELEM.enable()
    try:
        got = idx.batch_search(q, 10)
    finally:
        TELEM.disable()
    assert not any(sf.LAUNCHES.values())
    counters = TELEM.snapshot()["counters"]
    assert counters["kernel.scan_verified.calls"] == 1
    assert counters.get("flat.verify_fallback", 0) == 0
    _assert_exact_top_k(got, dist, tol)


def _host_tier(device, n=6000, d=32, seed=9):
    """A trained IVFPQIndex(host_rerank=True) on `device` and its corpus."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    idx = IVFPQIndex(d, Metric.L2, IVFPQConfig(nlist=32, nprobe=6, m=8, ks=256, rerank_c=512,
                                                pq_iters=5, host_rerank=True), device=device)
    idx.insert_batch(list(range(n)), x)
    idx.optimize()
    return idx, x


@pytest.mark.cuda
def test_host_tier_stream_reuses_pinned_buffers_and_equals_per_call(cuda_device, monkeypatch):
    """A CUDA session over a CSRReader (the native rerank): its stream over
    more batches than the pinned pool holds (lookahead 2: 3 buffers, 9
    batches) equals search() batch by batch; K10 runs at B=8 and K9 at
    B=24, and every batch is counted under RERANK_IMPL["native"]."""
    idx, x = _host_tier(cuda_device)
    base = idx.serve_session(lookahead=2)
    assert base.arrays.vecs is None and idx._store._dev is None
    rid = base.arrays.row_ids.cpu().numpy()
    slot_vecs = np.zeros((idx._next_slot, x.shape[1]), np.float32)
    for slot, v in idx._vectors.items():
        slot_vecs[slot] = v
    sess = dataclasses.replace(base, reader=rr.CSRReader(slot_vecs, rid))
    rng = np.random.default_rng(3)
    batches = [x[rng.choice(len(x), b, replace=False)] + 0.05 for b in (8, 24, 8, 8, 24, 8, 8, 24, 8)]
    made = []
    real_empty = torch.empty

    def counted_empty(*a, **kw):
        if kw.get("pin_memory"):
            made.append(a)
        return real_empty(*a, **kw)

    monkeypatch.setattr(ap.torch, "empty", counted_empty)
    rr.reset_rerank_counts()
    ap.reset_launches()
    streamed = list(sess.stream(batches, 10))
    assert ap.LAUNCHES["adc_probe_scores_rankseg"] == 6 and ap.LAUNCHES["adc_probe_scores"] == 3
    assert rr.RERANK_IMPL == {"native": 9, "numpy": 0, "device": 0}
    assert len(made) == 3  # lookahead + 1 buffers, each reused (9 batches)
    for (sd, si), b in zip(streamed, batches):
        wd, wi = sess.search(b, 10)
        np.testing.assert_array_equal(si, wi)
        np.testing.assert_array_equal(sd, wd)
    host = IVFPQIndex.from_state({
        "dimension": 32, "metric": "l2", "storage_dtype": "float32",
        "config": idx.config.__dict__, "vectors": idx._vectors, "metadata": idx._metadata,
        "ids": list(idx._idmap.items()), "free": idx._free, "next_slot": idx._next_slot,
        "centroids": idx._centroids, "lists": idx._store._lists_ids, "slot_list": idx._slot_list,
        "slot_spill": idx._slot_spill, "books": idx._books.centroids.cpu().numpy(),
    }, device="cpu")
    got, want = idx.batch_search(batches[1], 10), host.batch_search(batches[1], 11)
    wd = np.array([[r.score**2 for r in row] for row in want])
    assert ids_match_up_to_ties([[r.id for r in row] for row in got],
                                [[r.id for r in row] for row in want], wd, 10)


@pytest.mark.cuda
def test_host_tier_index_on_card_keeps_vectors_off_the_device(cuda_device):
    """batch_search (filtered too), serve_session and batch_search_stream
    on a CUDA host-tier index: the device view has no vectors, the store
    never uploads them, and the stream equals per-call batch_search."""
    idx, x = _host_tier(cuda_device)
    q = x[:8] + 0.05
    allow = list(range(0, len(x), 3))
    ap.reset_launches()
    res = idx.batch_search(q, 10, allow_ids=allow)
    assert ap.LAUNCHES["adc_probe_scores_rankseg"] == 1
    assert all(r.id in set(allow) for row in res for r in row)
    arrays, _, _ = idx._sync_pq()
    assert arrays.vecs is None and arrays.sqnorms is None and idx._store._dev is None
    batches = [q, x[100:124] + 0.05, q]
    streamed = list(idx.batch_search_stream(batches, 10, lookahead=2))
    assert [[[r.id for r in row] for row in s] for s in streamed] == [
        [[r.id for r in row] for row in idx.batch_search(b, 10)] for b in batches]
    assert idx._store._dev is None


# ---------------------------------------------------------------------------
# HNSW (plain torch on the card) and k-means replayed from its seed
# ---------------------------------------------------------------------------


def _hnsw_pair(metric, device, n=3000, d=32):
    from vectorindex_tpu_torch.models.hnsw import HNSWConfig, HNSWIndex

    x = np.random.default_rng(5).integers(-8, 9, (n, d)).astype(np.float32)
    idx = HNSWIndex(d, metric, HNSWConfig(m=8, ef_construction=48, build_chunk=256), device=device)
    idx.insert_batch(list(range(n)), x)
    idx.statistics()
    return idx, x


@pytest.mark.cuda
@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT], ids=lambda m: m.value)
def test_hnsw_integer_build_on_card_equals_host(metric, cuda_device):
    """Integer-valued rows: every product and sum is exact and every sort
    two-key, so the card's graph and search equal the host's exactly."""
    card, x = _hnsw_pair(metric, cuda_device)
    host, _ = _hnsw_pair(metric, "cpu")
    assert card._entry == host._entry
    np.testing.assert_array_equal(card._levels, host._levels)
    np.testing.assert_array_equal(card._lookup0, host._lookup0)
    for a, b in zip(card._layers, host._layers, strict=True):
        assert a.node_ids == b.node_ids
        np.testing.assert_array_equal(a.nbrs[: a.count], b.nbrs[: b.count])
    q = np.random.default_rng(6).integers(-8, 9, (32, x.shape[1])).astype(np.float32)
    assert [[r.id for r in row] for row in card.batch_search(q, 10)] == [
        [r.id for r in row] for row in host.batch_search(q, 10)]


@pytest.mark.cuda
def test_hnsw_device_search_has_no_host_sync(cuda_device):
    """Once warm, with the queries on the card, device_search enqueues all
    its work: torch.cuda.set_sync_debug_mode("error") raises on any host
    synchronisation."""
    card, x = _hnsw_pair(Metric.L2, cuda_device)
    q = torch.from_numpy(x[:64] + 0.5).to(cuda_device)
    warm = card.device_search(q, 10)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = card.device_search(q, 10)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert all(torch.equal(a, b) for a, b in zip(warm, got))


@pytest.mark.cuda
def test_kmeans_and_pq_train_replay_on_card(cuda_device):
    """Trained twice from one seed on the card, k-means (k-means‖ seeding,
    k > 256) and pq_train give the same bits; the segment sum equals the
    CPU's index_add_ (each cluster's rows added in row order)."""
    from vectorindex_tpu_torch.ops import kmeans as km
    from vectorindex_tpu_torch.ops import rng as vrng

    gen = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.randn(40_000, 32, generator=gen, device=cuda_device)
    cfg = km.KMeansConfig(k=300, iters=8, seed=3)
    a, b = km.kmeans(x, cfg), km.kmeans(x, cfg)
    assert torch.equal(a.centroids, b.centroids) and torch.equal(a.assignments, b.assignments)
    books = [pq.pq_train(vrng.make_generator(3, 1, device=cuda_device), x, m=8, ks=64,
                         iters=5).centroids for _ in range(2)]
    assert torch.equal(books[0], books[1])
    sums, counts = km._segment_mean(x, a.assignments, 300)
    want = torch.zeros(300, 32).index_add_(0, a.assignments.cpu().long(), x.cpu())
    assert torch.equal(sums.cpu(), want)
    assert torch.equal(counts.cpu(), torch.bincount(a.assignments.cpu().long(), minlength=300).float())
    w = torch.rand(100_000, generator=gen, device=cuda_device)
    picks = [vrng.weighted_pick(torch.Generator(device=cuda_device).manual_seed(1), w, (4096,))
             for _ in range(2)]
    assert torch.equal(picks[0], picks[1])


@pytest.mark.cuda
def test_flat_bf16_container_reloads_on_card_through_k1_k2(cuda_device, monkeypatch, tmp_path):
    """A bf16 flat index saved and loaded on the card keeps bf16 and gives
    the live index's ids and scores bit for bit, through K1/K2 with no
    strict fallback."""
    monkeypatch.setattr(tflat, "LARGE_SCAN_THRESHOLD", 1024)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3000, 32)).astype(np.float32)
    q = x[:16] + 0.05 * rng.standard_normal((16, 32)).astype(np.float32)
    live = tflat.FlatIndex(32, Metric.L2, storage_dtype=torch.bfloat16, device=cuda_device)
    live.insert_batch(list(range(len(x))), x)
    live.remove(7)
    p = str(tmp_path / "flat.vx")
    live.save_container(p)
    loaded = tflat.FlatIndex.load_container(p, device=cuda_device)
    assert loaded.storage_dtype == torch.bfloat16 and loaded._dev is not None
    want = live.batch_search(q, 10)
    TELEM.reset()
    TELEM.enable()
    sf.reset_launches()
    try:
        got = loaded.batch_search(q, 10)
    finally:
        TELEM.disable()
    assert sf.LAUNCHES["bin_candidates"] == 1 and sf.LAUNCHES["count_below"] == 1
    assert TELEM.snapshot()["counters"].get("flat.verify_fallback", 0) == 0
    assert [[r.id for r in row] for row in got] == [[r.id for r in row] for row in want]
    assert [[r.score for r in row] for row in got] == [[r.score for r in row] for row in want]


@pytest.mark.cuda
def test_durable_ivf_reloads_on_card_through_k3_k4(cuda_device, tmp_path):
    """load_durable of a journaled bf16 IVF index on the card equals the
    live index: ids and scores at B=8 (K3) and B=32 (K4)."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((4000, 32)).astype(np.float32)
    live = IVFIndex(32, config=IVFConfig(nlist=16, nprobe=4), storage_dtype=torch.bfloat16,
                    device=cuda_device)
    live.insert_batch(list(range(3500)), x[:3500])
    live.optimize()
    p = str(tmp_path / "ivf.vx")
    live.enable_durable(p)
    live.insert_batch(list(range(3500, 4000)), x[3500:])
    for i in range(0, 400, 9):
        live.remove(i)
    for i in range(401, 600, 11):
        live.update(i, vector=x[i] + 0.3)
    live.update(2, metadata={"m": 2})
    live.close_durable()
    loaded = IVFIndex.load_durable(p, device=cuda_device)
    assert loaded.storage_dtype == torch.bfloat16 and loaded.count == live.count
    for b, kernel in ((8, "ivf_probe_topc"), (32, "ivf_probe_scores")):
        q = x[1000: 1000 + b] + 0.05
        want = live.batch_search(q, 10)
        kp.reset_launches()
        got = loaded.batch_search(q, 10)
        assert kp.LAUNCHES[kernel] >= 1
        assert [[r.id for r in row] for row in got] == [[r.id for r in row] for row in want]
        assert [[r.score for r in row] for row in got] == [[r.score for r in row] for row in want]


@pytest.mark.cuda
@pytest.mark.parametrize("metric", [Metric.MANHATTAN, Metric.L2], ids=lambda m: m.value)
def test_verified_route_on_card_matches_cpu(metric, cuda_device):
    """At capacity 2^17 and B=32 (B x capacity = VERIFIED_MIN_BLOCK),
    manhattan (and L2 with k above the fused cap) take
    ops/scan.scan_topk_verified: on the card with no strict fallback, and
    equal to the same index on the CPU up to ties (utils/parity)."""
    rng = np.random.default_rng(77)
    x = rng.standard_normal((3000, 32)).astype(np.float32)
    q = x[:32] + 0.1 * rng.standard_normal((32, 32)).astype(np.float32)
    k = 10 if metric == Metric.MANHATTAN else 2 * sf.C + 1
    got = {}
    for dev in ("cpu", cuda_device):
        idx = tflat.FlatIndex(32, metric, capacity=1 << 17, device=dev)
        idx.insert_batch(list(range(len(x))), x)
        TELEM.reset()
        TELEM.enable()
        try:
            got[str(dev)] = idx.batch_search(q, k)
        finally:
            TELEM.disable()
        counters = TELEM.snapshot()["counters"]
        assert counters["kernel.scan_verified.calls"] == 1
        assert counters.get("flat.verify_fallback", 0) == 0
    cpu, card = got["cpu"], got[str(cuda_device)]
    wd = np.array([[r.score for r in row] for row in cpu], dtype=np.float64)
    wd = wd * wd if metric == Metric.L2 else wd
    gd = np.array([[r.score for r in row] for row in card], dtype=np.float64)
    np.testing.assert_allclose(gd * gd if metric == Metric.L2 else gd, wd, rtol=RTOL, atol=ATOL)
    assert ids_match_up_to_ties([[r.id for r in row] for row in card],
                                [[r.id for r in row] for row in cpu], wd, k)


@pytest.mark.cuda
def test_four_shards_on_one_card_match_the_unsharded_search(cuda_device):
    """ShardedFlatIndex over 4 shards of cuda:0 equals the mesh of the
    visible cards bit for bit (each shard scores blocks of the same shape),
    and the unsharded FlatIndex up to ties."""
    from vectorindex_tpu_torch.models.sharded import ShardedFlatIndex

    rng = np.random.default_rng(78)
    x = rng.standard_normal((150_000, 64)).astype(np.float32)
    q = x[:16] + 0.1 * rng.standard_normal((16, 64)).astype(np.float32)
    four = ShardedFlatIndex(64, n_devices=4, devices=[cuda_device] * 4)
    one = ShardedFlatIndex(64, n_devices=1, device="cuda")
    flat = tflat.FlatIndex(64, device=cuda_device)
    for idx in (four, one, flat):
        idx.insert_batch(list(range(len(x))), x)
    assert four.n_shards == 4 and four.capacity == 1 << 18
    a, b, c = (idx.batch_search(q, 10) for idx in (four, one, flat))
    assert [[(r.id, r.score) for r in row] for row in a] == [[(r.id, r.score) for r in row]
                                                             for row in b]
    wd = np.array([[r.score**2 for r in row] for row in c])
    np.testing.assert_allclose([[r.score**2 for r in row] for row in a], wd, rtol=RTOL, atol=ATOL)
    assert ids_match_up_to_ties([[r.id for r in row] for row in a],
                                [[r.id for r in row] for row in c], wd, 10)


@pytest.mark.cuda
def test_typed_refuses_a_cuda_tensor(cuda_device):
    """models/typed refuses a tensor on the card with the failed
    conversion's error; it never moves it to the host silently."""
    from vectorindex_tpu_torch.models.typed import as_matrix, as_vector
    from vectorindex_tpu_torch.utils.errors import IndexError, IndexErrorKind

    t = torch.ones(8, device=cuda_device)
    for fn in (as_vector, as_matrix):
        with pytest.raises(IndexError) as ei:
            fn(t, 8)
        assert ei.value.kind == IndexErrorKind.INVALID_VECTOR
    assert as_vector(t.cpu(), 8).shape == (8,)


@pytest.mark.cuda
@pytest.mark.parametrize("with_vecs", [True, False], ids=["vecs", "meta"])
def test_bench_pack_ivf_on_the_card_equals_the_host(with_vecs, cuda_device):
    """bench/synth.pack_ivf on cuda gives the CPU call's layout bit for bit."""
    from vectorindex_tpu_torch.bench import synth

    x, _, assign = synth.clustered_corpus(20_000, 64, 32, seed=5)
    a_dev, o_dev, cap_dev = synth.pack_ivf(x, assign, 32, with_vecs=with_vecs, device=cuda_device)
    a_cpu, o_cpu, cap_cpu = synth.pack_ivf(x, assign, 32, with_vecs=with_vecs, device="cpu")
    assert cap_dev == cap_cpu and a_dev.row_ids.is_cuda
    np.testing.assert_array_equal(o_dev, o_cpu)
    for name in ("vecs", "row_ids", "sqnorms", "starts", "lengths"):
        got, want = getattr(a_dev, name), getattr(a_cpu, name)
        assert (got is None) == (want is None) == (name in ("vecs", "sqnorms") and not with_vecs)
        if got is not None:
            assert torch.equal(got.cpu(), want), name


@pytest.mark.cuda
def test_bench_truth_on_the_card_equals_the_host(cuda_device):
    """exact_truth_chunked on cuda (a row chunk that does not divide n)
    equals its CPU call up to ties of the f64 distances, and exact_truth."""
    from vectorindex_tpu_torch.bench import datagen, synth

    x = datagen.generate(50_001, 64, seed=6)
    q = datagen.queries_from(x, 32, noise=0.1, seed=7)
    got = synth.exact_truth_chunked(q, x, 10, row_chunk=16_384, device=cuda_device)
    want = synth.exact_truth_chunked(q, x, 10, row_chunk=16_384, device="cpu")
    ref = np.sort(((q[:, None, :].astype(np.float64) - x[None].astype(np.float64)) ** 2).sum(-1),
                  axis=1)[:, :11]
    assert ids_match_up_to_ties(got, want, ref, 10)
    assert ids_match_up_to_ties(synth.exact_truth(q, x, 10, device=cuda_device), got, ref, 10)


@pytest.mark.cuda
def test_bench_time_loop_on_the_card(cuda_device):
    """time_loop times by CUDA events: positive times, outputs equal to a
    direct loop over the same slices on the card."""
    from vectorindex_tpu_torch.bench import timing

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    qpool = torch.randn(4 * 64, 128, generator=gen, device=cuda_device)
    x = torch.randn(100_000, 128, generator=gen, device=cuda_device)

    def fn(q, x):
        g = q @ x.T
        return g.sum(), torch.argmax(g, dim=1).sum()

    sec, out, samples = timing.time_loop(fn, qpool, 64, 4, args=(x,), return_samples=True,
                                         device=cuda_device)
    assert sec > 0 and all(s > 0 for s in samples)
    want = [fn(qpool[i * 64 : (i + 1) * 64], x) for i in range(4)]
    assert out[1] == sum(int(w[1]) for w in want)
    s0 = want[0][0]
    for w in want[1:]:
        s0 = s0 + w[0]
    assert out[0] == s0.cpu().numpy()
    assert timing.time_host(lambda: fn(qpool[:64], x)[0].item(), device=cuda_device) > 0
