"""The port's full-corpus ADC kernels (vectorindex_tpu_torch.kernels.adc: K6
adc_scan_u8, K7 adc_scan_u4, K8 adc_topk_fused) against the JAX package's
Pallas kernels (vectorindex_tpu.kernels.adc) on the same seeded numpy codes
and LUTs.

On the CPU the port's wrappers run the plain PyTorch versions; the JAX side
runs its kernels in interpret mode at the shapes of
tests/test_pallas_kernels.py, so the compiles stay few.

K8's kernel geometry (the query block, warps and class groups, the grid and
the [m, ks, B] LUT layout) is checked here by a numpy replay of the kernel's
index arithmetic; the kernel itself on the card by tests/test_torch_cuda.py.

Tolerances:
  - ADC distances: rtol=atol=1e-5. In interpret mode the JAX kernels
    contract a one-hot matrix with the f32 LUT (XLA's summation order); the
    port adds the m entries in order j = 0..m-1.
  - K8 ids: equal.
  - Within the port: K7 equals K6 on the unpacked codes, and K8's distances
    equal K6's at K8's rows, bit for bit (one add order everywhere).
The CUDA kernels are compared with these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorindex_tpu.kernels import adc as jadc
from vectorindex_tpu.ops import dtypes as jdtypes
from vectorindex_tpu_torch.kernels import adc
from vectorindex_tpu_torch.kernels import scan_fused as sf
from vectorindex_tpu_torch.ops import dtypes, pq
from vectorindex_tpu_torch.ops.topk import INVALID_ID, topk

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
CSRC = Path(__file__).resolve().parents[1] / "vectorindex_tpu_torch" / "kernels" / "csrc"


def _case(n, m, ks, b, seed, square=False):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, ks, (n, m)).astype(np.uint8)
    lut = rng.standard_normal((b, m, ks)).astype(np.float32)
    return codes, (lut**2 if square else lut)


def test_k6_plain_matches_jax_kernel():
    codes, lut = _case(1024, 8, 16, 4, seed=0)
    want = np.asarray(jadc.adc_scan_pallas(jnp.asarray(codes), jnp.asarray(lut), tile=256,
                                           interpret=True))
    got = adc.adc_scan_u8(torch.from_numpy(codes), torch.from_numpy(lut))
    assert got.shape == (4, 1024) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # ops/pq's 'auto' takes the JAX CPU route ('gather') on a CPU tensor
    auto = pq.adc_scan(torch.from_numpy(codes), torch.from_numpy(lut))
    np.testing.assert_allclose(auto.numpy(), want, **TOL)


def test_k7_plain_matches_jax_kernel():
    codes, lut = _case(1024, 8, 16, 4, seed=2)
    packed = np.array(jdtypes.pack_u4(jnp.asarray(codes)))
    np.testing.assert_array_equal(dtypes.pack_u4(torch.from_numpy(codes)).numpy(), packed)
    want = np.asarray(jadc.adc_scan_u4_pallas(jnp.asarray(packed), jnp.asarray(lut), tile=256,
                                              interpret=True))
    got = adc.adc_scan_u4(torch.from_numpy(packed), torch.from_numpy(lut))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the packed bytes are read in place: K7 is K6 on the unpacked codes
    assert torch.equal(got, adc.adc_scan_u8(torch.from_numpy(codes), torch.from_numpy(lut)))
    assert torch.equal(pq.adc_scan_u4(torch.from_numpy(packed), torch.from_numpy(lut)),
                       pq.adc_scan(torch.from_numpy(codes), torch.from_numpy(lut)))


@pytest.fixture(scope="module")
def k8_case():
    """The JAX fused top-k at n=3000, m=4, ks=16, B=12, k=10 on random
    codes, and on the same codes with a class-crowded query 0."""
    codes, lut = _case(3000, 4, 16, 12, seed=5, square=True)
    crowded = codes.copy()
    # query 0's three nearest rows: c, c + 256, c + 512 (class c of the first
    # 1,024-row tile), all at the smallest sum of query 0's LUT
    c = 37
    crowded[[c, c + 256, c + 512]] = np.argmin(lut[0], axis=1)
    out = {}
    for name, cc in (("random", codes), ("crowded", crowded)):
        jd, ji = jadc.adc_topk_fused(jnp.asarray(cc), jnp.asarray(lut), 10, interpret=True)
        out[name] = (cc, np.asarray(jd), np.asarray(ji))
    return lut, out, c


def test_k8_plain_matches_jax_kernel(k8_case):
    lut, out, _ = k8_case
    codes, jd, ji = out["random"]
    tc, tl = torch.from_numpy(codes), torch.from_numpy(lut)
    got_d, got_i = adc.adc_topk_fused(tc, tl, 10)
    assert got_d.shape == (12, 10) and got_i.dtype == torch.int32
    np.testing.assert_allclose(got_d.numpy(), jd, **TOL)
    np.testing.assert_array_equal(got_i.numpy(), ji)
    # the scan-then-strict-top-k answer, with K6's distances bit for bit
    full = adc.adc_scan_u8(tc, tl)
    want_d, want_i = topk(full, 10)
    assert torch.equal(got_d, want_d) and torch.equal(got_i, want_i)
    assert torch.equal(got_d, torch.gather(full, 1, got_i.long()))
    # k beyond the 2C bound is clamped to 2C, as in the JAX package
    wide_d, wide_i = adc.adc_topk_fused(tc, tl, 600)
    assert wide_d.shape == (12, 2 * adc.C_BINS)
    assert torch.equal(wide_i[:, :10], got_i)


def test_k8_class_crowding_keeps_what_the_tpu_kernel_drops(k8_case):
    """Rows c, c+256 and c+512 of one 1,024-row tile tie as query 0's
    nearest. The TPU kernel keeps 2 rows per class per tile and loses the
    third; the port's exact per-class top-3 returns the scan-then-sort
    answer, a superset of the TPU's candidates (not a fault of either)."""
    lut, out, c = k8_case
    codes, jd, ji = out["crowded"]
    got_d, got_i = adc.adc_topk_fused(torch.from_numpy(codes), torch.from_numpy(lut), 10)
    full = adc.adc_scan_u8(torch.from_numpy(codes), torch.from_numpy(lut))
    want_d, want_i = topk(full, 11)
    assert torch.equal(got_i, want_i[:, :10]) and torch.equal(got_d, want_d[:, :10])
    assert got_i[0, :3].tolist() == [c, c + 256, c + 512]
    strict = [i for i in want_i[0].tolist() if i != c + 512]
    assert ji[0].tolist() == strict[:10]  # the TPU kernel drops row c + 512
    np.testing.assert_array_equal(got_i[1:].numpy(), ji[1:])  # other queries agree
    np.testing.assert_allclose(got_d[1:].numpy(), jd[1:], **TOL)


def test_k8_masks_rows_past_n():
    codes, lut = _case(100, 4, 16, 4, seed=6)
    lut = np.abs(lut)
    jd, ji = jadc.adc_topk_fused(jnp.asarray(codes), jnp.asarray(lut), 10, interpret=True)
    got_d, got_i = adc.adc_topk_fused(torch.from_numpy(codes), torch.from_numpy(lut), 10)
    assert (got_i < 100).all() and torch.isfinite(got_d).all()
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(jd), **TOL)


def test_k8_fewer_rows_than_k_pads_with_invalid_id():
    """A query with fewer than k rows: the JAX kernel fills the empty slots
    with (+inf, 0), and row 0 is a real row (a reference fault, ROADMAP
    Queue 3); the port pads with (+inf, INVALID_ID), as every other top-k
    of either package does."""
    codes, lut = _case(5, 4, 16, 4, seed=7)
    lut = np.abs(lut)
    jd, ji = map(np.asarray, jadc.adc_topk_fused(jnp.asarray(codes), jnp.asarray(lut), 10,
                                                 interpret=True))
    got_d, got_i = adc.adc_topk_fused(torch.from_numpy(codes), torch.from_numpy(lut), 10)
    assert np.isinf(jd[:, 5:]).all() and (ji[:, 5:] == 0).all()  # the reference's padding
    assert torch.isinf(got_d[:, 5:]).all() and (got_i[:, 5:] == INVALID_ID).all()
    np.testing.assert_array_equal(got_i[:, :5].numpy(), ji[:, :5])
    np.testing.assert_allclose(got_d[:, :5].numpy(), jd[:, :5], **TOL)
    assert sorted(got_i[0, :5].tolist()) == list(range(5))
    empty_d, empty_i = adc.adc_topk_fused(torch.zeros((0, 4), dtype=torch.uint8),
                                          torch.from_numpy(lut), 3)
    assert torch.isinf(empty_d).all() and (empty_i == INVALID_ID).all()


def test_wrappers_check_their_inputs():
    codes = torch.zeros((64, 8), dtype=torch.uint8)
    lut = torch.zeros((2, 8, 16))
    bad = [
        (adc.adc_scan_u8, codes.int(), lut),  # codes not uint8
        (adc.adc_scan_u8, codes, lut.double()),  # lut not f32
        (adc.adc_scan_u8, codes[:, :7], lut),  # subspace count
        (adc.adc_scan_u8, codes, torch.zeros((2, 8, 300))),  # ks > 256
        (adc.adc_scan_u8, codes, torch.zeros((2, 16, 16)).transpose(1, 2)),  # not contiguous
        (adc.adc_scan_u8, torch.zeros((64, 256), dtype=torch.uint8), torch.zeros((1, 256, 256))),
        (adc.adc_scan_u4, codes, lut),  # unpacked width
        (adc.adc_scan_u4, codes[:, :4], torch.zeros((2, 8, 32))),  # ks > 16
        (adc.adc_scan_u4, codes[:, :4], torch.zeros((2, 7, 16))),  # odd m
    ]
    for fn, c, lt in bad:
        with pytest.raises(ValueError):
            fn(c, lt)
    with pytest.raises(ValueError):
        adc.adc_topk_fused(codes, lut.double(), 5)
    assert adc.query_block(8, 256) == 8 and adc.query_block(64, 256) == 3
    adc.reset_launches()
    adc.adc_scan_u8(codes, lut)
    assert adc.LAUNCHES == {"adc_scan_u8": 0, "adc_scan_u4": 0, "adc_topk_fused": 0,
                            "adc_scan_u8_v1": 0, "adc_scan_u4_v1": 0, "adc_topk_fused_v1": 0,
                            "adc_topk_fused_v2": 0}


def test_source_names_what_it_replaces():
    text = (CSRC / "adc.cu").read_text()
    for name in ("adc_scan_pallas", "adc_scan_u4_pallas", "adc_topk_fused"):
        assert f"adc.py:{name}" in text
    assert jadc.C_BINS == adc.C_BINS
    # K1/K2 and K8 share the class selection; K6-K10 share the ADC sum
    for src, header in (("scan_fused.cu", "class_top3.cuh"), ("adc.cu", "class_top3.cuh"),
                        ("adc.cu", "adc_sum.cuh"), ("adc_probe.cu", "adc_sum.cuh")):
        assert f'#include "{header}"' in (CSRC / src).read_text()


@pytest.mark.parametrize("m, ks, qb", [(8, 256, 16), (16, 256, 8), (16, 16, 32), (32, 16, 32),
                                      (8, 100, 16), (64, 256, 2)])
def test_k8_query_block_is_the_largest_that_fits(m, ks, qb):
    """K8 stages the largest power-of-two block of queries (at most 32, one
    a lane) whose LUTs, each table padded to 16 or 256 entries, fit in
    shared memory; its warps and class groups cover the C classes with
    K8_PAIRS classes a thread."""
    kpad = adc.k8_ks_pad(ks)
    assert kpad == (16 if ks <= 16 else 256)
    assert adc.k8_query_block(m, ks) == qb
    assert 4 * qb * m * kpad <= adc.MAX_SMEM_BYTES
    assert qb == adc.K8_MAX_QUERY_BLOCK or 8 * qb * m * kpad > adc.MAX_SMEM_BYTES
    warps, groups = adc.k8_warps(qb)
    assert 1 <= warps <= adc.K8_MAX_WARPS
    assert warps * groups * adc.K8_PAIRS * (32 // qb) == adc.C_BINS


@pytest.mark.parametrize("nq, ntiles, resident", [
    (256, 3907, 132), (8, 3907, 132), (1, 3907, 132), (17, 3907, 132), (700, 3907, 132),
    (256, 3907, 396), (13, 2, 132), (13, 1, 132)])
def test_k8_grid_covers_every_tile_once(nq, ntiles, resident):
    qb = 16
    _, groups = adc.k8_warps(qb)
    splits, per = adc.k8_grid(nq, qb, groups, ntiles, resident)
    tiles = [t for s in range(splits) for t in range(s * per, min((s + 1) * per, ntiles))]
    assert tiles == list(range(ntiles))  # each tile once, no split empty
    assert (splits - 1) * per < ntiles
    ctas = -(-nq // qb) * groups * splits
    fill = ctas / (-(-ctas // resident) * resident)
    assert fill >= adc.K8_WAVE_FILL or splits == ntiles


def test_k8_main_shape_is_one_wave():
    """bench_adc's batch: B=256 over 1M PQ8x8 rows. 16 queries a CTA take
    128 KB of LUTs, so one CTA an SM; 16 query blocks x 2 class groups x 4
    splits = 128 CTAs, one wave on the 132 SMs (PR 4's design ran 544 CTAs
    in 1.37 waves of 396)."""
    qb = adc.k8_query_block(8, 256)
    warps, groups = adc.k8_warps(qb)
    per_sm = sf.SM_SMEM_BYTES // (4 * qb * 8 * 256 + 1024)
    assert (qb, warps, groups, per_sm) == (16, 16, 2, 1)
    splits, per = adc.k8_grid(256, qb, groups, -(-1_000_000 // adc.C_BINS), sf.SMS * per_sm)
    assert (splits, per) == (4, 977) and 16 * groups * splits <= sf.SMS


def test_lut_by_entry_reads_back():
    _, lut = _case(1, 8, 16, 5, seed=9)
    t = adc.lut_by_entry(torch.from_numpy(lut))
    assert t.shape == (8, 16, 5) and t.is_contiguous()
    assert torch.equal(t.permute(2, 0, 1), torch.from_numpy(lut))
    assert t[3, 7, 2] == lut[2, 3, 7]


@pytest.mark.parametrize("m, ks, b, qb", [(8, 16, 13, 16), (8, 16, 13, 8), (4, 16, 17, 32),
                                          (16, 16, 3, 32), (8, 16, 1, 16), (5, 100, 5, 16)])
def test_k8_lane_layout_replays_the_plain_sums(m, ks, b, qb):
    """A numpy replay of csrc/adc.cu's adc_qlane_candidates_kernel indexing
    over a ragged n and a ragged last query block: each CTA stages its
    queries' LUTs [m][kpad][qb] from lut_by_entry (tables padded to kpad =
    k8_ks_pad(ks) entries), each lane scores query lane % qb of rows
    tile*C + class for its K8_PAIRS classes, the entry of code c in
    subspace j at byte (j*kpad*qb + c*qb + q)*4, the sum read in j order
    with f32 adds. Every (query, row < n) is scored exactly once, by one
    split, and equals plain K6 bit for bit."""
    n = 700
    codes, lut = _case(n, m, ks, b, seed=qb + b)
    kpad = adc.k8_ks_pad(ks)
    lut_t = adc.lut_by_entry(torch.from_numpy(lut)).numpy().reshape(m, ks, b)
    warps, groups = adc.k8_warps(qb)
    ntiles = -(-n // adc.C_BINS)
    splits, per = adc.k8_grid(b, qb, groups, ntiles, resident=sf.SMS)
    rows = 32 // qb
    y, w, lane, p = (a.ravel() for a in np.meshgrid(range(groups), range(warps), range(32),
                                                    range(adc.K8_PAIRS), indexing="ij"))
    q, cls = lane % qb, (y * warps + w) * adc.K8_PAIRS * rows + lane // qb + p * rows
    got = np.full((b, n), np.nan, dtype=np.float32)
    hits = np.zeros((b, n), dtype=np.int64)
    for q0 in range(0, b, qb):
        nqb = min(qb, b - q0)
        slut = np.zeros((m, kpad, qb), dtype=np.float32)
        slut[:, :ks, :nqb] = lut_t[:, :, q0 : q0 + nqb]
        slut = slut.ravel()
        for split in range(splits):
            for tile in range(split * per, min((split + 1) * per, ntiles)):
                row = tile * adc.C_BINS + cls
                live = (row < n) & (q < nqb)
                r, qq = row[live], q[live]
                acc = np.zeros(len(r), dtype=np.float32)
                for j in range(m):
                    byte = (j * kpad * qb + codes[r, j].astype(np.int64) * qb + qq) * 4
                    acc = acc + slut[byte // 4]
                got[q0 + qq, r] = acc
                np.add.at(hits, (q0 + qq, r), 1)
    assert (hits == 1).all()
    want = adc.adc_scan_u8_ref(torch.from_numpy(codes), torch.from_numpy(lut)).numpy()
    np.testing.assert_array_equal(got, want)


def test_k8_first_design_needs_cuda_tensors():
    codes, lut = _case(300, 8, 16, 2, seed=10)
    adc.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        adc.adc_topk_fused_v1(torch.from_numpy(codes), torch.from_numpy(lut), 10)
    with pytest.raises(ValueError):
        adc.adc_topk_fused_v1(torch.from_numpy(codes), torch.from_numpy(lut).double(), 10)
    assert not any(adc.LAUNCHES.values())


#: csrc/adc_topk.cu's kernel table: (qb, ksp, ql, skew, cnt) of each instance
RING_TABLE = {tuple(map(int, t)) for t in re.findall(
    r"VI_RING\((\d+), (\d+), (\d+), (\d+), (\d+)\)", (CSRC / "adc_topk.cu").read_text())}


def _ring_replay(codes, lut, plan, ctas):
    """A numpy replay of csrc/adc_topk.cu: adc_ring_candidates_kernel's map
    from (CTA, segment, tile, phase, step, warp, lane, pair, query of the
    lane) to (query, class, row, subspace), over the LUTs as lut_blocks lays
    them out, and merge_segments_kernel's partial slots. Each phase a lane
    of skew s adds sub-block (f - s) mod skew of its row (the previous
    tile's while f < s), reading the entry of code c at byte i·KSP·line +
    c·line + (sub-block)·qb·4 + 4·ql·q (+ 4 for its second query); a row
    starts from +0.0 at phase s and ends at phase s - 1. Returns the sums of
    every valid (query, row) it ends, how often each was ended, and each
    stream's partial slots."""
    n, m = codes.shape
    b, _, ks = lut.shape
    qb, ql, skew, warps, groups, _ = plan
    pairs, _, _ = adc.k8_geometry(qb, ql)
    kpad, mb = adc.k8_ks_pad(ks), -(-m // skew)
    lanes, slots_w, rows_g = qb // ql, 32 * ql // qb, adc.C_BINS // groups
    line = skew * qb * 4
    nblk, ntiles = -(-b // qb), -(-n // adc.C_BINS)
    units = nblk * groups * ntiles
    blocks = adc.lut_blocks(torch.from_numpy(lut), qb, ql, skew).numpy().reshape(nblk, -1)
    flat = codes.astype(np.int64).ravel()
    w, lane, p, hq = (a.ravel() for a in np.meshgrid(range(warps), range(32), range(pairs),
                                                     range(ql), indexing="ij"))
    q, slot = lane % lanes, lane // lanes
    s = slot % skew
    lr = w * pairs * slots_w + slot + p * slots_w
    assert sorted(set(lr.tolist())) == list(range(rows_g))  # the group's rows, each a slot
    got = np.full((b, n), np.nan, dtype=np.float32)
    hits = np.zeros((b, n), dtype=np.int64)
    stream_slots = {}

    def cta_of(u):
        return ((u + 1) * ctas - 1) // units

    for k in range(ctas):
        u, u1 = k * units // ctas, (k + 1) * units // ctas
        while u < u1:
            st = u // ntiles
            tb = u - st * ntiles
            te = min(ntiles, tb + u1 - u)
            qblk, g = divmod(st, groups)
            stream_slots.setdefault(st, []).append(k - cta_of(st * ntiles))
            qi = qblk * qb + q + hq * lanes
            acc = np.zeros(len(lane), dtype=np.float32)
            nxt = np.zeros(len(lane), dtype=np.int64)  # the next subspace each sum must add
            for t in range(tb, te + (skew > 1)):
                for f in range(skew):
                    acc[f == s] = 0.0
                    nxt[f == s] = 0
                    tile = np.where(f >= s, t, t - 1)
                    row = tile * adc.C_BINS + g * rows_g + lr
                    h = (f - s) % skew
                    valid = (tile >= tb) & (tile < te) & (row < n) & (qi < b)
                    for i in range(mb):
                        j = h * mb + i
                        at = row * m + j  # a padded subspace reads past its row
                        code = np.where((at >= 0) & (at < flat.size),
                                        flat[np.clip(at, 0, flat.size - 1)], 0) & (kpad - 1)
                        byte = i * kpad * line + code * line + h * qb * 4 + 4 * ql * q + 4 * hq
                        entry = blocks[qblk, byte // 4]
                        assert (entry[valid & (j >= m)] == 0).all()  # a zero table
                        assert (nxt[valid] == j[valid]).all()  # j in order
                        acc = (acc + entry).astype(np.float32)
                        nxt += 1
                    end = valid & (f == (s + skew - 1) % skew)
                    assert (nxt[end] == mb * skew).all()
                    got[qi[end], row[end]] = acc[end]
                    np.add.at(hits, (qi[end], row[end]), 1)
            u += te - tb
    return got, hits, stream_slots


@pytest.mark.parametrize("m, ks, b, n, resident, override", [
    (8, 256, 17, 700, 3, {}),  # PQ8x8: 16 a CTA, 4 a lane, skew 2; a ragged block, 3 CTAs
    (8, 256, 40, 1300, 5, {}),  # past a block; segments cut by CTAs
    (8, 256, 40, 1300, 5, dict(ql=1)),  # one query a lane (the A/B)
    (8, 256, 40, 1300, 5, dict(ql=2)),  # two a lane (the A/B)
    (16, 256, 9, 900, 4, dict(ql=2)),  # two a lane at PQ16 (the A/B)
    (8, 256, 40, 1300, 7, dict(skew=1)),  # skew off (the A/B)
    (8, 256, 5, 600, 132, {}),  # B below a block: 8 a CTA, no skew
    (8, 256, 1, 300, 2, {}),  # one query, one a lane
    (8, 256, 2, 300, 2, {}),  # two queries, two a lane
    (16, 256, 9, 900, 4, {}),  # PQ16: 8 a CTA, skew 4
    (9, 256, 20, 800, 3, {}),  # m odd: skew 2, an idle step of a zero table
    (18, 200, 12, 600, 3, {}),  # m = 18 over skew 4: mb 5, two idle steps
    (7, 200, 3, 555, 2, {}),  # m odd below the skew's least width
    (32, 256, 5, 600, 3, {}),  # rows of 32 codes: 4 a CTA, a loop compiled for them
    (64, 16, 16, 700, 3, {}),  # rows of 64 codes at skew 2, four class groups
    (8, 16, 40, 1000, 6, {}),  # small tables: 32 a CTA, two class groups
    (16, 16, 16, 700, 5, {})])  # 16 a CTA, skew 2, four class groups
def test_k8_ring_replays_the_plain_sums(m, ks, b, n, resident, override):
    """The replay of K8's kernel under k8_plan (and the A/B's variants)
    over a ragged n and ragged query blocks: every (query, row < n) is
    summed exactly once, over j = 0..m-1 in order and then the zero tables,
    and equals plain K6 bit for bit; each stream's partial slots are 0..k-1
    with k from the merge's formula, at most k8_part_slots."""
    codes, lut = _case(n, m, ks, b, seed=m * b + n)
    plan = adc.k8_plan(m, ks, b, **override)
    ctas = adc.k8_ctas(plan, b, n, resident)
    got, hits, stream_slots = _ring_replay(codes, lut, plan, ctas)
    assert (hits == 1).all()
    want = adc.adc_scan_u8_ref(torch.from_numpy(codes), torch.from_numpy(lut)).numpy()
    np.testing.assert_array_equal(got, want)
    ntiles = -(-n // adc.C_BINS)
    units = -(-b // plan.qb) * plan.groups * ntiles
    for st, slots in stream_slots.items():
        first = ((st * ntiles + 1) * ctas - 1) // units
        last = ((st * ntiles + ntiles) * ctas - 1) // units
        assert slots == list(range(last - first + 1))
        assert len(slots) <= adc.k8_part_slots(plan, b, n, ctas)


def test_k8_lut_blocks_read_back():
    """lut_blocks(lut, qb, ql, skew): line (i, code) of block blk holds in
    segment h, column 2q + e, query blk·qb + q + e·qb/2's entry of subspace
    h·mb + i; zero past ks, past m (padded to mb·skew) and past B."""
    _, lut = _case(1, 9, 200, 13, seed=12)
    qb, ql, skew = 8, 2, 4
    t = adc.lut_blocks(torch.from_numpy(lut), qb, ql, skew)
    mb = 3  # ceil(9 / 4)
    assert t.shape == (2, mb, 256, skew * qb) and t.is_contiguous()
    v = t.view(2, mb, 256, skew, qb).numpy()
    for blk in range(2):
        for col in range(qb):
            query = blk * qb + col // 2 + (col % 2) * qb // 2
            for h in range(skew):
                for i in range(mb):
                    j = h * mb + i
                    want = lut[query, j] if query < 13 and j < 9 else np.zeros(200, np.float32)
                    np.testing.assert_array_equal(v[blk, i, :200, h, col], want)
                    assert not v[blk, i, 200:, h, col].any()
    assert torch.equal(adc.lut_blocks(torch.from_numpy(lut), qb, ql, 1),
                       adc.lut_blocks(torch.from_numpy(lut), qb, ql))


def test_k8_plan_fits_shared_memory_and_routes():
    """For every (m, ks) the wrappers accept and B from 1: k8_plan takes the
    largest query block (<= 32 and B rounded up to a power of two) whose
    tables, padded for the skew, and at least two code-ring stages fit in
    shared memory, is a kernel csrc/adc_topk.cu instantiates, and covers the
    C classes; where no plan fits, or 32 rows a warp would read codes a byte
    a load at a pitch of a multiple of 32, k8_route sends the shape to the
    second design, and refuses it where neither fits."""
    counts = {"ring": 0, "qlanes": 0, "refused": 0}
    for ks in (16, 200, 256):
        for m in range(1, adc.MAX_SMEM_BYTES // (4 * ks) + 1, 1 if ks > 16 else 37):
            for b in (1, 3, 8, 17, 64, 256):
                plan = adc.k8_plan(m, ks, b)
                try:
                    route = adc.k8_route(m, ks, b)
                except ValueError:
                    assert plan is None and 4 * m * adc.k8_ks_pad(ks) > adc.MAX_SMEM_BYTES
                    counts["refused"] += 1
                    continue
                counts[route] += 1
                if plan is None:
                    # one warp of 32 rows: the most class groups
                    assert route == "qlanes" and adc.k8_smem(1, 1, 1, m, ks, 8, 2) > adc.MAX_SMEM_BYTES
                    continue
                # rows of a multiple of 32 codes read a byte a load by 32 rows a warp
                conflicted = plan.qb <= 4 and m % 32 == 0 and not adc.k8_cnt(m, plan.skew)
                assert route == ("qlanes" if conflicted else "ring")
                qb, ql, skew, warps, groups, stages = plan
                cap = min(32, 1 << (b - 1).bit_length())
                assert qb & (qb - 1) == 0 and qb <= cap and ql == min(4, qb)
                assert skew in (1, adc.k8_skew(qb, m)) and 2 <= stages <= adc.K8_RING_STAGES
                assert adc.k8_smem(qb, ql, skew, m, ks, groups, stages) <= adc.MAX_SMEM_BYTES
                key = (qb, adc.k8_ks_pad(ks), ql, skew, adc.k8_cnt(m, skew))
                assert key in RING_TABLE, key
                pairs, w, g = adc.k8_geometry(qb, ql)
                assert (w, g) == (warps, groups) or (qb == 1 and warps < w and groups > g)
                assert warps * pairs * (32 * ql // qb) * groups == adc.C_BINS
                if qb < cap:  # twice the block fits at no skew and two stages nowhere
                    _, _, g2 = adc.k8_geometry(2 * qb, min(4, 2 * qb))
                    assert adc.k8_smem(2 * qb, min(4, 2 * qb), 1, m, ks, g2, 2) > adc.MAX_SMEM_BYTES
    assert counts["ring"] and counts["qlanes"] and counts["refused"]


def test_k8_route_is_pinned():
    """The main shapes and the edges of k8_route, a pure function of
    (m, ks, B)."""
    assert adc.k8_plan(8, 256, 256) == adc.K8Plan(16, 4, 2, 16, 2, 4)  # bench_adc's PQ8x8
    assert adc.k8_plan(16, 256, 256) == adc.K8Plan(8, 4, 4, 16, 1, 4)  # PQ16
    assert adc.k8_plan(8, 256, 64) == adc.K8Plan(16, 4, 2, 16, 2, 4)  # B=64
    assert adc.k8_plan(8, 256, 8) == adc.K8Plan(8, 4, 1, 16, 1, 4)  # B=8: no skew at 8 codes
    assert adc.k8_plan(8, 256, 2) == adc.K8Plan(2, 2, 1, 8, 1, 4)  # B=2: two a lane
    assert adc.k8_plan(8, 256, 1) == adc.K8Plan(1, 1, 1, 8, 1, 4)  # B=1: one query a CTA
    assert adc.k8_plan(16, 16, 256) == adc.K8Plan(32, 4, 1, 16, 4, 4)  # pq16x4: a row a wavefront
    assert [adc.k8_route(m, 256, 4) for m in (8, 100, 213, 214, 227)] == ["ring"] * 3 + [
        "qlanes"] * 2
    assert adc.k8_plan(213, 256, 1) == adc.K8Plan(1, 1, 1, 1, 8, 2)  # one warp, 32 rows a stage
    with pytest.raises(ValueError):
        adc.k8_route(228, 256, 4)
    assert adc.k8_route(3000, 16, 1) == "qlanes" and adc.k8_route(1000, 16, 1) == "ring"
    # rows of 32 and 64 codes take loops compiled for them; 96 and 128 read at
    # run time by 32 rows a warp go to the second design, by fewer they stay
    assert adc.k8_route(32, 256, 256) == adc.k8_route(64, 256, 256) == "ring"
    assert adc.k8_route(96, 256, 64) == adc.k8_route(256, 16, 64) == "qlanes"
    assert adc.k8_route(128, 16, 64) == "ring" and adc.k8_route(100, 256, 64) == "ring"


@pytest.mark.parametrize("nq, n, resident", [
    (256, 1_000_000, 132), (64, 1_000_000, 132), (8, 1_000_000, 132), (1, 300, 132),
    (17, 20_077, 132), (256, 1_000_000, 264), (700, 5, 132), (256, 1_000_000, 140)])
def test_k8_ctas_cover_every_unit_once(nq, n, resident):
    """K8's persistent CTAs cut the (query block, class group, tile) units
    into contiguous ranges that cover each unit once, every range within
    one unit of the others; a stream is cut by at most k8_part_slots CTAs.
    The CTAs are the resident ones, or whole CTAs a stream where that keeps
    K8_WAVE_FILL of them (then no CTA crosses a stream)."""
    plan = adc.k8_plan(8, 256, nq)
    ctas = adc.k8_ctas(plan, nq, n, resident)
    ntiles = -(-n // adc.C_BINS)
    streams = -(-nq // plan.qb) * plan.groups
    units = streams * ntiles
    most = min(resident, units)
    assert ctas == most or (ctas % streams == 0 and adc.K8_WAVE_FILL * most <= ctas < most)
    bounds = [k * units // ctas for k in range(ctas + 1)]
    sizes = np.diff(bounds)
    assert bounds[-1] == units and sizes.min() >= 1 and sizes.max() - sizes.min() <= 1
    cuts = [sum(bounds[k] < (st + 1) * ntiles and bounds[k + 1] > st * ntiles for k in range(ctas))
            for st in range(streams)]
    assert max(cuts) <= adc.k8_part_slots(plan, nq, n, ctas)
    if ctas % streams == 0:
        assert max(cuts) == ctas // streams


def test_k8_second_design_needs_cuda_tensors():
    codes, lut = _case(300, 8, 16, 2, seed=13)
    adc.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        adc.adc_topk_fused_v2(torch.from_numpy(codes), torch.from_numpy(lut), 10)
    with pytest.raises(ValueError):
        adc.adc_topk_fused_v2(torch.from_numpy(codes), torch.from_numpy(lut).double(), 10)
    assert not any(adc.LAUNCHES.values())


def test_k8_source_names_what_it_replaces():
    text = (CSRC / "adc_topk.cu").read_text()
    assert "adc.py:adc_topk_fused" in text and "_adc_candidates_kernel" in text
    for header in ("class_top3.cuh", "adc_sum.cuh", "bulk_copy.cuh"):
        assert f'#include "{header}"' in text


def test_scan_query_block_fits_every_accepted_shape():
    """K6/K7 stage the largest power-of-two block of queries (at most 32)
    whose LUTs (tables padded to 16 or 256 entries) and two output tiles a
    warp group fit in shared memory, for every (m, ks) the wrappers accept;
    where not even one query's fit, the sizing raises instead of
    overflowing."""
    refused = []
    for ks in (16, 200, 256):
        for m in range(1, adc.MAX_SMEM_BYTES // (4 * ks) + 1):  # _check_inputs' limit
            try:
                qb = adc.scan_query_block(m, ks)
            except ValueError:
                assert adc.scan_smem(1, m, ks, adc.scan_tile_rows(1)) > adc.MAX_SMEM_BYTES
                refused.append((m, ks))
                continue
            rows = adc.scan_tile_rows(qb)
            assert qb & (qb - 1) == 0 and 1 <= qb <= adc.K8_MAX_QUERY_BLOCK
            assert adc.scan_smem(qb, m, ks, rows) <= adc.MAX_SMEM_BYTES
            assert qb == adc.K8_MAX_QUERY_BLOCK or (
                adc.scan_smem(2 * qb, m, ks, adc.scan_tile_rows(2 * qb)) > adc.MAX_SMEM_BYTES)
            ql = adc.scan_lane_queries(qb)
            assert ql == min(2, qb)
            assert rows % 32 == 0 and rows % adc.scan_pass_rows(qb, adc.SCAN_GROUPS, ql) == 0
    assert refused and all(m * 256 * 4 > 200_000 for m, ks in refused)  # only the widest tables
    # the main paths: PQ8x8 16 queries a CTA, pq16x4 32 (conflict-free lookups)
    assert adc.scan_query_block(8, 256) == 16 and adc.scan_query_block(16, 16) == 32
    assert adc.scan_query_block(16, 256) == 8 and adc.scan_query_block(32, 256) == 4


@pytest.mark.parametrize("nq, steps, resident", [
    (64, 1954, 132), (64, 1954, 264), (1, 1954, 132), (17, 1954, 132), (700, 1954, 132),
    (13, 2, 132), (13, 1, 132)])
def test_scan_grid_covers_every_step_once(nq, steps, resident):
    qb = 16
    splits, per = adc.scan_grid(nq, qb, steps, resident)
    got = [t for s in range(splits) for t in range(s * per, min((s + 1) * per, steps))]
    assert got == list(range(steps))  # each CTA step once, no split empty
    ctas = -(-nq // qb) * splits
    fill = ctas / (-(-ctas // resident) * resident)
    assert fill >= adc.K8_WAVE_FILL or splits == steps


def _replay_scan(codes, lut, packed, ql, groups, rows):
    """A numpy replay of csrc/adc.cu's adc_qlane_scan_kernel: per CTA
    (query block, split) and step, each warp group's lanes score queries q
    + h * qb/ql (h < ql) of their rows, reading the LUT columns q * ql + h
    that lut_blocks lays side by side, and write a float4 of sums per query
    into the group's tile at query * stride + pass * pass_rows + trow; the
    tile goes to out[q0 + query, base + r] for r < the tile's live rows.
    Returns (out, writes per (query, row))."""
    b, m, ks = lut.shape
    n = codes.shape[0]
    qb = adc.scan_query_block(m, ks)
    lpr = qb // ql  # lanes that share a row
    kpad, krows = adc.k8_ks_pad(ks), 32 // lpr
    wpg = adc.SCAN_WARPS // groups
    pass_rows, stride = adc.scan_pass_rows(qb, groups, ql), adc.scan_tile_stride(lpr, rows)
    span = groups * rows
    steps = -(-n // span)
    splits, per = adc.scan_grid(b, qb, steps, resident=sf.SMS)
    blocks = adc.lut_blocks(torch.from_numpy(lut), qb, ql).numpy().reshape(-1, m * kpad * qb)
    gw, lane, p = (a.ravel() for a in np.meshgrid(range(wpg), range(32), range(adc.K8_PAIRS),
                                                  indexing="ij"))
    q, trow = lane % lpr, (gw * krows + lane // lpr) * adc.K8_PAIRS
    out = np.full((b, n), np.nan, dtype=np.float32)
    hits = np.zeros((b, n), dtype=np.int64)
    for blk in range(blocks.shape[0]):
        q0, nqb = blk * qb, min(qb, b - blk * qb)
        for split in range(splits):
            for step in range(split * per, min((split + 1) * per, steps)):
                for g in range(groups):
                    base = step * span + g * rows
                    tile = np.full(qb * stride, np.nan, dtype=np.float32)
                    for ps in range(rows // pass_rows):
                        row = base + ps * pass_rows + trow + p
                        live = row < n
                        code = np.zeros((len(row), m), dtype=np.int64)
                        if packed:
                            byte = codes[row[live]].astype(np.int64)
                            code[live] = np.stack([byte[:, j // 2] >> 4 * (j % 2) & 15
                                                   for j in range(m)], axis=1)
                        else:
                            code[live] = codes[row[live]]
                        for h in range(ql):
                            acc = np.zeros(len(row), dtype=np.float32)
                            for j in range(m):
                                col = q * ql + h
                                acc = acc + blocks[blk][(j * kpad * qb + code[:, j] * qb + col)]
                            query = q + h * lpr
                            slot = query * stride + ps * pass_rows + trow + p
                            assert len(set(slot.tolist())) == len(slot)  # one lane a slot
                            assert np.isnan(tile[slot]).all()  # and one query a slot
                            tile[slot] = acc
                            # a quarter-warp's float4 stores hit 8 distinct 16-byte bank groups
                            f4 = (query * stride + ps * pass_rows + trow)[p == 0]
                            assert all(len({(a // 4) % 8 for a in grp}) == 8
                                       for grp in f4.reshape(-1, 8))
                    live_rows = min(rows, n - base)
                    for qq in range(nqb):
                        seg = tile[qq * stride : qq * stride + max(live_rows, 0)]
                        assert not np.isnan(seg).any()
                        out[q0 + qq, base : base + live_rows] = seg
                        hits[q0 + qq, base : base + live_rows] += 1
    return out, hits


@pytest.mark.parametrize("m, ks, b, packed, n, ql, groups", [
    (8, 256, 17, False, 1234, 2, 2),  # a misaligned n (plain stores) and a ragged query block
    (8, 256, 16, False, 1100, 1, 1),  # n % 4 == 0 (bulk copies), one query a lane, one group
    (16, 16, 5, True, 1100, 2, 2),  # packed u4 at 32 queries a CTA
    (16, 16, 5, True, 700, 1, 16),  # one query a lane, one warp a group
    (7, 200, 3, False, 777, 2, 4),  # m odd, tables padded to 256
    (32, 256, 9, False, 600, 2, 2)])  # 4 queries a CTA, rows of 32 codes
def test_scan_lane_layout_replays_the_plain_sums(m, ks, b, packed, n, ql, groups):
    """The replay covers every (query, row < n) exactly once and equals
    plain K6/K7 bit for bit: the sums run over j in order from 0 with f32
    adds whatever the lane, tile slot or store."""
    codes, lut = _case(n, m, ks, b, seed=m + b)
    stored = np.array(jdtypes.pack_u4(jnp.asarray(codes))) if packed else codes
    rows = adc.scan_tile_rows(adc.scan_query_block(m, ks), groups, ql)
    got, hits = _replay_scan(stored, lut, packed, ql, groups, rows)
    assert (hits == 1).all()
    ref = adc.adc_scan_u4_ref if packed else adc.adc_scan_u8_ref
    want = ref(torch.from_numpy(stored), torch.from_numpy(lut)).numpy()
    np.testing.assert_array_equal(got, want)


def test_scan_first_designs_need_cuda_tensors():
    codes, lut = _case(300, 8, 16, 2, seed=11)
    adc.reset_launches()
    for fn, c in ((adc.adc_scan_u8_v1, codes), (adc.adc_scan_u4_v1, np.ascontiguousarray(codes[:, :4]))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(torch.from_numpy(c), torch.from_numpy(lut))
        with pytest.raises(ValueError):
            fn(torch.from_numpy(c), torch.from_numpy(lut).double())
    assert not any(adc.LAUNCHES.values())
