"""The port's full-corpus ADC kernels (vectorindex_tpu_torch.kernels.adc: K6
adc_scan_u8, K7 adc_scan_u4, K8 adc_topk_fused) against the JAX package's
Pallas kernels (vectorindex_tpu.kernels.adc) on the same seeded numpy codes
and LUTs.

On the CPU the port's wrappers run the plain PyTorch versions; the JAX side
runs its kernels in interpret mode at the shapes of
tests/test_pallas_kernels.py, so the compiles stay few.

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

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorindex_tpu.kernels import adc as jadc
from vectorindex_tpu.ops import dtypes as jdtypes
from vectorindex_tpu_torch.kernels import adc
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
    assert adc.LAUNCHES == {"adc_scan_u8": 0, "adc_scan_u4": 0, "adc_topk_fused": 0}


def test_source_names_what_it_replaces():
    text = (CSRC / "adc.cu").read_text()
    for name in ("adc_scan_pallas", "adc_scan_u4_pallas", "adc_topk_fused"):
        assert f"adc.py:{name}" in text
    assert jadc.C_BINS == adc.C_BINS
    # K1/K2 and K8 share the class selection; K6-K10 share the ADC sum
    for src, header in (("scan_fused.cu", "class_top3.cuh"), ("adc.cu", "class_top3.cuh"),
                        ("adc.cu", "adc_sum.cuh"), ("adc_probe.cu", "adc_sum.cuh")):
        assert f'#include "{header}"' in (CSRC / src).read_text()
