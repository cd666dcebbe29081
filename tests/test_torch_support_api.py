"""The port's support API against the JAX package's: ops/mips, ops/layout,
models/typed and utils/debug. Mirrors tests/test_support_ops.py,
tests/test_accel_layout.py (layout), tests/test_typed_overloads.py and
tests/test_telemetry.py's debug test. Everything runs on the CPU; that
models/typed refuses a CUDA tensor is a `cuda`-marked case of
tests/test_torch_cuda.py, which runs on the card without JAX.

Tolerances: the MIPS transforms take the same f32 inputs in both packages:
the copied columns are equal; the augmentation column √(R²−‖x‖²) is within
√(2·d·2⁻²⁴·R²) (‖x‖² summed in another order, through a sqrt that is
steepest where ‖x‖² = R²); scores within rtol=2e-4, atol=2e-5
(utils/parity: f32 sums in another order). Layout and typed outputs must
be equal.
"""

import array

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorindex_tpu.ops import layout as jlayout
from vectorindex_tpu.ops import mips as jmips
from vectorindex_tpu_torch.models.flat import FlatIndex
from vectorindex_tpu_torch.models.hnsw import HNSWConfig, HNSWIndex
from vectorindex_tpu_torch.models.ivf import IVFConfig, IVFIndex
from vectorindex_tpu_torch.models.typed import VectorLike, as_matrix, as_vector
from vectorindex_tpu_torch.ops import layout, mips
from vectorindex_tpu_torch.utils import debug
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.errors import IndexError, IndexErrorKind
from vectorindex_tpu_torch.utils.parity import ATOL, RTOL

torch.set_num_threads(1)


def _data(n=200, d=16, b=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


# -- MIPS transform --


def test_mips_padded_dim_and_r2_match_the_reference():
    for d in (1, 16, 24, 127, 128, 129, 256):
        assert mips.padded_dim(d) == jmips.padded_dim(d)
    assert mips.padded_dim(5, multiple=16) == jmips.padded_dim(5, multiple=16) == 16
    p, jp = mips.R2Parameter(r2=1.0), jmips.R2Parameter(r2=1.0)
    for v in (0.5, 2.0):
        p.update(v)
        jp.update(v)
        assert (p.r2, p.stale) == (jp.r2, jp.stale)
    p.materialized()
    assert not p.stale


def test_mips_augmentation_matches_jax_and_orders_by_inner_product():
    q, x = _data(n=150, d=24, b=6, seed=4)
    r2 = float((x**2).sum(1).max())
    dim = mips.padded_dim(24)
    xa = mips.mips_materialize_augmentation(torch.from_numpy(x), r2, dim).numpy()
    qa = mips.mips_augment_query(torch.from_numpy(q), dim).numpy()
    jxa = np.asarray(jmips.mips_materialize_augmentation(jnp.asarray(x), r2, dim))
    np.testing.assert_array_equal(qa, np.asarray(jmips.mips_augment_query(jnp.asarray(q), dim)))
    np.testing.assert_array_equal(xa[:, :24], jxa[:, :24])
    np.testing.assert_allclose(xa[:, 24:], jxa[:, 24:], rtol=0, atol=np.sqrt(2 * 24 * 2**-24 * r2))
    np.testing.assert_allclose((xa**2).sum(1), r2, rtol=1e-4)  # augmented norms are all R
    l2 = ((qa[:, None] - xa[None]) ** 2).sum(-1)
    ip = q @ x.T
    for b in range(6):
        np.testing.assert_array_equal(np.argsort(l2[b])[:10], np.argsort(-ip[b])[:10])


def test_mips_hybrid_and_virtual_match_jax_and_explicit():
    q, x = _data(n=100, d=16, b=3, seed=5)
    r2 = float((x**2).sum(1).max())
    dim = mips.padded_dim(16)
    xa = mips.mips_materialize_augmentation(torch.from_numpy(x), r2, dim).numpy()
    qa = mips.mips_augment_query(torch.from_numpy(q), dim).numpy()
    explicit = ((qa[:, None] - xa[None]) ** 2).sum(-1)
    hybrid = mips.mips_hybrid_score_block(torch.from_numpy(q), torch.from_numpy(x), r2).numpy()
    np.testing.assert_allclose(hybrid, explicit, rtol=1e-3, atol=1e-3)
    want = np.asarray(jmips.mips_hybrid_score_block(jnp.asarray(q), jnp.asarray(x), r2))
    np.testing.assert_allclose(hybrid, want, rtol=RTOL, atol=ATOL)
    ip = torch.from_numpy(q @ x.T)
    qsq = torch.from_numpy((q * q).sum(1))
    virtual = mips.mips_virtual_to_l2_scores(ip, qsq, r2).numpy()
    np.testing.assert_allclose(virtual, np.asarray(jmips.mips_virtual_to_l2_scores(
        jnp.asarray(ip.numpy()), jnp.asarray(qsq.numpy()), r2)), rtol=RTOL, atol=ATOL)


def test_mips_bf16_augmentation_keeps_the_dtype():
    _, x = _data(n=64, d=16, seed=6)
    xb = torch.from_numpy(x).bfloat16()
    xa = mips.mips_materialize_augmentation(xb, 40.0, mips.padded_dim(16))
    assert xa.dtype == torch.bfloat16 and xa.shape == (64, 128)
    assert torch.equal(xa[:, :16], xb) and (xa[:, 17:] == 0).all()


# -- layout --


def test_padded_dimension_and_pad_rows_match_the_reference():
    for d, m in ((1, 128), (128, 128), (129, 128), (5, 16)):
        assert layout.padded_dimension(d, m) == jlayout.padded_dimension(d, m)
    assert layout.LANE == jlayout.LANE == 128 and layout.SUBLANE == jlayout.SUBLANE
    x = np.arange(15, dtype=np.float32).reshape(5, 3)
    for mult in (4, 5):
        (p, n), (jp, jn) = layout.pad_rows_to(x, mult), jlayout.pad_rows_to(x, mult)
        np.testing.assert_array_equal(p, jp)
        assert n == jn == 5


def test_interleave_layouts_match_the_reference_and_round_trip():
    x = np.arange(64, dtype=np.float32).reshape(16, 4)
    b = layout.vecs_interleave(x, r=8)
    np.testing.assert_array_equal(b, jlayout.vecs_interleave(x, r=8))
    np.testing.assert_array_equal(b[0, 1], x[:8, 1])  # AoSoA: block 0, dim 1 = rows 0..7
    np.testing.assert_array_equal(layout.vecs_deinterleave(b), x)
    codes = np.arange(48, dtype=np.uint8).reshape(16, 3)
    c = layout.pq_codes_interleave(codes, g=4)
    np.testing.assert_array_equal(c, jlayout.pq_codes_interleave(codes, g=4))
    np.testing.assert_array_equal(layout.pq_codes_deinterleave(c), codes)


# -- typed inputs --

D = 8


def _variants(v: np.ndarray):
    yield "numpy_f32", v
    yield "numpy_f64", v.astype(np.float64)
    yield "jax", jnp.asarray(v)
    yield "list", v.tolist()
    yield "tuple", tuple(v.tolist())
    yield "array_array", array.array("f", v.tolist())
    yield "memoryview", memoryview(v)
    yield "torch", torch.from_numpy(v)


def test_as_vector_all_variants_equal():
    from vectorindex_tpu.models.typed import as_vector as jas_vector

    v = np.arange(D, dtype=np.float32) / 3.0
    for name, var in _variants(v):
        got = as_vector(var, D)
        assert got.dtype == np.float32 and got.flags.c_contiguous, name
        np.testing.assert_array_equal(got, jas_vector(var, D), err_msg=name)
    assert isinstance(np.ones(3), VectorLike) and isinstance(torch.ones(3), VectorLike)


def test_as_matrix_mixed_rows_and_errors():
    rows = [np.ones(D, np.float32), [2.0] * D, tuple([3.0] * D)]
    m = as_matrix(rows, D)
    assert m.shape == (3, D) and (m[1] == 2.0).all()
    assert as_matrix(np.ones(D), D).shape == (1, D)
    for bad, kind in (("not a vector", IndexErrorKind.INVALID_VECTOR),
                      (object(), IndexErrorKind.INVALID_VECTOR),
                      (np.ones(D + 1, np.float32), IndexErrorKind.DIMENSION_MISMATCH)):
        with pytest.raises(IndexError) as ei:
            as_vector(bad, D)
        assert ei.value.kind == kind
    with pytest.raises(IndexError) as ei:
        as_matrix(np.ones((2, 2, 2)))
    assert ei.value.kind == IndexErrorKind.INVALID_VECTOR


@pytest.mark.parametrize("mk", [
    lambda: FlatIndex(D, device="cpu"),
    lambda: HNSWIndex(D, Metric.L2, HNSWConfig(m=4, ef_construction=16, build_chunk=16),
                      device="cpu"),
    lambda: IVFIndex(D, Metric.L2, IVFConfig(nlist=2, nprobe=2), device="cpu"),
], ids=["flat", "hnsw", "ivf"])
def test_every_index_accepts_typed_inserts_and_queries(mk):
    idx = mk()
    base = np.eye(D, dtype=np.float32) * 4.0
    idx.insert("np", base[0])
    idx.insert("jax", jnp.asarray(base[1]))
    idx.insert("list", base[2].tolist())
    idx.insert("arr", array.array("f", base[3].tolist()))
    idx.insert("torch", torch.from_numpy(base[4]))
    assert idx.count == 5
    assert idx.search(base[0].tolist(), 1)[0].id == "np"
    assert idx.search(jnp.asarray(base[1]), 1)[0].id == "jax"
    assert idx.search(torch.from_numpy(base[4]), 1)[0].id == "torch"


# -- debug --


def test_debug_check_finite_and_invariants():
    debug.enable()
    try:
        with pytest.raises(IndexError):
            debug.check_finite("x", np.asarray([1.0, np.nan]))
        with pytest.raises(IndexError):
            debug.check_finite("t", torch.tensor([1.0, float("inf")]).bfloat16())
        debug.check_finite("ok", np.ones(3))
        debug.check_finite("ok", torch.ones(3))
        # a healthy index passes the invariant sweep
        rng = np.random.default_rng(0)
        x = rng.standard_normal((50, 8)).astype(np.float32)
        idx = FlatIndex(8, device="cpu")
        idx.insert_batch(list(range(50)), x)
        debug.check_index_invariants(idx)
        # corrupt the control plane -> caught
        idx._valid[idx._idmap.lookup(3)] = False
        with pytest.raises(IndexError) as ei:
            debug.check_index_invariants(idx)
        assert ei.value.kind == IndexErrorKind.INTERNAL_INVARIANT
    finally:
        debug.disable()
    assert not debug.is_enabled()
    debug.check_finite("off", np.asarray([np.nan]))  # disabled: no check


def test_debug_traps_non_finite_search_distances(monkeypatch):
    """enable() checks the distances at batch_search's output: NaN traps,
    +inf (an empty slot: k above the live rows) does not; disabled, nothing
    is checked."""
    import vectorindex_tpu_torch.models.flat as tflat

    rng = np.random.default_rng(1)
    x = rng.standard_normal((20, 8)).astype(np.float32)
    idx = FlatIndex(8, device="cpu")
    idx.insert_batch(list(range(20)), x)
    debug.enable()
    try:
        assert len(idx.search(x[0], 30)) == 20  # 10 empty slots of +inf pass
        real = tflat.scan_topk_strict

        def poisoned(*a, **kw):
            d, i = real(*a, **kw)
            return d.masked_fill(torch.arange(d.shape[1]) == 1, float("nan")), i

        monkeypatch.setattr(tflat, "scan_topk_strict", poisoned)
        with pytest.raises(IndexError) as ei:
            idx.search(x[0], 5)
        assert ei.value.kind == IndexErrorKind.INTERNAL_INVARIANT
    finally:
        debug.disable()
    idx.search(x[0], 5)  # disabled: no trap
