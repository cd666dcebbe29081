"""The port's k-means stack (vectorindex_tpu_torch.ops.kmeans, ops.rng)
against the JAX package's.

Where no randomness is involved the outputs are compared directly:
assign_clusters and _segment_mean (rtol=atol=1e-5: f32 sums in another
order), and Lloyd from an injected initialisation on data where no cluster
empties (centroids and inertia within rtol=1e-4, atol=1e-5; assignments
equal except at rows whose two nearest centroids lie within 1e-4 of each
other; the same number of iterations). The port cannot replay JAX's
threefry draws, so seeding and mini-batch training are checked by property:
k distinct data points, determinism per seed, coverage of known blobs, and
inertia within 5% of the JAX package's on the same clustered set.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorindex_tpu.ops import kmeans as jkm
from vectorindex_tpu.ops import rng as jrng
from vectorindex_tpu_torch.ops import kmeans as km
from vectorindex_tpu_torch.ops import rng as vrng

torch.set_num_threads(1)


def _blobs(n_per=100, k=8, d=16, spread=0.05, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32) * 3
    pts = (centers[:, None, :] + rng.standard_normal((k, n_per, d)).astype(np.float32) * spread)
    pts = pts.reshape(-1, d)
    return pts[rng.permutation(len(pts))], centers


def _gen(seed, stream=0):
    return vrng.make_generator(seed, stream)


def _max_center_gap(centers, got):
    return np.linalg.norm(centers[:, None, :] - np.asarray(got)[None, :, :], axis=-1).min(1).max()


def test_assign_clusters_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1000, 16)).astype(np.float32)
    cent = rng.standard_normal((13, 16)).astype(np.float32)
    ja, jd = (np.asarray(a) for a in jkm.assign_clusters(jnp.asarray(x), jnp.asarray(cent)))
    ta, td = km.assign_clusters(torch.from_numpy(x), torch.from_numpy(cent))
    np.testing.assert_array_equal(ta.numpy(), ja)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-5, atol=1e-5)
    ca, cd = km.assign_clusters_chunked(torch.from_numpy(x), torch.from_numpy(cent), chunk=256)
    assert torch.equal(ca, ta) and torch.allclose(cd, td, rtol=1e-5, atol=1e-5)
    assert ta.dtype == torch.int32


def test_segment_mean_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((500, 12)).astype(np.float32)
    assign = rng.integers(0, 9, 500).astype(np.int32)
    assign[assign == 4] = 5  # cluster 4 empty
    js, jc = (np.asarray(a) for a in jkm._segment_mean(jnp.asarray(x), jnp.asarray(assign), 9))
    ts, tc = km._segment_mean(torch.from_numpy(x), torch.from_numpy(assign), 9)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tc.numpy(), jc)


def test_lloyd_from_injected_init_matches_jax():
    x, _ = _blobs(k=8, spread=0.6, seed=9)
    init = x[np.random.default_rng(3).choice(len(x), 8, replace=False)]
    j = jkm.kmeans_lloyd(jrng.make_key(9), jnp.asarray(x), jnp.asarray(init), k=8, iters=15)
    t = km.kmeans_lloyd(_gen(9), torch.from_numpy(x), torch.from_numpy(init), k=8, iters=15)
    assert (np.bincount(np.asarray(j.assignments), minlength=8) > 0).all()  # nothing empties
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(t.inertia), float(j.inertia), rtol=1e-4)
    assert t.iterations == int(j.iterations)
    d2 = ((x[:, None, :] - np.asarray(j.centroids)[None]) ** 2).sum(-1)
    two = np.sort(d2, axis=1)[:, :2]
    near_tie = two[:, 1] - two[:, 0] <= 1e-4 * (1 + two[:, 0])
    same = t.assignments.numpy() == np.asarray(j.assignments)
    assert (same | near_tie).all()


def test_pp_seed_distinct_deterministic_and_covers_blobs():
    x, centers = _blobs(k=8, spread=0.01)
    xt = torch.from_numpy(x)
    a = km.kmeans_pp_seed(_gen(3), xt, 8)
    assert a.shape == (8, 16) and len(np.unique(a.numpy(), axis=0)) == 8
    assert torch.equal(a, km.kmeans_pp_seed(_gen(3), xt, 8))
    assert not torch.equal(a, km.kmeans_pp_seed(_gen(4), xt, 8))
    assert _max_center_gap(centers, a.numpy()) < 0.5
    # every seed is a data point
    assert all((np.abs(x - s).sum(1) == 0).any() for s in a.numpy())


@pytest.mark.parametrize("k, rounds", [(16, 5), (300, 3)], ids=["k16", "k300"])
def test_parallel_seed_covers_blobs(k, rounds):
    x, centers = _blobs(k=16 if k == 16 else 20, n_per=50 if k == 16 else 200, spread=0.01, seed=5)
    seeds = km.kmeans_parallel_seed(_gen(5), torch.from_numpy(x), k, rounds=rounds)
    assert seeds.shape == (k, x.shape[1])
    assert _max_center_gap(centers, seeds.numpy()) < 0.5


@pytest.mark.parametrize("algo", ["lloyd", "minibatch"])
def test_kmeans_inertia_within_5pct_of_jax(algo):
    x, centers = _blobs(k=8, n_per=200, spread=0.05, seed=11)
    cfg = dict(k=8, iters=60 if algo == "minibatch" else 20, batch_size=256, algo=algo, seed=11)
    j = jkm.kmeans(jnp.asarray(x), jkm.KMeansConfig(**cfg))
    t = km.kmeans(torch.from_numpy(x), km.KMeansConfig(**cfg))
    assert abs(float(t.inertia) - float(j.inertia)) <= 0.05 * float(j.inertia)
    assert _max_center_gap(centers, t.centroids.numpy()) < 0.3
    t2 = km.kmeans(torch.from_numpy(x), km.KMeansConfig(**cfg))
    assert torch.equal(t.centroids, t2.centroids)  # deterministic per seed on the CPU
    assert torch.equal(km.assign_clusters(torch.from_numpy(x), t.centroids)[0], t.assignments)


def test_empty_cluster_repair_and_streaming():
    x = np.random.default_rng(0).standard_normal((20, 4)).astype(np.float32)
    res = km.kmeans(torch.from_numpy(x), km.KMeansConfig(k=16, iters=5, seed=0))
    assert torch.isfinite(res.centroids).all()
    xs, centers = _blobs(k=4, n_per=500, spread=0.02, seed=13)
    state = km.kmeans_stream_init(km.kmeans_pp_seed(_gen(13), torch.from_numpy(xs), 4))
    for c in range(0, len(xs), 250):
        state = km.kmeans_stream_update(state, torch.from_numpy(xs[c : c + 250]))
    assert _max_center_gap(centers, km.kmeans_stream_finalize(state).numpy()) < 0.3


def test_rng_streams():
    a, b = _gen(42, 0), _gen(42, 0)
    assert torch.equal(vrng.gaussian(a, (5,)), vrng.gaussian(b, (5,)))
    assert not torch.equal(vrng.uniform(_gen(42, 0), (5,)), vrng.uniform(_gen(42, 1), (5,)))
    child = vrng.split_stream(_gen(42), 3)
    assert torch.equal(vrng.randperm(child, 9), vrng.randperm(vrng.split_stream(_gen(42), 3), 9))
    assert sorted(vrng.randperm(_gen(1), 50).tolist()) == list(range(50))
    s = vrng.sample_without_replacement(_gen(2), 100, 30)
    assert len(set(s.tolist())) == 30 and int(s.max()) < 100
    w = torch.tensor([0.0, 1.0, 0.0, 3.0])
    picks = vrng.weighted_pick(_gen(3), w, (400,))
    assert picks.shape == (400,) and set(picks.tolist()) <= {1, 3}
    assert (picks == 3).sum() > (picks == 1).sum()
    assert set(vrng.weighted_pick(_gen(4), torch.zeros(3), (60,)).tolist()) == {0, 1, 2}
    assert vrng.weighted_pick(_gen(5), w).shape == ()
    big = vrng.make_generator(0xDEADBEEFCAFEBABE, 7)  # 64-bit seeds are accepted
    assert vrng.gaussian(big, (2, 3), dtype=torch.float64).dtype == torch.float64
