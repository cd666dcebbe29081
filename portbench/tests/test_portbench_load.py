"""The traffic generator: a mix's data file made concrete from the seed."""

import numpy as np
import pytest

from portbench import load

CFG = {"rows": 1000, "k": 10}
QUERIES = np.arange(50 * 3, dtype=np.float32).reshape(50, 3)


def _mix(**kw):
    base = {"name": "m", "loop": "closed", "clients": 1, "batch": 8, "k": None, "order": "cycle",
            "filter": None, "check_share": 0.5}
    base.update(kw)
    return base


def test_same_seed_same_traffic_other_seed_other():
    mix = _mix(order="shuffle", filter={"allow_share": 0.3}, loop="open", rate=1000.0)
    a, b = load.make(mix, CFG, QUERIES, 2**31 + 9), load.make(mix, CFG, QUERIES, 2**31 + 9)
    c = load.make(mix, CFG, QUERIES, 2**31 + 10)
    for x, y in ((a.order, b.order), (a.allow, b.allow), (a.keep, b.keep), (a.pool, b.pool),
                 (a.arrival_times(2.0), b.arrival_times(2.0))):
        assert np.array_equal(x, y)
    assert not np.array_equal(a.order, c.order) and not np.array_equal(a.allow, c.allow)
    assert not np.array_equal(a.arrival_times(2.0), c.arrival_times(2.0))


@pytest.mark.parametrize("order", ["cycle", "shuffle"])
@pytest.mark.parametrize("batch", [1, 8, 64])
def test_every_call_is_a_slice_of_the_order(order, batch):
    """A call of n queries from any position holds the queries the order
    names there, across the pool's end and for batches larger than the
    pool; a shuffle is a permutation of the pool."""
    t = load.make(_mix(order=order, batch=batch), CFG, QUERIES, 3)
    assert sorted(t.order.tolist()) == list(range(50))
    assert (t.order.tolist() == list(range(50))) == (order == "cycle")
    for start in (0, 7, 45, 49, 50 * 3 + 2):
        for n in {1, batch}:
            assert np.array_equal(t.slice(start, n), QUERIES[t.query_index(start, n)])


def test_filter_draws_a_share_of_the_rows():
    t = load.make(_mix(filter={"allow_share": 0.25}), {"rows": 100_000, "k": 10}, QUERIES, 5)
    assert np.all(np.diff(t.allow) > 0) and t.allow.max() < 100_000
    assert abs(t.allow.size / 100_000 - 0.25) < 0.01
    assert load.make(_mix(), CFG, QUERIES, 5).allow is None


@pytest.mark.parametrize("arrivals", ["poisson", "uniform"])
def test_open_loop_arrivals_keep_the_rate(arrivals):
    t = load.make(_mix(loop="open", rate=2000.0, arrivals=arrivals), CFG, QUERIES, 7)
    arr = t.arrival_times(5.0)
    assert np.all(np.diff(arr) >= 0) and arr.min() >= 0 and arr.max() < 5.0
    assert abs(arr.size / 10_000 - 1) < 0.05
    if arrivals == "uniform":
        np.testing.assert_allclose(np.diff(arr), 1 / 2000.0)


def test_check_sample_share_and_k():
    t = load.make(_mix(check_share=0.125, k=4), CFG, QUERIES, 11)
    assert abs(t.keep.mean() - 0.125) < 0.005 and t.k == 4
    assert load.make(_mix(), CFG, QUERIES, 11).k == 10


def test_warm_sizes():
    assert load.warm_sizes(load.make(_mix(batch=256), CFG, QUERIES, 1)) == [256]
    t = load.make(_mix(loop="open", rate=10.0, batch=20), CFG, QUERIES, 1)
    assert load.warm_sizes(t) == [1, 2, 4, 8, 16, 20]


@pytest.mark.parametrize("bad", [
    {"loop": "burst"}, {"clients": 2}, {"batch": 0}, {"order": "random"},
    {"loop": "open"}, {"loop": "open", "rate": 5.0, "arrivals": "bursty"},
    {"filter": {"allow_share": 0.0}}, {"check_share": 0.0},
])
def test_mixes_the_generator_does_not_make_are_refused(bad):
    with pytest.raises(SystemExit, match="traffic 'm'"):
        load.make(_mix(**bad), CFG, QUERIES, 1)
