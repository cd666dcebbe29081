"""The traffic generator: what a mix's data file asks of a run, from the seed.

A mix (`traffic/<name>.json`) is parameters alone:

  loop         "closed": one client, the next call issued when the last
               returns; "open": queries arrive at `rate` a second (gaps
               drawn from the seed, exponential or even), and each call
               takes up to `batch` of those that have arrived
  clients      1 (one process, one thread of calls)
  batch        queries a call (closed), or the most a call takes (open)
  rate         queries a second, open loops only
  arrivals     "poisson" (the default) or "uniform", open loops only
  order        "cycle": the query pool in order; "shuffle": a permutation
               of the pool drawn from the seed; either is cycled
  k            results a query, or null for the configuration's k
  filter       null, or {"allow_share": s}: every call searches only the
               ids of one set drawn from the seed, each row in it with
               probability s
  check_share  the share of calls whose answers are checked

The same seed gives the same order, arrivals, filter and checked calls.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

#: calls the seeded check sample is drawn for
MAX_CALLS = 1 << 20

_LOOPS = ("closed", "open")
_ORDERS = ("cycle", "shuffle")
_ARRIVALS = ("poisson", "uniform")


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def validate(mix: dict) -> None:
    """SystemExit with the reason where a mix asks for what this generator
    does not make."""
    def bad(why):
        raise SystemExit(f"portbench: traffic {mix.get('name')!r}: {why}")

    if mix.get("loop") not in _LOOPS:
        bad(f"loop must be one of {_LOOPS}")
    if int(mix.get("clients", 1)) != 1:
        bad("one client is generated")
    if int(mix["batch"]) < 1:
        bad("batch must be at least 1")
    if mix.get("order", "cycle") not in _ORDERS:
        bad(f"order must be one of {_ORDERS}")
    if mix["loop"] == "open":
        if not float(mix.get("rate", 0)) > 0:
            bad("an open loop needs a rate above 0")
        if mix.get("arrivals", "poisson") not in _ARRIVALS:
            bad(f"arrivals must be one of {_ARRIVALS}")
    f = mix.get("filter")
    if f is not None and not 0.0 < float(f["allow_share"]) <= 1.0:
        bad("filter.allow_share must lie in (0, 1]")
    if not 0.0 < float(mix["check_share"]) <= 1.0:
        bad("check_share must lie in (0, 1]")


@dataclass
class Traffic:
    """A mix made concrete for one seed."""

    loop: str
    batch: int
    k: int
    #: queries in the order they are sent, padded with the first `batch`
    #: so that every call is one contiguous slice
    pool: np.ndarray
    #: the pool index of each row of `pool`
    order: np.ndarray
    n_pool: int
    #: which calls are checked, by call number
    keep: np.ndarray
    rate: float = 0.0
    arrivals: str = "poisson"
    #: external ids a call may return (sorted), or None
    allow: Optional[np.ndarray] = None
    seed: int = 0

    def slice(self, start: int, n: int) -> np.ndarray:
        """The queries of a call taking n queries from position start."""
        s = start % self.n_pool
        return self.pool[s : s + n]

    def query_index(self, start: int, n: int) -> np.ndarray:
        """The pool indices of those queries."""
        return self.order[(start + np.arange(n)) % self.n_pool]

    def arrival_times(self, seconds: float) -> np.ndarray:
        """Open loop: the arrival times in [0, seconds), drawn from the seed."""
        n = int(self.rate * seconds * 1.5) + 64
        if self.arrivals == "uniform":
            t = np.arange(n) / self.rate
        else:
            t = np.cumsum(_rng(self.seed, 23).exponential(1.0 / self.rate, n))
        return t[t < seconds]


def make(mix: dict, cfg: dict, queries: np.ndarray, seed: int) -> Traffic:
    """The mix for `seed` over the configuration's query pool."""
    validate(mix)
    n_pool = queries.shape[0]
    order = np.arange(n_pool)
    if mix.get("order", "cycle") == "shuffle":
        order = _rng(seed, 17).permutation(n_pool)
    batch = int(mix["batch"])
    ordered = queries[order]
    reps = -(-batch // n_pool)
    pool = np.ascontiguousarray(np.concatenate([ordered] * (reps + 1))[: n_pool + batch])
    allow = None
    if mix.get("filter") is not None:
        share = float(mix["filter"]["allow_share"])
        allow = np.flatnonzero(_rng(seed, 19).random(int(cfg["rows"])) < share)
        if allow.size == 0:
            allow = np.zeros(1, dtype=np.int64)
    keep = _rng(seed, 11).random(MAX_CALLS) < float(mix["check_share"])
    return Traffic(
        loop=mix["loop"], batch=batch, k=int(mix.get("k") or cfg["k"]), pool=pool, order=order,
        n_pool=n_pool, keep=keep, rate=float(mix.get("rate", 0.0)),
        arrivals=mix.get("arrivals", "poisson"), allow=allow, seed=seed,
    )


def warm_sizes(traffic: Traffic) -> list:
    """The call sizes the window will use: the batch, and in an open loop
    every power of two below it and 1."""
    if traffic.loop == "closed":
        return [traffic.batch]
    sizes, n = {traffic.batch}, 1
    while n < traffic.batch:
        sizes.add(n)
        n *= 2
    return sorted(sizes)
