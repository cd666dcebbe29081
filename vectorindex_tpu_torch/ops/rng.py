"""Deterministic RNG streams on torch.Generator.

Counterpart of vectorindex_tpu.ops.rng (parity targets: reference S2
RNG & dtype, S2_RNGDtype.swift:32-344). Streams are keyed by (seed, stream)
like the reference's (seed, streamID) pairs, and `split_stream` derives an
independent child generator (reference rngSplit, S2_RNGDtype.swift:242).

The contract is determinism per (seed, stream, device), not the JAX
package's bits: JAX draws from threefry keys, which torch cannot replay, and
a CPU generator and a CUDA generator give different numbers from the same
seed. Tests that compare the two packages make their random inputs with
numpy and hand them to both; tests of the draws themselves check properties
(distinctness, determinism, coverage).
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor

_MASK64 = (1 << 64) - 1


def _mix(z: int) -> int:
    """splitmix64 finaliser: spreads (seed, stream) over all 64 bits."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def make_generator(seed: int, stream: int = 0, device="cpu") -> torch.Generator:
    """Generator for (seed, streamID) on `device` (reference semantics where
    every kernel takes rngSeed + streamID, KMeansSeeding.swift:40). 64-bit
    seeds are accepted as they are."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_mix(_mix(int(seed) & _MASK64) ^ (int(stream) & _MASK64)) >> 1)
    return gen


def split_stream(gen: torch.Generator, task_id: int) -> torch.Generator:
    """Independent child stream of `gen` for task `task_id`, on gen's
    device. Depends only on gen's seed, not on what was drawn from it."""
    child = torch.Generator(device=gen.device)
    child.manual_seed(_mix(gen.initial_seed() ^ _mix(int(task_id) & _MASK64)) >> 1)
    return child


def randperm(gen: torch.Generator, n: int) -> Tensor:
    """Uniform random permutation of [0, n) (reference randpermInPlace,
    S2_RNGDtype.swift:256)."""
    return torch.randperm(n, generator=gen, device=gen.device)


def sample_without_replacement(gen: torch.Generator, n: int, k: int) -> Tensor:
    """k distinct uniform draws from [0, n) (reference
    sampleWithoutReplacement, S2_RNGDtype.swift:275)."""
    return randperm(gen, n)[:k]


def weighted_pick(
    gen: torch.Generator, weights: Tensor, shape: Tuple[int, ...] = ()
) -> Tensor:
    """Indices drawn with replacement, proportionally to non-negative
    weights (reference weightedPick, S2_RNGDtype.swift:309); zero-weight
    entries are never picked unless every weight is zero, when the draw is
    uniform. Returns int64 of `shape`, with no host synchronisation."""
    w = torch.clamp_min(weights.float(), 0.0)
    w = w + (w.sum() <= 0).float()  # all-zero weights: draw uniformly
    count = 1
    for s in shape:
        count *= s
    picks = torch.multinomial(w, max(count, 1), replacement=True, generator=gen)
    return picks[:count].reshape(shape)


def gaussian(gen: torch.Generator, shape: Tuple[int, ...], dtype=torch.float32) -> Tensor:
    """Standard normal draws (reference gaussianBoxMuller,
    S2_RNGDtype.swift:344)."""
    return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)


def uniform(gen: torch.Generator, shape: Tuple[int, ...], dtype=torch.float32) -> Tensor:
    return torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)
