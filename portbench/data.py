"""Seeded rows and queries, drawn on the device and copied to the host once.

The clustered generator is the arithmetic of the port's numpy
`clustered_corpus` (a centre per cluster, each row a centre plus gaussian
noise, optionally scaled to unit norm), written in torch so that the rows
are drawn on the card in a few large calls. A configuration's `data` block
sets its parameters; `integer` rounds the components and `clip` bounds
them (BIGANN's components are uint8).

The same seed on the same kind of device gives the same bytes: each stream
has its own `torch.Generator`, and rows are drawn in chunks of a fixed size.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

#: rows drawn per call; fixed, so that a seed names one corpus
CHUNK_ROWS = 1 << 20

_STREAMS = {"centres": 1, "rows": 2, "queries": 3}


def generator(seed: int, stream: str, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 8 + _STREAMS[stream]) % (1 << 63))
    return g


def _shape(x: torch.Tensor, spec: dict) -> torch.Tensor:
    """Offset, rounding, clipping and norm of a block of raw draws."""
    x = x + float(spec["offset"])
    if spec["integer"]:
        x = torch.round(x)
    if spec["clip"] is not None:
        x = torch.clamp(x, float(spec["clip"][0]), float(spec["clip"][1]))
    if spec["normalize"]:
        x = x / torch.clamp_min(torch.linalg.vector_norm(x, dim=1, keepdim=True), 1e-30)
    return x


def _draw(n: int, centres: torch.Tensor, spec: dict, g: torch.Generator) -> np.ndarray:
    """[n, d] f32 rows on the host, drawn on centres.device chunk by chunk."""
    dev = centres.device
    out = np.empty((n, centres.shape[1]), dtype=np.float32)
    for s in range(0, n, CHUNK_ROWS):
        m = min(CHUNK_ROWS, n - s)
        assign = torch.randint(centres.shape[0], (m,), generator=g, device=dev)
        x = torch.randn((m, centres.shape[1]), generator=g, device=dev)
        x.mul_(float(spec["noise_std"])).add_(centres[assign])
        out[s : s + m] = _shape(x, spec).cpu().numpy()
    return out


def make(cfg: dict, seed: int, device: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """(rows [rows, d], queries [queries, d]) f32 numpy arrays for `cfg`."""
    spec = cfg["data"]
    if spec["generator"] != "clustered":
        raise ValueError(f"unknown generator {spec['generator']!r}")
    d = int(cfg["dimension"])
    centres = torch.randn(
        (int(spec["clusters"]), d), generator=generator(seed, "centres", device), device=device
    ).mul_(float(spec["center_std"]))
    rows = _draw(int(cfg["rows"]), centres, spec, generator(seed, "rows", device))
    queries = _draw(int(cfg["queries"]), centres, spec, generator(seed, "queries", device))
    return rows, queries
