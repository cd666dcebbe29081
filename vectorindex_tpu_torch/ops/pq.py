"""Product quantization: training, encoding, LUT build, ADC scan, residuals.

Counterpart of vectorindex_tpu.ops.pq (parity targets: the reference's
PQTrain.swift:83,390 (#19), PQEncode.swift:66-452 + pq_encode.c (#20),
PQLUT.swift:183-419 (#21), ADCScan.swift:54-148 (#22),
ResidualKernel.swift:148 (#23)).

  - Training runs ops/kmeans.kmeans_lloyd once per subspace (the JAX package
    vmaps it over the m subspaces), each on its own child generator of the
    caller's; the draws are not the JAX package's (see ops/rng).
  - Encoding is a chunked batched argmin over the codebooks (dot trick, one
    batched product per chunk); argmin keeps the first index of a tie, as
    jnp.argmin does.
  - Every product here (encode, the LUTs, the row corrections) runs at full
    f32: on the card that needs torch.backends.cuda.matmul.allow_tf32 False,
    and the functions raise otherwise.
  - ADC over a whole code array (`adc_scan`, `adc_scan_u4`): 'auto' launches
    the full-corpus ADC kernels K6/K7 (kernels/adc) on a CUDA tensor, as the
    JAX package takes its Pallas kernels on a TPU, and takes 'gather' on a
    CPU tensor, the JAX package's CPU route. 'gather' and 'onehot' are the
    JAX package's two plain strategies.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vectorindex_tpu_torch.ops import kmeans as km
from vectorindex_tpu_torch.ops import rng as vrng
from vectorindex_tpu_torch.ops.dtypes import pack_u4, unpack_u4

Tensor = torch.Tensor


class PQCodebooks(NamedTuple):
    """codebooks [m, ks, dsub] + cached squared norms [m, ks]."""

    centroids: Tensor
    sqnorms: Tensor

    @property
    def m(self) -> int:
        return self.centroids.shape[0]

    @property
    def ks(self) -> int:
        return self.centroids.shape[1]

    @property
    def dsub(self) -> int:
        return self.centroids.shape[2]


def books_from_centroids(centroids: Tensor) -> PQCodebooks:
    cents = centroids.float()
    return PQCodebooks(cents, (cents * cents).sum(dim=-1))


def _split_subspaces(x: Tensor, m: int) -> Tensor:
    n, d = x.shape
    if d % m:
        raise ValueError(f"dimension {d} not divisible by m={m}")
    return x.reshape(n, m, d // m).transpose(0, 1)  # [m, n, dsub]


def _subspace_dots(a: Tensor, cents: Tensor) -> Tensor:
    """dots[..., j, k] = ⟨a[..., j, :], C_j[k]⟩ at full f32: a [..., m, dsub],
    cents [m, ks, dsub] → [..., m, ks] (the JAX package's
    einsum('...md,mkd->...mk'))."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "f32 PQ products need torch.backends.cuda.matmul.allow_tf32 = False"
        )
    lead = a.shape[:-2]
    m, dsub = a.shape[-2:]
    at = a.float().reshape(-1, m, dsub).transpose(0, 1)  # [m, N, dsub]
    dots = torch.bmm(at, cents.float().transpose(1, 2))  # [m, N, ks]
    return dots.transpose(0, 1).reshape(*lead, m, cents.shape[1])


# ---------------------------------------------------------------------------
# #19 — training
# ---------------------------------------------------------------------------


def pq_train(
    gen: torch.Generator,
    x: Tensor,
    *,
    m: int,
    ks: int = 256,
    iters: int = 25,
    seeding: str = "random",
) -> PQCodebooks:
    """Train per-subspace codebooks (reference pq_train_f32, PQTrain.swift:83;
    maxIters default 25). Subspace j trains on the child stream
    split_stream(gen, j), which must live on x's device.

    seeding: 'random' (ks distinct random rows) or 'pp' (k-means++)."""
    xt = _split_subspaces(x.float(), m)  # [m, n, dsub]
    n = x.shape[0]
    if n < ks:
        raise ValueError(f"pq_train needs at least ks={ks} rows, got {n}")
    cents = []
    for j in range(m):
        g = vrng.split_stream(gen, j)
        xs = xt[j].contiguous()
        if seeding == "pp":
            seed = km.kmeans_pp_seed(g, xs, ks)
        else:
            seed = xs[vrng.sample_without_replacement(g, n, ks)]
        cents.append(km.kmeans_lloyd(g, xs, seed, k=ks, iters=iters).centroids)
    return books_from_centroids(torch.stack(cents))


def pq_train_residual(
    gen: torch.Generator,
    x: Tensor,
    coarse_centroids: Tensor,
    assignments: Tensor,
    *,
    m: int,
    ks: int = 256,
    iters: int = 25,
) -> PQCodebooks:
    """Residual-PQ training for IVF-PQ (reference pq_train_f32 residual mode,
    PQTrain.swift:89-90): train on r = x − c[assign] (#23)."""
    res = residuals(x, coarse_centroids, assignments)
    return pq_train(gen, res, m=m, ks=ks, iters=iters)


# ---------------------------------------------------------------------------
# #23 — residuals
# ---------------------------------------------------------------------------


def residuals(x: Tensor, coarse_centroids: Tensor, assignments: Tensor) -> Tensor:
    """r = x − c[assign] (reference residuals_f32, ResidualKernel.swift:148).
    Columns of x past the centroid width are dropped."""
    if x.shape[1] > coarse_centroids.shape[1]:
        x = x[:, : coarse_centroids.shape[1]]
    return x.float() - coarse_centroids.float()[assignments.long()]


# ---------------------------------------------------------------------------
# #20 — encoding
# ---------------------------------------------------------------------------


def pq_encode(x: Tensor, books: PQCodebooks, chunk: int = 4096) -> Tensor:
    """Encode rows → codes [n, m] uint8: the nearest centroid per subspace by
    the dot trick (reference pq_encode_u8_f32 withCSQ, cpq_encode.h:54-64),
    over row chunks so the [chunk, m, ks] distance tensor stays small."""
    n, d = x.shape
    m, ks, dsub = books.centroids.shape
    out = torch.empty((n, m), dtype=torch.uint8, device=x.device)
    for s in range(0, n, chunk):
        xt = x[s : s + chunk].float().reshape(-1, m, dsub)
        d2 = books.sqnorms[None] - 2.0 * _subspace_dots(xt, books.centroids)
        out[s : s + chunk] = torch.argmin(d2, dim=-1).to(torch.uint8)
    return out


def pq_encode_u4(x: Tensor, books: PQCodebooks, chunk: int = 4096) -> Tensor:
    """u4 encode (ks ≤ 16) with nibble packing → [n, m//2] bytes (reference
    pq_encode_u4_f32, PQEncode.swift:178)."""
    if books.ks > 16:
        raise ValueError("u4 encode requires ks <= 16")
    return pack_u4(pq_encode(x, books, chunk=chunk))


def pq_encode_residual(
    x: Tensor,
    coarse_centroids: Tensor,
    assignments: Tensor,
    books: PQCodebooks,
    chunk: int = 4096,
) -> Tensor:
    """Residual encode for IVF-PQ (reference pq_encode_u8_residual,
    PQEncode.swift:241-444)."""
    return pq_encode(residuals(x, coarse_centroids, assignments), books, chunk=chunk)


def pq_decode(codes: Tensor, books: PQCodebooks) -> Tensor:
    """Reconstruct vectors from codes (for tests / reconstruction error)."""
    n, m = codes.shape
    sub = torch.arange(m, device=codes.device)[None, :]
    return books.centroids[sub, codes.long()].reshape(n, m * books.dsub)


# ---------------------------------------------------------------------------
# #21 — LUT build
# ---------------------------------------------------------------------------


def pq_lut_l2(q: Tensor, books: PQCodebooks) -> Tensor:
    """L[b, j, k] = ‖q_j − C_j[k]‖² (reference pq_lut_l2_f32, PQLUT.swift:200;
    dot trick). [B, m, ks]."""
    m, _, dsub = books.centroids.shape
    qt = q.float().reshape(q.shape[0], m, dsub)
    qsq = (qt * qt).sum(dim=-1)  # [B, m]
    dots = _subspace_dots(qt, books.centroids)
    return torch.clamp_min(qsq[:, :, None] + books.sqnorms[None] - 2.0 * dots, 0.0)


def pq_lut_ip(q: Tensor, books: PQCodebooks) -> Tensor:
    """Inner-product LUT: L[b, j, k] = −⟨q_j, C_j[k]⟩ so ADC sums are
    ascending distances."""
    m, _, dsub = books.centroids.shape
    return -_subspace_dots(q.float().reshape(q.shape[0], m, dsub), books.centroids)


def pq_lut_residual_l2(
    q: Tensor, coarse_centroids: Tensor, lists: Tensor, books: PQCodebooks
) -> Tensor:
    """Fused residual LUT for IVF-PQ (reference pq_lut_residual_l2_f32,
    PQLUT.swift:287): for each (query b, probed list p), the LUT of
    (q − c_list) against the codebooks. lists [B, P] → [B, P, m, ks]."""
    b, p = lists.shape
    m, _, dsub = books.centroids.shape
    rq = q.float()[:, None, :] - coarse_centroids.float()[lists.long()]  # [B, P, d]
    rt = rq.reshape(b, p, m, dsub)
    rsq = (rt * rt).sum(dim=-1)  # [B, P, m]
    dots = _subspace_dots(rt, books.centroids)
    return torch.clamp_min(rsq[..., None] + books.sqnorms[None, None] - 2.0 * dots, 0.0)


def pq_lut_q_l2(q: Tensor, books: PQCodebooks) -> Tensor:
    """Query-only component of the residual L2 LUT: −2⟨q_j, C_j[k]⟩.

    The decomposition of the fused residual LUT (#21):
      ‖(q−c_l) − r̂‖² = ‖q−c_l‖² + Σ_j(−2⟨q_j, C_j[k_j]⟩)
                        + Σ_j(2⟨c_{l,j}, C_j[k_j]⟩ + ‖C_j[k_j]‖²)
    base(q, l) comes from the coarse select distances, the middle term is
    this per-query table, and the last term depends only on the stored row
    (pq_row_corrections)."""
    return 2.0 * pq_lut_ip(q, books)


def pq_row_corrections(
    codes: Tensor,  # [N, m] uint8 (unpacked)
    row_list: Tensor,  # [N] list id per row
    coarse_centroids: Tensor,  # [kc, d]
    books: PQCodebooks,
    chunk: int = 65536,
) -> Tensor:
    """Per-row constant of the decomposed residual LUT:
    t[i] = Σ_j (2⟨c_{l(i),j}, C_j[codes_ij]⟩ + ‖C_j[codes_ij]‖²) → [N] f32."""
    n, m = codes.shape
    kc = coarse_centroids.shape[0]
    _, ks, dsub = books.centroids.shape
    cdot = _subspace_dots(coarse_centroids.float().reshape(kc, m, dsub), books.centroids)
    table = (2.0 * cdot + books.sqnorms[None]).reshape(-1)  # [kc · m · ks]
    sub = torch.arange(m, device=codes.device)[None, :] * ks
    out = torch.empty(n, dtype=torch.float32, device=codes.device)
    for s in range(0, n, chunk):
        flat = row_list[s : s + chunk].long()[:, None] * (m * ks) + sub + codes[s : s + chunk].long()
        out[s : s + chunk] = table[flat].sum(dim=1)
    return out


# ---------------------------------------------------------------------------
# #22 — ADC scan over a whole code array
# ---------------------------------------------------------------------------


def adc_scan(codes: Tensor, lut: Tensor, *, strategy: str = "auto", chunk: int = 8192) -> Tensor:
    """dist[b, i] = Σ_j LUT[b, j, codes[i, j]] (reference adc_scan_u8,
    ADCScan.swift:54). codes [n, m] uint8, lut [B, m, ks] → [B, n] f32.

    strategy='auto': kernel K6 on a CUDA tensor (kernels/adc.adc_scan_u8),
    'gather' on a CPU tensor. 'gather': flat-index gather and a sum over j.
    'onehot': one-hot(codes) @ lutᵀ (exact: the one-hot side is 0/1)."""
    if strategy == "auto":
        if codes.is_cuda:
            from vectorindex_tpu_torch.kernels.adc import adc_scan_u8

            return adc_scan_u8(codes.contiguous(), lut.float().contiguous())
        strategy = "gather"
    n, m = codes.shape
    b, m2, ks = lut.shape
    if m2 != m:
        raise ValueError(f"lut has {m2} subspaces, codes {m}")
    lut_flat = lut.float().reshape(b, m * ks)
    offsets = torch.arange(m, device=codes.device)[None, :] * ks
    out = torch.empty((b, n), dtype=torch.float32, device=codes.device)
    if strategy == "onehot":
        lut_t = lut_flat.T  # [m·ks, B]
        for s in range(0, n, chunk):
            flat = codes[s : s + chunk].long() + offsets  # [C, m]
            oh = torch.zeros((flat.shape[0], m * ks), dtype=torch.float32, device=codes.device)
            oh.scatter_(1, flat, 1.0)
            out[:, s : s + chunk] = (oh @ lut_t).T
        return out
    if strategy == "gather":
        for s in range(0, n, chunk):
            flat = codes[s : s + chunk].long() + offsets  # [C, m]
            out[:, s : s + chunk] = lut_flat[:, flat].sum(dim=-1)
        return out
    raise ValueError(f"unknown ADC strategy {strategy!r}")


def adc_scan_u4(packed_codes: Tensor, lut: Tensor, **kw) -> Tensor:
    """u4 variant (reference adc_scan_u4, ADCScan.swift:99). lut must have
    ks ≤ 16. 'auto' on a CUDA tensor is kernel K7, which reads the packed
    bytes as they are (kernels/adc.adc_scan_u4); elsewhere unpack, then
    adc_scan."""
    if kw.get("strategy", "auto") == "auto" and packed_codes.is_cuda:
        from vectorindex_tpu_torch.kernels.adc import adc_scan_u4 as adc_scan_u4_kernel

        return adc_scan_u4_kernel(packed_codes.contiguous(), lut.float().contiguous())
    return adc_scan(unpack_u4(packed_codes), lut, **kw)


# ---------------------------------------------------------------------------
# streaming training (reference pq_train_streaming_f32, PQTrain.swift:390;
# chunked API like kmeans_state_init/update_chunk)
# ---------------------------------------------------------------------------


class PQStreamState(NamedTuple):
    states: tuple  # per-subspace KMeansStreamState
    m: int


def pq_stream_init(gen: torch.Generator, first_chunk: Tensor, *, m: int, ks: int) -> PQStreamState:
    """Initialize per-subspace streaming k-means from the first chunk
    (ks distinct random rows per subspace, from split_stream(gen, j))."""
    xt = _split_subspaces(first_chunk.float(), m)
    states = []
    for j in range(m):
        idx = vrng.sample_without_replacement(vrng.split_stream(gen, j), xt.shape[1], ks)
        states.append(km.kmeans_stream_init(xt[j][idx]))
    return PQStreamState(tuple(states), m)


def pq_stream_update(state: PQStreamState, chunk: Tensor) -> PQStreamState:
    """Consume one chunk of rows."""
    xt = _split_subspaces(chunk.float(), state.m)
    return PQStreamState(
        tuple(km.kmeans_stream_update(s, xt[j].contiguous()) for j, s in enumerate(state.states)),
        state.m,
    )


def pq_stream_finalize(state: PQStreamState) -> PQCodebooks:
    return books_from_centroids(torch.stack([km.kmeans_stream_finalize(s) for s in state.states]))
