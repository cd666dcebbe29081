"""The comparison that decides `correct`.

Answers are the index API's own: for a checked query, the ids and public
scores of its k results, in order. The plain reference (reference.py)
gives each query's exact top-k by (distance, id) over the rows as the
index stores them, among the ids the call allowed. An index module's
ANSWER names the form its answers are held to; each number is held to
its configuration's limit (`limits`; null prints it and holds nothing):

  missing      (both forms) places the reference fills that the answer
               leaves without a sound result: absent, out of range, outside
               the call's allow list, repeated within one answer, or with a
               score that is not finite
  score_err    (both) the widest gap between a result's score and the
               reference's public score of that id
  id_diff      (exact) results whose id is not the reference's at that rank
  rank_gap     (exact) the widest by which a result's reference distance
               exceeds the reference's distance at that rank (L2: squared
               distance; cosine: 1 - cos; inner product: its negation)
  recall_loss  (recall) 1 - recall@k: the share of the places the
               reference fills that the answer does not fill with a row at
               or within the reference's k-th distance
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from portbench import reference

FORMS = {
    "exact": ("missing", "id_diff", "rank_gap", "score_err"),
    "recall": ("missing", "recall_loss", "score_err"),
}
#: every number a form can hold, in the order they are printed
NUMBERS = ("missing", "id_diff", "rank_gap", "recall_loss", "score_err")


def answer_arrays(
    answers: Sequence[Tuple[int, Optional[Sequence]]], k: int, n_rows: int,
    allowed: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(query index [A], ids [A, k] int64, scores [A, k] f64) from
    (query index, results or None) pairs; results are (id, score) pairs.
    A position without a sound result holds id -1 and score NaN. `allowed`,
    a bool mask over the rows, marks the ids a call may return."""
    qidx = np.array([q for q, _ in answers], dtype=np.int64)
    ids = np.full((len(answers), k), -1, dtype=np.int64)
    scores = np.full((len(answers), k), np.nan)
    for a, (_, res) in enumerate(answers):
        res = list(res or [])[:k]
        seen = set()
        for j, (rid, score) in enumerate(res):
            ok = (
                isinstance(rid, (int, np.integer)) and 0 <= int(rid) < n_rows
                and (allowed is None or bool(allowed[int(rid)]))
                and int(rid) not in seen and np.isfinite(score)
            )
            if ok:
                ids[a, j] = int(rid)
                scores[a, j] = float(score)
                seen.add(int(rid))
    return qidx, ids, scores


def numbers(
    rows: np.ndarray,
    queries: np.ndarray,
    cfg: dict,
    qidx: np.ndarray,
    ids: np.ndarray,
    scores: np.ndarray,
    ref: Tuple[np.ndarray, np.ndarray],
    device: torch.device,
    form: str = "exact",
) -> dict:
    """The form's numbers for answers (qidx, ids, scores) against `ref`, the
    reference's (ids, dist) of every query in qidx's order."""
    metric = cfg["metric"]
    ref_ids, ref_dist = ref
    sound = ids >= 0
    safe = np.where(sound, ids, 0)
    dist = reference.distances_of(
        rows, queries[qidx], safe, metric, device, row_precision=cfg["index"]["storage_dtype"]
    )
    want = reference.public_scores(dist, metric)
    found = {"missing": int(np.maximum(0, (ref_ids >= 0).sum(1) - sound.sum(1)).sum())}
    if form == "exact":
        gap = np.where(sound, dist - ref_dist, 0.0)
        found["id_diff"] = int(np.sum(sound & (ids != ref_ids)))
        found["rank_gap"] = float(max(0.0, gap.max(initial=0.0)))
    elif form == "recall":
        # a place is filled where its row lies at or within the k-th
        # reference distance (ties at the k-th count, as any of them is a
        # true k-th neighbour)
        kth = ref_dist[:, -1:]
        hit = sound & (dist <= kth)
        found["recall_loss"] = float(1.0 - hit.sum() / max(1, int((ref_ids >= 0).sum())))
    else:
        raise ValueError(f"unknown answer form {form!r}")
    err = np.where(sound, np.abs(scores - want), 0.0)
    found["score_err"] = float(err.max(initial=0.0))
    return {n: found[n] for n in FORMS[form]}


def reference_topk(
    rows: np.ndarray, queries: np.ndarray, cfg: dict, device: torch.device,
    control: bool = False, allowed: Optional[np.ndarray] = None, k: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's (ids, dist) over every query given, k of each (the
    configuration's k by default); with `control`, computed in the
    configuration's control precision."""
    k = int(k or cfg["k"])
    if control:
        p = cfg["reference"]["control"]
        return reference.exact_topk(rows, queries, cfg["metric"], k, device, p, p, allowed=allowed)
    return reference.exact_topk(
        rows, queries, cfg["metric"], k, device,
        row_precision=cfg["index"]["storage_dtype"], allowed=allowed,
    )


def judge(found: dict, limits: dict) -> Tuple[bool, dict]:
    """(every held number within its limit, {name: {value, limit}})."""
    checks = {name: {"value": v, "limit": limits.get(name)} for name, v in found.items()}
    ok = all(c["limit"] is None or c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
