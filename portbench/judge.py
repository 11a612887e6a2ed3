"""The numbers that decide `correct`, each beside its limit.

Serve cells. For each sampled request, the reference's query (its own
tokenisation, towers and, for a pruned mode, its own pruning) gives its
top k; every served answer (pid, score) at rank r is held to two gaps, in
score units per query token (a score is a sum of Lq cosines):
- |served score - the reference's exact score of that pid|;
- the reference's r-th best score - its exact score of the served pid
  (how far the served answer lies below the reference's, as the
  widest-logit-gap test of a served model; tied docs read their rounding
  difference, a wrong or missing doc its score deficit). In a pruned mode
  the r-th best is over the candidates that the pipeline takes whichever
  way a near-tie at a cut goes (reference/search.py, Hierarchical.search).
`score_gap` is the widest of both over the sample; a pid that is no doc
reads infinity. `unanswered` counts requests that never answered.

Training cells: `loss_gap` (the first step's loss against the
reference's, relative), `grad_gap` (the worst leaf's gap between the
norms of the first gradient as the optimizer holds it and the
reference's, over the larger of the reference leaf's norm and the median
leaf's) and, for each learning-rate group of the reference (`base`, and
`mapping` for the mapping network), `change_gap.<group>` (the group's
median leaf's gap, the same way, of each leaf's change after three
steps, leaving out the leaves whose reference gradient is under a
thousandth of the median leaf's: round-off alone moves those under
Adam). A group's own number sees a wrong rate in that group alone, which
the median over every leaf would not. The later steps' losses and the
worst leaf's change swing from seed to seed: where a query token's two
best doc tokens score within rounding of each other, the max sends the
gradient to either, and Adam's sign-like first steps carry that into the
later steps (PERF.md section 2).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class Answer(NamedTuple):
    """A served answer as the checks read it (RetrievalResult's fields)."""
    pids: np.ndarray
    scores: np.ndarray


def sample_requests(answers: dict, reqs, n: int, seed: int) -> list:
    """A seeded sample of n answered request indices, with the request of
    the longest question among the answered ones."""
    keys = sorted(answers)
    if not keys:
        return []
    rng = np.random.default_rng([seed, 5])
    pick = list(rng.choice(keys, size=min(n, len(keys)), replace=False))
    longest = max(keys, key=lambda i: len(reqs.texts[reqs.entry(i)].split()))
    if longest not in pick:
        pick[-1] = longest
    return [int(i) for i in pick]


def serve_numbers(served: list, ref: dict, n_docs: int) -> dict:
    if not served:
        return {"score_gap": math.inf}
    lq = ref["q"].shape[1]
    pids = np.stack([np.asarray(a.pids) for a in served])
    scores = np.stack([np.asarray(a.scores, np.float64) for a in served])
    if (pids < 0).any() or (pids >= n_docs).any():
        return {"score_gap": math.inf}
    dev = ref["q"].device
    exact = ref["score"](torch.as_tensor(pids, device=dev)).double().cpu()
    best = ref["bound"].double().cpu()
    gap_score = (torch.as_tensor(scores) - exact).abs()
    gap_rank = best - exact
    return {"score_gap": float(torch.maximum(gap_score, gap_rank).max())
            / lq}


def train_numbers(prog: dict, ref: dict) -> dict:
    """prog/ref: {"loss": [three losses], "grad": {leaf: norm of the
    first gradient}, "change": {leaf: norm of the change}}; ref also
    "group": {leaf: its learning-rate group}."""
    out = {"loss_gap": abs(prog["loss"][0] - ref["loss"][0])
           / abs(ref["loss"][0]),
           "grad_gap": max(_leaf_gaps(prog["grad"], ref["grad"]))}
    moved = _moved(ref["grad"])
    for group in sorted(set(ref["group"].values())):
        keep = {k for k in moved if ref["group"][k] == group}
        out[f"change_gap.{group}"] = float(np.median(_leaf_gaps(
            prog["change"], ref["change"], keep=keep)))
    return out


def _moved(grad: dict) -> set:
    med = float(np.median(list(grad.values())))
    return {k for k, v in grad.items() if v >= 1e-3 * med}


def _leaf_gaps(prog: dict, ref: dict, keep=None) -> list:
    names = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in names]))
    return [abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med)
            for k in names]


def with_limits(numbers: dict, limits: dict) -> dict:
    """{name: {"value": v, "limit": l}}: every number, beside its limit."""
    return {name: {"value": value, "limit": limits[name]}
            for name, value in numbers.items()}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
