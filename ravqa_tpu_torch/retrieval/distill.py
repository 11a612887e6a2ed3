"""Cross-encoder distillation scorer.

Port of ravqa_tpu/retrieval/distill.py (reference third_party/ColBERT/
colbert/distillation/scorer.py:1-70 and ranking_scorer.py:1-60): score
(qid, pid) pairs with a cross-encoder teacher and write the per-qid
`distillation_scores.json` lines that triples-based KD training reads.

Pairs are scored in length-sorted order, then put back in their own
order (the reference's "sort by length in advance" TODO, done in the JAX
package). The JAX package pads each batch to `bsize` rows and a
power-of-two length for XLA's compile cache; the port runs each batch at
its own size on the teacher's device (pads are masked either way). The
teacher is a plain PyTorch module: the JAX package leaves it to XLA, and
no Pallas kernel runs here. tests/test_torch_reranker.py holds the scores
(1e-5), the JSON schema and the KD rows to the JAX package's.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.reranker import CrossEncoderReranker, RerankerTokenizer


class Scorer:
    """Batched cross-encoder scoring of (query, passage) pairs on the
    teacher's device."""

    def __init__(self, model: CrossEncoderReranker,
                 tokenizer: RerankerTokenizer, bsize: int = 256):
        self.model = model.eval()
        self.tokenizer = tokenizer
        self.bsize = bsize
        self.device = next(model.parameters()).device

    @torch.inference_mode()
    def score_pairs(self, questions: Sequence[str],
                    passages: Sequence[str]) -> np.ndarray:
        """-> (n,) float32 scores, in the pairs' order."""
        assert len(questions) == len(passages)
        n = len(questions)
        if n == 0:
            return np.zeros((0,), np.float32)
        lens = np.array([len(q) + len(p)
                         for q, p in zip(questions, passages)])
        order = np.argsort(lens, kind="stable")
        out = np.zeros(n, np.float32)
        for s in range(0, n, self.bsize):
            sel = order[s:s + self.bsize]
            ids, mask, tt = self.tokenizer.tensorize(
                [questions[i] for i in sel], [passages[i] for i in sel])

            def t(x):
                return torch.as_tensor(x, dtype=torch.long,
                                       device=self.device)
            out[sel] = self.model(t(ids), t(mask), t(tt)).cpu().numpy()
        return out

    def score_ranking(self, qids: Sequence, pids: Sequence,
                      queries: dict, collection,
                      save_path: Optional[str] = None) -> dict:
        """RankingScorer.run: score each (qid, pid) pair and group the
        scores by qid. `queries` maps qid -> text; `collection` is indexable
        by pid (a list by int pid, or a dict). With save_path, writes the
        reference's distillation_scores.json: one `[qid, [[score, pid],
        ...]]` JSON line per qid (ranking_scorer.py:36-42)."""
        assert len(qids) == len(pids)
        qtexts = [queries[q] for q in qids]
        ptexts = [collection[p] for p in pids]
        scores = self.score_pairs(qtexts, ptexts)
        by_qid: dict = {}
        for qid, pid, sc in zip(qids, pids, scores):
            by_qid.setdefault(qid, []).append((float(sc), pid))
        if save_path is not None:
            with open(save_path, "w") as f:
                for qid, entries in by_qid.items():
                    f.write(json.dumps([qid, entries]) + "\n")
        return by_qid


def load_distillation_scores(path: str) -> dict:
    """distillation_scores.json -> {qid: [(score, pid), ...]}."""
    by_qid = {}
    with open(path) as f:
        for line in f:
            qid, entries = json.loads(line)
            by_qid[qid] = [(float(s), p) for s, p in entries]
    return by_qid


def kd_triples_from_scores(by_qid: dict, nway: int = 2,
                           seed: int = 0) -> list:
    """Triples rows [qid, [pid, score], ...] for TriplesExecutor's
    KL-distillation path: per query, the teacher's top passage and nway - 1
    others drawn without replacement, each with its teacher score (the
    same numpy draws as the JAX package)."""
    rng = np.random.default_rng(seed)
    rows = []
    for qid, entries in by_qid.items():
        if len(entries) < nway:
            continue
        ordered = sorted(entries, key=lambda e: -e[0])
        top = ordered[0]
        rest_idx = rng.choice(len(ordered) - 1, size=nway - 1, replace=False)
        rest = [ordered[1 + i] for i in sorted(rest_idx)]
        rows.append([qid] + [[p, s] for s, p in [top] + rest])
    return rows
