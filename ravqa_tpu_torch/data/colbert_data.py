"""ColBERT-style data objects: Collection, Queries and Triples.

The port's own copy of ravqa_tpu/data/colbert_data.py (the reference
engine's third_party/ColBERT/colbert/data/{collection,queries,examples}.py
and training/LazyBatcher): TSV collections (`pid \t passage [\t title]`,
read as "title | passage"), TSV queries (`qid \t text`), and training
triples (JSONL `[qid, pos_pid, neg_pid, ...]` or TSV) with optional
distillation scores (`[qid, [pid, score], [pid, score], ...]`).
Triples.batches draws the same np.random.default_rng(seed) permutation
as the JAX package and drops the tail that does not fill a batch;
tests/test_torch_triples.py holds the copy to the original.
"""

from __future__ import annotations

import json
from typing import Iterator, Optional, Sequence

import numpy as np


class Collection:
    def __init__(self, passages: Sequence[str],
                 pids: Optional[Sequence] = None):
        self.passages = list(passages)
        self.pids = list(pids) if pids is not None else list(
            range(len(self.passages)))

    @classmethod
    def from_tsv(cls, path: str) -> "Collection":
        passages, pids = [], []
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2:
                    pid, text = parts[0], parts[1]
                    if len(parts) >= 3 and parts[2]:
                        text = parts[2] + " | " + text   # title | passage
                    pids.append(pid)
                    passages.append(text)
        return cls(passages, pids)

    def __len__(self):
        return len(self.passages)

    def __getitem__(self, i):
        return self.passages[i]

    def enumerate_batches(self, bsize: int,
                          rank: int = 0, nranks: int = 1) -> Iterator:
        """Round-robin chunking (reference Collection.enumerate_batches)."""
        for i, s in enumerate(range(0, len(self.passages), bsize)):
            if i % nranks == rank:
                yield s, self.passages[s:s + bsize]


class Queries:
    def __init__(self, qid2text: dict):
        self.qid2text = dict(qid2text)

    @classmethod
    def from_tsv(cls, path: str) -> "Queries":
        out = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2:
                    out[parts[0]] = parts[1]
        return cls(out)

    def __len__(self):
        return len(self.qid2text)

    def items(self):
        return self.qid2text.items()


class Triples:
    """Training examples: (qid, pos_pid, neg_pids...) with optional scores.

    JSONL rows: [qid, pid1, pid2, ...] or [qid, [pid, score], ...] for
    distillation (reference training/rerank batchers).
    """

    def __init__(self, rows: list):
        self.rows = rows

    @classmethod
    def from_jsonl(cls, path: str) -> "Triples":
        rows = []
        with open(path) as f:
            for line in f:
                rows.append(json.loads(line))
        return cls(rows)

    @classmethod
    def from_tsv(cls, path: str) -> "Triples":
        rows = []
        with open(path) as f:
            for line in f:
                rows.append(line.rstrip("\n").split("\t"))
        return cls(rows)

    def __len__(self):
        return len(self.rows)

    def batches(self, queries: Queries, collection: Collection,
                bsize: int, nway: int = 2, shuffle: bool = True,
                seed: int = 0, epochs: Optional[int] = None):
        """Yield dicts: query texts, doc texts (nway per query), and
        optional target scores for distillation."""
        pid2pos = {p: i for i, p in enumerate(collection.pids)}
        rng = np.random.default_rng(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = rng.permutation(len(self.rows)) if shuffle \
                else np.arange(len(self.rows))
            for s in range(0, len(order) - bsize + 1, bsize):
                qs, docs, scores = [], [], []
                has_scores = False
                for idx in order[s:s + bsize]:
                    row = self.rows[idx]
                    qid, entries = row[0], row[1:1 + nway]
                    qs.append(queries.qid2text[str(qid)])
                    for e in entries:
                        if isinstance(e, (list, tuple)):
                            pid, sc = e[0], float(e[1])
                            has_scores = True
                        else:
                            pid, sc = e, 0.0
                        docs.append(collection.passages[pid2pos[str(pid)]
                                    if str(pid) in pid2pos else int(pid)])
                        scores.append(sc)
                yield {"queries": qs, "docs": docs,
                       "target_scores":
                           np.array(scores, np.float32).reshape(
                               bsize, nway) if has_scores else None}
            epoch += 1


def docs_to_passages(docs: Sequence[str], max_words: int = 180,
                     overlap: int = 0) -> list[str]:
    """Split long documents into word-window passages (reference
    utility/preprocess/docs2passages.py semantics: fixed word windows)."""
    out = []
    step = max(max_words - overlap, 1)
    for doc in docs:
        words = doc.split()
        if not words:
            continue
        for s in range(0, len(words), step):
            chunk = words[s:s + max_words]
            if chunk:
                out.append(" ".join(chunk))
            if s + max_words >= len(words):
                break
    return out


def create_triples_from_ranking(retrieved_ids: Sequence[Sequence],
                                pos_item_ids: Sequence[Sequence],
                                query_ids: Sequence,
                                n_negatives: int = 1,
                                seed: int = 0) -> list:
    """Build training triples [qid, pos, neg...] from a ranking: positives
    from the annotations, negatives sampled from retrieved non-positives
    (reference utility/supervision/triples.py semantics)."""
    rng = np.random.default_rng(seed)
    triples = []
    for qid, row, pos in zip(query_ids, retrieved_ids, pos_item_ids):
        pos_set = set(pos)
        negs = [r for r in row if r not in pos_set]
        if not pos or not negs:
            continue
        chosen_pos = pos[int(rng.integers(len(pos)))]
        chosen_negs = list(rng.choice(negs,
                                      size=min(n_negatives, len(negs)),
                                      replace=False))
        triples.append([qid, chosen_pos] + chosen_negs)
    return triples
