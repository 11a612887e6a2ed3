"""Triples-based text-retrieval training (the ColBERT training subsystem).

Port of ravqa_tpu/executors/triples_executor.py (the reference engine's
training/ package: the triples LazyBatcher, the nway cross-entropy and
optional KL distillation against teacher scores). It trains the
text-only late-interaction tower from (query, positive, negatives)
triples, as in MS MARCO-style pretraining of PreFLMR's text backbone:

- make_batch tokenizes a Triples.batches() dict with the query and doc
  tokenizers (numpy arrays; loss_fn moves them to the executor's device);
- loss_fn: nway_ce_loss, plus in_batch_negative_loss with
  use_ib_negatives, plus distill_weight x KL(teacher || student) over
  each query's nway softmax when the batch carries target_scores; the
  metrics nway_loss, ib_loss and distill_kl;
- train_on_triples runs BaseExecutor.fit over the triples' batches.

Evaluation is FLMRExecutor.evaluate_retrieval (K1 on the card).
tests/test_torch_triples.py holds the loss, its grads and a 6-step loss
trajectory to the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.losses import in_batch_negative_loss, nway_ce_loss
from .flmr_executor import FLMRExecutor


class TriplesExecutor(FLMRExecutor):
    """Use with FLMRModelConfig(query_mode="text_only"). Batches come from
    Triples.batches()."""

    def __init__(self, *args, distill_weight: float = 0.0,
                 query_tokenizer=None, doc_tokenizer=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.distill_weight = distill_weight
        self.qt = query_tokenizer
        self.dt = doc_tokenizer

    def make_batch(self, batch: dict) -> dict:
        qi, qm = self.qt.tensorize(batch["queries"])
        di, dm = self.dt.tensorize(batch["docs"])
        out = {"query_input_ids": qi, "query_attention_mask": qm,
               "doc_input_ids": di, "doc_attention_mask": dm}
        if batch.get("target_scores") is not None:
            out["target_scores"] = np.asarray(batch["target_scores"],
                                              np.float32)
        return out

    def loss_fn(self, batch, generator: Optional[torch.Generator] = None):
        cfg = self.model.cfg
        q = self.model.query(self._t(batch["query_input_ids"], torch.long),
                             self._t(batch["query_attention_mask"]))
        d, d_mask = self.model.doc(self._t(batch["doc_input_ids"],
                                           torch.long),
                                   self._t(batch["doc_attention_mask"]))
        loss, scores = nway_ce_loss(q, d, d_mask, cfg.nway)
        metrics = {"nway_loss": loss.detach()}
        if cfg.use_ib_negatives:
            ib, _ = in_batch_negative_loss(q, d, d_mask, cfg.nway,
                                           group=self.model.negatives_group)
            loss = loss + ib
            metrics["ib_loss"] = ib.detach()
        if self.distill_weight > 0 and batch.get("target_scores") is not None:
            # KL(teacher || student) over the nway softmax, the mean over
            # queries (the reference's distillation objective)
            t = torch.log_softmax(self._t(batch["target_scores"],
                                          torch.float32), -1)
            s = torch.log_softmax(scores.float(), -1)
            kl = (t.exp() * (t - s)).sum(-1).mean()
            loss = loss + self.distill_weight * kl
            metrics["distill_kl"] = kl.detach()
        return loss, metrics

    def train_on_triples(self, triples, queries, collection, bsize: int,
                         steps: int, **fit_kwargs):
        batches = (self.make_batch(b) for b in triples.batches(
            queries, collection, bsize=bsize, nway=self.model.cfg.nway))
        return self.fit(batches, steps=steps, **fit_kwargs)
