"""FLMR retrieval executor: the training loss, query/doc encoding, index
building and the Recall@K evaluation.

Port of ravqa_tpu/executors/flmr_executor.py (reference
src/executors/FLMR_executor.py): the training step's loss is the nway plus
in-batch-negative loss (:368-427), with dropout off as in the JAX package
(deterministic=True); validation embeds the queries, builds an index over
the corpus on the executor's device, searches it and scores pseudo-
relevance and positive-id Recall/Precision@K (:429-973). An executor built
with inference_only=True (build_server's) holds no optimizer, so a
checkpoint loads straight into a serving executor (ROADMAP.md C5).

On a mesh (BaseExecutor's data parallelism) the index is sharded over
the "data" axis as the JAX executor shards it (flmr_executor.py:85-141):
each rank encodes its slice of the corpus, builds its shard's summaries,
with hierarchical block summaries of the largest block size in (64, 32,
..., 1) that divides the per-shard doc count, and searches it; every rank
encodes all the queries and gets the merged ranking.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from ..metrics import positive_id_scores, pseudo_relevance_scores
from ..models.flmr import FLMRRetriever, skiplist_mask
from ..retrieval import LateInteractionSearcher
from ..retrieval.index import TokenIndex, encode_corpus
from .base import CHECKPOINT_FILES, BaseExecutor, TrainConfig

__all__ = ["CHECKPOINT_FILES", "FLMRExecutor"]

_FLOAT_INPUTS = ("image_features", "pixel_values", "image_patch_features",
                 "doc_image_features")


class FLMRExecutor(BaseExecutor):
    def __init__(self, model: FLMRRetriever,
                 train_cfg: Optional[TrainConfig] = None, device=None,
                 log_dir: Optional[str] = None, seed: int = 0,
                 quiet: bool = False,
                 skip_ids: Optional[Sequence[int]] = None, **kwargs):
        self.skip_ids = tuple(skip_ids or ())
        super().__init__(model, train_cfg, device, log_dir, seed,
                         quiet=quiet, **kwargs)

    # -- loss ----------------------------------------------------------------
    def _inputs(self, batch: dict) -> dict:
        """A collated batch on the device: ids as int64, image features,
        patch features and pixels float32."""
        out = {}
        for k, v in batch.items():
            dtype = torch.long if k.endswith("input_ids") else (
                torch.float32 if k in _FLOAT_INPUTS else None)
            out[k] = self._t(v, dtype)
        return out

    def loss_fn(self, batch, generator):
        out = self.model(**self._inputs(batch), deterministic=True,
                         generator=generator)
        metrics = {"nway_loss": (out["loss"] - out["ib_loss"]).detach(),
                   "ib_loss": out["ib_loss"].detach()}
        return out["loss"], metrics

    # -- encoding ------------------------------------------------------------
    @torch.inference_mode()
    def encode_query(self, input_ids, attention_mask, image_features=None,
                     pixel_values=None,
                     image_patch_features=None) -> torch.Tensor:
        """-> (B, Lq_total, dim) float32 on the executor's device. Image
        features, or pixels for an in-graph ViT, and patch features for
        the transformer mapping, as the model's query mode takes them."""
        def opt(x, dtype=torch.float32):
            return None if x is None else self._t(x, dtype)

        with self.gathered_params():
            return self.model.query(opt(input_ids, torch.long),
                                    opt(attention_mask, None),
                                    opt(image_features), opt(pixel_values),
                                    opt(image_patch_features))

    @torch.inference_mode()
    def encode_doc(self, input_ids, attention_mask, skip_mask=None):
        ids = self._t(input_ids, torch.long)
        if skip_mask is None:
            skip_mask = skiplist_mask(ids, self.skip_ids)
        with self.gathered_params():
            return self.model.doc(ids, self._t(attention_mask),
                                  self._t(skip_mask, torch.float32))

    def _encode_queries(self, batches: Iterable[dict]) -> torch.Tensor:
        return torch.cat([self.encode_query(
            b.get("query_input_ids"), b.get("query_attention_mask"),
            b.get("image_features"), b.get("pixel_values"),
            b.get("image_patch_features")) for b in batches])

    def encode_queries(self, batches: Iterable[dict]) -> np.ndarray:
        return self._encode_queries(batches).cpu().numpy()

    def build_index(self, doc_batches: Iterable[dict],
                    pids: Optional[Sequence] = None,
                    dtype: torch.dtype = torch.float32,
                    pad_multiple: int = 8,
                    resume_dir: Optional[str] = None) -> TokenIndex:
        """Encode a corpus into a TokenIndex on the executor's device
        (float32 by default, as the JAX executor stores it). resume_dir
        keeps each batch's embeddings there and skips batches already
        encoded on a restart (retrieval.index.encode_corpus)."""
        def encode_fn(b):
            return self.encode_doc(b["doc_input_ids"], b["doc_attention_mask"],
                                   b.get("doc_skip_mask"))

        return encode_corpus(encode_fn, doc_batches,
                             pad_multiple=pad_multiple, dtype=dtype,
                             pids=pids, device=self.device,
                             resume_dir=resume_dir, mesh=self.mesh,
                             axis="data")

    # -- evaluation ----------------------------------------------------------
    def evaluate_retrieval(
        self,
        query_batches: Iterable[dict],
        doc_batches: Iterable[dict],
        passage_ids: Sequence,
        passage_contents: Optional[Sequence[str]] = None,
        answers: Optional[Sequence[Sequence[str]]] = None,
        gold_answers: Optional[Sequence[str]] = None,
        pos_item_ids: Optional[Sequence[Sequence]] = None,
        ks: Sequence[int] = (5, 10),
        index: Optional[TokenIndex] = None,
        search_mode: str = "exact",
        n_candidates: Optional[int] = None,
        add_null_document: bool = False,
        coarse_query_len: Optional[int] = None,
        coarse_int8: Optional[bool] = None,
        search_preset: str = "reference",
    ) -> dict:
        """The reference's evaluation loop (FLMR_executor:722-973): index
        the corpus (unless `index` is given), search every query and score
        the top max(ks). The pruned modes build summaries, and
        hierarchical block summaries of the largest block size in (64, 32,
        ..., 1) that divides the padded doc count. The searcher takes the
        kernels when the index is on the card. Returns the metrics, plus
        the index under "_index" and the retrieved passage ids under
        "_retrieved_pids"."""
        if index is None:
            index = self.build_index(doc_batches, pids=np.arange(
                len(passage_ids)))
        if search_mode in ("two_stage", "hierarchical") \
                and index.summaries is None:
            index.build_summaries()
        if search_mode == "hierarchical" and index.block_summaries is None:
            bs = max(b for b in (64, 32, 16, 8, 4, 2, 1)
                     if index.n_local % b == 0)
            index.build_block_summaries(block_size=bs)
        searcher = LateInteractionSearcher(
            index, self.mesh, "data" if self.mesh is not None else "index",
            mode=search_mode, n_candidates=n_candidates,
            coarse_query_len=coarse_query_len, coarse_int8=coarse_int8,
            preset=search_preset)
        q = self._encode_queries(query_batches)
        k = max(ks)
        _, rows = searcher.search(q, k=min(k, index.num_docs))
        metrics: dict = {}
        retrieved_pids = [[passage_ids[r] for r in row if r >= 0]
                          for row in rows]
        if answers is not None and passage_contents is not None:
            contents = [[passage_contents[r] for r in row if r >= 0]
                        for row in rows]
            metrics.update(pseudo_relevance_scores(
                contents, answers, ks, gold_answers,
                add_null_document=add_null_document))
        if pos_item_ids is not None:
            metrics.update(positive_id_scores(retrieved_pids, pos_item_ids,
                                              ks))
        metrics["_index"] = index
        metrics["_retrieved_pids"] = retrieved_pids
        return metrics
