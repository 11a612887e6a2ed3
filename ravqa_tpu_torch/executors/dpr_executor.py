"""DPR dual-encoder executor (port of ravqa_tpu/executors/dpr_executor.py;
the reference's RetrieverDPR training path): in-batch-negative training on
pooled embeddings; evaluation encodes the items and the queries on the
executor's device, scores every pair by inner product (torch.matmul) and
keeps the top max(ks) (torch.topk). That product is no kernel of the JAX
package (it computes it with numpy on the host), so there is none to port.
Both packages keep DPR a library class: neither main.py builds it.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from ..metrics import positive_id_scores, pseudo_relevance_scores
from .base import BaseExecutor


class DPRExecutor(BaseExecutor):
    def loss_fn(self, batch, generator):
        out = self.model(self._t(batch["query_input_ids"], torch.long),
                         self._t(batch["query_attention_mask"]),
                         self._t(batch["doc_input_ids"], torch.long),
                         self._t(batch["doc_attention_mask"]),
                         deterministic=True, generator=generator)
        return out["loss"], {}

    @torch.inference_mode()
    def _encode(self, encode, batches: Iterable[dict], prefix: str
                ) -> torch.Tensor:
        return torch.cat([encode(self._t(b[f"{prefix}_input_ids"],
                                         torch.long),
                                 self._t(b[f"{prefix}_attention_mask"]))
                          for b in batches])

    def encode_queries(self, batches: Iterable[dict]) -> np.ndarray:
        return self._encode(self.model.encode_query, batches,
                            "query").cpu().numpy()

    def encode_items(self, batches: Iterable[dict]) -> np.ndarray:
        return self._encode(self.model.encode_item, batches,
                            "doc").cpu().numpy()

    def evaluate_retrieval(self, query_batches, doc_batches, passage_ids,
                           passage_contents=None, answers=None,
                           pos_item_ids=None, ks: Sequence[int] = (5, 10)):
        """The top max(ks) passages of each query by inner product; the
        pseudo-relevance and positive-id Recall/Precision@K. Returns the
        metrics and the retrieved ids under "_retrieved_pids"."""
        q = self._encode(self.model.encode_query, query_batches, "query")
        d = self._encode(self.model.encode_item, doc_batches, "doc")
        with torch.inference_mode():
            k = min(max(ks), d.shape[0])
            rows = torch.topk(q @ d.T, k, dim=1).indices.cpu().numpy()
        metrics = {}
        retrieved = [[passage_ids[r] for r in row] for row in rows]
        if answers is not None and passage_contents is not None:
            contents = [[passage_contents[r] for r in row] for row in rows]
            metrics.update(pseudo_relevance_scores(contents, answers, ks))
        if pos_item_ids is not None:
            metrics.update(positive_id_scores(retrieved, pos_item_ids, ks))
        metrics["_retrieved_pids"] = retrieved
        return metrics
