"""WIT vision pretraining executor: FLMR's stage-1 mapping-network
pretraining.

Port of ravqa_tpu/executors/pretraining_executor.py (the reference's
FLMR_vision_pretraining_executor.py): the model runs with query_mode
"vision_only", so a query is the mapping network's prefix_len tokens
alone, no text (FLMR.py:143-156); the loss and the query encoding take
only the image features, and evaluation scores Recall@K against
pos_item_ids. The WIT recipe (configs/wit/flmr_wit_pretraining.json)
freezes the text towers, so only the mapping network trains.
"""

from __future__ import annotations

from typing import Iterable

import torch

from .flmr_executor import FLMRExecutor


class FLMRVisionPretrainingExecutor(FLMRExecutor):
    """Use with FLMRModelConfig(query_mode="vision_only")."""

    def _encode_queries(self, batches: Iterable[dict]) -> torch.Tensor:
        return torch.cat([self.encode_query(None, None, b["image_features"])
                          for b in batches])

    def loss_fn(self, batch, generator):
        out = self.model(
            image_features=self._t(batch["image_features"], torch.float32),
            doc_input_ids=self._t(batch["doc_input_ids"], torch.long),
            doc_attention_mask=self._t(batch["doc_attention_mask"]),
            deterministic=True, generator=generator)
        return out["loss"], {"nway_loss": (out["loss"]
                                           - out["ib_loss"]).detach(),
                             "ib_loss": out["ib_loss"].detach()}
