"""DPR dual encoder, the RA-VQA v1 retrieval baseline (port of
ravqa_tpu/models/dpr.py; reference src/models/retriever/retriever_dpr.py).

A question encoder and an item encoder, each a BertModel whose pooled
output is the embedding; scores are dot products, trained with in-batch
negatives (ops.losses.dpr_in_batch_loss). Module names follow the JAX
package's Flax tree ("query_encoder", "item_encoder"), so models.convert
carries its parameters both ways by the same rules as FLMR's towers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..ops.losses import dpr_in_batch_loss
from .bert import BertConfig, BertModel

INIT_STD = 0.02  # BERT's initializer_range


@dataclasses.dataclass(frozen=True)
class DPRModelConfig:
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    nway: int = 2  # 1 positive + (nway-1) sampled negatives per query

    @staticmethod
    def tiny(**kw) -> "DPRModelConfig":
        base = dict(bert=BertConfig.tiny())
        base.update(kw)
        return DPRModelConfig(**base)


class DPRRetriever(nn.Module):
    # the data-parallel process group whose ranks' items join the in-batch
    # negatives (set by a data-parallel executor; ops.losses)
    negatives_group = None

    def __init__(self, cfg: DPRModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.query_encoder = BertModel(cfg.bert, device=device)
        self.item_encoder = BertModel(cfg.bert, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init from a CPU `generator`: N(0, 0.02) weights and
        embeddings, zero biases, unit LayerNorm scales."""
        for module in self.modules():
            if isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, (nn.Linear, nn.Embedding)):
                w = torch.randn(module.weight.shape, generator=generator)
                module.weight.copy_(w * INIT_STD)
                if getattr(module, "bias", None) is not None:
                    module.bias.zero_()

    def encode_query(self, input_ids, attention_mask, deterministic=True,
                     generator: Optional[torch.Generator] = None):
        return self.query_encoder(input_ids, attention_mask,
                                  deterministic=deterministic,
                                  generator=generator)[1]

    def encode_item(self, input_ids, attention_mask, deterministic=True,
                    generator: Optional[torch.Generator] = None):
        return self.item_encoder(input_ids, attention_mask,
                                 deterministic=deterministic,
                                 generator=generator)[1]

    def forward(self, query_input_ids, query_attention_mask, item_input_ids,
                item_attention_mask, deterministic=True,
                generator: Optional[torch.Generator] = None) -> dict:
        """Item rows grouped per query, query i's positive at i*nway.
        -> {"loss", "scores" (B, B*nway), "query_emb", "item_emb"}."""
        q = self.encode_query(query_input_ids, query_attention_mask,
                              deterministic, generator)
        d = self.encode_item(item_input_ids, item_attention_mask,
                             deterministic, generator)
        loss, scores = dpr_in_batch_loss(q.float(), d.float(), self.cfg.nway,
                                         self.negatives_group)
        return {"loss": loss, "scores": scores, "query_emb": q,
                "item_emb": d}
