"""Cross-encoder reranker, its HF checkpoint converters and its pair
tokenizer.

Port of ravqa_tpu/models/reranker.py (reference third_party/ColBERT/
colbert/modeling/reranker/electra.py:1-35, the ELECTRA encoder with
Linear(hidden, 1) on [CLS]; and the ms-marco MiniLM cross-encoders that
colbert/distillation/scorer.py:40 loads through
AutoModelForSequenceClassification: a BERT encoder, the tanh pooler and a
linear classifier). One module covers both heads: `head="linear_cls"`
(ELECTRA) and `head="pooler_classifier"` (BERT sequence classification).
ELECTRA's factorised embeddings (embedding_size != hidden_size) go
through `embeddings_project` after the embedding LayerNorm, which runs in
float32. The encoder is post-LN with the exact erf GELU. The module and
parameter names follow the JAX package's Flax tree, so
models.convert.flax_to_state_dict carries its params; the HF converters
here write the port's state_dict straight from the HF names.

The JAX package pads each scoring batch to a (bsize, power-of-two length)
bucket for XLA's compile cache (retrieval/distill.py); eager PyTorch
compiles nothing per shape, so the port scores each batch at its own
size. The pads are masked either way (-1e9 on their keys), so the scores
agree. tests/test_torch_reranker.py holds the module, the converters and
the tokenizer to the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from .transformer import (EncoderConfig, TransformerEncoder, _layer_norm,
                          attention_bias_from_mask)


@dataclasses.dataclass(frozen=True)
class RerankerConfig:
    vocab_size: int = 30522
    embedding_size: int = 768            # ELECTRA may differ from hidden
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dropout_rate: float = 0.0
    # "linear_cls": score = Linear(hidden, 1)(x[:, 0])            (ELECTRA)
    # "pooler_classifier": tanh(pooler(x[:, 0])) -> classifier   (BERT)
    head: str = "linear_cls"

    @property
    def encoder_cfg(self) -> EncoderConfig:
        return EncoderConfig(
            hidden_size=self.hidden_size,
            num_layers=self.num_layers,
            num_heads=self.num_heads,
            intermediate_size=self.intermediate_size,
            activation="gelu",
            layer_norm_eps=self.layer_norm_eps,
            pre_layernorm=False,
            dropout_rate=self.dropout_rate,
        )

    @staticmethod
    def tiny(**kw) -> "RerankerConfig":
        """A small config for tests (the JAX package's sizes)."""
        base = dict(vocab_size=512, embedding_size=32, hidden_size=64,
                    num_layers=2, num_heads=4, intermediate_size=128,
                    max_position_embeddings=128, type_vocab_size=2)
        base.update(kw)
        return RerankerConfig(**base)


class CrossEncoderReranker(nn.Module):
    """score(query, passage), higher is more relevant: (B,) float32."""

    def __init__(self, cfg: RerankerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e, h = cfg.embedding_size, cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, e, device=device)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                e, device=device)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, e,
                                                  device=device)
        self.embeddings_ln = nn.LayerNorm(e, eps=cfg.layer_norm_eps,
                                          device=device)
        self.embeddings_project = (nn.Linear(e, h, device=device)
                                   if e != h else None)
        self.encoder = TransformerEncoder(cfg.encoder_cfg, device=device)
        if cfg.head == "pooler_classifier":
            self.pooler = nn.Linear(h, h, device=device)
            self.classifier = nn.Linear(h, 1, device=device)
        elif cfg.head == "linear_cls":
            self.score_head = nn.Linear(h, 1, device=device)
        else:
            raise ValueError(f"unknown reranker head {cfg.head!r}")

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        t = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = torch.arange(t, device=input_ids.device)[None, :]
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(pos)
             + self.token_type_embeddings(token_type_ids))
        x = _layer_norm(self.embeddings_ln, x)
        if self.embeddings_project is not None:
            x = self.embeddings_project(x)
        x = self.encoder(x, attention_bias_from_mask(attention_mask),
                         deterministic=deterministic, generator=generator)
        cls = x[:, 0]
        if self.cfg.head == "pooler_classifier":
            score = self.classifier(torch.tanh(self.pooler(cls)))
        else:
            score = self.score_head(cls)
        return score.squeeze(-1).float()


# ---------------------------------------------------------------------------
# HF torch checkpoint conversion, straight into the port's state_dict
# ---------------------------------------------------------------------------

def convert_hf_electra_reranker_params(state_dict: dict,
                                       cfg: RerankerConfig
                                       ) -> dict[str, torch.Tensor]:
    """The ElectraReranker layout (electra.py:17-20): `electra.*` encoder
    keys (an HF BertModel's, without the pooler) and a top-level
    `linear.{weight,bias}` scoring head -> the port's CrossEncoderReranker
    state_dict (head "linear_cls"). nn.Linear keeps HF's (out, in)
    weights, so the keys are only renamed."""
    from .convert_flmr import _bert_names, _rename, _t
    names = {hf: ours for hf, ours in _bert_names(cfg.num_layers).items()
             if ours != "pooler"}
    if cfg.embedding_size != cfg.hidden_size:
        names["embeddings_project"] = "embeddings_project"
    sd = _rename(state_dict, names, src="electra.")
    sd["score_head.weight"] = _t(state_dict["linear.weight"])
    sd["score_head.bias"] = _t(state_dict["linear.bias"])
    return sd


def convert_hf_seqcls_bert_params(state_dict: dict,
                                  cfg: RerankerConfig
                                  ) -> dict[str, torch.Tensor]:
    """The BertForSequenceClassification layout (the ms-marco MiniLM
    cross-encoders the reference's distillation Scorer defaults to,
    scorer.py:13): `bert.*` (convert_flmr.convert_hf_bert_params, the
    pooler included) and `classifier` -> the port's state_dict (head
    "pooler_classifier")."""
    from .convert_flmr import _t, convert_hf_bert_params
    sd = convert_hf_bert_params(state_dict, cfg.num_layers, prefix="bert.")
    sd["classifier.weight"] = _t(state_dict["classifier.weight"])
    sd["classifier.bias"] = _t(state_dict["classifier.bias"])
    return sd


# ---------------------------------------------------------------------------
# Pair tokenization
# ---------------------------------------------------------------------------

class RerankerTokenizer:
    """[CLS] query [SEP] passage [SEP] with token_type_ids 0/1 and HF
    `truncation='longest_first'` semantics (reference reranker/
    tokenizer.py:10-16): the longer of the two is trimmed one token at a
    time until the pair fits `total_maxlen`."""

    def __init__(self, tok, total_maxlen: int = 180):
        self.tok = tok
        self.total_maxlen = total_maxlen

    def _truncate_pair(self, a: list, b: list, budget: int):
        while len(a) + len(b) > budget:
            if len(a) >= len(b):
                a = a[:-1]
            else:
                b = b[:-1]
        return a, b

    def _ids(self, texts: Sequence[str], budget: int) -> list[list[int]]:
        """Each text's first `budget` token ids. Longest-first truncation
        keeps prefixes, and starting it from lengths capped at the budget
        ends where the whole lengths do (both pass through the capped
        pair), so the ids past the budget are never needed. A tokenizer
        with encode_batch (the port's WordPiece, native where built)
        encodes the batch at once."""
        if hasattr(self.tok, "encode_batch") and budget > 0:
            ids, lens = self.tok.encode_batch(list(texts), budget)
            return [row[:n].tolist() for row, n in zip(ids, lens)]
        return [self.tok.convert_tokens_to_ids(self.tok.tokenize(t))[
            :max(budget, 0)] for t in texts]

    def tensorize(self, questions: Sequence[str], passages: Sequence[str],
                  pad_to: Optional[int] = None):
        """-> (ids, mask, token types), int32 numpy (n, longest or
        pad_to)."""
        assert len(questions) == len(passages)
        cls_id, sep_id = self.tok.cls_token_id, self.tok.sep_token_id
        budget = self.total_maxlen - 3           # [CLS] + 2x [SEP]
        rows, types, lens = [], [], []
        for qa, pa in zip(self._ids(questions, budget),
                          self._ids(passages, budget)):
            qa, pa = self._truncate_pair(qa, pa, budget)
            ids = [cls_id] + qa + [sep_id] + pa + [sep_id]
            tt = [0] * (len(qa) + 2) + [1] * (len(pa) + 1)
            rows.append(ids)
            types.append(tt)
            lens.append(len(ids))
        maxlen = pad_to or max(lens)
        n = len(rows)
        ids = np.zeros((n, maxlen), np.int32)
        ttypes = np.zeros((n, maxlen), np.int32)
        mask = np.zeros((n, maxlen), np.int32)
        for i, (r, t) in enumerate(zip(rows, types)):
            ids[i, :len(r)] = r
            ttypes[i, :len(t)] = t
            mask[i, :len(r)] = 1
        return ids, mask, ttypes
