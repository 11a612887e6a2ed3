"""FLMR retriever towers (port of ravqa_tpu/models/flmr.py).

- query(): BERT token embeddings -> bias-free Linear(hidden, dim) -> zero
  the pad rows -> concat the mapping network's vision tokens -> L2
  normalize (reference FLMR.py:73-99).
- doc(): BERT -> linear -> pad/skiplist masking -> L2 normalize
  (colbert.py:194-215).
- forward(): the training forward, nway scores plus the nway and
  in-batch-negative losses (JAX ``__call__``, colbert.py:64-113), with the
  colbert or the FLIPR interaction.
- query modes "text+vision", "text_only" and "vision_only"; image
  features pre-extracted, or pixels through the model's own CLIP ViT
  (`in_graph_vision`); the PreFLMR transformer mapping
  (`use_transformer_mapping`: one text-conditioned token per vision patch);
  multimodal docs (`multimodal_docs`: doc text plus projected doc-image
  tokens).
- spans (utils.profiling, while recording is on): tower.query over
  tower.text, tower.vit and tower.mapping, as the configuration has them;
  tower.doc.
"""

from __future__ import annotations

import dataclasses
import string
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.losses import in_batch_negative_loss, nway_ce_loss
from ..utils.profiling import span
from .bert import BertConfig, BertModel
from .mapping import TransformerMapping, VisionMapping
from .vit import CLIPVisionModel, ViTConfig

INIT_STD = 0.02  # BERT's initializer_range


@dataclasses.dataclass(frozen=True)
class FLMRModelConfig:
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    dim: int = 128
    vision_dim: int = 768               # CLIP CLS embedding size
    prefix_len: int = 32                # mapping_network_prefix_length
    nway: int = 2
    use_ib_negatives: bool = True
    separate_question_encoder: bool = False
    query_mode: str = "text+vision"     # | "vision_only" | "text_only"
    in_graph_vision: bool = False       # encode pixel_values with own ViT
    vit: Optional[ViTConfig] = None
    pad_token_id: int = 0
    interaction: str = "colbert"        # | "flipr" (PreFLMR)
    flipr_query_part_len: int = 0       # text-token count (question part)
    flipr_k1: int = 0                   # top-k1 over the question part
    flipr_k2: int = 0                   # top-k2 over the context part
    multimodal_docs: bool = False       # doc = text | projected vision
    doc_prefix_len: int = 8             # vision tokens per doc image
    # PreFLMR transformer mapping network: one extra text-conditioned
    # late-interaction token per vision patch
    use_transformer_mapping: bool = False
    transformer_mapping_num_layers: int = 1
    transformer_mapping_hidden: int = 768
    transformer_mapping_num_heads: int = 12
    vision_patch_dim: Optional[int] = None  # patch features (vision_dim)
    # in-batch-negative loss knobs (ops.losses): ib_block_n > 0 scores the
    # (B x B*nway) grid in doc blocks, each recomputed in the backward;
    # ib_score_bf16 casts both operands of that product to bf16
    ib_block_n: int = 0
    ib_score_bf16: bool = False

    @staticmethod
    def tiny(**kw) -> "FLMRModelConfig":
        base = dict(bert=BertConfig.tiny(), dim=16, vision_dim=24,
                    prefix_len=4)
        base.update(kw)
        return FLMRModelConfig(**base)


@torch.no_grad()
def init_normal_(model: nn.Module, generator: torch.Generator) -> None:
    """Random init of a model's modules in order from `generator` (a CPU
    generator, so one seed gives the same weights on every device): N(0,
    0.02) weights, embeddings and a ViT's class and position embeddings,
    zero biases, unit LayerNorm scales."""
    for module in model.modules():
        if isinstance(module, CLIPVisionModel):
            for p in (module.class_embedding, module.position_embedding):
                p.copy_(torch.randn(p.shape, generator=generator) * INIT_STD)
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, (nn.Linear, nn.Embedding)):
            w = torch.randn(module.weight.shape, generator=generator)
            module.weight.copy_(w * INIT_STD)
            if getattr(module, "bias", None) is not None:
                module.bias.zero_()


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """Rows whose squared norm is below `eps` become exactly zero; others
    are divided by their norm (the JAX package's formula, not
    F.normalize's max(norm, eps))."""
    sq = (x * x).sum(dim=dim, keepdim=True)
    is_zero = sq < eps
    out = x * torch.rsqrt(torch.where(is_zero, torch.ones_like(sq), sq))
    return torch.where(is_zero, torch.zeros_like(out), out)


def punctuation_skiplist_ids(tokenizer) -> list[int]:
    """Token ids of punctuation symbols (ColBERT skiplist,
    colbert.py:38-41)."""
    ids = set()
    for symbol in string.punctuation:
        enc = tokenizer.encode(symbol, add_special_tokens=False)
        if enc:
            ids.add(enc[0])
    return sorted(ids)


def skiplist_mask(input_ids: torch.Tensor, skip_ids: Optional[Sequence[int]],
                  pad_token_id: int = 0) -> torch.Tensor:
    """(B, T) -> float mask: 0 on pads and skiplisted (punctuation) tokens."""
    keep = input_ids != pad_token_id
    if skip_ids is not None and len(skip_ids) > 0:
        skip = torch.as_tensor(list(skip_ids), dtype=input_ids.dtype,
                               device=input_ids.device)
        keep &= ~torch.isin(input_ids, skip)
    return keep.float()


class FLMRRetriever(nn.Module):
    # the data-parallel process group whose ranks' docs join the in-batch
    # negatives (set by a data-parallel executor; ops.losses)
    negatives_group = None

    def __init__(self, cfg: FLMRModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.doc_encoder = BertModel(cfg.bert, device=device)
        if cfg.separate_question_encoder:
            self.query_encoder = BertModel(cfg.bert, device=device)
        self.linear = nn.Linear(cfg.bert.hidden_size, cfg.dim, bias=False,
                                device=device)
        if cfg.query_mode not in ("text+vision", "text_only", "vision_only"):
            raise ValueError(f"unknown query_mode {cfg.query_mode!r}")
        if cfg.query_mode != "text_only":
            self.vision_projection = VisionMapping(
                vision_dim=cfg.vision_dim, lm_dim=cfg.dim,
                prefix_len=cfg.prefix_len, device=device)
        if cfg.multimodal_docs:
            self.doc_vision_projection = VisionMapping(
                vision_dim=cfg.vision_dim, lm_dim=cfg.dim,
                prefix_len=cfg.doc_prefix_len, device=device)
        if cfg.use_transformer_mapping:
            if cfg.query_mode != "text+vision":
                raise ValueError("the transformer mapping cross-attends to "
                                 "the text: it needs query_mode "
                                 "'text+vision'")
            h = cfg.transformer_mapping_hidden
            self.transformer_mapping = TransformerMapping(
                vision_dim=cfg.vision_patch_dim or cfg.vision_dim,
                text_dim=cfg.bert.hidden_size, hidden_size=h, lm_dim=cfg.dim,
                num_layers=cfg.transformer_mapping_num_layers,
                num_heads=cfg.transformer_mapping_num_heads,
                intermediate_size=4 * h, device=device)
        if cfg.in_graph_vision:
            if cfg.vit is None:
                raise ValueError("in_graph_vision needs a vit config")
            self.vision_model = CLIPVisionModel(cfg.vit, device=device)

    @property
    def query_bert(self) -> BertModel:
        return (self.query_encoder if self.cfg.separate_question_encoder
                else self.doc_encoder)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init from `generator` (init_normal_)."""
        init_normal_(self, generator)

    def encode_images(self, pixel_values: torch.Tensor,
                      deterministic: bool = True,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """(B, H, W, 3) or (B, n_roi, H, W, 3) pixels -> the ViT's pooled
        features (B[, n_roi], vision_dim)."""
        if pixel_values.dim() == 5:
            b, n_roi = pixel_values.shape[:2]
            _, pooled = self.vision_model(pixel_values.flatten(0, 1),
                                          deterministic, generator)
            return pooled.reshape(b, n_roi, -1)
        return self.vision_model(pixel_values, deterministic, generator)[1]

    def query(self, input_ids: Optional[torch.Tensor] = None,
              attention_mask: Optional[torch.Tensor] = None,
              image_features: Optional[torch.Tensor] = None,
              pixel_values: Optional[torch.Tensor] = None,
              image_patch_features: Optional[torch.Tensor] = None,
              deterministic: bool = True,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Late-interaction query embeddings, L2-normalized.

        image_features: (B, vision_dim) or (B, n_roi, vision_dim)
        pre-extracted CLS features; or pixel_values (B, H, W, 3) or (B,
        n_roi, H, W, 3) through the in-graph ViT. image_patch_features
        (B, P, patch_dim): the transformer mapping's input; with pixels
        alone it is the ViT's last layer's patch rows (the JAX package's
        choice; the HF PreFLMR release takes the second-to-last layer).
        Returns (B, Lq_total, dim) float32, text | mapping | transformer
        mapping tokens; pad text rows are zero."""
        with span("tower.query"):
            return self._query(input_ids, attention_mask, image_features,
                               pixel_values, image_patch_features,
                               deterministic, generator)

    def _query(self, input_ids, attention_mask, image_features,
               pixel_values, image_patch_features, deterministic,
               generator) -> torch.Tensor:
        cfg = self.cfg
        parts = []
        text_hidden = None
        if cfg.query_mode != "vision_only":
            with span("tower.text"):
                text_hidden = self.query_bert(input_ids, attention_mask,
                                              deterministic=deterministic,
                                              generator=generator)[0]
                q = self.linear(text_hidden)
                # query masking uses an empty skiplist: only pads zeroed
                # (FLMR.py:80)
                parts.append(q * (input_ids != cfg.pad_token_id).to(
                    q.dtype)[..., None])
        if cfg.query_mode != "text_only":
            if image_features is None:
                with span("tower.vit"):
                    if (cfg.use_transformer_mapping
                            and image_patch_features is None
                            and pixel_values.dim() == 4):
                        last_hidden, image_features = self.vision_model(
                            pixel_values, deterministic, generator)
                        image_patch_features = last_hidden[:, 1:]
                    else:
                        image_features = self.encode_images(
                            pixel_values, deterministic, generator)
            with span("tower.mapping"):
                v = self.vision_projection(image_features)
                # (B, prefix, dim) or (B, n_roi, prefix, dim) -> (B, n_v,
                # dim)
                parts.append(v.reshape(v.shape[0], -1, cfg.dim))
                if cfg.use_transformer_mapping:
                    parts.append(self.transformer_mapping(
                        image_patch_features, text_hidden, attention_mask))
        return l2_normalize(torch.cat(parts, dim=1).float())

    def doc(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
            skip_mask: Optional[torch.Tensor] = None,
            doc_image_features: Optional[torch.Tensor] = None,
            deterministic: bool = True,
            generator: Optional[torch.Generator] = None):
        """-> (D (B, Ld[+doc_prefix_len], dim) L2-normalized float32, mask
        (B, Ld[+doc_prefix_len]) float).

        skip_mask: optional precomputed skiplist mask; None zeroes pads.
        doc_image_features (B, vision_dim), with multimodal_docs: projected
        to doc_prefix_len more tokens, each unmasked."""
        with span("tower.doc"):
            return self._doc(input_ids, attention_mask, skip_mask,
                             doc_image_features, deterministic, generator)

    def _doc(self, input_ids, attention_mask, skip_mask, doc_image_features,
             deterministic, generator):
        d = self.linear(self.doc_encoder(input_ids, attention_mask,
                                         deterministic=deterministic,
                                         generator=generator)[0])
        if skip_mask is None:
            skip_mask = (input_ids != self.cfg.pad_token_id).float()
        d = d * skip_mask[..., None].to(d.dtype)
        if self.cfg.multimodal_docs and doc_image_features is not None:
            v = self.doc_vision_projection(doc_image_features)
            v = v.reshape(v.shape[0], -1, self.cfg.dim)
            d = torch.cat([d, v.to(d.dtype)], dim=1)
            skip_mask = torch.cat([skip_mask, torch.ones(
                v.shape[:2], dtype=skip_mask.dtype, device=v.device)], dim=1)
        return l2_normalize(d.float()), skip_mask

    def forward(self, query_input_ids: Optional[torch.Tensor] = None,
                query_attention_mask: Optional[torch.Tensor] = None,
                image_features: Optional[torch.Tensor] = None,
                pixel_values: Optional[torch.Tensor] = None,
                doc_input_ids: Optional[torch.Tensor] = None,
                doc_attention_mask: Optional[torch.Tensor] = None,
                doc_skip_mask: Optional[torch.Tensor] = None,
                doc_image_features: Optional[torch.Tensor] = None,
                image_patch_features: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> dict:
        """Training forward: nway scores and losses, the JAX ``__call__``'s
        arguments in its order. doc_* are grouped per query, row i*nway
        query i's positive (colbert.py:64-113).
        -> {"scores" (B, nway), "loss", "ib_loss"}; ib_loss is 0 without
        in-batch negatives, and loss = nway loss + ib_loss."""
        cfg = self.cfg
        q = self.query(query_input_ids, query_attention_mask, image_features,
                       pixel_values, image_patch_features, deterministic,
                       generator)
        d, d_mask = self.doc(doc_input_ids, doc_attention_mask,
                             doc_skip_mask, doc_image_features,
                             deterministic, generator)
        nway_loss, scores = nway_ce_loss(
            q, d, d_mask, cfg.nway, interaction=cfg.interaction,
            flipr_query_part_len=cfg.flipr_query_part_len,
            flipr_k1=cfg.flipr_k1, flipr_k2=cfg.flipr_k2)
        out = {"scores": scores, "loss": nway_loss,
               "ib_loss": torch.zeros((), device=q.device)}
        if cfg.use_ib_negatives:
            ib, _ = in_batch_negative_loss(
                q, d, d_mask, cfg.nway, block_n=cfg.ib_block_n,
                compute_dtype=torch.bfloat16 if cfg.ib_score_bf16 else None,
                group=self.negatives_group)
            out["ib_loss"] = ib
            out["loss"] = nway_loss + ib
        return out
