"""Oscar-style image captioner: BERT over [caption | tags | regions].

Port of ravqa_tpu/models/captioner.py (:41-233), the offline Oscar
captioning run (materials/Oscar/oscar/run_captioning.py) that writes the
caption JSON LoadOscarCaptionFeatures reads. The input contract is the
reference CaptionTensorizer's (run_captioning.py:197-320):

- the sequence is [caption: max_seq_a_len] + [tags: max_seq_len -
  max_seq_a_len] + [regions: max_img_seq_len];
- caption -> caption is lower-triangular; tags and regions see each other
  both ways and do not see the caption; the caption sees all real context
  (`caption_attention_mask`);
- segment ids: caption 0, tags 1; region features enter through a linear
  projection with no position or type embedding;
- the LM head is BERT's MLM head with the decoder tied to the word
  embeddings plus a free bias (`mlm_bias`).

The port reuses its BERT pieces (`TransformerEncoder`, post-LN, float32
softmax and LayerNorm). `greedy_caption` keeps the JAX decode: a full
forward per caption slot with the cursor's slot holding [MASK], [SEP]
forced at the last slot, no KV cache, so the tokens are the JAX
package's. Module names follow the Flax tree, so
`models.convert.captioner_to_state_dict` carries a JAX params tree across.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .bert import BertConfig
from .transformer import TransformerEncoder, _layer_norm


@dataclasses.dataclass(frozen=True)
class CaptionerConfig:
    bert: BertConfig = BertConfig()
    img_feature_dim: int = 2054          # VinVL 2048 + 6 box geometry
    max_seq_a_len: int = 40              # caption budget incl [CLS]/[SEP]
    max_seq_len: int = 70                # caption + tags
    max_img_seq_len: int = 50
    use_img_layernorm: bool = False
    cls_token_id: int = 101
    sep_token_id: int = 102
    mask_token_id: int = 103
    pad_token_id: int = 0

    @property
    def total_len(self) -> int:
        return self.max_seq_len + self.max_img_seq_len

    @staticmethod
    def tiny(**kw) -> "CaptionerConfig":
        base = dict(bert=BertConfig.tiny(), img_feature_dim=20,
                    max_seq_a_len=8, max_seq_len=14, max_img_seq_len=6)
        base.update(kw)
        return CaptionerConfig(**base)


def caption_attention_mask(cfg: CaptionerConfig, tag_mask: torch.Tensor,
                           img_mask: torch.Tensor) -> torch.Tensor:
    """The (B, T, T) 0/1 seq2seq mask of CaptionTensorizer
    (run_captioning.py:300-316). tag_mask (B, tags) and img_mask (B, img)
    flag the real (unpadded) tags and regions."""
    a, t = cfg.max_seq_a_len, cfg.total_len
    b = tag_mask.shape[0]
    m = torch.zeros(b, t, t, device=tag_mask.device)
    m[:, :a, :a] = torch.tril(torch.ones(a, a, device=tag_mask.device))
    ctx = torch.cat([tag_mask.float(), img_mask.float()], -1)   # (B, ctx)
    m[:, :a, a:] = ctx[:, None, :]
    m[:, a:, a:] = ctx[:, None, :] * ctx[:, :, None]
    return m


class OscarCaptioner(nn.Module):
    def __init__(self, cfg: CaptionerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        c = cfg.bert
        h = c.hidden_size
        self.word_embeddings = nn.Embedding(c.vocab_size, h, device=device)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings,
                                                h, device=device)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, h,
                                                  device=device)
        self.embeddings_ln = nn.LayerNorm(h, eps=c.layer_norm_eps,
                                          device=device)
        self.img_embedding = nn.Linear(cfg.img_feature_dim, h, device=device)
        if cfg.use_img_layernorm:
            self.img_ln = nn.LayerNorm(h, eps=c.layer_norm_eps,
                                       device=device)
        self.encoder = TransformerEncoder(c.encoder_cfg, device=device)
        self.mlm_dense = nn.Linear(h, h, device=device)
        self.mlm_ln = nn.LayerNorm(h, eps=c.layer_norm_eps, device=device)
        self.mlm_bias = nn.Parameter(torch.zeros(c.vocab_size,
                                                 device=device))

    def forward(self, text_ids, segment_ids, img_feats, attn_mask):
        """text_ids / segment_ids (B, max_seq_len); img_feats (B,
        max_img_seq_len, img_feature_dim); attn_mask (B, T, T). Returns
        (B, T, vocab) logits over the full sequence."""
        s = text_ids.shape[1]
        pos = torch.arange(s, device=text_ids.device)[None, :]
        x = (self.word_embeddings(text_ids) + self.position_embeddings(pos)
             + self.token_type_embeddings(segment_ids))
        x = _layer_norm(self.embeddings_ln, x)
        img = self.img_embedding(img_feats.float())
        if self.cfg.use_img_layernorm:
            img = _layer_norm(self.img_ln, img)
        h = torch.cat([x, img], dim=1)
        bias = (1.0 - attn_mask.float())[:, None] * -1e9
        h = self.encoder(h, bias)
        y = _layer_norm(self.mlm_ln, F.gelu(self.mlm_dense(h),
                                            approximate="none"))
        return y @ self.word_embeddings.weight.T + self.mlm_bias


@torch.no_grad()
def greedy_caption(model: OscarCaptioner, tag_ids, tag_mask, img_feats,
                   img_mask):
    """Masked-LM greedy decode. tag_ids / tag_mask (B, tags); img_feats
    (B, img, D); img_mask (B, img). Returns (token ids (B, max_seq_a_len)
    with [CLS] first and [PAD] after [SEP], lengths incl [CLS]/[SEP]).
    Each slot re-runs the forward with that slot masked (tokens right of
    the cursor are invisible through the triangular mask); no host sync
    between slots."""
    cfg = model.cfg
    a = cfg.max_seq_a_len
    b = tag_ids.shape[0]
    dev = tag_ids.device
    attn = caption_attention_mask(cfg, tag_mask, img_mask)
    segs = torch.cat([torch.zeros(b, a, dtype=torch.long, device=dev),
                      torch.ones(b, cfg.max_seq_len - a, dtype=torch.long,
                                 device=dev)], -1)
    cap = torch.full((b, a), cfg.mask_token_id, dtype=torch.long,
                     device=dev)
    cap[:, 0] = cfg.cls_token_id
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    pad = torch.full((b,), cfg.pad_token_id, dtype=torch.long, device=dev)
    for t in range(1, a):
        text = torch.cat([cap, tag_ids.long()], -1)
        logits = model(text, segs, img_feats, attn)
        tok = logits[:, t].float().argmax(-1)
        if t == a - 1:         # budget exhausted: force the closing [SEP]
            tok = torch.full_like(tok, cfg.sep_token_id)
        tok = torch.where(done, pad, tok)
        cap[:, t] = tok
        done = done | (tok == cfg.sep_token_id)
    return cap, (cap != cfg.pad_token_id).sum(-1)


def decode_captions(token_ids, lengths, id_to_token) -> list[str]:
    """Token ids -> caption strings (wordpiece join, ## merge), skipping
    [CLS]/[SEP]/[PAD]."""
    out = []
    for row, n in zip(np.asarray(token_ids), np.asarray(lengths)):
        words: list[str] = []
        for tid in row[1:int(n)]:
            tok = id_to_token(int(tid))
            if tok in ("[SEP]", "[PAD]", "[CLS]"):
                continue
            if tok.startswith("##") and words:
                words[-1] += tok[2:]
            else:
                words.append(tok)
        out.append(" ".join(words))
    return out


def write_caption_predictions(path: str, captions: dict) -> None:
    """Write the {image_key: [caption, ...]} JSON that
    LoadOscarCaptionFeatures and the reference (vqa_data_ops.py:108-129)
    read."""
    with open(path, "w") as f:
        json.dump({k: v if isinstance(v, list) else [v]
                   for k, v in captions.items()}, f)


def convert_oscar_captioner_params(state_dict: dict, cfg: CaptionerConfig
                                   ) -> dict[str, torch.Tensor]:
    """Oscar BertForImageCaptioning torch state dict -> OscarCaptioner's
    state_dict: the BERT names (HF BERT's under bert.) by
    convert_flmr.convert_hf_bert_params without the pooler, plus
    bert.img_embedding and cls.predictions.* (the decoder weight is tied
    to the word embeddings, so it is not read)."""
    from .convert_flmr import convert_hf_bert_params

    def g(name):
        t = state_dict[name]
        a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t)
        return torch.tensor(a.astype(np.float32))

    sd = {k: v for k, v in convert_hf_bert_params(
        state_dict, cfg.bert.num_layers, prefix="bert.").items()
        if not k.startswith("pooler.")}
    sd["img_embedding.weight"] = g("bert.img_embedding.weight")
    sd["img_embedding.bias"] = g("bert.img_embedding.bias")
    if cfg.use_img_layernorm:
        sd["img_ln.weight"] = g("bert.img_layer_norm.weight")
        sd["img_ln.bias"] = g("bert.img_layer_norm.bias")
    for dst, src in (("mlm_dense", "cls.predictions.transform.dense"),
                     ("mlm_ln", "cls.predictions.transform.LayerNorm")):
        sd[f"{dst}.weight"] = g(f"{src}.weight")
        sd[f"{dst}.bias"] = g(f"{src}.bias")
    sd["mlm_bias"] = g("cls.predictions.bias")
    return sd
