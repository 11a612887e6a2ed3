"""FLMR / PreFLMR checkpoint key mappings: the reference's HF layouts to
the port's state_dict and back.

Port of ravqa_tpu/models/convert_flmr.py. The JAX package maps the same
keys into its Flax tree; the port keeps PyTorch's (out, in) weights, so
its mappings only rename keys (the attention heads stay fused).

Layouts (SURVEY.md §5 checkpoint formats):
- FLMR interchange (HF_ColBERT): a BertPreTrainedModel state dict with
  `bert.*` and `linear.weight`, plus side files `vision_projection.pt`
  (the Tanh-MLP, nn.Sequential keys `model.0.*`, `model.2.*`),
  optionally `doc_vision_projection.pt` and a `query_encoder` copy for
  separate_question_encoder runs;
- the PreFLMR release (FLMRModelForRetrieval):
  `context_text_encoder.bert_model.*`, `context_text_encoder_linear.*`,
  `query_text_encoder.bert_model.*`, `vision_projection.model.*` and the
  transformer mapping's `transformer_mapping_input_linear.*`,
  `transformer_mapping_network.layer.{i}.*` (a BERT decoder layer with
  cross-attention), `transformer_mapping_output_linear.*`.

Values may be torch tensors or numpy arrays; the results are float32 CPU
tensors under the port's key names (models/flmr.py).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .flmr import FLMRModelConfig


def _t(v) -> torch.Tensor:
    a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)
    return torch.tensor(a.astype(np.float32))


# HF BertLayer / the mapping's decoder layer -> the port's module names
_BERT_LAYER = {"attention.self.query": "attention.query",
               "attention.self.key": "attention.key",
               "attention.self.value": "attention.value",
               "attention.output.dense": "attention.out",
               "attention.output.LayerNorm": "ln1",
               "intermediate.dense": "mlp.fc1",
               "output.dense": "mlp.fc2",
               "output.LayerNorm": "ln2"}
_MAPPING_LAYER = {"attention.self.query": "attention.query",
                  "attention.self.key": "attention.key",
                  "attention.self.value": "attention.value",
                  "attention.output.dense": "attention.out",
                  "attention.output.LayerNorm": "ln_self",
                  "crossattention.self.query": "cross_attention.query",
                  "crossattention.self.key": "cross_attention.key",
                  "crossattention.self.value": "cross_attention.value",
                  "crossattention.output.dense": "cross_attention.out",
                  "crossattention.output.LayerNorm": "ln_cross",
                  "intermediate.dense": "mlp.fc1",
                  "output.dense": "mlp.fc2",
                  "output.LayerNorm": "ln_out"}
_BERT_TOP = {"embeddings.word_embeddings": "word_embeddings",
             "embeddings.position_embeddings": "position_embeddings",
             "embeddings.token_type_embeddings": "token_type_embeddings",
             "embeddings.LayerNorm": "embeddings_ln",
             "pooler.dense": "pooler"}


def _bert_names(num_layers: int) -> dict[str, str]:
    """HF BertModel module names -> the port's BertModel names."""
    names = dict(_BERT_TOP)
    for i in range(num_layers):
        for hf, ours in _BERT_LAYER.items():
            names[f"encoder.layer.{i}.{hf}"] = f"encoder.layers.{i}.{ours}"
    return names


def _mapping_names(num_layers: int) -> dict[str, str]:
    """The companion repo's transformer-mapping names (after the prefix)
    -> the port's TransformerMapping names."""
    names = {"input_linear": "input_linear", "output_linear": "output_linear"}
    for i in range(num_layers):
        for hf, ours in _MAPPING_LAYER.items():
            names[f"network.layer.{i}.{hf}"] = f"layers.{i}.{ours}"
    return names


def _rename(sd: dict, names: dict[str, str], src: str = "",
            dst: str = "") -> dict:
    """{dst + ours + leaf: sd[src + hf + leaf]} for every (hf, ours): the
    weight (a KeyError when missing) and the bias where there is one (an
    embedding has none)."""
    out = {}
    for hf, ours in names.items():
        out[f"{dst}{ours}.weight"] = _t(sd[f"{src}{hf}.weight"])
        if f"{src}{hf}.bias" in sd:
            out[f"{dst}{ours}.bias"] = _t(sd[f"{src}{hf}.bias"])
    return out


def convert_hf_bert_params(sd: dict, num_layers: int,
                           prefix: str = "bert.") -> dict:
    """HF BertModel weights under `prefix` -> the port's BertModel
    state_dict."""
    return _rename(sd, _bert_names(num_layers), src=prefix)


def convert_mlp_params(sd: dict, prefix: str = "model.") -> dict:
    """Torch nn.Sequential MLP (Linear, Tanh, Linear) -> VisionMapping's
    state_dict (mlp.dense.<i>.*)."""
    out = {}
    i = layer = 0
    while f"{prefix}{i}.weight" in sd:
        out[f"mlp.dense.{layer}.weight"] = _t(sd[f"{prefix}{i}.weight"])
        out[f"mlp.dense.{layer}.bias"] = _t(sd[f"{prefix}{i}.bias"])
        layer += 1
        i += 2  # skip activation modules
    return out


def convert_transformer_mapping_params(
        sd: dict, num_layers: int,
        prefix: str = "transformer_mapping_") -> dict:
    """The PreFLMR transformer mapping's weights -> TransformerMapping's
    state_dict."""
    return _rename(sd, _mapping_names(num_layers), src=prefix)


def export_transformer_mapping_params(
        state_dict: dict, prefix: str = "transformer_mapping_") -> dict:
    """The reverse of convert_transformer_mapping_params: TransformerMapping
    weights -> the companion repo's state-dict layout (float32 tensors)."""
    n = 0
    while f"layers.{n}.ln_out.weight" in state_dict:
        n += 1
    inverse = {ours: hf for hf, ours in _mapping_names(n).items()}
    return _rename(state_dict, inverse, dst=prefix)


def _prefixed(sd: dict, prefix: str) -> dict:
    return {f"{prefix}{k}": v for k, v in sd.items()}


def convert_hf_flmr_params(
    colbert_sd: dict,
    cfg: FLMRModelConfig,
    vision_projection_sd: Optional[dict] = None,
    query_encoder_sd: Optional[dict] = None,
    doc_vision_projection_sd: Optional[dict] = None,
) -> dict:
    """The reference FLMR checkpoint (HF_ColBERT state dict and side files)
    -> FLMRRetriever's state_dict. A separate question encoder without its
    own state dict starts as a copy of the doc encoder."""
    n = cfg.bert.num_layers
    sd = _prefixed(convert_hf_bert_params(colbert_sd, n), "doc_encoder.")
    sd["linear.weight"] = _t(colbert_sd["linear.weight"])
    if vision_projection_sd is not None:
        sd.update(_prefixed(convert_mlp_params(vision_projection_sd),
                            "vision_projection."))
    if doc_vision_projection_sd is not None:
        # doc_vision_projection.pt side file (base_colbert.py:49-58)
        sd.update(_prefixed(convert_mlp_params(doc_vision_projection_sd),
                            "doc_vision_projection."))
    if cfg.separate_question_encoder:
        sd.update(_prefixed(convert_hf_bert_params(
            query_encoder_sd or colbert_sd, n), "query_encoder."))
    return sd


def convert_preflmr_params(sd: dict, cfg: FLMRModelConfig) -> dict:
    """The PreFLMR HF release's state dict (FLMRModelForRetrieval) ->
    FLMRRetriever's state_dict (the parts it holds; the ViT comes from
    vit.convert_hf_clip_vision_params)."""
    n = cfg.bert.num_layers
    out = _prefixed(convert_hf_bert_params(
        sd, n, prefix="context_text_encoder.bert_model."), "doc_encoder.")
    out["linear.weight"] = _t(sd["context_text_encoder_linear.weight"])
    if any(k.startswith("vision_projection.model.") for k in sd):
        out.update(_prefixed(convert_mlp_params(
            sd, prefix="vision_projection.model."), "vision_projection."))
    if cfg.separate_question_encoder and any(
            k.startswith("query_text_encoder.") for k in sd):
        out.update(_prefixed(convert_hf_bert_params(
            sd, n, prefix="query_text_encoder.bert_model."),
            "query_encoder."))
    if cfg.use_transformer_mapping and any(
            k.startswith("transformer_mapping_input_linear") for k in sd):
        out.update(_prefixed(convert_transformer_mapping_params(
            sd, cfg.transformer_mapping_num_layers), "transformer_mapping."))
    return out


def export_flmr_to_hf_format(state_dict: dict, cfg: FLMRModelConfig,
                             save_dir: str) -> None:
    """The reverse: FLMRRetriever's state_dict -> the reference's HF
    interchange layout (save_HF_model, FLMR_executor.py:1021-1032):
    `pytorch_model.bin` with bert.* and linear.weight,
    `vision_projection.pt` (the Tanh-MLP's model.0 / model.2) and, with a
    separate question encoder, `query_encoder_pytorch_model.bin`."""
    inverse = {ours: hf for hf, ours in
               _bert_names(cfg.bert.num_layers).items()}

    def bert(tower: str) -> dict:
        sub = {k[len(tower):]: v for k, v in state_dict.items()
               if k.startswith(tower)}
        return _rename(sub, inverse, dst="bert.")

    os.makedirs(save_dir, exist_ok=True)
    sd = bert("doc_encoder.")
    sd["linear.weight"] = _t(state_dict["linear.weight"])
    torch.save(sd, os.path.join(save_dir, "pytorch_model.bin"))
    if "vision_projection.mlp.dense.0.weight" in state_dict:
        vp = {}
        for layer, torch_idx in ((0, 0), (1, 2)):
            for leaf in ("weight", "bias"):
                key = f"vision_projection.mlp.dense.{layer}.{leaf}"
                if key in state_dict:
                    vp[f"model.{torch_idx}.{leaf}"] = _t(state_dict[key])
        torch.save(vp, os.path.join(save_dir, "vision_projection.pt"))
    if any(k.startswith("query_encoder.") for k in state_dict):
        torch.save(bert("query_encoder."),
                   os.path.join(save_dir, "query_encoder_pytorch_model.bin"))
