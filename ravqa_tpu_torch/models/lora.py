"""LoRA adapters, merged into the weights they adapt.

Port of ravqa_tpu/models/lora.py. The LoRA parameters live apart from the
model, in a dict keyed by the adapted Linear's weight name
({"language_model.decoder.0.self_attn.q.weight": {"lora_a": (in, r),
"lora_b": (r, out)}}), and the effective weight is
W + (alpha / rank) * (A @ B)^T: the JAX package adds (A @ B) reshaped to
its kernel's (in, out...) layout, and an nn.Linear weight is (out, in), so
the merged weight is the JAX merged kernel transposed (models/convert.py
carries both trees across). A target matches as a substring of the
Linear's name with "/" between its parts ("self_attn/q" matches
"language_model/encoder/0/self_attn/q"), as the JAX package matches its
parameter paths.

For training, LoRAParams holds the same dict as parameters of a module
(the RAG executor's model.lora), so the optimizer and autograd see them;
the merge stays the JAX arithmetic, done per call with the merged weights
swapped in (torch.func.functional_call): gradients reach A and B through
W + (alpha / rank) * (A @ B)^T, and none reach W.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch
from torch import nn


def _lora_path(weight_name: str) -> str:
    """"a.b.0.q.weight" -> "a/b/0/q", the form targets match."""
    return "/".join(weight_name.split(".")[:-1])


def init_lora(model: nn.Module, rank: int = 8,
              targets: Sequence[str] = ("q", "v"),
              generator: torch.Generator | None = None) -> dict:
    """LoRA parameters for every Linear of `model` whose name matches a
    target: A ~ N(0, 0.02) of (in, r), B = 0 of (r, out), on the Linear's
    device, drawn from `generator` (a CPU generator; seed 0 when None) in
    the order of model.named_modules()."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    lora = {}
    for name, m in model.named_modules():
        if not isinstance(m, nn.Linear):
            continue
        key = f"{name}.weight"
        if not any(t in _lora_path(key) for t in targets):
            continue
        w = m.weight
        a = torch.randn(m.in_features, rank, generator=generator) * 0.02
        lora[key] = {"lora_a": a.to(w.device, w.dtype),
                     "lora_b": torch.zeros(rank, m.out_features,
                                           dtype=w.dtype, device=w.device)}
    return lora


class LoRAParams(nn.Module):
    """A LoRA dict as parameters: one child per adapted weight, named by
    the weight's name with "/" for "." (a module name holds no "."), with
    the parameters lora_a and lora_b. entries() gives the dict back, its
    tensors the parameters themselves."""

    def __init__(self, lora: Mapping):
        super().__init__()
        self.adapters = nn.ModuleDict()
        for name, entry in lora.items():
            m = nn.Module()
            m.lora_a = nn.Parameter(entry["lora_a"])
            m.lora_b = nn.Parameter(entry["lora_b"])
            self.adapters[name.replace(".", "/")] = m

    def entries(self) -> dict:
        return {key.replace("/", "."): {"lora_a": m.lora_a,
                                        "lora_b": m.lora_b}
                for key, m in self.adapters.items()}


def lora_delta(entry: Mapping, alpha: float, rank: int) -> torch.Tensor:
    """The (out, in) update (alpha / rank) * (A @ B)^T of one weight."""
    return (entry["lora_a"] @ entry["lora_b"]).T * (alpha / rank)


def merge_lora(params: Mapping[str, torch.Tensor], lora: Mapping,
               alpha: float = 32.0, rank: int = 8) -> dict:
    """W_eff = W + (alpha / rank) * (A @ B)^T for each adapted weight.
    params: name -> tensor (a state_dict or dict(named_parameters())).
    Returns a new dict; the other entries are the same tensors."""
    out = dict(params)
    for name, entry in lora.items():
        w = params[name]
        out[name] = w + lora_delta(entry, alpha, rank).to(w.dtype)
    return out


def count_lora_params(lora: Mapping) -> int:
    return sum(t.numel() for entry in lora.values() for t in entry.values())
