"""Freeze flags over the port's parameter names.

Port of trainable_mask from ravqa_tpu/parallel/partition.py (:24-63): the
reference's freeze flags (freeze_colbert_doc_encoder / freeze_mapping_network
/ freeze_question_encoder / freeze_image_encoder, FLMR.py:52-68,
FLMR_executor.py:290-365) become a name -> trainable map without touching
the model. The port's module names follow the Flax tree, so the prefixes
are the JAX package's with "." for "/", but for the generator: the JAX
RagExecutor's tree holds "generator/base" and "generator/lora", the port's
RagModel holds the base as "generator" and the LoRA as "lora", so
freeze_generator_base freezes "generator". gather_with_local_grads and FSDP
come with data parallelism (ROADMAP.md A4).
"""

from __future__ import annotations

from typing import Iterable

from torch import nn

# module flag -> the parameter-name prefixes it freezes
FREEZE_FLAG_PREFIXES = {
    "freeze_colbert_doc_encoder": ("doc_encoder", "linear"),
    "freeze_question_encoder": ("query_encoder",),
    "freeze_mapping_network": ("vision_projection",),
    "freeze_image_encoder": ("vision_model",),
    "freeze_generator_base": ("generator",),
}


def trainable_mask(model: nn.Module, modules: Iterable[str]
                   ) -> dict[str, bool]:
    """{parameter name: trainable} over model.named_parameters(), honouring
    the freeze flags in `modules`. A prefix matches at any "."-aligned
    boundary of a name, not only at its start (a retriever nested under
    "retriever." is frozen by the same flags)."""
    modules = set(modules)
    frozen = [tuple(p.split(".")) for flag, prefixes in
              FREEZE_FLAG_PREFIXES.items() if flag in modules
              for p in prefixes]

    def trainable(name: str) -> bool:
        parts = tuple(name.split("."))
        return not any(parts[s:s + len(pre)] == pre for pre in frozen
                       for s in range(len(parts) - len(pre) + 1))

    return {name: trainable(name) for name, _ in model.named_parameters()}
