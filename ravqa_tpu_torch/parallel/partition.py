"""Freeze flags, cross-rank negatives and the FSDP plan over the port's
parameter names.

Port of ravqa_tpu/parallel/partition.py. trainable_mask (:24-63): the
reference's freeze flags (freeze_colbert_doc_encoder / freeze_mapping_network
/ freeze_question_encoder / freeze_image_encoder, FLMR.py:52-68,
FLMR_executor.py:290-365) become a name -> trainable map without touching
the model. The port's module names follow the Flax tree, so the prefixes
are the JAX package's with "." for "/", but for the generator: the JAX
RagExecutor's tree holds "generator/base" and "generator/lora", the port's
RagModel holds the base as "generator" and the LoRA as "lora", so
freeze_generator_base freezes "generator".

gather_with_local_grads (:66-74) is the reference's detach-and-reinsert
all_gather: only this rank's slot carries gradient. gather_rows is the
differentiable all_gather that data-parallel training uses instead: its
backward sums every rank's gradient of a slot back to the slot's owner,
so the in-batch loss over the gathered docs has the gradient of the
global batch's loss (see executors/base.py). fsdp_sharding (:77-90) is
the JAX package's shape rule, applied to each parameter's Flax layout.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
import torch.distributed as dist
from torch import nn

from .mesh import all_gather, all_reduce, mesh_axis_size

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


def gather_with_local_grads(x: torch.Tensor, group=None) -> torch.Tensor:
    """(b, ...) on each rank -> (world * b, ...), rank-major; only this
    rank's slot carries gradient (the other ranks' rows are detached)."""
    parts = list(all_gather(x, group).unbind(0))
    parts[dist.get_rank(group)] = x
    return torch.cat(parts, 0)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.b = group, x.shape[0]
        return all_gather(x, group).reshape(-1, *x.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        grad = all_reduce(grad.contiguous().clone(), group=ctx.group)
        r = dist.get_rank(ctx.group)
        return grad[r * ctx.b:(r + 1) * ctx.b], None


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """(b, ...) on each rank -> (world * b, ...), rank-major, differentiable:
    the gradient of every rank's slot is summed back to its owner
    (torch.distributed.nn.functional.all_gather's rule, through the host
    where gloo holds CUDA tensors)."""
    return _GatherRows.apply(x, group)


_HEAD_ATTENTION = ("query", "key", "value", "out")


def flax_layout(name: str, p: torch.Tensor, heads: Optional[int] = None):
    """A parameter's shape in the JAX package's Flax tree and, for each of
    its dims, the port tensor's dim it is (None where a Flax dim is a part
    of one port dim that is not a contiguous block of it). A Linear's
    kernel is (in, out); an attention projection's (hidden, heads,
    head_dim), its output's (heads, head_dim, hidden), when `heads` is
    given for it (models.convert.state_dict_to_flax)."""
    parts = name.split(".")
    if p.ndim == 2 and parts[-1] == "weight" and "embeddings" not in \
            parts[-2] and "embedding" not in parts[-2]:
        out_, in_ = p.shape
        if heads and parts[-2] in _HEAD_ATTENTION:
            if parts[-2] == "out":
                return (heads, in_ // heads, out_), (1, None, 0)
            return (in_, heads, out_ // heads), (1, 0, None)
        return (in_, out_), (1, 0)
    return tuple(p.shape), tuple(range(p.ndim))


def fsdp_sharding(model: nn.Module, mesh, axis: str = "data",
                  min_size: int = 2 ** 18,
                  num_heads: Optional[dict] = None) -> dict:
    """{parameter name: the port dim to shard over `axis`, or None to
    replicate}: the JAX rule on the Flax layout (flax_layout) — a
    parameter of fewer than min_size elements stays replicated, a larger
    one shards its largest dim that `axis`'s size divides (the first of
    equal ones), and one with no such dim stays replicated. num_heads:
    {top-level module: attention heads}, as models.convert takes it."""
    n = mesh_axis_size(mesh, axis)
    plan = {}
    for name, p in model.named_parameters():
        if p.numel() < min_size:
            plan[name] = None
            continue
        parts = name.split(".")
        attention = len(parts) > 2 and parts[-3] in ("attention",
                                                     "cross_attention")
        heads = (num_heads or {}).get(parts[0]) if attention else None
        shape, to_port = flax_layout(name, p, heads)
        order = sorted(range(len(shape)), key=lambda d: -shape[d])
        pick = next((d for d in order if shape[d] % n == 0), None)
        plan[name] = None if pick is None else to_port[pick]
    return plan
