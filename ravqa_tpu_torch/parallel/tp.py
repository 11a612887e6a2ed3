"""Tensor parallelism (Megatron-style) of the transformer towers over a
"model" mesh axis.

Port of ravqa_tpu/parallel/tp.py (:29-63). The JAX package shards each
kernel by its owner module's name and lets GSPMD insert the collectives;
the port plans over its nn.Linear modules of the same names and applies
the plan with torch.distributed.tensor.parallel:

- attention q/k/v (query/key/value) and MLP up-projections (wi, wi_0,
  wi_1, fc1, intermediate_query): column-parallel (JAX shards the Flax
  kernel's dim 1, the output; the torch weight is (out, in), so its dim
  0: ColwiseParallel);
- attention outputs and MLP down-projections (o, out, wo, fc2, output,
  output_query, projection): row-parallel (the kernel's dim 0, the input:
  RowwiseParallel, whose output is all-reduced);
- embeddings, norms, other weights: replicated.

Attention shards whole heads: a projection is sharded only when the model
axis divides its heads (the JAX rule's 3-D kernels shard the heads dim),
else the attention's four projections stay replicated (the JAX rule may
then split a head; the numbers are the same either way). An MLP's pair is
sharded when the axis divides its hidden width.
"""

from __future__ import annotations

from torch import nn

from .mesh import axis_rank, mesh_axis_size

_COLUMN_PARALLEL = {"q", "k", "v", "query", "key", "value", "wi", "wi_0",
                    "wi_1", "fc1", "intermediate_query"}
_ROW_PARALLEL = {"o", "out", "wo", "fc2", "output", "output_query",
                 "projection"}
_ATTENTION_PROJ = {"q", "k", "v", "o", "query", "key", "value", "out"}


def _heads(module: nn.Module):
    """The head count of an attention module (the port's
    MultiHeadAttention and T5Attention), else None."""
    if hasattr(module, "num_heads"):
        return module.num_heads
    cfg = getattr(module, "cfg", None)
    if cfg is not None and hasattr(cfg, "num_heads") \
            and hasattr(module, "relative_attention_bias"):
        return cfg.num_heads
    return None


def tp_sharding(model: nn.Module, mesh, axis: str = "model") -> dict:
    """{nn.Linear module name: "colwise" or "rowwise"} over `axis`; Linear
    modules not named are replicated."""
    n = mesh_axis_size(mesh, axis)
    plan = {}
    for parent_name, parent in model.named_modules():
        heads = _heads(parent)
        for child_name, child in parent.named_children():
            if not isinstance(child, nn.Linear):
                continue
            full = f"{parent_name}.{child_name}" if parent_name \
                else child_name
            col = child_name in _COLUMN_PARALLEL
            row = child_name in _ROW_PARALLEL
            if not (col or row):
                continue
            if heads is not None and child_name in _ATTENTION_PROJ:
                ok = heads % n == 0
            else:
                ok = (child.out_features if col
                      else child.in_features) % n == 0
            if ok:
                plan[full] = "colwise" if col else "rowwise"
    return plan


def apply_tp(model: nn.Module, mesh, axis: str = "model") -> nn.Module:
    """Shard `model` in place by tp_sharding over `axis` (every rank of an
    `axis` group must then feed the same inputs). An attention module with
    sharded projections runs its rank's heads; a T5 attention slices the
    relative position bias to them. Returns the model."""
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   RowwiseParallel,
                                                   parallelize_module)
    plan = tp_sharding(model, mesh, axis)
    if not plan:
        return model
    n = mesh_axis_size(mesh, axis)
    r = axis_rank(mesh, axis)
    for name, module in model.named_modules():
        heads = _heads(module)
        if heads is not None and hasattr(module, "relative_attention_bias") \
                and any(k.startswith(f"{name}.") for k in plan):
            local = heads // n
            module.tp_heads = slice(r * local, (r + 1) * local)
    sub = mesh[axis] if len(mesh.mesh_dim_names) > 1 else mesh
    parallelize_module(model, sub, {
        k: ColwiseParallel() if v == "colwise" else RowwiseParallel()
        for k, v in plan.items()})
    return model
