"""The optimizer's state as the JAX package's optax state tree.

The JAX package checkpoints ``flax.serialization.to_state_dict`` of the
optax state that its make_optimizer builds (ravqa_tpu/executors/base.py):
nested str-keyed dicts, a tuple's elements under "0", "1", ..., and the
stateless nodes (EmptyState, MaskedNode) as empty dicts. For the chain it
builds, inside out:

- AdamW: ``{"0": {"count", "mu", "nu"}, "1": {}, "2": sched}``: mu and nu
  are params trees, count an int32 scalar; sched is ``{"count"}`` when
  the learning rate is a schedule, else ``{}``;
- parameter groups (mapping_lr / retriever_lr): ``{"inner_states":
  {group: {"inner_state": <AdamW>}}}`` for "base" and each group set;
  a group's mu and nu hold ``{}`` at the other groups' leaves;
- grad_clip: ``{"0": {}, "1": <the rest>}``;
- accumulate_grad_batches > 1: ``{"mini_step", "gradient_step",
  "inner_opt_state": <the rest>, "acc_grads": <params tree>,
  "skip_state": {}}``;
- freeze flags that freeze a parameter: ``{"0": {"inner_state": {}}, "1":
  {"inner_state": <the rest>}}``, and ``{}`` at every frozen leaf of every
  params tree.

The port's Optimizer keeps the same numbers: Adam's count and the
schedule's are its `updates`, mini_step its `micro`, gradient_step its
`updates`, acc_grads its `acc`, mu and nu torch AdamW's exp_avg and
exp_avg_sq (zero for a trainable parameter that has not stepped, where
torch has no state yet). to_optax_tree and load_optax_tree carry them
through an executor's params-tree mapper, the one its params.msgpack goes
through (kernels transposed, attention kernels split by head), so every
moment lands on the parameter it belongs to.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np
import torch

from ..models.convert import FieldDict


def _groups(cfg) -> list[str]:
    out = ["base"]
    if cfg.mapping_lr is not None:
        out.append("mapping")
    if cfg.retriever_lr is not None:
        out.append("retriever")
    return out


def _scheduled(cfg) -> bool:
    """Whether make_schedule gives optax a schedule (a state with a count)
    rather than a constant."""
    return not (cfg.schedule == "constant" and cfg.warmup_steps <= 0)


def fill_like(template: dict, partial: Mapping) -> dict:
    """`template`'s tree with `partial`'s leaf where it has one and {}
    (optax's MaskedNode) at every other leaf."""
    out = {}
    for k, v in template.items():
        sub = partial.get(k) if isinstance(partial, Mapping) else None
        if isinstance(v, Mapping):
            out[k] = fill_like(v, sub if isinstance(sub, Mapping) else {})
        else:
            out[k] = sub if sub is not None and not isinstance(
                sub, Mapping) else {}
    return out


def moments(opt) -> dict:
    """{"mu", "nu", "acc"}: name -> tensor over opt's trainable parameters
    (zeros where AdamW holds no state yet; "acc" None without
    accumulation)."""
    mu, nu = {}, {}
    state = opt.adamw.state if opt.adamw is not None else {}
    for name, p in zip(opt.names, opt.trainable):
        st = state.get(p, {})
        mu[name] = st.get("exp_avg", None)
        nu[name] = st.get("exp_avg_sq", None)
        if mu[name] is None:
            mu[name] = torch.zeros_like(p)
            nu[name] = torch.zeros_like(p)
    acc = (dict(zip(opt.names, opt.acc)) if opt.acc is not None else None)
    return {"mu": mu, "nu": nu, "acc": acc}


def to_optax_tree(opt, moments: Mapping, to_flax: Callable[[dict], dict],
                  template: dict) -> dict:
    """The flax state dict of make_optimizer's optax state for `opt`.
    moments: the dict `moments(opt)` gives (whole tensors); to_flax: the
    executor's mapper from {parameter name: tensor} to its params tree;
    template: the params tree of every parameter (its structure)."""
    from .base import _group
    cfg = opt.cfg
    count = np.asarray(opt.updates, np.int32)

    def tree(values: Mapping) -> dict:
        return fill_like(template, to_flax(dict(values)))

    def adamw(group: Optional[str]) -> dict:
        names = [n for n in opt.names
                 if group is None or _group(cfg, n) == group]
        return {"0": {"count": count,
                      "mu": tree({n: moments["mu"][n] for n in names}),
                      "nu": tree({n: moments["nu"][n] for n in names})},
                "1": {}, "2": {"count": count} if _scheduled(cfg) else {}}

    if cfg.mapping_lr is not None or cfg.retriever_lr is not None:
        state = {"inner_states": {g: {"inner_state": adamw(g)}
                                  for g in _groups(cfg)}}
    else:
        state = adamw(None)
    if cfg.grad_clip > 0:
        state = {"0": {}, "1": state}
    if cfg.accumulate_grad_batches > 1:
        # MultiStepsState: flax writes a namedtuple in field order
        state = FieldDict(mini_step=np.asarray(opt.micro, np.int32),
                          gradient_step=count, inner_opt_state=state,
                          acc_grads=tree(moments["acc"]), skip_state={})
    if opt.masked:
        state = {"0": {"inner_state": {}}, "1": {"inner_state": state}}
    return state


def _at(tree, *keys):
    node = tree
    for k in keys:
        if not isinstance(node, Mapping) or k not in node:
            raise ValueError(f"opt_state: no {'/'.join(keys)} where this "
                             "train config's optimizer has one (a "
                             "checkpoint of another optimizer config?)")
        node = node[k]
    return node


def _int(a) -> int:
    return int(np.asarray(a).reshape(()))


def load_optax_tree(opt, tree: Mapping,
                    from_flax: Callable[[dict], dict],
                    place: Callable[[torch.Tensor, torch.Tensor],
                                    torch.Tensor]) -> None:
    """Set `opt` to the optax state `tree` (to_optax_tree's form, as the
    JAX package checkpoints it). from_flax: the executor's mapper from a
    params tree to {parameter name: tensor} (leaves {} dropped); place(t,
    p): t as parameter p holds it (device, dtype, FSDP shard). Raises
    ValueError where the tree does not fit this optimizer."""
    from .base import _group
    cfg = opt.cfg
    names = set(opt.names)
    if opt.masked:
        tree = _at(tree, "1", "inner_state")
    micro, acc = 0, None
    if cfg.accumulate_grad_batches > 1:
        micro = _int(_at(tree, "mini_step"))
        acc = from_flax(_at(tree, "acc_grads"))
        tree = _at(tree, "inner_opt_state")
    if cfg.grad_clip > 0:
        tree = _at(tree, "1")
    grouped = cfg.mapping_lr is not None or cfg.retriever_lr is not None
    adams = ({g: _at(tree, "inner_states", g, "inner_state", "0")
              for g in _groups(cfg)} if grouped else {None: _at(tree, "0")})
    counts = {_int(_at(a, "count")) for a in adams.values()}
    if len(counts) != 1:
        raise ValueError(f"opt_state: the groups' counts differ {counts}")
    count = counts.pop()
    mu, nu = {}, {}
    for group, a in adams.items():
        for key, out in (("mu", mu), ("nu", nu)):
            got = from_flax(_at(a, key))
            want = {n for n in names
                    if group is None or _group(cfg, n) == group}
            if set(got) != want:
                raise ValueError(
                    f"opt_state {key} ({group or 'all'}): the checkpoint "
                    f"holds {sorted(set(got) - want)[:4]} beyond this "
                    f"optimizer's trainable parameters and lacks "
                    f"{sorted(want - set(got))[:4]}")
            out.update(got)
    if acc is not None and set(acc) != names:
        raise ValueError("opt_state acc_grads: not this optimizer's "
                         "trainable parameters")
    opt.updates, opt.micro = count, micro
    if opt.adamw is not None:
        dtype = (torch.float64 if torch.get_default_dtype() == torch.float64
                 else torch.float32)
        for name, p in zip(opt.names, opt.trainable):
            opt.adamw.state[p] = {
                "step": torch.tensor(float(count), dtype=dtype),
                "exp_avg": place(mu[name], p),
                "exp_avg_sq": place(nu[name], p)}
    if opt.acc is not None:
        with torch.no_grad():
            for name, a, p in zip(opt.names, opt.acc, opt.trainable):
                a.copy_(place(acc[name], p))
