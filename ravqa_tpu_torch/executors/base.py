"""Training executor core: the train config, the learning-rate schedule,
AdamW with parameter groups, clipping, accumulation and freeze masks,
metric logging, the training loop and checkpoints, on one device or data
parallel over a mesh's "data" axis.

Port of ravqa_tpu/executors/base.py. The JAX package builds
an optax chain (clip_by_global_norm -> adamw, per-group learning rates by
multi_transform, optax.MultiSteps accumulation, masked freezing) and jits
one train step; here ``Optimizer`` does the same arithmetic around
torch.optim.AdamW and ``BaseExecutor.train_step`` runs eagerly:

- the schedule is evaluated at the update count before it advances, so
  update 0 takes lr(0) (0 under warmup), as optax does;
- clipping is optax's: g * max_norm / norm when norm >= max_norm, on the
  averaged grads of an accumulation window;
- with accumulate_grad_batches k, grads are averaged over k micro-steps
  (optax's running mean) and one update is made on the k-th; the schedule
  and Adam's count advance per update only;
- frozen parameters (freeze_* module flags) get no update and no optimizer
  state, and take no grad: the executor sets their requires_grad False,
  so autograd computes no weight grad for a frozen tower (the JAX step
  computes them and masks their updates; the trainable parameters' grads
  and updates are the same either way). A trainable parameter no loss
  term reaches gets a zero grad, as it does under jax.grad, so Adam's
  count and weight decay still apply to it.

Data parallelism (`mesh`, JAX base.py:215-330): one process per rank of
the mesh's "data" axis, every rank given the same global batch.
train_step takes the rank's dim-0 slice (parallel.shard_batch, JAX's
P("data") order) and reports the global loss (the ranks' mean) and the
global grad norm. The model's in-batch negatives span the ranks
(negatives_group; ops.losses), so the step's loss and gradient are those
of JAX's mesh step on the global batch.
- param_sharding "replicated" is DDP: every rank holds the parameters and
  Adam's moments, and after backward one all_reduce of a flat buffer of
  the grads averages them over the ranks;
- "fsdp" is FSDP2's fully_shard: each parameter of at least
  fsdp_min_size elements is sharded on the dim parallel.fsdp_sharding
  picks (the JAX rule), the smaller ones stay replicated (their grads
  all-reduced as under DDP), and Adam's moments shard like their
  parameters (ZeRO-3, JAX :259-267). The grad norm and clipping sum the
  shards' squares over the ranks, so they see whole parameters. Where the
  group is gloo's and the parameters are on the card (ranks sharing one
  GPU), FSDP's all-gather and reduce-scatter go through the host.

A checkpoint is the JAX package's: a directory with params.msgpack,
opt_state.msgpack (make_optimizer's optax state tree, opt_state.py),
rng.msgpack (the threefry key the steps split, utils/prng.py) and
step.json, or with backend "orbax" the JAX package's orbax directory
(orbax_io.py). Each package resumes the other's run where it stopped:
Adam's moments, the schedule's position, an open accumulation window and
the key.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import os
import time
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..models.convert import (flax_to_state_dict, read_flax_msgpack,
                              read_params_tree, save_flax_msgpack,
                              state_dict_to_flax)
from ..models.transformer import MultiHeadAttention
from ..parallel import trainable_mask
from ..parallel.mesh import (all_reduce, axis_group, axis_rank, broadcast,
                             full_tensor, mesh_axis_size, rank_zero,
                             shard_batch)
from ..utils.profiling import clock_mark, span
from ..utils.prng import prng_key, split
from . import orbax_io
from .opt_state import load_optax_tree, moments, to_optax_tree

# a checkpoint directory's params file, in the order load_checkpoint looks
CHECKPOINT_FILES = ("params.msgpack", "params.npz")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-5
    mapping_lr: Optional[float] = None     # separate LR for mapping network
    retriever_lr: Optional[float] = None   # separate LR for the retriever
    #   in joint RAG training (reference RAG_BLIP2_with_FLMR: lr 6e-4 for
    #   the generator, retriever_lr 1e-4)
    weight_decay: float = 0.0
    warmup_steps: int = 0
    total_steps: int = 10000
    schedule: str = "constant"             # constant | linear | cosine
    grad_clip: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    modules: tuple = ()                    # feature-flag bus incl. freeze_*
    accumulate_grad_batches: int = 1       # reference accumulate_grad_batches


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over `steps` updates, then end."""
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        c = min(max(count, 0), steps)
        return (init - end) * (1 - c / steps) + end
    return schedule


def _join(first, second, boundary: int) -> Callable[[int], float]:
    """optax.join_schedules of two schedules at one boundary."""
    return lambda count: (first(count) if count < boundary
                          else second(count - boundary))


def _warmup_cosine(init: float, peak: float, warmup: int,
                   decay_steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule with end value 0."""
    steps = decay_steps - warmup
    if not steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={steps}.")

    def cosine(count: int) -> float:
        c = min(count, steps)
        return peak * 0.5 * (1 + math.cos(math.pi * c / steps))
    return _join(_linear(init, peak, warmup), cosine, warmup)


def make_schedule(cfg: TrainConfig, lr: float) -> Callable[[int], float]:
    """update count -> learning rate, optax's value at each update.
    total_steps and warmup_steps count micro-batches; with accumulation the
    schedule advances once per update, so both are rescaled: ceil for the
    total, and a nonzero warmup keeps at least one update."""
    accum = max(cfg.accumulate_grad_batches, 1)
    total = max(-(-cfg.total_steps // accum), 1)
    warmup = max(cfg.warmup_steps // accum, 1) if cfg.warmup_steps > 0 else 0
    if cfg.schedule == "constant":
        if warmup > 0:
            return _linear(0.0, lr, warmup)
        return lambda count: lr
    if cfg.schedule == "linear":
        # warmup, then linear decay to 0 (HF
        # get_linear_schedule_with_warmup)
        decay = _linear(lr, 0.0, max(total - warmup, 1))
        if warmup > 0:
            return _join(_linear(0.0, lr, warmup), decay, warmup)
        return decay
    if cfg.schedule == "cosine":
        return _warmup_cosine(0.0, lr, max(warmup, 1), total)
    raise ValueError(cfg.schedule)


def _is_sharded(t: torch.Tensor) -> bool:
    from torch.distributed.tensor import DTensor, Shard
    return isinstance(t, DTensor) and any(isinstance(p, Shard)
                                          for p in t.placements)


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every element squared (optax.global_norm). FSDP's
    sharded grads (DTensors) count whole: their shards' squares are summed
    over the ranks."""
    tensors = list(tensors)
    sharded = [t for t in tensors if _is_sharded(t)]
    total = sum(_local(t).float().square().sum() for t in tensors
                if not _is_sharded(t))
    if sharded:
        part = sum(t.to_local().float().square().sum() for t in sharded)
        part = all_reduce(part.detach().clone().reshape(1),
                          group=sharded[0].device_mesh.get_group())[0]
        total = total + part
    return torch.sqrt(torch.as_tensor(total))


def _group(cfg: TrainConfig, name: str) -> str:
    """The learning-rate group of a parameter, as make_optimizer's labels
    in the JAX package: the mapping network (within the first two name
    parts), else the RAG executor's retriever, else the base rate."""
    parts = name.split(".")
    if cfg.mapping_lr is not None and "vision_projection" in parts[:2]:
        return "mapping"
    if cfg.retriever_lr is not None and parts[0] == "retriever":
        return "retriever"
    return "base"


class Optimizer:
    """make_optimizer's transformation over a module's parameters: AdamW
    with the mapping-network and retriever learning-rate groups, global-norm
    clipping, gradient accumulation and freeze masks. step() reads the
    trainable parameters' .grad."""

    def __init__(self, cfg: TrainConfig, model: nn.Module):
        self.cfg = cfg
        mask = trainable_mask(model, cfg.modules)
        # JAX masks the chain only where a flag freezes a parameter
        self.masked = not all(mask.values())
        groups: dict[str, list] = {}
        for name, p in model.named_parameters():
            if mask[name]:
                groups.setdefault(_group(cfg, name), []).append((name, p))
        lrs = {"base": cfg.lr, "mapping": cfg.mapping_lr,
               "retriever": cfg.retriever_lr}
        order = [g for g in ("base", "mapping", "retriever") if g in groups]
        self.names = [n for g in order for n, _ in groups[g]]
        self.trainable = [p for g in order for _, p in groups[g]]
        self.schedules = [make_schedule(cfg, lrs[g]) for g in order]
        self.adamw = None
        if self.trainable:
            # FSDP's sharded (DTensor) parameters beside replicated plain
            # ones: the multi-tensor (foreach) update refuses the mix
            mixed = any(_is_sharded(p) for p in self.trainable)
            self.adamw = torch.optim.AdamW(
                [{"params": [p for _, p in groups[g]], "lr": 0.0}
                 for g in order],
                betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps,
                weight_decay=cfg.weight_decay,
                **({"foreach": False} if mixed else {}))
        self.every = max(cfg.accumulate_grad_batches, 1)
        self.micro = 0       # micro-steps in the open accumulation window
        self.updates = 0     # updates made: the schedule's and Adam's count
        self.acc = ([torch.zeros_like(p) for p in self.trainable]
                    if self.every > 1 else None)

    def step(self) -> bool:
        """Take one micro-step's grads; update on the window's last one.
        Returns whether the parameters were updated."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.trainable]
        if self.acc is not None:
            for a, g in zip(self.acc, grads):        # optax's running mean
                a.add_((g - a) / (self.micro + 1))
            self.micro += 1
            if self.micro < self.every:
                return False
            self.micro = 0
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
        if self.cfg.grad_clip > 0 and grads:
            norm = global_norm(grads)
            keep = norm < self.cfg.grad_clip
            if any(_is_sharded(g) for g in grads):
                # DTensor arithmetic takes Python scalars, not tensors
                if not bool(keep):
                    c = float(self.cfg.grad_clip)
                    grads = [g / float(norm) * c for g in grads]
            else:
                grads = [torch.where(keep, g, g / norm * self.cfg.grad_clip)
                         for g in grads]
        if self.adamw is not None:
            for p, g in zip(self.trainable, grads):
                p.grad = g
            for group, schedule in zip(self.adamw.param_groups,
                                       self.schedules):
                group["lr"] = schedule(self.updates)
            self.adamw.step()
        self.updates += 1
        return True


def make_optimizer(cfg: TrainConfig, model: nn.Module) -> Optimizer:
    """AdamW with optional grad clip, a separate mapping-network LR
    (reference FLMR_executor.py:290-365 param groups), accumulation and
    freeze-flag masking."""
    return Optimizer(cfg, model)


class MetricsLogger:
    """Metrics history with selectable backends: "jsonl" (metrics.jsonl
    under log_dir), "tensorboard" (tensorboardX under log_dir/tb) and
    "wandb"; the last two warn and are skipped when their package is
    absent. The in-memory `history` list is always kept."""

    def __init__(self, log_dir: Optional[str] = None, quiet: bool = False,
                 backends: Sequence[str] = ("jsonl",),
                 wandb_kwargs: Optional[dict] = None):
        self.log_dir = log_dir
        self.quiet = quiet
        self.history: list[dict] = []
        self._f = None
        self._tb = None
        self._wandb_run = None
        if log_dir and "jsonl" in backends:
            os.makedirs(log_dir, exist_ok=True)
            self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        if log_dir and "tensorboard" in backends:
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(os.path.join(log_dir, "tb"))
            except Exception as e:  # pragma: no cover
                import logging
                logging.getLogger(__name__).warning(
                    "tensorboard backend unavailable: %s", e)
        if "wandb" in backends:  # pragma: no cover - wandb not installed
            try:
                import wandb
                self._wandb_run = wandb.init(
                    dir=log_dir, **(wandb_kwargs or {}))
            except Exception as e:
                import logging
                logging.getLogger(__name__).warning(
                    "wandb backend unavailable: %s", e)

    def log(self, metrics: dict, step: int, prefix: str = ""):
        rec = {("%s%s" % (prefix, k)): (float(v) if np.isscalar(v)
                                        or hasattr(v, "item") else v)
               for k, v in metrics.items()}
        rec["step"] = int(step)
        rec["time"] = time.time()
        self.history.append(rec)
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k in ("step", "time") or not isinstance(v, float):
                    continue
                self._tb.add_scalar(k, v, int(step))
            self._tb.flush()
        if self._wandb_run is not None:  # pragma: no cover
            self._wandb_run.log(
                {k: v for k, v in rec.items() if k != "time"}, step=step)
        if not self.quiet:
            short = {k: (round(v, 5) if isinstance(v, float) else v)
                     for k, v in rec.items() if k not in ("time",)}
            print(f"[metrics] {short}", flush=True)


def _num_heads(model: nn.Module) -> dict[str, int]:
    """The attention heads of each top-level module that has attention
    (the Flax tree splits attention kernels by head; a ViT's count may
    differ from the text towers')."""
    out = {}
    for name, child in model.named_children():
        heads = {m.num_heads for m in child.modules()
                 if isinstance(m, MultiHeadAttention)}
        if len(heads) > 1:
            raise ValueError(f"{name}: layers with different head counts "
                             f"{heads}")
        if heads:
            out[name] = heads.pop()
    return out


def _full_tensors(obj):
    """A state tree with each DTensor gathered whole (a collective)."""
    from torch.distributed.tensor import DTensor
    if isinstance(obj, DTensor):
        return full_tensor(obj)
    if isinstance(obj, dict):
        return {k: _full_tensors(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_full_tensors(v) for v in obj)
    return obj


def _shard_as(full, like):
    """A whole tensor as `like` holds it: this rank's shard of a sharded
    DTensor (the even chunk FSDP keeps), else unchanged."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(like, DTensor) or not isinstance(full, torch.Tensor) \
            or full.shape != like.shape:
        return full
    local = full
    for mesh_dim, pl in enumerate(like.placements):
        if isinstance(pl, Shard):
            n = like.device_mesh.size(mesh_dim)
            r = like.device_mesh.get_local_rank(mesh_dim)
            local = local.chunk(n, pl.dim)[r]
    return DTensor.from_local(local.contiguous(), like.device_mesh,
                              like.placements, run_check=False)


def _load_full(model: nn.Module, state: dict) -> None:
    """load_state_dict(strict) of whole tensors, into FSDP's shards where
    the model is sharded."""
    from torch.distributed.tensor import DTensor
    own = model.state_dict()
    if set(own) != set(state) or not any(isinstance(t, DTensor)
                                         for t in own.values()):
        model.load_state_dict(state, strict=True)
        return
    with torch.no_grad():
        for k, t in own.items():
            if tuple(state[k].shape) != tuple(t.shape):
                raise ValueError(f"{k}: checkpoint shape "
                                 f"{tuple(state[k].shape)}, model "
                                 f"{tuple(t.shape)}")
            src = _shard_as(state[k].to(device=t.device, dtype=t.dtype), t)
            _local(t).copy_(_local(src))


def _host_comms():
    """FSDP2 all-gather and reduce-scatter that copy CUDA tensors through
    the host, for a gloo group over ranks sharing a card."""
    from torch.distributed.fsdp._fully_shard._fsdp_api import (
        AllGather, ReduceScatter)
    from ..parallel.mesh import _all_gather_single

    class HostAllGather(AllGather):
        def allocate(self, size, *, dtype, device):
            return torch.empty(*size, dtype=dtype, device=device)

        def __call__(self, output_tensor, input_tensor, group,
                     async_op=False):
            out = output_tensor.new_empty(output_tensor.shape, device="cpu")
            _all_gather_single(out, input_tensor.cpu(), group=group)
            output_tensor.copy_(out)

    class HostReduceScatter(ReduceScatter):
        def allocate(self, size, *, dtype, device):
            return torch.empty(*size, dtype=dtype, device=device)

        def __call__(self, output_tensor, input_tensor, group, op,
                     async_op=False):
            out = output_tensor.new_empty(output_tensor.shape, device="cpu")
            torch.distributed.reduce_scatter_tensor(
                out, input_tensor.cpu(), op=op, group=group)
            output_tensor.copy_(out)

    return HostAllGather(), HostReduceScatter()


class BaseExecutor:
    """Owns the model (on `device`), the optimizer, the step count, the
    JAX package's PRNG key (`rng_key`, PRNGKey(seed), split once a step)
    and a CPU generator for dropout, seeded each step from that step's
    subkey.

    Subclasses define loss_fn(batch, generator) -> (loss, metrics dict).
    The parameters that the train config's freeze flags freeze get
    requires_grad False. inference_only=True builds no optimizer (a server
    never reads Adam's moments; the constructor calls
    prepare_for_serving); train_step then raises. mesh, param_sharding
    ("replicated" or "fsdp") and fsdp_min_size: data parallelism over the
    mesh's "data" axis (module docstring); every rank builds the same
    model (the same seed), which the constructor checks."""

    # False: loss_fn's loss is a mean over the rank's rows, so the
    # data-parallel step averages grads and metrics over the ranks; True:
    # it is the rank's share of the global batch's loss (a sum over the
    # ranks gives it), so they are summed
    loss_is_sum = False

    def __init__(self, model: nn.Module,
                 train_cfg: Optional[TrainConfig] = None, device=None,
                 log_dir: Optional[str] = None, seed: int = 0,
                 quiet: bool = False,
                 logger_backends: Sequence[str] = ("jsonl",),
                 inference_only: bool = False, mesh=None,
                 param_sharding: str = "replicated",
                 fsdp_min_size: int = 2 ** 18):
        self.device = torch.device(
            device if device is not None
            else next(model.parameters()).device)
        self.model = model.to(self.device).eval()
        self.train_cfg = train_cfg or TrainConfig()
        for name, trainable in trainable_mask(
                self.model, self.train_cfg.modules).items():
            if not trainable:
                self.model.get_parameter(name).requires_grad_(False)
        if param_sharding not in ("replicated", "fsdp"):
            raise ValueError(f"param_sharding {param_sharding!r}: "
                             "'replicated' or 'fsdp'")
        self.mesh, self.param_sharding = mesh, param_sharding
        self.dp_group, self._replicated = None, None
        if mesh is not None:
            self._data_parallel(fsdp_min_size)
        self.optimizer, self.inference_only = None, False
        if inference_only:
            self.prepare_for_serving()
        else:
            self.optimizer = make_optimizer(self.train_cfg, self.model)
        # on a mesh rank 0 logs (the ranks' metrics are the same)
        self.logger = MetricsLogger(log_dir if rank_zero() else None,
                                    quiet=quiet or not rank_zero(),
                                    backends=logger_backends)
        self.rng_key = prng_key(seed)
        self.generator = torch.Generator()
        self.step = 0

    # -- data parallelism ----------------------------------------------------
    def _data_parallel(self, fsdp_min_size: int) -> None:
        self.dp_group = axis_group(self.mesh, "data")
        self.dp_size = mesh_axis_size(self.mesh, "data")
        self.dp_rank = axis_rank(self.mesh, "data")
        if hasattr(self.model, "negatives_group"):
            self.model.negatives_group = self.dp_group
        # every rank must start from the same parameters
        sums = torch.stack([p.detach().double().sum()
                            for p in self.model.parameters()])
        ref = broadcast(sums.clone(), torch.distributed.get_global_rank(
            self.dp_group, 0), group=self.dp_group)
        if not torch.equal(ref, sums):
            raise ValueError("the data-parallel ranks built different "
                             "parameters: build the model from one seed")
        if self.param_sharding == "replicated":
            return
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard
        from ..parallel import fsdp_sharding
        plan = fsdp_sharding(self.model, self.mesh, "data", fsdp_min_size,
                             _num_heads(self.model))
        dims = {p: plan[n] for n, p in self.model.named_parameters()}
        ignored = {p for p, d in dims.items() if d is None}
        sub = self.mesh["data"] if len(self.mesh.mesh_dim_names) > 1 \
            else self.mesh
        fully_shard(self.model, mesh=sub,
                    shard_placement_fn=lambda p: Shard(dims[p]),
                    ignored_params=ignored or None)
        self._replicated = {n for n, d in plan.items() if d is None}
        if self.loss_is_sum:
            self.model.set_gradient_divide_factor(1.0)
        if self.device.type == "cuda" and \
                torch.distributed.get_backend(self.dp_group) == "gloo":
            ag, rs = _host_comms()
            self.model.set_custom_all_gather(ag)
            self.model.set_custom_reduce_scatter(rs)

    def _average_replicated_grads(self) -> None:
        """DDP's gradient average of the replicated parameters (every
        trainable one under DDP, those under fsdp_min_size under FSDP): one
        all_reduce of a flat buffer (an unreached parameter counts 0)."""
        params = [p for n, p in self.model.named_parameters()
                  if p.requires_grad and (self._replicated is None
                                          or n in self._replicated)]
        if not params:
            return
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in params])
        all_reduce(flat, group=self.dp_group)
        if not self.loss_is_sum:
            flat /= self.dp_size
        i = 0
        for p in params:
            p.grad = flat[i:i + p.numel()].view_as(p)
            i += p.numel()

    def _global_mean(self, metrics: dict) -> dict:
        """The global batch's metrics: the ranks' mean of each scalar
        metric, or their sum where the loss is a share (loss_is_sum); one
        all_reduce."""
        keys = [k for k, v in metrics.items()
                if isinstance(v, torch.Tensor) and v.numel() == 1]
        if not keys:
            return metrics
        vals = torch.stack([metrics[k].detach().float().reshape(())
                            for k in keys])
        all_reduce(vals, group=self.dp_group)
        if not self.loss_is_sum:
            vals /= self.dp_size
        return {**metrics, **{k: vals[i] for i, k in enumerate(keys)}}

    @contextlib.contextmanager
    def gathered_params(self):
        """The whole parameters in the model for calls other than forward
        (encoding, generation): FSDP gathers them only around forward."""
        if self.mesh is None or self.param_sharding != "fsdp":
            yield
            return
        self.model.unshard()
        try:
            yield
        finally:
            self.model.reshard()

    def full_state_dict(self) -> dict:
        """The whole parameters (FSDP's shards gathered; every rank calls
        this under FSDP), as plain tensors."""
        return {k: full_tensor(v) for k, v in self.model.state_dict().items()}

    # -- to be overridden ---------------------------------------------------
    def loss_fn(self, batch, generator: torch.Generator):
        raise NotImplementedError

    def _t(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    # -- training -----------------------------------------------------------
    def train_step(self, batch) -> dict:
        """One micro-step: loss, grads, the optimizer's step. Returns the
        metrics as tensors on the device (no host sync): loss_fn's,
        "loss" and "grad_norm", the global norm of every grad of this
        micro-step. Frozen parameters take no grad, so it is the trainable
        parameters' norm; the JAX step's also counts the frozen
        parameters' grads (ROADMAP.md C21). On a mesh, `batch` is the
        global batch: the rank steps on its slice, and the metrics are the
        ranks' means (the global loss) and the global grad norm."""
        if self.inference_only:
            raise RuntimeError(
                "executor is inference_only: no optimizer state; rebuild "
                "without inference_only to train")
        with span("train.step", step=self.step + 1):
            clock_mark(self.device)
            self.model.zero_grad(set_to_none=True)
            if self.mesh is not None:
                batch = shard_batch(batch, self.mesh, "data")
            # the JAX step's `rng, sub = jax.random.split(state.rng)`
            self.rng_key, sub = split(self.rng_key)
            self.generator.manual_seed(int(sub[0]) << 32 | int(sub[1]))
            with span("train.forward"):
                loss, metrics = self.loss_fn(batch, self.generator)
            with span("train.backward"):
                loss.backward()
            if self.mesh is not None:
                self._average_replicated_grads()
            with span("train.optimizer"):
                grad_norm = global_norm([p.grad
                                         for p in self.model.parameters()
                                         if p.grad is not None])
                self.optimizer.step()
        self.step += 1
        metrics = dict(metrics)
        metrics["loss"] = loss.detach()
        if self.mesh is not None:
            metrics = self._global_mean(metrics)
        metrics["grad_norm"] = grad_norm
        return metrics

    def fit(self, batches: Iterable, steps: Optional[int] = None,
            log_every: int = 50,
            val_every: Optional[int] = None,
            val_fn: Optional[Callable[[], dict]] = None,
            ckpt_manager=None, early_stopping=None) -> dict:
        """Training loop. ckpt_manager/early_stopping: see
        executors.callbacks."""
        last_metrics: dict = {}
        try:
            last_metrics = self._fit_loop(batches, steps, log_every,
                                          val_every, val_fn, ckpt_manager,
                                          early_stopping)
        finally:
            # a prefetch stream abandoned mid-way (steps reached, early
            # stop, an exception) would leave its producer thread parked
            # on device-resident batches; close() stops it. Only
            # prefetch-owned streams are closed: a caller's generator
            # must survive for a later fit() continuation.
            if getattr(batches, "_ravqa_prefetch_owned", False):
                batches.close()
        return last_metrics

    def _fit_loop(self, batches, steps, log_every, val_every, val_fn,
                  ckpt_manager, early_stopping) -> dict:
        last_metrics: dict = {}
        # islice: the batch after the last step is not drawn (the JAX loop
        # draws it and drops it, which for RAG training is a live retrieval)
        for i, batch in enumerate(itertools.islice(batches, steps)):
            metrics = self.train_step(batch)
            if (i + 1) % log_every == 0 or (steps and i == steps - 1):
                last_metrics = {k: float(v) for k, v in metrics.items()}
                self.logger.log(last_metrics, self.step, prefix="train/")
            if val_fn is not None and val_every and (i + 1) % val_every == 0:
                # val_fn logs its own metrics (run_eval, under "valid/")
                vm = val_fn()
                if ckpt_manager is not None:
                    ckpt_manager.on_validation(self, vm, self.step)
                if early_stopping is not None and early_stopping.update(vm):
                    self.logger.log({"early_stop": 1}, self.step)
                    break
        return last_metrics

    def prepare_for_serving(self) -> None:
        """Drop the optimizer (Adam's moments, accumulators) for an
        inference deployment (what inference_only=True builds). train_step
        raises afterwards."""
        self.optimizer = None
        self.inference_only = True

    # -- checkpoints ----------------------------------------------------------
    def _named_params(self) -> dict:
        """{parameter name: whole tensor} (every rank calls this under
        FSDP: the shards are gathered)."""
        return self.full_state_dict()

    def _to_flax(self, values: dict) -> dict:
        """{parameter name: tensor} (any subset, parameter-shaped) -> the
        JAX package's params tree of those leaves. Parameters, Adam's
        moments and accumulators all go through it."""
        return state_dict_to_flax(values, _num_heads(self.model))

    def _from_flax(self, tree: dict) -> dict:
        """The inverse of _to_flax; {} leaves (optax's MaskedNode) drop."""
        return flax_to_state_dict(tree)

    def load_params_tree(self, tree: dict) -> None:
        """Load a JAX params tree into the model (strict)."""
        _load_full(self.model, self._from_flax(tree))

    def checkpoint_state(self) -> Optional[dict]:
        """The trees the JAX package checkpoints: {"params", "opt_state"
        ({} without an optimizer, as the JAX package's serving executor
        writes it), "rng", "step"}, as numpy; None on a rank other than 0
        (every rank calls it)."""
        named = self._named_params()
        mom = (_full_tensors(moments(self.optimizer))
               if self.optimizer is not None else None)
        if not rank_zero():
            return None
        params = self._to_flax(named)
        return {"params": params,
                "opt_state": ({} if mom is None else to_optax_tree(
                    self.optimizer, mom, self._to_flax, params)),
                "rng": self.rng_key.copy(),
                "step": np.asarray(self.step, np.int32)}

    def save_checkpoint(self, path: str, backend: str = "msgpack"):
        """The JAX package's checkpoint of this executor: backend
        "msgpack" writes params.msgpack, opt_state.msgpack, rng.msgpack
        and step.json into `path`; "orbax" writes `path`/orbax
        (orbax_io.save). On a mesh rank 0 writes the whole parameters and
        moments."""
        if backend not in ("msgpack", "orbax"):
            raise ValueError(f"checkpoint backend {backend!r}: 'msgpack' "
                             "or 'orbax'")
        state = self.checkpoint_state()
        if state is None:
            return
        if backend == "orbax":
            orbax_io.save(os.path.join(path, "orbax"), state)
            return
        os.makedirs(path, exist_ok=True)
        for name in ("params", "opt_state", "rng"):
            save_flax_msgpack(os.path.join(path, f"{name}.msgpack"),
                              state[name])
        with open(os.path.join(path, "step.json"), "w") as f:
            json.dump({"step": self.step}, f)

    def _restore(self, step: int, opt_state: Optional[dict],
                 rng) -> None:
        """The step, the optimizer (a fresh one, then `opt_state` where
        given; where None or empty, as a serving executor writes it,
        "ckpt_opt_state_missing" is logged, as the JAX package does) and
        the key (kept where None)."""
        self.step = int(step)
        if self.optimizer is not None:
            self.optimizer = make_optimizer(self.train_cfg, self.model)
            if opt_state:
                load_optax_tree(
                    self.optimizer, opt_state, self._from_flax,
                    lambda t, p: _shard_as(
                        t.to(device=p.device, dtype=p.dtype), p))
            else:
                self.logger.log({"ckpt_opt_state_missing": 1}, self.step)
        if rng is not None:
            self.rng_key = np.asarray(rng, np.uint32).reshape(2).copy()

    def load_checkpoint(self, path: str) -> None:
        """Load a params file (flax msgpack or a flattened-key .npz) into
        the model, or a checkpoint directory (the JAX package's or
        save_checkpoint's): its params.msgpack (else params.npz),
        step.json, opt_state.msgpack and rng.msgpack. An inference_only
        executor reads no optimizer state."""
        if not os.path.isdir(path):
            self.load_params_tree(read_params_tree(path))
            return
        found = [os.path.join(path, f) for f in CHECKPOINT_FILES
                 if os.path.exists(os.path.join(path, f))]
        if not found:
            raise FileNotFoundError(f"{path} holds none of "
                                    f"{CHECKPOINT_FILES}")
        self.load_params_tree(read_params_tree(found[0]))

        def read(name):
            p = os.path.join(path, name)
            if not os.path.exists(p):
                return None
            with open(p, "rb") as f:
                return read_flax_msgpack(f.read())
        step = self.step
        if os.path.exists(os.path.join(path, "step.json")):
            with open(os.path.join(path, "step.json")) as f:
                step = json.load(f)["step"]
        self._restore(step, (read("opt_state.msgpack")
                             if self.optimizer is not None else None),
                      read("rng.msgpack"))

    def load_checkpoint_orbax(self, path: str) -> None:
        """Load `path`/orbax (the JAX package's save_checkpoint(backend=
        "orbax") or this one's). Whether it holds the optimizer's state
        is read from its metadata: a checkpoint without one (params and
        step only) loads with a fresh optimizer and the key kept; a
        failed read of one that has it raises."""
        p = os.path.join(path, "orbax")
        skip = () if self.optimizer is not None else ("opt_state",)
        tree = orbax_io.load(p, skip=skip)
        self.load_params_tree(tree["params"])
        full = "opt_state" in tree                  # None where skipped
        self._restore(int(np.asarray(tree["step"])),
                      tree.get("opt_state") if full else None,
                      tree.get("rng") if full else None)
