"""The FLMR family's training cell: the program's FLMRExecutor.train_step fed by its own
data path (RetrievalDataset over the benchmark's seeded corpus and
questions, prefetched to the device), then its first three steps judged
against the plain reference.

Set-up builds one executor with the benchmark's seeded weights and drives
it through its first three steps with the window's own call and feed;
the same executor then runs the window. The optimizer's state after step 1
gives the first gradient as the optimizer got it (Adam's first moment over
1 - beta1), and the parameters after step 3 give the change.
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from .. import inputs, judge
from ..generator import Log
from ..reference import train as ref_train
from ..reference import towers
from ..spec import ROOT
from ..trace import WINDOW, Tracer

CHECKED_STEPS = 3


def build(cell, seed: int, device, cache_dir: str):
    from ravqa_tpu_torch.data import (PassageCorpus, RetrievalDataset,
                                      prefetch_to_device)
    from ravqa_tpu_torch.executors import FLMRExecutor, TrainConfig
    from ravqa_tpu_torch.main import _flmr_config_from
    from ravqa_tpu_torch.models import FLMRRetriever
    from ravqa_tpu_torch.tokenization import (DocTokenizer, QueryTokenizer,
                                              WordPieceTokenizer)

    cfg = cell.cfg
    mc, tr = cfg["model_config"], cfg["train"]
    weights = inputs.make_weights(towers.param_specs(mc), seed, device)
    model = FLMRRetriever(_flmr_config_from(mc), device="meta")
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    ex = FLMRExecutor(model, TrainConfig(
        lr=tr["lr"], mapping_lr=tr["mapping_network_lr"],
        modules=tuple(mc.get("modules", []))), device=device, quiet=True,
        logger_backends=())
    vocab_size = mc.get("bert", {}).get("vocab_size", 30522)
    world = inputs.TrainWorld(cfg, cell.traffic, seed,
                              inputs.vocab_words(vocab_size))
    base = WordPieceTokenizer(inputs.vocab_file(vocab_size, cache_dir))
    ds = RetrievalDataset(
        world.items(), PassageCorpus(world.pids, world.passages),
        QueryTokenizer(base, query_maxlen=cfg["query_maxlen"]),
        DocTokenizer(base, doc_maxlen=cfg["doc_maxlen"]),
        nway=ref_train.nway_of(cfg), seed=data_seed(seed))
    it = prefetch_to_device(
        ds.loader(batch_size=tr["batch_size"], shuffle=True,
                  seed=loader_seed(seed)),
        size=tr["prefetch_batches"], device=device)
    state = {"weights": weights, "world": world, "vocab_size": vocab_size}
    return ex, it, state


def loader_seed(seed: int) -> int:
    return seed


def data_seed(seed: int) -> int:
    return seed + 1


def step(ex, it, span, waits=None):
    t = time.perf_counter()
    with span("pb.data_wait"):
        batch = next(it)
    if waits is not None:
        waits.append(time.perf_counter() - t)
    with span("pb.step"):
        return ex.train_step(batch)


def checked_steps(ex, it, w0: dict, span) -> dict:
    """The first CHECKED_STEPS steps through the window's own call and
    feed -> the program's side of judge.train_numbers."""
    losses, grad = [], {}
    b1 = ex.optimizer.cfg.adam_b1
    for s in range(CHECKED_STEPS):
        losses.append(step(ex, it, span)["loss"])
        if s == 0:
            opt = ex.optimizer
            # a leaf the optimizer holds no moment for got no gradient
            grad = {name: float(opt.adamw.state[p]["exp_avg"].norm())
                    / (1 - b1) if "exp_avg" in opt.adamw.state[p] else 0.0
                    for name, p in zip(opt.names, opt.trainable)}
    named = dict(ex.model.named_parameters())
    return {"loss": [float(v) for v in losses], "grad": grad,
            "change": {k: float((named[k].detach() - w0[k]).norm())
                       for k in w0}}


def run(cell, seed: int, seconds: float, tracer, device, cache_dir: str,
        t_start: float) -> dict:
    ex, it, state = build(cell, seed, device, cache_dir)
    prog = checked_steps(ex, it, state["weights"], tracer.span)
    _sync(device)
    log, waits, steps = Log(), [], 0
    bsz = cell.cfg["train"]["batch_size"]
    with tracer:
        with tracer.span(WINDOW):
            log.t0 = time.perf_counter()
            log.setup_s = log.t0 - t_start
            while time.perf_counter() - log.t0 < seconds:
                step(ex, it, tracer.span, waits)
                steps += 1
            _sync(device)
            log.t1 = time.perf_counter()
    log.attempted = steps
    peak = _peak(device)
    it.close()
    del ex, it
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check(cell, state, seed, prog, device)
    return {"log": log, "peak": peak, "checks": checks, "steps": steps,
            "questions": steps * bsz, "data_waits": waits}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0


def reference_batches(cell, state, seed: int, device):
    cfg = cell.cfg
    raw = ref_train.batches(state["world"], inputs.vocab(state["vocab_size"]),
                            cfg, loader_seed(seed), data_seed(seed),
                            CHECKED_STEPS)
    return [tuple(torch.as_tensor(np.asarray(x), device=device)
                  for x in b) for b in raw]


def check(cell, state, seed: int, prog: dict, device) -> dict:
    ref = ref_train.run(state["weights"], cell.cfg,
                        reference_batches(cell, state, seed, device),
                        CHECKED_STEPS)
    return judge.with_limits(judge.train_numbers(prog, ref),
                             cell.work["check"]["limits"])


def controls(cell, seed: int, device, program: bool) -> dict:
    """The readings that the limits of `correct` are set from: the
    reference's three steps in TF32, with half of each batch's queries
    left out of the loss (the mean over the rest), and with the mapping
    network at the base learning rate, each read with
    judge.train_numbers against the float32 reference. A step that leaves
    its state unchanged reads change_gap 1 by its definition and needs no
    run. With `program`, the program's own first steps too (its set-up
    as a run's, without the window)."""
    cfg = cell.cfg
    mc, tr = cfg["model_config"], cfg["train"]
    out = {}
    if program:
        ex, it, state = build(cell, seed, device,
                              os.path.join(ROOT, ".portbench_cache"))
        prog = checked_steps(ex, it, state["weights"], Tracer(False).span)
        it.close()
        del ex, it
    else:
        vocab_size = mc.get("bert", {}).get("vocab_size", 30522)
        state = {"weights": inputs.make_weights(towers.param_specs(mc), seed,
                                                device),
                 "vocab_size": vocab_size,
                 "world": inputs.TrainWorld(cfg, cell.traffic, seed,
                                            inputs.vocab_words(vocab_size))}
    weights = state["weights"]
    batches = reference_batches(cell, state, seed, device)
    ref = ref_train.run(weights, cfg, batches, CHECKED_STEPS)
    if program:
        out["program"] = judge.train_numbers(prog, ref)
    slow_map = {**cfg, "train": {**tr, "mapping_network_lr": tr["lr"]}}
    for name, c, kw in (("tf32", cfg, {"precision": "tf32"}),
                        ("half_batch", cfg, {"half": True}),
                        ("mapping_lr", slow_map, {})):
        got = ref_train.run(weights, c, batches, CHECKED_STEPS, **kw)
        out[name] = judge.train_numbers(got, ref)
    return out
