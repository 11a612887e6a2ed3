"""Where a training step's time goes, on one NVIDIA GPU.

    python -m ravqa_tpu_torch.profile_train \\
        configs/synthetic_flmr_base_train.json \\
        configs/synthetic_rag_blip2_train.json --out profile_train.json

FLMR retriever configs: builds the executor as `main --mode train` does
(random weights from the config's seed) and one batch of
`train.batch_size` from the train split, then measures, each the median
of 5 after 2 warm-ups (CUDA events):
  1. the whole train step (FLMRExecutor.train_step) on that batch, and the
     host's collate of a batch (tokenization, negative sampling);
  2. its parts alone: the query tower forward + backward, the doc tower
     forward + backward, the losses (nway + in-batch negatives, with the
     (B*nway, Ld, B, Lq) token-score tensor) forward + backward on fixed
     embeddings, and the optimizer step;
  3. torch.profiler over 3 train steps: kernel time by kind (GEMM,
     softmax, LayerNorm, reductions, elementwise, the optimizer's
     multi-tensor kernels, copies) and the device's busy share of a step.

RAG configs (RagExecutor): builds the executor as `main --mode train`
does and runs 2 accumulation windows of micro-batches (make_train_batch,
then train_step, as fit runs them) under RagStageTimer, which splits each
micro-step by stage with CUDA events: the host's prompts and labels,
retrieval (query tower + K1), ViT-g + Q-Former (no grad), the T5 encoder
forward, the decoder + head, the doc scores (the query re-encoded with
gradients, paired MaxSim), the LoRA merge and losses, the backward (with
remat's recompute) and the optimizer step (an update on the window's last
micro-step); the medians after the first window, questions/s trained,
and the busy share of one micro-step under torch.profiler.
Peak device memory is read with max_memory_allocated. Prints one line per
measurement and writes everything as JSON to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from .main import _is_rag, build_executor, build_pipeline, load_config
from .ops.losses import in_batch_negative_loss, nway_ce_loss
from .profile_serve import _time_ms, kernel_events

# kernel kinds by name: the first pattern found in the lowercased name
KINDS = (("GEMM", ("gemm", "xmma", "cutlass", "sm90_", "cublas")),
         ("optimizer (multi-tensor)", ("multi_tensor", "foreach")),
         ("softmax", ("softmax",)),
         ("LayerNorm", ("layer_norm", "layernorm")),
         ("reductions (max, sum, norms)", ("reduce", "max", "norm")),
         ("copies and fills", ("memcpy", "memset", "copy", "fill")),
         ("elementwise", ("elementwise", "vectorized", "unrolled")))


def _kind(name: str) -> str:
    low = name.lower()
    for kind, patterns in KINDS:
        if any(p in low for p in patterns):
            return kind
    return "other"


def profile_config(path: str) -> dict:
    cfg = load_config(path)
    data = build_pipeline(cfg).get_data(cfg.data_pipeline_output_node,
                                        explode=True)
    ex = build_executor(cfg, "cuda")
    ds = data["train"]
    bs = cfg.train.get("batch_size", 8)
    host = []
    for i in range(5):
        t0 = time.perf_counter()
        batch = ds.collate(list(range(i * bs, (i + 1) * bs)))
        host.append(time.perf_counter() - t0)
    inputs = ex._inputs(batch)
    res = {"config": path, "batch_size": bs,
           "collate_ms": float(np.median(host)) * 1e3}
    torch.cuda.reset_peak_memory_stats()
    res["step_ms"] = _time_ms(lambda: ex.train_step(inputs), iters=5)
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    print(f"{path}: train step {res['step_ms']:.1f} ms (B={bs}), host "
          f"collate {res['collate_ms']:.1f} ms a batch, peak "
          f"{res['peak_bytes'] / 2**30:.2f} GiB", flush=True)

    model, mc = ex.model, ex.model.cfg
    q_args = (inputs["query_input_ids"], inputs["query_attention_mask"],
              inputs["image_features"])
    d_args = (inputs["doc_input_ids"], inputs["doc_attention_mask"])

    def tower(fn, args):
        def run():
            out = fn(*args)
            out = out[0] if isinstance(out, tuple) else out
            out.sum().backward()
        return run

    with torch.no_grad():
        q = model.query(*q_args)
        d, d_mask = model.doc(*d_args)

    def losses():
        qg, dg = q.clone().requires_grad_(), d.clone().requires_grad_()
        nway, _ = nway_ce_loss(qg, dg, d_mask, mc.nway)
        ib, _ = in_batch_negative_loss(
            qg, dg, d_mask, mc.nway, block_n=mc.ib_block_n,
            compute_dtype=torch.bfloat16 if mc.ib_score_bf16 else None)
        (nway + ib).backward()

    ex.train_step(inputs)                  # leaves a micro-step's grads
    parts = {"query tower fwd+bwd": tower(model.query, q_args),
             "doc tower fwd+bwd": tower(model.doc, d_args),
             "losses fwd+bwd (score tensors)": losses,
             "optimizer step": ex.optimizer.step}
    res["parts_ms"] = {}
    for name, fn in parts.items():
        model.zero_grad(set_to_none=False)
        res["parts_ms"][name] = _time_ms(fn, iters=5)
        print(f"  {name}: {res['parts_ms'][name]:.2f} ms", flush=True)

    events = kernel_events(lambda: ex.train_step(inputs), n=3)
    kinds: dict = {}
    for name, (ms, _) in events.items():
        kinds[_kind(name)] = kinds.get(_kind(name), 0.0) + ms / 3
    device_ms = sum(kinds.values())
    res["kernel_ms_by_kind"] = kinds
    res["device_ms_per_step"] = device_ms
    res["device_busy_share"] = device_ms / res["step_ms"]
    res["top_kernels"] = dict(sorted(
        ((k, v[0] / 3) for k, v in events.items()),
        key=lambda kv: -kv[1])[:12])
    print("kernel ms a step by kind: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(kinds.items(),
                                          key=lambda kv: -kv[1])),
        flush=True)
    print(f"step: {device_ms:.1f} ms of kernels in {res['step_ms']:.1f} ms "
          f"({res['device_busy_share']:.1%} busy)", flush=True)
    return res


class RagStageTimer:
    """CUDA events around the stages of a RagExecutor's training
    micro-steps (make_train_batch, then train_step, as fit runs them),
    recorded by wrapping the executor's and its generator's methods (as
    instance attributes; the events do not synchronize) until close().
    steps() gives each micro-step's ms by stage."""

    def __init__(self, ex):
        self.ex = ex
        self._steps: list = []
        self._cur = None
        self._undo = []
        gen = ex.model.generator
        blip2 = ex.rag_cfg.generator_type == "blip2"
        lm = gen.language_model if blip2 else gen
        self._wrap(ex, "make_train_batch", self._make_train_batch)
        self._wrap(ex, "retrieve", self._events("retrieve"))
        self._wrap(ex, "train_step", self._train_step)
        for obj, name, key in (
                (ex, "loss_fn", "loss_fn"), (ex, "doc_scores", "doc_scores"),
                (lm, "encode", "encoder"), (lm, "decode", "decoder")) + (
                ((gen, "encode_image", "vision"),) if blip2 else ()):
            self._wrap(obj, name, self._events(key))
        self._wrap(ex.optimizer, "step", self._events("optimizer"))

    def _wrap(self, obj, name, make):
        orig = getattr(obj, name)
        setattr(obj, name, make(orig))
        self._undo.append((obj, name))

    def close(self) -> None:
        for obj, name in reversed(self._undo):
            delattr(obj, name)
        self._undo = []

    @staticmethod
    def _event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _events(self, key):
        def make(orig):
            def run(*args, **kwargs):
                if self._cur is None:
                    return orig(*args, **kwargs)
                start = self._event()
                out = orig(*args, **kwargs)
                self._cur.setdefault(key, []).append((start, self._event()))
                return out
            return run
        return make

    def _make_train_batch(self, orig):
        def run(batch):
            self._cur = {}
            t0 = time.perf_counter()
            out = orig(batch)
            self._cur["make_train_batch_wall_ms"] = \
                (time.perf_counter() - t0) * 1e3
            self._pending = self._cur
            self._cur = None
            return out
        return run

    def _train_step(self, orig):
        def run(batch):
            self._cur = getattr(self, "_pending", None) or {}
            self._pending = None
            start = self._event()
            try:
                return orig(batch)
            finally:
                self._cur["step"] = [(start, self._event())]
                self._steps.append(self._cur)
                self._cur = None
        return run

    def steps(self) -> list:
        """Each micro-step's {stage: ms} (synchronizes)."""
        torch.cuda.synchronize()
        out = []
        for rec in self._steps:
            ms = {k: sum(a.elapsed_time(b) for a, b in v)
                  for k, v in rec.items() if isinstance(v, list)}
            retrieval = ms.get("retrieve", 0.0)
            forward = sum(ms.get(k, 0.0) for k in
                          ("doc_scores", "vision", "encoder", "decoder"))
            loss_fn_end = rec["loss_fn"][0][1]
            opt_start = rec["optimizer"][0][0]
            out.append({
                "host: prompts and labels":
                    rec.get("make_train_batch_wall_ms", 0.0) - retrieval,
                "retrieval: query tower + K1 (+ doc gather)": retrieval,
                "ViT-g + Q-Former (no grad)": ms.get("vision", 0.0),
                "T5 encoder forward": ms.get("encoder", 0.0),
                "decoder + head forward": ms.get("decoder", 0.0),
                "doc scores (query tower with grad, paired MaxSim)":
                    ms.get("doc_scores", 0.0),
                "LoRA merge and losses": ms["loss_fn"] - forward,
                "backward (remat recompute included)":
                    loss_fn_end.elapsed_time(opt_start),
                "optimizer step": ms["optimizer"],
                "train_step": ms["step"],
            })
        return out


def profile_rag_config(path: str) -> dict:
    """Two accumulation windows of RAG training micro-batches under
    RagStageTimer, then one micro-step under torch.profiler."""
    from .main import build_rag_executor, rag_batches
    cfg = load_config(path)
    data = build_pipeline(cfg).get_data(cfg.data_pipeline_output_node,
                                        explode=True)
    t0 = time.perf_counter()
    ex = build_rag_executor(cfg, data, "cuda")
    tc = cfg.train
    bs, accum = tc.get("batch_size", 8), tc.get("accumulate_grad_batches", 1)
    res = {"config": path, "batch_size": bs, "accumulate": accum,
           "setup_s": time.perf_counter() - t0}
    raw = rag_batches(data["train"], bs, seed=cfg.get("seed", 0))
    torch.cuda.reset_peak_memory_stats()
    timer = RagStageTimer(ex)
    n = 2 * accum
    walls = []
    try:
        for _ in range(n):
            t = time.perf_counter()
            m = ex.train_step_rag(next(raw))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            if not torch.isfinite(m["loss"]):
                raise AssertionError(f"a non-finite loss: {m}")
        steps = timer.steps()
    finally:
        timer.close()
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    measured = steps[accum:] if n > accum else steps
    res["micro_step_ms"] = [s["train_step"] for s in steps]
    res["stages_ms"] = {k: float(np.median([s[k] for s in measured]))
                        for k in measured[0]}
    res["update_ms"] = [s["optimizer step"] for s in steps[accum - 1::accum]]
    res["micro_step_wall_s"] = walls
    res["questions_per_s"] = bs * len(walls[accum:]) / sum(walls[accum:])
    print(f"{path}: {n} micro-batches of {bs} (accumulation {accum}); "
          f"median ms by stage after the first window: " + ", ".join(
              f"{k} {v:.2f}" for k, v in res["stages_ms"].items()),
          flush=True)
    print(f"  optimizer updates {res['update_ms']} ms; micro-step walls "
          + ", ".join(f"{w:.3f}" for w in walls) + f" s; "
          f"{res['questions_per_s']:.3f} questions/s trained; peak "
          f"{res['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    events = kernel_events(lambda: ex.train_step_rag(next(raw)), n=1)
    kinds: dict = {}
    for name, (ms, _) in events.items():
        kinds[_kind(name)] = kinds.get(_kind(name), 0.0) + ms
    res["kernel_ms_by_kind"] = kinds
    res["device_ms_per_micro_step"] = sum(kinds.values())
    res["device_busy_share"] = res["device_ms_per_micro_step"] / (
        float(np.median(walls[accum:])) * 1e3)
    print(f"  one micro-step: {res['device_ms_per_micro_step']:.1f} ms of "
          f"kernels ({res['device_busy_share']:.1%} of the median wall); by "
          "kind: " + ", ".join(f"{k} {v:.1f}" for k, v in sorted(
              kinds.items(), key=lambda kv: -kv[1])), flush=True)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser("ravqa_tpu_torch.profile_train")
    p.add_argument("configs", nargs="+")
    p.add_argument("--out", default=None, help="JSON file for the results")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    out = {"device": smi, "results": [
        (profile_rag_config if _is_rag(load_config(c)) else profile_config)(c)
        for c in args.configs]}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
