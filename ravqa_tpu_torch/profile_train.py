"""Where an FLMR training step's time goes, on one NVIDIA GPU.

    python -m ravqa_tpu_torch.profile_train \\
        configs/synthetic_flmr_base_train.json \\
        --out profile_train.json

Builds the executor as `main --mode train` does (random weights from the
config's seed) and one batch of `train.batch_size` from the train split,
then measures, each the median of 5 after 2 warm-ups (CUDA events):
  1. the whole train step (FLMRExecutor.train_step) on that batch, and the
     host's collate of a batch (tokenization, negative sampling);
  2. its parts alone: the query tower forward + backward, the doc tower
     forward + backward, the losses (nway + in-batch negatives, with the
     (B*nway, Ld, B, Lq) token-score tensor) forward + backward on fixed
     embeddings, and the optimizer step;
  3. torch.profiler over 3 train steps: kernel time by kind (GEMM,
     softmax, LayerNorm, reductions, elementwise, the optimizer's
     multi-tensor kernels, copies) and the device's busy share of a step.
Peak device memory of a step is read with max_memory_allocated. Prints one
line per measurement and writes everything as JSON to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from .main import build_executor, build_pipeline, load_config
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
    out = {"device": smi,
           "results": [profile_config(c) for c in args.configs]}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
