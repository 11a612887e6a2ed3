"""Run one cell once and print its result line.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Builds the cell on the card, warms up, drives the measured window, judges
the timed path's outputs against the plain reference, and prints one JSON
line: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), `device`, with --trace 1
`breakdown`, and last `checked`: each number compared, with its limit
(also the last lines of standard error). Exits non-zero, printing no
result, without a card, with fewer cards than the cell asks for, or when
a JAX module was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "ravqa_tpu")
PEAK_BF16_FLOPS = 989e12      # H100 SXM, dense bf16 (NVIDIA data sheet)
PEAK_HBM_BYTES = 3.35e12      # H100 SXM HBM3 bytes/s


class Ctx:
    """What the metric readers read: the cell, the host-clock record of
    the window, the trace, and the program's counters."""

    def __init__(self, cell, out: dict, trace):
        self.cell, self.out, self.trace = cell, out, trace
        self.log = out["log"]
        self.setup_s = self.log.setup_s
        self.peak_flops, self.peak_bytes = PEAK_BF16_FLOPS, PEAK_HBM_BYTES

    @property
    def window_s(self) -> float:
        return self.log.t1 - self.log.t0


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, overrides=None) -> dict:
    """One run of a cell on `device` -> the result dict (the CPU tests call
    this at tiny sizes; a measured run goes through main)."""
    import torch

    from . import judge
    from .spec import ROOT, Cell, cell_module, reader
    from .trace import Tracer

    device = torch.device(device)
    cell = Cell(name, overrides)
    cache_dir = os.path.join(ROOT, ".portbench_cache")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    tracer = Tracer(trace and device.type == "cuda")
    out = cell_module(cell).run(cell, seed, seconds, tracer, device,
                                cache_dir, t_start)
    ctx = Ctx(cell, out, tracer.trace)
    metrics = {}
    group = cell.per_layer if trace else cell.end_to_end
    for m in group:
        folder = "layer_metrics" if trace else "e2e_metrics"
        value = reader(folder, m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    log = out["log"]
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": out["peak"]}
    result = {"correct": judge.passed(out["checks"]) and log.failed == 0,
              "attempted": log.attempted, "failed": log.failed,
              "metrics": metrics, "device": dev}
    if tracer.trace is not None:
        dev["busy_s"] = tracer.trace.busy_s()
        dev["window_s"] = tracer.trace.window_s
        result["breakdown"] = tracer.trace.breakdown()
    result["checked"] = out["checks"]
    return result


def main(argv=None, t_start=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    import torch
    from .spec import Cell
    chips = Cell(args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checked"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
