"""How many device events a torch.profiler trace loses over one process's
life, on one NVIDIA GPU.

    python -m ravqa_tpu_torch.scripts.profiler_trace_loss [--seconds 220] \
        [--out chiprun_out/profiler_trace_loss.json]

Each round keeps the card at work (200 products of two 8,192^2 float32
matrices), then takes two traces of CALLS launches of torch.mm on 256^2
matrices:
  tight: the profiler starts just before the calls, as a plain
     `with profile(...)` does. The launches the trace kept, the kernels it
     kept, and the positions (in launch order) of the launches whose
     kernel it lost;
  kernel_events: profile_serve.kernel_events (its spin-kernel burn-in
     first). The kernels it returns, which should be every launch.
Rounds go on for --seconds. Prints one JSON line per round and a summary
line: the rounds, the kernels that each kind of trace kept at its fewest,
and whether every loss was a prefix of the launches.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from ..profile_serve import kernel_events

CALLS = 10


def _tight(fn) -> dict:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    launches = sorted((e["ts"], e["args"]["correlation"]) for e in events
                      if e.get("cat") in ("cuda_runtime", "cuda_driver")
                      and "Launch" in e["name"])
    kept = {e["args"].get("correlation") for e in events
            if e.get("cat") == "kernel"}
    lost = [i for i, (_, c) in enumerate(launches) if c not in kept]
    return {"launches": len(launches), "kernels": len(kept),
            "lost": lost, "prefix": lost == list(range(len(lost)))}


def run(seconds: float) -> dict:
    a = torch.randn(256, 256, device="cuda")
    b = torch.randn(256, 256, device="cuda")
    big = torch.randn(8192, 8192, device="cuda")

    def fn():
        return torch.mm(a, b)

    rows = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(200):
            big @ big
        torch.cuda.synchronize()
        row = {"t_s": time.perf_counter() - t0, "tight": _tight(fn)}
        row["kernel_events"] = sum(
            k for _, k in kernel_events(fn, n=CALLS).values())
        print(json.dumps(row), flush=True)
        rows.append(row)
    return {"rounds": len(rows),
            "launches_per_trace": rows[0]["tight"]["launches"],
            "fewest_kept_tight": min(r["tight"]["kernels"] for r in rows),
            "fewest_kept_kernel_events": min(r["kernel_events"]
                                             for r in rows),
            "every_loss_a_prefix": all(r["tight"]["prefix"] for r in rows),
            "rows": rows}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=220.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiler_trace_loss needs a CUDA device")
    out = run(args.seconds)
    print(json.dumps({k: v for k, v in out.items() if k != "rows"}),
          flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
