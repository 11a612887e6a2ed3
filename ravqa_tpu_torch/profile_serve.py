"""Where a serve slice's time goes, on one NVIDIA GPU.

    python -m ravqa_tpu_torch.profile_serve \\
        configs/synthetic_flmr_base_serve_hier.json \\
        configs/synthetic_flmr_base_serve.json \\
        --out chiprun_out/profile_serve.json

For each config, build_server as the entry point does (random weights from
the config's seed), then:
  1. bursts: 3 closed bursts of 256 requests submitted at once
     through RetrievalServer.submit; requests/s and dispatches per burst;
  2. per batch: encode_query and search_device at B = 32, 8 and 1, ms
     (median of 10 after warm-up, CUDA events);
  3. profile (torch.profiler, kernel durations from its trace) over 8 full
     batches each of the query tower alone, the search alone and the
     server's whole dispatch (encode, search, results to the host); the
     search's kernels split by stage, the tower's kernel time, and the
     dispatch's kernel time over its wall time without the profiler.
Prints one line per measurement and writes everything as JSON to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
from concurrent.futures import Future

import numpy as np
import torch

from .main import build_pipeline, build_server, load_config

BATCH = 32
BURSTS = 3
PROFILED_BATCHES = 8
# search kernels by name: the first pattern found in the lowercased name
# picks the stage (the tensor-core summary sweep's instances are named by
# their Op: summary_kernel<CoarseBf16Op> is K2, <CoarseInt8Op> K3,
# <Stage1Op<...>> K4); every other kernel is the plain fine stage's gather,
# einsum, max and sum, or the glue between the stages
STAGES = (("stage 0: coarse_sweep (K2/K3)", ("coarse_sweep", "coarsebf16op",
                                                "coarseint8op")),
          ("stage 1: stage1_sweep (K4)", ("stage1_sweep", "stage1op")),
          ("residual fine stage: residual_maxsim (K6)",
           ("residual_maxsim",)),
          ("exact int8: maxsim_int8 (K5)", ("maxsim_int8",)),
          ("exact: maxsim (K1)", ("maxsim",)),
          ("top-k cuts", ("topk", "sort", "radix", "kth", "digitcumsum",
                          "withink")))
FINE = "plain fine stage and glue"


def _stage(name: str) -> str:
    low = name.lower()
    for stage, patterns in STAGES:
        if any(p in low for p in patterns):
            return stage
    return FINE


def _time_ms(fn, iters=10, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_events(fn, n=PROFILED_BATCHES):
    """Run fn n times under torch.profiler. Returns {kernel name: [device
    ms summed over the trace, events]}, from the kernel and memcpy/memset
    events of its trace."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out: dict = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            hit = out.setdefault(e["name"], [0.0, 0])
            hit[0] += e["dur"] / 1e3
            hit[1] += 1
    if not out:
        raise RuntimeError("the profiler's trace holds no device kernels")
    return out


def kernel_times(fn, n=PROFILED_BATCHES):
    """Run fn n times under torch.profiler. Returns {kernel name: device
    ms per call} (kernel_events' sums over n)."""
    return {k: ms / n for k, (ms, _) in kernel_events(fn, n).items()}


def _requests(data, n):
    items = data["items"]["train"] + data["items"]["test"]
    return [items[i % len(items)] for i in range(n)]


def _bursts(server, data, n=256):
    out = []
    reqs = _requests(data, n)
    for _ in range(BURSTS):
        d0 = server.dispatches
        t0 = time.perf_counter()
        futs = [server.submit(r["question"], r["image_features"])
                for r in reqs]
        for f in futs:
            f.result(120)
        wall = time.perf_counter() - t0
        out.append({"req_per_s": n / wall,
                    "dispatches": server.dispatches - d0})
    return out


def profile_config(path: str) -> dict:
    cfg = load_config(path)
    t0 = time.perf_counter()
    data = build_pipeline(cfg).get_data(cfg.data_pipeline_output_node,
                                        explode=True)
    server = build_server(cfg, data, "cuda")
    s, ex, k = server.searcher, server.ex, server.cfg.k
    res = {"config": path, "mode": s.mode, "preset": s.preset,
           "docs": s.index.num_docs,
           "setup_s": time.perf_counter() - t0}
    print(f"{path}: {s.mode} {s.preset}, {s.index.num_docs} docs, set-up "
          f"{res['setup_s']:.1f} s", flush=True)
    try:
        res["bursts"] = _bursts(server, data)
        print("bursts of 256:", res["bursts"], flush=True)

        reqs = _requests(data, BATCH)
        ids, mask = map(np.asarray, data["query_tokenizer"].tensorize(
            [r["question"] for r in reqs]))
        feats = np.stack([r["image_features"] for r in reqs])
        with torch.inference_mode():
            res["per_batch"] = {}
            for b in (32, 8, 1):
                q = ex.encode_query(ids[:b], mask[:b], feats[:b])
                enc = _time_ms(lambda: ex.encode_query(ids[:b], mask[:b],
                                                       feats[:b]))
                srch = _time_ms(lambda: s.search_device(q, k))
                res["per_batch"][b] = {"encode_ms": enc, "search_ms": srch}
                print(f"B={b}: encode {enc:.3f} ms, search {srch:.3f} ms",
                      flush=True)

            q = ex.encode_query(ids, mask, feats)
            tower = kernel_times(lambda: ex.encode_query(ids, mask, feats))
            search = kernel_times(lambda: s.search_device(q, k))

            def dispatch():
                server._dispatch([(ids[i], mask[i], feats[i], Future())
                                  for i in range(BATCH)])

            whole = kernel_times(dispatch)
            dispatch()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PROFILED_BATCHES):
                dispatch()
            wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILED_BATCHES
    finally:
        server.stop()
    split = {}
    for name, ms in search.items():
        split[_stage(name)] = split.get(_stage(name), 0.0) + ms
    split["query tower"] = sum(tower.values())
    device_ms = sum(whole.values())
    res["profile"] = {
        "device_ms_per_batch": split,
        "dispatch_device_ms": device_ms,
        "dispatch_wall_ms": wall_ms,
        "device_busy_share": device_ms / wall_ms,
        "top_search_kernels": dict(sorted(search.items(),
                                          key=lambda kv: -kv[1])[:12])}
    print(f"profile, ms per batch of {BATCH}: "
          + ", ".join(f"{n} {ms:.3f}" for n, ms in
                      sorted(split.items(), key=lambda kv: -kv[1])),
          flush=True)
    print(f"dispatch: {device_ms:.3f} ms of kernels in {wall_ms:.3f} ms of "
          f"wall ({device_ms / wall_ms:.1%} busy)", flush=True)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser("ravqa_tpu_torch.profile_serve")
    p.add_argument("configs", nargs="+")
    p.add_argument("--out", default=None, help="JSON file for the results")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA GPU")
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
