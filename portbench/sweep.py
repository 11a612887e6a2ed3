"""Find the highest open-loop rate a serve cell's server sustains: one
server built as the cell builds it, then a window of Poisson arrivals at
each rate in turn. A rate is sustained when at least 99 % of the requests
sent answered by the window's end or within a second after it, the
backlog at the window's end (sent, not yet answered) is under two
max_batch (one dispatch in flight and one filling: a request waits out
the dispatch in flight, then rides the next), and the p95 of the
window's second half is not above the first half's by more than 10 %.

    python3 -m portbench.sweep --workload flmr_exact_burst --seed 7 \\
        --seconds 20 --rates 150,170,185,195

Prints one JSON line per rate. A cell's open-loop traffic file then
states about four fifths of the highest sustained rate as a number; the
benchmark's runs never search for it.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from . import generator, inputs
from .spec import ROOT, Cell, cell_module
from .trace import Tracer


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Cell(args.workload)
    tracer = Tracer(False)
    device = torch.device("cuda")
    server, state = cell_module(cell).build(cell, args.seed, device,
                                os.path.join(ROOT, ".portbench_cache"),
                                tracer.span)
    reqs = inputs.Requests(
        {**cell.traffic, "arrival": "poisson"}, args.seed,
        inputs.vocab_words(state["vocab_size"]),
        feature_dim=server.image_feature_dim,
        pixel_shape=server.pixel_shape, device=device)
    for rate in (float(r) for r in args.rates.split(",")):
        traffic = {**cell.traffic, "arrival": "poisson", "rate": rate}
        log = generator.drive(server, reqs, traffic, args.seed, args.seconds,
                              time.perf_counter(), tracer.span)
        lat = np.asarray(log.latencies_ms)
        half = len(lat) // 2
        row = {"rate": rate, "sent": log.attempted,
               "answered_in_window": log.completed_in_window,
               "backlog_at_end": log.attempted - log.completed_in_window,
               "p95_ms": float(np.percentile(lat, 95)),
               "p95_first_half_ms": float(np.percentile(lat[:half], 95)),
               "p95_second_half_ms": float(np.percentile(lat[half:], 95)),
               "gen_lag_p95_ms": float(np.percentile(log.lags_ms, 95))}
        row["sustained"] = (
            row["answered_in_window"] >= 0.99 * row["sent"] - rate
            and row["backlog_at_end"] < 2 * cell.work["serve"]["max_batch"]
            and row["p95_second_half_ms"] <= 1.1 * row["p95_first_half_ms"])
        print(json.dumps(row), flush=True)
    server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
