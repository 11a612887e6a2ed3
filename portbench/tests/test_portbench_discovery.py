"""A later change adds a cell, a traffic mix with its own arrival
process, a cell kind and a per-layer metric with new files and
BENCHMARK.json entries only: the harness finds each by its name and runs
the cell."""

import json
import os
import shutil

from portbench.tests import _tiny

RUN = """
import json, time
from portbench.run import run_cell
from portbench.spec import Cell, reader
from portbench.tests import _tiny
over = _tiny.overrides("flmr_exact_burst")
over["traffic"] = {{"pool": 64, "question_words": [2, 6]}}
cell = Cell("flmr_exact_small", overrides=over)
assert [m["name"] for m in cell.per_layer] == ["batch_fill.small"], \\
    cell.per_layer
assert reader("layer_metrics", "batch_fill.small").read
assert reader("layer_metrics", "queue_depth").TAG == "new reader"
assert cell.work["kind"] == "flmr_serve_copy"
r = run_cell("flmr_exact_small", 9, 0.5, False, "cpu", time.perf_counter(),
             overrides=over)
from portbench.arrivals import steady
print(json.dumps({{"correct": r["correct"], "sent": steady.SENT,
                   "metrics": sorted(r["metrics"])}}))
"""


STEADY = """
import time

SENT = 0


def send_all(w):
    global SENT
    i = 0
    while time.perf_counter() < w.end:
        w.send(i, due=time.perf_counter())
        i += 1
        time.sleep(w.traffic["gap_s"])
    SENT = i
    return i
"""


def test_a_cell_added_as_files_and_entries_runs(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(_tiny.ROOT, "portbench"),
                    root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(_tiny.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    pb = root / "portbench"
    (pb / "traffic" / "steady8.json").write_text(json.dumps(
        {"arrival": "steady", "gap_s": 0.01, "question_words": [2, 6],
         "pool": 64, "image_pool": 8}))
    (pb / "arrivals" / "steady.py").write_text(STEADY)
    (pb / "cells" / "flmr_serve_copy.py").write_text(
        "from portbench.cells.flmr_serve import build, controls, run\n"
        "__all__ = ['build', 'controls', 'run']\n")
    work = json.loads((pb / "workloads" / "flmr_exact_burst.json")
                      .read_text())
    work["kind"] = "flmr_serve_copy"
    work["serve"]["batch_buckets"] = [8]
    (pb / "workloads" / "flmr_exact_small.json").write_text(
        json.dumps(work))
    (pb / "layer_metrics" / "queue_depth.py").write_text(
        'TAG = "new reader"\n\n\ndef read(ctx):\n    return None\n')
    bench["workloads"].append(
        {"name": "flmr_exact_small", "config": "flmr_base_okvqa",
         "traffic": "steady8", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "qps":
            m["workloads"].append("flmr_exact_small")
    bench["per_layer"].append(
        {"name": "batch_fill.small", "unit": "%", "better": "higher",
         "source": "program_counter", "layer": "serving.py micro-batcher",
         "moves": "qps", "workloads": ["flmr_exact_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _tiny.python(RUN.format(), str(root), [str(root), _tiny.ROOT])
    r = json.loads(out.strip().splitlines()[-1])
    assert r["correct"] and r["metrics"] == ["qps", "setup_s"]
    assert r["sent"] > 0
