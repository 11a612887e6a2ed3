"""Finding a cell's pieces by name: BENCHMARK.json at the checkout's root
names the cell's configuration, traffic and metrics; each lives in a file
of its own under portbench/, so a later change adds a cell, a traffic
mix, a configuration or a metric with new files and entries only.

- portbench/workloads/<cell>.json: the cell's settings (its kind, the
  server's or trainer's settings, and the limits of its check);
- portbench/cells/<kind>.py: what builds, runs and checks a cell of that
  kind (portbench/cells/__init__.py);
- the configuration's `file` (portbench/configs/<config>.json);
- portbench/traffic/<traffic>.json: the traffic mix's parameters, read by
  the one generator (portbench/generator.py), which sends by the mix's
  arrival process, portbench/arrivals/<arrival>.py;
- portbench/e2e_metrics/<name>.py and portbench/layer_metrics/<name>.py:
  one reader per metric, found by its whole name with each dot an
  underscore, else by the part before the first dot (`batch_fill.burst`
  -> batch_fill_burst.py, else batch_fill.py);
- portbench/flops/<config>.py: the model FLOPs the mfu readers use.
"""

from __future__ import annotations

import importlib
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def part(folder: str, name: str):
    """The module portbench/<folder>/<name>.py, imported as a part of the
    package (so it may import the harness's other modules)."""
    if not os.path.exists(os.path.join(HERE, folder, name + ".py")):
        raise FileNotFoundError(f"no portbench/{folder}/{name}.py")
    return importlib.import_module(f"{__package__}.{folder}.{name}")


def reader(folder: str, metric: str):
    """The reader module of `metric` in portbench/<folder>/."""
    for stem in (metric.replace(".", "_"), metric.split(".")[0]):
        if os.path.exists(os.path.join(HERE, folder, stem + ".py")):
            return part(folder, stem)
    raise FileNotFoundError(f"no reader for metric {metric!r} in "
                            f"portbench/{folder}/")


def cell_module(cell):
    """The module of the cell's kind, portbench/cells/<kind>.py."""
    return part("cells", cell.work["kind"])


class Cell:
    """Everything one cell's run reads, by the names in BENCHMARK.json."""

    def __init__(self, name: str, overrides: dict | None = None):
        bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entries[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.cfg = _json(os.path.join(ROOT, self.config_entry["file"]))
        self.work = _json(os.path.join(HERE, "workloads", name + ".json"))
        self.traffic = _json(os.path.join(HERE, "traffic",
                                          self.entry["traffic"] + ".json"))
        for key, val in (overrides or {}).items():
            _merge(getattr(self, key), val)
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._has(m)
                          and self._moves_here(m)]
        self.flops = part("flops", self.entry["config"])

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def _moves_here(self, metric: dict) -> bool:
        return any(m["name"] == metric["moves"] for m in self.end_to_end)


def _merge(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v
