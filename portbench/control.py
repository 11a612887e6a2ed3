"""The readings that the limits of `correct` are set from, on the card at
a cell's own sizes (the benchmark's runs never run them): each cell
kind's `controls` (portbench/cells/<kind>.py), on each seed. With
--program, the program's own readings on each seed too: a dozen seeds'
lower readings in one process.

    python3 -m portbench.control --workload flmr_exact_burst \\
        --seeds 11,12,13 [--program]

Prints one JSON line per seed and reading.
"""

from __future__ import annotations

import argparse
import gc
import json

import torch

from .spec import Cell, cell_module


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program", action="store_true",
                   help="also read the program on each seed")
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Cell(args.workload)
    kind = cell_module(cell)
    device = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        rows = kind.controls(cell, seed, device, args.program)
        for name, numbers in rows.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": name, **numbers}), flush=True)
        del rows
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
