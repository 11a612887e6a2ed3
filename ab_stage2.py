#!/usr/bin/env python3
"""X1 and the residual stage-2 experiment on several checkouts of the port,
in turns, in one run on one card: how a change of X1 is compared with its
parent.

    python3 ab_stage2.py PARENT . . PARENT [--lq 64]

Each ROOT (a checkout; a parent, e.g., a `git archive` unpacked into a
directory that .gitignore lists) runs in a process of its own, with its own
ravqa_tpu_torch, on the same inputs: phase 11's, made by
`stage2_inputs` of the chip_smoke.py beside this script (Lq 32 unless
--lq). For each shape it prints X1's max |error| against the plain
version, the wrapper's median of 10 (CUDA events), the kernel's device time
(torch.profiler) and the bound (`x1_bound`); at Lq = 32, the experiment's,
then every round of the stage-2 experiment (phase 12). Also X1's ptxas
registers and spills. Each process ends with a line `RESULT {json}`. TF32 is
off, as in chip_smoke.py.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def run_root(root, lq):
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from ravqa_tpu_torch.ops import maxsim, stage2
    log = maxsim.build_kernels()["ravqa_residual_lut_maxsim"]["log"]
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)
    res = {"root": root, "lq": lq}
    for shape, x1, _ in cs.stage2_inputs(lq):
        got = stage2.fused_lut_maxsim(**x1)
        want = stage2.fused_lut_maxsim_torch(**x1)
        res[shape] = {
            "err": (got - want).abs().max().item(),
            "ms": cs.time_ms(lambda: stage2.fused_lut_maxsim(**x1)),
            "device_ms": cs.device_ms(lambda: stage2.fused_lut_maxsim(**x1),
                                      "lut_maxsim_kernel"),
            "bound_ms": cs.x1_bound(x1, got)["bound_ms"]}
        print(shape, res[shape], flush=True)
        del x1, got, want
    torch.cuda.empty_cache()
    if lq == 32:
        res["times"] = cs.stage2_experiment()["times"]
    print("RESULT", json.dumps(res), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="checkouts, run in this order")
    ap.add_argument("--lq", type=int, default=32,
                    help="query tokens (the experiment runs at 32 only)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        run_root(args.roots[0], args.lq)
        return
    for root in args.roots:
        root = os.path.abspath(root)
        print(f"== {root} (Lq {args.lq})", flush=True)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        "--lq", str(args.lq), root], check=True)


if __name__ == "__main__":
    main()
