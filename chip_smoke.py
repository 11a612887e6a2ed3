#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ravqa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. environment: torch/CUDA versions, the card's name and power limit;
     TF32 off for float32 matmuls and convolutions. No GPU -> exit 1.
  2. build: the MaxSim kernel (csrc/maxsim.cu) from the repo's sources.
  3. the kernel against its plain PyTorch version on the card, at the
     serve shape in float32 and a bf16 index shape: scores, tie-aware
     top-10, and both times (median of 10 after warm-up, CUDA events).
  4. the slice: build_server on configs/synthetic_flmr_base_serve.json
     (FLMR at BERT-base width, 16,384 passages encoded on the card), 64
     requests from 4 threads, every answer checked against a plain search
     of the same index with the executor's own query embeddings, the
     kernel's launch count checked against the dispatches, and the towers
     on the card checked against the same module run on the CPU.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "configs", "synthetic_flmr_base_serve.json")
# float32 scores of L2-normalized embeddings at Lq <= 64: the kernel and
# the plain version sum the same products in different orders, which moves
# a score by ~1e-5; 1e-3 leaves room without hiding a wrong max or mask
ATOL = 1e-3
TOWER_ATOL = 1e-4
K = 10


def phase(name):
    print(f"== {name}", flush=True)


def check_topk(got_full, want_full, k=K, atol=ATOL):
    """Scores agree and the top-k agrees tie-aware: the rows the kernel
    picks carry, under the plain version, the scores the kernel gives."""
    import torch
    err = (got_full - want_full).abs().max().item()
    gv, gi = torch.topk(got_full, k, dim=1)
    wv, _ = torch.topk(want_full, k, dim=1)
    topk_err = max((gv - wv).abs().max().item(),
                   (want_full.gather(1, gi) - gv).abs().max().item())
    if not (err <= atol and topk_err <= atol):
        raise AssertionError(f"kernel disagrees with the plain version: "
                             f"max |score diff| {err}, top-{k} {topk_err}")
    return err


def time_ms(fn, iters=10, warmup=2):
    import torch
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


def kernel_shape(name, b, lq, n, ld, dim, dtype, maxsim):
    import torch
    g = torch.Generator(device="cuda").manual_seed(0)

    def normed(*shape):
        x = torch.randn(*shape, generator=g, device="cuda")
        return (x / x.norm(dim=-1, keepdim=True)).to(dtype)

    q = normed(b, lq, dim)
    q[:, -2:] = 0                                  # zero query rows
    tok = normed(n, ld, dim)
    mask = (torch.rand(n, ld, generator=g, device="cuda") > 0.3).to(
        torch.int8)
    mask[::997] = 0                                # docs with no tokens
    got = maxsim.maxsim_search(q, tok, mask)
    want = maxsim.maxsim_search_torch(q, tok, mask)
    torch.cuda.synchronize()
    empty = got[:, ::997]
    if not torch.equal(empty, torch.full_like(empty, -9999.0 * lq)):
        raise AssertionError("an all-masked doc must score -9999 * Lq")
    err = check_topk(got, want)
    ms = time_ms(lambda: maxsim.maxsim_search(q, tok, mask))
    plain_ms = time_ms(lambda: maxsim.maxsim_search_torch(q, tok, mask))
    flop = 2.0 * b * lq * n * ld * dim
    print(f"{name}: B={b} Lq={lq} N={n} Ld={ld} dim={dim} {dtype}: "
          f"max|err| {err:.3g}; kernel {ms:.3f} ms "
          f"({flop / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms",
          flush=True)
    return err, ms, plain_ms


def check_towers(ex, data, reqs):
    """The executor's towers on its device against the same module run by
    PyTorch on the CPU (the path the CPU tests hold to the JAX package), on
    4 queries and 4 passages at full width. Returns max |error|."""
    import copy
    import torch
    cpu = copy.deepcopy(ex.model).cpu()
    ids, mask = data["query_tokenizer"].tensorize(
        [r["question"] for r in reqs[:4]])
    feats = np.stack([r["image_features"] for r in reqs[:4]])
    di, dm = data["doc_tokenizer"].tensorize(
        data["passages"]["full_passages"].contents[:4])
    with torch.inference_mode():
        q_dev = ex.encode_query(ids, mask, feats).cpu()
        d_dev, _ = ex.encode_doc(di, dm)
        q_cpu = cpu.query(torch.from_numpy(ids).long(),
                          torch.from_numpy(mask), torch.from_numpy(feats))
        d_cpu, _ = cpu.doc(torch.from_numpy(di).long(), torch.from_numpy(dm))
    err = max((q_dev - q_cpu).abs().max().item(),
              (d_dev.cpu() - d_cpu).abs().max().item())
    print(f"towers on {ex.device} vs CPU (4 queries, 4 passages): max|err| "
          f"{err:.3g}", flush=True)
    # unit-norm rows in float32 on both sides (TF32 off): differences are
    # summation order through 12 layers, ~1e-6
    if not err <= TOWER_ATOL:
        raise AssertionError(f"towers disagree with their CPU run: {err}")
    return err


def serve_slice(config_path, device, maxsim):
    """Build the RetrievalServer from a config, answer 64 requests from 4
    threads, check every answer against a plain search of the same index.
    Returns (kernel launches, dispatches, max |score error|)."""
    import torch
    from ravqa_tpu_torch.main import build_pipeline, build_server, load_config
    cfg = load_config(config_path)
    t0 = time.perf_counter()
    data = build_pipeline(cfg).get_data(cfg.data_pipeline_output_node,
                                        explode=True)
    server = build_server(cfg, data, device)
    index = server.searcher.index
    index.tokens.sum().item()                      # wait for the encode
    print(f"setup (pipeline + corpus encode + index) "
          f"{time.perf_counter() - t0:.1f} s; index {index.num_docs} docs, "
          f"{index.tokens.numel() * index.tokens.element_size()} bytes "
          f"{index.tokens.dtype}", flush=True)
    items = data["items"]["train"] + data["items"]["test"]
    reqs = [items[i % len(items)] for i in range(64)]
    lat = [0.0] * len(reqs)
    results = [None] * len(reqs)

    def client(ids):
        for i in ids:
            t = time.perf_counter()
            results[i] = server.submit(reqs[i]["question"],
                                       reqs[i]["image_features"]).result(120)
            lat[i] = time.perf_counter() - t

    try:
        maxsim.maxsim_search.launches = 0
        d0 = server.dispatches
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(range(c, 64, 4),))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        wall = time.perf_counter() - t0
        launches = maxsim.maxsim_search.launches
        dispatches = server.dispatches - d0
    finally:
        server.stop()
    if any(t.is_alive() for t in threads) or None in results:
        raise AssertionError("not every request was answered")
    print(f"64 requests in {dispatches} dispatches: "
          f"{len(reqs) / wall:.1f} req/s, latency p50 "
          f"{np.percentile(lat, 50) * 1e3:.1f} ms, p95 "
          f"{np.percentile(lat, 95) * 1e3:.1f} ms; "
          f"kernel launches {launches}", flush=True)
    pids = np.stack([r.pids for r in results])
    scores = np.stack([r.scores for r in results])
    if pids.shape != (64, K) or not np.isfinite(scores).all() \
            or not ((pids >= 0) & (pids < index.num_docs)).all():
        raise AssertionError("served results are not k valid pids with "
                             "finite scores")
    ids, mask = data["query_tokenizer"].tensorize(
        [r["question"] for r in reqs])
    feats = np.stack([r["image_features"] for r in reqs])
    with torch.inference_mode():
        q = server.ex.encode_query(ids, mask, feats)
        want = maxsim.maxsim_search_torch(q, index.tokens, index.mask)
        got = torch.from_numpy(scores).to(want.device)
        rows = torch.from_numpy(pids).to(want.device)  # pids are index rows
        wv, _ = torch.topk(want, K, dim=1)
        err = max((got - wv).abs().max().item(),
                  (want.gather(1, rows) - got).abs().max().item())
    print(f"served scores vs plain search of the same index: max|err| "
          f"{err:.3g}", flush=True)
    if err > ATOL:
        raise AssertionError(f"served results disagree with the plain "
                             f"search: {err}")
    check_towers(server.ex, data, reqs)
    return launches, dispatches, err


def main():
    if not os.path.isdir(os.path.join(HERE, "ravqa_tpu_torch")):
        raise SystemExit("chip_smoke.py must run from a checkout of the repo")
    sys.path.insert(0, HERE)
    import torch

    phase("1 environment")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA GPU visible: chip_smoke.py needs one")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: matmul False, cudnn False", flush=True)

    phase("2 build")
    from ravqa_tpu_torch.ops import maxsim
    built = maxsim.build_kernel()
    print(f"maxsim kernel built and loaded in {built['seconds']:.2f} s",
          flush=True)
    for line in built["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    phase("3 kernel vs plain")
    err_a, ms_a, plain_a = kernel_shape("serve f32", 32, 64, 16387, 220, 128,
                                        torch.float32, maxsim)
    err_b, ms_b, plain_b = kernel_shape("index bf16", 32, 32, 16384, 128, 128,
                                        torch.bfloat16, maxsim)

    phase("4 serve slice")
    launches, dispatches, err_s = serve_slice(CONFIG, "cuda", maxsim)
    if launches < dispatches or launches == 0:
        raise AssertionError(f"maxsim kernel launched {launches} times for "
                             f"{dispatches} dispatches")

    print(json.dumps({"kernels": [{
        "name": "maxsim_search",
        "route": "cuda",
        "source": "ravqa_tpu_torch/csrc/maxsim.cu",
        "replaces": "ravqa_tpu/ops/maxsim.py:196",
        "launches": launches,
        "max_abs_err": max(err_a, err_b, err_s),
        "ms": ms_a,
        "plain_ms": plain_a,
        "bf16_ms": ms_b,
        "bf16_plain_ms": plain_b}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
