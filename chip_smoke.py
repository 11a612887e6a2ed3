#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ravqa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. environment: torch/CUDA versions, the card's name and power limit;
     TF32 off for float32 matmuls and convolutions. No GPU -> exit 1.
  2. build: every CUDA library of the port (csrc/maxsim_mma.cu: K1 on the
     tensor cores, a bf16 index or a float32 one as two bf16 planes,
     csrc/coarse_sweep.cu: K2 + K3 (K2's bf16 body and K3 on the tensor
     cores, csrc/summary_tile.cuh), csrc/stage1_sweep.cu: K4 (bf16 and
     int8 rows on the same tensor-core sweep, float32 rows on the CUDA
     cores), csrc/maxsim_int8.cu: K5, csrc/residual_maxsim.cu: K6,
     csrc/residual_lut_maxsim.cu: X1, csrc/candidate_maxsim.cu: X2 and X3,
     both on the tensor cores)
     from the repo's sources, the nvcc runs side by side; ptxas
     registers/spills.
  3. K1 against its plain PyTorch version on the card: a bf16 index
     ("K1") with a bf16 query (Ld=128) and with a float32 query split in
     two bf16 parts (Ld=64); a float32 index ("K1-f32") at the float32
     serve shape, read as two bf16 planes (hi.hi + lo.hi + hi.lo; the run
     fails unless that split route launched): scores, tie-aware top-10,
     an all-masked doc at exactly -9999 x Lq, both times (median of 10
     after warm-up, CUDA events), TFLOP/s and the bound (bf16 operations
     of every product the split takes; the CUDA cores' float32 bound
     beside it).
  4. the exact slice: build_server on configs/synthetic_flmr_base_serve.json
     (FLMR at BERT-base width, 16,384 passages encoded on the card), 64
     requests from 4 threads, every answer checked against a plain search
     of the same index with the executor's own query embeddings, K1's
     launch count checked against the dispatches (every one on the float32
     index's split route), the planes' bytes beside the index's, and the
     towers on the card checked against the same module run on the CPU.
  5. K2, K3 and K4 against their plain versions at the bench.py shape
     (B=32, Lq=32, dim=128; 112,640 docs x 8 summaries; 1,760 x 4 block
     summaries padded to 2,048; bs=64, n_blocks 16 and 32) and K3 and K4
     at the hierarchical serve's (Lq=64; 256 of 1,024 padded blocks x 4
     summaries; int8 rows, n_blocks 32 of 256 blocks x 8 summaries):
     scores, tie-aware top-10, K3's pre-scale sums exactly, invalid docs at
     exactly -9999, the wrapper's and the plain version's times, each
     kernel's launch alone beside them ("kernel_ms", CUDA events) and its
     device time from torch.profiler's trace ("device_ms"); the run fails
     unless K2's wrapper ran the tensor-core body on bf16 summaries.
  6. pruned search at the bench scale: a clustered bf16 index of 112,640
     docs x 128 tokens made on the card (bench.py's recipe), summaries and
     block summaries, then LateInteractionSearcher in hierarchical (fast,
     reference) and two_stage (fast, reference) mode: recall@10 against
     exact search (K1, which must take the MMA route) and ms per batch of
     32 and each search's launches, the exact search's beside its bound;
     hierarchical fast must reach recall 0.95, K2, K3 and K4 must each
     launch, and both reference searches must launch K2.
  7. the hierarchical slice: build_server on
     configs/synthetic_flmr_base_serve_hier.json (preset fast), 64
     requests from 4 threads, every answer checked against the same
     search run by the plain versions on a CPU copy of the index, on the
     query embeddings each dispatch searched; K3 and
     K4 launches at least the dispatches; recall@10 against exact search
     printed (not gated: the weights are random).
  8. K5 and K6 against their plain versions: K5 at B=32, N=16,384, Lq=32
     with Ld 128 and 64, and Lq=64 with Ld 220 (TOP/s beside each); K6
     (on the tensor cores) at the 1M fine-stage shape (B=32, Lq=32,
     C=256, Ld=64, dim 128) with a flat codec of 1,024 centroids and a
     factored one of 64 x 128, nbits 2 and 4, and at the residual serve's
     shape (Lq=64, Ld=220, C=256, factored, nbits 2): max |err|, tie-aware
     top-10 and both times; K6's launch alone ("kernel_ms") and its device
     time ("device_ms").
  9. the 1M legs: 1,000,448 docs x 64 tokens x 128 dims, clustered over
     8,192 topics and cluster-ordered (scripts/synth1m.py's recipe), made
     on the card; S=4 summaries, block size 64; B=32, Lq=32 queries from
     docs 0-31 plus 0.1 noise, k=10, preset fast. Legs: exact K1 on the
     bf16 index (the oracle); the int8 index exact (K5) and hierarchical
     (K3, K4); the residual index (nbits 2, factored 64 x 128 codec)
     hierarchical (K3, K4, K6). Each: recall@10 against exact K1,
     self-top-1, ms per batch, bytes on the card; the exact K1 and K5
     legs beside their bounds (K1's counts the bf16 operations of both
     parts of the float32 query). Gates: recall >= 0.95 on both int8
     legs, self-top-1 >= 0.95 on every leg, every kernel of a leg
     launches, the exact leg's K1 on the MMA route.
 10. the compressed serve slice: phase 7's index copied into an int8 index
     served in exact mode (K5) and a residual one (factored 64 x 128,
     nbits 2) served hierarchical fast (K3, K4, K6), each behind
     RetrievalServer; 64 requests from 4 threads, every answer checked
     against the same search run by the plain versions on a CPU copy of
     the compressed index, on the query embeddings each dispatch searched
     (as in 7); each kernel launches at least once per dispatch;
     then the search alone, ms per batch of 32.
 11. X1, X2, X3 against their plain versions at the stage-2 experiment's
     shape (B=32, Lq=32, Ld=64, dim 128) at C = 1,024, 256 and 200 (a
     multiple of neither the TPU tiles' 32 nor 128), ~30 % of the tokens
     masked and one candidate of every query with none: max |err| and
     tie-aware top-10 at 1e-3; X2 batched, X3 the same kernel once per
     query (B launches of B = 1); both times (median of 10, CUDA events),
     X1's and X2's launches alone, and X1's, X2's and X3's device times
     from the profiler (X3's also per launch). X1's bound counts the bytes
     of the mask and of the scored rows only (a masked row's ids, centroid
     scores and scale do not change its -9999) and the bf16 operations of
     its three products (the weights and the query as two bf16 parts
     each); the CUDA cores' float32 bound beside it.
 12. the residual stage-2 experiment: ravqa_tpu_torch.scripts.
     exp_residual_stage2.run() with every round at the script's full
     widths (N = 200,064, then 1,000,448 docs of records made on the card,
     about 2.3 GB), every variant's ms per batch and rel-err line printed.
     Gates: each kernel route against its plain twin on the same inputs to
     1e-3; the launches of X1 (fused_lut_maxsim), X2 and X3
     (candidate_maxsim batched and once per query, B a batch) equal what
     the run called; no round raises.
Every phase prints its seconds. The line before the last is the kernels'
JSON record: each kernel's launches on its path, its error against its
plain version, its time and its plain version's, and its bound, the least
time the card could take for the same work (the larger of the bytes it
must move over 3.35 TB/s and its operations over the data sheet's peak for
their type), at the shape its "ms" was taken; library_ms is null, since
no single PyTorch call computes any of these functions. The last line is
{"ok": true, "device": {...}}.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "configs", "synthetic_flmr_base_serve.json")
HIER_CONFIG = os.path.join(HERE, "configs",
                           "synthetic_flmr_base_serve_hier.json")
# float32 scores of L2-normalized embeddings at Lq <= 64: the kernel and
# the plain version sum the same products in different orders, which moves
# a score by ~1e-5; 1e-3 leaves room without hiding a wrong max or mask
ATOL = 1e-3
TOWER_ATOL = 1e-4
# summary sweeps: the kernel and the plain version sum the same float32
# products (bf16 and int8 values are exact in float32) in another order;
# scores are sums of 32 maxima of unit-vector products, so the order moves
# them by ~1e-5, and 1e-3 leaves room without hiding a wrong max or slot
SWEEP_ATOL = 1e-3
K = 10


_PHASE_START = [time.perf_counter()]


def phase(name):
    now = time.perf_counter()
    print(f"(phase took {now - _PHASE_START[0]:.1f} s)\n== {name}",
          flush=True)
    _PHASE_START[0] = now


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


# NVIDIA H100 SXM data sheet, dense: device memory rate and peak operation
# rates by the type the operations take (float32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}


def bound(nbytes, ops, kind):
    """The least time the card could take for a kernel's work: bytes it
    must move (each input read once, each output written once) over the
    memory rate, or its operations over the peak rate of their type,
    whichever is larger. Returns {"bound_ms", "bound_by", "bytes", "ops"}."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops, "ops_type": kind}


def record_kernel(out, kernel, shape, err, fn, plain_fn, bnd, ops=None):
    """Time a kernel's wrapper and its plain version (median of 10, CUDA
    events) and keep them, its error and its bound in out[kernel]: under
    "shapes" for each shape, and the first shape's at the top. `ops`, the
    function's operations, adds the rate reached (tera_ops_per_s)."""
    ms, plain_ms = time_ms(fn), time_ms(plain_fn)
    o = out[kernel]
    o["err"] = max(o["err"], err)
    o["shapes"][shape] = {"ms": ms, "plain_ms": plain_ms, **bnd}
    if ops is not None:
        o["shapes"][shape]["tera_ops_per_s"] = ops / ms / 1e9
    for key, v in (("ms", ms), ("plain_ms", plain_ms),
                   ("bound_ms", bnd["bound_ms"]),
                   ("bound_by", bnd["bound_by"])):
        o.setdefault(key, v)                       # the first shape's
    print(f"{kernel} {shape}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})", flush=True)


def device_ms(fn, pattern, launches=1):
    """The device time per call of the kernels whose lowercased name holds
    `pattern`, `launches` of them a call, from torch.profiler's trace of 10
    calls: the kernel's own time, where CUDA events around a small launch
    also count the host's enqueue. It is the mean of the launches the trace
    holds times `launches`: a trace late in a long run has been seen to
    keep 1 of a kernel's 10 launches (the run prints how many it kept)."""
    from ravqa_tpu_torch.profile_serve import kernel_events
    hit = [v for k, v in kernel_events(fn, n=10).items()
           if pattern in k.lower()]
    if not hit:
        raise AssertionError(f"the profiler saw no kernel like {pattern!r}")
    ms, events = (sum(x) for x in zip(*hit))
    if events != 10 * launches:
        print(f"  (the trace kept {events} of the {10 * launches} launches "
              f"like {pattern!r})", flush=True)
    return ms / events * launches


def maxsim_bound(maxsim, q, tok, mask):
    """K1's bound for q against tok: the bf16 operations of every product
    the route takes (a float32 query in two parts, a float32 index in two
    planes: hi.hi + lo.hi + hi.lo), with a note saying so; for a float32
    index also the CUDA cores' float32 bound of the same function
    ("f32_bound_ms"). Returns (bound dict, the function's FLOP)."""
    b, lq, dim = q.shape
    n, ld, _ = tok.shape
    flop = 2.0 * b * lq * n * ld * dim
    route = maxsim.maxsim_route(q.dtype, tok.dtype)
    products = maxsim.route_products(route)
    nbytes = _nbytes(q, tok, mask) + 4 * b * n
    bnd = bound(nbytes, flop * products, "bf16")
    if products > 1:
        bnd["bound_note"] = (f"bf16 operations of the {products} products "
                             f"of {route.parts} query parts and "
                             f"{route.planes} index planes")
    if route.planes > 1:
        bnd["f32_bound_ms"] = bound(nbytes, flop, "f32")["bound_ms"]
    return bnd, flop


def kernel_shape(out, key, shape, b, lq, n, ld, dim, q_dtype, t_dtype,
                 maxsim):
    """K1 against its plain version at one shape, kept in out[key] by
    record_kernel; an all-masked doc must score exactly -9999 * Lq."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(0)

    def normed(*shape, dtype):
        x = torch.randn(*shape, generator=g, device="cuda")
        return (x / x.norm(dim=-1, keepdim=True)).to(dtype)

    q = normed(b, lq, dim, dtype=q_dtype)
    q[:, -2:] = 0                                  # zero query rows
    tok = normed(n, ld, dim, dtype=t_dtype)
    mask = (torch.rand(n, ld, generator=g, device="cuda") > 0.3).to(
        torch.int8)
    mask[::997] = 0                                # docs with no tokens
    route = maxsim.maxsim_route(q_dtype, t_dtype)
    # a float32 index's planes, made once as the searcher keeps them
    planes = (maxsim.split_index_bf16(tok, route.planes)
              if route.planes > 1 else None)
    split0 = maxsim.maxsim_search.split_launches
    got = maxsim.maxsim_search(q, tok, mask, planes=planes)
    want = maxsim.maxsim_search_torch(q, tok, mask)
    torch.cuda.synchronize()
    if (maxsim.maxsim_search.split_launches - split0) != (route.planes > 1):
        raise AssertionError(f"{key}: K1 did not take the route {route}")
    empty = got[:, ::997]
    if not torch.equal(empty, torch.full_like(empty, -9999.0 * lq)):
        raise AssertionError("an all-masked doc must score -9999 * Lq")
    err = check_topk(got, want)
    print(f"{key} {shape}: route {tuple(route)}, max|err| {err:.3g}",
          flush=True)
    bnd, flop = maxsim_bound(maxsim, q, tok, mask)
    record_kernel(out, key, shape, err,
                  lambda: maxsim.maxsim_search(q, tok, mask, planes=planes),
                  lambda: maxsim.maxsim_search_torch(q, tok, mask), bnd,
                  ops=flop)
    print(f"  {out[key]['shapes'][shape]['tera_ops_per_s']:.1f} TFLOP/s"
          + (f"; the CUDA cores' float32 bound {bnd['f32_bound_ms']:.3f} ms"
             if "f32_bound_ms" in bnd else ""), flush=True)


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


def drive_requests(server, data, index, wrappers, n=64, clients=4):
    """Send n requests from `clients` closed-loop threads and stop the
    server. Every wrapper's launch count is set to 0 just before and read
    just after. Returns (requests, scores (n, K), pids (n, K), launches per
    wrapper, dispatches)."""
    items = data["items"]["train"] + data["items"]["test"]
    reqs = [items[i % len(items)] for i in range(n)]
    lat = [0.0] * n
    results = [None] * n

    def client(ids):
        for i in ids:
            t = time.perf_counter()
            results[i] = server.submit(reqs[i]["question"],
                                       reqs[i]["image_features"]).result(120)
            lat[i] = time.perf_counter() - t

    try:
        for w in wrappers:
            w.launches = 0
        d0 = server.dispatches
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client,
                                    args=(range(c, n, clients),))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        wall = time.perf_counter() - t0
        launches = [w.launches for w in wrappers]
        dispatches = server.dispatches - d0
    finally:
        server.stop()
    if any(t.is_alive() for t in threads) or None in results:
        raise AssertionError("not every request was answered")
    print(f"{n} requests in {dispatches} dispatches: "
          f"{n / wall:.1f} req/s, latency p50 "
          f"{np.percentile(lat, 50) * 1e3:.1f} ms, p95 "
          f"{np.percentile(lat, 95) * 1e3:.1f} ms; kernel launches "
          f"{dict(zip((w.__name__ for w in wrappers), launches))}",
          flush=True)
    pids = np.stack([r.pids for r in results])
    scores = np.stack([r.scores for r in results])
    if pids.shape != (n, K) or not np.isfinite(scores).all() \
            or not ((pids >= 0) & (pids < index.num_docs)).all():
        raise AssertionError("served results are not k valid pids with "
                             "finite scores")
    return reqs, scores, pids, launches, dispatches


def encode_requests(server, data, reqs):
    """The executor's query embeddings of `reqs`, on its device."""
    import torch
    ids, mask = data["query_tokenizer"].tensorize(
        [r["question"] for r in reqs])
    feats = np.stack([r["image_features"] for r in reqs])
    with torch.inference_mode():
        return server.ex.encode_query(ids, mask, feats)


def start_server(config_path, device):
    """build_server from a config, as the entry point does. Returns (data,
    server, index)."""
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
          f"{index.tokens.dtype}; search mode {server.searcher.mode}",
          flush=True)
    return data, server, index


def serve_slice(config_path, device, maxsim):
    """Build the RetrievalServer from a config, answer 64 requests from 4
    threads, check every answer against a plain search of the same index.
    Returns (kernel launches, dispatches, max |score error|)."""
    import torch
    data, server, index = start_server(config_path, device)
    planes = index.token_planes()          # made by the warm-up's search
    print(f"index planes (bf16 hi | lo, made by the searcher's first "
          f"search): {_nbytes(planes)} bytes, {tuple(planes.shape)}",
          flush=True)
    maxsim.maxsim_search.split_launches = 0
    reqs, scores, pids, launches, dispatches = drive_requests(
        server, data, index, [maxsim.maxsim_search])
    launches = launches[0]
    if maxsim.maxsim_search.split_launches != launches:
        raise AssertionError(f"{maxsim.maxsim_search.split_launches} of "
                             f"{launches} K1 launches took the float32 "
                             f"index's split route")
    q = encode_requests(server, data, reqs)
    with torch.inference_mode():
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


def _normed(g, *shape, dtype):
    import torch
    x = torch.randn(*shape, generator=g, device="cuda")
    return (x / x.norm(dim=-1, keepdim=True)).to(dtype)


def _compare(name, got, want, atol=SWEEP_ATOL):
    """check_topk plus the report line; returns max |error|."""
    err = check_topk(got, want, atol=atol)
    print(f"  {name}: max|err| {err:.3g}", flush=True)
    return err


def sweep_kernels(maxsim):
    """K2, K3 and K4 against their plain versions at the bench.py shapes
    and, for K3 and K4, at the hierarchical serve's. Each also times the
    kernel alone ("kernel_ms", launch_coarse_bf16 / launch_coarse_int8 /
    launch_stage1 on the inputs the wrapper prepares) and its device time
    from the profiler ("device_ms"); K2 fails unless the wrapper's trace
    holds the tensor-core body. Returns {kernel: {"err", "ms", "plain_ms",
    "shapes": {...}}}."""
    import torch
    from ravqa_tpu_torch.ops.quant import (quantize_queries_int8,
                                           quantize_summaries_int8,
                                           quantize_summaries_t_int8)
    g = torch.Generator(device="cuda").manual_seed(1)
    b, dim, bs = 32, 128, 64
    queries = {}
    for lq in (32, 64):
        queries[lq] = _normed(g, b, lq, dim, dtype=torch.float32)
        queries[lq][:, -2:] = 0                    # zero query rows
    out = {k: {"err": 0.0, "shapes": {}} for k in ("K2", "K3", "K4")}

    # the tensor-core sweep's instances, by their Op's name
    ops_name = {"K2": "coarsebf16op", "K3": "coarseint8op",
                "K4": "stage1op"}

    def record(kernel, shape, err, fn, plain_fn, bnd, kernel_fn=None):
        record_kernel(out, kernel, shape, err, fn, plain_fn, bnd)
        if kernel_fn is not None:
            o = out[kernel]["shapes"][shape]
            o["kernel_ms"] = time_ms(kernel_fn)
            o["device_ms"] = device_ms(kernel_fn, ops_name[kernel])
            print(f"  {kernel} {shape}: the launch alone "
                  f"{o['kernel_ms']:.4f} ms, the kernel's device time "
                  f"{o['device_ms']:.4f} ms", flush=True)

    summ_docs = None
    # two-stage coarse pass: 112,640 docs x 8 summaries; hierarchical
    # stage 0: 1,760 blocks x 4 summaries, zero-padded to 2,048; the
    # hierarchical serve's stage 0 (K3 only): 256 blocks padded to 1,024,
    # Lq = 64 (32 text + 32 mapping tokens)
    for shape, s_, n, n_valid, lq in (
            ("docs S=8 N=112640", 8, 112640, None, 32),
            ("blocks S=4 N=2048", 4, 2048, 1760, 32),
            ("serve blocks Lq=64 S=4 N=1024", 4, 1024, 256, 64)):
        q = queries[lq]
        summ_t = _normed(g, s_, n, dim, dtype=torch.bfloat16)
        valid = torch.ones(n, dtype=torch.int8, device="cuda")
        if n_valid is None:
            valid[::997] = 0                       # docs with no tokens
            summ_docs = summ_t.transpose(0, 1).contiguous()
        else:
            valid[n_valid:] = 0
            summ_t[:, n_valid:] = 0
        invalid = valid == 0
        ops = 2.0 * b * lq * s_ * n * dim
        if lq == 32:
            got = maxsim.coarse_sweep(q, summ_t, valid)
            want = maxsim.coarse_sweep_torch(q, summ_t, valid)
            torch.cuda.synchronize()
            if not bool((got[:, invalid] == -9999.0).all()):
                raise AssertionError("K2: an invalid doc must score -9999")
            err = _compare(f"K2 bf16 {shape}", got, want)
            qc = q.bfloat16()
            record("K2", shape, err,
                   lambda: maxsim.coarse_sweep(q, summ_t, valid),
                   lambda: maxsim.coarse_sweep_torch(q, summ_t, valid),
                   bound(_nbytes(q, summ_t, valid, got), ops, "bf16"),
                   lambda: maxsim.launch_coarse_bf16(qc, summ_t, valid))
            # the wrapper's own trace: bf16 summaries on the tensor cores
            wrapper_dev = device_ms(
                lambda: maxsim.coarse_sweep(q, summ_t, valid),
                ops_name["K2"])
            out["K2"]["shapes"][shape]["wrapper_device_ms"] = wrapper_dev
            print(f"  K2 {shape}: the wrapper ran summary_kernel"
                  f"<CoarseBf16Op>, {wrapper_dev:.4f} ms on the device",
                  flush=True)

        st8, dsc = quantize_summaries_t_int8(summ_t)
        q8, qs = quantize_queries_int8(q)
        ones_q, ones_d = torch.ones_like(qs), torch.ones_like(dsc)
        raw = maxsim.coarse_sweep_int8(q8, ones_q, st8, ones_d, valid)
        raw_want = maxsim.coarse_sweep_int8_torch(q8, ones_q, st8, ones_d,
                                                  valid)
        torch.cuda.synchronize()
        if not torch.equal(raw, raw_want):
            raise AssertionError(
                f"K3: pre-scale sums of int32 maxima differ from the plain "
                f"version: max {(raw - raw_want).abs().max().item()}")
        print(f"  K3 int8 {shape}: pre-scale sums equal exactly (max "
              f"|sum| {raw_want[:, ~invalid].abs().max().item():.0f})",
              flush=True)
        got = maxsim.coarse_sweep(q, st8, valid, dscale=dsc)
        want = maxsim.coarse_sweep_torch(q, st8, valid, dscale=dsc)
        torch.cuda.synchronize()
        if not bool((got[:, invalid] == -9999.0).all()):
            raise AssertionError("K3: an invalid doc must score -9999")
        err = _compare(f"K3 int8 {shape}", got, want)
        record("K3", shape, err,
               lambda: maxsim.coarse_sweep(q, st8, valid, dscale=dsc),
               lambda: maxsim.coarse_sweep_torch(q, st8, valid, dscale=dsc),
               bound(_nbytes(q, st8, dsc, valid, got), ops, "int8"),
               lambda: maxsim.launch_coarse_int8(q8, qs, st8, dsc, valid))

    # hierarchical stage 1 over the docs' summaries: 1,760 blocks of 64,
    # and the serve's 256 blocks of 64 docs x 8 summaries at Lq = 64
    rows = maxsim.stage1_rows(summ_docs, bs)
    si8, ssc = quantize_summaries_int8(summ_docs)
    rows8 = maxsim.stage1_rows(si8, bs)
    serve_docs = _normed(g, 256 * bs, 8, dim, dtype=torch.float32)
    serve_i8, serve_sc = quantize_summaries_int8(serve_docs)
    serve_rows8 = maxsim.stage1_rows(serve_i8, bs)
    cases = [(f"{label} rows n_blocks={nbl}", 32, nbl, r, dscale)
             for nbl in (32, 16)
             for label, r, dscale in (("int8", rows8, ssc),
                                      ("bf16", rows, None))]
    cases.append(("serve int8 rows Lq=64 n_blocks=32 of 256", 64, 32,
                  serve_rows8, serve_sc))
    for shape, lq, nbl, r, dscale in cases:
        q = queries[lq]
        nb = r.shape[0]
        blk = torch.rand(b, nb, generator=g, device="cuda").argsort(
            dim=1)[:, :nbl]
        got = maxsim.stage1_sweep(q, r, blk, dscale=dscale)
        want = maxsim.stage1_sweep_torch(q, r, blk, dscale=dscale)
        err = _compare(f"K4 {shape}", got, want)
        # the rows of the blocks some query selected, each read once;
        # int8 rows are products in bf16 (the TPU kernel's cast)
        used = torch.unique(blk).numel()
        nbytes = (_nbytes(q, blk, got) + used * r[0].numel()
                  * r.element_size()
                  + (0 if dscale is None else used * bs * 4))
        qc, blk32 = q.bfloat16(), blk.to(torch.int32).contiguous()
        record("K4", shape, err,
               lambda: maxsim.stage1_sweep(q, r, blk, dscale=dscale),
               lambda: maxsim.stage1_sweep_torch(q, r, blk, dscale=dscale),
               bound(nbytes, 2.0 * b * lq * nbl * r.shape[1] * bs * dim,
                     "bf16"),
               lambda: maxsim.launch_stage1(qc, r, blk32, dscale))
    return out


def bench_index(n=112640, ld=128, dim=128, n_topics=2048, b=32, lq=32):
    """bench.py's clustered synthetic index, made on the card: each doc's
    tokens are its topic vector plus 0.3 noise, normalized, bf16, docs
    sorted by topic (the cluster order hierarchical search wants); queries
    are a random doc's first Lq tokens plus 0.1 noise. Returns (tokens,
    mask, q)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(0)
    topics = _normed(g, n_topics, dim, dtype=torch.float32)
    assign = torch.randint(n_topics, (n,), generator=g,
                           device="cuda").sort().values
    tok = torch.empty((n, ld, dim), dtype=torch.bfloat16, device="cuda")
    for lo in range(0, n, 8192):
        a = assign[lo:lo + 8192]
        t = topics[a][:, None, :] + 0.3 * torch.randn(
            len(a), ld, dim, generator=g, device="cuda")
        tok[lo:lo + 8192] = t / t.norm(dim=-1, keepdim=True)
    mask = torch.ones((n, ld), dtype=torch.int8, device="cuda")
    qidx = torch.randint(n, (b,), generator=g, device="cuda")
    qt = tok[qidx, :lq].float() + 0.1 * torch.randn(
        b, lq, dim, generator=g, device="cuda")
    return tok, mask, (qt / qt.norm(dim=-1, keepdim=True)).bfloat16()


def _recall(rows, exact_rows):
    rows, exact_rows = rows.cpu().tolist(), exact_rows.cpu().tolist()
    return float(np.mean([len(set(a) & set(e)) / len(e)
                          for a, e in zip(rows, exact_rows)]))


def pruned_search(maxsim):
    """Hierarchical and two-stage search at the bench scale (112,640 docs).
    Returns ({mode: {"recall", "ms"}}, {kernel: launches})."""
    import torch
    from ravqa_tpu_torch.retrieval import (LateInteractionSearcher,
                                           build_index_from_embeddings)
    t0 = time.perf_counter()
    tok, mask, q = bench_index()
    index = build_index_from_embeddings(tok, mask, pad_multiple=128,
                                        dtype=torch.bfloat16)
    del tok
    index.build_summaries(n_summary=8, iters=4)
    index.build_block_summaries(block_size=64)
    torch.cuda.synchronize()
    print(f"bench index {index.num_docs} docs x {index.doc_maxlen} tokens "
          f"bf16, summaries {tuple(index.summaries.shape)}, block summaries "
          f"{tuple(index.block_summaries.shape)}: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    maxsim.maxsim_search.launches = 0
    exact = maxsim.maxsim_search(q, index.tokens, index.mask)
    exact_rows = torch.topk(exact, K, dim=1).indices
    torch.cuda.synchronize()
    oracle_launches = maxsim.maxsim_search.launches
    if oracle_launches == 0:
        raise AssertionError("the exact oracle did not launch K1")
    modes = [("hierarchical", "fast"), ("hierarchical", "reference"),
             ("two_stage", "fast"), ("two_stage", "reference")]
    searchers = {f"{m} {p}": LateInteractionSearcher(index, mode=m, preset=p)
                 for m, p in modes}
    wrappers = {"K2": maxsim.coarse_sweep, "K3": maxsim.coarse_sweep_int8,
                "K4": maxsim.stage1_sweep}
    rows, per_search = {}, {}
    for name, s in searchers.items():
        for w in wrappers.values():
            w.launches = 0
        rows[name] = s.search_device(q, K)[1]
        torch.cuda.synchronize()
        per_search[name] = {k: w.launches for k, w in wrappers.items()}
    launches = {k: sum(p[k] for p in per_search.values()) for k in wrappers}
    print(f"launches over the four searches: {launches}", flush=True)
    for k_, n in launches.items():
        if n == 0:
            raise AssertionError(f"{k_} never launched on the pruned path")
    for name in ("hierarchical reference", "two_stage reference"):
        if per_search[name]["K2"] == 0:
            raise AssertionError(f"{name} search did not launch K2")
    out = {}
    for name, s in searchers.items():
        out[name] = {"recall": _recall(rows[name], exact_rows),
                     "ms": time_ms(lambda: s.search_device(q, K)),
                     "launches": per_search[name]}
        print(f"{name}: recall@10 vs exact {out[name]['recall']:.4f}, "
              f"{out[name]['ms']:.3f} ms per batch of 32 "
              f"(n_candidates {s.resolve_candidates(K)}"
              + (f", n_blocks {s.resolve_blocks(K)}"
                 if s.mode == "hierarchical" else "")
              + f"; launches {per_search[name]})", flush=True)
    bnd, _ = maxsim_bound(maxsim, q, index.tokens, index.mask)
    out["exact"] = {"recall": 1.0, "ms": time_ms(
        lambda: maxsim.maxsim_search(q, index.tokens, index.mask)),
        "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"]}
    print(f"exact (K1, bf16 index, {oracle_launches} launch): "
          f"{out['exact']['ms']:.3f} ms per batch, bound "
          f"{bnd['bound_ms']:.3f} ms ({bnd['bound_by']})", flush=True)
    launches["K1"] = oracle_launches
    if out["hierarchical fast"]["recall"] < 0.95:
        raise AssertionError("hierarchical fast search: recall@10 "
                             f"{out['hierarchical fast']['recall']} < 0.95")
    return out, launches


def _tie_aware(got_p, got_s, want_p, want_s, atol):
    """Scores agree; a pid that clears the k-th score by more than the
    tolerance on one side is in the other side's top-k."""
    if not np.allclose(got_s, want_s, rtol=0, atol=atol):
        return False
    return set(want_p[want_s > want_s[-1] + atol]) <= set(got_p) \
        and set(got_p[got_s > got_s[-1] + atol]) <= set(want_p)


def cpu_copy(index):
    """The index with every tensor moved to the CPU."""
    import torch
    return dataclasses.replace(index, **{
        f.name: getattr(index, f.name).cpu()
        for f in dataclasses.fields(index)
        if isinstance(getattr(index, f.name), torch.Tensor)})


def record_searches(server):
    """Keep every dispatch's query embeddings and search result: wraps the
    server's searcher.search_device until check_served. Returns the list
    that (q, scores, rows) go into."""
    s = server.searcher
    search = s.search_device
    record = []

    def recording(q, k):
        scores, rows = search(q, k)
        record.append((q, scores, rows))
        return scores, rows

    s.search_device = recording
    return record


def check_served(server, index, record, scores, pids):
    """Every served answer is one of the dispatches' search results, and
    each of those agrees with the same search run by the plain versions on
    a CPU copy of the index, on the query embeddings the dispatch searched.
    (Encoding the requests again in other batches moves the embeddings by
    ~1e-6, which flips the int8 or bf16 rounding of some query values and
    moves a compressed index's scores by up to ~1e-3.) Returns (the
    dispatches' query embeddings on the card, their result rows, max |score
    error|)."""
    import torch
    from ravqa_tpu_torch.retrieval import LateInteractionSearcher
    s = server.searcher
    del s.search_device                          # drop record_searches' wrap
    q = torch.cat([r[0] for r in record])
    got_s = torch.cat([r[1] for r in record]).cpu().numpy()
    got_r = torch.cat([r[2] for r in record]).cpu().numpy()
    served = sorted((p.tolist(), v.tobytes()) for p, v in zip(pids, scores))
    searched = sorted((index.pids[r].tolist(), v.tobytes())
                      for r, v in zip(got_r, got_s))
    if served != searched:
        raise AssertionError("the served answers are not the dispatches' "
                             "search results")
    # a CUDA searcher takes the kernel route (use_pallas True), which the
    # CPU copy runs through the kernels' plain versions
    cpu = LateInteractionSearcher(
        cpu_copy(index), use_pallas=s.use_pallas, mode=s.mode,
        preset=s.preset,
        n_candidates=s.n_candidates, n_blocks=s.n_blocks,
        coarse_query_len=s.coarse_query_len, group_size=s.group_size,
        coarse_int8=s.coarse_int8, stage1_kernel=s._summ_rows is not None,
        centroid_prune=s.centroid_prune)
    t0 = time.perf_counter()
    want_s, want_r = (t.numpy() for t in cpu.search_device(q.cpu(), K))
    print(f"plain search of a CPU copy of the index: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    bad = [i for i in range(len(q)) if not _tie_aware(
        got_r[i], got_s[i], want_r[i], want_s[i], ATOL)]
    err = float(np.abs(got_s - want_s).max())
    print(f"served answers vs the plain versions' search on the same query "
          f"embeddings: max|score err| {err:.3g}, {len(bad)} of {len(q)} "
          f"queries differ", flush=True)
    if bad:
        raise AssertionError(f"served answers disagree with the plain "
                             f"versions' search on queries {bad}")
    return q, torch.from_numpy(got_r), err


def hier_serve_slice(maxsim):
    """The hierarchical serve slice (preset fast). Returns (launches of K3
    and K4, dispatches, recall@10 vs exact, max |score error|, (data,
    server, index) for the compressed slice)."""
    import torch
    data, server, index = start_server(HIER_CONFIG, "cuda")
    record = record_searches(server)
    _, scores, pids, launches, dispatches = drive_requests(
        server, data, index, [maxsim.coarse_sweep_int8, maxsim.stage1_sweep])
    q, rows, err = check_served(server, index, record, scores, pids)
    with torch.inference_mode():
        exact = torch.topk(maxsim.maxsim_search(q, index.tokens,
                                                index.mask), K, dim=1)[1]
    recall = _recall(rows, exact)
    print(f"recall@10 vs exact search (random weights, not gated): "
          f"{recall:.4f}", flush=True)
    return launches, dispatches, recall, err, (data, server, index)


def random_records(g, n, ld, dim, nbits, n_cent):
    """Residual records of n docs with random codes below n_cent, bf16
    scales in [0.5, 1.5), random residual bytes; about 30 % of the tokens
    and every 997th doc masked. Returns (records, mask)."""
    import torch
    from ravqa_tpu_torch.ops.residual import pack_records
    codes = torch.randint(n_cent, (n, ld), generator=g, device="cuda")
    scales = 0.5 + torch.rand(n, ld, generator=g, device="cuda")
    packed = torch.randint(256, (n, ld, dim * nbits // 8), generator=g,
                           device="cuda").to(torch.uint8)
    mask = (torch.rand(n, ld, generator=g, device="cuda") > 0.3).to(
        torch.int8)
    mask[::997] = 0
    return pack_records(codes, scales, packed), mask


def compressed_kernels():
    """K5 and K6 against their plain versions. Returns {kernel: {"err",
    "ms", "plain_ms", "shapes"}}: ms and plain_ms of the first shape."""
    import torch
    from ravqa_tpu_torch.ops import quant, residual
    g = torch.Generator(device="cuda").manual_seed(2)
    b, lq, dim = 32, 32, 128
    q = _normed(g, b, lq, dim, dtype=torch.float32)
    q[:, -2:] = 0                                  # zero query rows
    out = {k: {"err": 0.0, "shapes": {}} for k in ("K5", "K6")}

    def record(kernel, shape, got, want, fn, plain_fn, bnd):
        record_kernel(out, kernel, shape, _compare(f"{kernel} {shape}", got,
                                                   want), fn, plain_fn, bnd)

    for lq_k5, ld in ((lq, 128), (lq, 64), (64, 220)):
        n = 16384
        if lq_k5 == lq:
            q8, qs = quant.quantize_queries_int8(q)
        else:                                      # the serve query length
            q64 = _normed(g, b, lq_k5, dim, dtype=torch.float32)
            q64[:, -2:] = 0
            q8, qs = quant.quantize_queries_int8(q64)
        tok = _normed(g, n, ld, dim, dtype=torch.float32)
        mask = (torch.rand(n, ld, generator=g, device="cuda") > 0.3).to(
            torch.int8)
        mask[::997] = 0                            # docs with no tokens
        t8, ds = quant.quantize_index_int8(tok, mask)
        del tok
        got = quant.maxsim_search_int8(q8, qs, t8, ds)
        want = quant.maxsim_search_int8_q8_torch(q8, qs, t8, ds)
        torch.cuda.synchronize()
        empty = got[:, ::997]
        if not torch.allclose(empty, (-9999.0 * qs.sum(1))[:, None]
                              .expand_as(empty), rtol=1e-6, atol=0):
            raise AssertionError("K5: a doc with no valid token must score "
                                 "-9999 * sum of the query scales")
        ops = 2.0 * b * lq_k5 * n * ld * dim
        shape = f"Lq={lq_k5} N=16384 Ld={ld}"
        record_kernel(out, "K5", shape, _compare(f"K5 {shape}", got, want),
                      lambda: quant.maxsim_search_int8(q8, qs, t8, ds),
                      lambda: quant.maxsim_search_int8_q8_torch(q8, qs, t8,
                                                                ds),
                      bound(_nbytes(q8, qs, t8, ds, got), ops, "int8"),
                      ops=ops)
        print(f"  {out['K5']['shapes'][shape]['tera_ops_per_s']:.1f} TOP/s",
              flush=True)
        del t8, ds, got, want

    def k6(shape, q, ld, n, k1, k2, nbits, c=256):
        """K6 at one shape: C random candidates per query over n docs of
        ld tokens, candidate 0 with no valid token."""
        b, lq, dim = q.shape
        cand = torch.randint(n, (b, c), generator=g, device="cuda")
        cand[:, 0] = 0                             # doc 0 has no valid token
        if k2:
            coarse = 0.3 * _normed(g, k1, dim, dtype=torch.float32)
            fine = 0.1 * torch.randn(k2, dim, generator=g, device="cuda")
            cent = (coarse[:, None] + fine[None]).reshape(-1, dim)
        else:
            coarse = fine = None
            cent = _normed(g, k1, dim, dtype=torch.float32)
        w = 0.05 * torch.randn(2 ** nbits, generator=g,
                               device="cuda").sort().values
        records, mask = random_records(g, n, ld, dim, nbits, cent.shape[0])
        args = (q, records, cand, mask, cent, w)
        kw = dict(nbits=nbits, coarse=coarse, fine=fine)
        got = residual.maxsim_residual(*args, **kw)
        want = residual.maxsim_residual_torch(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got[:, 0], torch.full_like(got[:, 0],
                                                      -9999.0 * lq)):
            raise AssertionError("K6: a doc with no valid token must "
                                 "score -9999 * Lq")
        # the candidates' record and mask rows, each read once; the
        # residual dots and the centroid-score table, in bf16
        used = torch.unique(cand).numel()
        rows = k1 + k2 if k2 else k1
        nbytes = (_nbytes(q, cand, w, coarse, fine, got)
                  + (0 if k2 else _nbytes(cent))
                  + used * (records.shape[1] + mask.shape[1]))
        ops = 2.0 * b * lq * dim * (c * ld + rows)
        record("K6", shape, got, want,
               lambda: residual.maxsim_residual(*args, **kw),
               lambda: residual.maxsim_residual_torch(*args, **kw),
               bound(nbytes, ops, "bf16"))
        # the kernel alone, without the wrapper's table and casts
        prep = (q.bfloat16().contiguous(),
                residual.centroid_scores(q, cent, coarse, fine).contiguous(),
                records, cand.to(torch.int32).contiguous(), mask,
                w.bfloat16().float().contiguous())
        def alone():
            return residual.launch_residual_kernel(
                *prep, nbits=nbits, k1=k1 if k2 else 0, k2=k2)
        o = out["K6"]["shapes"][shape]
        o["kernel_ms"] = time_ms(alone)
        o["device_ms"] = device_ms(alone, "residual_maxsim_kernel")
        print(f"  K6 {shape}: the kernel alone {o['kernel_ms']:.4f} ms, "
              f"its device time {o['device_ms']:.4f} ms", flush=True)

    # the 1M fine stage's shape: 256 candidates per query, 64 tokens
    for name, k1, k2 in (("factored 64x128", 64, 128),
                         ("flat 1024", 1024, 0)):
        for nbits in (2, 4):
            k6(f"{name} nbits={nbits}", q, 64, 65536, k1, k2, nbits)
    # the residual serve's: Lq = 64, 220-token docs, factored, nbits 2
    q64 = _normed(g, b, 64, dim, dtype=torch.float32)
    q64[:, -2:] = 0
    k6("serve factored 64x128 nbits=2 Lq=64 Ld=220", q64, 220, 16384, 64,
       128, 2)
    return out


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def synth_1m(n=1_000_448, ld=64, dim=128, n_topics=8192, slab=62_528, b=32,
             lq=32):
    """scripts/synth1m.py's corpus, made on the card slab by slab: doc i's
    topic is floor(i * n_topics / n) (cluster-ordered runs of ~122 docs),
    each token its topic plus 0.3 noise, normalized, stored bf16; queries
    are docs 0-31's first Lq tokens plus 0.1 noise. Returns (tokens,
    queries float32)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(7)
    topics = _normed(g, n_topics, dim, dtype=torch.float32)
    tok = torch.empty((n, ld, dim), dtype=torch.bfloat16, device="cuda")
    for lo in range(0, n, slab):
        idx = torch.arange(lo, min(lo + slab, n), device="cuda")
        assign = (idx * n_topics // n).clamp_max(n_topics - 1)
        t = topics[assign][:, None, :] + 0.3 * torch.randn(
            len(idx), ld, dim, generator=g, device="cuda")
        tok[lo:lo + slab] = t / t.norm(dim=-1, keepdim=True)
    qt = tok[:b, :lq].float() + 0.1 * torch.randn(b, lq, dim, generator=g,
                                                  device="cuda")
    return tok, qt / qt.norm(dim=-1, keepdim=True)


def one_million_legs(maxsim):
    """The 1M legs (phase 9). Returns ({leg: {"recall", "self_top1", "ms",
    "bytes"}}, {leg: {kernel: launches}})."""
    import torch
    from ravqa_tpu_torch.ops import quant, residual
    from ravqa_tpu_torch.retrieval import (LateInteractionSearcher,
                                           TokenIndex,
                                           build_index_from_embeddings)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tok, q = synth_1m()
    index = build_index_from_embeddings(
        tok, torch.ones(tok.shape[:2], dtype=torch.int8, device="cuda"),
        pad_multiple=128, dtype=torch.bfloat16)
    del tok
    index.build_summaries(n_summary=4, iters=2)
    index.build_block_summaries(block_size=64)
    torch.cuda.synchronize()
    print(f"1M bf16 index {index.num_docs} docs x {index.doc_maxlen} "
          f"tokens, summaries {tuple(index.summaries.shape)}, block "
          f"summaries {tuple(index.block_summaries.shape)}: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    b = q.shape[0]
    self_rows = torch.arange(b, device="cuda")
    wrappers = {"K1": maxsim.maxsim_search, "K3": maxsim.coarse_sweep_int8,
                "K4": maxsim.stage1_sweep, "K5": quant.maxsim_search_int8,
                "K6": residual.maxsim_residual}
    out, launches = {}, {}
    exact_rows = None

    def leg(name, search, nbytes, kernels, bnd=None):
        nonlocal exact_rows
        for w in wrappers.values():
            w.launches = 0
        rows = search()[1]
        torch.cuda.synchronize()
        launches[name] = {k: wrappers[k].launches for k in kernels}
        if min(launches[name].values()) == 0:
            raise AssertionError(f"1M {name}: a kernel of the leg never "
                                 f"launched: {launches[name]}")
        if exact_rows is None:
            exact_rows = rows
        r = {"recall": _recall(rows, exact_rows),
             "self_top1": float((rows[:, 0] == self_rows).float().mean()),
             "ms": time_ms(search, iters=3, warmup=1), "bytes": nbytes}
        if bnd is not None:
            r.update({k: v for k, v in bnd.items()
                      if k in ("bound_ms", "bound_by", "bound_note")})
            print(f"1M {name}: {r['ms']:.3f} ms per batch against a bound of "
                  f"{bnd['bound_ms']:.3f} ms ({bnd['bound_by']}"
                  + (f"; {bnd['bound_note']}" if "bound_note" in bnd else "")
                  + ")", flush=True)
        out[name] = r
        print(f"1M {name}: recall@10 vs exact {r['recall']:.4f}, self-top-1 "
              f"{r['self_top1']:.4f}, {r['ms']:.3f} ms per batch of {b}, "
              f"{nbytes} bytes on the card; launches {launches[name]}",
              flush=True)

    k1_bound, k1_flop = maxsim_bound(maxsim, q, index.tokens, index.mask)
    one_part = bound(k1_bound["bytes"], k1_flop, "bf16")["bound_ms"]
    k1_bound["bound_note"] += f" (one part: {one_part:.3f} ms)"
    leg("exact bf16 (K1)",
        lambda: torch.topk(maxsim.maxsim_search(q, index.tokens, index.mask),
                           K, dim=1),
        _nbytes(index.tokens, index.mask), ("K1",), k1_bound)

    t0 = time.perf_counter()
    t8, s8 = quant.quantize_index_int8(index.tokens, index.mask)
    i8 = dataclasses.replace(index, tokens=t8, scales=s8)
    del t8, s8
    torch.cuda.synchronize()
    print(f"int8 index: {time.perf_counter() - t0:.1f} s", flush=True)
    nb8 = _nbytes(i8.tokens, i8.scales, i8.mask)
    s = LateInteractionSearcher(i8, mode="exact")
    n_, ld_, dim_ = i8.tokens.shape
    lq_ = q.shape[1]
    # codes and scales of the index, the int8 query and its scales, out
    leg("int8 exact (K5)", lambda: s.search_device(q, K), nb8, ("K5",),
        bound(_nbytes(i8.tokens, i8.scales) + b * lq_ * (dim_ + 4)
              + 4 * b * n_, 2.0 * b * lq_ * n_ * ld_ * dim_, "int8"))
    s = LateInteractionSearcher(i8, mode="hierarchical", preset="fast")
    leg("int8 hierarchical fast (K3, K4)", lambda: s.search_device(q, K),
        nb8, ("K3", "K4"))
    del s, i8
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    res = dataclasses.replace(index)
    index.tokens = None
    res.quantize_residual(n_centroids=(64, 128), nbits=2)
    torch.cuda.synchronize()
    print(f"residual index (factored 64 x 128, nbits 2; codec trained on "
          f"the card): {time.perf_counter() - t0:.1f} s", flush=True)
    s = LateInteractionSearcher(res, mode="hierarchical", preset="fast")
    leg("residual hierarchical fast (K3, K4, K6)",
        lambda: s.search_device(q, K),
        _nbytes(res.records, res.mask, res.codec_centroids,
                res.codec_weights, res.codec_coarse, res.codec_fine),
        ("K3", "K4", "K6"))
    print(f"summaries {_nbytes(res.summaries)} bytes, block summaries "
          f"{_nbytes(res.block_summaries)} bytes (every leg)", flush=True)
    del s, res, index
    torch.cuda.empty_cache()
    for name, r in out.items():
        if r["self_top1"] < 0.95:
            raise AssertionError(f"1M {name}: self-top-1 {r['self_top1']}")
        if name.startswith("int8") and r["recall"] < 0.95:
            raise AssertionError(f"1M {name}: recall@10 {r['recall']}")
    return out, launches


def compressed_serve_slice(maxsim, data, server, index):
    """Phase 7's index as an int8 copy served in exact mode (K5) and a
    residual copy (factored 64 x 128, nbits 2) served hierarchical fast
    (K3, K4, K6), each behind RetrievalServer. Returns {slice: {"launches",
    "dispatches", "err", "search_ms_b32"}}."""
    from ravqa_tpu_torch.ops import quant, residual
    from ravqa_tpu_torch.retrieval import LateInteractionSearcher
    from ravqa_tpu_torch.serving import RetrievalServer
    t0 = time.perf_counter()
    i8 = dataclasses.replace(index, meta=dict(index.meta)).quantize_int8()
    res = dataclasses.replace(index, meta=dict(index.meta)).quantize_residual(
        n_centroids=(64, 128), nbits=2)
    print(f"int8 and residual copies of the serve index: "
          f"{time.perf_counter() - t0:.1f} s; bytes int8 "
          f"{_nbytes(i8.tokens, i8.scales)}, residual "
          f"{_nbytes(res.records)} (float32 "
          f"{_nbytes(index.tokens)})", flush=True)
    out = {}
    for name, idx, kw, wrappers in (
            ("int8 exact", i8, dict(mode="exact"),
             [quant.maxsim_search_int8]),
            ("residual hierarchical fast", res,
             dict(mode="hierarchical", preset="fast"),
             [maxsim.coarse_sweep_int8, maxsim.stage1_sweep,
              residual.maxsim_residual])):
        srv = RetrievalServer(server.ex, LateInteractionSearcher(idx, **kw),
                              data["query_tokenizer"],
                              image_feature_dim=server.image_feature_dim,
                              id2content=server.id2content,
                              config=server.cfg)
        srv.warm_up()
        print(f"-- {name}", flush=True)
        record = record_searches(srv)
        _, scores, pids, launches, dispatches = drive_requests(
            srv, data, idx, wrappers)
        if dispatches == 0 or min(launches) < dispatches:
            raise AssertionError(f"{name}: launches {launches} for "
                                 f"{dispatches} dispatches")
        q, _, err = check_served(srv, idx, record, scores, pids)
        ms = time_ms(lambda: srv.searcher.search_device(q[:32], K))
        print(f"search alone: {ms:.3f} ms per batch of 32", flush=True)
        out[name] = {"launches": dict(zip((w.__name__ for w in wrappers),
                                          launches)),
                     "dispatches": dispatches, "err": err,
                     "search_ms_b32": ms}
    return out


def stage2_inputs(lq=32):
    """Phase 11's inputs, made on the card from seed 3, shape by shape:
    B=32 queries of Lq unit tokens (float32), Ld=64, dim 128, C = 1,024,
    256 and 200 (a multiple of neither of the TPU tiles, 32 and 128); ~30 %
    of the tokens masked and candidate 1 of every query with none. Yields
    (shape, X1's keyword arguments, X2's bf16 candidate tokens): the mask
    (X1's mg, X2's too), X1's pre-gathered centroid scores (dot products of unit vectors, here
    0.1 N(0, 1)), 2-bit bucket ids and scales near 1."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(3)
    b, ld, dim = 32, 64, 128
    q = _normed(g, b, lq, dim, dtype=torch.float32)
    w = torch.tensor([-0.05, -0.01, 0.01, 0.05], device="cuda")
    for c in (1024, 256, 200):
        mask = (torch.rand(b, c, ld, generator=g, device="cuda") > 0.3).to(
            torch.int8)
        mask[:, 1] = 0
        x1 = dict(q=q, cqg=0.1 * torch.randn(b, c, ld, lq, generator=g,
                                             device="cuda"),
                  bits=torch.randint(4, (b, c, ld, dim), generator=g,
                                     device="cuda", dtype=torch.uint8),
                  sg=1.0 + 0.01 * torch.randn(b, c, ld, generator=g,
                                              device="cuda"),
                  mg=mask, weights=w)
        yield f"C={c}", x1, _normed(g, b, c, ld, dim, dtype=torch.bfloat16)


def x1_bound(x1, out):
    """X1's bound on these inputs: the bytes it must move (the mask, the
    query, the weights, the scores and, of each scored row (mg != 0) only,
    its ids, centroid scores and scale: a masked row scores -9999 whatever
    they hold) and the bf16 operations of its three products (hi.hi + lo.hi
    + hi.lo) over the scored rows; the CUDA cores' float32 bound of the
    same function beside it ("f32_bound_ms")."""
    q, mg = x1["q"], x1["mg"]
    _, lq, dim = q.shape
    scored = int((mg != 0).sum().item())
    nbytes = (_nbytes(mg, q, x1["weights"], out)
              + scored * (dim + 4 * lq + 4))
    flop = 2.0 * lq * dim * scored
    bnd = bound(nbytes, 3 * flop, "bf16")
    bnd["bound_note"] = ("bytes and bf16 operations of the 3 products "
                         "(hi.hi + lo.hi + hi.lo) of the scored rows")
    bnd["scored_rows"] = scored
    bnd["f32_bound_ms"] = bound(nbytes, flop, "f32")["bound_ms"]
    return bnd


def stage2_kernels():
    """X1, X2 and X3 against their plain versions on phase 11's inputs
    (stage2_inputs). Returns {kernel: {"err", "ms", "plain_ms", "bound_ms",
    "bound_by", "shapes"}}: the first shape's times and bound at the top.
    X1 and X2 also time the launch alone ("kernel_ms", launch_fused_lut /
    launch_candidate) and X1, X2 and X3 the device time of their kernels
    from the profiler ("device_ms" a call of the route,
    "device_ms_per_launch": X3's call is B launches). X1's bound is
    x1_bound's."""
    import torch
    from ravqa_tpu_torch.ops import stage2
    out = {k: {"err": 0.0, "shapes": {}} for k in ("X1", "X2", "X3")}

    def per_query(mask, tok):
        return torch.cat([stage2.candidate_maxsim(qb[i:i + 1], tok[i:i + 1],
                                                  mask[i:i + 1])
                          for i in range(b)])

    def check(kernel, shape, got, want, fn, plain_fn, bnd):
        torch.cuda.synchronize()
        if not torch.equal(got[:, 1], torch.full_like(got[:, 1],
                                                      -9999.0 * lq)):
            raise AssertionError(f"{kernel}: a candidate with no valid token "
                                 f"must score -9999 * Lq")
        record_kernel(out, kernel, shape, _compare(f"{kernel} {shape}", got,
                                                   want), fn, plain_fn, bnd)

    for shape, x1, tok in stage2_inputs():
        b, lq, dim = x1["q"].shape
        mask = x1["mg"]
        qb = x1["q"].bfloat16()
        got = stage2.fused_lut_maxsim(**x1)
        check("X1", shape, got, stage2.fused_lut_maxsim_torch(**x1),
              lambda: stage2.fused_lut_maxsim(**x1),
              lambda: stage2.fused_lut_maxsim_torch(**x1), x1_bound(x1, got))
        x1s = out["X1"]["shapes"][shape]
        x1s["kernel_ms"] = time_ms(lambda: stage2.launch_fused_lut(**x1))
        x1s["device_ms"] = device_ms(lambda: stage2.fused_lut_maxsim(**x1),
                                     "lut_maxsim_kernel")
        print(f"  X1 {shape}: the launch alone {x1s['kernel_ms']:.4f} ms, "
              f"device {x1s['device_ms']:.4f} ms; {x1s['scored_rows']} rows "
              f"scored; the CUDA cores' float32 bound "
              f"{x1s['f32_bound_ms']:.4f} ms", flush=True)
        del x1, got
        # X2 batched, X3 the same kernel once per query (B launches)
        flop = 2.0 * lq * dim * mask.numel()
        want = stage2.candidate_maxsim_torch(qb, tok, mask)
        got = stage2.candidate_maxsim(qb, tok, mask)
        bnd = bound(_nbytes(qb, tok, mask, got), flop, "bf16")
        check("X2", shape, got, want,
              lambda: stage2.candidate_maxsim(qb, tok, mask),
              lambda: stage2.candidate_maxsim_torch(qb, tok, mask), bnd)
        check("X3", shape, per_query(mask, tok), want,
              lambda: per_query(mask, tok),
              lambda: stage2.candidate_maxsim_torch(qb, tok, mask), bnd)
        x2, x3 = out["X2"]["shapes"][shape], out["X3"]["shapes"][shape]
        x2["kernel_ms"] = time_ms(
            lambda: stage2.launch_candidate(qb, tok, mask))
        for o, fn, n in ((x2, lambda: stage2.candidate_maxsim(qb, tok, mask),
                          1),
                         (x3, lambda: per_query(mask, tok), b)):
            o["device_ms"] = device_ms(fn, "candidate_kernel", launches=n)
            o["device_ms_per_launch"] = o["device_ms"] / n
        # the host's enqueue of X3's launches (the clock stops before the
        # card is waited for)
        host = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            per_query(mask, tok)
            host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        x3["host_ms_per_launch"] = float(np.median(host)) * 1e3 / b
        print(f"  X2 {shape}: the launch alone {x2['kernel_ms']:.4f} ms, "
              f"device {x2['device_ms']:.4f} ms; X3: device "
              f"{x3['device_ms']:.4f} ms for {b} launches, "
              f"{x3['device_ms_per_launch'] * 1e3:.2f} us a launch on the "
              f"device, {x3['host_ms_per_launch'] * 1e3:.2f} us a launch "
              f"on the host", flush=True)
        del tok, want, got
    return out


def stage2_experiment():
    """The residual stage-2 experiment (phase 12): every round of
    ravqa_tpu_torch.scripts.exp_residual_stage2.run() at the script's full
    widths, with the launch counts set to 0 just before. Returns its report
    and {kernel: launches} as the wrappers counted them."""
    import torch
    from ravqa_tpu_torch.ops import stage2
    from ravqa_tpu_torch.scripts import exp_residual_stage2 as exp
    torch.cuda.empty_cache()
    fused, cand = stage2.fused_lut_maxsim, stage2.candidate_maxsim
    fused.launches = cand.launches = 0
    report = exp.run()
    torch.cuda.synchronize()
    routes, want = report["launches"], report["expected_launches"]
    if routes != want or min(want.values()) == 0 \
            or fused.launches != routes["X1"] \
            or cand.launches != routes["X2"] + routes["X3"]:
        raise AssertionError(f"stage-2 launches: routes {routes}, expected "
                             f"{want}, counted X1 {fused.launches}, X2 + X3 "
                             f"{cand.launches}")
    twin = report["twin_err"]
    if set(twin) != {"X1", "X2", "X3"} or max(twin.values()) > SWEEP_ATOL:
        raise AssertionError(f"stage-2 kernel routes against their plain "
                             f"twins: {twin}")
    bad = [k for k, v in {**report["times"], **report["rel_err"]}.items()
           if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"stage-2 experiment: not finite: {bad}")
    print(f"launches {routes} (expected {want}); plain twins max |err| "
          f"{twin}", flush=True)
    return report


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
    t0 = time.perf_counter()
    for name, built in maxsim.build_kernels().items():
        print(f"{name} built and loaded in {built['seconds']:.2f} s",
              flush=True)
        for line in built["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  ptxas:", line.strip(), flush=True)
    print(f"all libraries: {time.perf_counter() - t0:.2f} s", flush=True)

    phase("3 K1 vs plain")
    # K1 on a bf16 index ("K1") and on a float32 one, read as two bf16
    # planes ("K1-f32"): the same tensor-core kernel, two rows
    k1 = {k: {"err": 0.0, "shapes": {}} for k in ("K1", "K1-f32")}
    f32, bf16 = torch.float32, torch.bfloat16
    for key, shape, args in (
            ("K1", "bf16 B=32 Lq=32 N=16384 Ld=128",
             (32, 32, 16384, 128, 128, bf16, bf16)),
            ("K1", "f32 query x bf16 index B=32 Lq=32 N=16384 Ld=64",
             (32, 32, 16384, 64, 128, f32, bf16)),
            ("K1-f32", "serve f32 B=32 Lq=64 N=16387 Ld=220",
             (32, 64, 16387, 220, 128, f32, f32))):
        kernel_shape(k1, key, shape, *args, maxsim)
    phase("4 exact serve slice")
    launches, dispatches, serve_err = serve_slice(CONFIG, "cuda", maxsim)
    if launches < dispatches or launches == 0:
        raise AssertionError(f"maxsim kernel launched {launches} times "
                             f"for {dispatches} dispatches")

    phase("5 K2, K3, K4 vs plain at the bench and serve shapes")
    sweeps = sweep_kernels(maxsim)
    phase("6 pruned search at 112,640 docs")
    searches, pruned_launches = pruned_search(maxsim)
    phase("7 hierarchical serve slice")
    (l3, l4), hier_dispatches, hier_recall, hier_serve_err, served = \
        hier_serve_slice(maxsim)
    if min(l3, l4) < hier_dispatches or hier_dispatches == 0:
        raise AssertionError(f"K3/K4 launched {l3}/{l4} times for "
                             f"{hier_dispatches} dispatches")
    phase("8 K5 and K6 vs plain")
    compressed = compressed_kernels()
    phase("9 the 1M legs")
    legs_1m, launches_1m = one_million_legs(maxsim)
    phase("10 compressed serve slice")
    comp_serve = compressed_serve_slice(maxsim, *served)
    del served
    phase("11 X1, X2, X3 vs plain")
    stage2_k = stage2_kernels()
    phase("12 the residual stage-2 experiment")
    experiment = stage2_experiment()
    phase("report")

    def entry(name, source, replaces, launches, measured):
        return {"name": name, "route": "cuda",
                "source": "ravqa_tpu_torch/csrc/" + source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": measured["err"], "ms": measured["ms"],
                "plain_ms": measured["plain_ms"],
                "bound_ms": measured["bound_ms"],
                "bound_by": measured["bound_by"],
                "shapes": measured["shapes"]}

    k1_replaces = "ravqa_tpu/ops/maxsim.py:196 (_maxsim_kernel :162)"
    kernels = {
        "K1": entry("maxsim_search (bf16 index, tensor cores)",
                    "maxsim_mma.cu", k1_replaces, pruned_launches["K1"],
                    k1["K1"]),
        "K1-f32": entry("maxsim_search (float32 index as two bf16 planes, "
                        "tensor cores)", "maxsim_mma.cu", k1_replaces,
                        launches, k1["K1-f32"])}
    kernels["K1"]["launches_note"] = (
        "phase 6's exact oracle (bf16 query); the exact serve slice's "
        "float32 index runs K1-f32")
    kernels["K1"]["launches_1m"] = launches_1m["exact bf16 (K1)"]["K1"]
    kernels["K1-f32"]["launches_note"] = "phase 4, the exact serve slice"
    kernels["K1-f32"]["f32_bound_ms"] = k1["K1-f32"]["shapes"][
        next(iter(k1["K1-f32"]["shapes"]))]["f32_bound_ms"]

    for key, name, source, replaces, launches in (
            ("K2", "coarse_sweep (bf16, tensor cores)", "coarse_sweep.cu",
             "ravqa_tpu/ops/maxsim.py:336 (_coarse_sweep_kernel :252)",
             pruned_launches["K2"]),
            ("K3", "coarse_sweep_int8", "coarse_sweep.cu",
             "ravqa_tpu/ops/maxsim.py:336 (_coarse_sweep_int8_kernel "
             ":293)", l3),
            ("K4", "stage1_sweep", "stage1_sweep.cu",
             "ravqa_tpu/ops/maxsim.py:510", l4)):
        kernels[key] = entry(name, source, replaces, launches, sweeps[key])
    kernels["K2"]["launches_note"] = (
        "phase 6 (hierarchical and two-stage search under the reference "
        "preset); the fast serve slice runs K3 and K4")
    kernels["K3"]["pruned_search_launches"] = pruned_launches["K3"]
    kernels["K4"]["pruned_search_launches"] = pruned_launches["K4"]
    res_launches = comp_serve["residual hierarchical fast"]["launches"]
    for key, name, source, replaces, launches in (
            ("K5", "maxsim_search_int8", "maxsim_int8.cu",
             "ravqa_tpu/ops/quant.py:138 (_maxsim_int8_kernel :113)",
             comp_serve["int8 exact"]["launches"]["maxsim_search_int8"]),
            ("K6", "maxsim_residual", "residual_maxsim.cu",
             "ravqa_tpu/ops/residual.py:524 (_residual_maxsim_kernel :447)",
             res_launches["maxsim_residual"])):
        kernels[key] = entry(name, source, replaces, launches,
                             compressed[key])
    kernels["K5"]["launches_1m"] = launches_1m["int8 exact (K5)"]["K5"]
    kernels["K6"]["launches_1m"] = launches_1m[
        "residual hierarchical fast (K3, K4, K6)"]["K6"]
    script = "scripts/exp_residual_stage2.py"
    for key, name, source, replaces in (
            ("X1", "fused_lut_maxsim", "residual_lut_maxsim.cu",
             f"{script}:189 (v_pallas :173, _fused_kernel :151)"),
            ("X2", "candidate_maxsim (batched, tensor cores)",
             "candidate_maxsim.cu",
             f"{script}:268 (maxsim_candidates_pallas :261, _cand_kernel "
             f":251)"),
            ("X3", "candidate_maxsim (once per query)", "candidate_maxsim.cu",
             f"{script}:405 (v_record_perq_pallas :388, _perq_kernel "
             f":379)")):
        x = dict(stage2_k[key])
        x["err"] = max(x["err"], experiment["twin_err"][key])
        kernels[key] = entry(name, source, replaces,
                             experiment["launches"][key], x)
    kernels["X3"]["ms_note"] = ("the batch's B launches of B = 1, as "
                                "v_record_perq runs them")
    kernels["X1"]["f32_bound_ms"] = stage2_k["X1"]["shapes"][
        next(iter(stage2_k["X1"]["shapes"]))]["f32_bound_ms"]
    for k in kernels.values():
        # no single PyTorch call computes any of these functions
        k["library_ms"] = None
    # the served answers' error against the same search by the plain
    # versions, apart from each kernel's own error above
    print(json.dumps({"kernels": [kernels[k] for k in sorted(kernels)],
                      "searches": searches,
                      "exact_serve_err": serve_err,
                      "hier_serve_err": hier_serve_err,
                      "hier_serve_recall": hier_recall,
                      "searches_1m": legs_1m,
                      "compressed_serve": comp_serve,
                      "stage2_experiment": experiment}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
