#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ravqa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. environment: torch/CUDA versions, the card's name and power limit;
     TF32 off for float32 matmuls and convolutions. No GPU -> exit 1.
  2. build: every CUDA library of the port (csrc/maxsim.cu: K1,
     csrc/coarse_sweep.cu: K2 + K3, csrc/stage1_sweep.cu: K4) from the
     repo's sources, the nvcc runs side by side; ptxas registers/spills.
  3. K1 against its plain PyTorch version on the card, at the serve shape
     in float32 and a bf16 index shape: scores, tie-aware top-10, and both
     times (median of 10 after warm-up, CUDA events).
  4. the exact slice: build_server on configs/synthetic_flmr_base_serve.json
     (FLMR at BERT-base width, 16,384 passages encoded on the card), 64
     requests from 4 threads, every answer checked against a plain search
     of the same index with the executor's own query embeddings, K1's
     launch count checked against the dispatches, and the towers on the
     card checked against the same module run on the CPU.
  5. K2, K3 and K4 against their plain versions at the bench.py shape
     (B=32, Lq=32, dim=128; 112,640 docs x 8 summaries; 1,760 x 4 block
     summaries padded to 2,048; bs=64, n_blocks 16 and 32): scores,
     tie-aware top-10, K3's pre-scale sums exactly, both times.
  6. pruned search at the bench scale: a clustered bf16 index of 112,640
     docs x 128 tokens made on the card (bench.py's recipe), summaries and
     block summaries, then LateInteractionSearcher in hierarchical (fast,
     reference) and two_stage (fast, reference) mode: recall@10 against
     exact search (K1) and ms per batch of 32; hierarchical fast must
     reach recall 0.95, and K2, K3 and K4 must each launch.
  7. the hierarchical slice: build_server on
     configs/synthetic_flmr_base_serve_hier.json (preset fast), 64
     requests from 4 threads, every answer checked against the same
     search run by the plain versions on a CPU copy of the index; K3 and
     K4 launches at least the dispatches; recall@10 against exact search
     printed (not gated: the weights are random).
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
    reqs, scores, pids, launches, dispatches = drive_requests(
        server, data, index, [maxsim.maxsim_search])
    launches = launches[0]
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
    """K2, K3 and K4 against their plain versions at the bench.py shape.
    Returns {kernel: {"err", "ms", "plain_ms", "shapes": {...}}}."""
    import torch
    from ravqa_tpu_torch.ops.quant import (quantize_queries_int8,
                                           quantize_summaries_int8,
                                           quantize_summaries_t_int8)
    g = torch.Generator(device="cuda").manual_seed(1)
    b, lq, dim, bs = 32, 32, 128, 64
    q = _normed(g, b, lq, dim, dtype=torch.float32)
    q[:, -2:] = 0                                  # zero query rows
    out = {k: {"err": 0.0, "shapes": {}} for k in ("K2", "K3", "K4")}

    def record(kernel, shape, err, fn, plain_fn):
        ms, plain_ms = time_ms(fn), time_ms(plain_fn)
        o = out[kernel]
        o["err"] = max(o["err"], err)
        o["shapes"][shape] = {"ms": ms, "plain_ms": plain_ms}
        o.setdefault("ms", ms)                     # the first shape's
        o.setdefault("plain_ms", plain_ms)
        print(f"{kernel} {shape}: kernel {ms:.3f} ms, plain {plain_ms:.3f} "
              f"ms", flush=True)

    summ_docs = None
    # two-stage coarse pass: 112,640 docs x 8 summaries; hierarchical
    # stage 0: 1,760 blocks x 4 summaries, zero-padded to 2,048
    for shape, s_, n, n_valid in (("docs S=8 N=112640", 8, 112640, None),
                                  ("blocks S=4 N=2048", 4, 2048, 1760)):
        summ_t = _normed(g, s_, n, dim, dtype=torch.bfloat16)
        valid = torch.ones(n, dtype=torch.int8, device="cuda")
        if n_valid is None:
            valid[::997] = 0                       # docs with no tokens
            summ_docs = summ_t.transpose(0, 1).contiguous()
        else:
            valid[n_valid:] = 0
            summ_t[:, n_valid:] = 0
        invalid = valid == 0
        got = maxsim.coarse_sweep(q, summ_t, valid)
        want = maxsim.coarse_sweep_torch(q, summ_t, valid)
        torch.cuda.synchronize()
        if not bool((got[:, invalid] == -9999.0).all()):
            raise AssertionError("K2: an invalid doc must score -9999")
        err = _compare(f"K2 bf16 {shape}", got, want)
        record("K2", shape, err, lambda: maxsim.coarse_sweep(q, summ_t, valid),
               lambda: maxsim.coarse_sweep_torch(q, summ_t, valid))

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
        err = _compare(f"K3 int8 {shape}", got, want)
        record("K3", shape, err,
               lambda: maxsim.coarse_sweep(q, st8, valid, dscale=dsc),
               lambda: maxsim.coarse_sweep_torch(q, st8, valid, dscale=dsc))

    # hierarchical stage 1 over the docs' summaries: 1,760 blocks of 64
    rows = maxsim.stage1_rows(summ_docs, bs)
    si8, ssc = quantize_summaries_int8(summ_docs)
    rows8 = maxsim.stage1_rows(si8, bs)
    nb = rows.shape[0]
    for nbl in (32, 16):
        blk = torch.rand(b, nb, generator=g, device="cuda").argsort(
            dim=1)[:, :nbl]
        for label, r, dscale in (("int8", rows8, ssc), ("bf16", rows, None)):
            shape = f"{label} rows n_blocks={nbl}"
            got = maxsim.stage1_sweep(q, r, blk, dscale=dscale)
            want = maxsim.stage1_sweep_torch(q, r, blk, dscale=dscale)
            err = _compare(f"K4 {shape}", got, want)
            record("K4", shape, err,
                   lambda: maxsim.stage1_sweep(q, r, blk, dscale=dscale),
                   lambda: maxsim.stage1_sweep_torch(q, r, blk,
                                                     dscale=dscale))
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
    exact = maxsim.maxsim_search(q, index.tokens, index.mask)
    exact_rows = torch.topk(exact, K, dim=1).indices
    modes = [("hierarchical", "fast"), ("hierarchical", "reference"),
             ("two_stage", "fast"), ("two_stage", "reference")]
    searchers = {f"{m} {p}": LateInteractionSearcher(index, mode=m, preset=p)
                 for m, p in modes}
    wrappers = {"K2": maxsim.coarse_sweep, "K3": maxsim.coarse_sweep_int8,
                "K4": maxsim.stage1_sweep}
    for w in wrappers.values():
        w.launches = 0
    rows = {name: s.search_device(q, K)[1] for name, s in searchers.items()}
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"launches over the four searches: {launches}", flush=True)
    for k_, n in launches.items():
        if n == 0:
            raise AssertionError(f"{k_} never launched on the pruned path")
    out = {}
    for name, s in searchers.items():
        out[name] = {"recall": _recall(rows[name], exact_rows),
                     "ms": time_ms(lambda: s.search_device(q, K))}
        print(f"{name}: recall@10 vs exact {out[name]['recall']:.4f}, "
              f"{out[name]['ms']:.3f} ms per batch of 32 "
              f"(n_candidates {s.resolve_candidates(K)}"
              + (f", n_blocks {s.resolve_blocks(K)}"
                 if s.mode == "hierarchical" else "") + ")", flush=True)
    out["exact"] = {"recall": 1.0, "ms": time_ms(
        lambda: maxsim.maxsim_search(q, index.tokens, index.mask))}
    print(f"exact (K1): {out['exact']['ms']:.3f} ms per batch", flush=True)
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


def hier_serve_slice(maxsim):
    """The hierarchical serve slice (preset fast). Returns (launches of K3
    and K4, dispatches, recall@10 vs exact)."""
    import torch
    from ravqa_tpu_torch.retrieval import LateInteractionSearcher, TokenIndex
    data, server, index = start_server(HIER_CONFIG, "cuda")
    s = server.searcher
    reqs, scores, pids, launches, dispatches = drive_requests(
        server, data, index, [maxsim.coarse_sweep_int8, maxsim.stage1_sweep])
    q = encode_requests(server, data, reqs)
    cpu_index = TokenIndex(
        tokens=index.tokens.cpu(), mask=index.mask.cpu(), pids=index.pids,
        num_docs=index.num_docs, meta=index.meta,
        summaries=index.summaries.cpu(),
        block_summaries=index.block_summaries.cpu(),
        block_size=index.block_size)
    cpu = LateInteractionSearcher(
        cpu_index, use_pallas=True, mode=s.mode, preset=s.preset,
        n_candidates=s.n_candidates, n_blocks=s.n_blocks,
        coarse_query_len=s.coarse_query_len, group_size=s.group_size,
        coarse_int8=s.coarse_int8,
        stage1_kernel=s._summ_rows is not None)
    t0 = time.perf_counter()
    want_s, want_r = (t.numpy() for t in cpu.search_device(q.cpu(), K))
    print(f"plain search of a CPU copy of the index: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    bad = [i for i in range(len(reqs)) if not _tie_aware(
        pids[i], scores[i], want_r[i], want_s[i], ATOL)]
    err = float(np.abs(scores - want_s).max())
    print(f"served answers vs the plain versions' search: max|score err| "
          f"{err:.3g}, {len(bad)} of {len(reqs)} queries differ", flush=True)
    if bad:
        raise AssertionError(f"served answers disagree with the plain "
                             f"versions' search on queries {bad}")
    with torch.inference_mode():
        exact = torch.topk(maxsim.maxsim_search(q, index.tokens,
                                                index.mask), K, dim=1)[1]
    recall = _recall(torch.from_numpy(pids), exact)
    print(f"recall@10 vs exact search (random weights, not gated): "
          f"{recall:.4f}", flush=True)
    return launches, dispatches, recall, err


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
    err_a, ms_a, plain_a = kernel_shape("serve f32", 32, 64, 16387, 220,
                                        128, torch.float32, maxsim)
    err_b, ms_b, plain_b = kernel_shape("index bf16", 32, 32, 16384, 128,
                                        128, torch.bfloat16, maxsim)
    phase("4 exact serve slice")
    launches, dispatches, serve_err = serve_slice(CONFIG, "cuda", maxsim)
    if launches < dispatches or launches == 0:
        raise AssertionError(f"maxsim kernel launched {launches} times "
                             f"for {dispatches} dispatches")
    kernels = {"K1": {
        "name": "maxsim_search", "route": "cuda",
        "source": "ravqa_tpu_torch/csrc/maxsim.cu",
        "replaces": "ravqa_tpu/ops/maxsim.py:196",
        "launches": launches, "max_abs_err": max(err_a, err_b),
        "ms": ms_a, "plain_ms": plain_a, "bf16_ms": ms_b,
        "bf16_plain_ms": plain_b}}

    phase("5 K2, K3, K4 vs plain at the bench shape")
    sweeps = sweep_kernels(maxsim)
    phase("6 pruned search at 112,640 docs")
    searches, pruned_launches = pruned_search(maxsim)
    phase("7 hierarchical serve slice")
    (l3, l4), hier_dispatches, hier_recall, hier_serve_err = \
        hier_serve_slice(maxsim)
    if min(l3, l4) < hier_dispatches or hier_dispatches == 0:
        raise AssertionError(f"K3/K4 launched {l3}/{l4} times for "
                             f"{hier_dispatches} dispatches")
    src = "ravqa_tpu_torch/csrc/"
    for key, name, source, replaces, launches in (
            ("K2", "coarse_sweep (float)", "coarse_sweep.cu",
             "ravqa_tpu/ops/maxsim.py:336 (_coarse_sweep_kernel :252)",
             pruned_launches["K2"]),
            ("K3", "coarse_sweep_int8", "coarse_sweep.cu",
             "ravqa_tpu/ops/maxsim.py:336 (_coarse_sweep_int8_kernel "
             ":293)", l3),
            ("K4", "stage1_sweep", "stage1_sweep.cu",
             "ravqa_tpu/ops/maxsim.py:510", l4)):
        sw = sweeps[key]
        kernels[key] = {
            "name": name, "route": "cuda", "source": src + source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": sw["err"], "ms": sw["ms"],
            "plain_ms": sw["plain_ms"], "shapes": sw["shapes"]}
    kernels["K2"]["launches_note"] = (
        "phase 6 (hierarchical and two-stage search under the reference "
        "preset); the fast serve slice runs K3 and K4")
    kernels["K3"]["pruned_search_launches"] = pruned_launches["K3"]
    kernels["K4"]["pruned_search_launches"] = pruned_launches["K4"]
    # the served answers' error against the same search by the plain
    # versions, apart from each kernel's own error above
    print(json.dumps({"kernels": [kernels[k] for k in sorted(kernels)],
                      "searches": searches,
                      "exact_serve_err": serve_err,
                      "hier_serve_err": hier_serve_err,
                      "hier_serve_recall": hier_recall}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
