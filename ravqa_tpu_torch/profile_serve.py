"""Where a serve slice's time goes, on one NVIDIA GPU.

    python -m ravqa_tpu_torch.profile_serve \\
        configs/synthetic_flmr_base_serve_hier.json \\
        configs/synthetic_flmr_base_serve.json \\
        configs/synthetic_preflmr_vitl_serve.json \\
        configs/synthetic_preflmr_vitl_serve_hier.json \\
        configs/synthetic_rag_blip2_serve.json \\
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
     dispatch's kernel time over its wall time without the profiler. With
     an in-graph ViT or the transformer mapping (the PreFLMR configs,
     whose requests carry 224 x 224 x 3 images) the tower's kernel time is
     split into the ViT, the text tower (BERT and the linear) and the
     transformer mapping, each profiled alone on the same batch.
A RAG config (a VQAServer: FLMR retrieval, then a T5 or BLIP-2 generator)
gets instead 3 closed bursts of 2 full batches (`serve.max_batch`
questions, each with seeded 768-d features and, for BLIP-2, its image),
questions/s, and the kernel time of one full dispatch split by stage
(vqa_stages: the query tower, the search, ViT-g, the Q-Former and
projection, the T5 encoder, the cross-attention keys and values, the beam
search), each profiled alone on the dispatch's own inputs, beside the whole
dispatch's kernel time over its wall time.
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
from .serving import VQAServer

BATCH = 32
BURSTS = 3
PROFILED_BATCHES = 8
# kernel_events' first launches in each trace, which the trace may lose:
# torch.cuda._sleep's spin_kernel, BURN_IN_CYCLES clock cycles each
BURN_IN = 64
BURN_IN_CYCLES = 10_000
BURN_IN_KERNEL = "spin_kernel"
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


def kernel_events(fn, n=PROFILED_BATCHES, attempts=4):
    """Run fn n times under torch.profiler. Returns {kernel name: [device
    ms summed over the trace, events]}, from the kernel and memcpy/memset
    events of its trace.

    A trace on the card loses kernels (their launches kept), mostly the
    first after the profiler starts, and more the older the process:
    scripts/profiler_trace_loss.py measures it. So BURN_IN launches of
    torch's `spin_kernel` (torch.cuda._sleep) go first, inside the
    window, and a trace that kept fewer of fn's kernels than fn launched
    is taken again with four times the burn-in, `attempts` times in all.
    The trace that kept most is returned (the caller can count what it
    kept); none that kept any of fn's kernels raises. The burn-in is not
    in the result."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    burn_in, best = BURN_IN, (-1, {})
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(burn_in):
                torch.cuda._sleep(BURN_IN_CYCLES)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        out, kept, launches = _device_events(prof, BURN_IN_KERNEL)
        if kept > best[0]:
            best = (kept, out)
        if kept >= launches - burn_in:
            break
        print(f"  (the profiler's trace kept {kept} of fn's "
              f"{launches - burn_in} kernels after {burn_in} burn-in "
              f"launches; taken again with {4 * burn_in})", flush=True)
        burn_in *= 4
    if best[0] <= 0:
        raise RuntimeError(f"the profiler's trace kept none of fn's "
                           f"kernels in {attempts} attempts")
    return best[1]


def _device_events(prof, skip: str) -> tuple:
    """Of prof's Chrome trace: ({kernel name: [device ms, events]} of the
    kernel and memcpy/memset events, the kernel events, the kernel
    launches), leaving out the kernels whose name holds `skip` (their
    launches are counted)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out: dict = {}
    kernels = launches = 0
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset") and skip not in name:
            hit = out.setdefault(name, [0.0, 0])
            hit[0] += e["dur"] / 1e3
            hit[1] += 1
            kernels += cat == "kernel"
        elif cat in ("cuda_runtime", "cuda_driver") and "Launch" in name:
            launches += 1
    return out, kernels, launches


def kernel_times(fn, n=PROFILED_BATCHES):
    """Run fn n times under torch.profiler. Returns {kernel name: device
    ms per call} (kernel_events' sums over n)."""
    return {k: ms / n for k, (ms, _) in kernel_events(fn, n).items()}


def _requests(data, n):
    items = data["train"].items + data["test"].items
    return [items[i % len(items)] for i in range(n)]


def _vision(r) -> dict:
    """A request's image: its features, or its pixels (float32) for an
    in-graph ViT."""
    if "image" in r:
        return {"pixel_values": np.asarray(r["image"], np.float32)}
    return {"image_features": r["image_features"]}


def vqa_request(i: int, item: dict, server) -> dict:
    """submit()'s image arguments of VQA request i: seeded features of the
    server's width (seed 20,000 + i) and, where the server takes pixels,
    the item's image (float32)."""
    out = {}
    if server.image_feature_dim:
        out["image_features"] = np.random.default_rng(20_000 + i).normal(
            size=server.image_feature_dim).astype(np.float32)
    if server.pixel_shape is not None:
        out["pixel_values"] = np.asarray(item["image"], np.float32)
    return out


def bursts(server, data, n=256):
    """BURSTS closed bursts of n requests (the data's questions and images
    in turn; vqa_request's for a VQAServer) submitted at once. Returns
    [{"req_per_s", "dispatches"}]."""
    out = []
    reqs = _requests(data, n)
    vqa = isinstance(server, VQAServer)
    for _ in range(BURSTS):
        d0 = server.dispatches
        t0 = time.perf_counter()
        futs = [server.submit(r["question"], **(
            vqa_request(i, r, server) if vqa else _vision(r)))
            for i, r in enumerate(reqs)]
        for f in futs:
            f.result(120)
        wall = time.perf_counter() - t0
        out.append({"req_per_s": n / wall,
                    "dispatches": server.dispatches - d0})
    return out


def vqa_stages(server, data, b: int) -> tuple:
    """The stages of a VQAServer dispatch of b questions (vqa_request's
    images), each as a function of the dispatch's own inputs, computed
    once here: {stage: fn}, and the dispatch's rows for _dispatch."""
    ex = server.ex
    gen = ex.model.generator
    rows = []
    for i, r in enumerate(_requests(data, b)):
        ids, mask = server.qt.tensorize([r["question"]])
        img = vqa_request(i, r, server)
        rows.append((r["question"], np.asarray(ids)[0], np.asarray(mask)[0],
                     img.get("image_features"), img.get("pixel_values"),
                     None))
    batch = server.gen_batch(rows)
    with torch.inference_mode():
        ret = ex.retrieve(batch)
        gi, gm = ex._tensorize(ex.input_builder.build(batch["questions"],
                                                      ret["contents"]),
                               ex.rag_cfg.gen_maxlen)
        q = ex.encode_query(batch)
        n_docs = ret["rows"].shape[1]
        ids = torch.as_tensor(gi, dtype=torch.long, device=ex.device)
        mask = torch.as_tensor(gm, device=ex.device)
        enc, enc_mask = ex.encode_generator(gi, gm,
                                            batch.get("pixel_values"))
        kv = gen.cross_kv(enc)
    stages = {"retrieval: query tower": lambda: ex.encode_query(batch),
              "retrieval: search": lambda: ex.searcher.search_device(
                  q, n_docs)}
    if ex.rag_cfg.generator_type == "blip2":
        px = torch.as_tensor(batch["pixel_values"], device=ex.device)
        with torch.inference_mode():
            img = gen.vision_model(px)
            qtok = gen.query_tokens.expand(b, *gen.query_tokens.shape)
            vis = gen.encode_image(px).repeat_interleave(n_docs, dim=0)
        stages["ViT-g"] = lambda: gen.vision_model(px)
        stages["Q-Former and projection"] = lambda: gen.language_projection(
            gen.qformer(qtok, img))
        stages["T5 encoder"] = lambda: gen.encode_tokens(vis, ids, mask)
    else:
        stages["T5 encoder"] = lambda: gen.encode(ids, mask)
    stages["cross-attention K/V"] = lambda: gen.cross_kv(enc)
    stages["decode"] = lambda: ex.decode(kv, enc_mask)
    return stages, rows


def profile_vqa(server, data) -> dict:
    """A VQAServer's bursts, and one full dispatch's kernel time by stage
    against its wall time."""
    b = server.cfg.max_batch
    res = {"bursts": bursts(server, data, n=2 * b)}
    print(f"bursts of {2 * b}:", res["bursts"], flush=True)
    stages, rows = vqa_stages(server, data, b)
    with torch.inference_mode():
        split = {name: sum(kernel_times(fn, n=2).values())
                 for name, fn in stages.items()}

        def dispatch():
            server._dispatch([r + (Future(),) for r in rows])

        device_ms = sum(kernel_times(dispatch, n=2).values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            dispatch()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    res["profile"] = {"batch": b, "device_ms_per_dispatch": split,
                      "dispatch_device_ms": device_ms,
                      "dispatch_wall_ms": wall_ms,
                      "device_busy_share": device_ms / wall_ms}
    print(f"profile, device ms per dispatch of {b}: "
          + ", ".join(f"{n} {ms:.3f}" for n, ms in split.items()),
          flush=True)
    print(f"dispatch: {device_ms:.3f} ms of kernels in {wall_ms:.3f} ms of "
          f"wall ({device_ms / wall_ms:.1%} busy)", flush=True)
    return res


def profile_config(path: str) -> dict:
    cfg = load_config(path)
    t0 = time.perf_counter()
    data = build_pipeline(cfg).get_data(cfg.data_pipeline_output_node,
                                        explode=True)
    server = build_server(cfg, data, "cuda")
    if isinstance(server, VQAServer):
        res = {"config": path, "setup_s": time.perf_counter() - t0,
               "docs": server.ex.index.num_docs}
        print(f"{path}: VQA, {res['docs']} docs, set-up "
              f"{res['setup_s']:.1f} s", flush=True)
        try:
            res.update(profile_vqa(server, data))
        finally:
            server.stop()
        return res
    s, ex, k = server.searcher, server.ex, server.cfg.k
    res = {"config": path, "mode": s.mode, "preset": s.preset,
           "docs": s.index.num_docs,
           "setup_s": time.perf_counter() - t0}
    print(f"{path}: {s.mode} {s.preset}, {s.index.num_docs} docs, set-up "
          f"{res['setup_s']:.1f} s", flush=True)
    try:
        res["bursts"] = bursts(server, data)
        print("bursts of 256:", res["bursts"], flush=True)

        reqs = _requests(data, BATCH)
        ids, mask = map(np.asarray, data["query_tokenizer"].tensorize(
            [r["question"] for r in reqs]))
        vis = {key: np.stack([_vision(r)[key] for r in reqs])
               for key in _vision(reqs[0])}
        feats = vis.get("image_features")
        pixels = vis.get("pixel_values")

        def encode(b=BATCH):
            return ex.encode_query(ids[:b], mask[:b], *(
                None if x is None else x[:b] for x in (feats, pixels)))

        with torch.inference_mode():
            res["per_batch"] = {}
            for b in (32, 8, 1):
                q = encode(b)
                enc = _time_ms(lambda: encode(b))
                srch = _time_ms(lambda: s.search_device(q, k))
                res["per_batch"][b] = {"encode_ms": enc, "search_ms": srch}
                print(f"B={b}: encode {enc:.3f} ms, search {srch:.3f} ms",
                      flush=True)

            q = encode()
            tower = kernel_times(encode)
            search = kernel_times(lambda: s.search_device(q, k))
            res["tower_parts_ms"] = tower_parts(ex, ids, mask, pixels)

            def dispatch():
                server._dispatch([
                    (ids[i], mask[i],
                     None if feats is None else feats[i],
                     None if pixels is None else pixels[i], Future())
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
        "query_tower_parts_ms": res.pop("tower_parts_ms"),
        "dispatch_device_ms": device_ms,
        "dispatch_wall_ms": wall_ms,
        "device_busy_share": device_ms / wall_ms,
        "top_search_kernels": dict(sorted(search.items(),
                                          key=lambda kv: -kv[1])[:12])}
    print(f"profile, device ms per batch of {BATCH}: "
          + ", ".join(f"{n} {ms:.3f}" for n, ms in
                      sorted(split.items(), key=lambda kv: -kv[1])),
          flush=True)
    print(f"dispatch: {device_ms:.3f} ms of kernels in {wall_ms:.3f} ms of "
          f"wall ({device_ms / wall_ms:.1%} busy)", flush=True)
    return res


def tower_parts(ex, ids, mask, pixels) -> dict:
    """The query tower's kernel time per batch, by part, each part
    profiled alone on the batch's own inputs: the ViT, the text tower
    (BERT and the linear) and the transformer mapping (on the ViT's
    last-layer patch rows). Empty without an in-graph ViT."""
    m = ex.model
    if not m.cfg.in_graph_vision:
        return {}
    ids_t = torch.as_tensor(ids, dtype=torch.long, device=ex.device)
    mask_t = torch.as_tensor(mask, device=ex.device)
    parts = {"text tower (BERT, linear)": lambda: m.linear(
        m.query_bert(ids_t, mask_t)[0])}
    px = torch.as_tensor(pixels, device=ex.device)
    parts["ViT"] = lambda: m.vision_model(px)
    if m.cfg.use_transformer_mapping:
        hidden = m.query_bert(ids_t, mask_t)[0]
        patches = m.vision_model(px)[0][:, 1:]
        parts["transformer mapping"] = lambda: m.transformer_mapping(
            patches, hidden, mask_t)
    out = {name: sum(kernel_times(fn).values())
           for name, fn in parts.items()}
    print("query tower by part, device ms per batch: "
          + ", ".join(f"{n} {ms:.3f}" for n, ms in out.items()), flush=True)
    return out


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
