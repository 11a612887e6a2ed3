"""The FLMR family's serve cell (FLMR and PreFLMR): the program's
RetrievalServer over a seeded token index, driven by the cell's traffic,
then its answers judged against the plain reference.

Set-up composes the program's objects as its `main.build_server` does
(the executor with inference_only, LateInteractionSearcher,
RetrievalServer, warm_up), with the benchmark's seeded weights and index
in place of a checkpoint and a corpus encoded through the doc tower.
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from .. import generator, inputs, judge
from ..spec import ROOT
from ..trace import Tracer
from ..reference import search as ref_search
from ..reference import tokenize as ref_tok
from ..reference import towers


def build(cell, seed: int, device, cache_dir: str, span):
    """The program's server over the benchmark's inputs -> (server, state)
    where state holds the benchmark's own inputs for the reference."""
    from ravqa_tpu_torch.executors import FLMRExecutor, TrainConfig
    from ravqa_tpu_torch.main import _flmr_config_from
    from ravqa_tpu_torch.models import FLMRRetriever
    from ravqa_tpu_torch.retrieval import LateInteractionSearcher, TokenIndex
    from ravqa_tpu_torch.serving import RetrievalServer, ServeConfig
    from ravqa_tpu_torch.tokenization import QueryTokenizer, WordPieceTokenizer

    cfg, sv = cell.cfg, cell.work["serve"]
    mc = cfg["model_config"]
    weights = inputs.make_weights(towers.param_specs(mc), seed, device)
    model = FLMRRetriever(_flmr_config_from(mc), device="meta")
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    ex = FLMRExecutor(model, TrainConfig(modules=tuple(mc.get("modules", []))),
                      device=device, quiet=True, inference_only=True,
                      logger_backends=())
    tokens, mask, n_docs = inputs.make_index(cfg, seed, device)
    pids = np.arange(tokens.shape[0], dtype=np.int64)
    pids[n_docs:] = -1
    index = TokenIndex(tokens=tokens, mask=mask, pids=pids, num_docs=n_docs,
                       meta={"doc_maxlen": tokens.shape[1],
                             "dim": tokens.shape[2]})
    mode = sv["search_mode"]
    if mode == "hierarchical":
        index.build_summaries(n_summary=sv["n_summary"])
        index.build_block_summaries(block_size=sv["block_size"])
    # use_pallas: the kernels' route (on a CPU index, in the CPU tests,
    # their plain versions)
    searcher = LateInteractionSearcher(
        index, None, "index", use_pallas=True, mode=mode,
        preset=sv["preset"],
        n_candidates=sv.get("n_candidates"), n_blocks=sv.get("n_blocks"))
    vocab_size = cfg["model_config"].get("bert", {}).get("vocab_size", 30522)
    base = WordPieceTokenizer(inputs.vocab_file(vocab_size, cache_dir))
    qt = QueryTokenizer(base, query_maxlen=cfg["query_maxlen"])
    vit = mc.get("vit")
    server = RetrievalServer(
        ex, searcher, qt,
        image_feature_dim=0 if vit else mc.get("vision_embedding_size", 768),
        pixel_shape=((vit["image_size"], vit["image_size"], 3)
                     if vit else None),
        config=ServeConfig(max_batch=sv["max_batch"],
                           max_wait_ms=sv["max_wait_ms"], k=sv["k"],
                           batch_buckets=(tuple(sv["batch_buckets"])
                                          if sv.get("batch_buckets")
                                          else None)))
    _add_ranges(server, span)
    server.warm_up()
    state = {"weights": weights, "tokens": tokens, "mask": mask,
             "n_docs": n_docs, "vocab_size": vocab_size}
    return server, state


def _add_ranges(server, span) -> None:
    """The benchmark's ranges (Tracer.span) around the server's dispatch,
    its query tower and its search (each range names the padded batch)."""
    encode, search = server.encode, server.searcher.search_device
    dispatch = server._dispatch

    def encode_r(batch):
        with span(f"pb.encode.b{len(batch)}"):
            return encode(batch)

    def search_r(q, k):
        with span(f"pb.search.b{q.shape[0]}"):
            return search(q, k)

    def dispatch_r(batch):
        server.pb_dispatches.append((time.perf_counter(), len(server.sizes)))
        with span("pb.dispatch"):
            return dispatch(batch)

    server.pb_dispatches = []

    server.encode = encode_r
    server.searcher.search_device = search_r
    server._dispatch = dispatch_r


def run(cell, seed: int, seconds: float, tracer, device, cache_dir: str,
        t_start: float) -> dict:
    server, state = build(cell, seed, device, cache_dir, tracer.span)
    reqs = inputs.Requests(
        cell.traffic, seed, inputs.vocab_words(state["vocab_size"]),
        feature_dim=server.image_feature_dim,
        pixel_shape=server.pixel_shape, device=device)
    _sync(device)
    with tracer:
        log = generator.drive(server, reqs, cell.traffic, seed, seconds,
                              t_start, tracer.span)
    # the dispatches that started in the window, as the server recorded them
    window_sizes = [server.sizes[i] for t, i in server.pb_dispatches
                    if log.t0 <= t <= log.t1 and i < len(server.sizes)]
    peak = _peak(device)
    server.stop()
    answers = log.answers
    del server
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check(cell, state, reqs, answers, log, seed)
    return {"log": log, "sizes": window_sizes, "peak": peak,
            "checks": checks, "state": state, "reqs": reqs}


# the window of a program reading in `controls`: the cell's own load, long
# enough to answer more requests than a run's check samples
PROGRAM_WINDOW_S = 5.0


def controls(cell, seed: int, device, program: bool) -> dict:
    """The readings that the limits of `correct` are set from: the
    reference in TF32 put in the program's place, answering the first
    `sample` requests of the pool, read as a run reads the program
    (judge.serve_numbers against the float32 reference); with `program`,
    first the program's own numbers from a run of PROGRAM_WINDOW_S."""
    out = {}
    if program:
        got = run(cell, seed, PROGRAM_WINDOW_S, Tracer(False), device,
                  os.path.join(ROOT, ".portbench_cache"), time.perf_counter())
        out["program"] = {k: c["value"] for k, c in got["checks"].items()}
        state, reqs = got["state"], got["reqs"]
    else:
        state, reqs = _inputs(cell, seed, device)
    sample = list(range(cell.work["check"]["sample"]))
    with torch.no_grad():
        ref = reference_answers(cell, state, reqs, sample, "float32")
        ctl = reference_answers(cell, state, reqs, sample, "tf32")
    served = [judge.Answer(r.cpu().numpy(), s.cpu().numpy())
              for s, r in zip(ctl["top_s"], ctl["top_r"])]
    out["tf32"] = judge.serve_numbers(served, ref, state["n_docs"])
    return out


def _inputs(cell, seed: int, device):
    """The benchmark's inputs of a run (weights, index, request pool),
    without the program."""
    cfg = cell.cfg
    mc = cfg["model_config"]
    vocab_size = mc.get("bert", {}).get("vocab_size", 30522)
    tokens, mask, n_docs = inputs.make_index(cfg, seed, device)
    state = {"weights": inputs.make_weights(towers.param_specs(mc), seed,
                                            device),
             "tokens": tokens, "mask": mask, "n_docs": n_docs,
             "vocab_size": vocab_size}
    vit = mc.get("vit")
    reqs = inputs.Requests(
        cell.traffic, seed, inputs.vocab_words(vocab_size),
        feature_dim=0 if vit else mc.get("vision_embedding_size", 768),
        pixel_shape=((vit["image_size"], vit["image_size"], 3)
                     if vit else None), device=device)
    return state, reqs


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0


@torch.no_grad()
def check(cell, state, reqs, answers, log, seed: int) -> dict:
    """The reference over a seeded sample of the answered requests (the
    longest question among them), then judge.serve_numbers."""
    sample = judge.sample_requests(answers, reqs, cell.work["check"]["sample"],
                                   seed)
    ref = reference_answers(cell, state, reqs, sample, "float32")
    served = [answers[i] for i in sample]
    numbers = judge.serve_numbers(served, ref, state["n_docs"])
    numbers["unanswered"] = float(log.unanswered)
    return judge.with_limits(numbers, cell.work["check"]["limits"])


def reference_answers(cell, state, reqs, sample, precision: str):
    """The reference's (q, top scores, exact scores of a row lookup) for
    the sampled requests, at the configuration's precision or the
    control's."""
    cfg, sv = cell.cfg, cell.work["serve"]
    mc = cfg["model_config"]
    w = state["weights"]
    vocab = inputs.vocab(state["vocab_size"])
    entries = [reqs.entry(i) for i in sample]
    with towers.precision(precision):
        qs = []
        for lo in range(0, len(entries), 32):
            chunk = entries[lo:lo + 32]
            ids, msk = ref_tok.queries([reqs.texts[e] for e in chunk], vocab,
                                       cfg["query_maxlen"])
            dev = state["tokens"].device
            ids, msk = torch.as_tensor(ids, device=dev), \
                torch.as_tensor(msk, device=dev)
            img = [reqs.image(e) for e in chunk]
            feats = pix = None
            if "image_features" in img[0]:
                feats = torch.as_tensor(np.stack(
                    [x["image_features"] for x in img]), device=dev)
            elif "pixel_values" in img[0]:
                pix = torch.as_tensor(np.stack(
                    [x["pixel_values"] for x in img]), device=dev)
            qs.append(towers.query(w, mc, ids, msk, feats, pix))
        q = torch.cat(qs)
        k = sv["k"]
        tokens, mask = state["tokens"], state["mask"]
        if sv["search_mode"] == "exact":
            top_s, top_r = ref_search.exact_topk(q, tokens, mask, k)
            bound = top_s
        else:
            hier = state.get("hier")
            if hier is None:
                hier = state["hier"] = ref_search.Hierarchical(
                    tokens, mask, block_size=sv["block_size"],
                    n_summary=sv["n_summary"],
                    n_block_summary=sv["n_block_summary"])
            top_s, top_r, bound = hier.search(q, k, sv["n_blocks"],
                                              sv["n_candidates"])
    return {"q": q, "top_s": top_s, "top_r": top_r, "bound": bound,
            "score": lambda rows: ref_search.maxsim_rows(q, tokens, mask,
                                                         rows)}
