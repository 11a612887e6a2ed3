"""Rank functions of the port's multi-process CPU tests.

parallel.launch runs each of these in spawned processes joined to a gloo
group; a spawned rank imports this module by name, so it imports torch and
the port only (never jax). Inputs arrive as numpy arrays and results go
back as numpy arrays or floats, from every rank.
"""

import numpy as np
import torch
import torch.distributed as dist


def _np(t):
    """A copy (a CPU tensor's numpy() would share the memory that later
    steps update in place)."""
    return t.detach().cpu().numpy().copy()


# -- parallel ---------------------------------------------------------------

def mesh_rank(batch: dict) -> dict:
    """This rank's view of the mesh helpers on a global batch."""
    from ravqa_tpu_torch.parallel import (axis_rank, make_mesh,
                                          mesh_axis_size, shard_batch)
    n = dist.get_world_size()
    mesh = make_mesh({"data": n})
    out = {"slice": shard_batch(batch, mesh, "data"),
           "size": mesh_axis_size(mesh, "data"),
           "rank": axis_rank(mesh, "data")}
    if n % 2 == 0:
        mesh2 = make_mesh({"a": 2, "b": n // 2})
        out["rank_ab"] = axis_rank(mesh2, ("a", "b"))
        out["size_ab"] = mesh_axis_size(mesh2, ("a", "b"))
        out["rank_b"] = axis_rank(mesh2, "b")
    return out


def gather_rank(x: np.ndarray) -> dict:
    """gather_with_local_grads and gather_rows of this rank's rows of x,
    each under the JAX test's loss sum(g * w) / rows with w the gathered
    row index: the values gathered and the grads of the rank's rows."""
    from ravqa_tpu_torch.parallel import (gather_rows,
                                          gather_with_local_grads, make_mesh,
                                          shard_rows)
    mesh = make_mesh({"data": dist.get_world_size()})
    group = mesh.get_group("data")
    out = {}
    for name, fn in (("local", gather_with_local_grads),
                     ("rows", gather_rows)):
        xl = torch.tensor(x[shard_rows(len(x), mesh)], requires_grad=True)
        g = fn(xl, group)
        w = torch.arange(g.shape[0], dtype=torch.float32)[:, None]
        ((g * w).sum() / g.shape[0]).backward()
        out[name] = (_np(g), _np(xl.grad))
    return out


def fail_on_rank_1():
    """Rank 1 raises; the others wait in a barrier until they are killed."""
    if dist.get_rank() == 1:
        raise ZeroDivisionError("rank 1 fails on purpose")
    dist.barrier()


# -- sharded search -----------------------------------------------------------

def _codec(arrays):
    from ravqa_tpu_torch.ops.residual import ResidualCodec
    t = {k: None if v is None else torch.from_numpy(v)
         for k, v in arrays.items() if k != "nbits"}
    return ResidualCodec(centroids=t["centroids"],
                         bucket_cutoffs=t["bucket_cutoffs"],
                         bucket_weights=t["bucket_weights"],
                         nbits=arrays["nbits"], coarse=t["coarse"],
                         fine=t["fine"])


def _sharded_index(kind, embs, masks, pids, codecs, mesh, block_size):
    from ravqa_tpu_torch.parallel import local_device
    from ravqa_tpu_torch.retrieval import build_index_from_embeddings
    idx = build_index_from_embeddings(embs, masks, pids, 8, torch.float32,
                                      mesh, "index", device=local_device())
    idx.build_summaries(n_summary=4)
    idx.build_block_summaries(block_size=block_size)
    if kind == "int8":
        idx.quantize_int8()
    elif kind in codecs:
        idx.quantize_residual(mesh=mesh, axis="index",
                              codec=_codec(codecs[kind]))
    return idx


def search_rank(specs: list, embs, masks, pids, q, codecs: dict,
                block_size: int) -> dict:
    """Each spec (name, index kind, searcher kwargs, k) searched over an
    index sharded over "index" on the rank's device: {name: (scores, pids,
    the per-shard cuts, with "rows": whether the shard kept the stage-1
    rows, and "k4": this rank's K4 launches in the search)}."""
    import warnings
    from ravqa_tpu_torch.ops import maxsim
    from ravqa_tpu_torch.parallel import make_mesh
    from ravqa_tpu_torch.retrieval import LateInteractionSearcher
    mesh = make_mesh({"index": dist.get_world_size()})
    indexes, out = {}, {}
    for name, kind, kw, k in specs:
        if kind not in indexes:
            indexes[kind] = _sharded_index(kind, embs, masks, pids, codecs,
                                           mesh, block_size)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            s = LateInteractionSearcher(indexes[kind], mesh, "index", **kw)
            before = maxsim.stage1_sweep.launches
            scores, found = s.search(q, k)
        out[name] = (scores, found, dict(
            s._search_fn(k).cuts, rows=s._summ_rows is not None,
            k4=maxsim.stage1_sweep.launches - before))
    return out


def codec_rank(embs, masks, n_centroids, sample, heldout) -> dict:
    """The codec a sharded index trains (on the global sample) and its
    records, gathered."""
    from ravqa_tpu_torch.parallel import make_mesh
    from ravqa_tpu_torch.retrieval import build_index_from_embeddings
    mesh = make_mesh({"index": dist.get_world_size()})
    idx = build_index_from_embeddings(embs, masks, None, 8, torch.float32,
                                      mesh, "index")
    idx.build_summaries(n_summary=2)
    idx.quantize_residual(n_centroids, 2, mesh, "index", seed=3,
                          sample=sample, heldout=heldout)
    return {"centroids": _np(idx.codec_centroids),
            "weights": _np(idx.codec_weights),
            "records": _np(idx._gathered(idx.records))}


def index_io_rank(path: str, embs, masks) -> dict:
    """load_index of this rank's rows, then a sharded save of the same
    index (rank 0 writes under path + "_resaved")."""
    from ravqa_tpu_torch.parallel import make_mesh
    from ravqa_tpu_torch.retrieval import (build_index_from_embeddings,
                                           encode_corpus, load_index,
                                           save_index)
    mesh = make_mesh({"index": dist.get_world_size()})
    loaded = load_index(path, torch.float32, mesh, "index")
    built = build_index_from_embeddings(embs, masks, None, 8, torch.float32,
                                        mesh, "index")
    save_index(built, path + "_resaved")
    # encode_corpus over batches of 5: each rank encodes its own rows
    calls = []

    def encode(b):
        calls.append(len(b["i"]))
        rows = torch.as_tensor(np.asarray(b["i"]))
        return (torch.from_numpy(embs)[rows],
                torch.from_numpy(masks)[rows].to(torch.int8))

    batches = [{"i": list(range(s, min(s + 5, len(embs))))}
               for s in range(0, len(embs), 5)]
    enc = encode_corpus(encode, batches, pad_multiple=8,
                        dtype=torch.float32, mesh=mesh, axis="index")
    return {"loaded": _np(loaded.tokens), "loaded_mask": _np(loaded.mask),
            "pids": loaded.pids, "n_pad": loaded.n_pad,
            "built": _np(built.tokens), "encoded": _np(enc.tokens),
            "encoded_mask": _np(enc.mask), "encoded_rows": sum(calls)}


def positional_mesh_rank(path: str, embs, masks, q) -> dict:
    """tests/test_torch_index.py's calls with a mesh at the JAX package's
    argument positions."""
    from ravqa_tpu_torch.parallel import make_mesh
    from ravqa_tpu_torch.retrieval import (LateInteractionSearcher,
                                           build_index_from_embeddings,
                                           load_index)
    mesh = make_mesh({"index": dist.get_world_size()})
    loaded = load_index(path, torch.float32, mesh, "index")
    built = build_index_from_embeddings(embs, masks, None, 8, torch.float32,
                                        mesh, "index")
    search = LateInteractionSearcher(built, mesh, "index").search(q, 5)
    tokens = _np(built.tokens)
    built.build_summaries(n_summary=2)
    built.quantize_residual(16, 2, mesh, "index", 1)
    return {"loaded": _np(loaded.tokens), "built": tokens,
            "records": _np(built.records), "search": search}


# -- data-parallel training ---------------------------------------------------

def _flmr(cfg_kw: dict, state: dict):
    from ravqa_tpu_torch.models import FLMRModelConfig, FLMRRetriever
    from ravqa_tpu_torch.models.bert import BertConfig
    kw = dict(cfg_kw)
    kw["bert"] = BertConfig(**kw["bert"])
    model = FLMRRetriever(FLMRModelConfig(**kw))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def train_rank(cfg_kw: dict, state: dict, batches: list, lr: float,
               sharding: str, min_size: int, grad_clip: float = 0.0,
               ckpt: str = "") -> dict:
    """FLMR train steps of a data-parallel executor (on the rank's device)
    on the global batches:
    each step's metrics, the first step's (averaged) grads, the parameters
    and Adam's moments after the first step, the parameters after the
    last, the share of Adam's moment
    elements this rank holds; with `ckpt`, a checkpoint after the first
    step, loaded into a fresh executor that takes the remaining steps."""
    from torch.distributed.tensor import DTensor
    from ravqa_tpu_torch.executors import FLMRExecutor, TrainConfig
    from ravqa_tpu_torch.parallel import full_tensor, local_device, make_mesh
    mesh = make_mesh({"data": dist.get_world_size()})

    def executor():
        return FLMRExecutor(_flmr(cfg_kw, state),
                            TrainConfig(lr=lr, grad_clip=grad_clip),
                            device=local_device(), quiet=True, mesh=mesh,
                            param_sharding=sharding, fsdp_min_size=min_size)

    def full(t):
        return _np(full_tensor(t))

    ex = executor()
    out = {"metrics": [], "grads": None}
    for i, b in enumerate(batches):
        m = ex.train_step(b)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["grads"] = {n: full(p.grad) for n, p in
                            ex.model.named_parameters() if p.grad is not None}
            out["params_1"] = {k: _np(v) for k, v in
                               ex.full_state_dict().items()}
            out["moments_1"] = [
                {k: full(st[k]) for k in ("exp_avg", "exp_avg_sq")}
                for st in (ex.optimizer.adamw.state[p]
                           for p in ex.optimizer.trainable)]
            if ckpt:
                ex.save_checkpoint(ckpt)
                dist.barrier()
                ex = executor()
                ex.load_checkpoint(ckpt)
                out["resumed_step"] = ex.step
    out["params"] = {k: _np(v) for k, v in ex.full_state_dict().items()}
    held = total = 0
    for st in ex.optimizer.adamw.state.values():
        for key in ("exp_avg", "exp_avg_sq"):
            t = st[key]
            held += (t.to_local() if isinstance(t, DTensor) else t).numel()
            total += t.numel()
    out["moment_share"] = held / total
    return out


def m2kr_rank(cfg_kw: dict, state: dict, sizes: list, kw: dict) -> dict:
    """train_m2kr on three SyntheticOKVQA worlds with a data-parallel
    executor: the per-step logged metrics and train_m2kr's summary."""
    from ravqa_tpu_torch.data import DataPipeline
    from ravqa_tpu_torch.executors import FLMRExecutor, TrainConfig, m2kr
    from ravqa_tpu_torch.parallel import make_mesh
    mesh = make_mesh({"data": dist.get_world_size()})
    worlds = [m2kr_world(DataPipeline, *a) for a in sizes]
    for w in worlds:
        w["train"].rng = np.random.default_rng(7)
    ex = FLMRExecutor(_flmr(cfg_kw, state), TrainConfig(lr=1e-3),
                      device="cpu", quiet=True, mesh=mesh)
    tasks = [m2kr.M2KRTask(n, w["test"], w["passages"]["full_passages"],
                           ks=(1, 5), train_dataset=w["train"])
             for n, w in zip(M2KR_NAMES, worlds)]
    got = m2kr.train_m2kr(ex, tasks, **kw)
    log = [{k: v for k, v in h.items() if k != "time"}
           for h in ex.logger.history]
    return {"summary": {k: v for k, v in got.items()
                        if k in ("per_task_batches", "per_task_loss",
                                 "eval_history")},
            "log": log}


M2KR_NAMES = ("okvqa", "wit", "infoseek")


def m2kr_world(pipeline, seed, n_docs, n_q):
    return pipeline({
        "raw": {"transform_name": "SyntheticOKVQA",
                "setup_kwargs": {"n_docs": n_docs, "n_questions": n_q,
                                 "vision_dim": 8, "seed": seed}},
        "loaders": {"transform_name": "PrepareDataloaders",
                    "input_node": "raw",
                    "setup_kwargs": {"query_maxlen": 16, "doc_maxlen": 12,
                                     "nway": 2}},
    }).get_data("loaders", explode=True)


def rag_rank(config: str, steps: int) -> dict:
    """RAG training steps of configs/synthetic_rag.json's executor on a
    data-parallel mesh (or one device without a process group), on the
    same global batches: each step's metrics and the trained LoRA and
    retriever parameters."""
    from ravqa_tpu_torch.config import load_config
    from ravqa_tpu_torch.main import (build_pipeline, build_rag_executor,
                                      rag_batches)
    from ravqa_tpu_torch.parallel import make_mesh
    mesh = (make_mesh({"data": dist.get_world_size()})
            if dist.is_initialized() else None)
    cfg = load_config(config)
    data = build_pipeline(cfg).get_data(cfg.data_pipeline_output_node,
                                        explode=True)
    ex = build_rag_executor(cfg, data, "cpu", mesh=mesh)
    raw = rag_batches(data["train"], 4, seed=0)
    metrics = [{k: float(v) for k, v in
                ex.train_step_rag(next(raw)).items()} for _ in range(steps)]
    return {"metrics": metrics,
            "params": {n: _np(p) for n, p in ex.model.named_parameters()
                       if p.requires_grad}}


def rag_mesh_rank(pipeline: dict, vocab: int, eos: int, params: dict,
                  tokens, mask, contents: list, ids: list, batch: dict,
                  rag_kw: dict, train_kw: dict) -> dict:
    """One train_step_rag of a RagExecutor (tiny FLMR retriever with a
    separate question encoder, tiny gated-gelu T5 with LoRA) on a "data"
    mesh of every rank, over an index of `tokens` sharded on it, from the
    JAX params tree `params`, on the global `batch`: the step's metrics,
    the trainable grads (the global batch's, summed over the ranks'
    shares) and the parameters after the update, by the names
    tests/test_torch_rag_train.py gives them."""
    from ravqa_tpu_torch.data import DataPipeline
    from ravqa_tpu_torch.executors import RagConfig, RagExecutor, TrainConfig
    from ravqa_tpu_torch.models import (BertConfig, FLMRModelConfig,
                                        FLMRRetriever, T5Config, T5Model)
    from ravqa_tpu_torch.parallel import make_mesh
    from ravqa_tpu_torch.retrieval import build_index_from_embeddings
    torch.manual_seed(0)
    mesh = make_mesh({"data": dist.get_world_size()})
    tw = DataPipeline(pipeline).get_data("loaders", explode=True)
    retriever = FLMRRetriever(FLMRModelConfig.tiny(
        bert=BertConfig.tiny(vocab_size=vocab), vision_dim=8, prefix_len=2,
        dim=16, nway=2, separate_question_encoder=True))
    gen = T5Model(T5Config.tiny(vocab_size=vocab, eos_token_id=eos,
                                feed_forward_proj="gated-gelu",
                                tie_word_embeddings=False))
    index = build_index_from_embeddings(tokens, mask, pad_multiple=8,
                                        dtype=torch.float32, mesh=mesh,
                                        axis="data")
    ex = RagExecutor(retriever, gen, tw["tokenizer"], RagConfig(**rag_kw),
                     train_cfg=TrainConfig(**train_kw),
                     query_tokenizer=tw["query_tokenizer"], index=index,
                     passage_contents=contents, passage_ids=ids,
                     device="cpu", quiet=True, mesh=mesh)
    ex.load_params_tree(params)
    names = {**{f"retriever.{k}": p for k, p in
                ex.model.retriever.named_parameters()},
             **{f"lora:{k}:{leaf}": p for k, e in ex.lora.items()
                for leaf, p in e.items()}}
    m = ex.train_step(ex.make_train_batch(batch))
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": {n: _np(p.grad) for n, p in names.items()
                      if p.requires_grad},
            "params": {n: _np(p) for n, p in names.items()}}


def vqa_serve_rank(config: str, opts: list, question: str):
    """build_server on a RAG config over a "data" mesh: rank 0 answers
    `question` through its VQAServer, then ends the other ranks'
    serve_shard loops; returns (answer, passages, doc scores) on rank 0,
    the messages a worker ran elsewhere."""
    from ravqa_tpu_torch.config import apply_overrides, load_config
    from ravqa_tpu_torch.main import build_pipeline, build_server
    from ravqa_tpu_torch.parallel import make_mesh
    from ravqa_tpu_torch.serving import serve_shard
    mesh = make_mesh({"data": dist.get_world_size()})
    cfg = apply_overrides(load_config(config), opts)
    data = build_pipeline(cfg).get_data(cfg.data_pipeline_output_node,
                                        explode=True)
    server = build_server(cfg, data, "cpu", mesh=mesh)
    if dist.get_rank() != 0:
        return serve_shard(server)
    r = server.submit(question).result(120)
    server.stop()
    server.ex.searcher.shutdown()
    return r.answer, list(r.passages), np.asarray(r.doc_scores)


# -- tensor parallelism --------------------------------------------------------

def tp_rank(jobs: list) -> list:
    """Each job (kind "t5" or "bert", state dict, inputs, mesh axes): the
    model's linears sharded over "model" of a (data x model) mesh, its
    forward on this rank's "data" slice of the inputs: the output, the
    plan and the rank's slice."""
    from ravqa_tpu_torch.parallel import (apply_tp, make_mesh, shard_rows,
                                          tp_sharding)
    out = []
    for kind, state, inputs, axes in jobs:
        mesh = make_mesh(axes)
        if kind == "t5":
            from ravqa_tpu_torch.models import T5Config, T5Model
            model = T5Model(T5Config.tiny())
        else:
            from ravqa_tpu_torch.models import BertConfig, BertModel
            model = BertModel(BertConfig.tiny())
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state.items()})
        plan = tp_sharding(model, mesh, "model")
        apply_tp(model.eval(), mesh, "model")
        rows = shard_rows(len(next(iter(inputs.values()))), mesh, "data")
        args = [torch.from_numpy(v[rows]) for v in inputs.values()]
        with torch.no_grad():
            y = model(*args)
        y = y[0] if isinstance(y, tuple) else y
        out.append({"out": _np(y), "plan": plan,
                    "rows": (rows.start, rows.stop)})
    return out
