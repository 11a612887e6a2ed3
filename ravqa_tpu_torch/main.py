"""CLI entry point of the PyTorch port: config-driven FLMR retrieval
training, evaluation and serving, and RAVQA training, evaluation and
answer serving.

Port of ravqa_tpu/main.py. For FLMR retrieval configs, and the WIT
mapping-network pretraining config (`executor.ExecutorClass`
FLMRVisionPretrainingExecutor: vision-only queries): `--mode train`
(the trainer, validation through `run_eval` every `train.val_every` steps,
then `<log_dir>/<experiment_name>/ckpt`), `--mode test` / `eval` (the
checkpoint, an index of the corpus, search, `<split>_metrics.json`,
`<split>_predictions.json` and the prediction table), `--mode serve`
(a RetrievalServer, POST /search) and `prepare_data`. For RAG configs
(`executor.ExecutorClass` RagExecutor): `--mode train` (joint training
of the LoRA and the retriever over live retrieval, validation through
`run_rag_eval` every `train.val_every` steps, then the checkpoint),
`--mode test` / `eval` (the checkpoint, then generation over the split,
`<split>_rag_metrics.json` with exact match and VQA accuracy), `--mode
serve` (a VQAServer over live FLMR retrieval and a T5 or BLIP-2
generator, POST /answer) and `prepare_data`. Examples, on an NVIDIA GPU:

    python -m ravqa_tpu_torch.main --config configs/synthetic_flmr.json \
        --mode train --experiment_name dev --opts train.lr=1e-4
    python -m ravqa_tpu_torch.main --config configs/synthetic_flmr.json \
        --mode eval --experiment_name dev
    python -m ravqa_tpu_torch.main \
        --config configs/synthetic_flmr_base_serve.json --mode serve
    python -m ravqa_tpu_torch.scripts.synthetic_wit
    python -m ravqa_tpu_torch.main \
        --config configs/synthetic_flmr_wit_pretrain.json --mode train
    python -m ravqa_tpu_torch.main \
        --config configs/synthetic_rag_blip2_train.json --mode train
    python -m ravqa_tpu_torch.main \
        --config configs/synthetic_rag_blip2_serve.json --mode serve

FLMR with ROIs (configs/okvqa/flmr_with_roi.json; the VinVL, Oscar and
OCR files from `python -m ravqa_tpu_torch.scripts.extract_vinvl_features`
and `run_captioning`) trains and evaluates the same way:

    python -m ravqa_tpu_torch.scripts.synthetic_okvqa
    python -m ravqa_tpu_torch.main \
        --config configs/synthetic_flmr_roi_train.json --mode train

`--device` chooses where the models, the index and the data pipeline's
ViT live (default "cuda"; pass "cpu" for the plain PyTorch path).
`--use_dummy_data` sets `use_dummy_data` on every node (LoadOKVQAData
keeps 20 items a split).

`--num_devices N` runs the mode over N ranks of a "data" mesh (JAX
main.py:534-540): N spawned processes (parallel.launch), or, under
`torchrun --nproc_per_node N -m ravqa_tpu_torch.main ... --num_devices N`,
torchrun's. Each rank owns a card under NCCL when there are N cards, or
they share the card (or the CPU with --device cpu) under gloo; the first
line of each rank names its backend and device. Training is data
parallel (each rank steps on its slice of every global batch of
train.batch_size, the in-batch negatives spanning the ranks), the corpus
index is sharded over the ranks (each encodes its slice) and searched
collectively, and rank 0 writes the checkpoint, the metrics files and the
predictions. Serving: rank 0 owns the server, the query tower and the
HTTP front; the other ranks search their shards for each dispatch
(serving.MeshSearchFront, serve_shard).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

# load_config is re-exported: callers of the port (chip_smoke.py) load a
# config through this module
from .config import Config, apply_overrides, load_config

def parse_args(argv=None):
    p = argparse.ArgumentParser("ravqa_tpu_torch")
    p.add_argument("--config", required=True)
    p.add_argument("--mode", required=True,
                   choices=["prepare_data", "train", "test", "eval",
                            "serve"])
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--experiment_name", default="default")
    p.add_argument("--log_dir", default="experiments")
    p.add_argument("--opts", nargs="*", default=[])
    p.add_argument("--modules", nargs="*", default=[],
                   help="extra model_config.modules flags (reference "
                        "--modules)")
    p.add_argument("--use_dummy_data", action="store_true",
                   help="truncate the OK-VQA data to 20 items a split")
    p.add_argument("--num_devices", type=int, default=0,
                   help="ranks of the data-parallel mesh (0: one device)")
    p.add_argument("--device", default="cuda",
                   help="torch device for the model and the index")
    return p.parse_args(argv)


def build_pipeline(cfg: Config, cache_dir: Optional[str] = None,
                   device: Optional[str] = None):
    """The config's data pipeline; nodes with `cache` true are kept under
    cache_dir (main() passes <log_dir>/cache, as the JAX package's does).
    `device` reaches the nodes that run a model (ExtractImageFeaturesWithViT)
    as their global_config's "device"."""
    from .data import DataPipeline
    if device is not None:
        cfg = Config({**cfg, "device": str(device)})
    return DataPipeline(cfg.data_pipeline.to_dict(), cache_dir=cache_dir,
                        global_config=cfg)


def _flmr_config_from(mc):
    """model_config dict -> FLMRModelConfig, reading the keys the JAX
    package's does, and `multimodal_docs` / `doc_prefix_len`, which the
    JAX package's leaves unread (ROADMAP.md C16). `vit` is a ViTConfig's
    fields, or {"tiny": true} for ViTConfig.tiny() (its other keys then
    unread). Multimodal docs project the batches' `doc_image_features`;
    a doc batch without them stays text-only."""
    from .models import BertConfig, FLMRModelConfig, ViTConfig
    modules = mc.get("modules", [])
    vit = None
    vit_spec = dict(mc.get("vit", {}))
    if vit_spec:
        vit = ViTConfig.tiny() if vit_spec.pop("tiny", False) \
            else ViTConfig(**vit_spec)
    return FLMRModelConfig(
        bert=BertConfig(**mc.get("bert", {})),
        in_graph_vision=bool(mc.get("in_graph_vision", False)
                             or "in_graph_vision" in modules),
        vit=vit,
        dim=mc.get("dim", 128),
        vision_dim=mc.get("vision_embedding_size", 768),
        prefix_len=mc.get("mapping_network_prefix_length", 32),
        nway=mc.get("num_negative_samples", 1) + 1,
        use_ib_negatives=mc.get("use_ib_negatives", True),
        separate_question_encoder="separate_question_encoder" in modules,
        multimodal_docs=bool(mc.get("multimodal_docs", False)),
        doc_prefix_len=mc.get("doc_prefix_len", 8),
        query_mode=mc.get("query_mode", "text+vision"),
        interaction=mc.get("interaction", "colbert"),
        flipr_query_part_len=mc.get("flipr_query_part_len", 0),
        flipr_k1=mc.get("flipr_k1", 0),
        flipr_k2=mc.get("flipr_k2", 0),
        use_transformer_mapping=mc.get("use_transformer_mapping", False),
        transformer_mapping_num_layers=mc.get(
            "transformer_mapping_num_layers", 1),
        transformer_mapping_hidden=mc.get("transformer_mapping_hidden", 768),
        transformer_mapping_num_heads=mc.get(
            "transformer_mapping_num_heads", 12),
        vision_patch_dim=mc.get("vision_patch_dim"),
        ib_block_n=mc.get("ib_block_n", 0),
        ib_score_bf16=mc.get("ib_score_bf16", False),
    )


def build_executor(cfg: Config, device, log_dir: Optional[str] = None,
                   quiet: bool = True, inference_only: bool = False,
                   mesh=None):
    """FLMR executor with weights drawn from the config's seed (a CPU
    torch.Generator, so one seed gives the same weights on every device)
    and the trainer configured from `train.*`: an FLMRExecutor, or an
    FLMRVisionPretrainingExecutor when `executor.ExecutorClass` names it
    (the WIT recipe). Any other class raises, where the JAX package's
    builds an FLMRExecutor for it (ROADMAP.md C20). inference_only builds
    no optimizer (serving). mesh: data parallelism over its "data" axis
    (train.param_sharding "replicated", the default, or "fsdp", with
    train.fsdp_min_size)."""
    from .executors import (FLMRExecutor, FLMRVisionPretrainingExecutor,
                            TrainConfig)
    from .models import FLMRRetriever
    name = cfg.get("executor", Config()).get("ExecutorClass", "FLMRExecutor")
    classes = {"FLMRExecutor": FLMRExecutor,
               "FLMRVisionPretrainingExecutor": FLMRVisionPretrainingExecutor}
    if name not in classes:
        raise NotImplementedError(
            f"executor {name!r}: main.py builds FLMRExecutor, "
            "FLMRVisionPretrainingExecutor and RagExecutor only (ROADMAP.md "
            "C20; DPRExecutor is a library class in both packages)")
    mc = cfg.model_config
    model = FLMRRetriever(_flmr_config_from(mc))
    model.reset_parameters(
        torch.Generator().manual_seed(cfg.get("seed", 0)))
    tc = cfg.get("train", Config())
    train_cfg = TrainConfig(
        lr=tc.get("lr", 1e-5),
        mapping_lr=tc.get("mapping_network_lr"),
        weight_decay=tc.get("weight_decay", 0.0),
        warmup_steps=tc.get("warmup_steps", 0),
        total_steps=tc.get("total_steps", 10000),
        schedule=tc.get("schedule", "constant"),
        grad_clip=tc.get("grad_clip", 0.0),
        modules=tuple(mc.get("modules", [])),
        accumulate_grad_batches=tc.get("accumulate_grad_batches", 1),
    )
    return classes[name](model, train_cfg, device=device, log_dir=log_dir,
                         seed=cfg.get("seed", 0), quiet=quiet,
                         logger_backends=tuple(tc.get("logger_backends",
                                                      ["jsonl"])),
                         inference_only=inference_only, mesh=mesh,
                         param_sharding=tc.get("param_sharding",
                                               "replicated"),
                         fsdp_min_size=tc.get("fsdp_min_size", 2 ** 18))


def build_rag_executor(cfg: Config, data, device,
                       log_dir: Optional[str] = None, quiet: bool = True,
                       inference_only: bool = False, mesh=None):
    """RAVQA / RAVQA-v2 executor from a config (executor.ExecutorClass
    RagExecutor): the FLMR retriever (weights from a CPU generator of the
    config's seed, as build_executor's), the corpus index encoded on
    `device`, and the `model_config.generator` (type "t5", or "blip2" with
    its vision, qformer and t5 blocks), built on `device` with weights
    drawn there from a generator seeded seed + 1, at the flax
    initializers' scales. `model_config.rag` keys fill RagConfig; the
    module flags use_gt_docs_for_training, ignore_knowledge_passages and
    force_existence, num_knowledge_passages(_in_training) and
    static_retrieval (with index_files.static_results) are read as the
    JAX package's build_rag_executor reads them, and `train.*` (lr,
    retriever_lr, weight_decay, schedule, warmup_steps, total_steps,
    accumulate_grad_batches; the model's module flags) into its
    TrainConfig. inference_only builds no optimizer and no LoRA
    (serving, evaluation). mesh: the index sharded over its "data" axis
    (JAX main.py:181-184) and the training data parallel."""
    from .data import corpus_doc_batches
    from .executors import FLMRExecutor, RagConfig, RagExecutor, TrainConfig
    from .executors.rag_executor import \
        load_static_retrieval_from_predictions
    from .models import FLMRRetriever, T5Config, T5Model
    from .models.blip2 import (Blip2Config, Blip2T5, Blip2VisionConfig,
                               QFormerConfig)

    mc = cfg.model_config
    seed = cfg.get("seed", 0)
    retriever = FLMRRetriever(_flmr_config_from(mc))
    retriever.reset_parameters(torch.Generator().manual_seed(seed))
    gen_cfg = dict(mc.get("generator", {}))
    gen_type = gen_cfg.pop("type", "t5")
    tok = data["tokenizer"]
    gen_cfg.setdefault("vocab_size", tok.vocab_size + 8)
    gen_cfg.setdefault("eos_token_id", tok.sep_token_id)
    # built on the meta device, then given memory and drawn on `device`:
    # a full-width generator never passes through the host
    if gen_type == "blip2":
        # with a "t5" block the flat keys above stay unread, as in JAX
        nqt = gen_cfg.pop("num_query_tokens", 32)
        generator = Blip2T5(Blip2Config(
            vision=Blip2VisionConfig(**gen_cfg.pop("vision", {})),
            qformer=QFormerConfig(**gen_cfg.pop("qformer", {})),
            t5=T5Config(**gen_cfg.pop("t5", gen_cfg)),
            num_query_tokens=nqt), device="meta")
    else:
        generator = T5Model(T5Config(**gen_cfg), device="meta")
    generator = generator.to_empty(device=device)
    generator.reset_parameters(
        torch.Generator(device=device).manual_seed(seed + 1))
    corpus = data["passages"]["full_passages"]
    index = FLMRExecutor(retriever, device=device, inference_only=True,
                         mesh=mesh).build_index(
        corpus_doc_batches(corpus, data["doc_tokenizer"], batch_size=64))
    rag_keys = {f.name for f in dataclasses.fields(RagConfig)}
    rag_kwargs = {k: v for k, v in mc.get("rag", {}).items()
                  if k in rag_keys}
    rag_kwargs["generator_type"] = gen_type
    modules = mc.get("modules", [])
    for flag in ("use_gt_docs_for_training", "ignore_knowledge_passages",
                 "force_existence"):
        if flag in modules:
            rag_kwargs[flag] = True
    if mc.get("num_knowledge_passages_in_training"):
        rag_kwargs["n_docs_in_training"] = \
            mc["num_knowledge_passages_in_training"]
    if mc.get("num_knowledge_passages"):
        rag_kwargs.setdefault("n_docs", mc["num_knowledge_passages"])
    static_map = None
    if "static_retrieval" in modules:
        paths = mc.get("index_files", {}).get("static_results", [])
        if not paths:
            raise ValueError("the static_retrieval module needs "
                             "model_config.index_files.static_results")
        static_map = {}
        for path in paths:
            static_map.update(
                load_static_retrieval_from_predictions(path, corpus.ids))
    tc = cfg.get("train", Config())
    train_cfg = TrainConfig(lr=tc.get("lr", 1e-5),
                            retriever_lr=tc.get("retriever_lr"),
                            weight_decay=tc.get("weight_decay", 0.0),
                            schedule=tc.get("schedule", "constant"),
                            warmup_steps=tc.get("warmup_steps", 0),
                            total_steps=tc.get("total_steps", 1000),
                            modules=tuple(modules),
                            accumulate_grad_batches=tc.get(
                                "accumulate_grad_batches", 1))
    return RagExecutor(retriever, generator, gen_tokenizer=tok,
                       rag_cfg=RagConfig(**rag_kwargs), train_cfg=train_cfg,
                       query_tokenizer=data["query_tokenizer"], index=index,
                       passage_contents=corpus.contents,
                       passage_ids=corpus.ids,
                       static_retrieval=static_map, device=device,
                       log_dir=log_dir, seed=seed, quiet=quiet,
                       inference_only=inference_only, mesh=mesh)


def build_server(cfg: Config, data, device, log_dir: Optional[str] = None,
                 mesh=None):
    """RetrievalServer from a config: encode the corpus into an index on
    `device`, build the searcher, wrap both in the micro-batcher. A RAG
    config gives a VQAServer instead (build_rag_executor; the checkpoint
    loaded, then the LoRA merged once by prepare_for_serving; a BLIP-2
    generator's requests carry pixels of its vision config's image size).
    Loads `train.load_model_path` (a params file or a checkpoint
    directory), else <log_dir>/ckpt/params.msgpack (the JAX package's
    checkpoint) or <log_dir>/ckpt/params.npz, when present.
    `model_config.search_mode` picks exact, two_stage or
    hierarchical search (the pruned modes build summaries with
    `serve.n_summary` and block summaries with `serve.block_size`);
    `serve.*` keys set the micro-batching parameters (batch_buckets among
    them) and the searcher's
    knobs (n_candidates, approx_topk, approx_recall, coarse_int8,
    centroid_prune, coarse_query_len, stage1_kernel, preset). mesh: the
    index sharded over its "data" axis; rank 0 gets the server (its
    searcher a serving.MeshSearchFront), another rank its shard's
    searcher for serving.serve_shard."""
    from .data import corpus_doc_batches
    from .parallel import rank_zero
    from .retrieval import LateInteractionSearcher
    from .serving import (MeshSearchFront, RetrievalServer, ServeConfig,
                          VQAServer)

    sv = cfg.get("serve", Config())
    bb = sv.get("batch_buckets")
    sc = ServeConfig(max_batch=sv.get("max_batch", 32),
                     max_wait_ms=sv.get("max_wait_ms", 2.0),
                     k=sv.get("k", 10),
                     max_queue=sv.get("max_queue", 0),
                     batch_buckets=tuple(bb) if bb else None)
    mc = cfg.model_config
    rag = _is_rag(cfg)
    ex = (build_rag_executor(cfg, data, device, log_dir, inference_only=True,
                             mesh=mesh)
          if rag else build_executor(cfg, device, inference_only=True,
                                     mesh=mesh))
    if not _load_checkpoint(ex, cfg, log_dir):
        print("serve: no checkpoint found (set train.load_model_path) "
              "— serving randomly initialized weights", flush=True)
    if rag:
        ex.prepare_for_serving()
        if mesh is not None:
            if not rank_zero():
                return ex.searcher
            ex.searcher = MeshSearchFront(ex.searcher)
            ex.index = ex.searcher.index
        vis = (ex.model.generator.cfg.vision
               if ex.rag_cfg.generator_type == "blip2" else None)
        server = VQAServer(
            ex, data["query_tokenizer"],
            image_feature_dim=mc.get("vision_embedding_size", 768),
            pixel_shape=(None if vis is None else
                         (vis.image_size, vis.image_size, 3)),
            config=sc)
        server.warm_up()
        return server
    corpus = data["passages"]["full_passages"]
    index = ex.build_index(
        corpus_doc_batches(corpus, data["doc_tokenizer"], batch_size=64))
    mode = mc.get("search_mode", "exact")
    if mode in ("two_stage", "hierarchical"):
        index.build_summaries(n_summary=sv.get("n_summary", 8))
    if mode == "hierarchical":
        index.build_block_summaries(block_size=sv.get("block_size", 64))
    searcher = LateInteractionSearcher(
        index, mesh, "data" if mesh is not None else "index", mode=mode,
        n_candidates=sv.get("n_candidates"),
        approx_topk=sv.get("approx_topk"),
        approx_recall=sv.get("approx_recall", 0.95),
        coarse_int8=sv.get("coarse_int8"),
        centroid_prune=sv.get("centroid_prune"),
        coarse_query_len=sv.get("coarse_query_len"),
        stage1_kernel=sv.get("stage1_kernel"),
        preset=sv.get("preset", "reference"))
    if mesh is not None:
        if not rank_zero():
            return searcher
        searcher = MeshSearchFront(searcher)
    # an in-graph ViT takes raw pixels per request, of the size of the
    # ViT the model was built with
    vit = ex.model.cfg.vit if ex.model.cfg.in_graph_vision else None
    server = RetrievalServer(
        ex, searcher, data["query_tokenizer"],
        image_feature_dim=(0 if vit is not None else
                           mc.get("vision_embedding_size", 768)),
        id2content=dict(enumerate(corpus.contents)),
        pixel_shape=(None if vit is None else
                     (vit.image_size, vit.image_size, 3)),
        config=sc)
    server.warm_up()
    return server


def _is_rag(cfg: Config) -> bool:
    return cfg.get("executor", Config()).get("ExecutorClass") == "RagExecutor"


def _load_checkpoint(ex, cfg, log_dir: Optional[str]) -> bool:
    """Load `train.load_model_path` (a params file or a checkpoint
    directory; raises on a bad path), else <log_dir>/ckpt when it holds a
    params file. Returns whether anything was loaded."""
    from .executors.base import CHECKPOINT_FILES
    explicit = cfg.get("train", Config()).get("load_model_path")
    ckpt = os.path.join(log_dir, "ckpt") if log_dir else None
    if explicit:
        ex.load_checkpoint(explicit)
        return True
    if ckpt and any(os.path.exists(os.path.join(ckpt, f))
                    for f in CHECKPOINT_FILES):
        ex.load_checkpoint(ckpt)
        return True
    return False


def _callbacks_from(cfg, log_dir: str):
    """CheckpointManager / EarlyStopping from the reference's config keys
    (train.model_checkpoint_callback_paras /
    train.early_stopping_callback_paras,
    FLMR_base_preload_vision_features.jsonnet:206-232)."""
    from .executors.callbacks import CheckpointManager, EarlyStopping
    tc = cfg.get("train", Config())

    def default_mode(monitor: str) -> str:
        # Lightning defaults to "min"; recall/accuracy-style monitors (the
        # reference's recall_at_5) to "max"
        up = ("recall", "precision", "accuracy", "success", "mrr", "bleu")
        return "max" if any(t in monitor for t in up) else "min"

    ckpt_manager = None
    mp = tc.get("model_checkpoint_callback_paras")
    if mp:
        monitor = mp.get("monitor", "loss")
        ckpt_manager = CheckpointManager(
            dirpath=mp.get("dirpath", os.path.join(log_dir, "ckpts")),
            monitor=monitor,
            mode=mp.get("mode", default_mode(monitor)),
            save_top_k=mp.get("save_top_k", 1),
            save_last=mp.get("save_last", True))
    early = None
    ep = tc.get("early_stopping_callback_paras")
    if ep:
        monitor = ep.get("monitor", "loss")
        early = EarlyStopping(monitor=monitor,
                              mode=ep.get("mode", default_mode(monitor)),
                              patience=ep.get("patience", 3),
                              min_delta=ep.get("min_delta", 0.0))
    return ckpt_manager, early


def _maybe_prefetch(batches, tc, device):
    """Wrap a batch iterator with the background-thread prefetch and early
    device copies (train.prefetch_batches, default 2; 0 disables)."""
    depth = tc.get("prefetch_batches", 2)
    if not depth:
        return batches
    from .data import prefetch_to_device
    return prefetch_to_device(batches, size=depth, device=device)


def run_eval(cfg, ex, data, log_dir: str, split: str = "valid") -> dict:
    """Index the corpus, search the split's questions, score Recall and
    Precision@K; write <split>_metrics.json, <split>_predictions.json and
    <split>_prediction_table.jsonl under log_dir."""
    from .data import corpus_doc_batches, query_eval_batches
    from .utils.tables import (build_prediction_table, log_prediction_table,
                               save_prediction_table)
    ds = data.get(split) or data["test"]
    corpus = data["passages"]["full_passages"]
    ks = cfg.get("metrics", Config()).get("Ks", [5, 10])
    mc = cfg.model_config
    # the reference's exhaustive_search_in_testing flag forces exact search
    search_mode = mc.get("search_mode", "exact")
    if "exhaustive_search_in_testing" in mc.get("modules", []):
        search_mode = "exact"
    m = ex.evaluate_retrieval(
        query_eval_batches(ds),
        corpus_doc_batches(corpus, ds.dt),
        passage_ids=corpus.ids,
        passage_contents=corpus.contents,
        answers=[it.get("answers", []) for it in ds.items],
        pos_item_ids=[it.get("pos_item_ids", []) for it in ds.items],
        ks=ks,
        search_mode=search_mode,
        search_preset=mc.get("search_preset", "reference"),
        # reference parity (metrics_processors.py:225): the flag drops
        # position 0, where static retrieval files hold a null document
        add_null_document="add_null_document" in mc.get("modules", []))
    metrics = {k: v for k, v in m.items() if not k.startswith("_")}
    ex.logger.log(metrics, ex.step, prefix=f"{split}/")
    from .parallel import rank_zero
    if not rank_zero():
        return metrics              # the ranks' results are the same
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, f"{split}_metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    preds = [{"question_id": it.get("question_id"),
              "top_ranking_passages": [
                  {"passage_id": str(pid),
                   "content": corpus.content_of(pid)}
                  for pid in row]}
             for it, row in zip(ds.items, m["_retrieved_pids"])]
    with open(os.path.join(log_dir, f"{split}_predictions.json"), "w") as f:
        json.dump(preds, f)
    contents = [[corpus.content_of(pid) for pid in row]
                for row in m["_retrieved_pids"]]
    cols, rows = build_prediction_table(ds.items, contents, max(ks))
    save_prediction_table(
        os.path.join(log_dir, f"{split}_prediction_table.jsonl"), cols, rows)
    log_prediction_table(ex.logger, f"{split}/predictions", cols, rows)
    return metrics


def rag_batches(dataset, batch_size: int, seed: int = 0):
    """RAG training batches from a RetrievalDataset, endlessly: each epoch
    a permutation from numpy default_rng(seed), whole batches only;
    question ids, questions, answers, pos_item_ids, query tokens and the
    items' image features and pixels (the JAX main.py's rag_batches)."""
    rng = np.random.default_rng(seed)
    items = dataset.items
    while True:
        order = rng.permutation(len(items))
        for s in range(0, len(order) - batch_size + 1, batch_size):
            yield _rag_batch(dataset, [items[i] for i in
                                       order[s:s + batch_size]])


def rag_eval_batches(dataset, batch_size: int):
    """Evaluation batches in dataset order; the last one is padded by
    repeating its last item, and the pads carry question_id None, so each
    question is counted once (the JAX main.py's rag_eval_batches)."""
    items = dataset.items
    n = len(items)
    for s in range(0, n, batch_size):
        chunk = [items[i] for i in range(s, min(s + batch_size, n))]
        qids = [it["question_id"] for it in chunk]
        while len(chunk) < batch_size:
            chunk.append(chunk[-1])
            qids.append(None)
        batch = _rag_batch(dataset, chunk)
        batch["question_ids"] = qids
        yield batch


def _rag_batch(dataset, chunk) -> dict:
    from .data.datasets import _attach_vision
    parsed = [dataset.parser.parse(it, dataset.input_modules) for it in chunk]
    qi, qm = dataset.qt.tensorize([p["text_sequence"] for p in parsed])
    batch = {"question_ids": [it["question_id"] for it in chunk],
             "questions": [it["question"] for it in chunk],
             "answers": [it["answers"] for it in chunk],
             "pos_item_ids": [it.get("pos_item_ids") for it in chunk],
             "query_input_ids": qi, "query_attention_mask": qm}
    _attach_vision(batch, chunk, parsed)
    return batch


def run_rag_eval(cfg, ex, data, log_dir: str, split: str = "test") -> dict:
    """Generate an answer for each question of the split (batches of
    train.batch_size), score exact match and VQA accuracy, log them under
    `<split>/` and write <split>_rag_metrics.json under log_dir."""
    from .metrics import exact_match, vqa_accuracy
    ds = data.get(split) or data["test"]
    preds, answers = [], []
    bs = cfg.get("train", Config()).get("batch_size", 8)
    for batch in rag_eval_batches(ds, min(bs, len(ds.items))):
        out = ex.generate(batch)
        for qid, p, a in zip(batch["question_ids"], out["predictions"],
                             batch["answers"]):
            if qid is None:                     # the padded tail's repeats
                continue
            preds.append(p)
            answers.append(a)
    if len(preds) != len(ds.items):
        raise AssertionError(f"{len(preds)} predictions for "
                             f"{len(ds.items)} questions")
    metrics = {"exact_match": exact_match(preds, answers),
               "vqa_accuracy": vqa_accuracy(preds, answers)}
    ex.logger.log(metrics, ex.step, prefix=f"{split}/")
    from .parallel import rank_zero
    if not rank_zero():
        return metrics
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, f"{split}_rag_metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    return metrics


def run_rag_train(cfg, args, data, log_dir: str, mesh=None) -> int:
    """Joint RAG training: `train.total_steps` micro-batches of
    `train.batch_size` questions, each retrieved live with the current
    retriever (so no batch is prepared ahead), validating every
    `train.val_every` through run_rag_eval, then <log_dir>/ckpt.
    `train.load_model_path` starts from a checkpoint."""
    tc = cfg.get("train", Config())
    ex = build_rag_executor(cfg, data, args.device, log_dir, quiet=False,
                            mesh=mesh)
    if tc.get("load_model_path"):
        ex.load_checkpoint(tc.get("load_model_path"))
    raw = rag_batches(data["train"], tc.get("batch_size", 8),
                      seed=cfg.get("seed", 0))
    ckpt_manager, early_stopping = _callbacks_from(cfg, log_dir)
    ex.fit((ex.make_train_batch(b) for b in raw),
           steps=tc.get("total_steps", 100),
           log_every=tc.get("log_every", 20),
           val_every=tc.get("val_every"),
           val_fn=(lambda: run_rag_eval(cfg, ex, data, log_dir, "valid"))
           if tc.get("val_every") else None,
           ckpt_manager=ckpt_manager, early_stopping=early_stopping)
    ex.save_checkpoint(os.path.join(log_dir, "ckpt"))
    return 0


def run_rag_test(cfg, args, data, log_dir: str, mesh=None) -> int:
    """Evaluate the checkpoint (train.load_model_path, else <log_dir>/ckpt)
    on the test split (--mode test) or the valid split (--mode eval). The
    JAX package's RAG test mode evaluates the executor as built, without
    the checkpoint (ROADMAP.md C17)."""
    ex = build_rag_executor(cfg, data, args.device, log_dir, quiet=False,
                            inference_only=True, mesh=mesh)
    if not _load_checkpoint(ex, cfg, log_dir):
        print(f"{args.mode}: no checkpoint found — evaluating randomly "
              "initialized weights", flush=True)
    metrics = run_rag_eval(cfg, ex, data, log_dir,
                           "test" if args.mode == "test" else "valid")
    _print_rank0(metrics)
    return 0


def _print_rank0(metrics: dict) -> None:
    from .parallel import rank_zero
    if rank_zero():
        print(json.dumps(metrics, indent=2))


def run_train(cfg, args, data, log_dir: str, mesh=None) -> int:
    """Train `train.total_steps` micro-steps (the remaining ones when
    `train.auto_resume` finds <log_dir>/ckpt), validating every
    `train.val_every`, then save <log_dir>/ckpt."""
    tc = cfg.get("train", Config())
    ex = build_executor(cfg, args.device, log_dir, quiet=False, mesh=mesh)
    explicit = tc.get("load_model_path")
    auto = os.path.join(log_dir, "ckpt")
    steps = tc.get("total_steps", 100)
    if explicit:
        ex.load_checkpoint(explicit)
    elif tc.get("auto_resume") and os.path.exists(
            os.path.join(auto, "params.msgpack")):
        # a restarted job continues from its checkpoint (optimizer and
        # schedule position included) and trains only the remaining steps
        print(f"auto-resuming from {auto}", flush=True)
        ex.load_checkpoint(auto)
        steps = max(steps - ex.step, 0)
    batches = _maybe_prefetch(
        data["train"].loader(batch_size=tc.get("batch_size", 8),
                             shuffle=True, seed=cfg.get("seed", 0)),
        tc, ex.device)
    ckpt_manager, early_stopping = _callbacks_from(cfg, log_dir)
    ex.fit(batches, steps=steps,
           log_every=tc.get("log_every", 20),
           val_every=tc.get("val_every"),
           val_fn=lambda: run_eval(cfg, ex, data, log_dir, "valid"),
           ckpt_manager=ckpt_manager, early_stopping=early_stopping)
    ex.save_checkpoint(auto)
    return 0


def run_test(cfg, args, data, log_dir: str, mesh=None) -> int:
    """Evaluate the checkpoint (train.load_model_path, else <log_dir>/ckpt)
    on the test split (--mode test) or the valid split (--mode eval)."""
    ex = build_executor(cfg, args.device, log_dir, quiet=False,
                        inference_only=True, mesh=mesh)
    if not _load_checkpoint(ex, cfg, log_dir):
        print(f"{args.mode}: no checkpoint found — evaluating randomly "
              "initialized weights", flush=True)
    split = "test" if args.mode == "test" else "valid"
    metrics = run_eval(cfg, ex, data, log_dir, split)
    _print_rank0(metrics)
    return 0


def run_serve(cfg, args, data, log_dir: str, mesh=None) -> int:
    from .parallel import rank_zero
    from .serving import VQAServer, make_http_server, serve_shard
    server = build_server(cfg, data, args.device, log_dir, mesh)
    if mesh is not None and not rank_zero():
        serve_shard(server)          # this rank's searcher, until shutdown
        return 0
    httpd = make_http_server(server, args.host, args.port)
    what = (("VQAServer", "/answer") if isinstance(server, VQAServer)
            else ("RetrievalServer", "/search"))
    print(f"{what[0]} on {args.device} listening on {args.host}:"
          f"{httpd.server_address[1]} (POST {what[1]}, GET /healthz)",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.stop()
        if mesh is not None:            # end the other ranks' loops
            (server.ex if isinstance(server, VQAServer)
             else server).searcher.shutdown()
    return 0


def main(argv=None):
    args = parse_args(argv)
    import torch.distributed as dist
    if args.num_devices and not dist.is_initialized():
        # one process per rank (or torchrun's), each running this main
        import signal
        import sys
        from .parallel import launch
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
        return launch(main, args.num_devices,
                      list(sys.argv[1:] if argv is None else argv),
                      device=args.device, timeout=600.0, join_timeout=None,
                      threads=0)[0]
    cfg = apply_overrides(load_config(args.config), args.opts)
    if args.modules:
        cfg.model_config.modules = list(cfg.model_config.get("modules", [])) \
            + list(args.modules)
    if args.use_dummy_data:
        for node in cfg.data_pipeline.values():
            if isinstance(node, dict) and "setup_kwargs" in node:
                node.setup_kwargs["use_dummy_data"] = True
    mesh = None
    if args.num_devices:
        from .parallel import barrier, local_device, make_mesh
        mesh = make_mesh({"data": args.num_devices})
        args.device = str(local_device())
    log_dir = os.path.join(args.log_dir, args.experiment_name)
    os.makedirs(log_dir, exist_ok=True)

    def get_data():
        return build_pipeline(cfg, os.path.join(log_dir, "cache"),
                              args.device).get_data(
            cfg.data_pipeline_output_node, explode=True)

    cached = any(isinstance(n, dict) and n.get("cache")
                 for n in cfg.data_pipeline.values())
    if mesh is None or not cached:
        data = get_data()
    else:
        # rank 0 fills the pipeline's cache first; the others read it
        rank = dist.get_rank()
        data = get_data() if rank == 0 else None
        barrier()
        data = data if rank == 0 else get_data()
    if args.mode == "prepare_data":
        print("prepare_data done:", list(data))
        return 0
    if args.mode == "serve":
        return run_serve(cfg, args, data, log_dir, mesh)
    if _is_rag(cfg):
        return (run_rag_train if args.mode == "train" else run_rag_test)(
            cfg, args, data, log_dir, mesh)
    if args.mode == "train":
        return run_train(cfg, args, data, log_dir, mesh)
    return run_test(cfg, args, data, log_dir, mesh)


if __name__ == "__main__":
    raise SystemExit(main())
