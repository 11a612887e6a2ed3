"""CLI entry point of the PyTorch port: config-driven retrieval serving.

Port of ravqa_tpu/main.py for `--mode serve` (and `prepare_data`) on FLMR
retrieval configs. Example, on an NVIDIA GPU:

    python -m ravqa_tpu_torch.main \
        --config configs/synthetic_flmr_base_serve.json --mode serve

`--device` chooses where the model and index live (default "cuda"; pass
"cpu" for the plain PyTorch path). Training, test/eval and RAG configs are
not ported yet (ROADMAP.md, Queue A).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import torch

# load_config is re-exported: callers of the port (chip_smoke.py) load a
# config through this module
from .config import Config, apply_overrides, load_config

_NOT_PORTED = "is not ported yet to ravqa_tpu_torch (see ROADMAP.md, Queue A)"


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
    p.add_argument("--device", default="cuda",
                   help="torch device for the model and the index")
    return p.parse_args(argv)


def build_pipeline(cfg: Config):
    from .data import DataPipeline
    return DataPipeline(cfg.data_pipeline.to_dict())


_UNPORTED_MODEL_KEYS = ("in_graph_vision", "vit", "use_transformer_mapping",
                        "multimodal_docs")


def _flmr_config_from(mc):
    """model_config dict -> FLMRModelConfig; raises on features the port
    does not have yet."""
    from .models import BertConfig, FLMRModelConfig
    modules = mc.get("modules", [])
    for key in _UNPORTED_MODEL_KEYS:
        if mc.get(key) or key in modules:
            raise NotImplementedError(f"model_config.{key} {_NOT_PORTED}")
    if mc.get("query_mode", "text+vision") != "text+vision":
        raise NotImplementedError(
            f"query_mode {mc.get('query_mode')!r} {_NOT_PORTED}")
    if mc.get("interaction", "colbert") != "colbert":
        raise NotImplementedError(
            f"interaction {mc.get('interaction')!r} {_NOT_PORTED}")
    return FLMRModelConfig(
        bert=BertConfig(**mc.get("bert", {})),
        dim=mc.get("dim", 128),
        vision_dim=mc.get("vision_embedding_size", 768),
        prefix_len=mc.get("mapping_network_prefix_length", 32),
        separate_question_encoder="separate_question_encoder" in modules,
    )


def build_executor(cfg: Config, device):
    """FLMR executor with weights drawn from the config's seed."""
    from .executors import FLMRExecutor
    from .models import FLMRRetriever
    cls = cfg.get("executor", Config()).get("ExecutorClass", "FLMRExecutor")
    if cls != "FLMRExecutor":
        raise NotImplementedError(f"executor {cls!r} {_NOT_PORTED}")
    model = FLMRRetriever(_flmr_config_from(cfg.model_config))
    model.reset_parameters(
        torch.Generator().manual_seed(cfg.get("seed", 0)))
    return FLMRExecutor(model, device=device)


def build_server(cfg: Config, data, device, log_dir: Optional[str] = None):
    """RetrievalServer from a config: encode the corpus into an index on
    `device`, build the searcher, wrap both in the micro-batcher.
    Loads `train.load_model_path` (or <log_dir>/ckpt/params.npz) when
    present. `model_config.search_mode` picks exact, two_stage or
    hierarchical search (the pruned modes build summaries with
    `serve.n_summary` and block summaries with `serve.block_size`);
    `serve.*` keys set the micro-batching parameters and the searcher's
    knobs (n_candidates, approx_topk, approx_recall, coarse_int8,
    centroid_prune, coarse_query_len, stage1_kernel, preset)."""
    from .data import corpus_doc_batches
    from .retrieval import LateInteractionSearcher
    from .serving import RetrievalServer, ServeConfig

    sv = cfg.get("serve", Config())
    sc = ServeConfig(max_batch=sv.get("max_batch", 32),
                     max_wait_ms=sv.get("max_wait_ms", 2.0),
                     k=sv.get("k", 10),
                     max_queue=sv.get("max_queue", 0))
    mc = cfg.model_config
    ex = build_executor(cfg, device)
    explicit = cfg.get("train", Config()).get("load_model_path")
    auto = os.path.join(log_dir, "ckpt", "params.npz") if log_dir else None
    if explicit:
        ex.load_checkpoint(explicit)             # raises on a bad path
    elif auto and os.path.exists(auto):
        ex.load_checkpoint(auto)
    else:
        print("serve: no checkpoint found (set train.load_model_path) "
              "— serving randomly initialized weights", flush=True)
    ex.prepare_for_serving()
    corpus = data["passages"]["full_passages"]
    index = ex.build_index(
        corpus_doc_batches(corpus, data["doc_tokenizer"], batch_size=64))
    mode = mc.get("search_mode", "exact")
    if mode in ("two_stage", "hierarchical"):
        index.build_summaries(n_summary=sv.get("n_summary", 8))
    if mode == "hierarchical":
        index.build_block_summaries(block_size=sv.get("block_size", 64))
    searcher = LateInteractionSearcher(
        index, mode=mode,
        n_candidates=sv.get("n_candidates"),
        approx_topk=sv.get("approx_topk"),
        approx_recall=sv.get("approx_recall", 0.95),
        coarse_int8=sv.get("coarse_int8"),
        centroid_prune=sv.get("centroid_prune"),
        coarse_query_len=sv.get("coarse_query_len"),
        stage1_kernel=sv.get("stage1_kernel"),
        preset=sv.get("preset", "reference"))
    server = RetrievalServer(ex, searcher, data["query_tokenizer"],
                             image_feature_dim=mc.get("vision_embedding_size",
                                                      768),
                             id2content=dict(enumerate(corpus.contents)),
                             config=sc)
    server.warm_up()
    return server


def run_serve(cfg, args, data, log_dir: str) -> int:
    from .serving import make_http_server
    server = build_server(cfg, data, args.device, log_dir)
    httpd = make_http_server(server, args.host, args.port)
    print(f"RetrievalServer on {args.device} listening on {args.host}:"
          f"{httpd.server_address[1]} (POST /search, GET /healthz)",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.stop()
    return 0


def main(argv=None):
    args = parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.opts)
    if cfg.get("executor", Config()).get("ExecutorClass") == "RagExecutor":
        raise NotImplementedError(f"RAG serving {_NOT_PORTED}")
    if args.mode in ("train", "test", "eval"):
        raise NotImplementedError(f"--mode {args.mode} {_NOT_PORTED}")
    log_dir = os.path.join(args.log_dir, args.experiment_name)
    data = build_pipeline(cfg).get_data(cfg.data_pipeline_output_node,
                                        explode=True)
    if args.mode == "prepare_data":
        print("prepare_data done:", list(data))
        return 0
    return run_serve(cfg, args, data, log_dir)


if __name__ == "__main__":
    raise SystemExit(main())
