"""Tiny widths of the benchmark's cells for the CPU tests: every
configuration and traffic key a run reads, cut so a run takes seconds."""

import copy
import os
import subprocess
import sys
import time

BERT = {"vocab_size": 512, "hidden_size": 64, "num_layers": 2,
        "num_heads": 4, "intermediate_size": 128,
        "max_position_embeddings": 128}
BASE_CFG = {"query_maxlen": 12, "doc_maxlen": 24, "passage_words": [3, 30],
            "index": {"n_docs": 300, "n_topics": 8}}
FLMR = {"cfg": {**BASE_CFG,
                "model_config": {"bert": BERT, "dim": 16,
                                 "vision_embedding_size": 24,
                                 "mapping_network_prefix_length": 4,
                                 "num_negative_samples": 2},
                "train": {"n_questions": 90, "n_passages": 200,
                          "batch_size": 6}},
        "work": {"serve": {"max_batch": 4}, "check": {"sample": 16}},
        "traffic": {"outstanding": 8, "pool": 64, "rate": 150.0,
                    "question_words": [2, 6]}}
PREFLMR = {"cfg": {**BASE_CFG,
                   "model_config": {
                       "bert": BERT, "dim": 16,
                       "vit": {"image_size": 32, "patch_size": 8,
                               "hidden_size": 64, "num_layers": 2,
                               "num_heads": 4, "intermediate_size": 128},
                       "vision_embedding_size": 64, "vision_patch_dim": 64,
                       "mapping_network_prefix_length": 4,
                       "transformer_mapping_hidden": 64,
                       "transformer_mapping_num_heads": 4}},
           "work": {"serve": {"max_batch": 4, "block_size": 16,
                              "n_blocks": 8, "n_candidates": 32},
                    "check": {"sample": 16}},
           "traffic": {"outstanding": 8, "pool": 64, "image_pool": 8,
                       "question_words": [2, 6]}}
TINY = {"flmr_exact_burst": FLMR, "flmr_exact_poisson": FLMR,
        "flmr_train": FLMR, "preflmr_hier_burst": PREFLMR}

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def overrides(cell: str) -> dict:
    return copy.deepcopy(TINY[cell])


def run(cell: str, seed: int = 2 ** 31 + 11, seconds: float = 1.0,
        trace: bool = False) -> dict:
    from portbench.run import run_cell
    return run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter(),
                    overrides=overrides(cell))


def python(code: str, cwd: str, path: list) -> str:
    """Run `code` in a fresh interpreter with `path` first on sys.path;
    its standard output."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(path)}
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout
