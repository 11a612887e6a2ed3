"""The port's evaluation and CLI training slice against the JAX package's.

- FLMRExecutor.evaluate_retrieval in exact, two_stage and hierarchical mode
  on configs/synthetic_flmr.json with the JAX executor's parameters: the
  same metric dict and the same retrieved passages as the JAX executor's
  (both packages on their plain routes, on the CPU);
- `main --mode train --device cpu`, then `--mode eval` from the checkpoint
  it wrote: ckpt/, valid_metrics.json, valid_predictions.json and the
  prediction table; the eval reproduces the final validation, and the JAX
  executor on the port's checkpoint reports the same metrics;
- `train.auto_resume` trains only the remaining steps;
- PrepareDataloaders' datasets give the JAX package's collated batches;
- the host copies (metrics, prediction table), encode_corpus's resume_dir
  and the prefetch thread.

Metrics are compared exactly: each is a share of questions or hits, and
the rankings they come from are compared first (the towers agree to 1e-5,
far inside the synthetic corpus' score gaps).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from ravqa_tpu.config import apply_overrides as jax_apply_overrides
from ravqa_tpu.config import load_config as jax_load_config
from ravqa_tpu_torch.config import apply_overrides, load_config
from ravqa_tpu_torch.models import flax_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "synthetic_flmr.json")
# 264 passages so the pruned modes prune: two_stage keeps 24 candidates;
# hierarchical's blocks are of 8 docs (the largest of 64, 32, ... that
# divides 264), of which the reference preset keeps 12 and fast all 33
EVAL_OPTS = ["data_pipeline.raw.setup_kwargs.n_docs=264"]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both packages' pipelines and executors on the same parameters."""
    from ravqa_tpu import main as jax_main
    from ravqa_tpu_torch import main as torch_main
    tmp = tmp_path_factory.mktemp("eval")
    jcfg = jax_apply_overrides(jax_load_config(CONFIG), EVAL_OPTS)
    jdata = jax_main.build_pipeline(jcfg, cache_dir=None).get_data(
        jcfg.data_pipeline_output_node, explode=True)
    jex = jax_main.build_executor(jcfg, jdata, None, str(tmp / "j"),
                                  quiet=True)
    tcfg = apply_overrides(load_config(CONFIG), EVAL_OPTS)
    tdata = torch_main.build_pipeline(tcfg).get_data(
        tcfg.data_pipeline_output_node, explode=True)
    tex = torch_main.build_executor(tcfg, "cpu")
    tex.model.load_state_dict(flax_to_state_dict(
        jax.device_get(jex.state.params)))
    return jdata, jex, tdata, tex


def _evaluate(data, ex, mode, **kw):
    from ravqa_tpu_torch.data import corpus_doc_batches, query_eval_batches
    ds, corpus = data["test"], data["passages"]["full_passages"]
    return ex.evaluate_retrieval(
        query_eval_batches(ds), corpus_doc_batches(corpus, ds.dt),
        passage_ids=corpus.ids, passage_contents=corpus.contents,
        answers=[it["answers"] for it in ds.items],
        pos_item_ids=[it["pos_item_ids"] for it in ds.items],
        ks=(1, 5, 10), search_mode=mode, **kw)


@pytest.mark.parametrize("mode,kw", [
    ("exact", {}),
    ("two_stage", {"n_candidates": 24}),
    ("hierarchical", {"n_candidates": 24}),
    ("hierarchical", {"n_candidates": 24, "search_preset": "fast"})])
def test_evaluate_retrieval_matches_jax(worlds, mode, kw):
    from ravqa_tpu.data.datasets import corpus_doc_batches as jcdb
    from ravqa_tpu.data.datasets import query_eval_batches as jqeb
    jdata, jex, tdata, tex = worlds
    ds, corpus = jdata["test"], jdata["passages"]["full_passages"]
    want = jex.evaluate_retrieval(
        jqeb(ds), jcdb(corpus, ds.dt), passage_ids=corpus.ids,
        passage_contents=corpus.contents,
        answers=[it["answers"] for it in ds.items],
        pos_item_ids=[it["pos_item_ids"] for it in ds.items],
        ks=(1, 5, 10), search_mode=mode, **kw)
    got = _evaluate(tdata, tex, mode, **kw)
    assert [r[:5] for r in got["_retrieved_pids"]] == \
        [r[:5] for r in want["_retrieved_pids"]]
    strip = lambda m: {k: v for k, v in m.items() if not k.startswith("_")}
    assert strip(got) == strip(want)
    assert got["_index"].num_docs == 264
    if mode == "hierarchical":
        assert got["_index"].block_size == 8


def test_train_then_eval_cli(worlds, tmp_path):
    """--mode train on the CPU writes ckpt/ and the validation files; --mode
    eval from the checkpoint reproduces the final validation; the JAX
    executor loads the port's checkpoint and reports the same metrics."""
    from ravqa_tpu import main as jax_main
    from ravqa_tpu_torch.main import main
    log = str(tmp_path)
    common = ["--config", CONFIG, "--device", "cpu", "--log_dir", log,
              "--experiment_name", "run"]
    assert main(common + ["--mode", "train", "--opts", "train.total_steps=6",
                          "train.val_every=3", "train.log_every=2"]) == 0
    exp = os.path.join(log, "run")
    assert sorted(os.listdir(os.path.join(exp, "ckpt"))) == [
        "opt_state.msgpack", "params.msgpack", "rng.msgpack", "step.json"]
    for f in ("valid_metrics.json", "valid_predictions.json",
              "valid_prediction_table.jsonl", "metrics.jsonl"):
        assert os.path.exists(os.path.join(exp, f)), f
    hist = [json.loads(line) for line in open(os.path.join(exp,
                                                           "metrics.jsonl"))]
    assert [h["step"] for h in hist if "train/loss" in h] == [2, 4, 6]
    final = {k[len("valid/"):]: v for h in hist if h["step"] == 6
             for k, v in h.items() if k.startswith("valid/")}
    assert [h["step"] for h in hist if "valid/recall_at_1" in h] == [3, 6]
    assert all(np.isfinite(h["train/loss"]) for h in hist
               if "train/loss" in h)
    os.remove(os.path.join(exp, "valid_metrics.json"))
    assert main(common + ["--mode", "eval"]) == 0
    with open(os.path.join(exp, "valid_metrics.json")) as f:
        got = json.load(f)
    assert got == pytest.approx(final, abs=0)
    preds = json.load(open(os.path.join(exp, "valid_predictions.json")))
    assert len(preds) == 7 and len(preds[0]["top_ranking_passages"]) == 5
    # the JAX executor on the port's checkpoint: the same metrics
    jcfg = jax_load_config(CONFIG)
    jdata = jax_main.build_pipeline(jcfg, cache_dir=None).get_data(
        jcfg.data_pipeline_output_node, explode=True)
    jex = jax_main.build_executor(jcfg, jdata, None, str(tmp_path / "j"),
                                  quiet=True)
    jex.load_checkpoint(os.path.join(exp, "ckpt"))
    assert jax_main.run_eval(jcfg, jex, jdata, str(tmp_path / "j")) == got


def test_auto_resume_trains_the_remaining_steps(tmp_path):
    from ravqa_tpu_torch.main import main
    common = ["--config", CONFIG, "--device", "cpu", "--log_dir",
              str(tmp_path), "--experiment_name", "r", "--mode", "train",
              "--opts", "train.log_every=1", "train.auto_resume=True"]
    assert main(common + ["train.total_steps=3"]) == 0
    assert main(common + ["train.total_steps=5"]) == 0
    assert main(common + ["train.total_steps=5"]) == 0    # nothing left
    exp = os.path.join(tmp_path, "r")
    hist = [json.loads(line) for line in open(os.path.join(exp,
                                                           "metrics.jsonl"))]
    assert [h["step"] for h in hist if "train/loss" in h] == [1, 2, 3, 4, 5]
    with open(os.path.join(exp, "ckpt", "step.json")) as f:
        assert json.load(f)["step"] == 5


def test_prepare_dataloaders_gives_the_jax_batches():
    """Fresh pipelines of both packages (an executor's build draws from the
    train dataset's generator: the JAX one collates an init probe)."""
    from ravqa_tpu import main as jax_main
    from ravqa_tpu.data.datasets import query_eval_batches as jqeb
    from ravqa_tpu_torch import main as torch_main
    from ravqa_tpu_torch.data import RetrievalDataset, query_eval_batches
    jcfg = jax_apply_overrides(jax_load_config(CONFIG), EVAL_OPTS)
    jdata = jax_main.build_pipeline(jcfg, cache_dir=None).get_data(
        jcfg.data_pipeline_output_node, explode=True)
    tcfg = apply_overrides(load_config(CONFIG), EVAL_OPTS)
    tdata = torch_main.build_pipeline(tcfg).get_data(
        tcfg.data_pipeline_output_node, explode=True)
    assert set(tdata) == set(jdata)
    assert isinstance(tdata["valid"], RetrievalDataset)
    assert tdata["valid"].items == tdata["test"].items    # valid <- test
    jl = jdata["train"].loader(batch_size=4, shuffle=True, seed=3)
    tl = tdata["train"].loader(batch_size=4, shuffle=True, seed=3)
    for _ in range(10):                # past the first epoch's 25 items
        jb, tb = next(jl), next(tl)
        assert jb.keys() == tb.keys()
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
    for jb, tb in zip(jqeb(jdata["test"], 4),
                      query_eval_batches(tdata["test"], 4)):
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])


def test_metric_and_table_copies_match_jax():
    from ravqa_tpu.metrics import retrieval_metrics as jm
    from ravqa_tpu.utils import tables as jt
    from ravqa_tpu_torch.metrics import retrieval_metrics as tm
    from ravqa_tpu_torch.utils import tables as tt
    rng = np.random.default_rng(0)
    words = ["cat", "dog", "sky", "sun"]
    contents = [[" ".join(rng.choice(words, 2)) for _ in range(6)]
                for _ in range(5)]
    answers = [list(rng.choice(words, 2)) for _ in range(5)]
    gold = [a[0] for a in answers]
    for null in (False, True):
        assert tm.pseudo_relevance_scores(contents, answers, (1, 3, 5), gold,
                                          null) == \
            jm.pseudo_relevance_scores(contents, answers, (1, 3, 5), gold,
                                       null)
    ids = [list(rng.integers(0, 9, 6)) for _ in range(5)]
    pos = [[int(rng.integers(0, 9))] for _ in range(5)]
    assert tm.positive_id_scores(ids, pos, (1, 5)) == \
        jm.positive_id_scores(ids, pos, (1, 5))
    items = [{"question_id": str(i), "question": "q", "answers": a,
              "img_caption": {"caption": "c"}, "image_id": i}
             for i, a in enumerate(answers)]
    assert tt.build_prediction_table(items, contents, 4) == \
        jt.build_prediction_table(items, contents, 4)


def test_encode_corpus_resumes_from_its_chunks(tmp_path):
    """Chunks land in resume_dir as chunk_{i}.npz (the JAX package's
    files); a restart encodes only the missing ones, and the index equals
    the uninterrupted build's."""
    from ravqa_tpu.retrieval.index import encode_corpus as jax_encode
    from ravqa_tpu_torch.retrieval.index import encode_corpus
    rng = np.random.default_rng(0)
    batches = [{"d": rng.normal(size=(3, 4, 8)).astype(np.float32),
                "m": (rng.random((3, 4)) > 0.3).astype(np.int8)}
               for _ in range(4)]
    calls = []

    def fn(b):
        calls.append(1)
        return torch.from_numpy(b["d"]), torch.from_numpy(b["m"])

    full = encode_corpus(fn, batches, pad_multiple=8, dtype=torch.float32)
    rdir = str(tmp_path / "chunks")
    encode_corpus(fn, batches[:2], pad_multiple=8, dtype=torch.float32,
                  resume_dir=rdir)
    calls.clear()
    got = encode_corpus(fn, batches, pad_multiple=8, dtype=torch.float32,
                        resume_dir=rdir)
    assert len(calls) == 2                      # chunks 0 and 1 were kept
    assert sorted(os.listdir(rdir)) == [f"chunk_{i}.npz" for i in range(4)]
    assert torch.equal(got.tokens, full.tokens)
    assert torch.equal(got.mask, full.mask)
    # the JAX package resumes from the port's chunks without encoding
    jidx = jax_encode(lambda b: 1 / 0, batches, pad_multiple=8,
                      dtype=np.float32, resume_dir=rdir)
    np.testing.assert_array_equal(np.asarray(jidx.tokens),
                                  full.tokens.numpy())


def test_prefetch_keeps_order_raises_and_closes():
    import threading
    from ravqa_tpu_torch.data import prefetch, prefetch_to_device
    assert list(prefetch(iter(range(20)), size=3)) == list(range(20))

    def bad():
        yield 1
        raise KeyError("source failed")
    it = prefetch(bad(), size=2)
    assert next(it) == 1
    with pytest.raises(KeyError, match="source failed"):
        next(it)
    before = threading.active_count()
    it = prefetch_to_device(({"x": np.full((2,), i), "ids": ["a"]}
                             for i in range(1000)), size=2, device="cpu")
    b = next(it)
    assert isinstance(b["x"], torch.Tensor) and b["ids"] == ["a"]
    assert it._ravqa_prefetch_owned
    it.close()
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before
