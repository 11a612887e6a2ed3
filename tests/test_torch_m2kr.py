"""The port's M2KR multi-task training and evaluation against the JAX
package's, on three tiny SyntheticOKVQA worlds with the JAX executor's
parameters carried into the port:

- evaluate_m2kr over two tasks (one with pseudo-relevance scores, one
  without): every task's metrics and "_flat", exactly;
- apply_task_instructions: each dataset's query text and its tokens;
- task_mixture_weights for every sampling rule (rtol 1e-12), and the
  ValueError on an unknown one;
- multitask_loader: 20 draws, the same task names and identical batches;
  its assertion on a task smaller than a batch;
- train_m2kr for 6 steps (instructions on, log_every 1, an evaluation at
  step 3 and 6) against the JAX loop without a mesh: each step's per-task
  losses within rtol 1e-4 (tests/test_torch_train.py's executor
  tolerance), the batch counts and both evaluations' task keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravqa_tpu.data import DataPipeline as JaxPipeline
from ravqa_tpu.executors import FLMRExecutor as JaxExecutor
from ravqa_tpu.executors import TrainConfig as JaxTrainConfig
from ravqa_tpu.executors import m2kr as jm2kr
from ravqa_tpu.models import BertConfig as JaxBertConfig
from ravqa_tpu.models import FLMRModelConfig as JaxFLMRConfig
from ravqa_tpu.models import FLMRRetriever as JaxFLMR
from ravqa_tpu_torch.data import DataPipeline
from ravqa_tpu_torch.executors import FLMRExecutor, TrainConfig
from ravqa_tpu_torch.executors import m2kr
from ravqa_tpu_torch.models import (BertConfig, FLMRModelConfig,
                                    FLMRRetriever, flax_to_state_dict)

NAMES = ("okvqa", "wit", "infoseek")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _world(pipeline, seed, n_docs, n_q):
    return pipeline({
        "raw": {"transform_name": "SyntheticOKVQA",
                "setup_kwargs": {"n_docs": n_docs, "n_questions": n_q,
                                 "vision_dim": 8, "seed": seed}},
        "loaders": {"transform_name": "PrepareDataloaders",
                    "input_node": "raw",
                    "setup_kwargs": {"query_maxlen": 16, "doc_maxlen": 12,
                                     "nway": 2}},
    }).get_data("loaders", explode=True)


def _tasks(mod, worlds, **kw):
    return [mod.M2KRTask(n, w["test"], w["passages"]["full_passages"],
                         ks=(1, 5), train_dataset=w["train"], **kw)
            for n, w in zip(NAMES, worlds)]


@pytest.fixture
def pair():
    """Both packages' worlds and executors on the same parameters."""
    sizes = [(s, 16 + 4 * s, 20 + 5 * s) for s in range(3)]
    jworlds = [_world(JaxPipeline, *a) for a in sizes]
    tworlds = [_world(DataPipeline, *a) for a in sizes]
    vocab = jworlds[0]["tokenizer"].vocab_size + 8
    jcfg = JaxFLMRConfig.tiny(bert=JaxBertConfig.tiny(vocab_size=vocab),
                              vision_dim=8, prefix_len=2, dim=16, nway=2)
    model = JaxFLMR(jcfg)
    params = model.init(
        jax.random.PRNGKey(0),
        query_input_ids=jnp.ones((2, 16), jnp.int32),
        query_attention_mask=jnp.ones((2, 16), jnp.int32),
        image_features=jnp.ones((2, 8), jnp.float32),
        doc_input_ids=jnp.ones((4, 12), jnp.int32),
        doc_attention_mask=jnp.ones((4, 12), jnp.int32))["params"]
    jex = JaxExecutor(model, params, JaxTrainConfig(lr=1e-3), quiet=True)
    tmodel = FLMRRetriever(FLMRModelConfig.tiny(
        bert=BertConfig.tiny(vocab_size=vocab), vision_dim=8, prefix_len=2,
        dim=16, nway=2))
    tmodel.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    tex = FLMRExecutor(tmodel, TrainConfig(lr=1e-3), device="cpu",
                       quiet=True)
    return jworlds, jex, tworlds, tex


def test_evaluate_m2kr_matches_jax(pair):
    jworlds, jex, tworlds, tex = pair
    want = jm2kr.evaluate_m2kr(jex, [
        jm2kr.M2KRTask("okvqa", jworlds[0]["test"],
                       jworlds[0]["passages"]["full_passages"], ks=(1, 5)),
        jm2kr.M2KRTask("wit", jworlds[1]["test"],
                       jworlds[1]["passages"]["full_passages"], ks=(1, 5),
                       use_answers=False)], batch_size=3)
    got = m2kr.evaluate_m2kr(tex, [
        m2kr.M2KRTask("okvqa", tworlds[0]["test"],
                      tworlds[0]["passages"]["full_passages"], ks=(1, 5)),
        m2kr.M2KRTask("wit", tworlds[1]["test"],
                      tworlds[1]["passages"]["full_passages"], ks=(1, 5),
                      use_answers=False)], batch_size=3)
    assert got == want
    assert "recall_at_5" in got["okvqa"] and "recall_at_5" not in got["wit"]
    assert "wit/pos_item_ids_recall_at_5" in got["_flat"]
    assert len(got["_flat"]) == len(got["okvqa"]) + len(got["wit"])


def test_instruction_query_text_and_tokens(pair):
    jworlds, _, tworlds, _ = pair
    jt, tt = _tasks(jm2kr, jworlds), _tasks(m2kr, tworlds)
    assert m2kr.DEFAULT_INSTRUCTIONS == jm2kr.DEFAULT_INSTRUCTIONS
    for question_too in (True, False):
        assert m2kr.instruction_input_modules("x", question_too) == \
            jm2kr.instruction_input_modules("x", question_too)
    jm2kr.apply_task_instructions(jt)
    m2kr.apply_task_instructions(tt)
    for j, t in zip(jt, tt):
        for jd, td in ((j.dataset, t.dataset),
                       (j.train_dataset, t.train_dataset)):
            assert td.input_modules == jd.input_modules
            texts = [td.query_text(it) for it in td.items]
            assert texts == [jd.query_text(it) for it in jd.items]
            assert texts[0].startswith(
                m2kr.DEFAULT_INSTRUCTIONS[t.name].strip())
            for a, b in zip(td.qt.tensorize(texts), jd.qt.tensorize(texts)):
                np.testing.assert_array_equal(a, b)
    # a dataset with its own InstructionInput keeps it
    own = [{"type": "InstructionInput", "option": "default",
            "separation_tokens": {"start": "mine", "end": ""},
            "prompts": ["mine"]}]
    tt[0].dataset.input_modules = own
    m2kr.apply_task_instructions(tt)
    assert tt[0].dataset.input_modules is own


def test_task_mixture_weights_match_jax(pair):
    jworlds, _, tworlds, _ = pair
    jt, tt = _tasks(jm2kr, jworlds), _tasks(m2kr, tworlds)
    for kw in ({"temperature": 1.0}, {"temperature": 4.0},
               {"temperature": 1e9}, {"sampling": "uniform"},
               {"sampling": "ratio", "ratios": {"okvqa": 3.0, "wit": 0.5}}):
        np.testing.assert_allclose(m2kr.task_mixture_weights(tt, **kw),
                                   jm2kr.task_mixture_weights(jt, **kw),
                                   rtol=1e-12, atol=0, err_msg=str(kw))
    with pytest.raises(ValueError):
        m2kr.task_mixture_weights(tt, sampling="nope")


def test_multitask_loader_draws_match_jax(pair):
    jworlds, _, tworlds, _ = pair
    jt, tt = _tasks(jm2kr, jworlds), _tasks(m2kr, tworlds)
    jl = jm2kr.multitask_loader(jt, 4, temperature=2.0, seed=3)
    tl = m2kr.multitask_loader(tt, 4, temperature=2.0, seed=3)
    names = []
    for _ in range(20):
        (jn, jb), (tn, tb) = next(jl), next(tl)
        assert tn == jn
        assert sorted(tb) == sorted(jb)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        names.append(tn)
    assert len(set(names)) == 3
    # the task sequence: default_rng(seed) over the mixture weights
    rng = np.random.default_rng(3)
    p = m2kr.task_mixture_weights(tt, temperature=2.0)
    assert names == [NAMES[int(rng.choice(3, p=p))] for _ in range(20)]
    with pytest.raises(AssertionError, match="batch_size"):
        next(m2kr.multitask_loader(tt, 64))


def test_train_m2kr_matches_jax(pair):
    jworlds, jex, tworlds, tex = pair
    jt, tt = _tasks(jm2kr, jworlds), _tasks(m2kr, tworlds)
    for w in jworlds + tworlds:          # negatives from one seed in both
        w["train"].rng = np.random.default_rng(7)
    kw = dict(steps=6, batch_size=4, seed=1, val_every=3, eval_batch_size=8,
              log_every=1, temperature=2.0)
    want = jm2kr.train_m2kr(jex, jt, **kw)
    got = m2kr.train_m2kr(tex, tt, **kw)
    assert got["per_task_batches"] == want["per_task_batches"]
    assert sum(got["per_task_batches"].values()) == 6
    jlog = [h for h in jex.logger.history if any(
        k.endswith("/loss") for k in h)]
    tlog = [h for h in tex.logger.history if any(
        k.endswith("/loss") for k in h)]
    assert len(tlog) == len(jlog) == 6
    for t, j in zip(tlog, jlog):
        assert t["step"] == j["step"]
        keys = sorted(k for k in j if k.startswith("train/"))
        assert sorted(k for k in t if k.startswith("train/")) == keys
        for k in keys:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=k)
    for name, v in want["per_task_loss"].items():
        np.testing.assert_allclose(got["per_task_loss"][name], v,
                                   rtol=1e-4)
        assert isinstance(got["per_task_loss"][name], float)
    assert len(got["eval_history"]) == 2
    for g, w in zip(got["eval_history"], want["eval_history"]):
        assert sorted(g) == sorted(w)
        for name in NAMES:
            assert sorted(g[name]) == sorted(w[name])
            assert "pos_item_ids_recall_at_5" in g[name]
            assert "recall_at_5" in g[name]
    evals = [h for h in tex.logger.history if "eval/wit/recall_at_1" in h]
    assert [h["step"] for h in evals] == [3, 6]
