"""Data-parallel training over torch.distributed against the JAX package's
mesh training, on gloo ranks spawned on the CPU (parallel.launch,
tests/_torch_ranks.py):

- an FLMR train step (nway 2 with in-batch negatives across the ranks) on
  2 and 4 ranks, DDP and FSDP, with and without clipping, against the JAX
  executor's step on a "data" mesh of as many devices, on the same global
  batch and carried parameters: the loss and grad norm, every grad (JAX's
  jax.grad of the loss on the global batch, what the mesh step
  differentiates) and the parameters after the update;
- FSDP: each rank holds its share of Adam's moments (JAX
  tests/test_checkpoint_resume.py:133-165), and a checkpoint saved after a
  step resumes into a fresh FSDP executor with the same parameters as the
  uninterrupted run (:168-195), its params.msgpack read by the JAX
  package;
- M2KR multi-task training (train_m2kr) on 2 ranks against the JAX loop on
  a 2-device mesh (tests/test_m2kr.py:78);
- a RAG train step (tiny FLMR with a separate question encoder, tiny T5
  with LoRA, live exact retrieval over an index sharded on the mesh) on 2
  and 4 ranks against the JAX RagExecutor's mesh train_step on the same
  global batch and carried parameters (tests/test_rag_executor.py:181):
  the losses and grad norm, every LoRA and retriever grad (jax.grad of the
  global batch's loss) and the parameters after the update. Each rank's
  loss is its share of the global loss (the NLL and retrieval losses over
  the global counts), so a scaling fault there shows here;
- main.py --num_devices and the dry run: tests/test_torch_ddp_cli.py.

Tolerances, tests/test_torch_train.py's: losses and grad norms rtol 1e-4,
grads rtol 1e-4 and atol 1e-5 of the largest, parameters after an update
within 2 lr (Adam moves every coordinate by about lr, so grads that differ
in their rounding alone part a parameter by up to 2 lr); FSDP's moments
against the replicated step's 1e-6 (JAX :155-161); the RAG step's, those
of tests/test_torch_rag_train.py (its grads within ATOL_GRAD of the
largest of their part of the model).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks
from ravqa_tpu.executors import FLMRExecutor as JaxExecutor
from ravqa_tpu.executors import TrainConfig as JaxTrainConfig
from ravqa_tpu.executors import m2kr as jm2kr
from ravqa_tpu.models import bert as jax_bert
from ravqa_tpu.models import flmr as jflmr
from ravqa_tpu.parallel import make_mesh as jax_make_mesh
from ravqa_tpu_torch.models import FLMRModelConfig, flax_to_state_dict
from ravqa_tpu_torch.parallel import launch

LR = 1e-3


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _global_batch(rng, cfg, b=8, lq=8, ld=10):
    vocab = cfg.bert.vocab_size
    qi = rng.integers(5, vocab, (b, lq)).astype(np.int32)
    qm = np.ones((b, lq), np.int32)
    qm[0, lq - 3:] = 0
    di = rng.integers(5, vocab, (b * cfg.nway, ld)).astype(np.int32)
    dm = np.ones_like(di)
    for r in range(len(di)):
        dm[r, int(rng.integers(2, ld + 1)):] = 0
    return dict(query_input_ids=qi, query_attention_mask=qm,
                image_features=rng.normal(size=(b, cfg.vision_dim)).astype(
                    np.float32),
                doc_input_ids=di * dm, doc_attention_mask=dm)


@pytest.fixture(scope="module")
def flmr_world():
    cfg = FLMRModelConfig.tiny(nway=2, use_ib_negatives=True)
    jcfg = jflmr.FLMRModelConfig(
        bert=jax_bert.BertConfig(**vars(cfg.bert)), dim=cfg.dim,
        vision_dim=cfg.vision_dim, prefix_len=cfg.prefix_len, nway=2,
        use_ib_negatives=True)
    model = jflmr.FLMRRetriever(jcfg)
    rng = np.random.default_rng(0)
    batches = [_global_batch(rng, cfg) for _ in range(3)]
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    params = jax.device_get(model.init(jax.random.PRNGKey(0), **jb)[
        "params"])
    state = {k: v.numpy() for k, v in flax_to_state_dict(params).items()}
    cfg_kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    cfg_kw["bert"] = dataclasses.asdict(cfg.bert)
    return model, params, batches, state, cfg_kw


def _jax_step(model, params, batch, n, grad_clip):
    """The JAX executor's mesh step on the global batch: its metrics and
    parameters after the update, and jax.grad of the same loss."""
    mesh = jax_make_mesh({"data": n}, jax.devices()[:n])
    ex = JaxExecutor(model, params, JaxTrainConfig(lr=LR,
                                                   grad_clip=grad_clip),
                     mesh=mesh, quiet=True)
    m = ex.train_step({k: jnp.asarray(v) for k, v in batch.items()})
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grads = jax.grad(lambda p: model.apply({"params": p}, **jb)["loss"])(
        params)
    return ({k: float(v) for k, v in m.items()},
            flax_to_state_dict(jax.device_get(grads)),
            flax_to_state_dict(jax.device_get(ex.state.params)))


CASES = [(2, "replicated", 0.0), (4, "replicated", 0.0), (2, "fsdp", 0.0),
         (4, "fsdp", 0.0), (4, "replicated", 0.5), (2, "fsdp", 0.5)]


@pytest.mark.parametrize("n,sharding,clip", CASES)
def test_flmr_step_matches_jax_mesh(flmr_world, n, sharding, clip):
    model, params, batches, state, cfg_kw = flmr_world
    want_m, want_g, want_p = _jax_step(model, params, batches[0], n, clip)
    ranks = launch(_torch_ranks.train_rank, n, cfg_kw, state, batches[:1],
                   LR, sharding, 1024, clip, timeout=60, join_timeout=240)
    got = ranks[0]
    for key in ("loss", "nway_loss", "ib_loss", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][0][key], want_m[key],
                                   rtol=1e-4, err_msg=key)
    # the port's grads are the ones the update used: clipped
    norm = want_m["grad_norm"]
    if clip and norm >= clip:
        want_g = {k: g * clip / norm for k, g in want_g.items()}
    scale = max(float(g.abs().max()) for g in want_g.values())
    assert set(got["grads"]) == set(want_g)
    for name, g in want_g.items():
        np.testing.assert_allclose(got["grads"][name], g.numpy(), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)
    for name, p in want_p.items():
        np.testing.assert_allclose(got["params"][name], p.numpy(), rtol=0,
                                   atol=2 * LR, err_msg=name)
    for r in ranks[1:]:                  # every rank took the same step
        for name, p in got["params"].items():
            np.testing.assert_array_equal(r["params"][name], p)
    if sharding == "fsdp":
        assert got["moment_share"] < 1 / n + 0.15, got["moment_share"]


def test_fsdp_matches_replicated_and_resumes(flmr_world, tmp_path):
    """FSDP against DDP over 3 steps on 4 ranks (loss rtol 1e-5 on the
    first, Adam's moments after it within 1e-6, parameters 2 lr a step);
    an FSDP checkpoint after step 1 resumed by a fresh FSDP executor ends
    where the uninterrupted run does, exactly; the JAX package loads its
    params.msgpack."""
    from ravqa_tpu.executors.base import load_params as jax_load_params
    _, params, batches, state, cfg_kw = flmr_world
    run = {s: launch(_torch_ranks.train_rank, 4, cfg_kw, state, batches, LR,
                     s, 1024, timeout=60, join_timeout=240)[0]
           for s in ("replicated", "fsdp")}
    ck = str(tmp_path / "ck")
    resumed = launch(_torch_ranks.train_rank, 4, cfg_kw, state, batches, LR,
                     "fsdp", 1024, 0.0, ck, timeout=60, join_timeout=240)[0]
    rep, fsdp = run["replicated"], run["fsdp"]
    np.testing.assert_allclose(fsdp["metrics"][0]["loss"],
                               rep["metrics"][0]["loss"], rtol=1e-5)
    # Adam's moments are linear and quadratic in the grads: tight; the
    # parameters go through g / (|g| + eps): within 2 lr a step
    for a, b in zip(fsdp["moments_1"], rep["moments_1"]):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-6, err_msg=k)
    for name, p in rep["params_1"].items():
        np.testing.assert_allclose(fsdp["params_1"][name], p, atol=2 * LR,
                                   err_msg=name)
        np.testing.assert_allclose(fsdp["params"][name], rep["params"][name],
                                   atol=3 * 2 * LR, err_msg=name)
        np.testing.assert_array_equal(resumed["params"][name],
                                      fsdp["params"][name])
    assert resumed["resumed_step"] == 1
    loaded = flax_to_state_dict(jax.device_get(jax_load_params(
        params, os.path.join(ck, "params.msgpack"))))
    for name, p in fsdp["params_1"].items():
        np.testing.assert_array_equal(loaded[name].numpy(), p)


def test_m2kr_training_matches_jax_mesh():
    """train_m2kr, 4 steps of 4 questions with an evaluation at step 2
    and 4, on 2 ranks and on the JAX package's 2-device mesh."""
    from ravqa_tpu.data import DataPipeline as JaxPipeline
    from ravqa_tpu.models import FLMRModelConfig as JaxCfg
    from ravqa_tpu.models import FLMRRetriever as JaxFLMR
    sizes = [(s, 16 + 4 * s, 20 + 5 * s) for s in range(3)]
    jworlds = [_torch_ranks.m2kr_world(JaxPipeline, *a) for a in sizes]
    vocab = jworlds[0]["tokenizer"].vocab_size + 8
    jcfg = JaxCfg.tiny(bert=jax_bert.BertConfig.tiny(vocab_size=vocab),
                       vision_dim=8, prefix_len=2, dim=16, nway=2)
    model = JaxFLMR(jcfg)
    params = model.init(
        jax.random.PRNGKey(0),
        query_input_ids=jnp.ones((2, 16), jnp.int32),
        query_attention_mask=jnp.ones((2, 16), jnp.int32),
        image_features=jnp.ones((2, 8), jnp.float32),
        doc_input_ids=jnp.ones((4, 12), jnp.int32),
        doc_attention_mask=jnp.ones((4, 12), jnp.int32))["params"]
    jex = JaxExecutor(model, params, JaxTrainConfig(lr=1e-3),
                      mesh=jax_make_mesh({"data": 2}, jax.devices()[:2]),
                      quiet=True)
    for w in jworlds:
        w["train"].rng = np.random.default_rng(7)
    jt = [jm2kr.M2KRTask(n, w["test"], w["passages"]["full_passages"],
                         ks=(1, 5), train_dataset=w["train"])
          for n, w in zip(_torch_ranks.M2KR_NAMES, jworlds)]
    kw = dict(steps=4, batch_size=4, seed=1, val_every=2, eval_batch_size=8,
              log_every=1, temperature=2.0)
    want = jm2kr.train_m2kr(jex, jt, **kw)
    cfg = FLMRModelConfig.tiny(bert=dataclasses.replace(
        FLMRModelConfig.tiny().bert, vocab_size=vocab), vision_dim=8,
        prefix_len=2, dim=16, nway=2)
    cfg_kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    cfg_kw["bert"] = dataclasses.asdict(cfg.bert)
    state = {k: v.numpy() for k, v in
             flax_to_state_dict(jax.device_get(params)).items()}
    ranks = launch(_torch_ranks.m2kr_rank, 2, cfg_kw, state, sizes, kw,
                   timeout=60, join_timeout=300)
    got = ranks[0]["summary"]
    assert got["per_task_batches"] == want["per_task_batches"]
    jlog = [h for h in jex.logger.history
            if any(k.endswith("/loss") for k in h)]
    tlog = [h for h in ranks[0]["log"]
            if any(k.endswith("/loss") for k in h)]
    assert len(tlog) == len(jlog) == 4
    for t, j in zip(tlog, jlog):
        for k in (k for k in j if k.startswith("train/")):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=k)
    for g, w in zip(got["eval_history"], want["eval_history"]):
        for name in _torch_ranks.M2KR_NAMES:
            for k, v in w[name].items():
                np.testing.assert_allclose(g[name][k], v, rtol=1e-6,
                                           err_msg=f"{name}/{k}")
    assert ranks[1]["log"] == ranks[0]["log"]   # the global metrics


# the published recipe's trainer without accumulation, so the one step
# updates (tests/test_torch_rag_train.py's TRAIN)
RAG_TRAIN = dict(lr=1e-3, retriever_lr=1e-4, weight_decay=0.05,
                 modules=("freeze_question_encoder",))


@pytest.fixture(scope="module")
def rag_world():
    """tests/test_torch_rag_train.py's world: the synthetic data, the JAX
    retriever, its corpus index's tokens, and the JAX T5 with its params."""
    from ravqa_tpu import models as jax_models
    from ravqa_tpu.data import DataPipeline as JaxPipeline
    from ravqa_tpu.data.datasets import corpus_doc_batches
    from test_torch_rag_train import (PIPELINE, _jax_generator,
                                      _jax_retriever_cfg)
    jw = JaxPipeline(PIPELINE).get_data("loaders", explode=True)
    vocab = jw["tokenizer"].vocab_size + 8
    eos = jw["tokenizer"].sep_token_id
    retriever = jax_models.FLMRRetriever(_jax_retriever_cfg(vocab))
    rp = retriever.init(
        jax.random.PRNGKey(0),
        query_input_ids=jnp.ones((2, 12), jnp.int32),
        query_attention_mask=jnp.ones((2, 12), jnp.int32),
        image_features=jnp.ones((2, 8), jnp.float32),
        doc_input_ids=jnp.ones((4, 12), jnp.int32),
        doc_attention_mask=jnp.ones((4, 12), jnp.int32))["params"]
    corpus = jw["passages"]["full_passages"]
    jindex = JaxExecutor(retriever, rp, JaxTrainConfig(lr=1e-3),
                         quiet=True).build_index(
        corpus_doc_batches(corpus, jw["doc_tokenizer"], batch_size=16))
    gen, gp = _jax_generator("t5", vocab, eos)
    return dict(jw=jw, corpus=corpus, vocab=vocab, eos=eos,
                retriever=retriever, rp=rp, gen=gen, gp=gp,
                tokens=np.array(jindex.tokens, np.float32)[:jindex.num_docs],
                mask=np.array(jindex.mask)[:jindex.num_docs],
                pipeline=PIPELINE)


@pytest.mark.parametrize("n", [2, 4])
def test_rag_step_matches_jax_mesh(rag_world, n):
    import optax
    from ravqa_tpu.executors import RagConfig as JaxRagConfig
    from ravqa_tpu.executors import RagExecutor as JaxRagExecutor
    from ravqa_tpu.parallel import trainable_mask as jax_trainable_mask
    from ravqa_tpu.retrieval import build_index_from_embeddings as jax_build
    from test_torch_rag_train import (BASE, _assert_grads_close, _batch,
                                      _jax_grads, _jax_params)
    w = rag_world
    mesh = jax_make_mesh({"data": n}, jax.devices()[:n])
    rag_kw = dict(BASE, generator_type="t5")
    jex = JaxRagExecutor(
        w["retriever"], w["rp"], w["gen"], w["gp"],
        gen_tokenizer=w["jw"]["tokenizer"], rag_cfg=JaxRagConfig(**rag_kw),
        train_cfg=JaxTrainConfig(**RAG_TRAIN), mesh=mesh,
        index=jax_build(w["tokens"], w["mask"], pad_multiple=8,
                        dtype=jnp.float32, mesh=mesh, axis="data"),
        passage_contents=w["corpus"].contents, passage_ids=w["corpus"].ids,
        quiet=True)
    params = jax.device_get(jex.state.params)
    batch = _batch(w, list(range(8)), "t5")
    # one most frequent answer a question: most_frequent breaks a tie by
    # Python's salted set order, which differs between this process and
    # the spawned ranks (tests/test_torch_rag_train.py keeps _batch's ties
    # and compares in one process)
    batch["answers"] = [a[:3] + a[4:] for a in batch["answers"]]
    jbatch = jex.make_train_batch(batch)
    grads = jax.jit(jax.grad(lambda p: jex.loss_fn(p, jbatch, None)[0]))(
        jex.state.params)
    jm = {k: float(v) for k, v in jex.train_step(jbatch).items()}
    # the port's norm counts the trainable grads only (ROADMAP.md C21)
    mask = jax_trainable_mask(jex.state.params, list(RAG_TRAIN["modules"]))
    jm["grad_norm"] = float(optax.global_norm(jax.tree.map(
        lambda g, on: g if on else jnp.zeros_like(g), grads, mask)))
    ranks = launch(_torch_ranks.rag_mesh_rank, n, w["pipeline"], w["vocab"],
                   w["eos"], params, w["tokens"], w["mask"],
                   list(w["corpus"].contents), list(w["corpus"].ids), batch,
                   rag_kw, RAG_TRAIN, timeout=60, join_timeout=300)
    got = ranks[0]
    for key in ("loss", "nll_loss", "rag_loss", "additional_loss",
                "grad_norm"):
        np.testing.assert_allclose(got["metrics"][key], jm[key], rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    want_g = _jax_grads(jex, grads)
    assert set(got["grads"]) < set(want_g)
    _assert_grads_close(got["grads"], want_g, f"{n} ranks")
    lrs = {"lora": RAG_TRAIN["lr"], "retriever": RAG_TRAIN["retriever_lr"]}
    for name, p in _jax_params(jex).items():
        lr = lrs["lora" if name.startswith("lora") else "retriever"]
        np.testing.assert_allclose(got["params"][name], np.asarray(p),
                                   rtol=0, atol=2 * lr, err_msg=name)
    for r in ranks[1:]:                  # every rank took the same step
        for name, p in got["params"].items():
            np.testing.assert_array_equal(r["params"][name], p)
