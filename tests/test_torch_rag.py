"""The port's RAG serving slice against the JAX package's, at tiny width.

Both packages build the same synthetic world (SyntheticOKVQA, 96 passages),
a tiny FLMR retriever, a tiny T5 or BLIP-2 generator with LoRA and the
corpus index; the JAX executor's params tree ({"retriever", "generator":
{"base", "lora"}}) comes into the port through models/convert.py
(RagExecutor.load_params_tree), and the port's index holds the JAX index's
token embeddings. Then the same questions, image features and pixels go to
both `generate`s and both VQAServers.

Tolerance: 1e-4 max abs on doc_scores and log-probs; generated tokens,
selected docs, retrieved passages and answers identical.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravqa_tpu import models as jax_models
from ravqa_tpu.data import DataPipeline as JaxPipeline
from ravqa_tpu.data.datasets import corpus_doc_batches as jax_doc_batches
from ravqa_tpu.executors import FLMRExecutor as JaxFLMRExecutor
from ravqa_tpu.executors import RagConfig as JaxRagConfig
from ravqa_tpu.executors import RagExecutor as JaxRagExecutor
from ravqa_tpu.executors import TrainConfig as JaxTrainConfig
from ravqa_tpu.models import blip2 as jax_blip2
from ravqa_tpu.models import lora as jax_lora
from ravqa_tpu.models import rag as jax_rag
from ravqa_tpu.serving import ServeConfig as JaxServeConfig
from ravqa_tpu.serving import VQAServer as JaxVQAServer
from ravqa_tpu_torch.config import apply_overrides, load_config
from ravqa_tpu_torch.data import DataPipeline
from ravqa_tpu_torch.executors import RagConfig, RagExecutor
from ravqa_tpu_torch.models import (BertConfig, FLMRModelConfig,
                                    FLMRRetriever, T5Config, T5Model,
                                    count_lora_params, flatten_params,
                                    generator_to_state_dict, init_lora,
                                    lora_to_flax, lora_to_torch, merge_lora)
from ravqa_tpu_torch.models.blip2 import (Blip2Config, Blip2T5,
                                          Blip2VisionConfig, QFormerConfig)
from ravqa_tpu_torch.models.rag import (MARKER_REPLACEMENTS,
                                        GeneratorInputBuilder,
                                        select_answers_by_joint_score)
from ravqa_tpu_torch.retrieval import build_index_from_embeddings
from ravqa_tpu_torch.serving import ServeConfig, VQAServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
PIPELINE = {
    "raw": {"transform_name": "SyntheticOKVQA",
            "setup_kwargs": {"n_docs": 96, "n_questions": 12,
                             "vision_dim": 8}},
    "loaders": {"transform_name": "PrepareDataloaders", "input_node": "raw",
                "setup_kwargs": {"query_maxlen": 12, "doc_maxlen": 12,
                                 "nway": 2}},
}
# RagConfig of every case: 3 passages a question, 4 decoded tokens
BASE = dict(n_docs=3, gen_maxlen=32, label_maxlen=4, max_decode_len=4,
            use_lora=True, lora_rank=2)
HIER = dict(search_mode="hierarchical", search_preset="fast",
            n_candidates=8)
# the tiny RAG-BLIP-2 serve config: synthetic_rag_blip2_serve.json cut to
# tiny widths over 64 passages with 32 x 32 images
TINY_BLIP2_OPTS = [
    "data_pipeline.raw.setup_kwargs.n_docs=64",
    "data_pipeline.raw.setup_kwargs.vision_dim=16",
    "data_pipeline.raw.setup_kwargs.emit_pixels=32",
    "data_pipeline.loaders.setup_kwargs.query_maxlen=16",
    "data_pipeline.loaders.setup_kwargs.doc_maxlen=16",
    "model_config.bert={'vocab_size': 512, 'hidden_size': 64, "
    "'num_layers': 2, 'num_heads': 4, 'intermediate_size': 128, "
    "'max_position_embeddings': 64}",
    "model_config.dim=32", "model_config.vision_embedding_size=16",
    "model_config.mapping_network_prefix_length=4",
    "model_config.generator={'type': 'blip2', 'num_query_tokens': 4, "
    "'vision': {'image_size': 32, 'patch_size': 8, 'hidden_size': 32, "
    "'num_layers': 2, 'num_heads': 4, 'intermediate_size': 64}, "
    "'qformer': {'hidden_size': 32, 'num_layers': 2, 'num_heads': 4, "
    "'intermediate_size': 64, 'encoder_hidden_size': 32}, "
    "'t5': {'vocab_size': 512, 'd_model': 64, 'd_kv': 16, 'd_ff': 128, "
    "'num_layers': 2, 'num_heads': 4, 'feed_forward_proj': 'gated-gelu', "
    "'tie_word_embeddings': False}}",
    "model_config.rag.gen_maxlen=24"]
BLIP2_CONFIG = os.path.join(REPO, "configs", "synthetic_rag_blip2_serve.json")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world():
    """Both packages' data, the JAX retriever, T5 and BLIP-2 params and the
    JAX index of the 96 passages."""
    jw = JaxPipeline(PIPELINE).get_data("loaders", explode=True)
    tw = DataPipeline(PIPELINE).get_data("loaders", explode=True)
    vocab = jw["tokenizer"].vocab_size + 8
    eos = jw["tokenizer"].sep_token_id
    rcfg = jax_models.FLMRModelConfig.tiny(
        bert=jax_models.BertConfig.tiny(vocab_size=vocab), vision_dim=8,
        prefix_len=2, dim=16, nway=2)
    retriever = jax_models.FLMRRetriever(rcfg)
    rp = retriever.init(
        jax.random.PRNGKey(0),
        query_input_ids=jnp.ones((2, 12), jnp.int32),
        query_attention_mask=jnp.ones((2, 12), jnp.int32),
        image_features=jnp.ones((2, 8), jnp.float32),
        doc_input_ids=jnp.ones((4, 12), jnp.int32),
        doc_attention_mask=jnp.ones((4, 12), jnp.int32))["params"]
    t5 = jax_models.T5Model(jax_models.T5Config.tiny(
        vocab_size=vocab, eos_token_id=eos, feed_forward_proj="gated-gelu",
        tie_word_embeddings=False))
    t5p = t5.init(jax.random.PRNGKey(1), jnp.ones((2, 8), jnp.int32),
                  jnp.ones((2, 8), jnp.int32),
                  jnp.ones((2, 3), jnp.int32))["params"]
    blip2 = jax_blip2.Blip2T5(jax_blip2.Blip2Config(
        vision=jax_blip2.Blip2VisionConfig.tiny(),
        qformer=jax_blip2.QFormerConfig.tiny(),
        t5=jax_models.T5Config.tiny(vocab_size=vocab, eos_token_id=eos),
        num_query_tokens=2))
    bp = blip2.init(jax.random.PRNGKey(2),
                    jnp.ones((1, 32, 32, 3), jnp.float32),
                    jnp.ones((1, 6), jnp.int32), jnp.ones((1, 6), jnp.int32),
                    jnp.ones((1, 2), jnp.int32))["params"]
    corpus = jw["passages"]["full_passages"]
    fe = JaxFLMRExecutor(retriever, rp, JaxTrainConfig(lr=1e-3), quiet=True)
    jindex = fe.build_index(jax_doc_batches(corpus, jw["doc_tokenizer"],
                                            batch_size=16))
    return dict(jw=jw, tw=tw, vocab=vocab, eos=eos, retriever=retriever,
                rp=rp, gens={"t5": (t5, t5p), "blip2": (blip2, bp)},
                jindex=jindex, corpus=corpus)


def _port_modules(w, kind):
    """The port's retriever and generator of the world's configs (weights
    come with the params tree)."""
    retriever = FLMRRetriever(FLMRModelConfig.tiny(
        bert=BertConfig.tiny(vocab_size=w["vocab"]), vision_dim=8,
        prefix_len=2, dim=16, nway=2))
    if kind == "t5":
        gen = T5Model(T5Config.tiny(vocab_size=w["vocab"],
                                    eos_token_id=w["eos"],
                                    feed_forward_proj="gated-gelu",
                                    tie_word_embeddings=False))
    else:
        gen = Blip2T5(Blip2Config(
            vision=Blip2VisionConfig.tiny(), qformer=QFormerConfig.tiny(),
            t5=T5Config.tiny(vocab_size=w["vocab"], eos_token_id=w["eos"]),
            num_query_tokens=2))
    return retriever, gen


def _port_index(w):
    """The JAX index's tokens and masks as the port's index."""
    j = w["jindex"]
    return build_index_from_embeddings(
        np.array(j.tokens, np.float32)[:j.num_docs],
        np.array(j.mask)[:j.num_docs], pad_multiple=8,
        dtype=torch.float32)


def _static_map(w):
    """question_id -> 2 passages (row, score); question 3 is missing (it
    gets dummy passages)."""
    n = len(w["corpus"])
    return {it["question_id"]: [((7 * int(it["question_id"])) % n, 1.0),
                                ((7 * int(it["question_id"]) + 5) % n, 0.5)]
            for it in w["jw"]["train"].items
            if it["question_id"] != "3"}


def _pair(w, kind, rag, static=None, lora_b_seed=None):
    """The JAX RagExecutor and the port's, on the same weights. With
    lora_b_seed, the JAX executor's LoRA B matrices are drawn nonzero
    first (so the merge changes the generator)."""
    gen, gp = w["gens"][kind]
    rag = dict(BASE, **rag)
    jex = JaxRagExecutor(
        w["retriever"], w["rp"], gen, gp, gen_tokenizer=w["jw"]["tokenizer"],
        rag_cfg=JaxRagConfig(generator_type=kind, **rag),
        train_cfg=JaxTrainConfig(lr=1e-3), index=w["jindex"],
        passage_contents=w["corpus"].contents, static_retrieval=static,
        quiet=True)
    if lora_b_seed is not None:
        rng = np.random.default_rng(lora_b_seed)
        params = jax.device_get(jex.state.params)

        def draw(path, x):
            if path[-1].key == "lora_b":
                return rng.normal(size=x.shape).astype(np.float32) * 0.3
            return x
        params["generator"]["lora"] = jax.tree_util.tree_map_with_path(
            draw, params["generator"]["lora"])
        jex.state = jex.state.replace(params=params)
    retriever, tgen = _port_modules(w, kind)
    tex = RagExecutor(retriever, tgen, w["tw"]["tokenizer"],
                      RagConfig(generator_type=kind, **rag),
                      query_tokenizer=w["tw"]["query_tokenizer"],
                      index=_port_index(w),
                      passage_contents=w["corpus"].contents,
                      static_retrieval=static, device="cpu")
    tex.load_params_tree(jax.device_get(jex.state.params))
    return jex, tex


def _batch(w, idxs, kind):
    items = [w["jw"]["train"].items[i] for i in idxs]
    qi, qm = w["jw"]["query_tokenizer"].tensorize(
        [it["question"] for it in items])
    out = {"question_ids": [it["question_id"] for it in items],
           "questions": [it["question"] for it in items],
           "query_input_ids": np.asarray(qi),
           "query_attention_mask": np.asarray(qm),
           "image_features": np.stack([it["image_features"]
                                       for it in items])}
    if kind == "blip2":
        out["pixel_values"] = np.random.default_rng(len(idxs)).normal(
            size=(len(items), 32, 32, 3)).astype(np.float32)
    return out


def _jax_generate(jex, batch):
    """The JAX executor's generate, with the per-sequence log-probs its
    jitted device step computes (generate itself returns only the pick)."""
    step = jex._generate_device
    seen = {}

    def record(*args):
        out = step(*args)
        seen["seq_lp"] = np.asarray(out[2])
        return out

    jex._generate_device = record
    try:
        out = jex.generate(batch)
    finally:
        jex._generate_device = step
    out["seq_logprobs"] = seen["seq_lp"].reshape(out["doc_scores"].shape)
    return out


def _assert_same(want, got):
    assert got["predictions"] == want["predictions"]
    np.testing.assert_array_equal(got["all_generations"],
                                  np.asarray(want["all_generations"]))
    np.testing.assert_array_equal(got["selected_docs"],
                                  np.asarray(want["selected_docs"]))
    assert got["retrieved_contents"] == want["retrieved_contents"]
    np.testing.assert_allclose(got["doc_scores"], want["doc_scores"],
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(got["seq_logprobs"], want["seq_logprobs"],
                               rtol=0, atol=ATOL)


GENERATE_CASES = {
    "t5-exact-greedy-lora": ("t5", {}, False, 11),
    "t5-hierarchical-fast-beam2": ("t5", dict(HIER, num_beams=2), False,
                                   None),
    "t5-static-beam5": ("t5", dict(num_beams=5), True, None),
    "blip2-exact-beam5-lora": ("blip2", dict(num_beams=5), False, 12),
    "blip2-hierarchical-fast-greedy": ("blip2", HIER, False, None),
    "blip2-static-beam2": ("blip2", dict(num_beams=2), True, 13),
}


@pytest.mark.parametrize("case", sorted(GENERATE_CASES))
def test_generate_matches_jax(world, case):
    """RagExecutor.generate: T5 and BLIP-2; live exact, live hierarchical
    (preset fast) and static retrieval (one question missing from the map:
    dummy passages); greedy and 2 or 5 beams; LoRA B drawn nonzero in three
    cases."""
    kind, rag, static, lora_b = GENERATE_CASES[case]
    jex, tex = _pair(world, kind, rag,
                     _static_map(world) if static else None, lora_b)
    batch = _batch(world, [0, 1, 2, 3], kind)
    if rag.get("search_mode") == "hierarchical":
        assert tex.searcher.mode == jex.searcher.mode == "hierarchical"
        assert tex.searcher.preset == "fast"
    want, got = _jax_generate(jex, batch), tex.generate(batch)
    _assert_same(want, got)
    assert got["doc_scores"].shape == (4, 3)
    if static:
        assert got["retrieved_contents"][3] == ["", "", ""]


def test_prepare_for_serving_leaves_generate_unchanged(world):
    """The LoRA merged in place once (B nonzero): the same output as the
    per-call merge, and as the JAX executor's after its own merge."""
    jex, tex = _pair(world, "blip2", dict(num_beams=2), lora_b_seed=5)
    batch = _batch(world, [4, 5, 6], "blip2")
    before = tex.generate(batch)
    q_weight = tex.model.generator.language_model.decoder[0].cross_attn.q
    w0 = q_weight.weight.detach().clone()
    tex.prepare_for_serving()
    assert tex.lora is None and tex.optimizer is None
    assert not torch.equal(q_weight.weight, w0)
    after = tex.generate(batch)
    jex.prepare_for_serving()
    _assert_same(before, after)
    _assert_same(_jax_generate(jex, batch), after)
    with pytest.raises(RuntimeError, match="inference_only"):
        tex.train_step(batch)


@pytest.mark.parametrize("merged", [False, True])
def test_jax_rag_checkpoint_loads(world, tmp_path, merged):
    """A params.msgpack written by the JAX RagExecutor, in training form
    (base + LoRA, B nonzero) and after prepare_for_serving (merged), loads
    through the port's own msgpack reader into a freshly built executor:
    the same answers. The port's save_checkpoint writes the tree back
    (flax reads it to the JAX params)."""
    from flax import serialization
    jex, _ = _pair(world, "t5", {}, lora_b_seed=7)
    if merged:
        jex.prepare_for_serving()
    jex.save_checkpoint(str(tmp_path / "jax"))
    retriever, gen = _port_modules(world, "t5")
    tex = RagExecutor(retriever, gen, world["tw"]["tokenizer"],
                      RagConfig(**BASE),
                      index=_port_index(world),
                      passage_contents=world["corpus"].contents,
                      device="cpu", seed=3)
    tex.load_checkpoint(str(tmp_path / "jax"))
    assert (tex.lora is None) == merged
    batch = _batch(world, [0, 1], "t5")
    _assert_same(_jax_generate(jex, batch), tex.generate(batch))
    tex.save_checkpoint(str(tmp_path / "port"))
    with open(tmp_path / "port" / "params.msgpack", "rb") as f:
        back = serialization.msgpack_restore(f.read())
    want = flatten_params(jax.device_get(jex.state.params))
    got = flatten_params(back)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=0)


def test_lora_targets_and_merge_match_jax(world):
    """init_lora adapts the same kernels as the JAX executor's targets
    (q and v of every self-attention, q and v of every cross-attention),
    with the same shapes and count; merge_lora with B nonzero equals the
    JAX merged kernels after conversion."""
    from ravqa_tpu_torch.executors.rag_executor import LORA_TARGETS
    gen, gp = world["gens"]["blip2"]
    jl = jax_lora.init_lora(gp, rank=2, targets=LORA_TARGETS,
                            rng=jax.random.PRNGKey(0))
    _, tgen = _port_modules(world, "blip2")
    tgen.load_state_dict(generator_to_state_dict(jax.device_get(gp)))
    tl = init_lora(tgen, rank=2, targets=LORA_TARGETS)
    want_shapes = {k: v.shape for k, v in flatten_params(
        jax.device_get(jl)).items()}
    got_shapes = {k: v.shape for k, v in flatten_params(
        lora_to_flax(tl)).items()}
    assert got_shapes == want_shapes
    assert count_lora_params(tl) == jax_lora.count_lora_params(jl)
    assert len(tl) == 2 * 2 + 2 * 4           # 2 encoder, 2 decoder layers
    rng = np.random.default_rng(0)
    jl = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32),
                      jax.device_get(jl))
    want = generator_to_state_dict(jax.device_get(
        jax_lora.merge_lora(gp, jl, alpha=32.0, rank=2)))
    got = merge_lora(tgen.state_dict(), lora_to_torch(jl), alpha=32.0,
                     rank=2)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=1e-5)
    assert any(not torch.equal(got[k], tgen.state_dict()[k]) for k in tl)


def test_input_builder_and_joint_score_match_jax():
    questions = ["<BOQ>what is <BOC>a cat<EOC> doing?<EOQ>",
                 "<BOV>dog<SOV>tree<EOV> where?"]
    docs = [["passage one ", " two"], ["three", ""]]
    for ignore in (False, True):
        want = jax_rag.GeneratorInputBuilder(ignore_knowledge=ignore,
                                             prefix="p: ")
        got = GeneratorInputBuilder(ignore_knowledge=ignore, prefix="p: ")
        assert got.build(questions, docs) == want.build(questions, docs)
    assert MARKER_REPLACEMENTS == jax_rag.MARKER_REPLACEMENTS
    rng = np.random.default_rng(0)
    scores = rng.normal(size=(6, 5)).astype(np.float32) * 3
    lp = rng.normal(size=(6, 5)).astype(np.float32)
    lp[0] = lp[0, 0]                 # equal log-probs: the first doc wins
    scores[0] = 1.0
    np.testing.assert_array_equal(
        select_answers_by_joint_score(scores, lp),
        jax_rag.select_answers_by_joint_score(scores, lp))
    assert select_answers_by_joint_score(scores, lp)[0] == 0


def test_vqa_server_matches_jax_server(world):
    """The same requests to both VQAServers (T5, live exact retrieval,
    2 beams): the same answers and passages, doc_scores within 1e-4; a
    request without features gets zeros of the server's width."""
    jex, tex = _pair(world, "t5", dict(num_beams=2), lora_b_seed=9)
    items = [world["jw"]["train"].items[i] for i in range(5)]
    reqs = [(it["question"], it["image_features"]) for it in items] + [
        ("cat dog", None)]
    jserver = JaxVQAServer(jex, world["jw"]["query_tokenizer"],
                           image_feature_dim=8,
                           config=JaxServeConfig(max_batch=4,
                                                 max_wait_ms=20.0))
    tserver = VQAServer(tex, world["tw"]["query_tokenizer"],
                        image_feature_dim=8,
                        config=ServeConfig(max_batch=4, max_wait_ms=20.0))
    try:
        jf = [jserver.submit(q, f) for q, f in reqs]
        tf = [tserver.submit(q, f) for q, f in reqs]
        for a, b in zip(jf, tf):
            want, got = a.result(timeout=300), b.result(timeout=300)
            assert got.answer == want.answer
            assert got.passages == want.passages and len(got.passages) == 3
            np.testing.assert_allclose(got.doc_scores, want.doc_scores,
                                       rtol=0, atol=ATOL)
        assert tserver.dispatches >= 2
        alone = tserver.answer_batch([reqs[0][0]], reqs[0][1][None])
        assert alone[0].answer == tf[0].result().answer
        with pytest.raises(ValueError, match="image_features of shape"):
            tserver.submit("cat", np.zeros(5, np.float32))
        with pytest.raises(ValueError, match="takes no pixel_values"):
            tserver.submit("cat", pixel_values=np.zeros((4, 4, 3)))
    finally:
        jserver.stop()
        tserver.stop()


def _tiny_blip2_server():
    from ravqa_tpu_torch.main import build_pipeline, build_server
    cfg = apply_overrides(load_config(BLIP2_CONFIG), TINY_BLIP2_OPTS)
    data = build_pipeline(cfg).get_data(cfg.data_pipeline_output_node,
                                        explode=True)
    return data, build_server(cfg, data, "cpu")


def test_build_server_serves_tiny_rag_blip2_config():
    """main.py's build_server on synthetic_rag_blip2_serve.json cut to tiny
    widths, on the CPU: a VQAServer with the published rag block (5
    passages, 5 beams, 10 decoded tokens), LoRA merged, images of the
    vision config's size; requests with and without an image answered
    through POST /answer as through submit()."""
    import threading
    import urllib.request
    from ravqa_tpu_torch.serving import make_http_server
    data, server = _tiny_blip2_server()
    ex = server.ex
    assert isinstance(server, VQAServer)
    assert ex.rag_cfg.n_docs == 5 and ex.rag_cfg.num_beams == 5
    assert ex.rag_cfg.max_decode_len == 10 and ex.lora is None
    assert ex.rag_cfg.generator_type == "blip2"
    assert server.pixel_shape == (32, 32, 3)
    assert server.image_feature_dim == 16
    assert ex.searcher.mode == "exact"
    httpd = make_http_server(server, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        it = data["train"].items[0]
        feats = np.linspace(-1, 1, 16, dtype=np.float32)
        want = server.submit(it["question"], feats, it["image"]).result(120)
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/answer",
            data=json.dumps({"question": it["question"],
                             "image_features": feats.tolist(),
                             "pixel_values": it["image"].tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            got = json.loads(r.read())
        assert got["answer"] == want.answer
        assert got["passages"] == want.passages and len(want.passages) == 5
        np.testing.assert_allclose(got["doc_scores"], want.doc_scores,
                                   rtol=0, atol=1e-6)
        blank = server.submit("cat dog").result(120)
        assert np.isfinite(blank.doc_scores).all()
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()


def test_static_retrieval_from_predictions_matches_jax(tmp_path):
    """The static map from an FLMR prediction dump: corpus rows by passage
    id, a passage without a score scoring -rank, unknown ids dropped."""
    from ravqa_tpu.executors.rag_executor import \
        load_static_retrieval_from_predictions as jax_load
    from ravqa_tpu_torch.executors import \
        load_static_retrieval_from_predictions
    preds = [{"question_id": 1, "top_ranking_passages": [
                 {"passage_id": "GS_3", "score": 2.5},
                 {"passage_id": "GS_9"}, {"passage_id": "nope"}]},
             {"question_id": "q2", "top_ranking_passages": []}]
    path = tmp_path / "preds.json"
    path.write_text(json.dumps(preds))
    ids = [f"GS_{i}" for i in range(12)]
    got = load_static_retrieval_from_predictions(str(path), ids)
    assert got == jax_load(str(path), ids)
    assert got["1"] == [(3, 2.5), (9, -1.0)] and got["q2"] == []
