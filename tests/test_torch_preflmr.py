"""The port's PreFLMR and in-graph-vision FLMR against the JAX package's,
at tiny width.

Each model is built by both packages' `_flmr_config_from` from one config
in configs/ (with tiny overrides), the JAX parameters from `model.init`
carried into the port through models/convert.py, and both sides get the
same numpy inputs. Tolerances: the transformer mapping and the query and
doc embeddings max abs 1e-5 (float32 on both sides; the reduction orders
differ); the training loss rtol 1e-5 and every grad rtol 1e-4 with atol
1e-5 times the model's largest grad (the attention key biases' grads are
0 in exact arithmetic, rounding alone). The served answers: scores within
rtol 1e-4 and atol 1e-4, pids tie-aware.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravqa_tpu import main as jax_main
from ravqa_tpu.config import apply_overrides as jax_apply_overrides
from ravqa_tpu.config import load_config as jax_load_config
from ravqa_tpu.models import convert_flmr as jax_convert_flmr
from ravqa_tpu.models import flmr as jax_flmr
from ravqa_tpu.models import mapping as jax_mapping
from ravqa_tpu_torch import main as torch_main
from ravqa_tpu_torch.config import apply_overrides, load_config
from ravqa_tpu_torch.executors.base import _num_heads
from ravqa_tpu_torch.models import (FLMRRetriever, TransformerMapping,
                                    flatten_params, flax_to_state_dict,
                                    state_dict_to_flax)
from ravqa_tpu_torch.models import convert_flmr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
PIXELS_OPTS = ["model_config.use_transformer_mapping=True",
               "model_config.transformer_mapping_hidden=32",
               "model_config.transformer_mapping_num_heads=4",
               "model_config.vision_patch_dim=64",
               "model_config.modules=['separate_question_encoder']"]
# each case: (config, overrides, query inputs); "pixels" are (32, 32, 3)
# images, "roi" 2 of them per query, "patches" (4, 16) patch features
QUERY_CASES = {
    "preflmr_patches": ("synthetic_preflmr.json", [], "features+patches"),
    "in_graph_vit": ("synthetic_flmr_pixels.json", [], "pixels"),
    "in_graph_vit_mapping_sqe": ("synthetic_flmr_pixels.json", PIXELS_OPTS,
                                 "pixels"),
    "text_only": ("synthetic_flmr.json", ["model_config.query_mode="
                                          "'text_only'"], "text"),
    "vision_only": ("synthetic_flmr.json", ["model_config.query_mode="
                                            "'vision_only'"], "features"),
    "roi_pixels": ("synthetic_flmr_pixels.json", [], "roi"),
}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _configs(name, opts):
    path = os.path.join(REPO, "configs", name)
    jmc = jax_apply_overrides(jax_load_config(path), opts).model_config
    tmc = apply_overrides(load_config(path), opts).model_config
    return (jax_main._flmr_config_from(jmc),
            torch_main._flmr_config_from(tmc))


def _ids(rng, b, t, vocab, n_valid):
    ids = rng.integers(5, vocab, size=(b, t)).astype(np.int32)
    mask = np.zeros((b, t), np.int32)
    for i, n in enumerate(n_valid):
        mask[i, :n] = 1
        ids[i, n:] = 0
    return ids, mask


def _query_inputs(rng, cfg, kind, b=3):
    qi, qm = _ids(rng, b, 9, cfg.bert.vocab_size, [9, 6, 4][:b])
    out = {"input_ids": qi, "attention_mask": qm}
    if kind in ("features", "features+patches"):
        out["image_features"] = rng.normal(size=(b, cfg.vision_dim)).astype(
            np.float32)
    if kind == "features+patches":
        out["image_patch_features"] = rng.normal(
            size=(b, 4, cfg.vision_patch_dim)).astype(np.float32)
    if kind in ("pixels", "roi"):
        shape = (b,) + ((2,) if kind == "roi" else ()) + (32, 32, 3)
        out["pixel_values"] = rng.uniform(0, 255, shape).astype(np.float32)
    return out


def _carry(jm, tcfg, **init):
    """model.init's params for every method in `init` ({method: kwargs}),
    merged, and the port's model loaded with them."""
    key = jax.random.PRNGKey(3)
    params = {}
    for method, kw in init.items():
        params.update(jm.init(key, **{k: jnp.asarray(v) for k, v in
                                      kw.items()},
                              method=getattr(jax_flmr.FLMRRetriever,
                                             method))["params"])
    tm = FLMRRetriever(tcfg)
    tm.load_state_dict(flax_to_state_dict(jax.device_get(params)),
                       strict=True)
    return params, tm.eval()


@pytest.mark.parametrize("case", sorted(QUERY_CASES))
def test_flmr_query_matches_jax(case):
    name, opts, kind = QUERY_CASES[case]
    jcfg, tcfg = _configs(name, opts)
    rng = np.random.default_rng(0)
    inputs = _query_inputs(rng, tcfg, kind)
    di, dm = _ids(rng, 2, 12, tcfg.bert.vocab_size, [12, 5])
    jm = jax_flmr.FLMRRetriever(jcfg)
    params, tm = _carry(jm, tcfg, query=inputs,
                        doc=dict(input_ids=di, attention_mask=dm))
    want = np.asarray(jm.apply({"params": params}, **{
        k: jnp.asarray(v) for k, v in inputs.items()},
        method=jax_flmr.FLMRRetriever.query))
    with torch.no_grad():
        got = tm.query(**{k: torch.from_numpy(v).long()
                          if k == "input_ids" else torch.from_numpy(v)
                          for k, v in inputs.items()}).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_preflmr_query_lengths():
    """text | mapping | transformer mapping: Lq = 9 + 4 + 16 patches of the
    tiny ViT, and the published widths' 32 + 32 + 256 = 320."""
    _, tcfg = _configs("synthetic_flmr_pixels.json", PIXELS_OPTS)
    inputs = _query_inputs(np.random.default_rng(1), tcfg, "pixels")
    tm = FLMRRetriever(tcfg).eval()
    with torch.no_grad():
        q = tm.query(torch.from_numpy(inputs["input_ids"]).long(),
                     torch.from_numpy(inputs["attention_mask"]),
                     pixel_values=torch.from_numpy(inputs["pixel_values"]))
    assert q.shape == (3, 9 + 2 + 16, tcfg.dim)
    _, full = _configs("synthetic_preflmr_vitl_serve.json", [])
    assert full.vit.num_patches == 256 and full.prefix_len == 32
    assert full.bert.hidden_size == 768 and full.vit.num_layers == 24


def test_multimodal_docs_match_jax():
    """Doc text tokens | doc_prefix_len projected doc-image tokens, the
    image tokens unmasked. The port reads the two keys from the config;
    the JAX package's config leaves them unread (ROADMAP.md C16)."""
    jcfg, tcfg = _configs("synthetic_flmr.json", [
        "model_config.multimodal_docs=True", "model_config.doc_prefix_len=3"])
    assert tcfg.multimodal_docs and tcfg.doc_prefix_len == 3
    assert not jcfg.multimodal_docs
    jcfg = dataclasses.replace(jcfg, multimodal_docs=True, doc_prefix_len=3)
    rng = np.random.default_rng(2)
    di, dm = _ids(rng, 4, 10, tcfg.bert.vocab_size, [10, 7, 3, 1])
    feats = rng.normal(size=(4, tcfg.vision_dim)).astype(np.float32)
    jm = jax_flmr.FLMRRetriever(jcfg)
    doc = dict(input_ids=di, attention_mask=dm, doc_image_features=feats)
    params, tm = _carry(jm, tcfg, doc=doc,
                        query=_query_inputs(rng, tcfg, "features"))
    want_d, want_m = jm.apply({"params": params}, jnp.asarray(di),
                              jnp.asarray(dm),
                              doc_image_features=jnp.asarray(feats),
                              method=jax_flmr.FLMRRetriever.doc)
    with torch.no_grad():
        got_d, got_m = tm.doc(torch.from_numpy(di).long(),
                              torch.from_numpy(dm),
                              doc_image_features=torch.from_numpy(feats))
    assert got_d.shape == (4, 10 + 3, tcfg.dim)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=0,
                               atol=ATOL)


def test_transformer_mapping_matches_jax():
    rng = np.random.default_rng(4)
    patches = rng.normal(size=(3, 5, 24)).astype(np.float32)
    text = rng.normal(size=(3, 7, 48)).astype(np.float32)
    mask = np.ones((3, 7), np.int32)
    mask[1, 4:] = 0
    mask[2, 1:] = 0
    jm = jax_mapping.TransformerMapping(vision_dim=24, hidden_size=32,
                                        lm_dim=16, num_layers=2, num_heads=4,
                                        intermediate_size=128)
    args = (jnp.asarray(patches), jnp.asarray(text), jnp.asarray(mask))
    params = jm.init(jax.random.PRNGKey(4), *args)["params"]
    want = np.asarray(jm.apply({"params": params}, *args))
    tm = TransformerMapping(24, 48, hidden_size=32, lm_dim=16, num_layers=2,
                            num_heads=4, intermediate_size=128)
    tm.load_state_dict(flax_to_state_dict(jax.device_get(params)),
                       strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(patches), torch.from_numpy(text),
                 torch.from_numpy(mask)).numpy()
    assert got.shape == (3, 5, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _batch(rng, cfg, b, lq, ld):
    vocab = cfg.bert.vocab_size
    qi, qm = _ids(rng, b, lq, vocab, [lq] * (b - 1) + [lq - 3])
    di, dm = _ids(rng, b * cfg.nway, ld, vocab,
                  rng.integers(2, ld + 1, b * cfg.nway))
    return dict(query_input_ids=qi, query_attention_mask=qm,
                image_features=rng.normal(size=(b, cfg.vision_dim)).astype(
                    np.float32),
                image_patch_features=rng.normal(
                    size=(b, 4, cfg.vision_patch_dim)).astype(np.float32),
                doc_input_ids=di, doc_attention_mask=dm)


def test_preflmr_forward_loss_and_grads_match_jax():
    """configs/synthetic_preflmr.json: FLIPR over text | mapping |
    transformer-mapping tokens, in-batch negatives; the loss and every
    parameter's grad, the transformer mapping's included."""
    jcfg, tcfg = _configs("synthetic_preflmr.json", [])
    assert tcfg.interaction == "flipr" and tcfg.use_transformer_mapping
    batch = _batch(np.random.default_rng(5), tcfg, 3, 16, 10)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = jax_flmr.FLMRRetriever(jcfg)
    params = jm.init(jax.random.PRNGKey(5), **jb)["params"]

    def jloss(p):
        out = jm.apply({"params": p}, **jb)
        return out["loss"], out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    tm = FLMRRetriever(tcfg)
    tm.load_state_dict(flax_to_state_dict(jax.device_get(params)),
                       strict=True)
    out = tm(**{k: torch.from_numpy(v).long() if k.endswith("input_ids")
                else torch.from_numpy(v) for k, v in batch.items()})
    out["loss"].backward()
    for key in ("loss", "ib_loss", "scores"):
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(jout[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    want = flax_to_state_dict(jax.device_get(jgrads))
    names = dict(tm.named_parameters())
    assert set(want) == set(names)
    assert any(k.startswith("transformer_mapping.layers.0.cross_attention")
               for k in want)
    scale = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        got = names[name].grad
        got = torch.zeros_like(g) if got is None else got
        np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)


def test_flax_round_trip_is_byte_equal():
    """Every new subtree (the ViT's patch embedding, class and position
    embeddings, pre/post LayerNorms and pre-LN layers; the transformer
    mapping's input/output linears and cross-attention; the doc vision
    projection) goes flax -> port -> flax unchanged, with the ViT's and
    the mapping's own head counts."""
    jcfg, tcfg = _configs("synthetic_flmr_pixels.json", PIXELS_OPTS + [
        "model_config.transformer_mapping_num_heads=2"])
    jcfg = dataclasses.replace(jcfg, multimodal_docs=True)
    tcfg = dataclasses.replace(tcfg, multimodal_docs=True)
    rng = np.random.default_rng(6)
    inputs = _query_inputs(rng, tcfg, "pixels")
    di, dm = _ids(rng, 2, 12, tcfg.bert.vocab_size, [12, 5])
    feats = rng.normal(size=(2, tcfg.vision_dim)).astype(np.float32)
    params, tm = _carry(jax_flmr.FLMRRetriever(jcfg), tcfg, query=inputs,
                        doc=dict(input_ids=di, attention_mask=dm,
                                 doc_image_features=feats))
    heads = _num_heads(tm)
    assert heads == {"doc_encoder": 4, "query_encoder": 4,
                     "transformer_mapping": 2, "vision_model": 4}
    back = flatten_params(state_dict_to_flax(tm.state_dict(), heads))
    want = flatten_params(jax.device_get(params))
    assert set(back) == set(want)
    for top in ("vision_model/class_embedding",
                "vision_model/patch_embedding/kernel",
                "transformer_mapping/layer_0/cross_attention/key/kernel",
                "transformer_mapping/input_linear/kernel",
                "doc_vision_projection/mlp/dense_0/kernel"):
        assert top in want
    for k, v in want.items():
        assert back[k].shape == v.shape and back[k].dtype == v.dtype, k
        assert back[k].tobytes() == np.asarray(v).tobytes(), k


# ---------------------------------------------------------------------------
# HF key mappings (convert_flmr)
# ---------------------------------------------------------------------------

def _tiny_params(separate=True):
    jcfg, tcfg = _configs("synthetic_preflmr.json", [
        "model_config.modules=['separate_question_encoder']"] if separate
        else [])
    batch = _batch(np.random.default_rng(7), tcfg, 2, 16, 10)
    params = jax_flmr.FLMRRetriever(jcfg).init(
        jax.random.PRNGKey(7),
        **{k: jnp.asarray(v) for k, v in batch.items()})["params"]
    return jcfg, tcfg, jax.device_get(params)


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   msg=k)


def test_convert_hf_flmr_matches_jax(tmp_path):
    """The FLMR interchange layout (the JAX package's export writes it):
    both packages' convert_hf_flmr_params give the same weights, and the
    port's export writes the files the JAX package's does."""
    jcfg, tcfg, params = _tiny_params()
    jax_convert_flmr.export_flmr_to_hf_format(params, jcfg,
                                              str(tmp_path / "jax"))

    def load(d, f):
        return torch.load(tmp_path / d / f, weights_only=True)

    sd, vp = load("jax", "pytorch_model.bin"), load(
        "jax", "vision_projection.pt")
    qsd = load("jax", "query_encoder_pytorch_model.bin")
    got = convert_flmr.convert_hf_flmr_params(
        sd, tcfg, vision_projection_sd=vp, query_encoder_sd=qsd,
        doc_vision_projection_sd=vp)
    want = flax_to_state_dict(jax_convert_flmr.convert_hf_flmr_params(
        {k: v.numpy() for k, v in sd.items()}, jcfg,
        vision_projection_sd={k: v.numpy() for k, v in vp.items()},
        query_encoder_sd={k: v.numpy() for k, v in qsd.items()},
        doc_vision_projection_sd={k: v.numpy() for k, v in vp.items()}))
    _assert_same(got, want)
    # the port's export of the same weights: the same three files
    convert_flmr.export_flmr_to_hf_format(flax_to_state_dict(params), tcfg,
                                          str(tmp_path / "torch"))
    for f in ("pytorch_model.bin", "vision_projection.pt",
              "query_encoder_pytorch_model.bin"):
        _assert_same(load("torch", f), load("jax", f))


def test_convert_preflmr_matches_jax():
    """A synthetic state dict in the PreFLMR release's layout
    (FLMRModelForRetrieval), made from random weights by renaming the
    interchange layout and the JAX package's transformer-mapping export:
    both packages' convert_preflmr_params give the same weights."""
    import tempfile
    jcfg, tcfg, params = _tiny_params()
    with tempfile.TemporaryDirectory() as d:
        jax_convert_flmr.export_flmr_to_hf_format(params, jcfg, d)
        sd = torch.load(os.path.join(d, "pytorch_model.bin"),
                        weights_only=True)
        vp = torch.load(os.path.join(d, "vision_projection.pt"),
                        weights_only=True)
        qsd = torch.load(os.path.join(d, "query_encoder_pytorch_model.bin"),
                         weights_only=True)
    hf = {}
    for k, v in sd.items():
        hf[k.replace("bert.", "context_text_encoder.bert_model.", 1)
           if k.startswith("bert.") else "context_text_encoder_linear."
           + k.split(".")[-1]] = v.numpy()
    for k, v in qsd.items():
        hf[k.replace("bert.", "query_text_encoder.bert_model.", 1)] = \
            v.numpy()
    for k, v in vp.items():
        hf["vision_projection." + k] = v.numpy()
    jtm = jax_convert_flmr.export_transformer_mapping_params(
        params["transformer_mapping"], jcfg.transformer_mapping_num_heads)
    hf.update(jtm)
    got = convert_flmr.convert_preflmr_params(hf, tcfg)
    want = flax_to_state_dict(jax_convert_flmr.convert_preflmr_params(
        hf, jcfg))
    _assert_same(got, want)
    assert "transformer_mapping.layers.0.cross_attention.key.weight" in got
    # the mapping's export, both ways
    sub = {k[len("transformer_mapping."):]: v for k, v in got.items()
           if k.startswith("transformer_mapping.")}
    exported = convert_flmr.export_transformer_mapping_params(sub)
    _assert_same(exported, {k: torch.tensor(v) for k, v in jtm.items()})
    tm = FLMRRetriever(tcfg)
    tm.load_state_dict(got, strict=True)


# ---------------------------------------------------------------------------
# serving: both packages' build_server on the PreFLMR ViT-L configs
# ---------------------------------------------------------------------------

# the published configs cut to tiny widths: BERT, ViT, the mapping and
# 512 passages; Lq = 16 text + 4 mapping + 16 patch tokens. The `vit`
# spec names the tiny ViT's image size too: both packages build
# ViTConfig.tiny() from it, but the JAX server sizes its blank and padding
# images from the raw dict (224 without the key; ROADMAP C14)
TINY_OPTS = [
    "data_pipeline.raw.setup_kwargs.n_docs=512",
    "data_pipeline.raw.setup_kwargs.vision_dim=16",
    "data_pipeline.raw.setup_kwargs.emit_pixels=32",
    "data_pipeline.loaders.setup_kwargs.query_maxlen=16",
    "data_pipeline.loaders.setup_kwargs.doc_maxlen=16",
    "model_config.bert={'vocab_size': 512, 'hidden_size': 64, "
    "'num_layers': 2, 'num_heads': 4, 'intermediate_size': 128, "
    "'max_position_embeddings': 64}",
    "model_config.dim=32",
    "model_config.vit={'tiny': True, 'image_size': 32}",
    "model_config.vision_embedding_size=64",
    "model_config.vision_patch_dim=64",
    "model_config.mapping_network_prefix_length=4",
    "model_config.transformer_mapping_hidden=32",
    "model_config.transformer_mapping_num_heads=4",
]
# hierarchical: 64 blocks of 8, stage 0 keeps 32, stage 1 keeps 24 docs
HIER_TINY_OPTS = TINY_OPTS + ["serve.block_size=8", "serve.n_summary=4",
                              "serve.n_candidates=24"]
SERVE_CASES = {"exact": ("synthetic_preflmr_vitl_serve.json", TINY_OPTS),
               "hierarchical": ("synthetic_preflmr_vitl_serve_hier.json",
                                HIER_TINY_OPTS)}


@pytest.fixture(scope="module", params=sorted(SERVE_CASES))
def preflmr_servers(request, tmp_path_factory):
    name, opts = SERVE_CASES[request.param]
    path = os.path.join(REPO, "configs", name)
    tmp = tmp_path_factory.mktemp("preflmr_" + request.param)
    cfg = jax_apply_overrides(jax_load_config(path), opts)
    jdata = jax_main.build_pipeline(cfg, cache_dir=None).get_data(
        cfg.data_pipeline_output_node, explode=True)
    jserver = jax_main.build_server(cfg, jdata, None, str(tmp / "jax"))
    params = tmp / "params.npz"
    np.savez(params, **flatten_params(
        jax.device_get(jserver.ex.state.params)))
    tcfg = apply_overrides(load_config(path), opts + [
        f"train.load_model_path={params}"])
    tdata = torch_main.build_pipeline(tcfg).get_data(
        tcfg.data_pipeline_output_node, explode=True)
    tserver = torch_main.build_server(tcfg, tdata, "cpu", str(tmp / "torch"))
    yield request.param, jserver, tserver, jdata["train"].items[:8]
    jserver.stop()
    tserver.stop()


def test_preflmr_served_answers_match_jax(preflmr_servers):
    """The same questions and seeded 32 x 32 images, and one request
    without an image (a blank one of the ViT's size), give the same pids
    and scores from both servers."""
    mode, jserver, tserver, items = preflmr_servers
    assert tserver.searcher.mode == jserver.searcher.mode == mode
    assert tserver.pixel_shape == jserver.pixel_shape == (32, 32, 3)
    assert tserver.image_feature_dim == jserver.image_feature_dim == 0
    assert "image" in items[0] and "image_features" not in items[0]
    reqs = [(it["question"], it["image"]) for it in items] + [
        ("cat dog", None)]
    jfuts = [jserver.submit(t, pixel_values=px) for t, px in reqs]
    tfuts = [tserver.submit(t, pixel_values=px) for t, px in reqs]
    tol = dict(rtol=1e-4, atol=1e-4)
    for jf, tf in zip(jfuts, tfuts):
        j, t = jf.result(timeout=300), tf.result(timeout=300)
        assert t.pids.shape == t.scores.shape == (10,)
        assert np.isfinite(t.scores).all()
        np.testing.assert_allclose(t.scores, j.scores, **tol)
        margin = tol["atol"] + tol["rtol"] * abs(j.scores[-1])
        assert set(j.pids[j.scores > j.scores[-1] + margin]) <= set(t.pids)
        assert set(t.pids[t.scores > t.scores[-1] + margin]) <= set(j.pids)
    ids, mask = tserver.qt.tensorize(["cat"])
    q = tserver.encode([(ids[0], mask[0], None, items[0]["image"])])
    assert q.shape == (1, 16 + 4 + 16, 32)


def test_preflmr_http_takes_pixels(preflmr_servers):
    """POST /search with a "pixel_values" image (H x W x 3 nested lists)
    answers as submit() does; without one the server's blank image of the
    ViT's size."""
    import json
    import threading
    import urllib.error
    import urllib.request
    from ravqa_tpu_torch.serving import make_http_server
    _, _, tserver, items = preflmr_servers
    httpd = make_http_server(tserver, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    def post(obj):
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/search",
            data=json.dumps(obj).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    try:
        img = items[0]["image"]
        got = post({"query": items[0]["question"],
                    "pixel_values": img.tolist()})
        want = tserver.submit(items[0]["question"],
                              pixel_values=img).result(120)
        assert got["pids"] == want.pids.tolist()
        blank = post({"query": "cat dog"})
        want = tserver.submit("cat dog").result(120)
        assert blank["pids"] == want.pids.tolist()
        with pytest.raises(urllib.error.HTTPError) as e:
            post({"query": "cat", "pixel_values": img[:16].tolist()})
        assert e.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_preflmr_bad_image_is_refused_alone(preflmr_servers):
    """An image of another shape, or image features sent to the in-graph
    ViT's server, are refused at submit() on the caller's thread; the good
    requests around them are served as they are alone."""
    _, _, tserver, items = preflmr_servers
    good = tserver.submit(items[0]["question"], pixel_values=items[0]["image"])
    with pytest.raises(ValueError, match="pixel_values of shape"):
        tserver.submit("cat", pixel_values=items[1]["image"][:16])
    with pytest.raises(ValueError, match="takes no image_features"):
        tserver.submit("cat", image_features=np.zeros(64, np.float32))
    also = tserver.submit(items[1]["question"], pixel_values=items[1]["image"])
    for fut, it in ((good, items[0]), (also, items[1])):
        got = fut.result(timeout=120)
        alone = tserver.submit(it["question"],
                               pixel_values=it["image"]).result(120)
        assert got.pids.shape == (10,) and np.isfinite(got.scores).all()
        np.testing.assert_allclose(got.scores, alone.scores, rtol=1e-5,
                                   atol=1e-5)
