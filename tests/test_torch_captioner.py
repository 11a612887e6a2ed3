"""The Oscar captioner of ravqa_tpu_torch against ravqa_tpu on the CPU:
models/captioner.py, the weight bridges (convert_oscar_captioner_params,
models.convert.captioner_to_state_dict) and the captioning script's row
inputs.

One synthetic Oscar state dict (scripts/synthetic_okvqa.py's, tiny widths)
goes through both packages' convert_oscar_captioner_params. Tolerances:
the attention mask exactly; the forward's logits 1e-4 (atol, of logits of
magnitude ~1e-1-1e0); the greedy tokens and lengths identical, and the
decoded strings; the script's inputs exactly.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravqa_tpu.models import bert as jax_bert
from ravqa_tpu.models import captioner as jax_cap
from ravqa_tpu_torch.models import BertConfig, captioner_to_state_dict
from ravqa_tpu_torch.models import captioner
from ravqa_tpu_torch.scripts import run_captioning
from ravqa_tpu_torch.scripts.synthetic_okvqa import \
    synthetic_oscar_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny():
    """Both packages' captioners from one synthetic Oscar state dict, and
    one batch of three: tags and regions partly padded."""
    bert = dict(vocab_size=300)
    cfg = captioner.CaptionerConfig.tiny(bert=BertConfig.tiny(**bert))
    jcfg = jax_cap.CaptionerConfig.tiny(bert=jax_bert.BertConfig.tiny(
        **bert))
    sd = {k: v.numpy() for k, v in synthetic_oscar_state_dict(
        cfg, seed=0).items()}
    # a nonzero LM bias and LayerNorm, so the bridge's every leaf counts
    rng = np.random.default_rng(1)
    sd["cls.predictions.bias"] = rng.normal(size=300).astype(np.float32)
    sd["cls.predictions.transform.LayerNorm.bias"] = rng.normal(
        size=cfg.bert.hidden_size).astype(np.float32) * 0.1
    params = jax.device_get(jax_cap.convert_oscar_captioner_params(sd, jcfg))
    model = captioner.OscarCaptioner(cfg)
    model.load_state_dict(captioner_to_state_dict(params))
    tags = cfg.max_seq_len - cfg.max_seq_a_len
    tag_ids = rng.integers(5, 300, (3, tags)).astype(np.int32)
    tag_mask = np.ones((3, tags), np.int32)
    tag_mask[1, 2:] = 0
    img = rng.normal(size=(3, cfg.max_img_seq_len,
                           cfg.img_feature_dim)).astype(np.float32)
    img_mask = np.ones((3, cfg.max_img_seq_len), np.int32)
    img_mask[2, 3:] = 0
    return dict(cfg=cfg, jcfg=jcfg, sd=sd, params=params,
                model=model.eval(), tag_ids=tag_ids, tag_mask=tag_mask,
                img=img, img_mask=img_mask)


def test_caption_attention_mask_matches_jax(tiny):
    got = captioner.caption_attention_mask(
        tiny["cfg"], torch.from_numpy(tiny["tag_mask"]),
        torch.from_numpy(tiny["img_mask"]))
    want = jax_cap.caption_attention_mask(
        tiny["jcfg"], jnp.asarray(tiny["tag_mask"]),
        jnp.asarray(tiny["img_mask"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_convert_oscar_captioner_params_matches_jax(tiny):
    """The port's convert_oscar_captioner_params equals the JAX package's
    tree carried across by captioner_to_state_dict (the tied decoder has no
    weight in either), and holds every parameter of the port's model."""
    got = captioner.convert_oscar_captioner_params(tiny["sd"], tiny["cfg"])
    want = captioner_to_state_dict(tiny["params"])
    assert set(got) == set(want) == set(tiny["model"].state_dict())
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_forward_matches_jax(tiny):
    """The logits over the whole sequence, with the caption slots masked
    after [CLS], 1e-4."""
    cfg = tiny["cfg"]
    a = cfg.max_seq_a_len
    text = np.concatenate([np.full((3, a), cfg.mask_token_id),
                           tiny["tag_ids"]], -1).astype(np.int32)
    text[:, 0] = cfg.cls_token_id
    text[0, 1:3] = [17, 40]
    segs = np.concatenate([np.zeros((3, a)), np.ones(
        (3, cfg.max_seq_len - a))], -1).astype(np.int32)
    attn = np.array(jax_cap.caption_attention_mask(
        tiny["jcfg"], jnp.asarray(tiny["tag_mask"]),
        jnp.asarray(tiny["img_mask"])))
    want = jax_cap.OscarCaptioner(tiny["jcfg"]).apply(
        {"params": tiny["params"]}, text, segs, tiny["img"], attn)
    with torch.no_grad():
        got = tiny["model"](torch.from_numpy(text).long(),
                            torch.from_numpy(segs).long(),
                            torch.from_numpy(tiny["img"]),
                            torch.from_numpy(attn))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_greedy_caption_matches_jax(tiny):
    """greedy_caption's tokens and lengths identical (the [SEP] forced at
    the last slot, [PAD] after [SEP]), and decode_captions' strings."""
    want_c, want_n = jax.jit(lambda p, *x: jax_cap.greedy_caption(
        jax_cap.OscarCaptioner(tiny["jcfg"]), p, *x))(
        {"params": tiny["params"]}, tiny["tag_ids"], tiny["tag_mask"],
        tiny["img"], tiny["img_mask"])
    got_c, got_n = captioner.greedy_caption(
        tiny["model"], *(torch.from_numpy(tiny[k]) for k in (
            "tag_ids", "tag_mask", "img", "img_mask")))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    vocab = {i: f"w{i}" for i in range(300)}
    vocab.update({0: "[PAD]", 101: "[CLS]", 102: "[SEP]", 7: "##s"})
    assert captioner.decode_captions(got_c.numpy(), got_n.numpy(),
                                     vocab.get) == \
        jax_cap.decode_captions(np.asarray(want_c), np.asarray(want_n),
                                vocab.get)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_run_captioning", os.path.join(REPO, "scripts",
                                           "run_captioning.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_caption_script_inputs_match_jax(tmp_path):
    """The captioning script's TSV reader and region inputs (raw 2,048-d
    features gain the box geometry; at most max_img_seq_len regions) equal
    the JAX script's; write_caption_predictions writes the same JSON."""
    jscript = _jax_script()
    cfg = captioner.CaptionerConfig(max_img_seq_len=4)
    jcfg = jax_cap.CaptionerConfig(max_img_seq_len=4)
    rng = np.random.default_rng(0)
    rows = []
    for key, n, dim in (("000000000001", 6, 2048), ("000000000002", 2, 2054),
                        ("000000000003", 0, 2048)):
        objs = [{"class": f"c{j}", "rect": [1.0 + j, 2.0, 30.0, 40.0 + j],
                 "feature": __import__("base64").b64encode(
                     rng.normal(size=dim).astype(np.float32).tobytes())
                 .decode()} for j in range(n)]
        rows.append(f"{key}\t{json.dumps({'objects': objs})}")
    path = tmp_path / "predictions.tsv"
    path.write_text("\n".join(rows) + "\n")
    got = run_captioning.load_tsv(str(path))
    assert got == jscript.load_tsv(str(path))
    assert run_captioning.load_tsv(str(path), 2) == jscript.load_tsv(
        str(path), 2)
    for _, pred in got:
        g = run_captioning.region_inputs(pred, cfg)
        w = jscript.region_inputs(pred, jcfg)
        for a, b in zip(g[:2], w[:2]):
            np.testing.assert_array_equal(a, b)
        assert g[2] == w[2]
    caps = {"1": "a cat", "2": ["two", "captions"]}
    captioner.write_caption_predictions(str(tmp_path / "p.json"), caps)
    jax_cap.write_caption_predictions(str(tmp_path / "j.json"), caps)
    assert (tmp_path / "p.json").read_text() == \
        (tmp_path / "j.json").read_text()
