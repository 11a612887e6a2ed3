"""The port's DPR dual encoder and executor against the JAX package's, at
the tiny BERT width, on the JAX parameters carried into the port:

- DPRRetriever's loss, scores and pooled embeddings (rtol 1e-5, atol
  1e-6: tests/test_torch_models.py's tower tolerance) and its grads (rtol
  1e-4, atol 1e-5 of the largest: tests/test_torch_train.py's);
- models.convert both ways: flax -> port -> flax gives JAX's tree back
  exactly, with the names and shapes JAX's init makes;
- DPRExecutor.train_step: 3 steps' losses and grad norms (rtol 1e-4) and
  the parameters after them (within 2 lr a step, as there);
- evaluate_retrieval: the same retrieved ids and metrics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravqa_tpu.executors import DPRExecutor as JaxDPRExecutor
from ravqa_tpu.executors import TrainConfig as JaxTrainConfig
from ravqa_tpu.models import BertConfig as JaxBertConfig
from ravqa_tpu.models import DPRModelConfig as JaxDPRConfig
from ravqa_tpu.models import DPRRetriever as JaxDPR
from ravqa_tpu.tokenization import (DocTokenizer, QueryTokenizer,
                                    WordPieceTokenizer, make_tiny_vocab)
from ravqa_tpu_torch.executors import DPRExecutor, TrainConfig
from ravqa_tpu_torch.executors.base import _num_heads
from ravqa_tpu_torch.models import (BertConfig, DPRModelConfig,
                                    DPRRetriever, flatten_params,
                                    flax_to_state_dict, state_dict_to_flax)

WORDS = ["cat", "dog", "sun", "sky", "tree", "fish", "red", "blue"]
PASSAGES = ["cat dog", "sun sky", "tree fish", "dog sun", "fish cat",
            "sky tree", "red blue cat", "blue sun"]
LR = 3e-3


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    tok = WordPieceTokenizer(make_tiny_vocab(WORDS))
    qt, dt = QueryTokenizer(tok, 8), DocTokenizer(tok, 10)
    vocab = tok.vocab_size + 8
    jm = JaxDPR(JaxDPRConfig.tiny(bert=JaxBertConfig.tiny(vocab_size=vocab)))
    di, dm = dt.tensorize(PASSAGES)
    qi, qm = qt.tensorize(PASSAGES)
    params = jm.init(jax.random.PRNGKey(0), jnp.array(qi[:2]),
                     jnp.array(qm[:2]), jnp.array(di[:4]),
                     jnp.array(dm[:4]))["params"]
    tcfg = DPRModelConfig.tiny(bert=BertConfig.tiny(vocab_size=vocab))
    return dict(qt=qt, dt=dt, jm=jm, params=jax.device_get(params),
                tcfg=tcfg, qi=qi, qm=qm, di=di, dm=dm)


def _port(setup):
    m = DPRRetriever(setup["tcfg"])
    m.load_state_dict(flax_to_state_dict(setup["params"]))
    return m


def _batch(setup, order):
    docs = []
    for i in order:
        docs += [PASSAGES[i], PASSAGES[(i + 3) % len(PASSAGES)]]
    qi, qm = setup["qt"].tensorize([PASSAGES[i] for i in order])
    di, dm = setup["dt"].tensorize(docs)
    return {"query_input_ids": qi, "query_attention_mask": qm,
            "doc_input_ids": di, "doc_attention_mask": dm}


def test_forward_and_grads_match_jax(setup):
    b = _batch(setup, [0, 4, 6])
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def jloss(p):
        out = setup["jm"].apply({"params": p}, jb["query_input_ids"],
                                jb["query_attention_mask"],
                                jb["doc_input_ids"], jb["doc_attention_mask"])
        return out["loss"], out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        setup["params"])
    m = _port(setup)
    out = m(*(torch.from_numpy(b[k]).long() for k in (
        "query_input_ids", "query_attention_mask", "doc_input_ids",
        "doc_attention_mask")))
    out["loss"].backward()
    assert out["scores"].shape == (3, 6)
    for key in ("loss", "scores", "query_emb", "item_emb"):
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(jout[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    want = flax_to_state_dict(jax.device_get(jgrads))
    names = dict(m.named_parameters())
    assert set(want) == set(names)
    scale = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        np.testing.assert_allclose(names[name].grad.numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)


def test_conversion_both_ways(setup):
    m = _port(setup)
    assert _num_heads(m) == {"query_encoder": 4, "item_encoder": 4}
    back = flatten_params(state_dict_to_flax(m.state_dict(), _num_heads(m)))
    want = flatten_params(setup["params"])
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    # the port's own init has JAX's names and shapes
    fresh = DPRRetriever(setup["tcfg"])
    fresh.reset_parameters(torch.Generator().manual_seed(0))
    tree = flatten_params(state_dict_to_flax(fresh.state_dict(),
                                             _num_heads(fresh)))
    assert {k: v.shape for k, v in tree.items()} == \
        {k: np.asarray(v).shape for k, v in want.items()}


def test_train_step_matches_jax(setup):
    jex = JaxDPRExecutor(setup["jm"], setup["params"],
                         JaxTrainConfig(lr=LR), quiet=True)
    tex = DPRExecutor(_port(setup), TrainConfig(lr=LR), device="cpu",
                      quiet=True)
    rng = np.random.default_rng(0)
    losses = []
    for step in range(3):
        b = _batch(setup, rng.permutation(len(PASSAGES))[:3])
        jm = jex.train_step({k: jnp.asarray(v) for k, v in b.items()})
        tm = tex.train_step(b)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4, err_msg=f"{step} {key}")
        losses.append(float(tm["loss"]))
    want = flax_to_state_dict(jax.device_get(jex.state.params))
    for n, p in tex.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   rtol=0, atol=3 * 2 * LR, err_msg=n)
    assert tex.step == 3 and np.isfinite(losses).all()


def test_evaluate_retrieval_matches_jax(setup):
    jex = JaxDPRExecutor(setup["jm"], setup["params"],
                         JaxTrainConfig(lr=LR), quiet=True)
    tex = DPRExecutor(_port(setup), TrainConfig(lr=LR), device="cpu",
                      quiet=True)
    kw = dict(passage_ids=[f"P{i}" for i in range(len(PASSAGES))],
              passage_contents=PASSAGES,
              answers=[[p.split()[0]] for p in PASSAGES],
              pos_item_ids=[[f"P{i}"] for i in range(len(PASSAGES))],
              ks=[1, 3, 5])
    q = [{"query_input_ids": setup["qi"][s:s + 3],
          "query_attention_mask": setup["qm"][s:s + 3]}
         for s in range(0, len(PASSAGES), 3)]
    d = [{"doc_input_ids": setup["di"], "doc_attention_mask": setup["dm"]}]
    want = jex.evaluate_retrieval(q, d, **kw)
    got = tex.evaluate_retrieval(q, d, **kw)
    np.testing.assert_allclose(tex.encode_queries(q), jex.encode_queries(q),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tex.encode_items(d), jex.encode_items(d),
                               rtol=1e-5, atol=1e-6)
    assert got["_retrieved_pids"] == want["_retrieved_pids"]
    strip = lambda m: {k: v for k, v in m.items() if not k.startswith("_")}
    assert strip(got) == strip(want)
    assert "pos_item_ids_recall_at_3" in got and "recall_at_3" in got
