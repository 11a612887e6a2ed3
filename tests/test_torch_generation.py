"""ravqa_tpu_torch.models.generation against ravqa_tpu.models.generation.

Greedy and beam search (2 and 5 beams) run the same step function on both
sides: the tiny T5's decode_step with the JAX parameters carried across
(models/convert.py), and a step that reads its logits from a seeded table
with exact ties, where only the tie rules decide. Generated tokens must be
identical; log-probs agree within 1e-4. Where two candidates of the JAX
run lie within 1e-5 at a step (so that the float32 difference between the
engines could swap them), the test prints that margin rather than choosing
another seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravqa_tpu.models import generation as jax_gen
from ravqa_tpu.models import t5 as jax_t5
from ravqa_tpu_torch.models.convert import generator_to_state_dict
from ravqa_tpu_torch.models.generation import (NEG, beam_generate,
                                               greedy_generate)
from ravqa_tpu_torch.models.t5 import T5Config, T5Model

ATOL = 1e-4
MAX_LEN = 6
B = 3


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def t5_pair():
    """A tiny gated-GELU T5 on both sides, its encoder output for B inputs,
    and eos = the token the JAX model's first greedy step picks most, so
    that sequences finish within MAX_LEN."""
    kw = dict(feed_forward_proj="gated-gelu", tie_word_embeddings=False,
              vocab_size=64)
    jm = jax_t5.T5Model(jax_t5.T5Config.tiny(**kw))
    rng = np.random.default_rng(0)
    ids = rng.integers(2, 64, (B, 7)).astype(np.int32)
    mask = np.ones((B, 7), np.int32)
    mask[2, 4:] = 0
    p = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.asarray(ids),
                               jnp.asarray(mask),
                               jnp.asarray(ids[:, :2]))["params"])
    tm = T5Model(T5Config.tiny(**kw))
    tm.load_state_dict(generator_to_state_dict(p), strict=True)
    tm.eval()
    jenc = jm.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask),
                    method=jax_t5.T5Model.encode)
    with torch.no_grad():
        tenc = tm.encode(torch.tensor(ids), torch.tensor(mask))
    return jm, p, tm, jenc, tenc, mask


def _recording(step, record):
    """step, recording each call's last-position logits (the JAX run's,
    through an ordered debug callback inside lax.scan)."""
    def wrapped(tok, cache):
        logits, cache = step(tok, cache)
        jax.debug.callback(lambda x: record.append(np.asarray(x)),
                           logits[:, -1], ordered=True)
        return logits, cache
    return wrapped


def _log_softmax(x):
    x = x.astype(np.float64)
    x = x - x.max(-1, keepdims=True)
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def _greedy_margin(record) -> float:
    """The smallest gap between the best two tokens over the steps."""
    s = np.sort(np.stack(record), axis=-1)
    return float((s[..., -1] - s[..., -2]).min())


def _beam_margin(record, n_beams, eos, pad=0) -> float:
    """The smallest gap between neighbouring candidates among the n_beams
    + 1 best of each step, replaying the JAX run's beam search on its
    recorded logits."""
    b = record[0].shape[0] // n_beams
    lp = np.full((b, n_beams), NEG)
    lp[:, 0] = 0.0
    done = np.zeros((b, n_beams), bool)
    margin = np.inf
    for logits in record:
        logp = _log_softmax(logits).reshape(b, n_beams, -1)
        pad_only = np.full(logp.shape[-1], NEG)
        pad_only[pad] = 0.0
        logp = np.where(done[:, :, None], pad_only, logp)
        flat = (lp[:, :, None] + logp).reshape(b, -1)
        order = np.argsort(-flat, axis=1, kind="stable")[:, :n_beams + 1]
        top = np.take_along_axis(flat, order, 1)
        margin = min(margin, float(np.diff(-top, axis=1).min()))
        idx = order[:, :n_beams]
        src, tok = idx // logp.shape[-1], idx % logp.shape[-1]
        done = np.take_along_axis(done, src, 1) | (tok == eos)
        lp = top[:, :n_beams]
    return margin


def _report(kind, margin):
    if margin < 1e-5:
        print(f"{kind}: the JAX run's closest candidates at a step lie "
              f"{margin:.3g} apart")


def _eos(jm, p, jenc, mask):
    cache = jm.apply({"params": p}, B, 1, method=jax_t5.T5Model.init_cache)
    logits, _ = jm.apply({"params": p}, jnp.zeros((B, 1), jnp.int32), jenc,
                         jnp.asarray(mask), cache,
                         method=jax_t5.T5Model.decode_step)
    return int(np.bincount(np.asarray(logits)[:, 0].argmax(-1)).argmax())


def test_greedy_matches_jax(t5_pair):
    jm, p, tm, jenc, tenc, mask = t5_pair
    eos = _eos(jm, p, jenc, mask)
    record = []

    def jstep(tok, cache):
        return jm.apply({"params": p}, tok, jenc, jnp.asarray(mask), cache,
                        method=jax_t5.T5Model.decode_step)

    want_t, want_lp = jax_gen.greedy_generate(
        _recording(jstep, record),
        jm.apply({"params": p}, B, MAX_LEN,
                 method=jax_t5.T5Model.init_cache),
        B, MAX_LEN, 0, eos)
    jax.effects_barrier()
    kv, m = tm.cross_kv(tenc), torch.tensor(mask)
    with torch.no_grad():
        got_t, got_lp = greedy_generate(
            lambda tok, cache: tm.decode_step(tok, kv, m, cache),
            tm.init_cache(B, MAX_LEN), B, MAX_LEN, 0, eos)
    _report("greedy", _greedy_margin(record))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    assert float(np.abs(got_lp.numpy() - np.asarray(want_lp)).max()) < ATOL


@pytest.mark.parametrize("n_beams", [2, 5])
def test_beam_matches_jax(t5_pair, n_beams):
    """The JAX step on the encoder output repeated over the beams; the
    port's on cross_kv computed once, the beams' rows grouped."""
    jm, p, tm, jenc, tenc, mask = t5_pair
    eos = _eos(jm, p, jenc, mask)
    enc_b = jnp.repeat(jenc, n_beams, axis=0)
    mask_b = jnp.repeat(jnp.asarray(mask), n_beams, axis=0)
    record = []

    def jstep(tok, cache):
        return jm.apply({"params": p}, tok, enc_b, mask_b, cache,
                        method=jax_t5.T5Model.decode_step)

    want_s, want_lp = jax_gen.beam_generate(
        _recording(jstep, record),
        lambda n: jm.apply({"params": p}, n, MAX_LEN,
                           method=jax_t5.T5Model.init_cache),
        B, n_beams, MAX_LEN, 0, eos)
    jax.effects_barrier()
    kv, m = tm.cross_kv(tenc), torch.tensor(mask)
    with torch.no_grad():
        got_s, got_lp = beam_generate(
            lambda tok, cache: tm.decode_step(tok, kv, m, cache),
            lambda n: tm.init_cache(n, MAX_LEN), B, n_beams, MAX_LEN, 0,
            eos)
    _report(f"beam {n_beams}", _beam_margin(record, n_beams, eos))
    assert got_s.shape == (B, n_beams, MAX_LEN)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert float(np.abs(got_lp.numpy() - np.asarray(want_lp)).max()) < ATOL
    assert (got_s == eos).any()            # some beam finished


def _tables(vocab=12, seed=0):
    """Seeded logits per previous token plus one row per sequence, rounded
    to 0.5 so that many candidates tie exactly; token 3 (eos) is often
    among the best."""
    rng = np.random.default_rng(seed)
    t = np.round(rng.normal(size=(vocab, vocab)) * 2) / 2
    t[:, 3] += 1.0
    row = np.round(rng.normal(size=(B, vocab)) * 2) / 2
    return t.astype(np.float32), row.astype(np.float32)


@pytest.mark.parametrize("n_beams,length_penalty",
                         [(1, 0.0), (2, 0.0), (5, 0.0), (5, 1.0)])
def test_tie_rules_match_jax(n_beams, length_penalty):
    """Exact ties among candidates: the lower flat index (beam, token) wins,
    finished beams emit only pad, the final beams ordered as jnp.argsort;
    greedy takes the first maximal token."""
    table, row = _tables()
    seq = np.arange(B * n_beams) // n_beams   # each row's sequence
    jt, jrow = jnp.asarray(table), jnp.asarray(row[seq])
    tt, trow = torch.tensor(table), torch.tensor(row[seq])

    def jstep(tok, cache):
        return (jt[tok[:, 0]] + jrow)[:, None], cache

    def tstep(tok, cache):
        return (tt[tok[:, 0]] + trow)[:, None], cache

    def jcache(n):
        return {"x": jnp.zeros((n, 1))}

    def tcache(n):
        return [{"x": torch.zeros(n, 1)}]

    if n_beams == 1:
        want = jax_gen.greedy_generate(jstep, jcache(B), B, 8, 0, 3)
        got = greedy_generate(tstep, tcache(B), B, 8, 0, 3)
    else:
        want = jax_gen.beam_generate(jstep, jcache, B, n_beams, 8, 0, 3,
                                     length_penalty=length_penalty)
        got = beam_generate(tstep, tcache, B, n_beams, 8, 0, 3,
                            length_penalty=length_penalty)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=0, atol=1e-5)
    assert (got[0] == 3).any()
