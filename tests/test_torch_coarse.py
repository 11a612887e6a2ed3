"""ravqa_tpu_torch.retrieval.coarse and the summary sweeps of
ravqa_tpu_torch.ops.maxsim against ravqa_tpu.

The same numpy inputs go through the JAX function and the port's. Where
the JAX function reaches a Pallas kernel it runs in TPU interpret mode, as
the JAX package's own tests run it; those cases are kept tiny.

Tolerances, with their reasons:
- summaries (k-means, float32 on both sides, different summation orders):
  atol 1e-5 on unit vectors;
- sweep scores: rtol 1e-5, atol 1e-4 * Lq: float32 sums of the same
  products in another order (bf16 and int8 values are exact in float32);
- searches: scores as the sweeps; rows compared tie-aware (a row that
  clears the k-th score by more than the tolerance is in both top-k);
  the cuts are exact on both sides (approx_topk=False for JAX).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravqa_tpu.ops import maxsim as jax_maxsim
from ravqa_tpu.ops import quant as jax_quant
from ravqa_tpu.retrieval import coarse as jax_coarse
from ravqa_tpu_torch.ops import maxsim as torch_maxsim
from ravqa_tpu_torch.retrieval import coarse as torch_coarse


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _interpret():
    from jax.experimental.pallas import tpu as pltpu
    return pltpu.force_tpu_interpret_mode()


def _normed(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def clustered(seed=0, n=256, ld=12, dim=32, n_topics=8, b=4, lq=6):
    """A cluster-ordered corpus (doc tokens = topic + noise, docs sorted by
    topic) with masked tail tokens, a doc with no valid token and padded
    (all-masked, zero) rows at the end; queries are noisy copies of a doc's
    first tokens. Returns (q, tokens, mask) numpy float32."""
    rng = np.random.default_rng(seed)
    topics = _normed(rng.normal(size=(n_topics, dim)))
    doc_topic = np.sort(rng.integers(n_topics, size=n))
    tok = _normed(topics[doc_topic][:, None] + 0.35 * rng.normal(
        size=(n, ld, dim)))
    mask = np.ones((n, ld), np.float32)
    mask[:, ld - 3:] = (rng.random((n, 3)) > 0.5)
    mask[5] = 0
    mask[-8:] = 0                                  # padded rows
    tok *= mask[..., None]
    src = rng.integers(n - 8, size=b)
    q = _normed(tok[src, :lq] + 0.1 * rng.normal(size=(b, lq, dim)))
    q[:, -1] = 0.0                                 # a zero query row
    return q, tok, mask


def _t(x):
    return torch.from_numpy(np.array(x))          # a writable copy


def _j(x):
    return jnp.asarray(x)


def _tol(lq):
    return dict(rtol=1e-5, atol=1e-4 * lq)


def assert_search_equal(got, want, lq):
    """(scores, rows) of the port vs the JAX package, tie-aware."""
    gs, gr = (np.asarray(x) for x in got)
    ws, wr = (np.asarray(x) for x in want)
    tol = _tol(lq)
    np.testing.assert_allclose(gs, ws, **tol)
    margin = tol["atol"]
    for b in range(gs.shape[0]):
        assert set(wr[b][ws[b] > ws[b, -1] + margin]) <= set(gr[b])
        assert set(gr[b][gs[b] > gs[b, -1] + margin]) <= set(wr[b])


# -- summaries ---------------------------------------------------------------

@pytest.mark.parametrize("n_summary,iters", [(4, 4), (3, 6)])
def test_summarize_docs_matches_jax(n_summary, iters):
    _, tok, mask = clustered(n=64)
    mask[7, 2:] = 0                        # fewer valid tokens than S
    want = np.asarray(jax_coarse.summarize_docs(
        _j(tok), _j(mask), n_summary=n_summary, iters=iters))
    got = torch_coarse.summarize_docs(_t(tok), _t(mask), n_summary=n_summary,
                                      iters=iters, chunk=24)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_block_summaries_match_jax():
    _, tok, mask = clustered(n=128)
    summ = np.asarray(jax_coarse.summarize_docs(_j(tok), _j(mask),
                                                n_summary=4))
    want = np.asarray(jax_coarse.block_summaries(_j(summ), block_size=16,
                                                 n_block_summary=3))
    got = torch_coarse.block_summaries(_t(summ), block_size=16,
                                       n_block_summary=3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    want_t = np.asarray(jax_coarse.block_summaries_t(_j(want),
                                                     pad_multiple=32))
    got_t = torch_coarse.block_summaries_t(_t(want), pad_multiple=32)
    assert got_t.is_contiguous() and got_t.shape == want_t.shape == (3, 32,
                                                                     32)
    np.testing.assert_array_equal(got_t.numpy(), want_t)


def test_cluster_order_matches_jax():
    rng = np.random.default_rng(4)
    topics = _normed(rng.normal(size=(6, 16)))
    summ = _normed(topics[rng.integers(6, size=96)][:, None]
                   + 0.3 * rng.normal(size=(96, 3, 16)))
    want = np.asarray(jax_coarse.cluster_order(_j(summ), n_clusters=6,
                                               chunk=40))
    got = torch_coarse.cluster_order(_t(summ), n_clusters=6, chunk=40)
    np.testing.assert_array_equal(got.numpy(), want)


def test_coarse_scores_matches_jax():
    q, tok, mask = clustered(n=64)
    summ = np.asarray(jax_coarse.summarize_docs(_j(tok), _j(mask),
                                                n_summary=4))
    for cql in (None, 3):
        want = np.asarray(jax_coarse.coarse_scores(_j(q), _j(summ), cql))
        got = torch_coarse.coarse_scores(_t(q), _t(summ), cql)
        np.testing.assert_allclose(got.numpy(), want, **_tol(q.shape[1]))


# -- the sweeps' plain versions against the TPU kernels ----------------------

def _summ_t(seed=5, s=3, n=256, dim=128):
    rng = np.random.default_rng(seed)
    summ = _normed(rng.normal(size=(s, n, dim)))
    valid = rng.random(n) > 0.1
    summ[:, ~valid] = 0.0
    return summ, valid


@pytest.mark.parametrize("int8", [False, True])
def test_coarse_sweep_torch_matches_pallas_interpret(int8):
    rng = np.random.default_rng(6)
    b, lq, dim = 3, 8, 128
    q = _normed(rng.normal(size=(b, lq, dim)))
    q[1, -2:] = 0.0
    summ_t, valid = _summ_t(dim=dim)
    st = _j(summ_t).astype(jnp.bfloat16)
    dscale = None
    if int8:
        st, dscale = jax_quant.quantize_summaries_t_int8(st)
    with _interpret():
        want = np.asarray(jax_maxsim.coarse_sweep_pallas(
            _j(q), st, _j(valid), tile_n=128, queries_per_chunk=2,
            dscale=dscale))
    tst = _t(np.asarray(st, np.float32))
    tst = tst.to(torch.int8) if int8 else tst.bfloat16()
    got = torch_maxsim.coarse_sweep_torch(
        _t(q), tst, _t(valid), None if dscale is None else
        _t(np.asarray(dscale)))
    np.testing.assert_allclose(got.numpy(), want, **_tol(lq))
    assert (got.numpy()[:, ~valid] == -9999.0).all()


def test_coarse_sweep_int8_pre_scale_sums_are_integers():
    rng = np.random.default_rng(7)
    q8 = _t(rng.integers(-127, 128, size=(2, 5, 16)).astype(np.int8))
    st8 = _t(rng.integers(-127, 128, size=(3, 20, 16)).astype(np.int8))
    ones_q, ones_d = torch.ones(2, 5), torch.ones(20)
    got = torch_maxsim.coarse_sweep_int8_torch(q8, ones_q, st8, ones_d)
    want = np.einsum("bqd,snd->sbqn", q8.numpy().astype(np.int64),
                     st8.numpy().astype(np.int64)).max(0).sum(1)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def _rows(int8, seed=8, n=256, s=4, bs=16, dim=64):
    rng = np.random.default_rng(seed)
    summ = rng.normal(size=(n, s, dim)).astype(np.float32)
    if int8:
        si8, dscale = jax_quant.quantize_summaries_int8(_j(summ))
        return jax_maxsim.stage1_rows(si8, bs), dscale
    return jax_maxsim.stage1_rows(_j(summ).astype(jnp.bfloat16), bs), None


def _torch_rows(rows, dscale):
    r = np.asarray(rows, np.float32)
    tr = _t(r).to(torch.int8) if dscale is not None else _t(r).bfloat16()
    return tr, None if dscale is None else _t(np.asarray(dscale))


@pytest.mark.parametrize("int8", [False, True])
def test_stage1_sweep_torch_matches_xla_and_pallas(int8):
    rows, dscale = _rows(int8)
    rng = np.random.default_rng(9)
    q = rng.normal(size=(3, 8, 64)).astype(np.float32)
    blk = rng.integers(0, rows.shape[0], size=(3, 8)).astype(np.int32)
    want_xla = np.asarray(jax_maxsim.stage1_sweep_xla(
        _j(q), rows, _j(blk), dscale=dscale))
    with _interpret():
        want_pl = np.asarray(jax_maxsim.stage1_sweep_pallas(
            _j(q), rows, _j(blk), tile_b=8, dscale=dscale))
    tr, td = _torch_rows(rows, dscale)
    got = torch_maxsim.stage1_sweep_torch(_t(q), tr, _t(blk), dscale=td)
    assert got.shape == (3, 8 * 16)
    # scores of unit-free random rows (|score| ~ 100): relative tolerance
    np.testing.assert_allclose(got.numpy(), want_xla, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), want_pl, rtol=1e-5, atol=1e-3)


def test_stage1_rows_matches_jax():
    rng = np.random.default_rng(10)
    summ = rng.normal(size=(64, 3, 8)).astype(np.float32)
    want = np.asarray(jax_maxsim.stage1_rows(_j(summ), 16))
    got = torch_maxsim.stage1_rows(_t(summ), 16)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


# -- two-stage and hierarchical search ----------------------------------------

@pytest.fixture(scope="module")
def corpus():
    q, tok, mask = clustered()
    summ = np.asarray(jax_coarse.summarize_docs(_j(tok), _j(mask),
                                                n_summary=4, iters=4))
    bsum = np.asarray(jax_coarse.block_summaries(_j(summ), block_size=16))
    return q, tok, mask, summ, bsum


@pytest.mark.parametrize("variant", ["einsum", "einsum_cql", "summ_t_bf16",
                                     "summ_t_int8", "maxsim_k1"])
def test_two_stage_search_matches_jax(corpus, variant):
    q, tok, mask, summ, _ = corpus
    kw = dict(k=5, n_candidates=24)
    jkw, tkw = {}, {}
    if variant == "einsum_cql":
        jkw = tkw = {"coarse_query_len": 3}
    if variant == "maxsim_k1":          # the exhaustive MaxSim (K1) pass
        jkw = tkw = {"use_pallas_coarse": True}
    if variant.startswith("summ_t"):
        st = jnp.swapaxes(_j(summ), 0, 1)
        if variant == "summ_t_int8":
            st, sts = jax_quant.quantize_summaries_t_int8(st)
            tkw["summaries_t"] = _t(np.asarray(st))
            tkw["summaries_t_scale"] = _t(np.asarray(sts))
            jkw["summaries_t_scale"] = sts
        else:
            st = st.astype(jnp.bfloat16)
            tkw["summaries_t"] = _t(np.asarray(st, np.float32)).bfloat16()
        jkw.update(summaries_t=st, use_pallas_coarse=True)
        tkw["use_pallas_coarse"] = True
    args = (q, tok, mask, summ)
    if variant.startswith("summ_t") or variant == "maxsim_k1":
        with _interpret():
            want = jax_coarse.two_stage_search(*map(_j, args), **kw, **jkw)
    else:
        want = jax_coarse.two_stage_search(*map(_j, args), **kw, **jkw)
    got = torch_coarse.two_stage_search(*map(_t, args), **kw, **tkw)
    assert_search_equal(got, want, q.shape[1])


@pytest.mark.parametrize("stage1", ["float", "int8", "rows_bf16",
                                    "rows_int8"])
@pytest.mark.parametrize("stage0", ["einsum", "bsum_t"])
def test_hierarchical_search_matches_jax(corpus, stage0, stage1):
    q, tok, mask, summ, bsum = corpus
    kw = dict(k=5, n_blocks=4, n_candidates=20, block_size=16,
              coarse_query_len=4)
    jkw, tkw = {}, {}
    jsumm, tsumm = _j(summ), _t(summ)
    if stage1 == "int8":
        si8, ss = jax_quant.quantize_summaries_int8(_j(summ))
        jkw = dict(summ_int8=si8, summ_scale=ss)
        tkw = dict(summ_int8=_t(np.asarray(si8)), summ_scale=_t(
            np.asarray(ss)))
        jsumm = tsumm = None
    elif stage1.startswith("rows"):
        if stage1 == "rows_int8":
            si8, ss = jax_quant.quantize_summaries_int8(_j(summ))
            rows = jax_maxsim.stage1_rows(si8, 16)
            trows = _t(np.asarray(rows))
            jkw, tkw = dict(summ_scale=ss), dict(summ_scale=_t(
                np.asarray(ss)))
        else:
            rows = jax_maxsim.stage1_rows(_j(summ).astype(jnp.bfloat16), 16)
            trows = _t(np.asarray(rows, np.float32)).bfloat16()
        jkw["summ_rows"], tkw["summ_rows"] = rows, trows
        jsumm = tsumm = None
    if stage0 == "bsum_t":
        bt = jax_coarse.block_summaries_t(_j(bsum).astype(jnp.bfloat16),
                                          pad_multiple=32)
        jkw["block_summ_t"] = bt
        tkw["block_summ_t"] = _t(np.asarray(bt, np.float32)).bfloat16()
        with _interpret():
            want = jax_coarse.hierarchical_search(
                _j(q), _j(tok), _j(mask), jsumm, _j(bsum), **kw, **jkw)
    else:
        want = jax_coarse.hierarchical_search(
            _j(q), _j(tok), _j(mask), jsumm, _j(bsum), **kw, **jkw)
    got = torch_coarse.hierarchical_search(
        _t(q), _t(tok), _t(mask), tsumm, _t(bsum), **kw, **tkw)
    assert_search_equal(got, want, q.shape[1])


def test_hierarchical_pruning_bites(corpus):
    """The cuts above are real: the hierarchical search's candidates are a
    strict subset of the corpus, and its answers still match exact search
    on this clustered corpus."""
    q, tok, mask, summ, bsum = corpus
    got_s, got_r = torch_coarse.hierarchical_search(
        _t(q), _t(tok), _t(mask), _t(summ), _t(bsum), k=5, n_blocks=4,
        n_candidates=20, block_size=16)
    exact = torch_maxsim.maxsim_search_torch(_t(q), _t(tok),
                                             _t(mask).to(torch.int8))
    want_s, want_r = torch.topk(exact, 5, dim=1)
    assert_search_equal((got_s, got_r), (want_s, want_r), q.shape[1])
    assert 4 * 16 < tok.shape[0]


@pytest.mark.parametrize("search", ["two_stage", "hier_float", "hier_rows"])
def test_invalid_docs_never_take_candidates(search):
    """Queries anti-correlated with the corpus: every real doc scores below
    an empty doc's all-zero summaries, so only the -9999 validity masking
    keeps empty docs out of the candidate sets."""
    q, tok, mask = clustered(seed=3, n=128, n_topics=1)
    mask[::3] = 0
    tok *= mask[..., None]
    q = -q
    summ = np.asarray(jax_coarse.summarize_docs(_j(tok), _j(mask),
                                                n_summary=4))
    bsum = np.asarray(jax_coarse.block_summaries(_j(summ), block_size=16))
    if search == "two_stage":
        kw = dict(k=5, n_candidates=10)
        want = jax_coarse.two_stage_search(*map(_j, (q, tok, mask, summ)),
                                           **kw)
        got = torch_coarse.two_stage_search(*map(_t, (q, tok, mask, summ)),
                                            **kw)
    else:
        # every block: blocks holding a zero k-means centroid tie at
        # exactly 0 in stage 0, and the two top-k's break ties apart
        kw = dict(k=5, n_blocks=8, n_candidates=10, block_size=16)
        jkw = tkw = {}
        jsumm, tsumm = _j(summ), _t(summ)
        if search == "hier_rows":
            rows = jax_maxsim.stage1_rows(_j(summ).astype(jnp.bfloat16), 16)
            jkw = dict(summ_rows=rows)
            tkw = dict(summ_rows=_t(np.asarray(rows, np.float32)).bfloat16())
            jsumm = tsumm = None
        want = jax_coarse.hierarchical_search(
            _j(q), _j(tok), _j(mask), jsumm, _j(bsum), **kw, **jkw)
        got = torch_coarse.hierarchical_search(
            _t(q), _t(tok), _t(mask), tsumm, _t(bsum), **kw, **tkw)
    assert (np.asarray(got[1]) % 3 != 0).all()     # real docs only
    assert_search_equal(got, want, q.shape[1])
