"""ravqa_tpu_torch.retrieval (index + exact search) against ravqa_tpu.

The same embeddings go into both packages' build_index_from_embeddings and
exact LateInteractionSearcher (the JAX one with use_pallas=False and
approx_topk=False). Scores must agree within rtol 1e-5, atol 1e-4 * Lq
(float32 on both sides; the MaxSim sums run in different orders). Pids are
compared tie-aware: each pid the port returns must carry, in the JAX
package's full score matrix, the score the port reports for it, and the
k-th best scores must agree (near-ties may swap order between engines).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravqa_tpu.ops.maxsim import maxsim_search_xla
from ravqa_tpu.retrieval import index as jax_index
from ravqa_tpu.retrieval import search as jax_search
from ravqa_tpu_torch.retrieval import (LateInteractionSearcher,
                                       build_index_from_embeddings,
                                       encode_corpus)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _normed(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _corpus(seed=0, n=13, ld=7, dim=16):
    rng = np.random.default_rng(seed)
    embs = _normed(rng, (n, ld, dim))
    masks = (rng.random((n, ld)) > 0.3).astype(np.float32)
    masks[:, 0] = 1
    masks[4] = 0                                  # a doc with no tokens
    return embs * masks[..., None], masks


def assert_tie_aware(scores, pids, full, want_scores, lq, pid_of_row):
    tol = dict(rtol=1e-5, atol=1e-4 * lq)
    np.testing.assert_allclose(scores, want_scores, **tol)
    row_of_pid = {p: r for r, p in enumerate(pid_of_row) if p >= 0}
    pad_rows = [r for r, p in enumerate(pid_of_row) if p < 0]
    for b in range(scores.shape[0]):
        for s, p in zip(scores[b], pids[b]):
            rows = [row_of_pid[p]] if p >= 0 else pad_rows
            np.testing.assert_allclose(full[b, rows], s, **tol)


@pytest.mark.parametrize("k", [5, 15])           # 15 > num_docs: pad rows
def test_exact_search_matches_jax(k):
    embs, masks = _corpus()
    pids = np.arange(100, 113)
    rng = np.random.default_rng(1)
    q = _normed(rng, (4, 6, 16))
    q[:, -1] = 0.0                                # zero query rows
    jidx = jax_index.build_index_from_embeddings(embs, masks, pids=pids,
                                                 pad_multiple=8,
                                                 dtype=jnp.float32)
    want_s, want_p = jax_search.LateInteractionSearcher(
        jidx, use_pallas=False, approx_topk=False).search(q, k=k)
    tidx = build_index_from_embeddings(embs, masks, pids=pids,
                                       pad_multiple=8, dtype=torch.float32)
    got_s, got_p = LateInteractionSearcher(tidx).search(q, k=k)
    assert got_s.shape == got_p.shape == (4, k)
    full = np.asarray(maxsim_search_xla(jnp.asarray(q), jidx.tokens,
                                        jidx.mask))
    assert_tie_aware(got_s, got_p, full, want_s, q.shape[1], jidx.pids)
    if k > 13:
        # the empty rows (doc pid 104 and three pads) tie for the last 3
        assert set(got_p[:, -3:].ravel()) <= {-1, 104}
        assert (got_p[:, -3:] == -1).sum(axis=1).min() >= 2
        np.testing.assert_allclose(got_s[:, -3:], -9999.0 * 6, rtol=1e-6)


@pytest.mark.parametrize("as_list", [False, True])
def test_index_layout_matches_jax(as_list):
    embs, masks = _corpus(seed=2, n=10)
    if as_list:                                   # ragged per-doc arrays
        lens = [7 - (i % 3) for i in range(10)]
        embs = [embs[i, :n] for i, n in enumerate(lens)]
        masks = [masks[i, :n] for i, n in enumerate(lens)]
    j = jax_index.build_index_from_embeddings(embs, masks, pad_multiple=8,
                                              dtype=jnp.float32)
    t = build_index_from_embeddings(embs, masks, pad_multiple=8,
                                    dtype=torch.float32)
    assert (t.num_docs, t.n_pad, t.doc_maxlen, t.dim) == \
        (j.num_docs, j.n_pad, j.doc_maxlen, j.dim) == (10, 16, 7, 16)
    assert t.mask.dtype == torch.int8 and t.meta == j.meta
    np.testing.assert_array_equal(t.pids, j.pids)
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(j.tokens))
    bf = build_index_from_embeddings(embs, masks, pad_multiple=8)
    assert bf.tokens.dtype == torch.bfloat16      # the JAX default too


def test_encode_corpus_matches_one_shot_build():
    embs, masks = _corpus(seed=3, n=11)
    batches = [(embs[s:s + 4], masks[s:s + 4]) for s in range(0, 11, 4)]
    idx = encode_corpus(
        lambda b: (torch.from_numpy(b[0]), torch.from_numpy(b[1])),
        batches, pad_multiple=8, dtype=torch.float32)
    ref = build_index_from_embeddings(embs, masks, pad_multiple=8,
                                      dtype=torch.float32)
    assert torch.equal(idx.tokens, ref.tokens)
    assert torch.equal(idx.mask, ref.mask)
    np.testing.assert_array_equal(idx.pids, ref.pids)


def test_unported_modes_raise():
    embs, masks = _corpus(n=8)
    idx = build_index_from_embeddings(embs, masks, pad_multiple=8)
    for kw in ({"mode": "two_stage"}, {"mode": "hierarchical"},
               {"mesh": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            LateInteractionSearcher(idx, **kw)
    # TPU knobs are accepted as no-ops
    LateInteractionSearcher(idx, use_pallas=True, tile_d=16,
                            approx_topk=True, preset="fast")
