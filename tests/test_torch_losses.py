"""The port's training MaxSim and losses against the JAX package's, in value
and gradient.

ravqa_tpu_torch.ops.maxsim's pair functions (maxsim_pair_xla,
maxsim_all_pairs_xla, maxsim_all_pairs_blocked, flipr_reduce) and
ravqa_tpu_torch.ops.losses get the same numpy inputs as ravqa_tpu's; the
gradients are the vector-Jacobian products with one fixed random
cotangent (jax.vjp against torch.autograd).

Tolerance: float32 values and grads rtol 1e-5, atol 1e-5 (sums of at most
a few hundred products, ordered differently by XLA and PyTorch). The bf16
compute_dtype rounds both operands to bf16 before a float32 product in
both packages, so values keep 1e-5; its grads pass the cotangent through
the bf16 cast (rounded to 8 bits of mantissa in both packages, at points
that can differ by one rounding), so they take rtol 1e-2, atol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravqa_tpu.ops import losses as jl
from ravqa_tpu.ops import maxsim as jm
from ravqa_tpu_torch.ops import losses as tl
from ravqa_tpu_torch.ops import maxsim as tm

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_GRAD = dict(rtol=1e-2, atol=1e-3)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _inputs(seed=0, bq=3, lq=5, bd=7, ld=6, dim=8, all_masked_doc=None):
    rng = np.random.default_rng(seed)
    q = _unit(rng, bq, lq, dim)
    q[:, -1] = 0.0                               # a zero (pad) query row
    d = _unit(rng, bd, ld, dim)
    d_mask = (rng.random((bd, ld)) > 0.3).astype(np.float32)
    d_mask[:, 0] = 1.0
    if all_masked_doc is not None:
        d_mask[all_masked_doc] = 0.0
    q_mask = (rng.random((bq, lq)) > 0.2).astype(np.float32)
    return q, d, d_mask, q_mask


def _compare(jfn, tfn, arrays, n_grad, tol=F32, grad_tol=F32, seed=1):
    """Value and vjp of jfn / tfn on `arrays`; grads w.r.t. the first
    n_grad arrays. Returns the torch grads."""
    jout, vjp = jax.vjp(lambda *a: jfn(*a, *arrays[n_grad:]),
                        *[jnp.asarray(a) for a in arrays[:n_grad]])
    cot = np.random.default_rng(seed).normal(
        size=np.shape(jout)).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot))
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays[:n_grad]]
    rest = [torch.tensor(a) for a in arrays[n_grad:]]
    tout = tfn(*leaves, *rest)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **tol)
    (tout * torch.from_numpy(cot)).sum().backward()
    for jg, leaf in zip(jgrads, leaves):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg),
                                   **grad_tol)
    return [leaf.grad for leaf in leaves]


@pytest.mark.parametrize("with_q_mask", [False, True])
def test_maxsim_pair_matches_jax(with_q_mask):
    q, d, d_mask, q_mask = _inputs(bq=4, bd=4)
    if with_q_mask:
        _compare(jm.maxsim_pair_xla, tm.maxsim_pair_xla,
                 [q, d, d_mask, q_mask], 2)
    else:
        _compare(jm.maxsim_pair_xla, tm.maxsim_pair_xla, [q, d, d_mask], 2)


@pytest.mark.parametrize("with_q_mask", [False, True])
def test_maxsim_all_pairs_matches_jax(with_q_mask):
    q, d, d_mask, q_mask = _inputs()
    arrays = [q, d, d_mask] + ([q_mask] if with_q_mask else [])
    _compare(jm.maxsim_all_pairs_xla, tm.maxsim_all_pairs_xla, arrays, 2)


@pytest.mark.parametrize("block_n", [0, 3, 4, 7, 20])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("with_q_mask", [False, True])
def test_maxsim_all_pairs_blocked_matches_jax(block_n, bf16, with_q_mask):
    """Bd = 7 (odd): block 3 and 4 pad it with masked docs; 0, 7 and 20
    take one block."""
    q, d, d_mask, q_mask = _inputs(seed=block_n)
    qm = q_mask if with_q_mask else None
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    _compare(lambda q, d, m: jm.maxsim_all_pairs_blocked(
                 q, d, m, qm if qm is None else jnp.asarray(qm),
                 block_n=block_n, compute_dtype=jdt),
             lambda q, d, m: tm.maxsim_all_pairs_blocked(
                 q, d, m, qm if qm is None else torch.from_numpy(qm),
                 block_n=block_n, compute_dtype=tdt),
             [q, d, d_mask], 2, grad_tol=BF16_GRAD if bf16 else F32)


def test_blocked_equals_unblocked_in_torch():
    q, d, d_mask, q_mask = _inputs(seed=3, bd=11)
    args = [torch.from_numpy(a) for a in (q, d, d_mask, q_mask)]
    want = tm.maxsim_all_pairs_xla(*args)
    for block_n in (0, 2, 5):
        got = tm.maxsim_all_pairs_blocked(*args, block_n=block_n)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lq,part,k1,k2", [
    (6, 3, 2, 2),        # context part of 3 >= k2: its top-2 added
    (6, 4, 3, 3),        # context part of 2 < k2: it adds nothing
    (6, 6, 4, 1),        # no context part
    (5, 2, 5, 0)])       # k1 past the question part; k2 = 0
def test_flipr_reduce_matches_jax(lq, part, k1, k2):
    rng = np.random.default_rng(lq + part + k1 + k2)
    scores = rng.normal(size=(3, 7, lq)).astype(np.float32)
    d_mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    d_mask[:, 0] = 1.0
    _compare(lambda s, m: jm.flipr_reduce(s, m, part, k1, k2),
             lambda s, m: tm.flipr_reduce(s, m, part, k1, k2),
             [scores, d_mask], 1)


def test_flipr_short_context_adds_nothing():
    scores = torch.ones(1, 2, 5)
    mask = torch.ones(1, 2)
    assert tm.flipr_reduce(scores, mask, 3, 3, 3).item() == 3.0
    assert tm.flipr_reduce(scores, mask, 3, 3, 2).item() == 5.0


@pytest.mark.parametrize("with_q_mask", [False, True])
def test_nway_ce_loss_colbert_matches_jax(with_q_mask):
    q, d, d_mask, q_mask = _inputs(bq=3, bd=9)
    qm = q_mask if with_q_mask else None

    def jfn(q, d, m):
        return jl.nway_ce_loss(q, d, m, 3, None if qm is None
                               else jnp.asarray(qm))[0]

    def tfn(q, d, m):
        return tl.nway_ce_loss(q, d, m, 3, None if qm is None
                               else torch.from_numpy(qm))[0]
    _compare(jfn, tfn, [q, d, d_mask], 2)


def test_nway_ce_loss_flipr_matches_jax():
    q, d, d_mask, _ = _inputs(bq=2, lq=7, bd=6)
    kw = dict(interaction="flipr", flipr_query_part_len=4, flipr_k1=3,
              flipr_k2=2)
    _compare(lambda q, d, m: jl.nway_ce_loss(q, d, m, 3, **kw)[0],
             lambda q, d, m: tl.nway_ce_loss(q, d, m, 3, **kw)[0],
             [q, d, d_mask], 2)


@pytest.mark.parametrize("variant", ["plain", "q_mask", "blocked",
                                     "blocked_bf16"])
def test_in_batch_negative_loss_matches_jax(variant):
    q, d, d_mask, q_mask = _inputs(bq=3, bd=9, seed=5)
    qm = q_mask if variant == "q_mask" else None
    block_n = 4 if variant.startswith("blocked") else 0
    bf16 = variant == "blocked_bf16"

    def jfn(q, d, m):
        return jl.in_batch_negative_loss(
            q, d, m, 3, None if qm is None else jnp.asarray(qm),
            block_n=block_n, compute_dtype=jnp.bfloat16 if bf16 else None)[0]

    def tfn(q, d, m):
        return tl.in_batch_negative_loss(
            q, d, m, 3, None if qm is None else torch.from_numpy(qm),
            block_n=block_n,
            compute_dtype=torch.bfloat16 if bf16 else None)[0]
    _compare(jfn, tfn, [q, d, d_mask], 2,
             grad_tol=BF16_GRAD if bf16 else F32)


def test_dpr_in_batch_loss_matches_jax():
    rng = np.random.default_rng(2)
    qp = rng.normal(size=(3, 8)).astype(np.float32)
    dp = rng.normal(size=(6, 8)).astype(np.float32)
    _compare(lambda a, b: jl.dpr_in_batch_loss(a, b, 2)[0],
             lambda a, b: tl.dpr_in_batch_loss(a, b, 2)[0], [qp, dp], 2)


@pytest.mark.parametrize("fn", ["all_pairs", "blocked"])
def test_all_masked_doc_scores_neg_inf_and_takes_no_gradient(fn):
    """A doc with no valid token scores -9999 x Lq (the max over its -9999
    fills), and its tokens get exactly zero gradient in both packages:
    the where / masked_fill cuts every token off."""
    q, d, d_mask, _ = _inputs(all_masked_doc=2)
    lq = q.shape[1]
    jfn = jm.maxsim_all_pairs_xla if fn == "all_pairs" else \
        (lambda q, d, m: jm.maxsim_all_pairs_blocked(q, d, m, block_n=3))
    tfn = tm.maxsim_all_pairs_xla if fn == "all_pairs" else \
        (lambda q, d, m: tm.maxsim_all_pairs_blocked(q, d, m, block_n=3))
    _, dgrad = _compare(jfn, tfn, [q, d, d_mask], 2)
    scores = tfn(*(torch.from_numpy(a) for a in (q, d, d_mask)))
    assert torch.equal(scores[:, 2], torch.full((q.shape[0],),
                                                -9999.0 * lq))
    assert torch.count_nonzero(dgrad[2]) == 0
    jg = jax.grad(lambda d: jfn(jnp.asarray(q), d,
                                jnp.asarray(d_mask)).sum())(jnp.asarray(d))
    assert not np.asarray(jg)[2].any()
    # masked tokens of the other docs take no gradient either
    assert torch.count_nonzero(dgrad[torch.from_numpy(d_mask) == 0]) == 0


def test_tied_maxima_split_the_gradient_evenly():
    """Two doc tokens tie for a query token's max: both packages give each
    half of the gradient."""
    scores = np.array([[[1.0, 0.5], [1.0, 0.2], [0.3, 0.5]]], np.float32)
    d_mask = np.ones((1, 3), np.float32)
    grads = _compare(jm.maxsim_reduce, tm.maxsim_reduce, [scores, d_mask],
                     1)
    cot = np.random.default_rng(1).normal(size=(1,)).astype(np.float32)[0]
    np.testing.assert_allclose(grads[0][0, :, 0].numpy(),
                               [cot / 2, cot / 2, 0.0], rtol=1e-6)
    np.testing.assert_allclose(grads[0][0, :, 1].numpy(),
                               [cot / 2, 0.0, cot / 2], rtol=1e-6)
