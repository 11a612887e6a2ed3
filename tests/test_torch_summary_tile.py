"""The tensor-core summary sweep's host-side design (csrc/summary_tile.cuh,
K3 and K4), checked on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py). What
they take from Python, and the orders they sum in, are checked here:

- ops.maxsim.summary_plan: a model of the kernels' index arithmetic
  (block -> group and tiles, tile row -> doc, pass and column -> query
  token, the epilogue's per-query emits) covers every (query token, doc,
  slot) exactly once, and writes each (query, doc) sum once first and once
  last, over the whole of its columns;
- the plan gives the card's 132 SMs at least one block each at the shapes
  chip_smoke.py measures;
- K4's k order: the fragment positions that a thread's 32-bit load of four
  int8 values (or 64-bit load of four bf16 ones) fills are the positions
  the staged query's word order gives, and a plain model of the kernel's
  sums in that order equals stage1_sweep_torch and JAX's stage1_sweep_xla;
- the dscale folded into K4's epilogue (raw sum x the doc's scale) equals
  stage1_sweep_pallas with dscale, in interpret mode.

Tolerances: rtol 1e-5, atol 1e-3 on scores of unnormalized rows (|score|
~ 100), as tests/test_torch_coarse.py: float32 sums of the same products
in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravqa_tpu.ops import maxsim as jax_maxsim
from ravqa_tpu.ops import quant as jax_quant
from ravqa_tpu_torch.ops import maxsim as torch_maxsim

ROWS = torch_maxsim.SUMMARY_TILE_ROWS


def _interpret():
    from jax.experimental.pallas import tpu as pltpu
    return pltpu.force_tpu_interpret_mode()


# -- the grid plan ---------------------------------------------------------

def _emits(plan, g_here, lq):
    """The epilogue's emits of one group (summary_tile.cuh, sweep): for
    each pass and 8-column slab j, the columns added since the last emit;
    an emit when a query ends (done % lqp == 0) or the pass does. Returns
    [(qi, first, last, the group's real columns summed)]; asserts that
    every real column summed into an emit belongs to the emitted query."""
    out, run = [], []
    cols, lqp = plan.cols, plan.lqp
    for p in range(plan.passes):
        for j in range(cols // 8):
            run += range(p * cols + 8 * j, p * cols + 8 * j + 8)
            done = p * cols + 8 * j + 8
            if done % lqp == 0 or j == cols // 8 - 1:
                qi = (done - 1) // lqp
                real = [c for c in run
                        if c // lqp < g_here and c % lqp < lq]
                if qi < g_here:
                    assert all(c // lqp == qi for c in real), (qi, real)
                    out.append((qi, qi * lqp >= p * cols,
                                (qi + 1) * lqp <= (p + 1) * cols, real))
                else:
                    assert not real, (qi, real)
                run = []
    return out


def _check_emits(plan, b, lq):
    for gi in range(plan.groups(b)):
        g_here = min(plan.queries_per_group, b - gi * plan.queries_per_group)
        emits = _emits(plan, g_here, lq)
        for qi in range(g_here):
            mine = [e for e in emits if e[0] == qi]
            assert sum(e[1] for e in mine) == 1 and mine[0][1]
            assert sum(e[2] for e in mine) == 1 and mine[-1][2]
            cols = sorted(c for e in mine for c in e[3])
            assert cols == [qi * plan.lqp + t for t in range(lq)]


def _blocks(plan, b):
    """(group, its tiles) of each block of the grid, as the kernel takes
    them: block x -> group x % groups, tiles from (x // groups) *
    tiles_per_block."""
    groups = plan.groups(b)
    for x in range(plan.blocks(b)):
        t0 = x // groups * plan.tiles_per_block
        yield x % groups, range(t0, min(t0 + plan.tiles_per_block,
                                        plan.n_tiles))


def _columns(plan, gi, b, lq):
    """(query, token) of every column of every pass of group gi, or None
    for a padding column."""
    g = plan.queries_per_group
    out = []
    for p in range(plan.passes):
        for c in range(plan.cols):
            gcol = p * plan.cols + c
            qi, tok = divmod(gcol, plan.lqp)
            out.append((gi * g + qi, tok)
                       if qi < min(g, b - gi * g) and tok < lq else None)
    return out


# (B, Lq, S, bs, n_blocks): Lq 1-300 (one query over several 128-column
# passes from Lq 129), bs 1-300 (a block over several 64-row tiles from
# 65), S 1-8, n_blocks 1-64
GATHERED = [(3, 1, 1, 1, 1), (2, 6, 3, 16, 5), (4, 32, 8, 64, 32),
            (2, 64, 8, 64, 64), (3, 150, 2, 24, 3), (2, 7, 1, 100, 3),
            (1, 300, 4, 300, 2), (5, 129, 2, 65, 7), (2, 17, 5, 8, 64)]


@pytest.mark.parametrize("shape", GATHERED)
def test_gathered_plan_covers_every_doc_slot_and_column_once(shape):
    b, lq, s_, bs, nbl = shape
    chunks = -(-bs // ROWS)
    plan = torch_maxsim.summary_plan(b, lq, nbl * chunks, gathered=True,
                                     sm_count=2)
    assert plan.queries_per_group == 1 and plan.cols >= min(plan.lqp, 128)
    assert plan.passes * plan.cols >= plan.lqp
    hits = np.zeros((b, nbl * bs, s_, lq), np.int64)
    for gi, tiles in _blocks(plan, b):
        cols = [c for c in _columns(plan, gi, b, lq) if c is not None]
        toks = np.array([t for _, t in cols])
        assert all(q == gi for q, _ in cols)
        for t in tiles:
            sel, j0 = divmod(t, chunks)
            j = j0 * ROWS + np.arange(ROWS)
            p = sel * bs + j[j < bs]          # rows past the block dropped
            np.add.at(hits, (gi, p[:, None, None],
                             np.arange(s_)[None, :, None],
                             toks[None, None, :]), 1)
    assert (hits == 1).all()
    _check_emits(plan, b, lq)


# (B, Lq, S, N): groups of several queries (Lq <= 64), one query over two
# passes (Lq=150, 300), N ragged against the 64-row tile, S 1-8
COARSE = [(3, 6, 3, 37), (32, 32, 8, 1000), (2, 150, 2, 130),
          (4, 80, 4, 129), (5, 7, 1, 300), (1, 1, 4, 9), (3, 300, 2, 70),
          (7, 64, 4, 1024)]


@pytest.mark.parametrize("shape", COARSE)
def test_coarse_plan_covers_every_doc_slot_and_column_once(shape):
    b, lq, s_, n = shape
    plan = torch_maxsim.summary_plan(b, lq, -(-n // ROWS), gathered=False,
                                     sm_count=2)
    assert plan.cols == 128
    assert plan.queries_per_group * plan.lqp <= 128 * plan.passes
    hits = np.zeros((b, n, s_, lq), np.int64)
    for gi, tiles in _blocks(plan, b):
        cols = [c for c in _columns(plan, gi, b, lq) if c is not None]
        qs = np.array([q for q, _ in cols])
        toks = np.array([t for _, t in cols])
        for t in tiles:
            d = t * ROWS + np.arange(ROWS)
            d = d[d < n]                      # rows past N dropped
            np.add.at(hits, (qs[None, None, :], d[:, None, None],
                             np.arange(s_)[None, :, None],
                             toks[None, None, :]), 1)
    assert (hits == 1).all()
    _check_emits(plan, b, lq)


@pytest.mark.parametrize("b,lq,n_tiles,gathered", [
    (32, 64, 32, True),       # K4 at the hierarchical serve: 32 blocks
    (32, 32, 32, True),       # K4 at the bench shape, n_blocks 32
    (32, 32, 16, True),       # and 16
    (32, 64, 16, False),      # K3 at the serve: 1,024 padded blocks
    (32, 32, 32, False),      # K3 at the bench block shape: 2,048
    (32, 32, 1760, False)])   # K3 at the two-stage shape: 112,640 docs
def test_plan_fills_the_card_at_the_measured_shapes(b, lq, n_tiles,
                                                    gathered):
    plan = torch_maxsim.summary_plan(b, lq, n_tiles, gathered=gathered)
    assert plan.blocks(b) >= 132
    assert plan.cols == (64 if lq == 64 else 32) if gathered else 128


# -- K4's k order and its folded scale ----------------------------------------

def _fragment_dims():
    """The true dim (within a k-step of 16) at each of the 16 k positions
    of a bf16 A fragment, as the kernel's loads fill it: thread c of a quad
    loads dims 4c .. 4c + 3 (one 32-bit word of int8 values, or 64 bits of
    bf16 ones) into its registers a0 = positions (2c, 2c + 1) and a2 =
    positions (2c + 8, 2c + 9)."""
    pos = np.empty(16, np.int64)
    for c in range(4):
        pos[[2 * c, 2 * c + 1, 2 * c + 8, 2 * c + 9]] = 4 * c + np.arange(4)
    return pos


def _staged_query_dims():
    """The true dim at each k position of a staged query column: words w0
    .. w7 (dims 2i, 2i + 1) stored as w0 w2 w4 w6 | w1 w3 w5 w7."""
    words = [0, 2, 4, 6, 1, 3, 5, 7]
    return np.array([2 * w + e for w in words for e in (0, 1)])


def test_query_staging_matches_the_fragment_k_order():
    frag = _fragment_dims()
    assert sorted(frag) == list(range(16))
    np.testing.assert_array_equal(_staged_query_dims(), frag)


def _k_order(dim):
    return np.concatenate([16 * ks + _fragment_dims()
                           for ks in range(-(-dim // 16))])


def stage1_model(q, rows, blk, dscale=None):
    """K4 as the kernel sums: dims in the fragments' k order (zeros past
    dim), products in float32 (int8 rows exact in bf16), the max over
    slots, then per doc the sum over the query's columns as a warp takes
    it: thread c adds its columns 8j + 2c, 8j + 2c + 1 slab by slab, then
    lanes ^1 and ^2 add; the doc's scale multiplies the sum."""
    b, lq, dim = q.shape
    nb, s_, bs, _ = rows.shape
    order = _k_order(dim)
    pad = len(order) - dim
    qk = torch.nn.functional.pad(q.bfloat16().float(), (0, pad))[..., order]
    rk = torch.nn.functional.pad(rows.float(), (0, pad))[..., order]
    g = rk[blk.long()]                           # (B, nbl, S, bs, k)
    m = torch.einsum("bnsjk,bqk->bnsjq", g, qk).amax(dim=2)
    lqp = -(-lq // 8) * 8
    m = torch.nn.functional.pad(m, (0, lqp - lq))    # zero columns
    m = m.reshape(*m.shape[:3], lqp // 8, 4, 2)      # (.., slab j, c, e)
    v = torch.zeros(m.shape[:3] + (4,))
    for j in range(lqp // 8):
        for e in range(2):
            v = v + m[:, :, :, j, :, e]
    v = v + v[..., [1, 0, 3, 2]]                     # lanes ^1
    total = (v + v[..., [2, 3, 0, 1]])[..., 0]       # lanes ^2
    out = total.reshape(b, -1)
    if dscale is not None:
        scl = dscale.reshape(nb, bs)[blk.long()].reshape(b, -1)
        out = out * scl
    return out


def _rows(int8, seed=8, n=256, s=4, bs=16, dim=64):
    rng = np.random.default_rng(seed)
    summ = rng.normal(size=(n, s, dim)).astype(np.float32)
    if int8:
        si8, dscale = jax_quant.quantize_summaries_int8(jnp.asarray(summ))
        return jax_maxsim.stage1_rows(si8, bs), dscale
    return jax_maxsim.stage1_rows(jnp.asarray(summ).astype(jnp.bfloat16),
                                  bs), None


def _torch_rows(rows, dscale):
    r = torch.from_numpy(np.array(rows, np.float32))
    tr = r.to(torch.int8) if dscale is not None else r.bfloat16()
    return tr, None if dscale is None else torch.from_numpy(
        np.array(dscale))


@pytest.mark.parametrize("int8,lq,dim", [(False, 8, 64), (True, 8, 64),
                                         (True, 13, 48), (False, 21, 40)])
def test_stage1_model_in_fragment_order_matches_plain_and_jax(int8, lq,
                                                              dim):
    rows, dscale = _rows(int8, dim=dim)
    rng = np.random.default_rng(9)
    q = rng.normal(size=(3, lq, dim)).astype(np.float32)
    blk = rng.integers(0, rows.shape[0], size=(3, 8)).astype(np.int32)
    want_xla = np.asarray(jax_maxsim.stage1_sweep_xla(
        jnp.asarray(q), rows, jnp.asarray(blk), dscale=dscale))
    tr, td = _torch_rows(rows, dscale)
    tq, tb = torch.from_numpy(q), torch.from_numpy(blk)
    got = stage1_model(tq, tr, tb, td)
    plain = torch_maxsim.stage1_sweep_torch(tq, tr, tb, dscale=td)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(got.numpy(), want_xla, rtol=1e-5, atol=1e-3)


def test_folded_dscale_matches_pallas_interpret():
    """K4's epilogue multiplies each raw sum by its doc's scale, where the
    TPU wrapper multiplies the kernel's raw output afterwards."""
    rows, dscale = _rows(True)
    rng = np.random.default_rng(11)
    q = rng.normal(size=(3, 8, 64)).astype(np.float32)
    blk = rng.integers(0, rows.shape[0], size=(3, 8)).astype(np.int32)
    with _interpret():
        want = np.asarray(jax_maxsim.stage1_sweep_pallas(
            jnp.asarray(q), rows, jnp.asarray(blk), tile_b=8,
            dscale=dscale))
    tr, td = _torch_rows(rows, dscale)
    got = stage1_model(torch.from_numpy(q), tr, torch.from_numpy(blk), td)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
