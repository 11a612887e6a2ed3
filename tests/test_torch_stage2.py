"""ravqa_tpu_torch.ops.stage2 and ravqa_tpu_torch.scripts.exp_residual_stage2
against scripts/exp_residual_stage2.py.

The JAX script cannot be imported in a test: at import it builds a
200,064-doc index and jits on the default backend. Its source is read with
ast and only its function definitions are executed, in a namespace that
sets small values for its module constants (N, LD, DIM, B, LQ, K, N_CENT,
NBITS, PER_BYTE, PACKED) and supplies jax, jnp, np, NEG_INF, decompress and
unpack_bits. Its Pallas kernels (X1 in v_pallas, X2 in
maxsim_candidates_pallas, X3 in v_record_perq_pallas) run in interpret
mode: pallas_call is patched to interpret=True while a test runs (the
functions import pallas inside their bodies, so they pick the patch up).
C is a multiple of 128, as the TPU tiles need. The same numpy inputs, made
from a seed, go to each JAX variant and its port. Tolerances, with their
reasons:
- float32 paths (X1 / v_pallas, v_cqsplit): 1e-4 abs, the same float32
  products summed in another order;
- bf16 decompress paths (v_baseline, v_batched / X2, the record variants,
  X3, v_grouped, v_batched_einsum): 1e-3 abs, the same bf16 values (exact
  in float32) summed in another order; v_grouped's bf16 scores round the
  same float32 sums to bf16 on both sides;
- make_records and the script's split_records: bit-equal;
- the sums of v_gathers / v_record_gather / v_decomp_only: rtol 1e-6 /
  1e-5, float32 sums of 1e4-1e7 values in another order.
X2's tensor-core kernel runs only on the card; its plan (every query,
candidate and token covered once) and a model of its epilogue (the mask,
the max over rows and the sum's order) are held here to the plain version
and to maxsim_candidates_pallas (1e-3 abs, as the bf16 paths above).
"""

import ast
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ravqa_tpu.ops.maxsim import NEG_INF as JAX_NEG_INF
from ravqa_tpu.ops.residual import decompress as jax_decompress
from ravqa_tpu.ops.residual import unpack_bits as jax_unpack_bits
from ravqa_tpu_torch.ops import stage2
from ravqa_tpu_torch.scripts import exp_residual_stage2 as exp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "exp_residual_stage2.py")
N, LD, DIM, B, LQ, K, N_CENT, NBITS = 512, 8, 32, 4, 4, 10, 64, 2
C = 128
EMPTY = 3                       # a doc with no valid token, candidate 0


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jx():
    """The script's function definitions, top-level and nested (round 8's
    with_computed_cand), executed with small module constants."""
    tree = ast.parse(open(SCRIPT).read())
    defs = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
            and n.name not in ("fine_res", "fine_group", "fine", "body",
                               "fn", "run")]
    ns = dict(jax=jax, jnp=jnp, np=np, NEG_INF=JAX_NEG_INF,
              decompress=jax_decompress, unpack_bits=jax_unpack_bits,
              N=N, LD=LD, DIM=DIM, B=B, LQ=LQ, K=K, N_CENT=N_CENT,
              NBITS=NBITS, PER_BYTE=8 // NBITS, PACKED=DIM * NBITS // 8)
    exec(compile(ast.Module(body=defs, type_ignores=[]), SCRIPT, "exec"), ns)
    return ns


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=True))


@pytest.fixture(scope="module")
def data():
    """numpy inputs: the script's index layout (int16 codes, residual bytes,
    bf16 scales, unit centroids and queries, the 2-bit weights), a mask
    with masked tokens and one doc with none, candidates with repeats."""
    rng = np.random.default_rng(0)
    cent = rng.normal(size=(N_CENT, DIM)).astype(np.float32)
    q = rng.normal(size=(B, LQ, DIM)).astype(np.float32)
    mask = (rng.random((N, LD)) > 0.2).astype(np.int8)
    mask[EMPTY] = 0
    cand = rng.integers(0, N, size=(B, C))
    cand[:, 0] = EMPTY
    scales = (1.0 + 0.01 * rng.normal(size=(N, LD))).astype(np.float32)
    return dict(
        q=q / np.linalg.norm(q, axis=-1, keepdims=True),
        cand=cand,
        codes=rng.integers(0, N_CENT, size=(N, LD)).astype(np.int16),
        resid=rng.integers(0, 256, size=(N, LD, DIM // 4)).astype(np.uint8),
        # bf16 values, so both sides hold the same scales
        scales=np.asarray(jnp.asarray(scales, jnp.bfloat16).astype(
            jnp.float32)),
        mask=mask,
        cent=cent / np.linalg.norm(cent, axis=-1, keepdims=True),
        weights=np.array([-0.05, -0.01, 0.01, 0.05], np.float32))


def _jax_args(d):
    return (jnp.asarray(d["q"]), jnp.asarray(d["cand"], jnp.int32),
            jnp.asarray(d["codes"]), jnp.asarray(d["resid"]),
            jnp.asarray(d["scales"], jnp.bfloat16), jnp.asarray(d["mask"]),
            jnp.asarray(d["cent"]), jnp.asarray(d["weights"]))


def _torch_args(d):
    t = lambda x: torch.from_numpy(np.array(x))   # noqa: E731
    return (t(d["q"]), t(d["cand"]).long(), t(d["codes"]), t(d["resid"]),
            t(d["scales"]).bfloat16(), t(d["mask"]), t(d["cent"]),
            t(d["weights"]))


def _close(got, want, atol=0.0, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


F32, BF16 = 1e-4, 1e-3

# variants over the separate-array index: (name, absolute tolerance)
SEPARATE = [("v_baseline", BF16), ("v_cqsplit", F32), ("v_pallas", F32),
            ("v_batched", BF16), ("v_batched_einsum", BF16)]


@pytest.mark.parametrize("name,atol", SEPARATE)
def test_variant_matches_jax(jx, data, interpret, name, atol):
    want = jx[name](*_jax_args(data))
    got = getattr(exp, name)(*_torch_args(data), k=K)
    assert tuple(got.shape) == (B, K) and got.dtype == torch.float32
    _close(got, want, atol=atol)


def test_v_gathers_and_decompress_match_jax(jx, data):
    _close(exp.v_gathers(*_torch_args(data)[:6]),
           jx["v_gathers"](*_jax_args(data)[:6]), rtol=1e-6)
    _close(exp.v_decomp_only(*_torch_args(data)),
           jx["v_decomp_only"](*_jax_args(data)), rtol=1e-5)


@pytest.fixture(scope="module")
def records(jx, data):
    """The packed records of both sides: (jax records, torch records)."""
    ja, ta = _jax_args(data), _torch_args(data)
    return (jx["make_records"](ja[2], ja[4], ja[3]),
            exp.make_records(ta[2], ta[4], ta[3]))


def test_make_records_and_split_are_bit_equal(jx, data, records):
    jrec, trec = records
    assert trec.dtype == torch.uint8
    np.testing.assert_array_equal(trec.numpy(), np.asarray(jrec))
    cand = data["cand"]
    want = jx["split_records"](jnp.take(jrec, jnp.asarray(cand), axis=0))
    got = exp.split_records(trec[torch.from_numpy(cand)], LD)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert g.dtype == {jnp.int32: torch.int32, jnp.float32: torch.float32,
                           jnp.uint8: torch.uint8}[w.dtype.type]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_split_records_sign_extends_codes_as_the_script():
    """Codes past 32767 read back negative through the script's int16
    bitcast, unsigned through ops.residual.split_records."""
    codes = torch.tensor([[40000, 5]])
    rec = exp.make_records(codes, torch.ones(1, 2), torch.zeros(
        1, 2, 1, dtype=torch.uint8))
    assert exp.split_records(rec, 2)[0].tolist() == [[40000 - 65536, 5]]
    assert exp.residual.split_records(rec, 2)[0].tolist() == [[40000, 5]]


def _rec_args(data, jx_or_torch):
    if jx_or_torch == "jax":
        a = _jax_args(data)
    else:
        a = _torch_args(data)
    return a[5], a[6], a[7]                       # mask, cent, weights


# variants over the packed records: (name, keyword arguments, tolerance)
RECORD = [("v_record_baseline", {}, BF16), ("v_record_perq", {}, BF16),
          ("v_grouped", {"g": 2}, BF16), ("v_grouped", {"g": 4}, BF16),
          ("v_grouped", {"g": 2, "sdtype": "bf16"}, BF16),
          ("v_records_batched", {}, BF16), ("v_records_perq", {}, BF16)]


@pytest.mark.parametrize("name,kw,atol", RECORD)
def test_record_variant_matches_jax(jx, data, records, interpret, name, kw,
                                    atol):
    jrec, trec = records
    jname = "v_record_perq_pallas" if name == "v_record_perq" else name
    jkw = {k: jnp.bfloat16 if v == "bf16" else v for k, v in kw.items()}
    tkw = {k: torch.bfloat16 if v == "bf16" else v for k, v in kw.items()}
    want = jx[jname](jnp.asarray(data["q"]),
                     jnp.asarray(data["cand"], jnp.int32), jrec,
                     *_rec_args(data, "jax"), **jkw)
    got = getattr(exp, name)(torch.from_numpy(data["q"]),
                             torch.from_numpy(data["cand"]), trec,
                             *_rec_args(data, "torch"), k=K, **tkw)
    assert tuple(got.shape) == (B, K)
    _close(got, want, atol=atol)


def test_record_gather_matches_jax(jx, data, records):
    jrec, trec = records
    want = jx["v_record_gather"](jnp.asarray(data["q"]),
                                 jnp.asarray(data["cand"], jnp.int32), jrec)
    got = exp.v_record_gather(torch.from_numpy(data["q"]),
                              torch.from_numpy(data["cand"]), trec, LD)
    _close(got, want, rtol=1e-6)


@pytest.mark.parametrize("stage", ["v_records_batched", "v_records_perq"])
def test_computed_candidates_match_jax(jx, data, records, stage):
    """Round 8's wrapper: candidates from the top-C of a dummy coarse
    score over bf16 doc keys."""
    jrec, trec = records
    keys = np.random.default_rng(5).normal(size=(N, DIM)).astype(np.float32)
    jkeys = jnp.asarray(keys, jnp.bfloat16)
    want = jx["with_computed_cand"](jx[stage])(
        jnp.asarray(data["q"]), jrec, *_rec_args(data, "jax"), jkeys, C)
    got = exp.with_computed_cand(getattr(exp, stage))(
        torch.from_numpy(data["q"]), trec, *_rec_args(data, "torch"),
        torch.from_numpy(np.array(jkeys.astype(jnp.float32))).bfloat16(),
        C, k=K)
    _close(got, want, atol=BF16)


# -- the kernels' plain versions --------------------------------------------

def _x1_inputs(seed=1, b=3, c=7, ld=5, lq=4, dim=16):
    rng = np.random.default_rng(seed)
    mg = (rng.random((b, c, ld)) > 0.3).astype(np.int8)
    mg[:, 2] = 0                                 # an all-masked candidate
    return dict(q=rng.normal(size=(b, lq, dim)).astype(np.float32),
                cqg=rng.normal(size=(b, c, ld, lq)).astype(np.float32),
                bits=rng.integers(0, 4, size=(b, c, ld, dim)).astype(
                    np.uint8),
                sg=rng.uniform(0.5, 1.5, size=(b, c, ld)).astype(np.float32),
                mg=mg,
                weights=np.array([-0.05, -0.01, 0.01, 0.05], np.float32))


def test_fused_lut_maxsim_plain_matches_numpy():
    a = _x1_inputs()
    w = a["weights"][a["bits"]]                                # LUT
    s = np.einsum("bcld,bqd->bclq", w.astype(np.float64), a["q"]) + a["cqg"]
    s = s * a["sg"][..., None]
    s = np.where(a["mg"][..., None] != 0, s, -9999.0)
    want = s.max(axis=2).sum(axis=-1)
    got = stage2.fused_lut_maxsim_torch(
        **{k: torch.from_numpy(v) for k, v in a.items()})
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    assert (got[:, 2] == -9999.0 * 4).all()      # C1: maxima from -inf


def test_fused_lut_maxsim_plain_matches_pallas_interpret(jx, interpret):
    """The plain version against the TPU body _fused_kernel, driven by the
    script's own pallas_call (v_pallas's tile of 32 candidates)."""
    a = _x1_inputs(b=2, c=32, ld=LD, lq=LQ, dim=DIM)
    ns = dict(jx)
    want = pl.pallas_call(
        ns["_fused_kernel"], grid=(2, 1),
        in_specs=[pl.BlockSpec((None, LQ, DIM), lambda i, j: (i, 0, 0)),
                  pl.BlockSpec((None, 32, LD, LQ), lambda i, j: (i, j, 0, 0)),
                  pl.BlockSpec((None, 32, LD, DIM),
                               lambda i, j: (i, j, 0, 0)),
                  pl.BlockSpec((None, 32, LD), lambda i, j: (i, j, 0)),
                  pl.BlockSpec((None, 32, LD), lambda i, j: (i, j, 0)),
                  pl.BlockSpec((1, 128), lambda i, j: (0, 0))],
        out_specs=pl.BlockSpec((None, 32), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((2, 32), jnp.float32),
    )(jnp.asarray(a["q"]), jnp.asarray(a["cqg"]),
      jnp.asarray(a["bits"], jnp.int32), jnp.asarray(a["sg"]),
      jnp.asarray(a["mg"], jnp.int32),
      jnp.pad(jnp.asarray(a["weights"]), (0, 124)).reshape(1, 128))
    got = stage2.fused_lut_maxsim_torch(
        **{k: torch.from_numpy(v) for k, v in a.items()})
    _close(got, want, atol=F32)


def _x2_inputs(seed=2, b=3, c=6, ld=5, lq=4, dim=16):
    rng = np.random.default_rng(seed)
    mask = (rng.random((b, c, ld)) > 0.3).astype(np.int8)
    mask[:, 1] = 0                               # an all-masked candidate
    q = rng.normal(size=(b, lq, dim)).astype(np.float32)
    tok = rng.normal(size=(b, c, ld, dim)).astype(np.float32)
    return q, tok, mask


def test_candidate_maxsim_plain_matches_numpy():
    q, tok, mask = _x2_inputs()
    qb, tb = (torch.from_numpy(x).bfloat16() for x in (q, tok))
    s = np.einsum("bcld,bqd->bclq", tb.double().numpy(), qb.double().numpy())
    s = np.where(mask[..., None] != 0, s, -9999.0)
    want = s.max(axis=2).sum(axis=-1)
    got = stage2.candidate_maxsim_torch(qb, tb, torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    assert (got[:, 1] == -9999.0 * 4).all()      # C1: maxima from -inf


@pytest.mark.parametrize("per_query", [False, True])
def test_candidate_maxsim_plain_matches_pallas_interpret(jx, interpret,
                                                         per_query):
    """X2 (maxsim_candidates_pallas, tile 128) or X3's body run once per
    query, against the plain version."""
    q, tok, mask = _x2_inputs(b=2, c=128, ld=LD, lq=LQ, dim=DIM)
    qb, tb = (jnp.asarray(x, jnp.bfloat16) for x in (q, tok))
    if per_query:
        want = jnp.stack([jx["maxsim_candidates_pallas"](
            qb[i:i + 1], tb[i:i + 1], jnp.asarray(mask[i:i + 1]))[0]
            for i in range(2)])
    else:
        want = jx["maxsim_candidates_pallas"](qb, tb, jnp.asarray(mask))
    got = stage2.candidate_maxsim(torch.from_numpy(q).bfloat16(),
                                  torch.from_numpy(tok).bfloat16(),
                                  torch.from_numpy(mask))
    _close(got, want, atol=BF16)


# -- X2's tensor-core kernel (csrc/candidate_maxsim.cu), its host side -----

ROWS = stage2.CANDIDATE_TILE_ROWS


@pytest.mark.parametrize("b", [1, 32])
@pytest.mark.parametrize("c", [200, 256, 1024])
@pytest.mark.parametrize("ld", [37, 64, 220])
def test_candidate_plan_covers_every_token_once(b, c, ld):
    """A model of the kernel's index arithmetic (block -> query and
    candidates, tile -> candidate and rows, rows past Ld dropped) covers
    every (query, candidate, token) exactly once and writes each score
    once; the query's Lq = 32 tokens fit the MMA's columns."""
    plan = stage2.candidate_plan(b, 32, c, ld)
    assert plan.cols == 32 and plan.tiles_per_cand == -(-ld // ROWS)
    ranges, tpc, cpb = plan.ranges(c), plan.tiles_per_cand, \
        plan.cands_per_block
    x = np.arange(plan.blocks(b, c))
    qb, c0 = x // ranges, x % ranges * cpb
    n_tiles = np.minimum(cpb, c - c0) * tpc                 # T of each block
    k = np.arange(cpb * tpc)
    live = k[None, :] < n_tiles[:, None]                    # (blocks, k)
    cand = c0[:, None] + k[None, :] // tpc
    row = (qb[:, None] * c + c0[:, None]) * ld \
        + (k[None, :] // tpc) * ld + k[None, :] % tpc * ROWS   # TMA rows
    l = k[None, :, None] % tpc * ROWS + np.arange(ROWS)     # token in cand
    keep = live[:, :, None] & (l < ld)
    flat = ((qb[:, None, None] * c + cand[:, :, None]) * ld + l)[keep]
    assert (flat == (row[:, :, None] + np.arange(ROWS))[keep]).all()
    assert (np.bincount(flat, minlength=b * c * ld) == 1).all()
    ends = live & (k[None, :] % tpc == tpc - 1)             # scores written
    scores = (qb[:, None] * c + cand)[ends]
    assert (np.bincount(scores, minlength=b * c) == 1).all()
    if (b, c) in ((1, 256), (32, 1024)):                    # the card's SMs
        assert plan.blocks(b, c) >= 132


@pytest.mark.parametrize("lq,cols", [(1, 16), (16, 16), (17, 32), (32, 32),
                                     (33, 64), (64, 64), (65, 128),
                                     (128, 128)])
def test_candidate_plan_columns_cover_the_query(lq, cols):
    assert stage2.candidate_plan(4, lq, 100, 64).cols == cols


def candidate_model(q, tok, mask):
    """X2 as the kernel computes it: float32 products of each candidate's
    64-row tiles with the query's columns; a row scores -9999 where masked
    and -inf past the candidate; thread (warp w, lane 4g + c) keeps the max
    over rows 16w + g and 16w + g + 8 of every tile, lanes ^4, ^8, ^16 and
    the 4 warps the max over the rest; then warp 0's lane l adds columns l,
    l + 32, .. (< Lq) in turn and the shuffle tree (lanes ^16, ^8, ^4, ^2,
    ^1) adds the lanes' sums."""
    b, c, ld, _ = tok.shape
    lq = q.shape[1]
    plan = stage2.candidate_plan(b, lq, c, ld)
    rows = plan.tiles_per_cand * ROWS
    s = torch.einsum("bcld,bqd->bclq", tok.float(), q.float())
    s = s.masked_fill(mask[..., None] == 0, -9999.0)
    s = torch.nn.functional.pad(s, (0, plan.cols - lq, 0, rows - ld),
                                value=float("-inf"))
    # row 64 j + 16 w + 8 h + g of the candidate
    s = s.reshape(b, c, plan.tiles_per_cand, 4, 2, 8, plan.cols)
    thread = s.amax(dim=(2, 4))                       # (b, c, w, g, col)
    colmax = thread.amax(dim=3).amax(dim=2)           # lanes, then warps
    lanes = torch.zeros(b, c, 32)
    for i in range(-(-plan.cols // 32)):
        for lane in range(32):
            col = 32 * i + lane
            if col < min(plan.cols, lq):
                lanes[..., lane] = lanes[..., lane] + colmax[..., col]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., [x ^ o for x in range(32)]]
    return lanes[..., 0]


@pytest.mark.parametrize("ld,lq", [(LD, LQ), (70, 33), (64, 32)])
def test_candidate_model_matches_plain_and_pallas_interpret(jx, interpret,
                                                            ld, lq):
    """The kernel's row max, mask and sum order equal candidate_maxsim_torch
    and maxsim_candidates_pallas (tile 128) in interpret mode; Ld = 70
    spans two tiles with 58 rows dropped; an all-masked candidate scores
    exactly -9999 * Lq."""
    q, tok, mask = _x2_inputs(b=2, c=128, ld=ld, lq=lq, dim=DIM)
    qb, tb = (torch.from_numpy(x).bfloat16() for x in (q, tok))
    got = candidate_model(qb, tb, torch.from_numpy(mask))
    assert torch.equal(got[:, 1], torch.full((2,), -9999.0 * lq))
    _close(got, stage2.candidate_maxsim_torch(qb, tb, torch.from_numpy(mask)),
           atol=BF16)
    want = jx["maxsim_candidates_pallas"](
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, tok)), jnp.asarray(mask))
    _close(got, want, atol=BF16)


def test_wrappers_take_the_plain_version_on_cpu():
    a = {k: torch.from_numpy(v) for k, v in _x1_inputs().items()}
    q, tok, mask = (torch.from_numpy(x) for x in _x2_inputs())
    before = (stage2.fused_lut_maxsim.launches,
              stage2.candidate_maxsim.launches)
    assert torch.equal(stage2.fused_lut_maxsim(**a),
                       stage2.fused_lut_maxsim_torch(**a))
    assert torch.equal(stage2.candidate_maxsim(q, tok, mask),
                       stage2.candidate_maxsim_torch(q, tok, mask))
    assert (stage2.fused_lut_maxsim.launches,
            stage2.candidate_maxsim.launches) == before


def test_wrappers_raise_on_other_devices():
    a = {k: torch.from_numpy(v).to("meta") for k, v in _x1_inputs().items()}
    with pytest.raises(ValueError, match="unsupported device"):
        stage2.fused_lut_maxsim(**a)
    q, tok, mask = (torch.from_numpy(x).to("meta") for x in _x2_inputs())
    with pytest.raises(ValueError, match="unsupported device"):
        stage2.candidate_maxsim(q, tok, mask)


# -- the experiment as a whole, on the CPU at a tiny size ----------------------

TINY = dict(n=600, ld=8, dim=32, b=32, lq=4, k=5, n_cent=64, cands=(16, 40),
            n_big=900, iters=1, device="cpu")
ROUND_LINES = {
    1: ["gathers_C16", "decompress_C40", "baseline_C16", "cqsplit_C40",
        "pallas_C16", "pallas_C40"],
    2: ["batched_pallas_C16", "batched_pallas_C40"],
    3: ["record_gather_C16", "record_baseline_C40", "record_perq_pallas_C16",
        "record_perq_pallas_C40"],
    4: ["grouped4_f32_C16", "grouped8_f32_C40", "grouped32_f32_C16",
        "grouped4_bf16_C40"],
    5: ["batched_einsum_sepgather_C16", "batched_einsum_sepgather_C40",
        "grouped32_records_C16"],
    6: ["grouped32_records_C40", "grouped32_records_bf16_C40"],
    7: ["1M_records_gather_C16", "1M_records_batched_C40",
        "1M_records_perq_C16"],
    8: ["computedcand_batched_C16", "computedcand_perq_C40"],
}
ROUND_REL = {1: {"baseline-vs-cqsplit", "baseline-vs-pallas"},
             2: {"baseline-vs-batched"},
             3: {"baseline-vs-record", "baseline-vs-perq-pallas"},
             4: {"baseline-vs-grouped4", "baseline-vs-grouped4-bf16"},
             5: {"baseline-vs-batched-einsum"}, 6: {"baseline-vs-g32-bf16"},
             7: set(), 8: set()}


@pytest.mark.parametrize("rnd", sorted(ROUND_LINES))
def test_run_round_on_cpu(rnd, capsys):
    report = exp.run(rounds=(rnd,), **TINY)
    out = capsys.readouterr().out
    assert set(ROUND_LINES[rnd]) <= set(report["times"])
    for name, ms in report["times"].items():
        assert ms > 0 and f"{name}: " in out and " ms/batch (" in out
    assert set(report["rel_err"]) == ROUND_REL[rnd]
    for name, v in report["rel_err"].items():
        assert np.isfinite(v) and f"{name} max rel err: " in out
    # CPU tensors take the plain versions: no launch, and each kernel
    # route equals its plain twin
    assert report["launches"] == {"X1": 0, "X2": 0, "X3": 0}
    calls = {1: ("X1", 2 * 2 + 1), 2: ("X2", 2 * 2 + 1),
             3: ("X3", (2 * 2 + 1) * 32)}
    for x, n in report["expected_launches"].items():
        assert n == (calls[rnd][1] if calls.get(rnd, (None,))[0] == x else 0)
    assert all(e == 0.0 for e in report["twin_err"].values())
    assert set(report["twin_err"]) == ({calls[rnd][0]} if rnd in calls
                                       else set())


def test_experiment_cli_refuses_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    with pytest.raises(SystemExit, match="CUDA GPU"):
        exp.main(["--rounds", "1"])
