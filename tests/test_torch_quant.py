"""ravqa_tpu_torch.ops.quant against ravqa_tpu.ops.quant.

The int8 codes and the scales must be bit-equal to the JAX package's on
the same numpy inputs (tolerance: none). Both upcast to float32, take the
absolute maximum, scale it by 1/127 and round half to even. The JAX
quantizers run jitted, as the JAX package runs them (quantize_queries_int8
inside the jitted coarse sweep): jit turns their division by 127 into a
multiplication by the float32 reciprocal, which the port reproduces.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ravqa_tpu.ops import quant as jax_quant
from ravqa_tpu_torch.ops import quant as torch_quant


def _inputs(shape, dtype, seed=0):
    """Random values plus rows that hit the rounding edge cases: exact
    halves (absmax 127 gives scale 1) and all-zero rows (eps scale)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[0, :6] = [127.0, 2.5, 3.5, -2.5, -0.5, 126.5]
    flat[0, 6:] = 0.0
    flat[1] = 0.0
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    return x


def _assert_bit_equal(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == {np.dtype(np.int8): torch.int8,
                           np.dtype(np.float32): torch.float32}[w.dtype]
        np.testing.assert_array_equal(g.numpy(), w)


def _torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).bfloat16()
    return torch.from_numpy(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_summaries_t_int8_bit_equal(dtype):
    x = _inputs((3, 40, 16), dtype)                    # (S, N, dim)
    want = jax_quant.quantize_summaries_t_int8(jnp.asarray(x))
    got = torch_quant.quantize_summaries_t_int8(_torch(x))
    _assert_bit_equal(got, want)
    # a slot-major view of doc-major summaries quantizes the same, into
    # contiguous codes (the coarse-sweep kernel takes them so)
    doc_major = _torch(np.ascontiguousarray(np.swapaxes(x, 0, 1)))
    codes, scales = torch_quant.quantize_summaries_t_int8(
        doc_major.transpose(0, 1))
    assert codes.is_contiguous()
    _assert_bit_equal((codes, scales), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_summaries_int8_bit_equal(dtype):
    x = _inputs((40, 3, 16), dtype)                    # (N, S, dim)
    want = jax_quant.quantize_summaries_int8(jnp.asarray(x))
    got = torch_quant.quantize_summaries_int8(_torch(x))
    _assert_bit_equal(got, want)


def test_quantize_queries_int8_bit_equal():
    x = _inputs((4, 9, 16), "float32")                 # (B, Lq, dim)
    x[2, -3:] = 0.0                                    # zero query rows
    want = jax.jit(jax_quant.quantize_queries_int8)(jnp.asarray(x))
    got = torch_quant.quantize_queries_int8(torch.from_numpy(x))
    _assert_bit_equal(got, want)
    assert (got[0][2, -3:] == 0).all()
    # round half to even: 2.5 -> 2, 3.5 -> 4, -2.5 -> -2, -0.5 -> 0
    assert got[0][0, 0, :6].tolist() == [127, 2, 4, -2, 0, 126]


# -- the int8 token index and its exact search (K5) --------------------------

def _index(dtype, seed=1, n=32, ld=12, dim=16):
    rng = np.random.default_rng(seed)
    tok = _inputs((n, ld, dim), dtype, seed)
    mask = (rng.random((n, ld)) > 0.3).astype(np.float32)
    mask[5] = 0                                        # a doc with no token
    return tok, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_index_int8_bit_equal(dtype):
    tok, mask = _index(dtype)
    want = jax_quant.quantize_index_int8(jnp.asarray(tok), jnp.asarray(mask))
    got = torch_quant.quantize_index_int8(_torch(tok), torch.from_numpy(mask),
                                          chunk=7)       # ragged chunks
    _assert_bit_equal(got, want)
    assert (got[0][5] == 0).all() and (got[1][5] == 0).all()
    np.testing.assert_array_equal(
        torch_quant.dequantize_int8(*got).numpy(),
        np.asarray(jax_quant.dequantize_int8(*want)))


def _int8_search_inputs(seed=2, b=3, lq=5):
    tok, mask = _index("float32", seed)
    tok /= np.maximum(np.linalg.norm(tok, axis=-1, keepdims=True), 1e-6)
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, tok.shape[-1])).astype(np.float32)
    q[1, -1] = 0.0                                     # a zero query row
    q[2] = -np.abs(q[2])                               # mostly negative
    d8, ds = jax_quant.quantize_index_int8(jnp.asarray(tok),
                                           jnp.asarray(mask))
    return q, mask, d8, ds


def test_maxsim_search_int8_plain_matches_pallas_interpret():
    """K5's plain version (quantized queries) against the TPU kernel in
    interpret mode. Both take the same int32 dot products, exact in
    float32; rtol 1e-6 covers the float32 sum over Lq in another order."""
    from jax.experimental.pallas import tpu as pltpu
    q, _, d8, ds = _int8_search_inputs()
    q8, qs = jax.jit(jax_quant.quantize_queries_int8)(jnp.asarray(q))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_quant.maxsim_search_int8_pallas(q8, qs, d8, ds,
                                                              tile_d=8))
    args = [torch.from_numpy(np.array(x)) for x in (q8, qs, d8, ds)]
    before = torch_quant.maxsim_search_int8.launches
    got = torch_quant.maxsim_search_int8(*args)
    assert torch_quant.maxsim_search_int8.launches == before   # CPU: plain
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    # the doc with no valid token: -9999 times each query token's scale
    np.testing.assert_allclose(got.numpy()[:, 5],
                               -9999.0 * np.asarray(qs).sum(1), rtol=1e-6)


def test_maxsim_search_int8_torch_matches_xla():
    """The float-query twin against maxsim_search_int8_xla: float32
    products of the same values, summed in another order (rtol 1e-5,
    atol 1e-4 * Lq)."""
    q, mask, d8, ds = _int8_search_inputs(seed=3)
    want = np.asarray(jax_quant.maxsim_search_int8_xla(
        jnp.asarray(q), d8, ds, jnp.asarray(mask)))
    got = torch_quant.maxsim_search_int8_torch(
        torch.from_numpy(q), torch.from_numpy(np.array(d8)),
        torch.from_numpy(np.array(ds)), torch.from_numpy(mask),
        max_chunk_elems=500)                           # several doc chunks
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-4 * q.shape[1])


def test_k5_epilogue_converts_int32_exactly_with_adds():
    """csrc/maxsim_int8.cu turns each int32 dot product s into a float as
    bits(s + 0x4B400000) - 1.5 * 2^23 (two full-rate adds, no conversion
    instruction). Exact for |s| < 2^22, which holds: |s| <= dim * 128^2
    = 2^21 at dim 128."""
    rng = np.random.default_rng(4)
    s = np.concatenate([np.arange(-2 ** 21, 2 ** 21 + 1, 4099),
                        [-2 ** 22, -2 ** 21, -1, 0, 1, 2 ** 21, 2 ** 22 - 1],
                        rng.integers(-2 ** 22, 2 ** 22, 10_000)]).astype(
        np.int32)
    conv = (s + np.int32(0x4B400000)).view(np.float32) \
        - np.float32(12582912.0)
    np.testing.assert_array_equal(conv, s.astype(np.float32))


def test_maxsim_search_int8_unit_scales_equal_pallas_exactly():
    """With unit query and doc scales (0 kept on masked tokens) the plain K5
    sums int32 maxima, all below 2^24: it equals the TPU kernel in
    interpret mode bit for bit, as the card test holds the CUDA kernel to
    the plain version."""
    from jax.experimental.pallas import tpu as pltpu
    q, _, d8, ds = _int8_search_inputs(seed=5)
    q8, qs = jax.jit(jax_quant.quantize_queries_int8)(jnp.asarray(q))
    ones_q = jnp.ones_like(qs)
    unit_d = (ds > 0).astype(jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_quant.maxsim_search_int8_pallas(
            q8, ones_q, d8, unit_d, tile_d=8))
    got = torch_quant.maxsim_search_int8(
        *[torch.from_numpy(np.array(x)) for x in (q8, ones_q, d8, unit_d)])
    assert np.abs(want).max() < 2 ** 24
    np.testing.assert_array_equal(got.numpy(), want)
