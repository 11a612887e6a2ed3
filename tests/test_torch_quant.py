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
