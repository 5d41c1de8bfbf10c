"""Parity of the port's attention (repro_torch.kernels.ref and the dispatch
in kernels.ops) with the JAX package on the CPU: the plain versions of the
flash and decode kernels against the reference's oracles and its Pallas
kernels run in interpret mode.

Inputs are drawn with numpy from a seed and handed to both packages; bf16
inputs are rounded from the same float32 draws by both.  Tolerances are
those of tests/test_kernels.py: 2e-3 in float32, 2e-2 in bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jdecode
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import ops, ref

# the oracles jitted (one compile per case instead of one per eager op)
naive = jax.jit(jref.attention_naive, static_argnames=("causal", "window"))
chunked = jax.jit(jref.flash_attention_ref,
                  static_argnames=("causal", "window", "q_chunk", "kv_chunk"))
decode_xla = jax.jit(jref.decode_attention_xla, static_argnames=("window",))
decode_chunked = jax.jit(jref.decode_attention_ref,
                         static_argnames=("window", "kv_chunk"))

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bf16" \
        else dict(rtol=2e-3, atol=2e-3)


def _inputs(seed, dtype, *shapes):
    """The same draws as JAX arrays and as torch tensors, in ``dtype``."""
    rs = np.random.RandomState(seed)
    jd, td = DTYPES[dtype]
    arrs = [rs.randn(*s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))


# (B, S, H, Hkv, D, q_block, kv_block): a subset of tests/test_kernels.py
SHAPES = {
    "mha": (1, 128, 4, 4, 64, 64, 64),
    "gqa4": (2, 256, 8, 2, 64, 128, 64),
    "mqa_d128": (1, 512, 4, 1, 128, 128, 256),
}
MASKS = {"causal": (True, 0), "full": (False, 0), "window64": (True, 64)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mask", MASKS)
def test_flash_plain_matches_oracles(dtype, shape, mask):
    B, S, H, Hkv, D, _, _ = SHAPES[shape]
    causal, window = MASKS[mask]
    (jq, jk, jv), (q, k, v) = _inputs(42, dtype, (B, S, H, D),
                                      (B, S, Hkv, D), (B, S, Hkv, D))
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    want = naive(jq, jk, jv, causal=causal, window=window)
    _close(got, want, dtype)
    # the port's own naive version agrees too
    _close(ref.attention_naive(q, k, v, causal=causal, window=window), want,
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_plain_matches_jax_chunked_ref(dtype):
    B, S, H, Hkv, D, _, _ = SHAPES["gqa4"]
    (jq, jk, jv), (q, k, v) = _inputs(8, dtype, (B, S, H, D),
                                      (B, S, Hkv, D), (B, S, Hkv, D))
    for causal, window in ((True, 0), (True, 64)):
        want = chunked(jq, jk, jv, causal=causal,
                                        window=window, q_chunk=64,
                                        kv_chunk=128)
        _close(ops.flash_attention(q, k, v, causal=causal, window=window),
               want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,mask", [("mha", "causal"),
                                        ("gqa4", "window64"),
                                        ("mqa_d128", "full")])
def test_flash_plain_matches_pallas_interpret(dtype, shape, mask):
    B, S, H, Hkv, D, qb, kb = SHAPES[shape]
    causal, window = MASKS[mask]
    (jq, jk, jv), (q, k, v) = _inputs(7, dtype, (B, S, H, D),
                                      (B, S, Hkv, D), (B, S, Hkv, D))
    want = jflash(jq, jk, jv, causal=causal, window=window, q_block=qb,
                  kv_block=kb, interpret=True)
    _close(ops.flash_attention(q, k, v, causal=causal, window=window,
                               impl="torch"), want, dtype)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 48), (False, 48)])
def test_flash_plain_right_aligned_queries(causal, window):
    """S < Skv: query i sits at position i + Skv - S (prefill with
    history), GQA 4:1."""
    (jq, jk, jv), (q, k, v) = _inputs(3, "f32", (2, 64, 8, 32),
                                      (2, 192, 2, 32), (2, 192, 2, 32))
    want = naive(jq, jk, jv, causal=causal, window=window)
    _close(ops.flash_attention(q, k, v, causal=causal, window=window), want,
           "f32")


@pytest.mark.parametrize("S,q_chunk,kv_chunk", [(100, 32, 48), (37, 512, 512),
                                                (1, 16, 16)])
def test_flash_plain_ragged_lengths(S, q_chunk, kv_chunk):
    """No length needs to be a multiple of a chunk (serving prompts are
    not): the last chunk is ragged."""
    (jq, jk, jv), (q, k, v) = _inputs(11, "f32", (2, S, 6, 32),
                                      (2, S, 2, 32), (2, S, 2, 32))
    for causal, window in ((True, 0), (True, 20), (False, 0)):
        want = naive(jq, jk, jv, causal=causal, window=window)
        _close(ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_chunk=q_chunk, kv_chunk=kv_chunk),
               want, "f32")


# (B, H, Hkv, D, Smax, kv_block): tests/test_kernels.py's decode shapes
DECODE_SHAPES = {
    "mha": (2, 4, 4, 64, 512, 128),
    "gqa4": (3, 8, 2, 64, 1024, 256),
    "mqa_d128": (1, 8, 1, 128, 2048, 512),
}


def _decode_inputs(seed, dtype, B, H, Hkv, D, Smax):
    (jq, jk, jv), (q, k, v) = _inputs(seed, dtype, (B, 1, H, D),
                                      (B, Smax, Hkv, D), (B, Smax, Hkv, D))
    lens = np.random.RandomState(seed).randint(1, Smax + 1, (B,))
    return ((jq, jk, jv, jnp.asarray(lens, jnp.int32)),
            (q, k, v, torch.from_numpy(lens).to(torch.int32)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("window", [0, 100])
def test_decode_plain_matches_oracles(dtype, shape, window):
    B, H, Hkv, D, Smax, _ = DECODE_SHAPES[shape]
    jargs, targs = _decode_inputs(3, dtype, B, H, Hkv, D, Smax)
    got = ops.decode_attention(*targs, window=window)
    assert got.dtype == targs[0].dtype and got.shape == (B, 1, H, D)
    _close(got, decode_xla(*jargs, window=window), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_plain_matches_jax_chunked_ref(dtype):
    jargs, targs = _decode_inputs(4, dtype, *DECODE_SHAPES["gqa4"][:5])
    for window in (0, 100):
        _close(ops.decode_attention(*targs, window=window),
               decode_chunked(*jargs, window=window), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [0, 256])
def test_decode_plain_matches_pallas_interpret(dtype, window):
    B, H, Hkv, D, Smax, kb = DECODE_SHAPES["gqa4"]
    jargs, targs = _decode_inputs(5, dtype, B, H, Hkv, D, Smax)
    want = jdecode(*jargs, window=window, kv_block=kb, interpret=True)
    _close(ops.decode_attention(*targs, window=window, impl="torch"), want,
           dtype)


def test_decode_plain_ragged_cache_length():
    """Smax need not be a multiple of the chunk (the serving cache is
    prompt + generated tokens long)."""
    jargs, targs = _decode_inputs(9, "f32", 3, 8, 2, 32, 1088)
    want = decode_xla(*jargs)
    _close(ref.decode_attention_ref(*targs, kv_chunk=1024), want, "f32")
    _close(ref.decode_attention_ref(*targs, kv_chunk=100), want, "f32")
