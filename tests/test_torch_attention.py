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


@pytest.mark.parametrize("Skv", [64, 1])
def test_flash_plain_fewer_keys_than_queries(Skv):
    """Skv < S without a causal mask or a window (cross-attention to fewer
    media tokens than text tokens): every query sees every key, as in the
    oracle."""
    (jq, jk, jv), (q, k, v) = _inputs(4, "f32", (2, 192, 8, 32),
                                      (2, Skv, 2, 32), (2, Skv, 2, 32))
    want = naive(jq, jk, jv, causal=False, window=0)
    _close(ops.flash_attention(q, k, v, causal=False, window=0), want, "f32")


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


# ---------------------------------------------------------------------------
# The CUDA kernels' launch geometry (kernels/attention.py), checked here
# because the card's kernels compute the same formulas from the same inputs
# ---------------------------------------------------------------------------

from repro_torch.kernels import attention as ak  # noqa: E402

# (Smax, window, kv_len): tests/test_torch_cuda.py's ragged and window
# decode cases and the serving caches (nemo: no window; zamba2: a window
# larger than the cache)
SPLIT_CASES = {
    "ragged": (1088, 0, (1025, 1088, 1, 530)),
    "window": (1088, 256, (1088, 700, 256, 3)),
    "window_one_block": (1088, 1, (1088, 700, 5, 1)),
    "zamba2": (1088, 4096, (1088,) * 4),
    "d32_g2": (300, 0, (17, 300)),
}


@pytest.mark.parametrize("case", SPLIT_CASES)
@pytest.mark.parametrize("lens", ["case", "one", "full"])
@pytest.mark.parametrize("pairs", [1, 32, 128])
def test_decode_split_covers_live_keys_once(case, lens, pairs):
    """The cluster's blocks read every live key exactly once and no key
    outside [kv_len - window, kv_len)."""
    Smax, window, case_lens = SPLIT_CASES[case]
    kv_lens = {"case": case_lens, "one": (1,), "full": (Smax,)}[lens]
    n = ak.decode_blocks(Smax, window, pairs)
    assert 1 <= n <= ak.DECODE_MAX_BLOCKS
    for kv_len in kv_lens:
        lo = max(0, kv_len - window) if window else 0
        read = np.zeros(Smax, np.int64)
        ranges = ak.decode_block_ranges(kv_len, Smax, window, n)
        for j0, j1 in ranges:
            assert j0 <= j1
            read[j0:j1] += 1
        want = np.zeros(Smax, np.int64)
        want[lo:min(kv_len, Smax)] = 1
        np.testing.assert_array_equal(read, want)
        # blocks split the live range evenly: sizes differ by at most one
        sizes = [j1 - j0 for j0, j1 in ranges]
        assert max(sizes) - min(sizes) <= 1


def test_decode_blocks_at_serving_shapes():
    """nemo (B * Hkv = 32 clusters): 8 blocks each, 256 blocks; zamba2
    (128 clusters): 3 each, 384 blocks, both at least two per SM of 132;
    short caches and windows take fewer."""
    assert ak.decode_blocks(1088, 0, 32) == 8
    assert ak.decode_blocks(1088, 4096, 128) == 3
    assert ak.decode_blocks(1088, 4096, 1) == 8
    assert ak.decode_blocks(300, 0, 4) == 3
    assert ak.decode_blocks(1088, 100, 4) == 1
    assert ak.decode_blocks(16, 0, 1) == 1


FLASH_SCHEDULE_CASES = {
    "prefill": (1024, 1024, True, 0),
    "ragged": (1000, 1000, True, 0),
    "window": (1024, 1024, True, 256),
    "right_aligned": (256, 1024, False, 0),
    "zamba2": (1024, 1024, True, 4096),
    "one_query": (1, 77, True, 0),
    "skv_ragged_tile": (100, 300, True, 40),
    "full_window": (300, 300, False, 50),
    "whisper_encoder": (1500, 1500, False, 0),
    "cross_fewer_keys": (1088, 1024, False, 0),
    "cross_one_key": (300, 1, False, 0),
}


@pytest.mark.parametrize("case", FLASH_SCHEDULE_CASES)
def test_flash_schedule_covers_visible_keys(case):
    """The query tiles partition [0, S); each tile's key range holds every
    key a row of it can see and every key in it is seen by some row (no
    wholly masked tile is loaded); causal grids launch the heaviest tiles
    first."""
    S, Skv, causal, window = FLASH_SCHEDULE_CASES[case]
    sched = ak.flash_schedule(S, Skv, causal=causal, window=window)
    rows = np.zeros(S, np.int64)
    offset = Skv - S
    kpos = np.arange(Skv)
    for s0, s_end, k_beg, k_end, n_tiles in sched:
        rows[s0:s_end] += 1
        assert s_end - s0 <= ak.FLASH_BLOCK_M and n_tiles >= 1
        assert n_tiles == -(-(k_end - k_beg) // ak.FLASH_BLOCK_N)
        qpos = np.arange(s0, s_end)[:, None] + offset
        vis = np.ones((s_end - s0, Skv), bool)
        if causal:
            vis &= kpos[None] <= qpos
        if window:
            vis &= kpos[None] > qpos - window
        seen = vis.any(0)
        assert not seen[:k_beg].any() and not seen[k_end:].any()
        assert seen[k_beg:k_end].all()
    np.testing.assert_array_equal(rows, np.ones(S, np.int64))
    if causal:
        work = [n for *_, n in sched]
        assert work == sorted(work, reverse=True)


def test_flash_schedule_fewer_keys_than_queries():
    """S = 1088 queries on Skv = 1024 keys, not causal, no window (a
    negative offset): 9 query tiles, the last one first, each visiting all
    16 key tiles; a causal mask or a window there is refused."""
    sched = ak.flash_schedule(1088, 1024, causal=False, window=0)
    assert sched == [(s0, min(s0 + 128, 1088), 0, 1024, 16)
                     for s0 in range(1024, -1, -128)]
    q = torch.zeros((1, 8, 2, 32))
    kv = torch.zeros((1, 4, 2, 32))
    for kw in (dict(causal=True, window=0), dict(causal=False, window=2)):
        with pytest.raises(ValueError, match="right-aligned"):
            ak.flash_attention(q, kv, kv, **kw)


def _flash_rounded_p(q, k, v, *, causal, window, kv_chunk, split=False):
    """ref.flash_attention_ref with one change, made here: p enters the PV
    product rounded to bf16 (the float32 denominator keeps the float32 p),
    as in the Pallas kernel (flash_attention.py:78); with ``split`` as the
    pair bf16(p) + bf16(p - bf16(p)), as in the card's bf16 tensor-core
    kernel.  Returns float32, before the cast to q's dtype."""
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = q.float().reshape(B, S, Hkv, G, D) / np.sqrt(D)
    qpos = torch.arange(S) + (Skv - S)
    acc = torch.zeros_like(qf)
    m = torch.full(qf.shape[:-1], ref.NEG_INF)
    l = torch.zeros(qf.shape[:-1])
    for k0 in range(0, Skv, kv_chunk):
        kb, vb = k[:, k0:k0 + kv_chunk].float(), v[:, k0:k0 + kv_chunk]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kb)
        mask = ref._mask(qpos, torch.arange(k0, k0 + kb.shape[1]),
                         causal=causal, window=window)
        s = torch.where(mask[None, :, None, None, :], s, ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        hi = p.to(torch.bfloat16).float()
        p_used = hi + (p - hi).to(torch.bfloat16).float() if split else hi
        acc = acc * alpha[..., None] + torch.einsum(
            "bqhgk,bkhd->bqhgd", p_used, vb.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-37)
    return out.reshape(B, S, H, D)


@pytest.mark.parametrize("shape,mask", [("mha", "causal"),
                                        ("gqa4", "window64")])
def test_bf16_p_rounding_is_the_pallas_kernels(shape, mask):
    """The Pallas kernel rounds p to bf16 for PV: the plain version with
    that rounding agrees with it in interpret mode within the bf16
    tolerance, and more closely than the plain version that keeps p in
    float32."""
    B, S, H, Hkv, D, qb, kb = SHAPES[shape]
    causal, window = MASKS[mask]
    (jq, jk, jv), (q, k, v) = _inputs(13, "bf16", (B, S, H, D),
                                      (B, S, Hkv, D), (B, S, Hkv, D))
    want = np.asarray(jflash(jq, jk, jv, causal=causal, window=window,
                             q_block=qb, kv_block=kb, interpret=True),
                      np.float32)
    rounded = _flash_rounded_p(q, k, v, causal=causal, window=window,
                               kv_chunk=kb).to(q.dtype)
    _close(rounded, want, "bf16")
    kept = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   kv_chunk=kb)
    gap_rounded = np.abs(rounded.float().numpy() - want).max()
    gap_kept = np.abs(kept.float().numpy() - want).max()
    assert gap_rounded <= gap_kept


@pytest.mark.parametrize("shape,mask", [("mha", "causal"),
                                        ("gqa4", "window64"),
                                        ("mqa_d128", "full")])
def test_bf16_p_pair_keeps_float32_p(shape, mask):
    """The card's bf16 kernel feeds p to the tensor cores as the pair
    bf16(p) + bf16(p - bf16(p)): before the output's own rounding that is
    within 1e-4 of float32 p (the plain version), where bf16(p) alone
    drifts by more than ten times as much; at the output it agrees with the
    Pallas kernel within the bf16 tolerance.  Values are scaled by 64, as a
    full-width model's are, so the drift of bf16(p) shows."""
    B, S, H, Hkv, D, qb, kb = SHAPES[shape]
    causal, window = MASKS[mask]
    (jq, jk, jv), (q, k, v) = _inputs(17, "bf16", (B, S, H, D),
                                      (B, S, Hkv, D), (B, S, Hkv, D))
    kw = dict(causal=causal, window=window, kv_chunk=kb)
    pair = _flash_rounded_p(q, k, v * 64, **kw, split=True) / 64
    hi = _flash_rounded_p(q, k, v * 64, **kw, split=False) / 64
    kept = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal, window=window,
                                   kv_chunk=kb)
    gap_pair = float((pair - kept).abs().max())
    gap_hi = float((hi - kept).abs().max())
    assert gap_pair <= 1e-4 and gap_hi > 10 * gap_pair
    want = jflash(jq, jk, jv, causal=causal, window=window, q_block=qb,
                  kv_block=kb, interpret=True)
    _close(pair.to(q.dtype), want, "bf16")
