"""The decode kernel's partial mode and the slice merge
(``kernels/ref.py:decode_attention_partial_ref``, ``merge_partials``,
``decode_attention_xla``; ``kernels/ops.py:decode_attention_partial``;
``kernels/attention.py:decode_attention_partial`` on ``meta``), held on the
CPU against the reference's model-path decode
(``repro.kernels.ref.decode_attention_xla``) and its kernel oracle
(``repro.kernels.ref.decode_attention_ref``).

A cache of Smax positions is cut into 1, 2 or 4 slices along its sequence,
as a ``kv_seq``-sharded cache is over the ``model`` axis; each slice's
partial (o, m, l) is computed from its global start, and the merge must
give the whole cache's decode.  Sequence lengths are ragged, so some slices
hold no live key.  The kernel itself runs on the card
(``tests/test_torch_cuda.py``)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import attention as ak
from repro_torch.kernels import ops, ref
from repro_torch.launch import cost

SMAX = 48
LENS = (48, 7, 30)          # ragged: the 7-key sequence leaves slices empty
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(G, D, dtype="float32", hkv=2, seed=0, lens=LENS):
    rng = np.random.default_rng(seed)
    B, H = len(lens), hkv * G
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, SMAX, hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, SMAX, hkv, D)).astype(np.float32)
    tdt = getattr(torch, dtype)
    t = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    return t, np.asarray(lens, np.int32)


def _merged(q, k, v, kv_len, slices, window):
    """The slices' partials (plain version) merged."""
    n = SMAX // slices
    parts = [ref.decode_attention_partial_ref(
        q, k[:, r * n:(r + 1) * n], v[:, r * n:(r + 1) * n], kv_len,
        start=r * n, window=window) for r in range(slices)]
    o, m, l = (torch.stack(x) for x in zip(*parts))
    return ref.merge_partials(m, l, o)


def _jax(t):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


@functools.lru_cache(maxsize=None)
def _reference(G, D, window):
    """The reference's two decodes of the whole cache (slices share it)."""
    (q, k, v), lens = _inputs(G, D)
    return [np.asarray(oracle(_jax(q), _jax(k), _jax(v), jnp.asarray(lens),
                              window=window))
            for oracle in (jref.decode_attention_xla,
                           jref.decode_attention_ref)]


@pytest.mark.parametrize("window", [0, 5], ids=["full", "window5"])
@pytest.mark.parametrize("slices", [1, 2, 4])
@pytest.mark.parametrize("D", [32, 64, 128, 160])
@pytest.mark.parametrize("G", [1, 4, 16])
def test_merged_slices_match_the_reference(G, D, slices, window):
    (q, k, v), lens = _inputs(G, D)
    kv_len = torch.from_numpy(lens)
    got = _merged(q, k, v, kv_len, slices, window)
    for want in _reference(G, D, window):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=TOL["float32"])
    # the port's own whole-cache forms agree too
    for whole in (ref.decode_attention_xla(q, k, v, kv_len, window=window),
                  ref.decode_attention_ref(q, k, v, kv_len, window=window)):
        np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0,
                                   atol=TOL["float32"])


@pytest.mark.parametrize("slices", [1, 2, 4])
@pytest.mark.parametrize("G,D", [(4, 128), (16, 64), (1, 160)])
def test_merged_slices_in_bf16(G, D, slices):
    (q, k, v), lens = _inputs(G, D, "bfloat16", seed=1)
    got = _merged(q, k, v, torch.from_numpy(lens), slices, 5).to(q.dtype)
    want = np.asarray(jref.decode_attention_xla(
        _jax(q), _jax(k), _jax(v), jnp.asarray(lens), window=5
    ).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=TOL["bfloat16"])


def test_an_empty_slice_is_minus_inf_zero_zero():
    """A slice past a sequence's length: m = -inf, l = 0, o = 0."""
    (q, k, v), _ = _inputs(4, 32)
    kv_len = torch.tensor([12, 40, 3], dtype=torch.int32)
    o, m, l = ref.decode_attention_partial_ref(
        q, k[:, 24:], v[:, 24:], kv_len, start=24)
    assert torch.isneginf(m[0]).all() and torch.isneginf(m[2]).all()
    assert (l[0] == 0).all() and (l[2] == 0).all()
    assert (o[0] == 0).all() and (o[2] == 0).all()
    assert torch.isfinite(m[1]).all() and (l[1] > 0).all()
    # a window that ends before the slice empties it as well
    o, m, l = ref.decode_attention_partial_ref(
        q, k[:, :8], v[:, :8], kv_len.new_tensor([40, 40, 40]), start=0,
        window=4)
    assert torch.isneginf(m).all() and (l == 0).all() and (o == 0).all()


def test_merge_of_only_empty_slices_is_zero_not_nan():
    (q, k, v), _ = _inputs(4, 64)
    kv_len = torch.tensor([0, 5, 0], dtype=torch.int32)
    out = _merged(q, k, v, kv_len, 4, 0)
    assert torch.isfinite(out).all()
    assert (out[0] == 0).all() and (out[2] == 0).all()
    want = ref.decode_attention_ref(q, k, v, kv_len)[1]
    torch.testing.assert_close(out[1], want.float(), rtol=0, atol=1e-5)


def test_merge_of_one_slice_is_its_normalised_output():
    (q, k, v), lens = _inputs(4, 32)
    o, m, l = ref.decode_attention_partial_ref(q, k, v,
                                               torch.from_numpy(lens),
                                               start=0)
    got = ref.merge_partials(m[None], l[None], o[None])
    torch.testing.assert_close(got, o / l[:, None, :, None], rtol=0,
                               atol=1e-7)


def test_ops_partial_dispatch_on_the_cpu():
    (q, k, v), lens = _inputs(4, 64)
    kv_len = torch.from_numpy(lens)
    want = ref.decode_attention_partial_ref(q, k[:, 16:], v[:, 16:], kv_len,
                                            start=16, window=9)
    before = ops.launch_counts()["decode_attention_partial"]
    got = ops.decode_attention_partial(q, k[:, 16:].contiguous(),
                                       v[:, 16:].contiguous(), kv_len,
                                       start=16, window=9)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ops.launch_counts()["decode_attention_partial"] == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.decode_attention_partial(q, k, v, kv_len, start=0, impl="cuda")


def test_partial_launcher_checks_on_meta():
    q = torch.empty(3, 1, 8, 128, dtype=torch.bfloat16, device="meta")
    k = torch.empty(3, 272, 2, 128, dtype=torch.bfloat16, device="meta")
    kv_len = torch.empty(3, dtype=torch.int32, device="meta")
    o, m, l = ak.decode_attention_partial(q, k, k, kv_len, start=272)
    assert o.shape == (3, 1, 8, 128) and o.dtype == torch.float32
    assert m.shape == l.shape == (3, 8) and m.dtype == torch.float32
    with pytest.raises(ValueError, match="start"):
        ak.decode_attention_partial(q, k, k, kv_len, start=-1)
    bad = torch.empty(3, 1, 8, 48, dtype=torch.bfloat16, device="meta")
    kb = torch.empty(3, 272, 2, 48, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="head_dim"):
        ak.decode_attention_partial(bad, kb, kb, kv_len, start=0)


def test_partial_counted_under_the_count_mode():
    """On meta under the count a partial launch records the slice's work:
    its live keys are the whole cache's clipped to the slice."""
    def step(q, k, v, kv_len):
        return ops.decode_attention_partial(q, k, v, kv_len, start=272)
    args = (torch.empty(4, 1, 32, 128, dtype=torch.bfloat16, device="meta"),
            torch.empty(4, 272, 8, 128, dtype=torch.bfloat16, device="meta"),
            torch.empty(4, 272, 8, 128, dtype=torch.bfloat16, device="meta"),
            torch.empty(4, dtype=torch.int32, device="meta"))
    counted = cost.count(step, *args)
    rec = counted["kernels"]["decode_attention_partial"]
    nbytes, flops, _ = cost.decode_partial_work(4, 272, 32, 8, 128, 0,
                                                [544] * 4, 272, "bfloat16")
    assert rec["launches"] == 1 and rec["flops"] == flops
    assert rec["bytes"] == nbytes


@pytest.mark.parametrize("window", [0, 100])
def test_slices_add_up_to_the_whole_cache_work(window):
    """The slices' live keys sum to the whole cache's (decode_work)."""
    lens, Smax = [1088, 700, 1, 300], 1088
    for slices in (1, 2, 4):
        n = Smax // slices
        live = sum(cost.slice_live(lens, window, r * n, n)
                   for r in range(slices))
        whole = cost.decode_work(4, Smax, 32, 8, 128, window, lens,
                                 "bfloat16")[1] / (4.0 * 128 * 32)
        assert live == whole
