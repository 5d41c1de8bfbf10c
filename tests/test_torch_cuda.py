"""The CUDA kernels on the card, against their plain torch versions: the
forest kernels bitwise (and against the numpy mirror), the attention
kernels within tests/test_kernels.py's tolerances (2e-3 in float32, 2e-2
in bf16), the recurrence kernels within the scan tests' tolerances there
(y 5e-3 in float32 and 5e-2 in bf16, the float32 state 1e-3: both sides
compute in float32 from the same inputs, so the gap is summation order and
at most one rounding of y to bf16).  Marked ``cuda``; without a GPU they
skip.

    python -m pytest -q -m cuda tests/test_torch_cuda.py"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.ml import forest
from repro_torch.online.broker import PredictionBroker

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _forest(rs, T, D, F):
    return forest.ForestParams(
        feat_idx=rs.randint(0, F, (T, D)).astype(np.int32),
        thresholds=rs.randn(T, D).astype(np.float32),
        leaves=rs.randn(T, 1 << D).astype(np.float32))


# R.F.'s main-path shapes and earlier cases, then every T in {1, 24, 33, 64}
# (one row per warp up to 32 rows per warp; lanes striding over trees when
# T > 32) with every D in {1, 5, 8, 9} (D = 9 takes the run-time-D
# instance; T = 64 at D = 8 and 9 reads the model where it lies instead of
# staging it) at the scheduler's, the broker's and a fat flush's row counts
FOREST_SHAPES = [(1, 22, 24, 5), (13, 22, 1, 6), (100, 32, 64, 6),
                 (4096, 22, 24, 5)] + [
    (B, 22, T, D) for T in (1, 24, 33, 64) for D in (1, 5, 8, 9)
    for B in (1, 13, 308, 4096)]


@pytest.mark.parametrize("B,F,T,D", FOREST_SHAPES)
def test_forest_infer_kernel_bitwise(dev, B, F, T, D):
    rs = np.random.RandomState(B + 100 * T + D)
    p = _forest(rs, T, D, F)
    x = rs.randn(B, F).astype(np.float32)
    args = (torch.from_numpy(x).to(dev), *p.on(dev))
    before = ops.launch_counts()["forest_infer"]
    got = ops.forest_infer(*args)
    assert ops.launch_counts()["forest_infer"] == before + 1
    assert torch.equal(got, ops.forest_infer(*args, impl="torch"))
    assert np.array_equal(got.cpu().numpy(), forest.forest_predict_np(p, x))


# (T, D) of the models packed into one flush, cycled over the segments:
# true tree counts below the padded T; a pack over 32 trees (lanes stride)
# that is staged; one of D = 9 that is neither compiled for its depth nor
# staged
PACKS = {"rf": [(24, 5), (8, 3), (16, 4), (1, 6)],
         "wide": [(33, 5), (64, 5), (2, 1)],
         "deep": [(64, 8), (33, 9), (24, 5), (1, 9)]}


@pytest.mark.parametrize("pack", PACKS)
@pytest.mark.parametrize("sizes", [(1,), (0, 5, 0, 7), (2048, 2048),
                                   (65, 1, 5, 12), (154, 154), (0, 0, 3)])
def test_forest_infer_grouped_kernel_bitwise(dev, sizes, pack):
    rs = np.random.RandomState(len(sizes))
    shapes = PACKS[pack]
    models = [_forest(rs, *shapes[i % len(shapes)], 22)
              for i in range(len(sizes))]
    x = rs.randn(sum(sizes), 22).astype(np.float32)
    groups, at = [], 0
    for m, b in zip(models, sizes):
        groups.append((m, x[at:at + b]))
        at += b
    outs, passes = forest.forest_predict_grouped(groups, device=dev)
    assert passes == 1
    for (m, rows), out in zip(groups, outs):
        assert np.array_equal(out, forest.forest_predict_np(m, rows))
    packed = forest.pack_forests(models)
    offsets = np.zeros(len(sizes) + 1, np.int32)
    np.cumsum(sizes, out=offsets[1:])
    args = (torch.from_numpy(x).to(dev), torch.from_numpy(offsets).to(dev),
            *packed.on(dev))
    before = ops.launch_counts()["forest_infer_grouped"]
    got = ops.forest_infer_grouped(*args, impl="cuda")
    assert ops.launch_counts()["forest_infer_grouped"] == before + 1
    assert torch.equal(got, ops.forest_infer_grouped(*args, impl="torch"))


def test_forest_predict_staged_results_stay(dev):
    """The staged host path returns a new array each call: a later call
    (of another size, which grows the buffers, or the same size) leaves an
    earlier result as it was.  Two threads scoring at once each get their
    own rows' scores."""
    rs = np.random.RandomState(3)
    p, q = _forest(rs, 24, 5, 22), _forest(rs, 8, 3, 22)
    xs = [rs.rand(b, 22).astype(np.float32) for b in (13, 4096, 13, 1)]
    got = [forest.forest_predict(p, x, device=dev) for x in xs]
    grouped, _ = forest.forest_predict_grouped(
        [(p, xs[0]), (q, xs[2])], device=dev)
    again, _ = forest.forest_predict_grouped([(q, xs[1])], device=dev)
    for x, g in zip(xs, got):
        assert np.array_equal(g, forest.forest_predict_np(p, x))
    assert np.array_equal(grouped[0], forest.forest_predict_np(p, xs[0]))
    assert np.array_equal(grouped[1], forest.forest_predict_np(q, xs[2]))
    assert np.array_equal(again[0], forest.forest_predict_np(q, xs[1]))

    results = [[], []]

    def score(i):
        for j in range(50):
            x = xs[(i + j) % 4][:1 + j % 13]
            results[i].append((x, forest.forest_predict(p, x, device=dev)))

    threads = [threading.Thread(target=score, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for x, g in results[0] + results[1]:
        assert np.array_equal(g, forest.forest_predict_np(p, x))


def test_prediction_broker_two_threads(dev):
    """Two clients on their own threads behind one PredictionBroker: each
    request gets the scores of its own rows, as if scored alone."""
    rs = np.random.RandomState(4)
    models = [SimpleNamespace(params=_forest(rs, 24, 5, 22)),
              SimpleNamespace(params=_forest(rs, 8, 3, 22))]
    requests = [[[(models[(i + j) % 2],
                   rs.rand(1 + (7 * i + j) % 13, 22).astype(np.float32))]
                 for j in range(40)] for i in range(2)]
    broker = PredictionBroker(device=dev)
    broker.add_clients(2)
    got = [[None] * 40 for _ in range(2)]

    def client(i):
        try:
            for j, groups in enumerate(requests[i]):
                got[i][j] = broker.submit(groups)
        finally:
            broker.done()

    threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "broker deadlocked"
    for i in range(2):
        for j, [(model, x)] in enumerate(requests[i]):
            want = np.clip(forest.forest_predict_np(model.params, x),
                           0.0, 1.0).astype(np.float32)
            assert np.array_equal(got[i][j][0], want)
    assert broker.n_requests == 80 and broker.n_flushes > 0


def test_kernel_rejects_bad_input(dev):
    p = _forest(np.random.RandomState(0), 4, 3, 8)
    fi, th, lv = p.on(dev)
    x = torch.zeros((4, 8), device=dev)
    with pytest.raises(TypeError):
        ops.forest_infer(x.double(), fi, th, lv)
    with pytest.raises(ValueError):
        ops.forest_infer(x, fi, th, lv.cpu())
    with pytest.raises(ValueError):
        ops.forest_infer(x.t(), fi, th, lv)
    # the staged launch takes pinned host buffers that fit x's buffer
    out = torch.empty(4, device=dev)
    pinned = torch.zeros(32, pin_memory=True)
    with pytest.raises(ValueError, match="pinned"):
        ops.forest_infer(x, fi, th, lv, out=out,
                         host=(torch.zeros(32), torch.zeros(4)))
    with pytest.raises(ValueError, match="words"):
        ops.forest_infer(x, fi, th, lv, out=out,
                         host=(torch.zeros(33, pin_memory=True),
                               torch.zeros(4, pin_memory=True)))
    with pytest.raises(ValueError, match="host staging"):
        ops.forest_infer(x, fi, th, lv, impl="torch",
                         host=(pinned, torch.zeros(4, pin_memory=True)))


# the shapes of chip_smoke.py's attn_kernels phase (nemo's and zamba2's
# serving shapes among them), plus head_dim 32 (the smoke configs') with an
# odd group size, a single query and a key count that is no multiple of the
# bf16 kernel's 64-key tile
# (B, S, Skv, H, Hkv, D, causal, window)
FLASH_CASES = {
    "prefill": (4, 1024, 1024, 32, 8, 128, True, 0),
    "ragged": (4, 1000, 1000, 32, 8, 128, True, 0),
    "window": (4, 1024, 1024, 16, 4, 64, True, 256),
    "right_aligned": (4, 256, 1024, 32, 8, 128, False, 0),
    "d32_g3": (2, 200, 456, 12, 4, 32, False, 0),
    "zamba2": (4, 1024, 1024, 32, 32, 64, True, 4096),
    "one_query": (3, 1, 77, 8, 2, 128, True, 0),
    "skv_ragged_tile": (2, 100, 300, 8, 2, 64, True, 40),
    # a window narrower than the query tile at D=32: rows whose first key
    # tile is wholly masked (bf16 once wrote NaN there)
    "d32_window": (2, 100, 100, 4, 4, 32, True, 16),
    # whisper-large-v3's encoder; cross-attention to fewer keys than
    # queries (llama-3.2-vision's 1024 media tokens); qwen3-moe's group of
    # 16 query heads per kv head
    "whisper_encoder": (4, 1500, 1500, 20, 20, 64, False, 0),
    "cross_fewer_keys": (4, 1088, 1024, 64, 8, 128, False, 0),
    "group16": (4, 1024, 1024, 64, 4, 128, True, 0),
    # head_dim 160 (stablelm-12b: its prefill; a window; cross-attention to
    # fewer keys than queries; a ragged S with ragged key tiles)
    "d160_prefill": (4, 1024, 1024, 32, 8, 160, True, 0),
    "d160_window": (2, 300, 300, 8, 2, 160, True, 100),
    "d160_cross_fewer_keys": (2, 300, 200, 8, 2, 160, False, 0),
    "d160_ragged": (3, 1000, 1000, 12, 4, 160, True, 0),
    "d160_right_aligned": (2, 100, 333, 8, 8, 160, True, 0),
}
# (B, Smax, H, Hkv, D, window, kv_len); "one_key" and "window_one_block"
# leave every cluster block but one without a key
DECODE_CASES = {
    "serve": (4, 1088, 32, 8, 128, 0, (1088,) * 4),
    "ragged": (4, 1088, 32, 8, 128, 0, (1025, 1088, 1, 530)),
    "window": (4, 1088, 32, 8, 128, 256, (1088, 700, 256, 3)),
    "d32_g2": (2, 300, 4, 2, 32, 0, (17, 300)),
    "zamba2": (4, 1088, 32, 32, 64, 4096, (1088,) * 4),
    "one_key": (4, 1088, 32, 8, 128, 0, (1, 1, 1, 1)),
    "window_one_block": (4, 1088, 32, 8, 128, 1, (1088, 700, 5, 1)),
    # qwen3-moe's group of 16 (DECODE_MAX_GROUP); whisper's static cross
    # cache of 1500 encoder frames, every row live
    "group16": (4, 1088, 64, 4, 128, 0, (1088, 700, 1, 530)),
    "cross_static": (4, 1500, 20, 20, 64, 0, (1500,) * 4),
    # head_dim 160 in each group bucket (1, 4 with G = 4 and G = 3, 16),
    # ragged kv_len and windows; "d160_serve" is stablelm-12b's last step
    "d160_serve": (4, 1088, 32, 8, 160, 0, (1088,) * 4),
    "d160_g1": (3, 1088, 8, 8, 160, 0, (1088, 5, 777)),
    "d160_g1_window": (3, 1088, 8, 8, 160, 64, (1088, 5, 777)),
    "d160_g4": (4, 1088, 32, 8, 160, 0, (1025, 1088, 1, 530)),
    "d160_g4_window": (4, 1088, 32, 8, 160, 256, (1088, 700, 256, 3)),
    "d160_g3_window": (2, 300, 6, 2, 160, 50, (300, 17)),
    "d160_g16": (4, 1088, 64, 4, 160, 0, (1088, 700, 1, 530)),
    "d160_g16_window": (4, 1088, 64, 4, 160, 128, (1088, 700, 1, 530)),
}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bf16" \
        else dict(rtol=2e-3, atol=2e-3)


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(DTYPES[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_kernel(dev, case, dtype):
    B, S, Skv, H, Hkv, D, causal, window = FLASH_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(0)
    q = _randn(gen, (B, S, H, D), dtype, dev)
    k = _randn(gen, (B, Skv, Hkv, D), dtype, dev)
    v = _randn(gen, (B, Skv, Hkv, D), dtype, dev)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = ops.flash_attention(q, k, v, causal=causal, window=window,
                               impl="torch")
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_kernel(dev, case, dtype):
    B, Smax, H, Hkv, D, window, lens = DECODE_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(1)
    q = _randn(gen, (B, 1, H, D), dtype, dev)
    k = _randn(gen, (B, Smax, Hkv, D), dtype, dev)
    v = _randn(gen, (B, Smax, Hkv, D), dtype, dev)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = ops.launch_counts()["decode_attention"]
    got = ops.decode_attention(q, k, v, kv_len, window=window)
    assert ops.launch_counts()["decode_attention"] == before + 1
    want = ops.decode_attention(q, k, v, kv_len, window=window, impl="torch")
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


def test_decode_attention_back_to_back(dev):
    """Two calls in a row on the same caches with different live lengths
    each give the plain version's answer: nothing of one call's clusters
    survives into the next."""
    gen = torch.Generator(device=dev).manual_seed(2)
    B, Smax, H, Hkv, D = 4, 1088, 32, 8, 128
    q = _randn(gen, (B, 1, H, D), "bf16", dev)
    k = _randn(gen, (B, Smax, Hkv, D), "bf16", dev)
    v = _randn(gen, (B, Smax, Hkv, D), "bf16", dev)
    first = torch.tensor((1088, 3, 700, 64), dtype=torch.int32, device=dev)
    second = torch.tensor((5, 1088, 1, 999), dtype=torch.int32, device=dev)
    got1 = ops.decode_attention(q, k, v, first)
    got2 = ops.decode_attention(q, k, v, second)
    for got, lens in ((got1, first), (got2, second)):
        want = ops.decode_attention(q, k, v, lens, impl="torch")
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **_tol("bf16"))


def test_attention_kernels_reject_bad_input(dev):
    q = torch.zeros((1, 8, 4, 48), device=dev)            # D = 48
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros((1, 8, 4, 32), device=dev)
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), q[:, :, :2].half(), q[:, :, :2].half())
    with pytest.raises(ValueError, match="right-aligned"):
        ops.flash_attention(q, q[:, :4, :2].contiguous(),
                            q[:, :4, :2].contiguous())
    kv_len = torch.ones(1, dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        ops.decode_attention(q[:, :1], q[:, :, :2].contiguous(),
                             q[:, :, :2].contiguous(), kv_len)


# the serving prefill shapes, tests/test_kernels.py's scan cases and a
# ragged S; (B, S, H, Dh) and (B, S, H, P, N)
RWKV_CASES = {"serve": (4, 1024, 32, 64), "k16": (1, 64, 2, 16),
              "k64": (2, 128, 4, 64), "k32": (1, 256, 8, 32),
              "ragged": (4, 1000, 32, 64)}
SSD_CASES = {"serve": (4, 1024, 64, 64, 64), "k16": (1, 64, 2, 16, 16),
             "k64": (2, 128, 4, 64, 64), "k32": (1, 256, 8, 32, 16),
             "ragged": (4, 1000, 64, 64, 64)}


def _scan_tol(dtype):
    return dict(rtol=5e-2, atol=5e-2) if dtype == "bf16" \
        else dict(rtol=5e-3, atol=5e-3)


def _rwkv_inputs(gen, B, S, H, Dh, dtype, dev):
    """tests/test_kernels.py's distributions: w = sigmoid(2 z), u = 0.3 z."""
    r, k, v = (_randn(gen, (B, S, H, Dh), dtype, dev) for _ in range(3))
    w = torch.sigmoid(2 * torch.randn((B, S, H, Dh), generator=gen,
                                      device=dev)).to(DTYPES[dtype])
    u = (0.3 * torch.randn((H, Dh), generator=gen, device=dev)).to(
        DTYPES[dtype])
    s0 = torch.randn((B, H, Dh, Dh), generator=gen, device=dev)
    return r, k, v, w, u, s0


def _ssd_inputs(gen, B, S, H, P, N, dtype, dev):
    """dt = softplus(z), A = -exp(0.5 z), as tests/test_kernels.py."""
    x = _randn(gen, (B, S, H, P), dtype, dev)
    dt = torch.nn.functional.softplus(torch.randn(
        (B, S, H), generator=gen, device=dev)).to(DTYPES[dtype])
    A = -torch.exp(0.5 * torch.randn((H,), generator=gen, device=dev))
    Bm, Cm = (_randn(gen, (B, S, N), dtype, dev) for _ in range(2))
    s0 = torch.randn((B, H, P, N), generator=gen, device=dev)
    return x, dt, A, Bm, Cm, s0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", RWKV_CASES)
def test_rwkv6_scan_kernel(dev, case, dtype):
    gen = torch.Generator(device=dev).manual_seed(5)
    args = _rwkv_inputs(gen, *RWKV_CASES[case], dtype, dev)
    before = ops.launch_counts()["rwkv6_scan"]
    y, st = ops.rwkv6_scan(*args)
    assert ops.launch_counts()["rwkv6_scan"] == before + 1
    want_y, want_st = ops.rwkv6_scan(*args, impl="torch")
    torch.cuda.synchronize()
    assert y.dtype == args[0].dtype and st.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y.float(), **_scan_tol(dtype))
    torch.testing.assert_close(st, want_st, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SSD_CASES)
def test_mamba2_ssd_kernel(dev, case, dtype):
    gen = torch.Generator(device=dev).manual_seed(8)
    args = _ssd_inputs(gen, *SSD_CASES[case], dtype, dev)
    before = ops.launch_counts()["mamba2_ssd"]
    y, st = ops.mamba2_ssd(*args)
    assert ops.launch_counts()["mamba2_ssd"] == before + 1
    want_y, want_st = ops.mamba2_ssd(*args, impl="torch")
    torch.cuda.synchronize()
    assert y.dtype == args[0].dtype and st.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y.float(), **_scan_tol(dtype))
    torch.testing.assert_close(st, want_st, rtol=1e-3, atol=1e-3)


def test_scan_kernels_carry_state(dev):
    """The sequence in two calls, the state carried between them, equals one
    call: the per-step arithmetic does not depend on where a call starts."""
    gen = torch.Generator(device=dev).manual_seed(9)
    r, k, v, w, u, s0 = _rwkv_inputs(gen, 2, 301, 4, 64, "f32", dev)
    y, st = ops.rwkv6_scan(r, k, v, w, u, s0)
    cut = 77
    y1, s1 = ops.rwkv6_scan(*(t[:, :cut].contiguous() for t in (r, k, v, w)),
                            u, s0)
    y2, s2 = ops.rwkv6_scan(*(t[:, cut:].contiguous() for t in (r, k, v, w)),
                            u, s1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(s2, st)
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(gen, 2, 301, 4, 32, 64, "f32", dev)
    y, st = ops.mamba2_ssd(x, dt, A, Bm, Cm, s0)
    first = (t[:, :cut].contiguous() for t in (x, dt))
    y1, s1 = ops.mamba2_ssd(*first, A, Bm[:, :cut].contiguous(),
                            Cm[:, :cut].contiguous(), s0)
    rest = (t[:, cut:].contiguous() for t in (x, dt))
    y2, s2 = ops.mamba2_ssd(*rest, A, Bm[:, cut:].contiguous(),
                            Cm[:, cut:].contiguous(), s1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(s2, st)


# the edges: every Dh / (P, N), the shortest sequences, a ragged chunk on
# either side of a chunk boundary (63, 65) and a long one (4096)
EDGE_S = (1, 63, 65, 4096)
SCAN_DIMS = (16, 32, 64)


def _model_decay(gen, shape, dtype, dev):
    """The model's w = exp(-exp(clip(dec, -20, 10))) with dec = 3 z: spans
    from 1 to exact zeros (models/layers.py:_rwkv6_projections)."""
    dec = 3 * torch.randn(shape, generator=gen, device=dev)
    return torch.exp(-torch.exp(dec.clamp(-20.0, 10.0))).to(DTYPES[dtype])


def _hold_scan(got, want, dtype):
    (y, st), (want_y, want_st) = got, want
    torch.cuda.synchronize()
    assert y.dtype == want_y.dtype and st.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all())
    torch.testing.assert_close(y.float(), want_y.float(), **_scan_tol(dtype))
    torch.testing.assert_close(st, want_st, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", EDGE_S)
@pytest.mark.parametrize("Dh", SCAN_DIMS)
def test_rwkv6_scan_kernel_edges(dev, Dh, S, dtype):
    """The model's own decay, exact zeros included."""
    gen = torch.Generator(device=dev).manual_seed(10 + S)
    r, k, v, _, u, s0 = _rwkv_inputs(gen, 1, S, 2, Dh, dtype, dev)
    w = _model_decay(gen, (1, S, 2, Dh), dtype, dev)
    if S > 1:
        assert bool((w == 0).any()) and bool((w > 0.5).any())
    args = (r, k, v, w, u, s0)
    _hold_scan(ops.rwkv6_scan(*args), ops.rwkv6_scan(*args, impl="torch"),
               dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", EDGE_S)
@pytest.mark.parametrize("P,N", [(P, N) for P in SCAN_DIMS
                                 for N in SCAN_DIMS])
def test_mamba2_ssd_kernel_edges(dev, P, N, S, dtype):
    """A from -1 to -50: dt A far below the point where exp underflows."""
    gen = torch.Generator(device=dev).manual_seed(20 + S)
    x, dt, _, Bm, Cm, s0 = _ssd_inputs(gen, 1, S, 2, P, N, dtype, dev)
    A = torch.tensor([-1.0, -50.0], device=dev)
    args = (x, dt, A, Bm, Cm, s0)
    _hold_scan(ops.mamba2_ssd(*args), ops.mamba2_ssd(*args, impl="torch"),
               dtype)


def test_scan_kernels_carry_state_bf16(dev):
    """bf16: RWKV6's steps do not depend on where a call starts (bitwise);
    the chunked SSD's chunk boundaries move with the cut, so its carried
    state agrees within 1e-3 and y within the bf16 tolerance."""
    gen = torch.Generator(device=dev).manual_seed(19)
    cut = 77
    r, k, v, w, u, s0 = _rwkv_inputs(gen, 2, 301, 4, 64, "bf16", dev)
    y, st = ops.rwkv6_scan(r, k, v, w, u, s0)
    y1, s1 = ops.rwkv6_scan(*(t[:, :cut].contiguous() for t in (r, k, v, w)),
                            u, s0)
    y2, s2 = ops.rwkv6_scan(*(t[:, cut:].contiguous() for t in (r, k, v, w)),
                            u, s1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(s2, st)
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(gen, 2, 301, 4, 64, 64, "bf16", dev)
    y, st = ops.mamba2_ssd(x, dt, A, Bm, Cm, s0)
    y1, s1 = ops.mamba2_ssd(*(t[:, :cut].contiguous() for t in (x, dt)), A,
                            Bm[:, :cut].contiguous(),
                            Cm[:, :cut].contiguous(), s0)
    y2, s2 = ops.mamba2_ssd(*(t[:, cut:].contiguous() for t in (x, dt)), A,
                            Bm[:, cut:].contiguous(),
                            Cm[:, cut:].contiguous(), s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1).float(), y.float(),
                               **_scan_tol("bf16"))
    torch.testing.assert_close(s2, st, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", DTYPES)
def test_scan_geometry_matches_the_library(dev, dtype):
    """kernels/recurrence.py's launch geometry is the one the built library
    makes (blocks per (b, h), threads, dynamic shared bytes), for every
    head_dim and (P, N)."""
    from repro_torch.kernels import recurrence as rk
    td = DTYPES[dtype]
    for Dh in SCAN_DIMS:
        want = rk.rwkv6_geometry(1, 1, Dh, td.itemsize)
        assert rk.built_geometry("rwkv6_scan", (Dh,), td) == {
            k: want[k] for k in ("blocks", "threads", "smem")}
    for P in SCAN_DIMS:
        for N in SCAN_DIMS:
            want = rk.mamba2_geometry(1, 1, P, N, td)
            assert rk.built_geometry("mamba2_ssd", (P, N), td) == {
                k: want[k] for k in ("blocks", "threads", "smem")}


def test_scan_kernels_reject_bad_input(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    r, k, v, w, u, s0 = _rwkv_inputs(gen, 1, 8, 2, 16, "f32", dev)
    with pytest.raises(ValueError, match="head_dim"):
        z = torch.zeros((1, 8, 2, 48), device=dev)
        ops.rwkv6_scan(z, z, z, z, torch.zeros((2, 48), device=dev),
                       torch.zeros((1, 2, 48, 48), device=dev))
    with pytest.raises(TypeError):
        ops.rwkv6_scan(r.half(), k.half(), v.half(), w.half(), u.half(), s0)
    with pytest.raises(TypeError):
        ops.rwkv6_scan(r, k, v, w, u, s0.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        ops.rwkv6_scan(r, k, v, w.transpose(1, 2).contiguous().transpose(1, 2),
                       u, s0)
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(gen, 1, 8, 2, 16, 16, "f32", dev)
    with pytest.raises(TypeError):
        ops.mamba2_ssd(x, dt, A.bfloat16(), Bm, Cm, s0)
    with pytest.raises(ValueError, match="state_dim"):
        z = torch.zeros((1, 8, 24), device=dev)
        ops.mamba2_ssd(x, dt, A, z, z, torch.zeros((1, 2, 16, 24), device=dev))
    with pytest.raises(ValueError):
        ops.mamba2_ssd(x, dt, A, Bm, Cm[:, :4].contiguous(), s0)


# ---------------------------------------------------------------- the
# paper's predictor study and §5 sweep on the card

def _failure_pattern(n, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 8).astype(np.float32)
    logit = 1.2 * X[:, 0] - 0.8 * X[:, 1] + 1.5 * (X[:, 2] > 0.5) - 0.6
    y = (rs.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return X, y


def test_dense_models_fit_on_the_card_like_on_the_cpu(dev):
    """GLM and N.N. fitted on the card (TF32 off) against the same fits on
    the CPU, at the tolerances the CPU fits keep to the JAX package."""
    from repro_torch.ml import models
    X, y = _failure_pattern(3000)
    card, cpu = models.GLM(device=dev).fit(X, y), \
        models.GLM(device="cpu").fit(X, y)
    np.testing.assert_allclose(card.wb, cpu.wb, rtol=0, atol=1e-5)
    card, cpu = models.NeuralNet(device=dev).fit(X, y), \
        models.NeuralNet(device="cpu").fit(X, y)
    for k in cpu.params:
        np.testing.assert_allclose(card.params[k], cpu.params[k], rtol=0,
                                   atol=1e-3, err_msg=k)
    np.testing.assert_allclose(card.predict_proba(X), cpu.predict_proba(X),
                               rtol=0, atol=1e-4)


def test_small_sweep_on_the_card_serial_and_broker(dev, tmp_path):
    """The CPU tests' kitchen_sink smoke sweep on the card: serial and
    broker (with a model registry) equal the CPU's serial sweep, and the
    card runs launch both forest kernels."""
    import json
    from repro_torch.cluster import fleet
    spec = fleet.SweepSpec(schedulers=("fifo", "atlas-fifo"), seeds=2,
                           scenarios=("kitchen_sink",), workloads=("smoke",),
                           fleet_sizes=(100,), min_samples=40)

    def body(result):
        out = json.loads(fleet.sweep_json(result))
        out.pop("provenance")
        out.pop("perf", None)
        return out

    want = body(fleet.run_sweep(spec, executor="serial", device="cpu",
                                log=lambda *a: None))
    launches = {}
    for executor, kw in (("serial", {}),
                         ("broker", {"registry": str(tmp_path / "reg")})):
        ops.reset_launch_counts()
        got = fleet.run_sweep(spec, executor=executor, device=dev,
                              log=lambda *a: None, **kw)
        launches[executor] = ops.launch_counts()
        assert body(got) == want, executor
    assert got["perf"]["broker"]["demand_calls"] > 0
    assert launches["serial"]["forest_infer"] > 0
    assert launches["broker"]["forest_infer_grouped"] > 0


def test_async_broker_on_the_card_serves_the_mirror(dev):
    """An AsyncBroker scoring on the card, over inproc:// (live models) and
    tcp:// (named models): every reply equals the numpy mirror, and the
    grouped kernel launched once per dispatch the server counted."""
    from repro_torch.online.server import AsyncBroker, BrokerClient
    rs = np.random.RandomState(5)
    models = {"map": SimpleNamespace(params=_forest(rs, 24, 5, 22)),
              "reduce": SimpleNamespace(params=_forest(rs, 8, 3, 22))}
    ops.reset_launch_counts()
    with AsyncBroker(models, policy="vt", device=dev) as server:
        assert ops.launch_counts()["forest_infer_grouped"] == 0  # warm-up
        for address in ("", "tcp://127.0.0.1:0"):
            client = BrokerClient(server.serve(address), server.loop,
                                  request_timeout_s=120)
            try:
                for i in range(24):
                    kind = ("map", "reduce")[i % 2]
                    x = rs.rand(1 + (5 * i) % 13, 22).astype(np.float32)
                    out = (client.submit([(models[kind], x)])[0]
                           if not address else client.predict(kind, x))
                    want = np.clip(forest.forest_predict_np(
                        models[kind].params, x), 0.0, 1.0)
                    assert np.array_equal(out, want.astype(np.float32))
            finally:
                client.close()
        stats = server.stats()
    assert stats["requests"] == 48
    assert ops.launch_counts()["forest_infer_grouped"] \
        == stats["dispatches"] > 0


def test_telemetry_on_the_card_equals_the_cpu(dev, tmp_path):
    """The obs layer on the card: a telemetry-on compare writes the same
    frame files as on the CPU (frames carry no device or wall-clock value),
    and a brokered sweep's BrokerObserver records exactly one flush per
    grouped-kernel launch and per server dispatch."""
    import dataclasses
    import json
    from repro_torch.cluster import WorkloadConfig, fleet
    from repro_torch.cluster.experiment import ExperimentConfig, compare
    cfg = ExperimentConfig(workload=WorkloadConfig(n_single=10, n_chains=2,
                                                   seed=5),
                           seed=3, min_samples=32, max_train=40,
                           obs_frame_every=120.0)
    out = {}
    for where in (dev, "cpu"):
        path = tmp_path / str(where) / "f.ndjson"
        out[str(where)] = compare("fifo", dataclasses.replace(
            cfg, device=where, obs_path=str(path)))
        for run in ("base", "atlas"):
            assert (path.parent / f"f__{run}.ndjson").exists()
    assert out[str(dev)] == out["cpu"]
    for run in ("base", "atlas"):
        assert (tmp_path / str(dev) / f"f__{run}.ndjson").read_bytes() \
            == (tmp_path / "cpu" / f"f__{run}.ndjson").read_bytes()
    spec = fleet.SweepSpec(schedulers=("fifo", "atlas-fifo"), seeds=1,
                           scenarios=("kitchen_sink",), workloads=("smoke",),
                           fleet_sizes=(100,), min_samples=40)
    ops.reset_launch_counts()
    result = fleet.run_sweep(spec, executor="broker", device=dev,
                             obs_dir=str(tmp_path / "obs"),
                             log=lambda *a: None)
    launches = ops.launch_counts()["forest_infer_grouped"]
    flushes = result["perf"]["obs"]["broker"]["broker.flushes"]
    assert flushes == launches == result["perf"]["broker"]["dispatches"] > 0
    frames = [json.loads(line) for line in
              (tmp_path / "obs" / "broker.ndjson").read_text().splitlines()]
    assert len(frames) == flushes


# ---------------------------------------------------------------------------
# training: the kernels under autograd, a train step, bf16 checkpoints
# ---------------------------------------------------------------------------

# (kernel, shape): attention (B, S, Skv, H, Hkv, D, causal, window); the
# scans at S = 300 (three 100-step chunks) and S = 256 (two of 128)
TRAIN_CASES = {
    "flash": (2, 64, 64, 4, 2, 64, True, 0),
    "flash_window": (2, 100, 100, 4, 4, 32, True, 16),
    # non-causal cross-attention to more keys than queries (the vlm's and
    # whisper's decoder), and a whisper-like encoder (S = Skv, D=64)
    "flash_cross": (2, 64, 160, 8, 2, 64, False, 0),
    "flash_encoder": (2, 150, 150, 4, 4, 64, False, 0),
    # head_dim 160 (stablelm-12b's geometry: 4 query heads per kv head)
    "flash_d160": (2, 128, 128, 8, 2, 160, True, 0),
    "flash_d160_window": (2, 100, 100, 4, 1, 160, True, 24),
    "rwkv6_300": (2, 300, 2, 64),
    "rwkv6_256": (1, 256, 4, 32),
    "mamba2_300": (2, 300, 2, 16, 16),
    "mamba2_256": (1, 256, 4, 64, 64),
}


def _train_fn(case):
    from repro_torch.kernels import ref
    if case.startswith("flash"):
        causal, window = TRAIN_CASES[case][6:]
        return (lambda q, k, v: ops.flash_attention(
                    q, k, v, causal=causal, window=window),
                lambda q, k, v: ref.flash_attention_ref(
                    q, k, v, causal=causal, window=window))
    if case.startswith("rwkv6"):
        return ops.rwkv6_scan, ref.rwkv6_scan_ref
    return ops.mamba2_ssd, ref.mamba2_ssd_ref


def _train_inputs(gen, case, dtype, dev):
    shape = TRAIN_CASES[case]
    if case.startswith("flash"):
        B, S, Skv, H, Hkv, D = shape[:6]
        return (_randn(gen, (B, S, H, D), dtype, dev),
                _randn(gen, (B, Skv, Hkv, D), dtype, dev),
                _randn(gen, (B, Skv, Hkv, D), dtype, dev))
    if case.startswith("rwkv6"):
        return _rwkv_inputs(gen, *shape, dtype, dev)
    return _ssd_inputs(gen, *shape, dtype, dev)


def _out_and_grads(fn, args, cots):
    leaves = [a.detach().requires_grad_() for a in args]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o.float() * c).sum() for o, c in zip(outs, cots))
    return outs, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", TRAIN_CASES)
def test_training_functions_on_the_card(dev, case, dtype):
    """Under autograd each kernel's Function launches the kernel (the scans
    once per chunk), its forward equals the bare kernel call (see below for
    the bf16 SSD at a chunk that 64 does not divide) and is within
    the kernel's tolerance of the plain version's outputs (attention 2e-2
    bf16 / 2e-3 float32; a scan's y 5e-2 / 5e-3 and its float32 final state
    1e-3, as chip_smoke's ATTN_TOL, SCAN_TOL and STATE_TOL), and its
    gradients are within 2e-2 (bf16) / 2e-3 (float32) of each gradient's
    largest magnitude from autograd through the plain version (chip_smoke's
    TRAIN_GRAD_TOL and its float32 counterpart)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    fn, plain = _train_fn(case)
    gen = torch.Generator(device=dev).manual_seed(11)
    args = _train_inputs(gen, case, dtype, dev)
    with torch.no_grad():
        bare = fn(*args)
    bare = bare if isinstance(bare, tuple) else (bare,)
    cots = [torch.randn(o.shape, generator=gen, device=dev) for o in bare]
    kernel = {"flash": "flash_attention", "rwkv6": "rwkv6_scan",
              "mamba2": "mamba2_ssd"}[case.split("_")[0]]
    before = ops.launch_counts()[kernel]
    outs, grads = _out_and_grads(fn, args, cots)
    S = TRAIN_CASES[case][1]
    from repro_torch.kernels import ref
    want = 1 if kernel == "flash_attention" else S // ref.divisor_chunk(
        S, 128)
    assert ops.launch_counts()[kernel] == before + want
    assert outs[0].grad_fn is not None
    # the forward equals the bare kernel call; the bf16 SSD kernel's own
    # 64-step chunks restart where a Function's chunk does, so where that
    # chunk is not a multiple of 64 (mamba2_300's 100) it is held to the
    # carried-state tolerances of test_scan_kernels_carry_state_bf16
    from repro_torch.kernels.recurrence import SSD_CHUNK
    ragged = kernel == "mamba2_ssd" and dtype == "bf16" and \
        ref.divisor_chunk(S, 128) % SSD_CHUNK
    for o, b, t in zip(outs, bare, (5e-2, 1e-3)):
        if ragged:
            torch.testing.assert_close(o.detach().float(), b.float(),
                                       rtol=t, atol=t)
        else:
            assert torch.equal(o.detach(), b)
    pouts, pgrads = _out_and_grads(plain, args, cots)
    bf16 = dtype == "bf16"
    tols = ((2e-2 if bf16 else 2e-3),) if kernel == "flash_attention" \
        else ((5e-2 if bf16 else 5e-3), 1e-3)
    for o, p, t in zip(outs, pouts, tols):
        assert torch.allclose(o.detach().float(), p.detach().float(),
                              rtol=t, atol=t)
    tol = 2e-2 if dtype == "bf16" else 2e-3
    for g, p in zip(grads, pgrads):
        assert g.dtype == p.dtype and bool(torch.isfinite(g).all())
        scale = float(p.float().abs().max())
        assert float((g.float() - p.float()).abs().max()) <= tol * scale


def test_smoke_train_step_on_the_card_matches_the_cpu(dev):
    """One float32 train step of stablelm-1.6b-smoke (accum 2) on the card
    through the kernels and on the CPU through the plain versions, from the
    same weights: losses within 1e-4, grad norms within 1e-3, every
    parameter within 2 lr (first-step Adam, see test_torch_train.py) and
    exactly n_layers x 2 flash launches (no remat in the smoke config)."""
    import dataclasses
    from repro_torch.configs import get_arch, smoke_reduce
    from repro_torch.models.steps import init_train_state, make_train_step
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel.axes import tree_leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(smoke_reduce(get_arch("stablelm-1.6b")),
                              accum_steps=2)
    opt = AdamWConfig(warmup_steps=1, total_steps=4)
    cpu_state = init_train_state(cfg, 0, opt, device="cpu")
    dev_state = tree_map(lambda t: t.to(dev), cpu_state)
    tokens = torch.randint(0, cfg.vocab_size, (4, 32),
                           generator=torch.Generator().manual_seed(2))
    step, _ = make_train_step(cfg, opt)
    ops.reset_launch_counts()
    dev_new, dm = step(dev_state, {"tokens": tokens})
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers * 2
    cpu_new, cm = step(cpu_state, {"tokens": tokens})
    assert abs(float(dm["loss"]) - float(cm["loss"])) <= 1e-4 * float(
        cm["loss"])
    assert abs(float(dm["grad_norm"]) - float(cm["grad_norm"])) <= 1e-3 * \
        float(cm["grad_norm"])
    lr = float(cm["lr"])
    for a, b in zip(tree_leaves(dev_new["params"]),
                    tree_leaves(cpu_new["params"])):
        assert a.is_cuda and float((a.cpu() - b).abs().max()) <= 2 * lr + 1e-6


def test_bf16_checkpoint_round_trip_on_the_card(dev, tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.parallel.axes import tree_leaves
    gen = torch.Generator(device=dev).manual_seed(4)
    tree = {"w": torch.randn((64, 33), generator=gen,
                             device=dev).to(torch.bfloat16),
            "m": {"a": torch.randn((7,), generator=gen, device=dev)},
            "count": torch.tensor(3, dtype=torch.int32, device=dev)}
    mgr = CheckpointManager(tmp_path, async_write=False)
    mgr.save(1, tree)
    got = mgr.restore(1, tree)
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)


# the moe, vlm and audio families' train step; float32 media on bf16
# weights; optim/compression.py
# ---------------------------------------------------------------------------

FAMILY_TRAIN = ("deepseek-moe-16b", "llama-3.2-vision-90b",
                "whisper-large-v3")


def _family_step(arch, dev, dtype=torch.float32, media_dtype=None,
                 accum=2):
    """One train step of ``arch``'s smoke config (the vlm's gates opened
    to 0.5; seeded media for vlm and audio) on the card through the
    kernels and on the CPU through the plain versions, from the same
    weights: (card metrics, card state, CPU metrics, CPU state, flash
    launches of the card step, the config)."""
    import dataclasses
    from repro_torch.configs import get_arch, smoke_reduce
    from repro_torch.models import get_model
    from repro_torch.models.steps import init_train_state, make_train_step
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel.axes import tree_map
    cfg = dataclasses.replace(smoke_reduce(get_arch(arch)),
                              accum_steps=accum, dtype=dtype)
    opt = AdamWConfig(warmup_steps=1, total_steps=4)
    cpu_state = init_train_state(cfg, 0, opt, device="cpu")
    if "cross_blocks" in cpu_state["params"]:
        for gate in ("gate_attn", "gate_mlp"):
            cpu_state["params"]["cross_blocks"][gate].fill_(0.5)
    dev_state = tree_map(lambda t: t.to(dev), cpu_state)
    gen = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 32),
                                     generator=gen)}
    ms = get_model(cfg).media_struct(4)
    if ms is not None:
        batch["media"] = (0.02 * torch.randn(ms.shape, generator=gen)).to(
            media_dtype or dtype)
    step, _ = make_train_step(cfg, opt)
    ops.reset_launch_counts()
    dev_new, dm = step(dev_state, batch)
    launches = ops.launch_counts()["flash_attention"]
    cpu_new, cm = step(cpu_state, batch)
    return dm, dev_new, cm, cpu_new, launches, cfg


def _flash_per_forward(cfg):
    if cfg.family == "audio":
        return cfg.enc_dec.n_enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


@pytest.mark.parametrize("arch", FAMILY_TRAIN)
def test_family_train_step_on_the_card_matches_the_cpu(dev, arch):
    """test_smoke_train_step_on_the_card_matches_the_cpu for the moe, vlm
    and audio families (float32, accum 2, TF32 off): losses and aux losses
    within 1e-4, grad norms within 1e-3, every parameter within 2 lr,
    exactly one flash launch per attention per microbatch (the smoke
    configs do not rematerialise)."""
    from repro_torch.parallel.axes import tree_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    dm, dev_new, cm, cpu_new, launches, cfg = _family_step(arch, dev)
    assert launches == _flash_per_forward(cfg) * 2
    for key in ("loss", "aux_loss"):
        assert abs(float(dm[key]) - float(cm[key])) <= 1e-4 * max(
            abs(float(cm[key])), 1e-6)
    assert abs(float(dm["grad_norm"]) - float(cm["grad_norm"])) <= 1e-3 * \
        float(cm["grad_norm"])
    lr = float(cm["lr"])
    for a, b in zip(tree_leaves(dev_new["params"]),
                    tree_leaves(cpu_new["params"])):
        assert a.is_cuda and float((a.cpu() - b).abs().max()) <= 2 * lr + 1e-6


@pytest.mark.parametrize("arch", FAMILY_TRAIN[1:])
def test_float32_media_on_bf16_weights_on_the_card(dev, arch):
    """A bf16 smoke vlm / whisper step with float32 media on the card: the
    float32 keys of the media run the float32 flash kernel (the queries
    cast up), one launch per attention per microbatch; the loss within
    chip_smoke's TRAIN_LOSS_RTOL (5e-3) of the CPU's plain step, every
    parameter's new value finite."""
    from repro_torch.parallel.axes import tree_leaves
    dm, dev_new, cm, _, launches, cfg = _family_step(
        arch, dev, dtype=torch.bfloat16, media_dtype=torch.float32)
    assert launches == _flash_per_forward(cfg) * 2
    assert abs(float(dm["loss"]) - float(cm["loss"])) <= 5e-3 * float(
        cm["loss"])
    assert all(bool(torch.isfinite(p).all())
               for p in tree_leaves(dev_new["params"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compression_on_the_card_equals_the_cpu(dev, dtype):
    """compress / decompress / compressed_psum (one process) on the card
    torch.equal to the CPU on the same seeded input (ragged last block,
    an all-zero block)."""
    from repro_torch.optim import compression as cz
    g = (3.0 * torch.randn(5 * cz.BLOCK + 41,
                           generator=torch.Generator().manual_seed(6))
         ).to(dtype)
    g[cz.BLOCK:2 * cz.BLOCK] = 0
    cpu, card = cz.compress(g), cz.compress(g.to(dev))
    for a, b in zip(cpu, card):
        assert b.is_cuda and a.dtype == b.dtype and torch.equal(a, b.cpu())
    deq = cz.decompress(*card[:2], g.shape)
    assert torch.equal(deq.cpu(), cz.decompress(*cpu[:2], g.shape))
    summed, resid = cz.compressed_psum(g.to(dev))
    assert torch.equal(summed, deq)     # quantised in float32: the same q
    assert torch.equal(resid, cz.compress(g.to(dev).float())[2])


DRYRUN_SMOKE = [("stablelm-1.6b", "train"), ("rwkv6-1.6b", "train"),
                ("zamba2-1.2b", "prefill"), ("zamba2-1.2b", "decode"),
                ("deepseek-moe-16b", "decode")]


@pytest.mark.parametrize("arch,kind", DRYRUN_SMOKE)
def test_cost_count_on_the_card_equals_launch_counts(dev, arch, kind):
    """launch/cost.py's counting mode around a smoke cell's step on the
    card: its kernel launches equal ops.launch_counts() and the dry run's
    on meta, and its FLOPs the dry run's."""
    import dataclasses
    from repro_torch.configs import SHAPES, get_arch, smoke_reduce
    from repro_torch.launch import cost, dryrun
    from repro_torch.launch.mesh import one_card_mesh
    from repro_torch.models import get_model
    from repro_torch.models.steps import init_train_state
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(smoke_reduce(get_arch(arch)), accum_steps=2)
    shape = {"train": SHAPES["train_4k"], "prefill": SHAPES["prefill_32k"],
             "decode": SHAPES["decode_32k"]}[kind]
    shape = dataclasses.replace(shape, seq_len=64, global_batch=4)
    cell, meta = dryrun.trace_cell(cfg, shape, one_card_mesh())
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (4, 1 if kind == "decode"
                                               else 64),
                           generator=gen, dtype=torch.int32, device=dev)
    model = get_model(cfg)
    if kind == "train":
        args = (init_train_state(cfg, 0, adamw.AdamWConfig(), device=dev),
                {"tokens": tokens})
    elif kind == "prefill":
        args = (model.init(0, device=dev), {"tokens": tokens})
    else:
        args = (model.init(0, device=dev), model.init_cache(4, 64, device=dev),
                tokens, torch.full((4,), 63, dtype=torch.int32, device=dev))
    assert cost.tree_bytes(args) == cost.tree_bytes(cell["args"])
    ops.reset_launch_counts()
    real = cost.count(cell["fn"], *args)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    assert any(launches.values())
    for k in ops.KERNELS:
        assert real["kernels"][k]["launches"] == launches[k] == \
            meta["kernels"][k]["launches"], k
    assert real["flops"] == meta["flops"]


# the decode kernel's partial mode: DECODE_CASES' caches cut into 1, 2 and
# 4 slices along the sequence (the slices of a kv_seq-sharded cache), each
# slice's (o, m, l) against the plain partial, and the merged slices
# against the whole-cache kernel and the plain version
PARTIAL_CASES = ("serve", "ragged", "window", "d32_g2", "one_key",
                 "window_one_block", "group16", "d160_g4", "d160_g4_window",
                 "d160_g16_window")


@pytest.mark.parametrize("slices", [1, 2, 4])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", PARTIAL_CASES)
def test_decode_attention_partial_mode(dev, case, dtype, slices):
    from repro_torch.kernels import ref
    B, Smax, H, Hkv, D, window, lens = DECODE_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(2)
    q = _randn(gen, (B, 1, H, D), dtype, dev)
    k = _randn(gen, (B, Smax, Hkv, D), dtype, dev)
    v = _randn(gen, (B, Smax, Hkv, D), dtype, dev)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    bounds = [Smax * r // slices for r in range(slices + 1)]
    parts, before = [], ops.launch_counts()["decode_attention_partial"]
    for r in range(slices):
        lo, hi = bounds[r], bounds[r + 1]
        ks, vs = k[:, lo:hi].contiguous(), v[:, lo:hi].contiguous()
        got = ops.decode_attention_partial(q, ks, vs, kv_len, start=lo,
                                           window=window)
        want = ops.decode_attention_partial(q, ks, vs, kv_len, start=lo,
                                            window=window, impl="torch")
        torch.cuda.synchronize()
        o, m, l = got
        assert o.dtype == m.dtype == l.dtype == torch.float32
        assert torch.equal(torch.isneginf(m), torch.isneginf(want[1]))
        assert torch.equal(l == 0, want[2] == 0)
        live = ~torch.isneginf(want[1])
        torch.testing.assert_close(m[live], want[1][live], **_tol(dtype))
        torch.testing.assert_close(l / want[2].clamp(min=1e-30),
                                   torch.where(live, 1.0, 0.0),
                                   **_tol(dtype))
        parts.append(got)
    assert ops.launch_counts()["decode_attention_partial"] == \
        before + slices
    o, m, l = (torch.stack(x) for x in zip(*parts))
    merged = ref.merge_partials(m, l, o)
    whole = ops.decode_attention(q, k, v, kv_len, window=window)
    plain = ref.decode_attention_xla(q, k, v, kv_len, window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(merged).all()
    torch.testing.assert_close(merged, plain.float(), **_tol(dtype))
    torch.testing.assert_close(merged.to(q.dtype).float(), whole.float(),
                               **_tol(dtype))


def test_decode_attention_partial_empty_slices(dev):
    """A slice past every live key and a kv_len of 0: o = 0, l = 0, m =
    -inf from the kernel, and the merge gives 0 there, never NaN."""
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(3)
    q = _randn(gen, (3, 1, 8, 128), "bf16", dev)
    k = _randn(gen, (3, 512, 2, 128), "bf16", dev)
    kv_len = torch.tensor([0, 100, 256], dtype=torch.int32, device=dev)
    o, m, l = ops.decode_attention_partial(q, k[:, 256:].contiguous(),
                                           k[:, 256:].contiguous(), kv_len,
                                           start=256)
    torch.cuda.synchronize()
    assert torch.isneginf(m).all() and (l == 0).all() and (o == 0).all()
    o0, m0, l0 = ops.decode_attention_partial(
        q, k[:, :256].contiguous(), k[:, :256].contiguous(), kv_len, start=0)
    out = ref.merge_partials(torch.stack([m0, m]), torch.stack([l0, l]),
                             torch.stack([o0, o]))
    assert torch.isfinite(out).all() and (out[0] == 0).all()
    whole = ops.decode_attention(q[1:], k[1:], k[1:], kv_len[1:])
    torch.testing.assert_close(out[1:].to(q.dtype).float(), whole.float(),
                               **_tol("bf16"))
