"""The port's plain recurrences (repro_torch.kernels.ref: rwkv6_scan_ref,
rwkv6_step_ref, mamba2_ssd_ref, mamba2_step_ref) against the JAX package on
the CPU: its oracles in repro/kernels/ref.py and its Pallas kernels in
interpret mode, on the shapes of tests/test_kernels.py's scan tests.

Inputs are drawn with numpy from a seed and handed to both packages (bf16
inputs are the same float32 draws rounded to bf16 on each side).
Tolerances:
- float32: the largest difference at most 1e-5 times the largest reference
  value (both sides compute in float32; they sum the state products in
  different orders, so entries near zero differ by more than 1e-5 of
  themselves);
- bf16: rtol = atol = 5e-2, tests/test_kernels.py's bf16 tolerance for these
  scans (both sides compute in float32 from the same bf16 inputs; y is
  rounded to bf16 once, and a float32 order difference can move that
  rounding by one bf16 step);
- the float32 state: 1e-5 of its scale in both cases.
The plain scans also carry their state across a split sequence (to 1e-6 of
the scale: the same operations, in the same order), and a scan of one step
equals the step function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.mamba2_ssd import mamba2_ssd as pallas_ssd
from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_rwkv
from repro_torch.kernels import ops, ref
from repro_torch.kernels import recurrence as rk

SCALE_TOL = 1e-5
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
# tests/test_kernels.py's cases: (B, S, H, Dh, chunk) and (B, S, H, P, N,
# chunk); the chunk is the Pallas kernel's
RWKV_CASES = [(1, 64, 2, 16, 16), (2, 128, 4, 64, 64), (1, 256, 8, 32, 128)]
SSD_CASES = [(1, 64, 2, 16, 16, 16), (2, 128, 4, 64, 64, 64),
             (1, 256, 8, 32, 16, 128)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, bf16=False):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if bf16:
        np.testing.assert_allclose(got, want, **BF16_TOL)
    else:
        err, scale = np.abs(got - want).max(), np.abs(want).max()
        assert err <= SCALE_TOL * scale, (err, scale)


def _pair(a, dtype):
    """The same numpy draw as a JAX array and a torch tensor of dtype."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _rwkv_np(seed, B, S, H, Dh):
    """tests/test_kernels.py's distributions: w = sigmoid(2 z), u = 0.3 z."""
    rs = np.random.RandomState(seed)
    r, k, v = (rs.randn(B, S, H, Dh).astype(np.float32) for _ in range(3))
    w = (1 / (1 + np.exp(-2 * rs.randn(B, S, H, Dh)))).astype(np.float32)
    u = (0.3 * rs.randn(H, Dh)).astype(np.float32)
    s0 = rs.randn(B, H, Dh, Dh).astype(np.float32)
    return r, k, v, w, u, s0


def _ssd_np(seed, B, S, H, P, N):
    """dt = softplus(z), A = -exp(0.5 z), as tests/test_kernels.py."""
    rs = np.random.RandomState(seed)
    x = rs.randn(B, S, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rs.randn(B, S, H))).astype(np.float32)
    A = (-np.exp(0.5 * rs.randn(H))).astype(np.float32)
    Bm, Cm = (rs.randn(B, S, N).astype(np.float32) for _ in range(2))
    s0 = rs.randn(B, H, P, N).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


def _rwkv_args(case, dtype, seed=5):
    r, k, v, w, u, s0 = _rwkv_np(seed, *case)
    pairs = [_pair(a, dtype) for a in (r, k, v, w, u)]
    pairs.append(_pair(s0, "f32"))
    return [j for j, _ in pairs], [t for _, t in pairs]


def _ssd_args(case, dtype, seed=8):
    x, dt, A, Bm, Cm, s0 = _ssd_np(seed, *case)
    pairs = [_pair(x, dtype), _pair(dt, dtype), _pair(A, "f32"),
             _pair(Bm, dtype), _pair(Cm, dtype), _pair(s0, "f32")]
    return [j for j, _ in pairs], [t for _, t in pairs]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", RWKV_CASES, ids=str)
def test_rwkv6_scan_ref_matches_reference(case, dtype):
    """Against the JAX oracle and the Pallas kernel in interpret mode."""
    B, S, H, Dh, chunk = case
    jargs, targs = _rwkv_args((B, S, H, Dh), dtype)
    y, st = ref.rwkv6_scan_ref(*targs)
    assert y.dtype == targs[0].dtype and st.dtype == torch.float32
    bf16 = dtype == "bf16"
    for want_y, want_st in (jref.rwkv6_scan_ref(*jargs),
                            pallas_rwkv(*jargs, chunk=chunk, interpret=True)):
        _close(y, want_y, bf16)
        _close(st, want_st)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_mamba2_ssd_ref_matches_reference(case, dtype):
    B, S, H, P, N, chunk = case
    jargs, targs = _ssd_args((B, S, H, P, N), dtype)
    y, st = ref.mamba2_ssd_ref(*targs)
    assert y.dtype == targs[0].dtype and st.dtype == torch.float32
    bf16 = dtype == "bf16"
    for want_y, want_st in (jref.mamba2_ssd_ref(*jargs),
                            pallas_ssd(*jargs, chunk=chunk, interpret=True)):
        _close(y, want_y, bf16)
        _close(st, want_st)


@pytest.mark.parametrize("dtype", DTYPES)
def test_step_refs_match_reference(dtype):
    """One decode step of each recurrence, from a random state."""
    bf16 = dtype == "bf16"
    jargs, targs = _rwkv_args((3, 1, 4, 32), dtype, seed=11)
    squeeze_j = [a[:, 0] for a in jargs[:4]] + jargs[4:]
    squeeze_t = [a[:, 0] for a in targs[:4]] + targs[4:]
    y, st = ref.rwkv6_step_ref(*squeeze_t)
    want_y, want_st = jref.rwkv6_step_ref(*squeeze_j)
    _close(y, want_y, bf16)
    _close(st, want_st)
    jargs, targs = _ssd_args((3, 1, 4, 32, 16), dtype, seed=12)
    squeeze_j = [a[:, 0] if i != 2 and i != 5 else a
                 for i, a in enumerate(jargs)]
    squeeze_t = [a[:, 0] if i != 2 and i != 5 else a
                 for i, a in enumerate(targs)]
    y, st = ref.mamba2_step_ref(*squeeze_t)
    want_y, want_st = jref.mamba2_step_ref(*squeeze_j)
    _close(y, want_y, bf16)
    _close(st, want_st)


def test_scans_of_one_step_equal_the_step_functions():
    _, (r, k, v, w, u, s0) = _rwkv_args((2, 1, 4, 16), "f32", seed=13)
    y, st = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    y1, st1 = ref.rwkv6_step_ref(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, s0)
    torch.testing.assert_close(y[:, 0], y1, rtol=0, atol=1e-6)
    torch.testing.assert_close(st, st1, rtol=0, atol=1e-6)
    _, (x, dt, A, Bm, Cm, s0) = _ssd_args((2, 1, 4, 16, 32), "f32", seed=14)
    y, st = ref.mamba2_ssd_ref(x, dt, A, Bm, Cm, s0)
    y1, st1 = ref.mamba2_step_ref(x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0],
                                  s0)
    torch.testing.assert_close(y[:, 0], y1, rtol=0, atol=1e-6)
    torch.testing.assert_close(st, st1, rtol=0, atol=1e-6)


@pytest.mark.parametrize("cut", [1, 37, 99])
def test_plain_scans_carry_state(cut):
    """Two calls with the state carried between them equal one call."""
    _, (r, k, v, w, u, s0) = _rwkv_args((2, 100, 4, 16), "f32", seed=15)
    y, st = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    y1, s1 = ref.rwkv6_scan_ref(r[:, :cut], k[:, :cut], v[:, :cut],
                                w[:, :cut], u, s0)
    y2, s2 = ref.rwkv6_scan_ref(r[:, cut:], k[:, cut:], v[:, cut:],
                                w[:, cut:], u, s1)
    _close(torch.cat([y1, y2], 1), y)
    _close(s2, st)
    _, (x, dt, A, Bm, Cm, s0) = _ssd_args((2, 100, 4, 16, 16), "f32", seed=16)
    y, st = ref.mamba2_ssd_ref(x, dt, A, Bm, Cm, s0)
    y1, s1 = ref.mamba2_ssd_ref(x[:, :cut], dt[:, :cut], A, Bm[:, :cut],
                                Cm[:, :cut], s0)
    y2, s2 = ref.mamba2_ssd_ref(x[:, cut:], dt[:, cut:], A, Bm[:, cut:],
                                Cm[:, cut:], s1)
    _close(torch.cat([y1, y2], 1), y)
    _close(s2, st)


def test_ops_dispatch_cpu_tensors_to_the_plain_versions():
    _, targs = _rwkv_args((1, 8, 2, 16), "f32", seed=17)
    before = ops.launch_counts()
    for got, want in zip(ops.rwkv6_scan(*targs), ref.rwkv6_scan_ref(*targs)):
        assert torch.equal(got, want)
    _, targs = _ssd_args((1, 8, 2, 16, 16), "f32", seed=18)
    for got, want in zip(ops.mamba2_ssd(*targs), ref.mamba2_ssd_ref(*targs)):
        assert torch.equal(got, want)
    assert ops.launch_counts() == before


# ---------------------------------------------------------------------------
# The bf16 SSD kernel's chunked algorithm, mirrored on the CPU
# (ref.mamba2_ssd_chunked_ref): without rounding it equals the stepwise
# recurrence to float32 order (1e-5 of the scale); with the kernel's bf16
# pairs it stays inside the card checks' tolerances (y 5e-2, state 1e-3).
# ---------------------------------------------------------------------------

CHUNKED_S = (1, 63, 64, 65, 200)
CHUNKED_TOL = {"y": dict(rtol=5e-2, atol=5e-2),
               "state": dict(rtol=1e-3, atol=1e-3)}


def _strong_ssd_np(seed, B, S, H, P, N):
    """_ssd_np with A from -1 down to -50 across the heads, so that dt A
    reaches below -80 (down to -85 at least, in the last head) and
    exp(dt A) underflows to 0 in float32."""
    x, dt, _, Bm, Cm, s0 = _ssd_np(seed, B, S, H, P, N)
    A = -np.linspace(1.0, 50.0, H).astype(np.float32)
    dt = (dt + 1.7).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


def _chunked_args(case, S, strong, dtype):
    B, _, H, P, N, _ = case
    draw = _strong_ssd_np if strong else _ssd_np
    x, dt, A, Bm, Cm, s0 = draw(20 + S, B, S, H, P, N)
    if strong:
        assert (dt * A[None, None]).min() < -80
    pairs = [_pair(x, dtype), _pair(dt, dtype), _pair(A, "f32"),
             _pair(Bm, dtype), _pair(Cm, dtype), _pair(s0, "f32")]
    return [j for j, _ in pairs], [t for _, t in pairs]


def _hold(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("strong", [False, True], ids=["decay", "strong"])
@pytest.mark.parametrize("S", CHUNKED_S)
@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_mamba2_chunked_mirror_matches_stepwise(case, S, strong):
    """float32 inputs: unrounded, the chunked form is the stepwise one to
    1e-5 of the scale; with the kernel's bf16 pairs, within the card
    tolerances.  Held against the port's plain version and the JAX
    oracle."""
    jargs, targs = _chunked_args(case, S, strong, "f32")
    exact = ref.mamba2_ssd_chunked_ref(*targs, split_bf16=False)
    split = ref.mamba2_ssd_chunked_ref(*targs)
    for want_y, want_st in (ref.mamba2_ssd_ref(*targs),
                            jref.mamba2_ssd_ref(*jargs)):
        _close(exact[0], want_y)
        _close(exact[1], want_st)
        _hold(split[0], want_y, CHUNKED_TOL["y"])
        _hold(split[1], want_st, CHUNKED_TOL["state"])


@pytest.mark.parametrize("strong", [False, True], ids=["decay", "strong"])
@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_mamba2_chunked_mirror_bf16_inputs(case, strong):
    """bf16 inputs, as the kernel takes them: y (rounded to bf16) and the
    float32 state within the card tolerances of both oracles."""
    jargs, targs = _chunked_args(case, 200, strong, "bf16")
    y, st = ref.mamba2_ssd_chunked_ref(*targs)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    for want_y, want_st in (ref.mamba2_ssd_ref(*targs),
                            jref.mamba2_ssd_ref(*jargs)):
        _hold(y, want_y, CHUNKED_TOL["y"])
        _hold(st, want_st, CHUNKED_TOL["state"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_chunked_mirror_carries_state(dtype):
    """A cut at 77 moves the chunk boundaries; the carried state still
    agrees with one call within 1e-3, and y within the y tolerance."""
    _, (x, dt, A, Bm, Cm, s0) = _chunked_args(SSD_CASES[1], 200, False,
                                              dtype)
    cut = 77
    y, st = ref.mamba2_ssd_chunked_ref(x, dt, A, Bm, Cm, s0)
    y1, s1 = ref.mamba2_ssd_chunked_ref(x[:, :cut], dt[:, :cut], A,
                                        Bm[:, :cut], Cm[:, :cut], s0)
    y2, s2 = ref.mamba2_ssd_chunked_ref(x[:, cut:], dt[:, cut:], A,
                                        Bm[:, cut:], Cm[:, cut:], s1)
    _hold(torch.cat([y1, y2], 1), y, CHUNKED_TOL["y"])
    _hold(s2, st, CHUNKED_TOL["state"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_chunked_mirror_needs_the_bf16_pair(dtype, monkeypatch):
    """The control for the pairs: with M, the scaled X and S_in rounded
    once to bf16 instead, the carried state misses its 1e-3 tolerance
    (by about 4x here), while the pairs keep it."""
    jargs, targs = _chunked_args(SSD_CASES[1], 200, False, dtype)
    want_st = jref.mamba2_ssd_ref(*jargs)[1]
    _hold(ref.mamba2_ssd_chunked_ref(*targs)[1], want_st,
          CHUNKED_TOL["state"])
    monkeypatch.setattr(ref, "bf16_pair",
                        lambda t: t.to(torch.bfloat16).float())
    single = ref.mamba2_ssd_chunked_ref(*targs)[1]
    with pytest.raises(AssertionError):
        _hold(single, want_st, CHUNKED_TOL["state"])


def test_bf16_pair_is_exact_to_sixteen_bits():
    """hi + lo holds a float32 to about 2^-16 of itself, where one bf16
    rounding is 2^-8 off."""
    x = torch.from_numpy(np.random.RandomState(3).randn(4096).astype(
        np.float32) * 100)
    pair = ref.bf16_pair(x)
    assert ((pair - x).abs() <= x.abs() * 2.0 ** -16).all()
    assert ((x.to(torch.bfloat16).float() - x).abs().max()
            > (pair - x).abs().max() * 50)


# ---------------------------------------------------------------------------
# Launch geometry of the CUDA scans (kernels/recurrence.py), on the CPU
# ---------------------------------------------------------------------------

H100_SMS = 132
SM_SMEM = 233_472          # shared memory per SM, 1 KB of it per block
BLOCK_SMEM = 232_448       # dynamic shared memory one block may have
SM_THREADS = 2048


def _resident_per_sm(geo):
    """Blocks each SM must hold for the whole grid to be resident at once,
    and whether they fit its shared memory and threads."""
    per_sm = -(-geo["blocks"] // H100_SMS)
    fits = (per_sm * (geo["smem"] + 1024) <= SM_SMEM
            and per_sm * geo["threads"] <= SM_THREADS)
    return per_sm, fits


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
def test_rwkv6_geometry_fills_the_card(itemsize):
    """At the serving prefill (B=4, H=32, Dh=64) the kernel runs in one
    wave, two blocks of four warps on each SM, each thread a 4 x 4 tile of
    the state (the first stepwise kernel: one block of 8 warps per SM, 16
    state elements per thread in one column)."""
    geo = rk.rwkv6_geometry(4, 32, 64, itemsize)
    assert geo["instance"] == (2, 4, 4)
    assert geo["blocks"] == 4 * 32 * 2 and geo["threads"] == 128
    per_sm, fits = _resident_per_sm(geo)
    assert per_sm == 2 and fits and geo["smem"] <= BLOCK_SMEM


@pytest.mark.parametrize("Dh", rk.DIMS)
def test_rwkv6_geometry_every_head_dim(Dh):
    """Whole warps, a column group's threads within one warp (the
    reduce-scatter is warp shuffles), and the kernel's own shared-memory
    sum (csrc/recurrence.cu: the mbarriers' 128 bytes, two stages of r, k,
    w, v boxes, the y columns in two tiles)."""
    cs, re, ce = rk.RWKV6_INSTANCE[Dh]
    for itemsize in (2, 4):
        geo = rk.rwkv6_geometry(1, 2, Dh, itemsize)
        assert geo["threads"] % 32 == 0 and Dh // re <= 32
        assert geo["smem"] == (128 + 2 * 4 * 32 * Dh * itemsize
                               + 2 * 32 * (Dh // cs) * 4) <= BLOCK_SMEM


@pytest.mark.parametrize("P,N", [(p, n) for p in rk.DIMS for n in rk.DIMS])
def test_mamba2_geometry(P, N):
    """bf16 takes the chunked kernel, two blocks per SM; float32 the
    stepwise one without dynamic shared memory."""
    geo = rk.mamba2_geometry(4, 64, P, N, torch.bfloat16)
    assert geo["kernel"] == "chunked" and geo["threads"] == 128
    assert geo["blocks"] == 4 * 64
    per_sm, fits = _resident_per_sm(geo)
    assert per_sm == 2 and fits
    f32 = rk.mamba2_geometry(4, 64, P, N, torch.float32)
    assert f32 == {"kernel": "stepwise", "blocks": 256, "threads": 4 * P,
                   "smem": 0}


def test_scan_launchers_refuse_cpu_tensors():
    _, targs = _rwkv_args((1, 8, 2, 16), "f32", seed=17)
    with pytest.raises(ValueError, match="CUDA"):
        rk.rwkv6_scan(*targs)
    _, targs = _ssd_args((1, 8, 2, 16, 16), "f32", seed=18)
    with pytest.raises(ValueError, match="CUDA"):
        rk.mamba2_ssd(*targs)
