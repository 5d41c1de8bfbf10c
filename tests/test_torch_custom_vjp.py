"""The port's chunked adjoints of the recurrences (``kernels/ref.py``:
``RWKV6Scan``, ``SSDScan``) against the JAX package's custom VJPs
(``repro/kernels/ref.py:rwkv6_scan_ref``, ``mamba2_ssd_ref``) and against
autograd through the port's stepwise plain versions, mirroring
tests/test_custom_vjp.py: the same loss, sin(y).sum() + 0.1 (state**2).sum(),
and its tolerance, rtol 3e-4 / atol 3e-5 on every gradient (float32; the
adjoint sums its terms in another order than the step-by-step backward).
Cases add S above the 128-step chunk (several chunks) and S that 128 does not
divide (chunks of its largest divisor below 128).  The wrapper leaves the
forward unchanged: bitwise equal to the stepwise version.  Attention's
autograd Function (``kernels/ops.py:FlashAttention``) is held to autograd
through the plain version (bitwise: its backward is that) and to the JAX
package's gradients (rtol 1e-5 / atol 1e-5).  Inputs come from numpy
seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

TOL = dict(rtol=3e-4, atol=3e-5)
RWKV_CASES = [(2, 64, 3, 8), (1, 96, 2, 16), (1, 256, 2, 8), (2, 300, 2, 8)]
SSD_CASES = [(2, 64, 3, 8, 5), (1, 96, 2, 16, 8), (1, 256, 2, 8, 4),
             (2, 300, 2, 8, 4)]


def _rwkv_inputs(B, S, H, Dh, seed=0):
    rs = np.random.RandomState(seed)
    r, k, v = (rs.randn(B, S, H, Dh).astype(np.float32) for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rs.randn(B, S, H, Dh)))).astype(np.float32)
    u = (0.2 * rs.randn(H, Dh)).astype(np.float32)
    s0 = rs.randn(B, H, Dh, Dh).astype(np.float32)
    return r, k, v, w, u, s0


def _ssd_inputs(B, S, H, P, N, seed=1):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, S, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rs.randn(B, S, H))).astype(np.float32)
    A = (-np.exp(0.3 * rs.randn(H))).astype(np.float32)
    Bm, Cm = (rs.randn(B, S, N).astype(np.float32) for _ in range(2))
    s0 = rs.randn(B, H, P, N).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


def _jax_grads(fn, args):
    def loss(*a):
        y, sf = fn(*a)
        return jnp.sin(y).sum() + (sf ** 2).sum() * 0.1
    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(
        range(len(args))))(*map(jnp.asarray, args))]


def _torch_grads(fn, args):
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    y, sf = fn(*leaves)
    loss = torch.sin(y).sum() + (sf ** 2).sum() * 0.1
    return (y.detach(), sf.detach()), [
        g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _assert_close(got, want, names):
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


@pytest.mark.parametrize("B,S,H,Dh", RWKV_CASES)
def test_rwkv6_adjoint_matches_reference_vjp_and_autograd(B, S, H, Dh):
    args = _rwkv_inputs(B, S, H, Dh)
    names = "r k v w u s0".split()
    (y, sf), got = _torch_grads(ref.rwkv6_scan_chunked, args)
    _assert_close(got, _jax_grads(jref.rwkv6_scan_ref, args), names)
    (y0, s0), plain = _torch_grads(ref.rwkv6_scan_ref, args)
    _assert_close(got, plain, names)
    assert torch.equal(y, y0) and torch.equal(sf, s0)   # forward unchanged


@pytest.mark.parametrize("B,S,H,P,N", SSD_CASES)
def test_mamba2_adjoint_matches_reference_vjp_and_autograd(B, S, H, P, N):
    args = _ssd_inputs(B, S, H, P, N)
    names = "x dt A B C s0".split()
    (y, sf), got = _torch_grads(ref.mamba2_ssd_chunked, args)
    _assert_close(got, _jax_grads(jref.mamba2_ssd_ref, args), names)
    (y0, s0), plain = _torch_grads(ref.mamba2_ssd_ref, args)
    _assert_close(got, plain, names)
    assert torch.equal(y, y0) and torch.equal(sf, s0)   # forward unchanged


def test_mamba2_adjoint_with_strong_decays():
    """A from -1 down to -50 across the heads: dt A far below where exp
    underflows, the decay matrix's off-diagonal terms 0."""
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(1, 200, 4, 8, 4, seed=2)
    A = -np.linspace(1.0, 50.0, 4).astype(np.float32)
    args = (x, dt, A, Bm, Cm, s0)
    _, got = _torch_grads(ref.mamba2_ssd_chunked, args)
    assert all(np.isfinite(g).all() for g in got)
    _assert_close(got, _jax_grads(jref.mamba2_ssd_ref, args),
                  "x dt A B C s0".split())


@pytest.mark.parametrize("S,chunk", [(64, 64), (256, 128), (300, 100),
                                     (257, 1)])
def test_chunk_is_the_references(S, chunk):
    assert ref.divisor_chunk(S, ref.RWKV_CHUNK) == chunk
    assert ref.divisor_chunk(S, ref.SSD_CHUNK) == chunk
    assert jref._divisor_chunk(S, jref._RWKV_CHUNK) == chunk


def test_ops_dispatch_the_adjoints_under_grad_on_the_cpu():
    """Under autograd the CPU path is the same Function with the plain
    forward; without grad it is the plain version itself."""
    args = _rwkv_inputs(1, 200, 2, 8)
    (_, _), via_ops = _torch_grads(ops.rwkv6_scan, args)
    (_, _), direct = _torch_grads(ref.rwkv6_scan_chunked, args)
    for a, b in zip(via_ops, direct):
        assert np.array_equal(a, b)
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    y, _ = ops.rwkv6_scan(*leaves)
    assert y.grad_fn is not None and "RWKV6Scan" in type(y.grad_fn).__name__
    sargs = [torch.tensor(a, requires_grad=True)
             for a in _ssd_inputs(1, 200, 2, 8, 4)]
    y, _ = ops.mamba2_ssd(*sargs)
    assert "SSDScan" in type(y.grad_fn).__name__
    with torch.no_grad():
        y, _ = ops.mamba2_ssd(*sargs)
    assert y.grad_fn is None


def test_adjoint_gradients_keep_the_input_dtypes():
    r, k, v, w, u, s0 = (torch.tensor(a) for a in _rwkv_inputs(1, 130, 2, 8))
    leaves = [t.to(torch.bfloat16).requires_grad_() for t in (r, k, v, w, u)]
    s0 = s0.requires_grad_()
    y, sf = ref.rwkv6_scan_chunked(*leaves, s0)
    assert y.dtype == torch.bfloat16 and sf.dtype == torch.float32
    grads = torch.autograd.grad(y.float().sum() + sf.sum(), leaves + [s0])
    assert [g.dtype for g in grads] == [torch.bfloat16] * 5 + [torch.float32]
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8), (False, 0)])
def test_flash_attention_function_matches_plain_autograd_and_reference(
        causal, window):
    rs = np.random.RandomState(4)
    q = rs.randn(2, 24, 4, 16).astype(np.float32)
    k, v = (rs.randn(2, 24, 2, 16).astype(np.float32) for _ in range(2))
    cot = rs.randn(2, 24, 4, 16).astype(np.float32)

    def grads(fn):
        leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        out = fn(*leaves, causal=causal, window=window)
        return out, torch.autograd.grad((out * torch.tensor(cot)).sum(),
                                        leaves)
    out, got = grads(ops.flash_attention)
    assert type(out.grad_fn).__name__.startswith("FlashAttention")
    _, plain = grads(ref.flash_attention_ref)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    want = jax.grad(lambda *a: (jref.flash_attention_ref(
        *a, causal=causal, window=window) * cot).sum(), argnums=(0, 1, 2))(
        q, k, v)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_backward_recomputes_in_one_block(causal):
    """The Function's backward recomputes the plain version in one block:
    its gradients equal autograd through the plain version at
    q_chunk = S and kv_chunk = Skv, and agree within 1e-5 with the plain
    version's default 512-row chunks (S = 600 and Skv = 700 span two
    chunks of each)."""
    rs = np.random.RandomState(6)
    q = rs.randn(1, 600, 4, 8).astype(np.float32)
    k, v = (rs.randn(1, 700, 2, 8).astype(np.float32) for _ in range(2))
    cot = torch.tensor(rs.randn(1, 600, 4, 8).astype(np.float32))

    def grads(fn, **kw):
        leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        out = fn(*leaves, causal=causal, **kw)
        return torch.autograd.grad((out * cot).sum(), leaves)
    got = grads(ops.flash_attention)
    whole = grads(ref.flash_attention_ref, q_chunk=600, kv_chunk=700)
    chunked = grads(ref.flash_attention_ref)
    for a, b, c in zip(got, whole, chunked):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)
