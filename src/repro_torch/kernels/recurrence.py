"""Launchers of the CUDA recurrence kernels (``csrc/recurrence.cu``).

Each launcher checks what the kernel takes (device, dtype, shape,
contiguity), allocates the outputs, launches on the current stream of the
tensors' device and raises if the launch was refused.  It does not
synchronise.  The kernels replace the Pallas TPU kernels
``repro/kernels/rwkv6_scan.py:rwkv6_scan`` and
``repro/kernels/mamba2_ssd.py:mamba2_ssd``; ``kernels.ref`` holds their plain
versions."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.attention import DTYPES, _check, _raise_on

DIMS = (16, 32, 64)       # rwkv6 head_dim; mamba2 head_dim P and state N


def _check_lead(x: torch.Tensor, name: str, ndim: int):
    if not x.is_cuda:
        raise ValueError(f"the CUDA recurrence kernels take CUDA tensors; "
                         f"{name} is on {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions, got "
                         f"{tuple(x.shape)}")
    _check(x, name, x.dtype, tuple(x.shape), x.device)


def _check_dim(name: str, n: int):
    if n not in DIMS:
        raise ValueError(f"{name} must be one of {DIMS}, got {n}")


def rwkv6_scan(r, k, v, w, u, state0):
    """r, k, v, w: (B, S, H, Dh) float32 or bfloat16; u: (H, Dh) in r's
    dtype; state0: (B, H, Dh, Dh) float32.  Contiguous, on one CUDA device.
    Returns y (B, S, H, Dh) in r's dtype and the final state, float32."""
    _check_lead(r, "r", 4)
    B, S, H, Dh = r.shape
    _check_dim("head_dim", Dh)
    dev = r.device
    for name, t in (("k", k), ("v", v), ("w", w)):
        _check(t, name, r.dtype, (B, S, H, Dh), dev)
    _check(u, "u", r.dtype, (H, Dh), dev)
    _check(state0, "state0", torch.float32, (B, H, Dh, Dh), dev)
    y = torch.empty_like(r)
    state = torch.empty_like(state0)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rwkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state0.data_ptr(), y.data_ptr(), state.data_ptr(),
            B, S, H, Dh, DTYPES[r.dtype], stream)
    _raise_on(rc, "rwkv6_scan")
    return y, state


def mamba2_ssd(x, dt, A, Bmat, Cmat, state0):
    """x: (B, S, H, P); dt: (B, S, H); B, C: (B, S, N), all float32 or all
    bfloat16; A: (H,) float32; state0: (B, H, P, N) float32.  Contiguous, on
    one CUDA device.  Returns y (B, S, H, P) in x's dtype and the final
    state, float32."""
    _check_lead(x, "x", 4)
    Bb, S, H, P = x.shape
    N = Bmat.shape[-1] if Bmat.dim() == 3 else -1
    _check_dim("head_dim P", P)
    _check_dim("state_dim N", N)
    dev = x.device
    _check(dt, "dt", x.dtype, (Bb, S, H), dev)
    _check(A, "A", torch.float32, (H,), dev)
    _check(Bmat, "B", x.dtype, (Bb, S, N), dev)
    _check(Cmat, "C", x.dtype, (Bb, S, N), dev)
    _check(state0, "state0", torch.float32, (Bb, H, P, N), dev)
    y = torch.empty_like(x)
    state = torch.empty_like(state0)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mamba2_ssd_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
            Cmat.data_ptr(), state0.data_ptr(), y.data_ptr(),
            state.data_ptr(), Bb, S, H, P, N, DTYPES[x.dtype], stream)
    _raise_on(rc, "mamba2_ssd")
    return y, state
