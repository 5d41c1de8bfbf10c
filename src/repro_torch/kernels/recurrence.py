"""Launchers of the CUDA recurrence kernels (``csrc/recurrence.cu``).

Each launcher checks what the kernel takes (device, dtype, shape,
contiguity), allocates the outputs, launches on the current stream of the
tensors' device and raises if the launch was refused.  It does not
synchronise.  A ``meta`` tensor (the dry run under ``launch/cost.py``'s
counting mode) passes the same checks and gets its outputs without a
launch.  The kernels replace the Pallas TPU kernels
``repro/kernels/rwkv6_scan.py:rwkv6_scan`` and
``repro/kernels/mamba2_ssd.py:mamba2_ssd``; ``kernels.ref`` holds their plain
versions (and ``mamba2_ssd_chunked_ref``, the bf16 SSD kernel's algorithm).

The C entry points pick the kernel instance from the head and state sizes.
The launch geometry they make is also computed here, so that the CPU tests
can check it: ``rwkv6_geometry`` (the (CS, RE, CE) instance: CS blocks per
head, an RE x CE tile of the state per thread; blocks, threads, shared
bytes) and ``mamba2_geometry`` (the chunked tensor-core kernel for bf16,
the stepwise one for float32).  ``built_geometry`` asks the library for
its own, and a card test holds the two together."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.attention import DTYPES, _check, _on, _raise_on

DIMS = (16, 32, 64)       # rwkv6 head_dim; mamba2 head_dim P and state N
RWKV6_STEPS = 32          # steps staged at a time (RW_TC)
RWKV6_STAGES = 2          # the raw staging ring (RW_STAGES)
# the compiled (CS, RE, CE) instance by head_dim: CS blocks per head, each
# thread an RE x CE tile of the state.  At 64, (2, 4, 4) was timed against
# (2, 2, 4) and (2, 4, 2) and kept (PERF.md)
RWKV6_INSTANCE = {16: (1, 2, 4), 32: (1, 4, 4), 64: (2, 4, 4)}
SSD_CHUNK = 64            # steps per chunk of the bf16 SSD kernel (SSD_L)
SSD_THREADS = 128         # the bf16 SSD kernel's four warps (SSD_THREADS)
SSD_QSPLIT = 4            # threads per state row of the float32 kernel


def rwkv6_smem_bytes(Dh: int, cs: int, itemsize: int) -> int:
    """``csrc/recurrence.cu:rwkv6_smem_bytes``: 128 bytes for the stages'
    mbarriers (the boxes after them 128-byte aligned), the staged r, k, w,
    v boxes (two stages, the inputs' dtype) and the block's y columns of a
    chunk as float32, in two tiles (one per chunk parity)."""
    T = RWKV6_STEPS
    return (128 + RWKV6_STAGES * 4 * T * Dh * itemsize
            + 2 * T * (Dh // cs) * 4)


def rwkv6_geometry(B: int, H: int, Dh: int, itemsize: int) -> dict:
    """The launch of ``rwkv6_scan_kernel<T, Dh, CS, RE, CE>``: B * H * CS
    blocks of (Dh / CS / CE) * (Dh / RE) threads, a thread per RE rows x CE
    value columns of the state."""
    cs, re, ce = RWKV6_INSTANCE[Dh]
    return {"instance": (cs, re, ce), "blocks": B * H * cs,
            "threads": Dh // cs // ce * (Dh // re),
            "smem": rwkv6_smem_bytes(Dh, cs, itemsize)}


def mamba2_smem_bytes(P: int, N: int) -> int:
    """``csrc/recurrence.cu:mamba2_chunked_smem_bytes``: 1 KB of slack to
    align the swizzled tiles, bf16 tiles (two stages of x, B and C as TMA
    writes them, dense; the scaled x and S_in as hi + lo pairs and y, rows
    padded by 8 elements), two chunks' float32 rows (dt, cs and the
    decays, 4 + SSD_CHUNK / 16 rows a chunk) and two mbarriers."""
    L = SSD_CHUNK
    return (1024 + 2 * (2 * L * P + 4 * L * N + 2 * L * (P + 8)
                        + 2 * P * (N + 8) + L * (P + 8))
            + 2 * 4 * (4 + L // 16) * L + 16)


def mamba2_geometry(B: int, H: int, P: int, N: int,
                    dtype: torch.dtype) -> dict:
    """bf16: ``mamba2_ssd_chunked_kernel<P, N>`` (a block of SSD_THREADS per
    (b, h), chunks of SSD_CHUNK steps on the tensor cores); float32:
    ``mamba2_ssd_kernel`` (stepwise, SSD_QSPLIT threads per state row,
    static shared memory only)."""
    if dtype == torch.bfloat16:
        return {"kernel": "chunked", "blocks": B * H,
                "threads": SSD_THREADS, "smem": mamba2_smem_bytes(P, N)}
    return {"kernel": "stepwise", "blocks": B * H,
            "threads": SSD_QSPLIT * P, "smem": 0}


def built_geometry(kernel: str, dims: tuple, dtype: torch.dtype) -> dict:
    """The launch the built library makes for ``kernel`` ("rwkv6_scan" with
    dims (Dh,), "mamba2_ssd" with (P, N)) at B = H = 1: blocks, threads and
    dynamic shared bytes, as ``rwkv6_geometry`` and ``mamba2_geometry``
    give them.  Builds the library (needs nvcc)."""
    import ctypes
    lib = _build.load()
    out = (ctypes.c_int * 3)()
    query = (lib.rwkv6_scan_geometry if kernel == "rwkv6_scan"
             else lib.mamba2_ssd_geometry)
    _raise_on(query(*dims, DTYPES[dtype], out), f"{kernel} geometry")
    return {"blocks": out[0], "threads": out[1], "smem": out[2]}


def _check_lead(x: torch.Tensor, name: str, ndim: int):
    if not (x.is_cuda or x.is_meta):
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
    if r.is_meta:                   # the dry run: checked, not launched
        return y, state
    lib = _build.load()
    with _on(dev):
        rc = lib.rwkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state0.data_ptr(), y.data_ptr(), state.data_ptr(),
            B, S, H, Dh, DTYPES[r.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "rwkv6_scan")
    return y, state


def mamba2_ssd(x, dt, A, Bmat, Cmat, state0):
    """x: (B, S, H, P); dt: (B, S, H); B, C: (B, S, N), all float32 or all
    bfloat16; A: (H,) float32; state0: (B, H, P, N) float32.  Contiguous, on
    one CUDA device.  Returns y (B, S, H, P) in x's dtype and the final
    state, float32.  bf16 runs the chunked kernel on the tensor cores,
    float32 the stepwise one on the CUDA cores."""
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
    if x.is_meta:                   # the dry run: checked, not launched
        return y, state
    lib = _build.load()
    with _on(dev):
        rc = lib.mamba2_ssd_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
            Cmat.data_ptr(), state0.data_ptr(), y.data_ptr(),
            state.data_ptr(), Bb, S, H, P, N, DTYPES[x.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "mamba2_ssd")
    return y, state
