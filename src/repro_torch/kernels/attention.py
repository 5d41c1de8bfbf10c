"""Launchers of the CUDA attention kernels (``csrc/attention.cu``).

Each launcher checks what the kernel takes (device, dtype, shape,
contiguity), allocates the output and any scratch, launches on the current
stream of the tensors' device and raises if the launch was refused.  It does
not synchronise.  The kernels replace the Pallas TPU kernels
``repro/kernels/flash_attention.py:flash_attention`` and
``repro/kernels/decode_attention.py:decode_attention``; ``kernels.ref``
holds their plain versions."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
FLASH_MAX_GROUP = 64      # query heads per kv head: the block's 64 rows
DECODE_MAX_GROUP = 16     # the decode kernel's register accumulators


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_q(q: torch.Tensor, max_group: int, H: int, Hkv: int):
    if not q.is_cuda:
        raise ValueError(f"the CUDA attention kernels take CUDA tensors; q is "
                         f"on {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, D), got {tuple(q.shape)}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS}, got "
                         f"{q.shape[3]}")
    if Hkv < 1 or H % Hkv or H // Hkv > max_group:
        raise ValueError(f"{H} query heads on {Hkv} kv heads: need a group "
                         f"size H / Hkv that is an integer <= {max_group}")
    _check(q, "q", q.dtype, tuple(q.shape), q.device)


def _raise_on(rc: int, kernel: str):
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")


def flash_attention(q, k, v, *, causal=True, window=0) -> torch.Tensor:
    """q: (B, S, H, D); k/v: (B, Skv, Hkv, D), Skv >= S; float32 or
    bfloat16, contiguous, on one CUDA device.  Returns (B, S, H, D) in q's
    dtype."""
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    _check_q(q, FLASH_MAX_GROUP, H, Hkv)
    dev = q.device
    _check(k, "k", q.dtype, (B, Skv, Hkv, D), dev)
    _check(v, "v", q.dtype, (B, Skv, Hkv, D), dev)
    if Skv < S:
        raise ValueError(f"queries are right-aligned: Skv ({Skv}) < S ({S})")
    out = torch.empty_like(q)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            Skv, H, Hkv, D, DTYPES[q.dtype], int(bool(causal)), int(window),
            stream)
    _raise_on(rc, "flash_attention")
    return out


def decode_attention(q, k, v, kv_len, *, window=0) -> torch.Tensor:
    """q: (B, 1, H, D); k/v: (B, Smax, Hkv, D) caches in q's dtype; kv_len:
    (B,) int32 live prefix lengths in [1, Smax].  Contiguous, on one CUDA
    device.  Returns (B, 1, H, D) in q's dtype."""
    B, _, H, D = q.shape
    Smax, Hkv = k.shape[1], k.shape[2]
    _check_q(q, DECODE_MAX_GROUP, H, Hkv)
    dev = q.device
    _check(q, "q", q.dtype, (B, 1, H, D), dev)
    _check(k, "k", q.dtype, (B, Smax, Hkv, D), dev)
    _check(v, "v", q.dtype, (B, Smax, Hkv, D), dev)
    _check(kv_len, "kv_len", torch.int32, (B,), dev)
    out = torch.empty_like(q)
    lib = _build.load()
    G = H // Hkv
    chunks = lib.decode_attention_chunks(Smax)
    part_m = torch.empty((B, Hkv, chunks, G), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_o = torch.empty((B, Hkv, chunks, G, D), dtype=torch.float32,
                         device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), B, Smax, H, Hkv, D, DTYPES[q.dtype], int(window),
            part_m.data_ptr(), part_l.data_ptr(), part_o.data_ptr(), stream)
    _raise_on(rc, "decode_attention")
    return out
