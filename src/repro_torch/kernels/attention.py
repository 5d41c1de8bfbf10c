"""Launchers of the CUDA attention kernels (``csrc/flash_attention.cu``,
``csrc/decode_attention.cu``).

Each launcher checks what the kernel takes (device, dtype, shape,
contiguity), allocates the output, launches on the current stream of the
tensors' device and raises if the launch was refused.  It allocates no
scratch and does not synchronise.  A ``meta`` tensor (the dry run under
``launch/cost.py``'s counting mode) passes the same checks and gets its
output without a launch.  The kernels replace the Pallas TPU
kernels ``repro/kernels/flash_attention.py:flash_attention`` and
``repro/kernels/decode_attention.py:decode_attention``; ``kernels.ref``
holds their plain versions.

The launch geometry is computed here, or mirrored here where the kernel
computes it from data on the card, so that the CPU tests can check it:
``flash_schedule`` (the query tiles in launch order and the key tiles each
visits) and ``decode_blocks`` / ``decode_block_ranges`` (the cluster size
and each block's share of the live keys)."""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims both kernels are compiled for; 160 is stablelm-12b's (5120 /
# 32), which the kernels take as it is (no padding of the cache)
HEAD_DIMS = (32, 64, 128, 160)
FLASH_MAX_GROUP = 64      # query heads per kv head: the float32 block's rows
DECODE_MAX_GROUP = 16     # the decode kernel's register bucket
FLASH_BLOCK_M = 128       # bf16 kernel: query rows per block (MMA_BM)
FLASH_BLOCK_N = 64        # bf16 kernel: keys per tile (MMA_BN)
DECODE_MAX_BLOCKS = 8     # the portable cluster size
DECODE_KEYS_PER_BLOCK = 128
DECODE_TARGET_BLOCKS = 264  # two blocks on each of the card's 132 SMs


def flash_schedule(S: int, Skv: int, *, causal: bool, window: int) -> list:
    """The bf16 flash kernel's work per query tile, in launch order (the
    grid's slowest dimension, last query tile first): one (s0, s_end,
    k_beg, k_end, n_key_tiles) per tile of FLASH_BLOCK_M query rows, as
    ``flash_attention_mma_kernel`` computes it.  Keys [k_beg, k_end) are the
    ones some row of the tile can see, walked in tiles of FLASH_BLOCK_N."""
    offset = Skv - S
    n_q = -(-S // FLASH_BLOCK_M)
    out = []
    for z in range(n_q):
        s0 = (n_q - 1 - z) * FLASH_BLOCK_M
        s_end = min(s0 + FLASH_BLOCK_M, S)
        pos_first, pos_last = s0 + offset, s_end - 1 + offset
        k_end = min(Skv, pos_last + 1) if causal else Skv
        k_beg = max(0, pos_first - window + 1) if window else 0
        out.append((s0, s_end, k_beg, k_end,
                    -(-(k_end - k_beg) // FLASH_BLOCK_N)))
    return out


def decode_blocks(Smax: int, window: int, pairs: int) -> int:
    """Blocks per (sequence, kv head) cluster for ``pairs`` clusters: at
    least DECODE_KEYS_PER_BLOCK of the longest possible live range each,
    and no more than it takes to give the grid DECODE_TARGET_BLOCKS blocks;
    1 to DECODE_MAX_BLOCKS."""
    live = window if 0 < window < Smax else Smax
    return max(1, min(DECODE_MAX_BLOCKS,
                      -(-live // DECODE_KEYS_PER_BLOCK),
                      -(-DECODE_TARGET_BLOCKS // max(1, pairs))))


def decode_block_ranges(kv_len: int, Smax: int, window: int,
                        n_blocks: int) -> list:
    """The keys [j0, j1) block r of a cluster reads for one sequence, as
    ``decode_attention_kernel`` computes them on the card from kv_len."""
    hi = min(kv_len, Smax)
    lo = max(0, kv_len - window) if window else 0
    live = max(0, hi - lo)
    return [(lo + r * live // n_blocks, lo + (r + 1) * live // n_blocks)
            for r in range(n_blocks)]


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
    if not (q.is_cuda or q.is_meta):
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


def _on(dev: torch.device):
    """A context that makes ``dev`` the current device, entered only when it
    is not already (a single-card process never pays for the switch)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def flash_attention(q, k, v, *, causal=True, window=0) -> torch.Tensor:
    """q: (B, S, H, D); k/v: (B, Skv, Hkv, D); float32 or bfloat16,
    contiguous, on one CUDA device; D in HEAD_DIMS, H / Hkv <=
    FLASH_MAX_GROUP.  Returns (B, S, H, D) in q's dtype.
    bfloat16 runs on the tensor cores, float32 on the CUDA cores.  Queries
    are right-aligned (query i at position i + Skv - S), so Skv >= S unless
    nothing is masked (not causal, no window): then every query sees every
    key and cross-attention may have fewer keys than queries."""
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if Skv < S and (causal or window):
        raise ValueError(f"queries are right-aligned: Skv ({Skv}) < S ({S}) "
                         "only without a causal mask or a window")
    _check_q(q, FLASH_MAX_GROUP, H, Hkv)
    dev = q.device
    _check(k, "k", q.dtype, (B, Skv, Hkv, D), dev)
    _check(v, "v", q.dtype, (B, Skv, Hkv, D), dev)
    out = torch.empty_like(q)
    if q.is_meta:                   # the dry run: checked, not launched
        return out
    lib = _build.load()
    with _on(dev):
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            Skv, H, Hkv, D, DTYPES[q.dtype], int(bool(causal)), int(window),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "flash_attention")
    return out


def _check_decode(q, k, v, kv_len):
    B, _, H, D = q.shape
    Smax, Hkv = k.shape[1], k.shape[2]
    _check_q(q, DECODE_MAX_GROUP, H, Hkv)
    dev = q.device
    if q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, D), got {tuple(q.shape)}")
    _check(k, "k", q.dtype, (B, Smax, Hkv, D), dev)
    _check(v, "v", q.dtype, (B, Smax, Hkv, D), dev)
    _check(kv_len, "kv_len", torch.int32, (B,), dev)


def decode_attention(q, k, v, kv_len, *, window=0) -> torch.Tensor:
    """q: (B, 1, H, D); k/v: (B, Smax, Hkv, D) caches in q's dtype; kv_len:
    (B,) int32 live prefix lengths in [1, Smax]; D in HEAD_DIMS, H / Hkv <=
    DECODE_MAX_GROUP.  Contiguous, on one CUDA device.  Returns (B, 1, H, D) in q's dtype: one launch, nothing
    allocated but the output."""
    B, _, H, D = q.shape
    Smax, Hkv = k.shape[1], k.shape[2]
    _check_decode(q, k, v, kv_len)
    dev = q.device
    out = torch.empty_like(q)
    if q.is_meta:                   # the dry run: checked, not launched
        return out
    lib = _build.load()
    with _on(dev):
        rc = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), B, Smax, H, Hkv, D, DTYPES[q.dtype], int(window),
            decode_blocks(Smax, int(window), B * Hkv),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "decode_attention")
    return out


def decode_attention_partial(q, k, v, kv_len, *, start: int, window=0):
    """The decode kernel's partial mode on one slice of a cache cut along
    its sequence: k/v (B, Smax, Hkv, D) hold global positions [start,
    start + Smax); kv_len (B,) int32 (any value >= 0) and ``window`` are
    the whole cache's.  q, k, v as for ``decode_attention``.  Returns (o
    (B, 1, H, D), m (B, H), l (B, H)), float32: the output against its max
    m, not divided by the sum l of its weights; a sequence with no live key
    in the slice gets o = 0, l = 0 and m = -inf.  ``ref.merge_partials``
    merges the slices."""
    B, _, H, D = q.shape
    Smax, Hkv = k.shape[1], k.shape[2]
    _check_decode(q, k, v, kv_len)
    if start < 0:
        raise ValueError(f"start must be >= 0, got {start}")
    dev = q.device
    o = torch.empty(q.shape, dtype=torch.float32, device=dev)
    m = torch.empty(B, H, dtype=torch.float32, device=dev)
    l = torch.empty(B, H, dtype=torch.float32, device=dev)
    if q.is_meta:                   # the dry run: checked, not launched
        return o, m, l
    lib = _build.load()
    with _on(dev):
        rc = lib.decode_attention_partial_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            o.data_ptr(), m.data_ptr(), l.data_ptr(), B, Smax, H, Hkv, D,
            DTYPES[q.dtype], int(window), int(start),
            decode_blocks(Smax, int(window), B * Hkv),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "decode_attention_partial")
    return o, m, l
