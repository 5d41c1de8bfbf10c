"""Launchers of the CUDA forest kernels (``csrc/forest.cu``).

Each launcher checks what the kernel takes (device, dtype, shape,
contiguity), takes the output the caller gives or allocates one, launches
on the current stream of the tensors' device and raises if the launch was
refused.  It does not synchronise, unless the caller hands it pinned host
buffers (``host``): then the C entry point copies the rows in before the
launch and the scores out after it, on the same stream, and waits for them
(one copy each way and one synchronisation per decision, with no Python
between them).  The kernels replace the Pallas TPU kernels
``repro/kernels/forest.py:forest_infer`` and ``forest_infer_grouped``;
``kernels.ref`` holds their plain versions.

The launch runs once per scheduling decision, so its host work is kept
short: the model tensors (built once by ``ForestParams.on`` /
``PackedForests.on`` and kept) and the staging buffers are checked once per
set of tensor objects, the device is switched only when it is not the
current one, and the stream is read as a raw handle."""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build

# tensors already checked together: (device index, ids) -> the tensors, kept
# so that their ids are not reused while the entry lives
_CHECKED: dict = {}
_CHECKED_MAX = 64
_CHECKED_LOCK = threading.Lock()


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_x(x: torch.Tensor):
    if not x.is_cuda:
        raise ValueError(f"the CUDA forest kernels take CUDA tensors; x is on "
                         f"{x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (rows, features), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be {torch.float32}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def _check_once(x: torch.Tensor, named: tuple, check):
    """Run ``check(device)`` once per (x's device, tensor objects)."""
    key = (x.get_device(), *(id(t) for _, t in named))
    hit = _CHECKED.get(key)
    if hit is not None and all(a is t for a, (_, t) in zip(hit, named)):
        return
    check(x.device)
    with _CHECKED_LOCK:
        if len(_CHECKED) >= _CHECKED_MAX:
            _CHECKED.pop(next(iter(_CHECKED)), None)
        _CHECKED[key] = tuple(t for _, t in named)


def _output(out, host, n: int, x: torch.Tensor) -> tuple:
    """(out, host_in address, its bytes, host_out address) for the C entry
    point: ``out`` or a new (n,) output, and the host buffers, or (None, 0,
    None) without ``host``.  host_in's words go to x's address, so they must
    fit x's buffer from there.  The buffers of a staged call (reused from
    call to call) are checked once, with ``out``."""
    if out is None:
        out = torch.empty(n, dtype=torch.float32, device=x.device)
    elif host is None:
        _check(out, "out", torch.float32, (n,), x.device)
    if host is None:
        return out, None, 0, None
    host_in, host_out = host

    def check(dev):
        _check(out, "out", torch.float32, (n,), dev)
        for name, t in (("host_in", host_in), ("host_out", host_out)):
            if t.is_cuda or not t.is_pinned():
                raise ValueError(f"{name} must be pinned host memory")
            if t.dtype != torch.float32:
                raise TypeError(f"{name} must be {torch.float32}, got "
                                f"{t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if tuple(host_out.shape) != (n,):
            raise ValueError(f"host_out must have shape ({n},), got "
                             f"{tuple(host_out.shape)}")
        room = x.untyped_storage().nbytes() - 4 * x.storage_offset()
        if 4 * host_in.numel() > room:
            raise ValueError(f"host_in holds {host_in.numel()} words, x's "
                             f"buffer {room // 4} from x on")

    _check_once(x, (("host_in", host_in), ("host_out", host_out), ("x", x),
                    ("out", out)), check)
    return out, host_in.data_ptr(), 4 * host_in.numel(), host_out.data_ptr()


def _launch(fn, x: torch.Tensor, *args) -> int:
    """Call the C entry point on x's device and its current stream."""
    index = x.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def _raise_on(rc: int, kernel: str):
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")


def forest_infer(x, feat_idx, thresholds, leaves, out=None,
                 host=None) -> torch.Tensor:
    """x: (B, F) float32; feat_idx: (T, D) int32; thresholds: (T, D) float32;
    leaves: (T, 2^D) float32, all contiguous on one CUDA device.
    Returns (B,) float32 mean leaf values, in ``out`` when given.  ``host``
    = (host_in, host_out), pinned float32: host_in is copied to x's address
    first, and the scores are in host_out when the call returns."""
    _check_x(x)
    B, F = x.shape
    T, D = feat_idx.shape

    def check(dev):
        _check(feat_idx, "feat_idx", torch.int32, (T, D), dev)
        _check(thresholds, "thresholds", torch.float32, (T, D), dev)
        _check(leaves, "leaves", torch.float32, (T, 1 << D), dev)
        if T < 1:
            raise ValueError("a forest needs at least one tree")

    _check_once(x, (("feat_idx", feat_idx), ("thresholds", thresholds),
                    ("leaves", leaves)), check)
    out, *copies = _output(out, host, B, x)
    rc = _launch(_build.load().forest_infer_launch, x, x.data_ptr(), B, F,
                 feat_idx.data_ptr(), thresholds.data_ptr(),
                 leaves.data_ptr(), T, D, out.data_ptr(), *copies)
    _raise_on(rc, "forest_infer")
    return out


def forest_infer_grouped(x, seg_start, feat_idx, thresholds, leaves,
                         n_trees, out=None, host=None) -> torch.Tensor:
    """x: (R, F) float32 rows stacked segment by segment; seg_start: (M+1,)
    int32 offsets (seg_start[0] == 0, seg_start[M] == R, non-decreasing);
    feat_idx/thresholds: (M, T, D) padded blocks; leaves: (M, T, 2^D);
    n_trees: (M,) int32 true tree counts in [1, T].  All contiguous on one
    CUDA device.  Returns (R,) float32, row r scored by its own segment, in
    ``out`` when given.  ``host`` as in ``forest_infer`` (host_in then holds
    the rows and, after them, the offsets, where seg_start lies)."""
    _check_x(x)
    R, F = x.shape
    M, T, D = feat_idx.shape
    _check(seg_start, "seg_start", torch.int32, (M + 1,), x.device)

    def check(dev):
        _check(feat_idx, "feat_idx", torch.int32, (M, T, D), dev)
        _check(thresholds, "thresholds", torch.float32, (M, T, D), dev)
        _check(leaves, "leaves", torch.float32, (M, T, 1 << D), dev)
        _check(n_trees, "n_trees", torch.int32, (M,), dev)

    _check_once(x, (("feat_idx", feat_idx), ("thresholds", thresholds),
                    ("leaves", leaves), ("n_trees", n_trees)), check)
    out, *copies = _output(out, host, R, x)
    rc = _launch(_build.load().forest_infer_grouped_launch, x, x.data_ptr(),
                 R, F, seg_start.data_ptr(), M, feat_idx.data_ptr(),
                 thresholds.data_ptr(), leaves.data_ptr(), n_trees.data_ptr(),
                 T, D, out.data_ptr(), *copies)
    _raise_on(rc, "forest_infer_grouped")
    return out
