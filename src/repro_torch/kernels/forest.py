"""Launchers of the CUDA forest kernels (``csrc/forest.cu``).

Each launcher checks what the kernel takes (device, dtype, shape,
contiguity), allocates the output, launches on the current stream of the
tensors' device and raises if the launch was refused.  It does not
synchronise: the caller's ``.cpu()`` does.  The kernels replace the Pallas
TPU kernels ``repro/kernels/forest.py:forest_infer`` and
``forest_infer_grouped``; ``kernels.ref`` holds their plain versions."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


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
    _check(x, "x", torch.float32, tuple(x.shape), x.device)


def _raise_on(rc: int, kernel: str):
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")


def forest_infer(x, feat_idx, thresholds, leaves) -> torch.Tensor:
    """x: (B, F) float32; feat_idx: (T, D) int32; thresholds: (T, D) float32;
    leaves: (T, 2^D) float32, all contiguous on one CUDA device.
    Returns (B,) float32 mean leaf values."""
    _check_x(x)
    B, F = x.shape
    T, D = feat_idx.shape
    dev = x.device
    _check(feat_idx, "feat_idx", torch.int32, (T, D), dev)
    _check(thresholds, "thresholds", torch.float32, (T, D), dev)
    _check(leaves, "leaves", torch.float32, (T, 1 << D), dev)
    if T < 1:
        raise ValueError("a forest needs at least one tree")
    out = torch.empty(B, dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.forest_infer_launch(
            x.data_ptr(), B, F, feat_idx.data_ptr(), thresholds.data_ptr(),
            leaves.data_ptr(), T, D, out.data_ptr(), stream)
    _raise_on(rc, "forest_infer")
    return out


def forest_infer_grouped(x, seg_start, feat_idx, thresholds, leaves,
                         n_trees) -> torch.Tensor:
    """x: (R, F) float32 rows stacked segment by segment; seg_start: (M+1,)
    int32 offsets (seg_start[0] == 0, seg_start[M] == R, non-decreasing);
    feat_idx/thresholds: (M, T, D) padded blocks; leaves: (M, T, 2^D);
    n_trees: (M,) int32 true tree counts in [1, T].  All contiguous on one
    CUDA device.  Returns (R,) float32, row r scored by its own segment."""
    _check_x(x)
    R, F = x.shape
    M, T, D = feat_idx.shape
    dev = x.device
    _check(seg_start, "seg_start", torch.int32, (M + 1,), dev)
    _check(feat_idx, "feat_idx", torch.int32, (M, T, D), dev)
    _check(thresholds, "thresholds", torch.float32, (M, T, D), dev)
    _check(leaves, "leaves", torch.float32, (M, T, 1 << D), dev)
    _check(n_trees, "n_trees", torch.int32, (M,), dev)
    out = torch.empty(R, dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.forest_infer_grouped_launch(
            x.data_ptr(), R, F, seg_start.data_ptr(), M, feat_idx.data_ptr(),
            thresholds.data_ptr(), leaves.data_ptr(), n_trees.data_ptr(), T,
            D, out.data_ptr(), stream)
    _raise_on(rc, "forest_infer_grouped")
    return out
