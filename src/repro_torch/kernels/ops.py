"""Device rule and kernel dispatch.

Every op takes ``impl``:
  None      by device: the CUDA kernel for CUDA tensors, the plain torch
            version (``ref.py``) for CPU tensors.
  "cuda"    the CUDA kernel; raises on CPU tensors.
  "torch"   the plain torch version, on any device.  On CUDA tensors only
            when asked for explicitly (``chip_smoke.py`` compares the two).

A launch counter per kernel counts the launches made through these
wrappers, so a run can show that its main path went through the kernels.

Under autograd (grad enabled and an input that requires grad) the three
training kernels run inside a ``torch.autograd.Function``: the forward is
the same kernel (or, on the CPU, the same plain version) and the backward is
plain torch, as the reference trains through ``ref.py`` on every impl.
``flash_attention``'s backward recomputes the plain version under autograd
(what the reference's ``jax.checkpoint`` blocks do, here in one block);
the scans' forward runs chunk by chunk, one kernel launch per chunk from
the previous chunk's final state (the kernels return only the final
state, and the adjoint needs each chunk's first), and their backward is
the chunked adjoint
(``ref.RWKV6Scan``, ``ref.SSDScan``).  Every forward launch counts, the
recomputation of a rematerialised layer's forward included."""

from __future__ import annotations

import functools
import threading

import torch

from repro_torch.kernels import ref

IMPLS = ("torch", "cuda")
KERNELS = ("forest_infer", "forest_infer_grouped", "flash_attention",
           "decode_attention", "rwkv6_scan", "mamba2_ssd")

_COUNT_LOCK = threading.Lock()
_LAUNCHES = dict.fromkeys(KERNELS, 0)


def resolve_device(device=None) -> torch.device:
    """The device rule of the port: ``None`` means CUDA, and without a GPU
    that raises instead of running on the CPU; CPU runs say so with
    ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    return dev


def launch_counts() -> dict:
    with _COUNT_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts():
    with _COUNT_LOCK:
        for k in _LAUNCHES:
            _LAUNCHES[k] = 0


def _count(kernel: str):
    with _COUNT_LOCK:
        _LAUNCHES[kernel] += 1


def _resolve(impl: str | None, x: torch.Tensor, name: str = "x") -> str:
    if impl is None:
        return "cuda" if x.is_cuda else "torch"
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS} or None, got {impl!r}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(f"impl='cuda' needs CUDA tensors; {name} is on "
                         f"{x.device}")
    return impl


def _plain(out, host, result):
    if host is not None:
        raise ValueError("host staging goes with the CUDA kernel")
    return result if out is None else out.copy_(result)


def forest_infer(x, feat_idx, thresholds, leaves, *, impl=None, out=None,
                 host=None):
    """Mean leaf value of one oblivious forest: x (B, F) -> (B,), written
    into ``out`` (a (B,) float32 tensor on x's device) when given.  The
    kernel also takes ``host`` = (host_in, host_out), pinned buffers that it
    copies to x before the launch and from the scores after it, waiting for
    both (``kernels.forest.forest_infer``)."""
    if _resolve(impl, x) == "torch":
        return _plain(out, host, ref.forest_infer_ref(x, feat_idx,
                                                      thresholds, leaves))
    if not x.shape[0]:                        # nothing to launch
        return x.new_empty(0) if out is None else out
    from repro_torch.kernels import forest as fk
    out = fk.forest_infer(x, feat_idx, thresholds, leaves, out, host)
    _count("forest_infer")
    return out


def forest_infer_grouped(x, seg_start, feat_idx, thresholds, leaves, n_trees,
                         *, impl=None, out=None, host=None):
    """Block-diagonal pass over the packed multi-model layout (see
    ``ml.forest.pack_forests``); rows stacked segment by segment, segment m
    being rows ``seg_start[m]:seg_start[m + 1]``.  ``out`` and ``host`` as
    in ``forest_infer``."""
    if _resolve(impl, x) == "torch":
        sizes = (seg_start[1:] - seg_start[:-1]).long()
        seg_ids = torch.repeat_interleave(
            torch.arange(sizes.shape[0], device=x.device), sizes)
        return _plain(out, host, ref.forest_infer_grouped_ref(
            x, seg_ids, feat_idx, thresholds, leaves, n_trees))
    if not x.shape[0]:                        # nothing to launch
        return x.new_empty(0) if out is None else out
    from repro_torch.kernels import forest as fk
    out = fk.forest_infer_grouped(x, seg_start, feat_idx, thresholds, leaves,
                                  n_trees, out, host)
    _count("forest_infer_grouped")
    return out


def _under_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class FlashAttention(torch.autograd.Function):
    """Attention whose forward is ``attend(q, k, v)`` (the kernel or the
    plain version) and whose backward differentiates the plain version,
    recomputed from q, k and v in one block (no query or key chunks): the
    same function as the reference's 512 x 512 chunks, in a tenth of the
    launches at whisper's 1500-frame encoder (360 MB of float32 scores a
    call)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, attend):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return attend(q, k, v)

    @staticmethod
    def backward(ctx, gout):
        saved = ctx.saved_tensors           # unpacked once (remat)
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in saved]
            out = ref.flash_attention_ref(
                *qkv, causal=ctx.causal, window=ctx.window,
                q_chunk=qkv[0].shape[1], kv_chunk=qkv[1].shape[1])
            grads = torch.autograd.grad(out, qkv, gout)
        return (*grads, None, None, None)


def _common_dtype(q, k, v):
    """q, k and v in the dtype they promote to, and q's own dtype.  The
    plain versions compute in float32 from any inputs and return q's
    dtype; the kernels take one dtype, so bf16 queries on float32 keys
    (float32 media on bf16 weights) run the float32 kernel on the queries
    cast up, which is exact, and cast the output back."""
    if q.dtype == k.dtype == v.dtype:
        return q, k, v, q.dtype
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    return q.to(dt), k.to(dt), v.to(dt), q.dtype


def _flash_kernel(q, k, v, *, causal, window):
    from repro_torch.kernels import attention as ak
    q, k, v, out_dtype = _common_dtype(q, k, v)
    out = ak.flash_attention(q, k, v, causal=causal, window=window)
    _count("flash_attention")
    return out if out.dtype == out_dtype else out.to(out_dtype)


def flash_attention(q, k, v, *, causal=True, window=0, impl=None):
    """Blockwise attention, GQA, right-aligned queries: q (B, S, H, D),
    k/v (B, Skv, Hkv, D) -> (B, S, H, D)."""
    attend = functools.partial(
        ref.flash_attention_ref if _resolve(impl, q, "q") == "torch"
        else _flash_kernel, causal=causal, window=window)
    if _under_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, attend)
    return attend(q, k, v)


def decode_attention(q, k, v, kv_len, *, window=0, impl=None):
    """One query token per sequence against a KV cache: q (B, 1, H, D),
    k/v (B, Smax, Hkv, D), kv_len (B,) int32 live prefix lengths."""
    if _resolve(impl, q, "q") == "torch":
        return ref.decode_attention_ref(q, k, v, kv_len, window=window)
    from repro_torch.kernels import attention as ak
    q, k, v, out_dtype = _common_dtype(q, k, v)
    out = ak.decode_attention(q, k, v, kv_len, window=window)
    _count("decode_attention")
    return out if out.dtype == out_dtype else out.to(out_dtype)


def _rwkv6_kernel(r, k, v, w, u, state0):
    from repro_torch.kernels import recurrence as rk
    out = rk.rwkv6_scan(r, k, v, w, u, state0)
    _count("rwkv6_scan")
    return out


def rwkv6_scan(r, k, v, w, u, state0, *, impl=None):
    """WKV6 recurrence: r, k, v, w (B, S, H, Dh); u (H, Dh); state0
    (B, H, Dh, Dh) float32 -> (y (B, S, H, Dh) in r's dtype, final state
    float32).  Under autograd: ``ref.RWKV6Scan``, a launch per chunk."""
    scan = ref.rwkv6_scan_ref if _resolve(impl, r, "r") == "torch" \
        else _rwkv6_kernel
    if _under_grad(r, k, v, w, u, state0):
        return ref.rwkv6_scan_chunked(r, k, v, w, u, state0, scan=scan)
    return scan(r, k, v, w, u, state0)


def _ssd_kernel(x, dt, B, C, A, state0):
    from repro_torch.kernels import recurrence as rk
    out = rk.mamba2_ssd(x, dt, A, B, C, state0)
    _count("mamba2_ssd")
    return out


def mamba2_ssd(x, dt, A, B, C, state0, *, impl=None):
    """SSD recurrence: x (B, S, H, P); dt (B, S, H); A (H,) float32; B, C
    (B, S, N); state0 (B, H, P, N) float32 -> (y (B, S, H, P) in x's dtype,
    final state float32).  Under autograd: ``ref.SSDScan``, a launch per
    chunk."""
    scan = ref.ssd_chunk_ref if _resolve(impl, x) == "torch" \
        else _ssd_kernel
    if _under_grad(x, dt, A, B, C, state0):
        return ref.mamba2_ssd_chunked(x, dt, A, B, C, state0, scan=scan)
    return scan(x, dt, B, C, A, state0)
