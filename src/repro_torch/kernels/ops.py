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
recomputation of a rematerialised layer's forward included.

Under ``launch.cost``'s counting mode every launch also records its work
(bytes and FLOP by ``launch.cost``'s formulas), and a ``meta`` tensor
stands for a tensor on the card: ``impl`` None or "cuda" resolves to the
kernel, whose launcher runs its checks and returns meta outputs without
launching (no plain version runs, no launch is counted); shapes the
launcher refuses are recorded as refused and counted all the same.  This
is the dry run's path; outside the mode a meta tensor resolves as any
non-CUDA tensor does.

On DTensors (a step run on a mesh by ``parallel/partition.py``) the
attention kernels and the scans run under ``local_map`` on every rank's
local block: batch and heads are independent, so each rank launches the
kernel (or runs the plain version) on its own sequences and heads with no
communication, and under autograd the backward runs per rank too.  A
query head reads the kv head of its group: where the kv heads cannot be
split as the query heads are (fewer kv heads than ranks), each rank keeps
them whole and reads the ones its query heads need.  A decode whose cache
is sharded along its sequence runs the decode kernel's partial mode on
every rank's slice and merges the slices' partial softmaxes
(``ref.merge_partials``) after gathering them over the mesh dimensions
that cut the sequence.  Launch counters count per rank."""

from __future__ import annotations

import functools
import threading

import torch

from repro_torch.kernels import ref
from repro_torch.launch import cost
from repro_torch.parallel import partition

IMPLS = ("torch", "cuda")
KERNELS = ("forest_infer", "forest_infer_grouped", "flash_attention",
           "decode_attention", "decode_attention_partial", "rwkv6_scan",
           "mamba2_ssd")

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


def _on_card(x: torch.Tensor) -> bool:
    """x is on the card, or is a meta tensor standing for one under the
    counting mode."""
    return x.is_cuda or (x.is_meta and cost.active() is not None)


def _resolve(impl: str | None, x: torch.Tensor, name: str = "x") -> str:
    if impl is None:
        return "cuda" if _on_card(x) else "torch"
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS} or None, got {impl!r}")
    if impl == "cuda" and not _on_card(x):
        raise ValueError(f"impl='cuda' needs CUDA tensors; {name} is on "
                         f"{x.device}")
    return impl


def _record(kernel: str, work, refused: str | None = None):
    """Record one launch's ``work()`` (bytes, FLOP, rate dtype) with the
    counting mode, if one is active."""
    mode = cost.active()
    if mode is not None:
        mode.kernel(kernel, work(), refused)


def _launch(kernel: str, x: torch.Tensor, launch, work, outputs):
    """``launch()`` the kernel, count it and record its work.  On a meta
    ``x`` (the counting mode's stand-in for the card) the launcher only
    checks and allocates, and nothing is counted; where it refuses the
    shapes, ``outputs()`` gives the outputs and the refusal is recorded."""
    refused = None
    if x.is_meta:
        try:
            out = launch()
        except (ValueError, TypeError) as e:
            refused, out = str(e), outputs()
    else:
        out = launch()
        _count(kernel)
    _record(kernel, work, refused)
    return out


def _dtype_name(x: torch.Tensor) -> str:
    return str(x.dtype).removeprefix("torch.")


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
    _record("forest_infer", lambda: cost.forest_work(
        x.shape[0], x.shape[1], *feat_idx.shape, 1,
        x.shape[0] * feat_idx.shape[0]))
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
    _record("forest_infer_grouped", lambda: _grouped_work(
        x, seg_start, feat_idx, n_trees))
    return out


def _grouped_work(x, seg_start, feat_idx, n_trees):
    """The grouped call's work on this data: each segment's rows times its
    own tree count (read back from the card; only under the counting
    mode)."""
    M, T, D = feat_idx.shape
    sizes = (seg_start[1:] - seg_start[:-1]).tolist()
    trees = sum(n * t for n, t in zip(sizes, n_trees.tolist()))
    return cost.forest_work(x.shape[0], x.shape[1], T, D, M, trees)


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
    B, S, H, D = q.shape
    out = _launch(
        "flash_attention", q,
        lambda: ak.flash_attention(q, k, v, causal=causal, window=window),
        lambda: cost.flash_work(B, S, k.shape[1], H, k.shape[2], D, causal,
                                window, _dtype_name(q)),
        lambda: torch.empty_like(q))
    return out if out.dtype == out_dtype else out.to(out_dtype)


def flash_attention(q, k, v, *, causal=True, window=0, impl=None):
    """Blockwise attention, GQA, right-aligned queries: q (B, S, H, D),
    k/v (B, Skv, Hkv, D) -> (B, S, H, D)."""
    if partition.is_dtensor(q):
        return _on_local_heads(
            functools.partial(flash_attention, causal=causal, window=window,
                              impl=impl), q, k, v)
    attend = functools.partial(
        ref.flash_attention_ref if _resolve(impl, q, "q") == "torch"
        else _flash_kernel, causal=causal, window=window)
    if _under_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, attend)
    return attend(q, k, v)


def decode_attention(q, k, v, kv_len, *, window=0, impl=None):
    """One query token per sequence against a KV cache: q (B, 1, H, D),
    k/v (B, Smax, Hkv, D), kv_len (B,) int32 live prefix lengths."""
    if partition.is_dtensor(k):
        if any(p.is_shard(1) for p in k.placements):
            return _decode_over_slices(q, k, v, kv_len, window=window,
                                       impl=impl)
        return _on_local_heads(
            lambda q, k, v, kv_len: decode_attention(
                q, k, v, kv_len, window=window, impl=impl),
            q, k, v, kv_len=kv_len)
    if _resolve(impl, q, "q") == "torch":
        return ref.decode_attention_ref(q, k, v, kv_len, window=window)
    from repro_torch.kernels import attention as ak
    q, k, v, out_dtype = _common_dtype(q, k, v)
    B, _, H, D = q.shape
    Smax = k.shape[1]
    out = _launch(
        "decode_attention", q,
        lambda: ak.decode_attention(q, k, v, kv_len, window=window),
        lambda: cost.decode_work(
            B, Smax, H, k.shape[2], D, window,
            [Smax] * B if q.is_meta else kv_len.tolist(), _dtype_name(q)),
        lambda: torch.empty_like(q))
    return out if out.dtype == out_dtype else out.to(out_dtype)


def decode_attention_partial(q, k, v, kv_len, *, start, window=0,
                             impl=None):
    """The decode kernel's partial mode on one slice of a cache cut along
    its sequence, holding global positions [start, start + Smax): q
    (B, 1, H, D), k/v (B, Smax, Hkv, D), kv_len (B,) int32 and ``window``
    the whole cache's.  Returns float32 (o (B, 1, H, D), m (B, H), l (B,
    H)), merged by ``ref.merge_partials``
    (``kernels.attention.decode_attention_partial``)."""
    if _resolve(impl, q, "q") == "torch":
        return ref.decode_attention_partial_ref(q, k, v, kv_len, start=start,
                                                window=window)
    from repro_torch.kernels import attention as ak
    q, k, v, _ = _common_dtype(q, k, v)
    B, _, H, D = q.shape
    Smax = k.shape[1]

    def outputs():
        return (torch.empty(q.shape, dtype=torch.float32, device=q.device),
                q.new_empty(B, H, dtype=torch.float32),
                q.new_empty(B, H, dtype=torch.float32))
    return _launch(
        "decode_attention_partial", q,
        lambda: ak.decode_attention_partial(q, k, v, kv_len, start=start,
                                            window=window),
        lambda: cost.decode_partial_work(
            B, Smax, H, k.shape[2], D, window,
            [start + Smax] * B if q.is_meta else kv_len.tolist(), start,
            _dtype_name(q)),
        outputs)


# ---------------------------------------------------------------------------
# DTensor inputs: the kernels on every rank's local block
# ---------------------------------------------------------------------------

def _replicate_but(t, dims):
    """DTensor t sharded only along tensor dims ``dims`` (a mesh dimension
    that shards any other dim, or holds a partial sum, is replicated)."""
    from torch.distributed.tensor import Replicate
    return partition.placed(t, t.device_mesh, tuple(
        p if p.is_shard() and p.dim in dims else Replicate()
        for p in t.placements))


def _follow(placements, dim_map, grad=False):
    """Placements of a tensor whose dims ``dim_map`` maps from the lead's
    (lead dim -> own dim, or absent where it has no such dim: replicated).
    With ``grad``, the placements of its gradient from a rank's block: a
    partial sum where the lead is sharded along a dim it lacks (each rank's
    sequences or heads add their share)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    out = []
    for p in placements:
        if not p.is_shard():
            out.append(Replicate())
        elif p.dim in dim_map:
            out.append(Shard(dim_map[p.dim]))
        else:
            out.append(Partial() if grad else Replicate())
    return tuple(out)


def _kv_heads_split(q, Hkv):
    """How the kv heads (dim 2 of k/v) follow q's head split, mesh dim by
    mesh dim: (placements of k/v, their gradients' placements, the query
    heads' global offset if some mesh dim keeps the kv heads whole)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    dm, H = q.device_mesh, q.shape[2]
    kpl, kgrad, whole = [], [], False
    for i, p in enumerate(q.placements):
        n = dm.size(i)
        if p.is_shard(2):
            if H % n:
                raise ValueError(f"{H} query heads do not split over {n} "
                                 f"ranks of mesh dim {i}")
            if Hkv % n == 0:
                kpl.append(Shard(2))
                kgrad.append(Shard(2))
                continue
            whole = True
            kpl.append(Replicate())
            kgrad.append(Partial())   # each rank's kv heads' share
        elif p.is_shard(0):
            kpl.append(Shard(0))
            kgrad.append(Shard(0))
        else:
            kpl.append(Replicate())
            kgrad.append(Replicate())
    h0 = partition.local_shape_offset(q)[1][2] if whole else None
    return tuple(kpl), tuple(kgrad), h0


def _own_kv_heads(k, v, h0: int, h_local: int, G: int):
    """The kv heads query heads [h0, h0 + h_local) read (G query heads a kv
    head)."""
    if h_local % G and G % h_local:
        raise ValueError(f"{h_local} local query heads at {h0} straddle "
                         f"groups of {G}")
    k0, k1 = h0 // G, -(-(h0 + h_local) // G)
    return k[:, :, k0:k1], v[:, :, k0:k1]


def _on_local_heads(fn, q, k, v, kv_len=None):
    """``fn(q, k, v[, kv_len])`` on every rank's local sequences and query
    heads of DTensors q (B, S, H, D), k/v (B, Skv, Hkv, D), under
    ``local_map``; the output is placed as q."""
    from torch.distributed.tensor.experimental import local_map
    q = _replicate_but(q, (0, 2))
    dm, H, Hkv = q.device_mesh, q.shape[2], k.shape[2]
    kpl, kgrad, h0 = _kv_heads_split(q, Hkv)
    k = partition.placed(k, dm, kpl)
    v = partition.placed(v, dm, kpl)
    args, pls, grads = [q, k, v], [q.placements, kpl, kpl], \
        [q.placements, kgrad, kgrad]
    if kv_len is not None:
        lpl = _follow(q.placements, {0: 0})
        args.append(partition.placed(kv_len, dm, lpl))
        pls.append(lpl)
        grads.append(lpl)

    def local(q, k, v, *rest):
        if h0 is not None:
            k, v = _own_kv_heads(k, v, h0, q.shape[2], H // Hkv)
        return fn(q.contiguous(), k.contiguous(), v.contiguous(), *rest)
    out = local_map(local, out_placements=list(q.placements),
                    in_placements=tuple(pls), in_grad_placements=tuple(grads),
                    device_mesh=dm)(*args)
    if tuple(out.shape) != tuple(q.shape):
        raise ValueError(f"uneven blocks: {tuple(q.shape)} came back as "
                         f"{tuple(out.shape)}")
    return out


def _decode_over_slices(q, k, v, kv_len, *, window, impl):
    """Decode against a cache whose sequence (dim 1) is sharded: every rank
    runs the partial mode on its slice (its global offset the slice's
    start), the slices' (m, l, o) are gathered over the mesh dims that cut
    the sequence and merged.  The query is one token, so it is replicated
    over those dims; it follows the cache's batch and kv-head split."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dm, H, Hkv = k.device_mesh, q.shape[2], k.shape[2]
    seq_dims = [i for i, p in enumerate(k.placements) if p.is_shard(1)]
    for i, p in enumerate(k.placements):
        if p.is_shard(2) and (H % dm.size(i) or Hkv % dm.size(i)):
            raise ValueError(f"{H} query / {Hkv} kv heads do not split over "
                             f"{dm.size(i)} ranks of mesh dim {i}")
    qpl = _follow(k.placements, {0: 0, 2: 2})
    q = partition.placed(q, dm, qpl)
    v = partition.placed(v, dm, k.placements)
    kv_len = partition.placed(kv_len, dm, _follow(k.placements, {0: 0}))
    start = partition.local_shape_offset(k)[1][1]
    o, m, l = decode_attention_partial(
        q.to_local().contiguous(), k.to_local().contiguous(),
        v.to_local().contiguous(), kv_len.to_local(), start=start,
        window=window, impl=impl)

    def gathered(t, dim_map):
        """(slices, *t.shape): every slice's t along a new leading dim."""
        pl = tuple(Shard(0) if i in seq_dims else p
                   for i, p in enumerate(_follow(k.placements, dim_map)))
        g = DTensor.from_local(t[None], dm, pl, run_check=False)
        return g.redistribute(dm, tuple(
            Replicate() if i in seq_dims else p for i, p in enumerate(pl))
        ).to_local()
    out = ref.merge_partials(gathered(m, {0: 1, 2: 2}),
                             gathered(l, {0: 1, 2: 2}),
                             gathered(o, {0: 1, 2: 3}))
    return DTensor.from_local(out.to(q.dtype), dm, qpl, run_check=False,
                              shape=q.shape, stride=q.stride())


def _rwkv6_kernel(r, k, v, w, u, state0):
    from repro_torch.kernels import recurrence as rk
    return _launch(
        "rwkv6_scan", r, lambda: rk.rwkv6_scan(r, k, v, w, u, state0),
        lambda: cost.rwkv6_work(*r.shape, _dtype_name(r)),
        lambda: (torch.empty_like(r), torch.empty_like(state0)))


def rwkv6_scan(r, k, v, w, u, state0, *, impl=None):
    """WKV6 recurrence: r, k, v, w (B, S, H, Dh); u (H, Dh); state0
    (B, H, Dh, Dh) float32 -> (y (B, S, H, Dh) in r's dtype, final state
    float32).  Under autograd: ``ref.RWKV6Scan``, a launch per chunk."""
    if partition.is_dtensor(r):
        return _scan_on_local_heads(
            functools.partial(rwkv6_scan, impl=impl), r,
            (r, k, v, w, u, state0), ({0: 0, 2: 2},) * 4
            + ({2: 0}, {0: 0, 2: 1}), ({0: 0, 2: 2}, {0: 0, 2: 1}))
    scan = ref.rwkv6_scan_ref if _resolve(impl, r, "r") == "torch" \
        else _rwkv6_kernel
    if _under_grad(r, k, v, w, u, state0):
        return ref.rwkv6_scan_chunked(r, k, v, w, u, state0, scan=scan)
    return scan(r, k, v, w, u, state0)


def _ssd_kernel(x, dt, B, C, A, state0):
    from repro_torch.kernels import recurrence as rk
    return _launch(
        "mamba2_ssd", x, lambda: rk.mamba2_ssd(x, dt, A, B, C, state0),
        lambda: cost.ssd_work(*x.shape, B.shape[-1], _dtype_name(x)),
        lambda: (torch.empty_like(x), torch.empty_like(state0)))


def mamba2_ssd(x, dt, A, B, C, state0, *, impl=None):
    """SSD recurrence: x (B, S, H, P); dt (B, S, H); A (H,) float32; B, C
    (B, S, N); state0 (B, H, P, N) float32 -> (y (B, S, H, P) in x's dtype,
    final state float32).  Under autograd: ``ref.SSDScan``, a launch per
    chunk."""
    if partition.is_dtensor(x):
        return _scan_on_local_heads(
            functools.partial(mamba2_ssd, impl=impl), x,
            (x, dt, A, B, C, state0), ({0: 0, 2: 2}, {0: 0, 2: 2}, {2: 0},
                                       {0: 0}, {0: 0}, {0: 0, 2: 1}),
            ({0: 0, 2: 2}, {0: 0, 2: 1}))
    scan = ref.ssd_chunk_ref if _resolve(impl, x) == "torch" \
        else _ssd_kernel
    if _under_grad(x, dt, A, B, C, state0):
        return ref.mamba2_ssd_chunked(x, dt, A, B, C, state0, scan=scan)
    return scan(x, dt, B, C, A, state0)


def _scan_on_local_heads(fn, lead, args, in_maps, out_maps):
    """A scan ``fn(*args)`` on every rank's local sequences and heads under
    ``local_map``: ``lead`` (B, S, H, ...), the first of ``args``, is
    sharded along batch and heads only, and every argument and output
    follows it through its dim map (lead dim -> own dim; absent:
    replicated).  Returns (y, final state) placed so."""
    from torch.distributed.tensor.experimental import local_map
    lead = _replicate_but(lead, (0, 2))
    dm = lead.device_mesh
    pls = tuple(_follow(lead.placements, m) for m in in_maps)
    args = [lead] + [partition.placed(a, dm, pl)
                     for a, pl in zip(args[1:], pls[1:])]
    outs = local_map(
        lambda *a: fn(*(t.contiguous() for t in a)),
        out_placements=tuple(_follow(lead.placements, m) for m in out_maps),
        in_placements=pls, in_grad_placements=tuple(
            _follow(lead.placements, m, grad=True) for m in in_maps),
        device_mesh=dm)(*args)
    for o, a in zip(outs, (args[0], args[-1])):
        if tuple(o.shape) != tuple(a.shape):
            raise ValueError(f"uneven blocks: {tuple(a.shape)} came back as "
                             f"{tuple(o.shape)}")
    return outs
