"""The cost of a step as one H100 runs it: FLOPs, bytes, transcendentals,
kernel launches and the peak of live memory, counted op by op.

The port's counterpart of ``repro/launch/hlo_cost.py``.  The reference reads
its roofline inputs out of XLA's optimised HLO text; the port has no HLO,
since PyTorch runs eagerly, so this module counts the aten operations the
step dispatches, under a ``TorchDispatchMode`` (``count``).  The step may
run on ``meta`` tensors (no storage, no device: the dry run) or on real
ones (the card), and counts the same.

  flops            matrix products: ``torch.utils.flop_counter``'s formulas
                   (2 * M * K * N for a product), plus each CUDA kernel's
                   own work formula below
  traffic_bytes    per aten op: operand bytes + output bytes (eager torch
                   fuses nothing, which is what hlo_cost assumes of XLA's
                   top-level ops); views and allocations move nothing; a
                   kernel counts each input once and each output once
  transcendentals  output elements of exp, tanh, log, rsqrt, sigmoid and
                   the like
  kernels          per hand-written kernel (``kernels/ops.py:KERNELS``):
                   launches, FLOPs, bytes and the summed bound, each from
                   the kernel's own work formula, never from its plain
                   version; and any shapes the kernel's launcher refuses
  temp_bytes       the peak of live bytes the step allocated on its device,
                   beyond its arguments (storages tracked by weak
                   reference, so a tensor autograd keeps counts until it
                   is freed)
  collectives      None: the count traces the whole step on one device,
                   not the partitioned step (``parallel/partition.py``),
                   and does not estimate a mesh's collectives

Under the mode, ``kernels/ops.py`` takes a ``meta`` tensor for a tensor on
the card: a wrapper whose impl resolves to the kernel runs the launcher's
checks, records the kernel's work and returns ``meta`` outputs of the
kernel's shapes.  It launches nothing and runs no plain version.  Outside
the mode, ``impl="cuda"`` on a meta tensor raises.

The work formulas and the card's peaks live here; ``chip_smoke.py`` reads
its kernels' bounds from them.
"""

from __future__ import annotations

import contextlib
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores, dense bf16 FLOP/s on the tensor cores, and
# device memory ("80 GB")
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_BF16_S = 989e12
HBM_BYTES = 80e9
# float32 operations per state element per step, an FMA counted as 2.
# rwkv6: k v, u (k v), S + u k v, r * (...) and its sum, w S, + k v;
# mamba2 (stepwise): exp(dt A) S, (dt x) B, the sum, S C and its sum
RWKV_OPS_PER_ELEMENT = 7
SSD_OPS_PER_ELEMENT = 5
COLLECTIVES_REASON = ("the count traces the whole step on one device, not "
                      "the partitioned step, and does not estimate a mesh's "
                      "collectives")

_ITEMSIZE = {"bfloat16": 2, "float32": 4}


# ---------------------------------------------------------------- bounds

def bound_ms(nbytes: float, flops: float, dtype_name: str) -> tuple:
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over the peak rate of their type
    (bf16 on the tensor cores, else float32 on the CUDA cores)."""
    peak = PEAK_BF16_S if dtype_name == "bfloat16" else PEAK_FP32_S
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def forest_work(rows, F, T, D, M, trees_per_row) -> tuple:
    """(bytes, operations, "float32") of a forest call: the rows, each
    tree's features, thresholds and 2^D leaves read once, a score written
    per row; D + 1 compares and adds per (row, tree) and one division per
    row."""
    L = 1 << D
    nbytes = 4 * (rows * F + M * T * D * 2 + M * T * L + rows)
    if M > 1:
        nbytes += 4 * (M + 1 + M)               # segment offsets, tree counts
    return nbytes, float(trees_per_row * (D + 1) + rows), "float32"


def visible_pairs(S, Skv, causal, window) -> int:
    """(query, key) pairs a right-aligned attention sees: query i sits at
    position i + Skv - S and sees the keys at or before it (causal) and
    after position - window (a window)."""
    pos = np.arange(S, dtype=np.int64) + (Skv - S)
    hi = np.minimum(pos, Skv - 1) if causal else np.full(S, Skv - 1)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros(S, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_work(B, S, Skv, H, Hkv, D, causal, window, dtype_name) -> tuple:
    """(bytes, FLOP, dtype) of a flash call: q, k, v read once and the
    output written once; 4*D FLOP (QK and PV) per visible (query, key) pair
    per head."""
    nbytes = _ITEMSIZE[dtype_name] * (2 * B * S * H * D + 2 * B * Skv * Hkv * D)
    return (nbytes, 4.0 * D * H * B * visible_pairs(S, Skv, causal, window),
            dtype_name)


def decode_work(B, Smax, H, Hkv, D, window, lens, dtype_name) -> tuple:
    """(bytes, FLOP, dtype) of one decode call: the live K/V rows, q, the
    output and kv_len; 4*D FLOP per live key per query head.  ``lens``:
    each sequence's kv_len."""
    live = sum(min(n, Smax) - (max(0, n - window) if window else 0)
               for n in lens)
    nbytes = _ITEMSIZE[dtype_name] * (2 * live * Hkv * D + 2 * B * H * D) \
        + 4 * B
    return nbytes, 4.0 * D * H * live, dtype_name


def slice_live(lens, window, start, Smax) -> int:
    """Live keys of a cache slice holding positions [start, start + Smax),
    summed over sequences of kv_len ``lens`` (the whole cache's)."""
    return sum(max(0, min(n - start, Smax)
                   - max(0, (n - window if window else 0) - start))
               for n in lens)


def decode_partial_work(B, Smax, H, Hkv, D, window, lens, start,
                        dtype_name) -> tuple:
    """(bytes, FLOP, dtype) of one call of the decode kernel's partial mode
    on a cache slice from ``start``: the slice's live K/V rows, q and
    kv_len read once, the float32 partial output, max and sum written once;
    4*D FLOP per live key per query head."""
    live = slice_live(lens, window, start, Smax)
    nbytes = _ITEMSIZE[dtype_name] * (2 * live * Hkv * D + B * H * D) \
        + 4 * (B * H * D + 2 * B * H + B)
    return nbytes, 4.0 * D * H * live, dtype_name


def rwkv6_work(B, S, H, Dh, dtype_name) -> tuple:
    """(bytes, FLOP, rate) of one WKV6 scan: r, k, v, w read once, y
    written once and u read once in the model's dtype, the two float32
    states; RWKV_OPS_PER_ELEMENT per state element per step, at the float32
    rate in both dtypes (the recurrence runs on the CUDA cores)."""
    itemsize = _ITEMSIZE[dtype_name]
    nbytes = itemsize * (5 * B * S * H * Dh + H * Dh) + 8 * B * H * Dh * Dh
    return (nbytes, float(RWKV_OPS_PER_ELEMENT) * B * S * H * Dh * Dh,
            "float32")


def ssd_chunked_flop(B, S, H, P, N) -> float:
    """The chunked form's tensor-core products: per (b, h) and chunk of n
    steps C B^T (2 n n N), M X (2 n n P), C S_in^T and (scaled x)^T B
    (2 n P N each).  The kernel's bf16 pairs double some of them; that is
    its precision, not the function's work."""
    from repro_torch.kernels.recurrence import SSD_CHUNK
    per_bh = sum(2 * n * n * N + 2 * n * n * P + 4 * n * P * N
                 for n in (min(SSD_CHUNK, S - c0)
                           for c0 in range(0, S, SSD_CHUNK)))
    return float(B * H * per_bh)


def ssd_work(B, S, H, P, N, dtype_name) -> tuple:
    """(bytes, FLOP, rate) of one SSD scan: x read and y written, dt, B and
    C read in the model's dtype, A and the two states in float32.  bf16
    runs the chunked form, so its operations are the tensor-core products
    at the bf16 rate (``ssd_chunked_flop``); float32 runs the stepwise
    kernel, so its operations stay SSD_OPS_PER_ELEMENT per state element
    per step at the float32 rate."""
    itemsize = _ITEMSIZE[dtype_name]
    nbytes = itemsize * (2 * B * S * H * P + B * S * H + 2 * B * S * N) \
        + 4 * H + 8 * B * H * P * N
    if dtype_name == "bfloat16":
        return nbytes, ssd_chunked_flop(B, S, H, P, N), "bfloat16"
    return (nbytes, float(SSD_OPS_PER_ELEMENT) * B * S * H * P * N,
            "float32")


# ---------------------------------------------------------------- counting

_aten = torch.ops.aten
# allocations and metadata: no bytes move
_NO_TRAFFIC = {_aten.empty, _aten.empty_strided, _aten.empty_like,
               _aten.new_empty, _aten.new_empty_strided, _aten.lift_fresh,
               _aten.lift_fresh_copy, _aten.detach, _aten.alias,
               _aten._local_scalar_dense, _aten.sym_size, _aten.sym_stride,
               _aten.sym_numel, _aten.sym_storage_offset, _aten.is_same_size}
# transcendentals per output element (logsumexp: per input element)
_TRANSCENDENTAL = {
    _aten.exp: 1, _aten.exp2: 1, _aten.expm1: 1, _aten.log: 1, _aten.log2: 1,
    _aten.log10: 1, _aten.log1p: 1, _aten.tanh: 1, _aten.sigmoid: 1,
    _aten.rsqrt: 1, _aten.sqrt: 1, _aten.pow: 1, _aten.sin: 1, _aten.cos: 1,
    _aten.erf: 1, _aten.silu: 1, _aten.gelu: 1, _aten.softplus: 2,
    _aten._softmax: 1, _aten._log_softmax: 2, _aten.silu_backward: 1,
    _aten.gelu_backward: 1, _aten.softplus_backward: 1,
    _aten.sigmoid_backward: 0, _aten.tanh_backward: 0}
_PER_INPUT = {_aten.logsumexp}


def tensors(tree) -> list:
    """The tensors of a tree (dicts, tuples, lists), in order."""
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts what the operations dispatched inside it cost (see the module
    docstring); ``count`` is the usual way in.  ``arguments``: the step's
    inputs, whose storages are not the step's allocations; ``track_cpu``:
    count allocations on the host too (a step run on the CPU)."""

    def __init__(self, arguments=(), track_cpu: bool = False):
        super().__init__()
        self.track_cpu = track_cpu
        from repro_torch.kernels.ops import KERNELS
        self.flops = 0.0
        self.traffic = 0.0
        self.transcendentals = 0.0
        self.kernels = {k: {"launches": 0, "flops": 0.0, "bytes": 0.0,
                            "bound_ms": 0.0, "refused": []}
                        for k in KERNELS}
        self.live = 0
        self.peak = 0
        self.times = 1          # ops counted this many times (``repeat``)
        self._args = {st._cdata for st in (t.untyped_storage()
                                           for t in tensors(arguments))}
        self._seen: dict[int, tuple] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        n = self.times
        if packet in flop_registry:
            self.flops += n * flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
        outs = tensors(out)
        if packet in _TRANSCENDENTAL:
            self.transcendentals += n * _TRANSCENDENTAL[packet] * sum(
                t.numel() for t in outs)
        elif packet in _PER_INPUT:
            self.transcendentals += n * args[0].numel()
        if not func.is_view and packet not in _NO_TRAFFIC:
            self.traffic += n * (
                sum(_nbytes(t) for t in tensors((args, kwargs)))
                + sum(_nbytes(t) for t in outs))
        for t in outs:
            self._track(t)
        return out

    def _track(self, t: torch.Tensor):
        if t.device.type == "cpu" and not self.track_cpu:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._args or key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = (n, weakref.ref(st, lambda _, k=key: self._free(k)))
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key: int):
        n, _ = self._seen.pop(key)
        self.live -= n

    def kernel(self, name: str, work: tuple, refused: str | None = None):
        """One launch of kernel ``name`` doing ``work`` = (bytes, FLOP,
        rate dtype); ``refused``: the launcher's message where it refuses
        these shapes (counted all the same)."""
        nbytes, flops, dtype_name = work
        n = self.times
        rec = self.kernels[name]
        rec["launches"] += n
        rec["flops"] += n * flops
        rec["bytes"] += n * nbytes
        rec["bound_ms"] += n * bound_ms(nbytes, flops, dtype_name)[0]
        if refused is not None and refused not in rec["refused"]:
            rec["refused"].append(refused)
        self.flops += n * flops
        self.traffic += n * nbytes

    def result(self) -> dict:
        return {"flops": self.flops, "traffic_bytes": self.traffic,
                "transcendentals": self.transcendentals,
                "collectives": None,
                "collectives_reason": COLLECTIVES_REASON,
                "temp_bytes": self.peak,
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}


def active() -> CostMode | None:
    """The innermost counting mode, or None.  The dispatch-mode stack
    follows autograd onto its device threads, so a kernel launched from a
    backward pass (a recomputed forward) finds it too."""
    if not torch._C._len_torch_dispatch_stack():     # the common case, fast
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostMode):
            return mode
    return None


@contextlib.contextmanager
def repeat(x: torch.Tensor, n: int):
    """Around a loop of ``n`` iterations that dispatch the same operations
    on the same shapes: yields how many to run.  That is ``n``, except on
    ``meta`` under the counting mode, where it is 1 and the mode counts
    that iteration ``n`` times (the outputs' shapes are the same, their
    values are not there to differ)."""
    mode = active()
    if mode is None or not x.is_meta or n <= 1:
        yield n
        return
    saved = mode.times
    mode.times = saved * n
    try:
        yield 1
    finally:
        mode.times = saved


def count(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under a CostMode and return its counts
    (``CostMode.result``) with the outputs under "outputs".  ``args`` on
    ``meta`` count the step without running it (nothing is allocated); on
    the card they run it."""
    mode = CostMode((args, kwargs), track_cpu=any(
        t.device.type == "cpu" for t in tensors(args)))
    with mode:
        out = fn(*args, **kwargs)
    return dict(mode.result(), outputs=out)


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a tree (meta or real)."""
    return sum(_nbytes(t) for t in tensors(tree))


def fits_one_h100(argument_bytes: float, temp_bytes: float) -> bool:
    """Whether a step's arguments plus its temporaries fit the card's 80 GB
    (HBM_BYTES, the data sheet's figure)."""
    return argument_bytes + temp_bytes <= HBM_BYTES

