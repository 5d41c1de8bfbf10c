"""Parameter definitions with logical axis names, and their materialisation.

The port's copy of what the models need from ``repro/parallel/axes.py``: a
``ParamDef`` per parameter tensor (shape, dtype, logical axes, initializer),
the abstract shape tree, and ``init_params``.  The logical-axis names stay on
every ``ParamDef`` (``layers``, ``embed``, ``heads``, ``kv_heads``,
``head_dim``, ``ff``, ``vocab``, ...) so that sharding rules can map them onto
a device mesh later; on one device nothing reads them.

Parameter trees are nested dicts whose leaves are ``ParamDef``s (or, once
materialised, tensors).  Leaves are visited in sorted-key order, the order in
which JAX flattens a dict, so leaf ``i`` here is leaf ``i`` there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

# the seed of leaf i is mixed from (seed, i) with this odd constant
_SEED_MIX = 0x9E3779B97F4A7C15


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Single source of truth for one parameter tensor: shape, dtype, logical
    axes and initializer (``normal`` | ``zeros`` | ``ones`` | ``scaled``)."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    dtype: Any = None  # filled by the model's default dtype when None
    init: str = "normal"
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_param_def(x: Any) -> bool:
    return isinstance(x, ParamDef)


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves_with_path(tree: Any, prefix: tuple = ()) -> list:
    """[(path, leaf)] in sorted-key order (JAX's flattening order of dicts)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_leaves_with_path(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` (sorted-key
    order, as ``tree_leaves`` lists them)."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return next(it)
    out = walk(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def abstract_params(defs: Any, default_dtype: torch.dtype) -> Any:
    """The parameter tree as tensors on the ``meta`` device: shapes and
    dtypes, no storage."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype or default_dtype,
                                          device="meta"), defs)


def param_numel(defs: Any) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(defs))


def _fill(out: torch.Tensor, d: ParamDef, gen: torch.Generator):
    """Fill ``out`` (d.shape) by d's rule from ``gen``, in float32 and then
    cast.  A stacked leaf (leading ``layers`` axis) is drawn one layer at a
    time, so the float32 temporary is one layer's, never the whole stack's."""
    if d.init == "zeros":
        out.zero_()
        return
    if d.init == "ones":
        out.fill_(1)
        return
    if d.init == "scaled":
        fan_in = d.shape[-2] if len(d.shape) >= 2 else max(d.shape[-1], 1)
        std = d.scale / (fan_in ** 0.5)
    elif d.init == "normal":
        std = 0.02 * d.scale
    else:
        raise ValueError(f"unknown init {d.init!r}")
    slices = out if d.axes[:1] == ("layers",) else out[None]
    for s in slices:
        s.copy_(torch.randn(s.shape, generator=gen, dtype=torch.float32,
                            device=out.device).mul_(std))


def init_params(defs: Any, seed: int, default_dtype: torch.dtype,
                device: torch.device) -> Any:
    """Materialise parameters on ``device``.  Leaf ``i`` (sorted-key order)
    draws from its own ``torch.Generator`` on that device, seeded from
    (seed, i), so a leaf does not depend on the others.  The numbers differ
    from JAX's for the same seed, and between CPU and CUDA generators:
    parity tests carry weights across instead (``convert.py``)."""
    device = torch.device(device)
    paths = tree_leaves_with_path(defs)
    index = {path: i for i, (path, _) in enumerate(paths)}

    def make(path, d):
        out = torch.empty(d.shape, dtype=d.dtype or default_dtype,
                          device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed((seed * _SEED_MIX + index[path]) % (1 << 63))
        _fill(out, d, gen)
        return out

    def walk(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: walk(v, prefix + (k,)) for k, v in tree.items()}
        return make(prefix, tree)
    return walk(defs)
