"""Logical-axis sharding and parameter definitions.

The port's copy of ``repro/parallel/axes.py``.  Parameters and activations
carry *logical* axis names; a per-arch rule table maps them onto the axes of
a device mesh, so one model definition serves any mesh (single pod
``(data, model)``, multi-pod ``(pod, data, model)``, or one card).

Logical axes used in the zoo:
  layers     stacked layer dimension (never sharded; no PP axis in the mesh)
  batch      global batch                -> ("pod", "data")
  seq        activation sequence dim     -> None (or "data" for SP long-context)
  kv_seq     KV-cache sequence dim       -> None, or "data" for long_500k decode
  embed      d_model                     -> None, or "data" for FSDP weight shard
  ff         MLP hidden                  -> "model"
  heads      attention query heads       -> "model"
  kv_heads   attention KV heads          -> "model" iff divisible, else None
  head_dim   per-head dim                -> None
  vocab      vocabulary                  -> "model"
  experts    MoE expert dim              -> "model"   (expert parallelism)
  expert_ff  per-expert hidden           -> None (EP already covers "model")
  state      SSM/RWKV recurrent state    -> None
  conv       conv kernel width           -> None
  frames     audio/vision token dim      -> None

``PartitionSpec`` and ``NamedSharding`` here are records of where each
leaf lives on a mesh (``launch/mesh.py``) and what a device holds of it,
which the dry run (``launch/dryrun.py``) reads; ``NamedSharding.placements``
turns one into the DTensor placements on a ``DeviceMesh`` of that mesh,
which ``parallel/partition.py`` runs a step with.  A ``ParamDef`` per parameter tensor (shape, dtype, logical axes,
initializer) is the single source of truth for the abstract shape tree,
the axes tree and ``init_params``.

Parameter trees are nested dicts whose leaves are ``ParamDef``s (or, once
materialised, tensors).  Leaves are visited in sorted-key order, the order in
which JAX flattens a dict, so leaf ``i`` here is leaf ``i`` there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, Sequence

import torch

# the seed of leaf i is mixed from (seed, i) with this odd constant
_SEED_MIX = 0x9E3779B97F4A7C15

# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------

# Default rules for a (data, model) or (pod, data, model) mesh.  Values may be a
# mesh-axis name, a tuple of mesh-axis names, or None (replicated).
DEFAULT_RULES: dict[str, Any] = {
    "layers": None,
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
    "embed": None,
    "ff": "model",
    "heads": "model",
    "heads_x_dim": "model",  # fused (heads*head_dim) projections (rwkv/mamba d_inner)
    "kv_heads": "model",
    "head_dim": None,
    "vocab": "model",
    "experts": "model",
    "expert_ff": None,
    "state": None,
    "conv": None,
    "frames": None,
}


def make_rules(
    *,
    fsdp: bool = False,
    shard_kv_heads: bool = True,
    sequence_parallel: bool = False,
    overrides: Mapping[str, Any] | None = None,
) -> dict[str, Any]:
    """Build a rule table.

    fsdp: additionally shard the ``embed`` dim of weights over the data axes
      (ZeRO-3 / FSDP style).
    shard_kv_heads: disable for archs whose kv_heads don't divide the model
      axis (replicating KV is cheaper for GQA than padding).
    sequence_parallel: shard kv_seq over every mesh axis (long-context decode
      where batch == 1 cannot use the data axis).
    """
    rules = dict(DEFAULT_RULES)
    if fsdp:
        rules["embed"] = ("pod", "data")
    if not shard_kv_heads:
        rules["kv_heads"] = None
    if sequence_parallel:
        rules["kv_seq"] = ("pod", "data", "model")
        rules["batch"] = None
    if overrides:
        rules.update(overrides)
    return rules


class PartitionSpec(tuple):
    """Where each dimension of a leaf lives on a mesh, as JAX's ``P``: one
    entry per dimension, None (replicated), a mesh-axis name, or a tuple of
    names (sharded over their product).  As ``P`` does, a tuple of one
    name becomes the name and an empty tuple None."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            (p[0] if len(p) == 1 else p or None) if isinstance(p, tuple)
            else p for p in parts))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def _mesh_axes(mesh) -> set[str]:
    return set(mesh.axis_names)


def _resolve_entry(entry: Any, present: set[str]) -> Any:
    """Drop mesh axes that don't exist on this mesh (e.g. 'pod' on single-pod)."""
    if entry is None:
        return None
    if isinstance(entry, str):
        return entry if entry in present else None
    kept = tuple(a for a in entry if a in present)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def logical_to_spec(axes: Sequence[str | None], rules: Mapping[str, Any],
                    mesh) -> PartitionSpec:
    """Map a tuple of logical axis names to a PartitionSpec for ``mesh``
    (anything with ``axis_names``)."""
    present = _mesh_axes(mesh)
    used: set[str] = set()
    parts = []
    for name in axes:
        if name is None:
            parts.append(None)
            continue
        entry = _resolve_entry(rules.get(name), present)
        # A mesh axis may appear at most once in a PartitionSpec.
        if entry is None:
            parts.append(None)
        elif isinstance(entry, str):
            if entry in used:
                parts.append(None)
            else:
                used.add(entry)
                parts.append(entry)
        else:
            fresh = tuple(a for a in entry if a not in used)
            used.update(fresh)
            parts.append(fresh if fresh else None)
    return PartitionSpec(*parts)


def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def _map_axes(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every logical-axes tuple of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    if not _is_axes(tree):
        raise TypeError(f"an axes tree holds dicts and tuples of axis "
                        f"names, got {tree!r}")
    return fn(tree)


def tree_spec(axes_tree: Any, rules: Mapping[str, Any], mesh) -> Any:
    """Map a tree of logical-axis tuples to a tree of PartitionSpecs."""
    return _map_axes(lambda axes: logical_to_spec(axes, rules, mesh),
                     axes_tree)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A PartitionSpec bound to a mesh (``launch.mesh.Mesh``): what each
    device holds of a leaf."""
    mesh: Any
    spec: PartitionSpec

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """One device's block of a leaf of ``shape``: every sharded
        dimension divided by the product of its mesh axes' sizes, rounded
        up (a ragged last block is padded to the others' size)."""
        sizes = dict(self.mesh.shape)
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        out = []
        for n, part in zip(shape, spec):
            names = () if part is None else \
                (part,) if isinstance(part, str) else part
            split = math.prod(sizes[a] for a in names)
            out.append(-(-n // split))
        return tuple(out)

    def shard_bytes(self, t: torch.Tensor) -> int:
        """Bytes of one device's block of tensor ``t`` (meta or real)."""
        return math.prod(self.shard_shape(t.shape)) * t.element_size()

    def placements(self, device_mesh) -> tuple:
        """The DTensor placements of this sharding on ``device_mesh`` (a
        ``torch.distributed`` DeviceMesh whose dimension names are this
        mesh's axis names): a tensor dimension named by a mesh axis, alone
        or in a tuple, is ``Shard(dim)`` on that mesh dimension, every other
        mesh dimension ``Replicate()``.  DTensor splits an uneven dimension
        unevenly (the last blocks smaller), where ``shard_shape`` pads every
        block to the first's size."""
        from torch.distributed.tensor import Replicate, Shard
        names = tuple(device_mesh.mesh_dim_names or ())
        if set(names) != set(self.mesh.axis_names):
            raise ValueError(f"device mesh axes {names} against the mesh's "
                             f"{self.mesh.axis_names}")
        out = [Replicate()] * len(names)
        for dim, part in enumerate(self.spec):
            for axis in () if part is None else \
                    (part,) if isinstance(part, str) else part:
                out[names.index(axis)] = Shard(dim)
        return tuple(out)


def tree_sharding(axes_tree: Any, rules: Mapping[str, Any], mesh) -> Any:
    """Same as tree_spec but returns NamedShardings bound to ``mesh``."""
    return _map_axes(
        lambda axes: NamedSharding(mesh, logical_to_spec(axes, rules, mesh)),
        axes_tree)


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------

# fill(out, ParamDef, torch.Generator): how init_params draws a leaf (_fill)
Initializer = Callable[..., None]


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


def params_axes(defs: Any) -> Any:
    """The tree of each parameter's logical axes."""
    return tree_map(lambda d: d.axes, defs)


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
