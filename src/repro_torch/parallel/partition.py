"""Running a step on a mesh: the port's counterpart of ``jax.jit(fn,
in_shardings=..., out_shardings=...)``.

A cell of ``launch/specs.py:build_cell`` names its step, its arguments and
their ``NamedSharding`` records.  ``run_cell`` lays the arguments on a
``torch.distributed`` DeviceMesh of the cell's mesh
(``launch/mesh.py:device_mesh``) as DTensors, calls the step, and lays its
outputs out as ``out_shardings`` says.  Inside the step DTensor's own
sharding propagation runs the plain torch operations; the model's
``ShardCtx.constrain`` places activations where the reference places
them; ``kernels/ops.py`` runs each hand-written kernel on every rank's
local block (``local_map``), and a decode whose cache is sharded along its
sequence merges the ranks' partial softmaxes.  Plain tensors met inside the
step (positions, masks, scalars) count as replicated
(``implicit_replication``).

Every rank holds the same whole arguments when they are distributed (the
same seed makes the same tensor on each) and keeps its own block: nothing
is sent.  DTensor is imported only when a DTensor is made, so a process
that never distributes anything does not pay for the import."""

from __future__ import annotations

import sys
from typing import Any

import torch

from repro_torch.parallel.axes import NamedSharding


def is_dtensor(x) -> bool:
    """x is a DTensor (without importing DTensor when no DTensor can
    exist yet)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def compute_local_shape_and_global_offset(shape, device_mesh,
                                          placements) -> tuple:
    """(this rank's block shape, its first element's global index) of a
    tensor of ``shape`` laid out by ``placements`` (DTensor's own rule:
    uneven dims split with the last blocks smaller)."""
    from torch.distributed.tensor import _utils
    return _utils.compute_local_shape_and_global_offset(
        shape, device_mesh, placements)


def local_shape_offset(t) -> tuple:
    """(this rank's block shape, its first element's global index) of
    DTensor ``t``."""
    return compute_local_shape_and_global_offset(t.shape, t.device_mesh,
                                                 t.placements)


def replicated(x, device_mesh):
    """``x`` as a DTensor replicated on every mesh dimension: a DTensor is
    redistributed there, a plain tensor (the same on every rank) wrapped."""
    from torch.distributed.tensor import DTensor, Replicate
    pl = (Replicate(),) * device_mesh.ndim
    if is_dtensor(x):
        return x if tuple(x.placements) == pl else x.redistribute(
            device_mesh, pl)
    return DTensor.from_local(x, device_mesh, pl, run_check=False)


def placed(x, device_mesh, placements):
    """``x`` (a DTensor, or a plain tensor the same on every rank) as a
    DTensor with ``placements``."""
    placements = tuple(placements)
    if is_dtensor(x):
        return x if tuple(x.placements) == placements else x.redistribute(
            device_mesh, placements)
    return replicated(x, device_mesh).redistribute(device_mesh, placements)


def like(value, target):
    """``value`` placed as DTensor ``target`` is, to be written into it."""
    return placed(value, target.device_mesh, target.placements)


def _sharding_placements(sharding, device_mesh, ndim: int) -> tuple:
    from torch.distributed.tensor import Replicate
    if sharding is None:
        return (Replicate(),) * device_mesh.ndim
    if not isinstance(sharding, NamedSharding):
        raise TypeError(f"a sharding is a NamedSharding or None, got "
                        f"{sharding!r}")
    if len(sharding.spec) > ndim:
        raise ValueError(f"{sharding.spec} has more entries than the "
                         f"leaf's {ndim} dimensions")
    return sharding.placements(device_mesh)


def _zip_tree(fn, tree, shardings):
    """fn(leaf, sharding) over a tree of dicts, tuples and lists; a None
    (or a single NamedSharding) in ``shardings`` covers a whole subtree."""
    if isinstance(tree, dict):
        return {k: _zip_tree(fn, v, shardings[k] if isinstance(
            shardings, dict) else shardings) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        parts = shardings if isinstance(shardings, (tuple, list)) \
            else [shardings] * len(tree)
        if len(parts) != len(tree):
            raise ValueError(f"{len(tree)} leaves against {len(parts)} "
                             "shardings")
        return type(tree)(_zip_tree(fn, v, s) for v, s in zip(tree, parts))
    return fn(tree, shardings)


def distribute(x: torch.Tensor, device_mesh, placements):
    """Whole tensor ``x`` (the same on every rank) as a DTensor with
    ``placements``: each rank keeps its own block and nothing is sent.  A
    block that is all of ``x`` (every mesh dimension that splits it has
    one rank) is ``x`` itself, not a copy; a smaller block is copied out,
    so the whole tensor can be freed."""
    from torch.distributed.tensor import DTensor
    placements = tuple(placements)
    x = x.to(device_mesh.device_type).contiguous()
    shape, offset = compute_local_shape_and_global_offset(
        x.shape, device_mesh, placements)
    local = x
    for dim, (n, at) in enumerate(zip(shape, offset)):
        if n != x.shape[dim]:
            local = local.narrow(dim, at, n)
    if local is not x:
        local = local.clone()
    return DTensor.from_local(local, device_mesh, placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def distribute_tree(tree: Any, shardings: Any, device_mesh) -> Any:
    """Every tensor leaf of ``tree`` (host or whole, the same on every
    rank) as a DTensor on ``device_mesh`` with its sharding's placements
    (``distribute``); None shardings replicate.  Non-tensor leaves and
    DTensors pass as they are."""
    def put(x, sharding):
        if not isinstance(x, torch.Tensor) or is_dtensor(x):
            return x
        if x.is_meta:
            raise ValueError("a meta tensor has no values to distribute; "
                             "pass the cell's arguments made for real")
        return distribute(x, device_mesh, _sharding_placements(
            sharding, device_mesh, x.dim()))
    return _zip_tree(put, tree, shardings)


def gather_tree(tree: Any) -> Any:
    """Every DTensor leaf of ``tree`` as the whole tensor (the same on
    every rank); other leaves as they are."""
    return _zip_tree(lambda x, _: x.full_tensor() if is_dtensor(x) else x,
                     tree, None)


def _redistribute_tree(tree: Any, shardings: Any, device_mesh) -> Any:
    """Every tensor leaf laid out as its sharding says (None: replicated),
    a Partial one reduced on the way."""
    def put(x, sharding):
        if not isinstance(x, torch.Tensor):
            return x
        return placed(x, device_mesh, _sharding_placements(
            sharding, device_mesh, x.dim()))
    return _zip_tree(put, tree, shardings)


def run_cell(cell: dict, device_mesh, args=None):
    """Run a ``build_cell`` cell on ``device_mesh``: its arguments (``args``
    in place of the cell's ``meta`` ones, made the same on every rank)
    distributed by ``in_shardings``, ``cell["fn"]`` called on them with
    plain tensors met inside counting as replicated, and the outputs laid
    out by ``out_shardings`` (None: replicated).  Returns the outputs as
    DTensors (``gather_tree`` makes them whole)."""
    from torch.distributed.tensor.experimental import implicit_replication
    args = cell["args"] if args is None else args
    dargs = distribute_tree(tuple(args), tuple(cell["in_shardings"]),
                            device_mesh)
    with implicit_replication():
        out = cell["fn"](*dargs)
    return _redistribute_tree(out, cell["out_shardings"], device_mesh)
