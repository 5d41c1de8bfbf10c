"""The port's sharding rules, logical-axis trees and cell specs
(``repro_torch.parallel.axes``, ``launch/mesh.py``, ``launch/specs.py``)
against the reference's, for every (arch x shape) cell on the reference's
two production meshes and a (4, 2) mesh.  The reference side reads axis
names and sizes only, so its meshes are ``jax.sharding.AbstractMesh``es
(no devices); specs are compared as tuples (the port's ``PartitionSpec``
is a tuple, JAX's ``P`` iterates as one)."""

import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import SHAPES as R_SHAPES, get_arch as r_get_arch
from repro.launch import mesh as rmesh, specs as rspecs
from repro.models.registry import get_model as r_get_model
from repro.models.steps import train_state_axes as r_train_state_axes
from repro.optim import adamw as radamw
from repro.parallel import axes as raxes
from repro_torch.configs import ARCH_IDS, SHAPES, get_arch
from repro_torch.launch import specs
from repro_torch.launch.mesh import (Mesh, data_shards, make_production_mesh,
                                     model_shards, one_card_mesh)
from repro_torch.models.registry import get_model
from repro_torch.models.steps import train_state_axes
from repro_torch.optim import adamw
from repro_torch.parallel import axes

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}


def _abstract(shape, names):
    try:
        return jax.sharding.AbstractMesh(shape, names)
    except TypeError:   # jax<=0.4.37 signature: tuple of (name, size) pairs
        return jax.sharding.AbstractMesh(tuple(zip(names, shape)))


def _meshes(name):
    shape, names = MESHES[name]
    return Mesh(names, shape, name), _abstract(shape, names)


def _plain(tree):
    """Specs (JAX's P or the port's PartitionSpec) and shardings (either
    package's NamedSharding) of a tree as plain tuples."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (jax.sharding.NamedSharding, axes.NamedSharding)):
        return tuple(tree.spec)
    return tuple(tree)


@functools.lru_cache(maxsize=None)
def _trees(arch_id):
    """(port, reference) params_axes, cache_axes and train_state_axes."""
    port = (get_model(get_arch(arch_id)).params_axes(),
            get_model(get_arch(arch_id)).cache_axes(),
            train_state_axes(get_arch(arch_id)))
    ref = (r_get_model(r_get_arch(arch_id)).params_axes(),
           r_get_model(r_get_arch(arch_id)).cache_axes(),
           r_train_state_axes(r_get_arch(arch_id)))
    return port, ref


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_rules_and_specs_match_reference(arch_id, mesh_name):
    """arch_rules, the specs of the parameter, cache and train-state trees,
    and the batch shardings of every shape equal the reference's."""
    mesh, rmesh_ = _meshes(mesh_name)
    (p_params, p_cache, p_state), (r_params, r_cache, r_state) = \
        _trees(arch_id)
    for shape_id in SHAPES:
        arch, shape = get_arch(arch_id), SHAPES[shape_id]
        rarch, rshape = r_get_arch(arch_id), R_SHAPES[shape_id]
        rules = specs.arch_rules(arch, shape, mesh)
        rrules = rspecs.arch_rules(rarch, rshape, rmesh_)
        assert rules == rrules, (arch_id, shape_id)
        for port, ref in ((p_params, r_params), (p_cache, r_cache),
                          (p_state, r_state)):
            assert _plain(axes.tree_spec(port, rules, mesh)) == \
                _plain(raxes.tree_spec(ref, rrules, rmesh_)), \
                (arch_id, shape_id)
        assert _plain(specs.batch_shardings(arch, shape, mesh)) == \
            _plain(rspecs.batch_shardings(rarch, rshape, rmesh_))
        assert specs.shard_ctx(arch, shape, mesh).n_groups == \
            rspecs.shard_ctx(rarch, rshape, rmesh_).n_groups


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_axes_trees_match_reference(arch_id):
    (p_params, p_cache, p_state), (r_params, r_cache, r_state) = \
        _trees(arch_id)
    assert p_params == r_params
    assert p_cache == r_cache
    assert p_state == r_state
    assert adamw.opt_state_axes(p_params) == radamw.opt_state_axes(r_params)
    # one logical-axes tuple per parameter and cache leaf, of its rank
    model = get_model(get_arch(arch_id))
    for tree, leaves in ((p_params, model.abstract_params()),
                         (p_cache, model.cache_struct(2, 64))):
        got = axes.tree_leaves_with_path(tree)
        want = axes.tree_leaves_with_path(leaves)
        assert [p for p, _ in got] == [p for p, _ in want]
        assert all(len(a) == t.dim() for (_, a), (_, t) in zip(got, want))


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_batch_specs_match_reference(arch_id):
    """Shapes and dtypes of every shape's batch, the media included, on
    the meta device (nothing allocated)."""
    for shape_id in SHAPES:
        got = specs.batch_specs(get_arch(arch_id), SHAPES[shape_id])
        want = rspecs.batch_specs(r_get_arch(arch_id), R_SHAPES[shape_id])
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].is_meta
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert str(got[k].dtype).removeprefix("torch.") == \
                str(want[k].dtype)


def test_batch_specs_shapes():
    arch = get_arch("llama-3.2-vision-90b")
    b = specs.batch_specs(arch, SHAPES["train_4k"])
    assert b["tokens"].shape == (256, 4096)
    assert b["media"].shape == (256, 1024, 8192)
    d = specs.batch_specs(arch, SHAPES["decode_32k"])
    assert d["tokens"].shape == (128, 1)
    assert d["pos"].shape == (128,)


def test_meshes_match_reference():
    for multi_pod, name in ((False, "pod16x16"), (True, "pod2x16x16")):
        mesh = make_production_mesh(multi_pod=multi_pod)
        ref = _abstract(*MESHES[name])
        assert mesh.name == name
        assert mesh.shape == dict(ref.shape)
        assert mesh.axis_names == tuple(ref.axis_names)
        assert mesh.size == ref.size
        assert data_shards(mesh) == rmesh.data_shards(ref)
        assert model_shards(mesh) == rmesh.model_shards(ref)
    one = one_card_mesh()
    assert (one.name, one.size, one.shape) == ("h100x1", 1,
                                               {"data": 1, "model": 1})
    assert data_shards(one) == model_shards(one) == 1


def test_rules_resolution_basics():
    mesh = Mesh(("data", "model"), (2, 2))
    rules = axes.make_rules()
    assert axes.logical_to_spec(("batch", "seq"), rules, mesh) == \
        ("data", None)
    assert axes.logical_to_spec(("embed", "ff"), rules, mesh) == \
        (None, "model")
    assert axes.logical_to_spec(("batch",), rules, mesh) == ("data",)
    fsdp = axes.make_rules(fsdp=True)
    assert axes.logical_to_spec(("embed", "ff"), fsdp, mesh) == \
        ("data", "model")
    # embed -> data, but batch already took data
    assert axes.logical_to_spec(("batch", "embed"), fsdp, mesh) == \
        ("data", None)


def test_decode_and_long_context_rules():
    mesh = Mesh(("data", "model"), (2, 2))
    rules = specs.arch_rules(get_arch("stablelm-1.6b"), SHAPES["decode_32k"],
                             mesh)
    spec = axes.logical_to_spec(("layers", "batch", "kv_seq", "kv_heads",
                                 "head_dim"), rules, mesh)
    assert spec[2] == "model"
    long = specs.arch_rules(get_arch("rwkv6-1.6b"), SHAPES["long_500k"], mesh)
    assert long["batch"] is None


def test_named_sharding_shard_shape():
    mesh = Mesh(("pod", "data", "model"), (2, 16, 16))
    s = axes.NamedSharding(mesh, axes.PartitionSpec(("pod", "data"), None,
                                                    "model"))
    assert s.shard_shape((100, 7, 33)) == (4, 7, 3)      # rounded up
    t = torch.empty((100, 7, 33), dtype=torch.bfloat16, device="meta")
    assert s.shard_bytes(t) == 4 * 7 * 3 * 2
    assert axes.NamedSharding(mesh, axes.PartitionSpec()).shard_shape(
        (5, 6)) == (5, 6)


def test_tree_sharding_and_params_axes_exports():
    from repro_torch import parallel
    for name in ("DEFAULT_RULES", "Initializer", "logical_to_spec",
                 "make_rules", "params_axes", "tree_sharding", "tree_spec"):
        assert hasattr(parallel, name), name
    mesh = Mesh(("data", "model"), (4, 2))
    tree = {"a": ("embed", "ff"), "b": {"c": ()}}
    got = axes.tree_sharding(tree, axes.make_rules(), mesh)
    assert got["a"].spec == (None, "model") and got["a"].mesh is mesh
    assert got["b"]["c"].spec == ()
    assert axes.DEFAULT_RULES == raxes.DEFAULT_RULES
    with pytest.raises(TypeError):
        axes.tree_spec({"a": [1]}, axes.make_rules(), mesh)


def test_spec_equals_reference_on_every_rule_variant():
    """logical_to_spec of every logical axis, alone and after each other,
    under every make_rules variant, on single- and multi-pod meshes."""
    logical = sorted(axes.DEFAULT_RULES) + [None, "no_such_axis"]
    for name in ("pod16x16", "pod2x16x16"):
        mesh, rmesh_ = _meshes(name)
        for fsdp in (False, True):
            for kv in (False, True):
                for sp in (False, True):
                    rules = axes.make_rules(fsdp=fsdp, shard_kv_heads=kv,
                                            sequence_parallel=sp)
                    rrules = raxes.make_rules(fsdp=fsdp, shard_kv_heads=kv,
                                              sequence_parallel=sp)
                    assert rules == rrules
                    for a in logical:
                        for b in logical:
                            assert tuple(axes.logical_to_spec(
                                (a, b), rules, mesh)) == tuple(
                                raxes.logical_to_spec((a, b), rrules,
                                                      rmesh_))


def test_partition_spec_is_a_tuple_like_p():
    spec = axes.PartitionSpec(("pod", "data"), None)
    assert tuple(spec) == tuple(P(("pod", "data"), None))
    assert spec == (("pod", "data"), None) and len(spec) == 2
    assert "PartitionSpec" in repr(spec)


def test_partition_spec_normalises_like_p():
    parts = (("data",), (), ("a", "b"), None, "model")
    assert tuple(axes.PartitionSpec(*parts)) == tuple(P(*parts))
