"""Property tests on the port's logical-axis rule system
(``repro_torch.parallel.axes``), the reference's four
(``tests/test_axes_property.py``) and a fifth: every spec equals the
reference's on the same axes, rules and mesh."""

import jax
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro.parallel import axes as raxes
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel.axes import (DEFAULT_RULES, PartitionSpec as P,
                                       logical_to_spec, make_rules)

LOGICAL = sorted(DEFAULT_RULES)


def _mesh(names=("data", "model")):
    return Mesh(tuple(names), (2,) * len(names))


@settings(max_examples=50, deadline=None)
@given(axes=st.lists(st.sampled_from(LOGICAL + [None]), min_size=0, max_size=6),
       fsdp=st.booleans(), kv=st.booleans(), sp=st.booleans())
def test_spec_never_reuses_a_mesh_axis(axes, fsdp, kv, sp):
    mesh = _mesh(("pod", "data", "model"))
    rules = make_rules(fsdp=fsdp, shard_kv_heads=kv, sequence_parallel=sp)
    spec = logical_to_spec(tuple(axes), rules, mesh)
    used = []
    for part in spec:
        if part is None:
            continue
        for a in (part if isinstance(part, tuple) else (part,)):
            used.append(a)
    assert len(used) == len(set(used)), (axes, spec)
    assert len(spec) == len(axes)


@settings(max_examples=30, deadline=None)
@given(axes=st.lists(st.sampled_from(LOGICAL), min_size=1, max_size=4))
def test_spec_only_uses_existing_mesh_axes(axes):
    mesh = _mesh(("data", "model"))  # no 'pod'
    spec = logical_to_spec(tuple(axes), make_rules(), mesh)
    for part in spec:
        if part is None:
            continue
        for a in (part if isinstance(part, tuple) else (part,)):
            assert a in ("data", "model")


def test_unknown_logical_axis_replicates():
    mesh = _mesh()
    assert logical_to_spec(("no_such_axis",), make_rules(), mesh) == P(None)


@settings(max_examples=20, deadline=None)
@given(overrides=st.dictionaries(st.sampled_from(LOGICAL),
                                 st.sampled_from([None, "data", "model"]),
                                 max_size=4))
def test_overrides_take_effect(overrides):
    mesh = _mesh()
    rules = make_rules(overrides=overrides)
    for k, v in overrides.items():
        spec = logical_to_spec((k,), rules, mesh)
        if v is None:
            assert spec == P(None)
        else:
            assert spec == P(v)


@settings(max_examples=50, deadline=None)
@given(axes=st.lists(st.sampled_from(LOGICAL + [None, "no_such_axis"]),
                     min_size=0, max_size=6),
       fsdp=st.booleans(), kv=st.booleans(), sp=st.booleans(),
       multi_pod=st.booleans())
def test_spec_equals_reference(axes, fsdp, kv, sp, multi_pod):
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    try:
        ref_mesh = jax.sharding.AbstractMesh((2,) * len(names), names)
    except TypeError:   # jax<=0.4.37 signature: tuple of (name, size) pairs
        ref_mesh = jax.sharding.AbstractMesh(tuple((n, 2) for n in names))
    kw = dict(fsdp=fsdp, shard_kv_heads=kv, sequence_parallel=sp)
    got = logical_to_spec(tuple(axes), make_rules(**kw), _mesh(names))
    want = raxes.logical_to_spec(tuple(axes), raxes.make_rules(**kw),
                                 ref_mesh)
    assert tuple(got) == tuple(want)
