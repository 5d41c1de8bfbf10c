"""Parity of the port's forests (repro_torch.ml.forest, repro_torch.kernels)
with the JAX package on the CPU: fitting, the plain torch versions of both
CUDA kernels, the dispatch and the packed layout.

Bitwise wherever the reference is numpy-exact (fitting with integer split
statistics, the numpy mirror); the Pallas kernels run in interpret mode and
are held to the reference's own tolerances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ml.forest as jforest
from repro.kernels import forest as jkernels
from repro.ml.models import ALL_MODELS as JAX_MODELS
from repro_torch.kernels import ops, ref
from repro_torch.ml import forest as tforest
from repro_torch.ml.models import ALL_MODELS as TORCH_MODELS

CPU = "cpu"


def _data(n=300, f=12, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.rand(n) > 0.8).astype(np.float32)
    return X, y


# the fixtures of tests/test_forest_grouped.py: (target flip, fit kwargs)
FITS = {
    "a": (False, dict(n_trees=24, depth=5, seed=0)),
    "b": (True, dict(n_trees=24, depth=5, seed=1)),
    "c": (False, dict(n_trees=8, depth=3, seed=2)),
    "d": (True, dict(n_trees=16, depth=4, seed=3)),
}


@pytest.fixture(scope="module")
def fitted():
    """{name: (jax ForestParams, port ForestParams)} on the same data."""
    X, y = _data()
    out = {}
    for name, (flip, kw) in FITS.items():
        target = 1 - y if flip else y
        out[name] = (jforest.fit_oblivious_forest(X, target, **kw),
                     tforest.fit_oblivious_forest(X, target, device=CPU, **kw))
    return out


def _assert_same_forest(j, t):
    assert np.array_equal(j.feat_idx, t.feat_idx)
    assert np.array_equal(j.thresholds, t.thresholds)
    assert np.array_equal(j.leaves, t.leaves)


@pytest.mark.parametrize("name", sorted(FITS))
def test_fit_matches_reference(fitted, name):
    _assert_same_forest(*fitted[name])


@pytest.mark.parametrize("algo", ["R.F.", "Tree", "CTree"])
def test_forest_models_fit_matches_reference(algo):
    X, y = _data(seed=10)
    j = JAX_MODELS[algo]().fit(X, y)
    t = TORCH_MODELS[algo](device=CPU).fit(X, y)
    _assert_same_forest(j.params, t.params)
    Xq = _data(n=40, seed=11)[0]         # <= SMALL_BATCH: the numpy route
    assert np.array_equal(j.predict_proba(Xq), t.predict_proba(Xq))


def test_boost_fit_matches_reference():
    """Boost fits on float residuals with float weights, so its leaf sums
    are sums of non-integers.  The splits agree exactly.  The leaf means do
    not: already in stage 0, with identical inputs and identical splits,
    the reference's ``_leaf_values`` one-hot dots (XLA's CPU dot) round
    differently from the port's.  Neither a sequential sum in sample order,
    a pairwise sum nor 16- or 32-lane partial sums reproduce XLA's order,
    so the leaves (largest gap about 1.3e-6) are held to 1e-5."""
    X, y = _data(seed=12)
    j = JAX_MODELS["Boost"]().fit(X, y)
    t = TORCH_MODELS["Boost"](device=CPU).fit(X, y)
    assert len(j.stages) == len(t.stages) == 20
    for sj, st in zip(j.stages, t.stages):
        assert np.array_equal(sj.feat_idx, st.feat_idx)
        assert np.array_equal(sj.thresholds, st.thresholds)
        np.testing.assert_allclose(st.leaves, sj.leaves, rtol=1e-5, atol=1e-5)
    Xq = _data(n=40, seed=13)[0]
    np.testing.assert_allclose(t.predict_proba(Xq), j.predict_proba(Xq),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B", [1, 13, 64, 65, 300])
def test_forest_infer_ref_bitwise_vs_numpy_mirror(fitted, B):
    jp, tp = fitted["a"]
    Xq = _data(seed=4)[0][:B]
    want = jforest.forest_predict_np(jp, Xq)
    got = ref.forest_infer_ref(torch.from_numpy(Xq), *tp.on(CPU)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(tforest.forest_predict(tp, Xq, device=CPU), want)
    assert np.array_equal(tforest.forest_predict_np(tp, Xq), want)


def _groups(fitted, spec, which, Xq):
    """[(params, rows)] for package ``which`` (0 = jax, 1 = port)."""
    return [(fitted[name][which], Xq[lo:hi]) for name, lo, hi in spec]


def _stacked(spec, sizes):
    out, at = [], 0
    for i, b in enumerate(sizes):
        out.append((spec[i % len(spec)], at, at + b))
        at += b
    return out


# the _check_bitwise cases of tests/test_forest_grouped.py
GROUP_CASES = {
    **{f"same_shape_{'_'.join(map(str, b))}": (4, _stacked(["a", "b"], b))
       for b in [(1,), (1, 1, 1), (7, 33), (1, 64, 2), (65, 1, 5, 12)]},
    "heterogeneous": (5, [("a", 0, 9), ("c", 9, 40), ("d", 40, 41),
                          ("a", 41, 100), ("c", 100, 103)]),
    "single_model": (6, [("a", 0, 50), ("a", 50, 51)]),
    "interleaved": (7, [("a", 0, 5), ("b", 5, 30), ("a", 30, 60),
                        ("b", 60, 61)]),
    "with_empty": (8, [("a", 0, 0), ("c", 0, 20), ("b", 20, 20),
                       ("d", 20, 33)]),
}


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_grouped_torch_bitwise_vs_numpy(fitted, case):
    seed, spec = GROUP_CASES[case]
    Xq = _data(seed=seed)[0]
    jgroups = _groups(fitted, spec, 0, Xq)
    want, _ = jforest.forest_predict_grouped(jgroups, impl="numpy")
    got, passes = tforest.forest_predict_grouped(_groups(fitted, spec, 1, Xq),
                                                 device=CPU)
    assert passes == 1
    for (params, rows), w, g in zip(jgroups, want, got):
        assert np.array_equal(g, w)
        assert np.array_equal(g, jforest.forest_predict_np(params, rows))
    # the port keeps the numpy pass too (the fleet sweep's executor uses it)
    got_np, _ = tforest.forest_predict_grouped(_groups(fitted, spec, 1, Xq),
                                               impl="numpy")
    for w, g in zip(want, got_np):
        assert np.array_equal(g, w)


def test_grouped_ref_direct_bitwise(fitted):
    """kernels.ref.forest_infer_grouped_ref on the packed layout, with
    explicit per-row segment ids, against the per-model numpy mirror."""
    names = ["a", "c", "d"]
    sizes = [9, 31, 4]
    packed = tforest.pack_forests([fitted[n][1] for n in names])
    Xq = _data(seed=9)[0][:sum(sizes)]
    seg_ids = torch.repeat_interleave(torch.arange(3), torch.tensor(sizes))
    got = ref.forest_infer_grouped_ref(torch.from_numpy(Xq), seg_ids,
                                       *packed.on(CPU)).numpy()
    at = 0
    for n, b in zip(names, sizes):
        want = jforest.forest_predict_np(fitted[n][0], Xq[at:at + b])
        assert np.array_equal(got[at:at + b], want)
        at += b


@pytest.mark.parametrize("B,F,T,D,bb", [
    (32, 16, 8, 4, 16),
    (100, 32, 64, 6, 32),
])
def test_forest_infer_ref_vs_pallas_interpret(B, F, T, D, bb):
    rs = np.random.RandomState(1)
    x = rs.randn(B, F).astype(np.float32)
    feat_idx = rs.randint(0, F, (T, D)).astype(np.int32)
    thr = rs.randn(T, D).astype(np.float32)
    leaves = rs.randn(T, 2 ** D).astype(np.float32)
    want = jkernels.forest_infer(jnp.asarray(x), jnp.asarray(feat_idx),
                                 jnp.asarray(thr), jnp.asarray(leaves),
                                 block_b=bb, interpret=True)
    got = ops.forest_infer(*map(torch.from_numpy, (x, feat_idx, thr, leaves)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_grouped_ref_vs_pallas_interpret(fitted):
    Xq = _data(seed=8, n=700)[0]
    sizes = [300, 250, 150]
    names = ["a", "b", "c"]
    packed = jforest.pack_forests([fitted[n][0] for n in names])
    want = jkernels.forest_infer_grouped(
        Xq, sizes, packed.feat_idx, packed.thresholds, packed.leaves,
        packed.n_trees, interpret=True)
    tpacked = tforest.pack_forests([fitted[n][1] for n in names])
    offsets = torch.tensor([0, 300, 550, 700], dtype=torch.int32)
    got = ops.forest_infer_grouped(torch.from_numpy(Xq), offsets,
                                   *tpacked.on(CPU))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_forest_infer_ref_vs_python_traversal():
    """Independent python traversal (no torch) as a second oracle."""
    rs = np.random.RandomState(2)
    B, F, T, D = 17, 8, 5, 3
    x = rs.randn(B, F).astype(np.float32)
    feat_idx = rs.randint(0, F, (T, D)).astype(np.int32)
    thr = rs.randn(T, D).astype(np.float32)
    leaves = rs.randn(T, 2 ** D).astype(np.float32)
    want = np.zeros(B)
    for b in range(B):
        for t in range(T):
            leaf = 0
            for d in range(D):
                leaf = (leaf << 1) | int(x[b, feat_idx[t, d]] > thr[t, d])
            want[b] += leaves[t, leaf]
    want /= T
    got = ref.forest_infer_ref(*map(torch.from_numpy,
                                    (x, feat_idx, thr, leaves)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("names", [("a", "c"), ("a", "b", "c", "d")])
def test_pack_forests_layout_matches_reference(fitted, names):
    want = jforest.pack_forests([fitted[n][0] for n in names])
    got = tforest.pack_forests([fitted[n][1] for n in names])
    for field in ("feat_idx", "thresholds", "leaves", "n_trees"):
        a, b = getattr(want, field), getattr(got, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


def test_device_copies_are_cached(fitted):
    tp = fitted["a"][1]
    assert tp.on(CPU) is tp.on("cpu")
    packed = tforest._packed_for([fitted["a"][1], fitted["b"][1]])
    assert tforest._packed_for([fitted["a"][1], fitted["b"][1]]) is packed
    assert packed.on(CPU) is packed.on(CPU)


def test_width_check_is_cached_and_still_raises(fitted):
    """forest_predict checks once per (forest, feature count) that the rows
    hold every feature the forest tests; a forest testing a feature the rows
    lack raises on the first call and after calls that passed."""
    tp = fitted["a"][1]
    top = int(tp.feat_idx.max())
    Xq = _data(seed=14)[0][:13]
    want = tforest.forest_predict_np(tp, Xq)
    for _ in range(2):                     # the second call hits the cache
        assert np.array_equal(tforest.forest_predict(tp, Xq, device=CPU),
                              want)
        outs, _ = tforest.forest_predict_grouped([(tp, Xq)], device=CPU)
        assert np.array_equal(outs[0], want)
    narrow = Xq[:, :top]                   # lacks the highest feature
    for _ in range(2):
        with pytest.raises(ValueError, match=f"feature {top}"):
            tforest.forest_predict(tp, narrow, device=CPU)
        with pytest.raises(ValueError, match=f"feature {top}"):
            tforest.forest_predict_grouped([(tp, narrow)], device=CPU)
    # a forest whose feature indices are replaced is checked anew
    wide = tforest.ForestParams(tp.feat_idx.copy(), tp.thresholds, tp.leaves)
    assert np.array_equal(tforest.forest_predict(wide, Xq, device=CPU), want)
    wide.feat_idx = np.full_like(tp.feat_idx, Xq.shape[1])
    with pytest.raises(ValueError, match="rows have 12 features"):
        tforest.forest_predict(wide, Xq, device=CPU)


@pytest.mark.parametrize("n,cap", [(0, 1024), (1, 1024), (1024, 1024),
                                   (1025, 2048), (4096 * 22 + 3, 131072)])
def test_staging_capacity_is_a_power_of_two(n, cap):
    assert tforest._capacity(n) == cap


def test_staging_views_share_the_buffers(monkeypatch):
    """The staging buffers' views, built on the CPU (pinned memory needs a
    card, so it is left out here): the rows and the int32 offsets lie one
    after the other in the input words; the device views alias the device
    buffers; a shape's views are kept until a buffer grows."""
    empty = torch.empty
    monkeypatch.setattr(tforest.torch, "empty", lambda *a, pin_memory=False,
                        **kw: empty(*a, **kw))
    st = tforest._Staging(torch.device(CPU))
    views = st.views_for(13, 22, 3)
    assert st.views_for(13, 22, 3) is views
    assert views.rows.shape == (13, 22) and views.offsets.dtype == np.int32
    views.rows[...] = 1.5
    views.offsets[:] = [0, 4, 13]
    host_words, host_out = views.host
    assert host_words.numel() == 13 * 22 + 3
    st.dev_in[:host_words.numel()].copy_(host_words)   # the C call's copy
    assert torch.equal(views.x, torch.full((13, 22), 1.5))
    assert views.seg_start.dtype == torch.int32
    assert views.seg_start.tolist() == [0, 4, 13]
    assert views.x.data_ptr() == st.dev_in.data_ptr()
    assert views.out.shape == host_out.shape == views.scores.shape == (13,)
    assert views.out.data_ptr() == st.dev_out.data_ptr()
    host_out.fill_(0.25)
    assert (views.scores == 0.25).all()
    cap = st.host_in.numel()
    st.views_for(4096, 22)                # grows: earlier views dropped
    assert st.host_in.numel() == tforest._capacity(4096 * 22) > cap
    assert st.views_for(13, 22, 3) is not views
    for rows in range(1, 300):              # a bounded set of shapes is kept
        st.views_for(rows, 22)
    assert len(st.views) <= tforest._VIEWS_MAX
