"""The port's train step (``models/steps.py``), AdamW (``optim/adamw.py``)
and data stream (``data/pipeline.py``) against the JAX package on the CPU.

(a) One ``make_train_step`` of stablelm-1.6b-smoke, rwkv6-1.6b-smoke and
zamba2-1.2b-smoke (float32) with accum_steps 1 and 2, from the JAX
package's own init carried across by ``convert.train_state_from_jax``.
With grad_clip 0 the first moment after one step is exactly 0.1 x the
(accumulated) gradient in both packages, so it holds every gradient leaf.
Tolerances: the loss rtol 1e-5; each gradient leaf and the grad norm within
GRAD_TOL of its norm.  stablelm-smoke's gradients are ill-conditioned at
this init: both packages' float32 gradients lie ~5e-4 (relative) from a
float64 evaluation of the same function, so it is held to 2e-3; the
recurrent models to 1e-4.  The new parameters: at count 1 Adam moves an
element by about lr x sign(g), so an element whose gradient is within
rounding of zero may move the other way; every element is within
2 lr + 1e-6 of the reference's and at most 1 % differ by more than 1e-6.
(b) tests/test_accum.py's three cases on the port, with their tolerances.
(d) ``apply_updates`` fed the same gradients: float32 and bf16 moments, 1-d
leaves without decay; parameters and moments rtol 1e-6 (bf16 moments: to
one bf16 rounding, 2^-8), grad norm and lr rtol 1e-6.
(e) ``SyntheticStream`` batches byte-equal to the reference's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, smoke_reduce as jsmoke
from repro.data import DataConfig as JDataConfig, Prefetcher as JPrefetcher
from repro.data import SyntheticStream as JStream
from repro.models.steps import init_train_state as jinit
from repro.models.steps import make_decode_step as jmake_decode
from repro.models.steps import make_prefill_step as jmake_prefill
from repro.models.steps import make_train_step as jmake
from repro.optim import AdamWConfig as JAdamW, apply_updates as japply
from repro_torch.configs import get_arch, smoke_reduce
from repro_torch.convert import train_state_from_jax
from repro_torch.data import DataConfig, Prefetcher, SyntheticStream
from repro_torch.models.layers import ShardCtx
from repro_torch.models.steps import (abstract_train_state, init_train_state,
                                      make_decode_step, make_prefill_step,
                                      make_train_step, n_microbatches)
from repro_torch.optim import AdamWConfig, apply_updates
from repro_torch.parallel.axes import tree_leaves, tree_leaves_with_path

ARCHS = ["stablelm-1.6b", "rwkv6-1.6b", "zamba2-1.2b"]
GRAD_TOL = {"stablelm-1.6b": 2e-3, "rwkv6-1.6b": 1e-4, "zamba2-1.2b": 1e-4}
OPT = dict(warmup_steps=1, total_steps=4, grad_clip=0.0)
B1 = 0.9


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=[(a, A) for a in ARCHS
                                        for A in (1, 2)],
                ids=lambda p: f"{p[0]}-accum{p[1]}")
def stepped(request):
    """The reference's and the port's first step from the same state."""
    arch, A = request.param
    jarch = dataclasses.replace(jsmoke(jget_arch(arch)), accum_steps=A)
    tarch = dataclasses.replace(smoke_reduce(get_arch(arch)), accum_steps=A)
    tokens = np.random.RandomState(0).randint(
        0, jarch.vocab_size, (4, 32)).astype(np.int32)
    state = jinit(jarch, jax.random.PRNGKey(0), JAdamW(**OPT))
    start = _np(state)
    jstep, _ = jmake(jarch, JAdamW(**OPT))
    jnew, jm = jax.jit(jstep)(state, {"tokens": jnp.asarray(tokens)})
    tstep, _ = make_train_step(tarch, AdamWConfig(**OPT))
    tnew, tm = tstep(train_state_from_jax(start, device="cpu"),
                     {"tokens": tokens})
    return arch, _np(jnew), _np(jm), tnew, tm


def test_train_step_matches_reference(stepped):
    arch, jnew, jm, tnew, tm = stepped
    tol = GRAD_TOL[arch]
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=tol)
    assert int(tnew["step"]) == int(jnew["step"]) == 1
    assert int(tnew["opt"]["count"]) == 1
    jmom = dict(tree_leaves_with_path(jnew["opt"]["m"]))
    for path, m in tree_leaves_with_path(tnew["opt"]["m"]):
        want = jmom[path] / (1 - B1)          # the gradient, both packages
        got = m.numpy() / (1 - B1)
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= tol, (path, err)
        assert np.isfinite(got).all() and np.abs(got).max() > 0, path
    lr = float(jm["lr"])
    np.testing.assert_allclose(float(tm["lr"]), lr, rtol=1e-6)
    jpar = dict(tree_leaves_with_path(jnew["params"]))
    for path, p in tree_leaves_with_path(tnew["params"]):
        d = np.abs(p.numpy() - jpar[path])
        assert d.max() <= 2 * lr + 1e-6, (path, d.max())
        assert (d > 1e-6).mean() <= 0.01, (path, (d > 1e-6).mean())


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_leaves_gradients_unchanged(arch):
    """remat "full" (each layer, or each hybrid group, recomputed in the
    backward pass) gives the gradients of remat "none", bit for bit: the
    recomputation repeats the same float32 operations on the CPU."""
    from repro_torch.models.steps import train_loss
    from repro_torch.parallel.axes import tree_unflatten
    base = smoke_reduce(get_arch(arch))
    params = init_train_state(base, 0, AdamWConfig(), device="cpu")["params"]
    tokens = torch.as_tensor(np.random.RandomState(4).randint(
        0, base.vocab_size, (2, 16)))
    grads = {}
    for remat in ("none", "full"):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, _ = train_loss(dataclasses.replace(base, remat=remat),
                             tree_unflatten(params, leaves), tokens)
        grads[remat] = torch.autograd.grad(loss, leaves)
    for a, b in zip(grads["none"], grads["full"]):
        assert torch.equal(a, b)


def test_train_state_structure_matches_reference():
    cfg = smoke_reduce(get_arch("stablelm-1.6b"))
    jstate = jinit(jsmoke(jget_arch("stablelm-1.6b")), jax.random.PRNGKey(0),
                   JAdamW())
    abstract = abstract_train_state(cfg, AdamWConfig())
    want = [(p, a.shape, str(a.dtype)) for p, a in
            tree_leaves_with_path(_np(jstate))]
    got = [(p, tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for p, t in tree_leaves_with_path(abstract)]
    assert got == want
    assert all(t.device.type == "meta" for t in tree_leaves(abstract))
    state = init_train_state(cfg, 0, AdamWConfig(moment_dtype="bf16"),
                             device="cpu")
    assert state["opt"]["m"]["embed"]["embedding"].dtype == torch.bfloat16
    assert int(state["step"]) == 0 and state["step"].dtype == torch.int32


def test_prefill_and_decode_steps_match_reference():
    """The serving step closures (tests/test_torch_lm.py's tolerance, rtol
    2e-4 / atol 2e-3, and the same greedy token)."""
    arch = "stablelm-1.6b"
    jcfg, tcfg = jsmoke(jget_arch(arch)), smoke_reduce(get_arch(arch))
    state = _np(jinit(jcfg, jax.random.PRNGKey(0), JAdamW()))
    params = train_state_from_jax(state, device="cpu")["params"]
    tokens = np.random.RandomState(1).randint(0, jcfg.vocab_size, (2, 8))
    jlogits, jcache = jmake_prefill(jcfg)(state["params"],
                                          {"tokens": jnp.asarray(tokens)})
    tlogits, tcache = make_prefill_step(tcfg)(
        params, {"tokens": torch.as_tensor(tokens)})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=2e-4, atol=2e-3)
    # the cache is as long as the prompt: the step writes over its last row
    pos = np.full((2,), 7, np.int32)
    nxt = np.asarray(jlogits).argmax(-1)[:, None].astype(np.int32)
    jn, jl, _ = jmake_decode(jcfg)(state["params"], jcache,
                                   jnp.asarray(nxt), jnp.asarray(pos))
    tn, tl, _ = make_decode_step(tcfg)(params, tcache, torch.as_tensor(nxt),
                                       torch.as_tensor(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4,
                               atol=2e-3)
    assert tn.dtype == torch.int32 and np.array_equal(tn.numpy(),
                                                      np.asarray(jn))


# ---------------------------------------------------------------------------
# (b) tests/test_accum.py on the port
# ---------------------------------------------------------------------------

def _accum_arch(accum, opt_dtype="fp32"):
    a = smoke_reduce(get_arch("stablelm-1.6b"))
    return dataclasses.replace(a, n_layers=2, d_model=64, d_ff=128,
                               vocab_size=128, n_heads=2, n_kv_heads=2,
                               head_dim=32, accum_steps=accum,
                               opt_dtype=opt_dtype)


def _accum_run(arch, tokens, ctx=None, **opt):
    opt = AdamWConfig(**{"warmup_steps": 1, "total_steps": 4,
                         "grad_clip": 0.0, **opt})
    step, _ = make_train_step(arch, opt, **({"ctx": ctx} if ctx else {}))
    return step(init_train_state(arch, 0, opt, device="cpu"),
                {"tokens": tokens})


def _tokens(seed):
    return np.random.RandomState(seed).randint(0, 128, (8, 32))


def test_accum_matches_full_batch():
    _, m1 = _accum_run(_accum_arch(1), _tokens(1))
    _, m4 = _accum_run(_accum_arch(4), _tokens(1))
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m4["grad_norm"]),
                               rtol=5e-4)


def test_accum_bf16_drift_bounded():
    _, m32 = _accum_run(_accum_arch(4, "fp32"), _tokens(2))
    _, m16 = _accum_run(_accum_arch(4, "bf16"), _tokens(2))
    np.testing.assert_allclose(float(m16["grad_norm"]),
                               float(m32["grad_norm"]), rtol=2e-2)


def test_accum_clamped_to_shardable_microbatch():
    """accum_steps larger than batch / data groups is clamped, not a crash."""
    arch = _accum_arch(64)
    assert n_microbatches(arch, 8, ShardCtx(n_groups=4)) == 2
    _, m = _accum_run(arch, _tokens(3), ctx=ShardCtx(n_groups=4),
                      grad_clip=1.0)
    assert np.isfinite(float(m["loss"]))


# ---------------------------------------------------------------------------
# (d) AdamW
# ---------------------------------------------------------------------------

def _opt_tree(rs, dtype=np.float32):
    shapes = {"w": (6, 5), "stack": (2, 4, 3), "bias": (5,), "norm": (7,)}
    return {k: (rs.randn(*s) * 0.5).astype(dtype) for k, s in shapes.items()}


@pytest.mark.parametrize("moment_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("count", [0, 6])
def test_apply_updates_matches_reference(moment_dtype, count):
    rs = np.random.RandomState(7)
    params, grads = _opt_tree(rs), _opt_tree(rs)
    m, v = _opt_tree(rs), {k: np.abs(a) for k, a in _opt_tree(rs).items()}
    cfg = dict(moment_dtype=moment_dtype, warmup_steps=3, total_steps=20)
    jmd = jnp.bfloat16 if moment_dtype == "bf16" else jnp.float32
    jopt = {"m": jax.tree.map(lambda a: jnp.asarray(a, jmd), m),
            "v": jax.tree.map(lambda a: jnp.asarray(a, jmd), v),
            "count": jnp.int32(count)}
    jp, jo, jmet = japply(jax.tree.map(jnp.asarray, params),
                          jax.tree.map(jnp.asarray, grads), jopt,
                          JAdamW(**cfg))
    topt = train_state_from_jax({"m": _np(jopt["m"]), "v": _np(jopt["v"]),
                                 "count": np.int32(count)}, device="cpu")
    tp, to, tmet = apply_updates(
        train_state_from_jax(params, device="cpu"),
        train_state_from_jax(grads, device="cpu"), topt,
        AdamWConfig(**cfg))
    mtol = 2 ** -8 if moment_dtype == "bf16" else 1e-6
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        for name in ("m", "v"):
            np.testing.assert_allclose(
                to[name][k].float().numpy(),
                np.asarray(jo[name][k], np.float32), rtol=mtol, atol=1e-7,
                err_msg=f"{name}/{k}")
    assert int(to["count"]) == count + 1
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-6)


def test_weight_decay_spares_one_dimensional_leaves():
    rs = np.random.RandomState(8)
    params = train_state_from_jax(_opt_tree(rs), device="cpu")
    zeros = {k: torch.zeros_like(p) for k, p in params.items()}
    opt = {"m": zeros, "v": zeros, "count": torch.tensor(0, dtype=torch.int32)}
    new, _, met = apply_updates(params, zeros, opt, AdamWConfig(
        warmup_steps=1))
    for k in ("bias", "norm"):
        assert torch.equal(new[k], params[k])
    for k in ("w", "stack"):
        want = params[k] - float(met["lr"]) * 0.1 * params[k]
        torch.testing.assert_close(new[k], want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# (e) the data stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("media", [None, (3, 4)])
def test_stream_batches_byte_equal_reference(media):
    kw = dict(vocab_size=97, seq_len=24, global_batch=8, seed=5,
              media_shape=media)
    mine, theirs = SyntheticStream(DataConfig(**kw)), JStream(JDataConfig(**kw))
    for step, shard, n in ((0, 0, 1), (3, 1, 2), (11, 3, 4)):
        a, b = mine.batch(step, shard, n), theirs.batch(step, shard, n)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def test_prefetcher_order_matches_reference():
    kw = dict(vocab_size=50, seq_len=8, global_batch=4, seed=1)
    pa = Prefetcher(SyntheticStream(DataConfig(**kw)), 1, 2, start_step=4)
    pb = JPrefetcher(JStream(JDataConfig(**kw)), 1, 2, start_step=4)
    try:
        for _ in range(3):
            (sa, a), (sb, b) = pa.next(), pb.next()
            assert sa == sb and a["tokens"].tobytes() == b["tokens"].tobytes()
    finally:
        pa.stop()
        pb.stop()
