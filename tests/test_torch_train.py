"""The port's train step (``models/steps.py``), AdamW (``optim/adamw.py``)
and data stream (``data/pipeline.py``) against the JAX package on the CPU.

(a) One ``make_train_step`` of the smoke configs of stablelm-1.6b,
rwkv6-1.6b, zamba2-1.2b, deepseek-moe-16b, llama-3.2-vision-90b and
whisper-large-v3 (float32) with accum_steps 1 and 2, from the JAX
package's own init carried across by ``convert.train_state_from_jax``; the
vlm's cross-block gates (zero at init, which would hide every cross
block) opened to 0.5 in both packages' states, and the vlm and audio
batches carrying media, normal x 0.02 from a numpy seed.  deepseek-moe's
smoke config is drop-free (capacity_factor 8), so it runs again at
capacity_factor 1.0, which drops (token, expert) pairs (the loss moves
against the drop-free step's).  With grad_clip 0 the first moment after
one step is exactly 0.1 x the (accumulated) gradient in both packages, so
it holds every gradient leaf.  Tolerances: the loss and the aux loss
rtol 1e-5; each gradient leaf and the grad norm within GRAD_TOL of its
norm.  Some of these gradients are ill-conditioned at this init (saturated
attention): against a float64 evaluation of the same function (the port's
arithmetic in float64), stablelm-smoke's float32 gradients lie ~5e-4
(relative) from it in both packages, so it is held to 2e-3;
deepseek-moe's first-layer attention gradients lie 1.2e-3 (port) and
3.3e-3 (reference) from it and 2.4e-3 / 3.5e-3 (accum 1 / 2) apart, held
to 5e-3; the vlm's 2e-4 / 1e-4, at most 8e-4 apart (accum 2), held to
2e-3; whisper's 2.7e-4 / 2.6e-4, 9e-5 apart, held to 5e-4; the recurrent
models to 1e-4.  The new parameters: at count 1 Adam moves an element by
about lr x sign(g), so an element whose gradient is within rounding of
zero may move the other way; every element is within 2 lr + 1e-6 of the
reference's and at most 1 % differ by more than 1e-6.
(c) A bf16 smoke vlm and whisper with float32 media (the data stream's
dtype): the reference promotes where the media meet the weights, and so
must the port.  Held: the dtypes (the hidden state bf16; the encoder's
output and the cross keys cached by prefill float32), the encoder's
float32 output within 1e-5 of the largest magnitude, and for the hidden
state, the prefill and decode logits and the train step's gradients, the
port no more than twice as far (in norm) from the float32 evaluation of
the same bf16-rounded weights as the reference is; the step's loss rtol
1e-3.  bf16 itself moves these by up to ~50 % of the gradient's norm in
both packages, so a tighter bound between the two would hold rounding.
(b) tests/test_accum.py's three cases on the port, with their tolerances.
(d) ``apply_updates`` fed the same gradients: float32 and bf16 moments, 1-d
leaves without decay; parameters and moments rtol 1e-6 (bf16 moments: to
one bf16 rounding, 2^-8), grad norm and lr rtol 1e-6.
(e) ``SyntheticStream`` batches byte-equal to the reference's.
(f) whisper's first gradient norm by depth from the reference's init and
from the same draw at the full fan-in, in both packages (tolerances at
NORM_RTOL)."""

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
from repro.models.registry import get_model as jget_model
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

ARCHS = ["stablelm-1.6b", "rwkv6-1.6b", "zamba2-1.2b", "deepseek-moe-16b",
         "llama-3.2-vision-90b", "whisper-large-v3"]
GRAD_TOL = {"stablelm-1.6b": 2e-3, "rwkv6-1.6b": 1e-4, "zamba2-1.2b": 1e-4,
            "deepseek-moe-16b": 5e-3, "llama-3.2-vision-90b": 2e-3,
            "whisper-large-v3": 5e-4}
# (arch, accum_steps, capacity_factor or None for the smoke config's)
STEPS = [(a, A, None) for a in ARCHS for A in (1, 2)] \
    + [("deepseek-moe-16b", A, 1.0) for A in (1, 2)]
OPT = dict(warmup_steps=1, total_steps=4, grad_clip=0.0)
B1 = 0.9
GATE = 0.5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(arch, A=1, capacity=None, bf16=False):
    """The reference's and the port's smoke config of ``arch``."""
    out = []
    for cfg, dtype in ((jsmoke(jget_arch(arch)), jnp.bfloat16),
                       (smoke_reduce(get_arch(arch)), torch.bfloat16)):
        cfg = dataclasses.replace(cfg, accum_steps=A)
        if capacity is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=capacity))
        if bf16:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        out.append(cfg)
    return out


def _batch(jarch, B=4, S=32):
    """Seeded tokens, and media (normal x 0.02, float32) for the vlm and
    audio families."""
    batch = {"tokens": np.random.RandomState(0).randint(
        0, jarch.vocab_size, (B, S)).astype(np.int32)}
    ms = jget_model(jarch).media_struct(B)
    if ms is not None:
        batch["media"] = (np.random.RandomState(1).randn(*ms.shape)
                          * 0.02).astype(np.float32)
    return batch


def _start(jarch):
    """The reference's initial train state as numpy, the vlm's gates
    opened."""
    start = _np(jinit(jarch, jax.random.PRNGKey(0), JAdamW(**OPT)))
    cross = start["params"].get("cross_blocks")
    if cross is not None:
        for gate in ("gate_attn", "gate_mlp"):
            cross[gate] = np.full_like(cross[gate], GATE)
    return start


def _jstep(jarch, start, batch):
    jstep, _ = jmake(jarch, JAdamW(**OPT))
    jnew, jm = jax.jit(jstep)(jax.tree.map(jnp.asarray, start),
                              {k: jnp.asarray(v) for k, v in batch.items()})
    return _np(jnew), _np(jm)


def _id(p):
    arch, A, cap = p
    return f"{arch}-accum{A}" if cap is None else f"{arch}-cap{cap}-accum{A}"


@pytest.fixture(scope="module", params=STEPS, ids=_id)
def stepped(request):
    """The reference's and the port's first step from the same state; for
    a capacity case also the port's loss at the smoke config's (drop-free)
    capacity."""
    arch, A, cap = request.param
    jarch, tarch = _configs(arch, A, cap)
    batch = _batch(jarch)
    start = _start(jarch)
    jnew, jm = _jstep(jarch, start, batch)
    tstep, _ = make_train_step(tarch, AdamWConfig(**OPT))
    tnew, tm = tstep(train_state_from_jax(start, device="cpu"), batch)
    drop_free = None
    if cap is not None:
        fstep, _ = make_train_step(_configs(arch, A)[1], AdamWConfig(**OPT))
        drop_free = float(fstep(train_state_from_jax(start, device="cpu"),
                                batch)[1]["loss"])
    return arch, jnew, jm, tnew, tm, drop_free


def test_train_step_matches_reference(stepped):
    arch, jnew, jm, tnew, tm, drop_free = stepped
    tol = GRAD_TOL[arch]
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["aux_loss"]), float(jm["aux_loss"]),
                               rtol=1e-5)
    assert (float(tm["aux_loss"]) > 0) == arch.startswith("deepseek")
    if drop_free is not None:       # the capacity drops changed the step
        assert abs(float(tm["loss"]) - drop_free) > 1e-5 * drop_free
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
    """remat "full" (each layer, each hybrid group or vlm period, each
    encoder and decoder block recomputed in the backward pass) gives the
    gradients of remat "none", bit for bit: the recomputation repeats the
    same float32 operations on the CPU."""
    from repro_torch.models.steps import train_loss
    from repro_torch.parallel.axes import tree_unflatten
    from repro_torch.models import get_model
    base = smoke_reduce(get_arch(arch))
    params = init_train_state(base, 0, AdamWConfig(), device="cpu")["params"]
    tokens = torch.as_tensor(np.random.RandomState(4).randint(
        0, base.vocab_size, (2, 16)))
    ms = get_model(base).media_struct(2)
    media = None if ms is None else torch.as_tensor(
        np.random.RandomState(5).randn(*ms.shape).astype(np.float32) * 0.02)
    grads = {}
    for remat in ("none", "full"):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, _ = train_loss(dataclasses.replace(base, remat=remat),
                             tree_unflatten(params, leaves), tokens,
                             media=media)
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
# (c) float32 media on bf16 weights
# ---------------------------------------------------------------------------

def _dist(a, b) -> float:
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    return float(np.linalg.norm(a - np.asarray(b, np.float64)))


def _grad_vector(opt_m) -> np.ndarray:
    return np.concatenate([np.asarray(
        m.float() if isinstance(m, torch.Tensor) else m,
        np.float64).ravel() / (1 - B1)
        for _, m in tree_leaves_with_path(opt_m)])


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-large-v3"])
def test_bf16_weights_take_float32_media(arch):
    """The smoke vlm / whisper with bf16 weights and float32 media, as the
    data stream writes them: forward, prefill and one decode step, and a
    train step, against the reference (module docstring, (c))."""
    from repro.models import encdec as jencdec
    from repro_torch.models import encdec, get_model
    jarch, tarch = _configs(arch, bf16=True)
    jarch32 = dataclasses.replace(jarch, dtype=jnp.float32)
    batch = _batch(jarch)
    start = _start(jarch)
    start32 = jax.tree.map(lambda a: np.asarray(a, np.float32)
                           if a.dtype == jnp.bfloat16 else a, start)
    jp, jp32 = (jax.tree.map(jnp.asarray, t["params"])
                for t in (start, start32))
    tp = train_state_from_jax(start, device="cpu")["params"]
    jm_, tm_ = jget_model(jarch), get_model(tarch)
    tokens, media = batch["tokens"], batch["media"]
    tmedia = torch.as_tensor(media)

    # the forward's final hidden state: bf16, as the reference's
    jh, _ = jm_.apply(jp, jnp.asarray(tokens), media=jnp.asarray(media),
                      return_hidden=True)
    truth, _ = jget_model(jarch32).apply(jp32, jnp.asarray(tokens),
                                         media=jnp.asarray(media),
                                         return_hidden=True)
    th, _ = tm_.apply(tp, tokens, media=tmedia, return_hidden=True,
                      device="cpu")
    assert jh.dtype == jnp.bfloat16 and th.dtype == torch.bfloat16
    assert _dist(th, truth) <= 2 * _dist(jh, truth)
    if arch.startswith("whisper"):     # the encoder computes in float32
        je = np.asarray(jencdec.encode(jp, jarch, jnp.asarray(media)))
        te = encdec.encode(tp, tarch, tmedia)
        assert je.dtype == np.float32 and te.dtype == torch.float32
        assert np.abs(te.numpy() - je).max() <= 1e-5 * np.abs(je).max()

    # prefill (the cross keys cached in float32) and one decode step
    S = tokens.shape[1]
    pos = np.full((tokens.shape[0],), S, np.int32)
    outs = {}
    for name, model, params, m in (
            ("ref", jm_, jp, jnp.asarray(media)),
            ("truth", jget_model(jarch32), jp32, jnp.asarray(media))):
        logits, cache = model.prefill(params, jnp.asarray(tokens), media=m,
                                      max_len=S + 1)
        nxt = jnp.asarray(np.asarray(logits).argmax(-1)[:, None],
                          jnp.int32)
        outs[name] = (logits, cache, nxt, model.decode(
            params, cache, nxt, jnp.asarray(pos))[0])
    tlogits, tcache = tm_.prefill(tp, tokens, media=tmedia, max_len=S + 1,
                                  device="cpu")
    assert str(outs["ref"][1]["xk"].dtype) == "float32"
    assert tcache["xk"].dtype == torch.float32
    tdec, _ = tm_.decode(tp, tcache, torch.tensor(
        np.asarray(outs["ref"][2])), torch.as_tensor(pos), device="cpu")
    for i, got in ((0, tlogits), (3, tdec)):
        assert _dist(got, outs["truth"][i]) <= 2 * _dist(outs["ref"][i],
                                                         outs["truth"][i])

    # the train step
    jnew, jm = _jstep(jarch, start, batch)
    j32, _ = _jstep(jarch32, start32, batch)
    tnew, tm = make_train_step(tarch, AdamWConfig(**OPT))[0](
        train_state_from_jax(start, device="cpu"), batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-3)
    g32 = _grad_vector(j32["opt"]["m"])
    gj, gt = _grad_vector(jnew["opt"]["m"]), _grad_vector(tnew["opt"]["m"])
    assert np.isfinite(gt).all()
    assert np.linalg.norm(gt - g32) <= 2 * np.linalg.norm(gj - g32)


# ---------------------------------------------------------------------------
# (f) whisper's first gradient norm by depth, from two draws
# ---------------------------------------------------------------------------

# whisper-large-v3's attention geometry (head_dim 64, d_model / heads =
# 64) at a fifth of its width: the reference's init draws wq/wk/wv at the
# fan-in of their heads axis and wo at that of its head dim, 8x the scale
# of a (d_model, heads x head_dim) projection, as at full width
WHISPER_NARROW = dict(d_model=320, n_heads=5, n_kv_heads=5, head_dim=64,
                      d_ff=1280)
WHISPER_DEPTHS = {"reference": (1, 2, 4), "fan_in_d_model": (1, 4)}
# rtol between the packages' norms: from the reference's draw the gap
# grows with the norm (2.8e-5, 2.2e-4, 6.2e-3 at 1, 2, 4 layers each side:
# saturated attention, as in (a)); from the rescaled draw it is 3e-6
NORM_RTOL = {"reference": 1e-2, "fan_in_d_model": 1e-5}


def _fan_in_d_model(params, d_model):
    """The attention projections of an encoder-decoder's numpy params
    rescaled to the fan-in of all their input axes (d_model; heads x
    head_dim for wo)."""
    for stack in ("enc_blocks", "dec_blocks"):
        for kind in ("attn", "xattn"):
            attn = params[stack].get(kind)
            if attn is None:
                continue
            for name in ("wq", "wk", "wv"):     # (L, d_model, heads, hd)
                attn[name] = attn[name] * np.float32(
                    (attn[name].shape[-2] / d_model) ** 0.5)
            attn["wo"] = attn["wo"] * np.float32(attn["wo"].shape[-3] ** -0.5)


@pytest.mark.parametrize("init", ["reference", "fan_in_d_model"])
def test_whisper_first_grad_norm_by_depth(init):
    """The first step's gradient norm (one microbatch, float32) of a
    narrow whisper (WHISPER_NARROW) cut to 1, 2 and 4 encoder and decoder
    layers, in both packages from the same draw.  From the reference's
    init it grows by more than 4x with each doubling of depth in both
    (8.2, 43, 460), which is what overflows float32 at 32 + 32 layers and
    full width; from the same draw at the full fan-in it stays within 2x
    of one layer's (8.2, 10.3).  The packages agree within NORM_RTOL."""
    norms = {}
    for depth in WHISPER_DEPTHS[init]:
        jarch, tarch = (dataclasses.replace(
            cfg, n_layers=depth, enc_dec=dataclasses.replace(
                cfg.enc_dec, n_enc_layers=depth), **WHISPER_NARROW)
            for cfg in _configs("whisper-large-v3"))
        start = _np(jinit(jarch, jax.random.PRNGKey(0), JAdamW(**OPT)))
        if init == "fan_in_d_model":
            _fan_in_d_model(start["params"], jarch.d_model)
        batch = _batch(jarch, B=2, S=16)
        _, jm = _jstep(jarch, start, batch)
        _, tm = make_train_step(tarch, AdamWConfig(**OPT))[0](
            train_state_from_jax(start, device="cpu"), batch)
        norms[depth] = float(tm["grad_norm"])
        np.testing.assert_allclose(norms[depth], float(jm["grad_norm"]),
                                   rtol=NORM_RTOL[init])
    if init == "reference":
        assert norms[2] > 4 * norms[1] and norms[4] > 4 * norms[2], norms
    else:
        assert norms[4] < 2 * norms[1], norms


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
