"""Head dim 160 (stablelm-12b: 5120 / 32) in the port, on the CPU: the
smoke-reduced stablelm-12b with its head dim put back against the JAX
package's model, the reference's Pallas attention kernels in interpret mode
at D = 160 against the port's plain versions, and the launchers' checks on
``meta`` (the dry run's path), where D = 160 is now taken and any head
dim outside (32, 64, 128, 160) is still refused.

Inputs are drawn with numpy from a seed and handed to both packages; the
weights are the JAX package's init from ``jax.random.PRNGKey(0)``, carried
across by ``convert.lm_params_from_jax``.  Tolerances are the ones
tests/test_torch_attention.py and tests/test_torch_lm.py state: 2e-3 in
float32 and 2e-2 in bf16 for a kernel; rtol 2e-4 / atol 2e-3 for the
model."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.kernels.decode_attention import decode_attention as jdecode
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import get_model as jget_model
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import attention, ops
from repro_torch.launch import cost, dryrun
from repro_torch.models import get_model

ARCH = "stablelm-12b"
HEAD_DIM = 160
MODEL_TOL = dict(rtol=2e-4, atol=2e-3)       # tests/test_torch_lm.py
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bf16" \
        else dict(rtol=2e-3, atol=2e-3)


def _inputs(seed, dtype, *shapes):
    rs = np.random.RandomState(seed)
    jd, td = DTYPES[dtype]
    arrs = [rs.randn(*s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.detach().float().numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got, np.float32),
        np.asarray(want, np.float32), **tol)


def _reduced(configs):
    """The smoke config of stablelm-12b (4 heads on 2 kv heads) at 2
    layers with its own head dim, 160, put back."""
    return dataclasses.replace(configs.smoke_reduce(configs.get_arch(ARCH)),
                               n_layers=2, head_dim=HEAD_DIM)


# ------------------------------------------------------------------ model

@pytest.fixture(scope="module")
def pair():
    jcfg = _reduced(jconfigs)
    jmodel = jget_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = _reduced(tconfigs)
    tparams = lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                 device="cpu")
    return jmodel, jparams, cfg, get_model(cfg), tparams


def test_reduced_config_keeps_head_dim_160(pair):
    _, _, cfg, _, tp = pair
    assert cfg.resolved_head_dim == HEAD_DIM
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.n_layers) == (4, 2, 2)
    # the query projection is d_model -> heads x 160 in both packages
    assert tuple(tp["blocks"]["attn"]["wq"].shape)[-2:] == (4, HEAD_DIM)


def test_model_matches_reference_at_head_dim_160(pair):
    """apply, prefill (and its cache) and 8 greedy decode steps within the
    model tolerance of the JAX package's, greedy tokens equal."""
    jmodel, jp, cfg, model, tp = pair
    B, S, steps = 2, 16, 8
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (B, S + 1))
    jl, _ = jax.jit(jmodel.apply)(jp, jnp.asarray(toks, jnp.int32))
    tl, _ = model.apply(tp, torch.from_numpy(toks), device="cpu")
    _close(tl, jl, MODEL_TOL)
    jlog, jcache = jax.jit(jmodel.prefill, static_argnames=("max_len",))(
        jp, jnp.asarray(toks[:, :S], jnp.int32), max_len=S + steps)
    tlog, tcache = model.prefill(tp, torch.from_numpy(toks[:, :S]),
                                 max_len=S + steps, device="cpu")
    _close(tlog, jlog, MODEL_TOL)
    assert tcache["k"].shape[-1] == HEAD_DIM
    for name in ("k", "v"):
        _close(tcache[name], jcache[name], MODEL_TOL)
    decode = jax.jit(jmodel.decode)
    pos = np.full((B,), S, np.int32)
    for _ in range(steps):
        jtok = np.asarray(jnp.argmax(jlog, -1))[:, None]
        ttok = tlog.argmax(-1)[:, None]
        assert np.array_equal(ttok.numpy(), jtok)
        jlog, jcache = decode(jp, jcache, jnp.asarray(jtok, jnp.int32),
                              jnp.asarray(pos))
        tlog, tcache = model.decode(tp, tcache, ttok, pos, device="cpu")
        _close(tlog, jlog, MODEL_TOL)
        pos = pos + 1
    _close(tcache["k"], jcache["k"], MODEL_TOL)


# ---------------------------------------------- the reference's kernels

B, S, H, HKV = 1, 64, 4, 2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 24)])
def test_flash_pallas_interpret_at_d160(dtype, causal, window):
    (jq, jk, jv), (q, k, v) = _inputs(160, dtype, (B, S, H, HEAD_DIM),
                                      (B, S, HKV, HEAD_DIM),
                                      (B, S, HKV, HEAD_DIM))
    want = jflash(jq, jk, jv, causal=causal, window=window, q_block=32,
                  kv_block=32, interpret=True)
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              impl="torch")
    assert got.dtype == q.dtype and got.shape == (B, S, H, HEAD_DIM)
    _close(got, want, _tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [0, 24])
def test_decode_pallas_interpret_at_d160(dtype, window):
    (jq, jk, jv), (q, k, v) = _inputs(161, dtype, (B, 1, H, HEAD_DIM),
                                      (B, S, HKV, HEAD_DIM),
                                      (B, S, HKV, HEAD_DIM))
    lens = np.array([45], np.int32)
    want = jdecode(jq, jk, jv, jnp.asarray(lens), window=window, kv_block=32,
                   interpret=True)
    got = ops.decode_attention(q, k, v, torch.from_numpy(lens),
                               window=window, impl="torch")
    assert got.dtype == q.dtype and got.shape == (B, 1, H, HEAD_DIM)
    _close(got, want, _tol(dtype))


# -------------------------------------------- the launchers on meta

def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launchers_take_d160_on_meta(dtype):
    """stablelm-12b's prefill and decode shapes: both launchers check and
    allocate, nothing launches, nothing is refused."""
    q, kv = _meta(4, 1024, 32, 160, dtype=dtype), \
        _meta(4, 1024, 8, 160, dtype=dtype)
    assert attention.flash_attention(q, kv, kv).shape == q.shape
    q1, cache = _meta(4, 1, 32, 160, dtype=dtype), \
        _meta(4, 1088, 8, 160, dtype=dtype)
    n = _meta(4, dtype=torch.int32)
    assert attention.decode_attention(q1, cache, cache, n).shape == q1.shape
    before = ops.launch_counts()
    got = cost.count(lambda *a: (ops.flash_attention(*a[:3]),
                                 ops.decode_attention(*a[3:])),
                     q, kv, kv, q1, cache, cache, n)
    for k in ("flash_attention", "decode_attention"):
        rec = got["kernels"][k]
        assert rec["launches"] == 1 and not rec["refused"], (k, rec)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("D", [16, 48, 96, 192, 256])
def test_launchers_refuse_other_head_dims(D):
    q, kv = _meta(1, 8, 4, D), _meta(1, 8, 2, D)
    with pytest.raises(ValueError, match="head_dim must be one of "
                       r"\(32, 64, 128, 160\)"):
        attention.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="head_dim"):
        attention.decode_attention(q[:, :1], kv, kv,
                                   _meta(1, dtype=torch.int32))


def test_stablelm12b_cell_traces_ok(tmp_path):
    """A stablelm-12b dry-run cell at its published widths: ok, its
    attention launches counted with no refusal."""
    rec = dryrun.run_cell(ARCH, "prefill_32k", out_dir=tmp_path,
                          verbose=False)
    assert rec["status"] == "ok" and "refused" not in rec, rec
    flash = rec["cost"]["kernels"]["flash_attention"]
    assert flash["launches"] == 40 and not flash["refused"]
