"""Parity of the port's LMs (repro_torch.configs, .parallel.axes, .models,
.launch.serve) with the JAX package on the CPU: the dense family, the
recurrent ones, ssm (RWKV6) and hybrid (Mamba2 + shared attention), and the
moe, vlm (cross-attention) and audio (encoder-decoder) families.

Configs and parameter trees are compared field for field and path for
path.  For the smoke-reduced mistral-nemo-12b, stablelm-1.6b, rwkv6-1.6b,
zamba2-1.2b, deepseek-moe-16b, qwen3-moe-235b-a22b, llama-3.2-vision-90b
and whisper-large-v3 (float32), the weights are the JAX package's own init
from ``jax.random.PRNGKey(0)``, carried across by
``convert.lm_params_from_jax``.
Each layer is held to 1e-5 of its output's scale: the largest difference is
at most 1e-5 times the largest reference value (the two packages sum the
float32 projections in different orders, so entries near zero differ by
more than 1e-5 of themselves).  The whole model (forward, prefill and its
cache, 8 greedy decode steps) is held to rtol 2e-4 / atol 2e-3, the
tolerance of tests/test_smoke_archs.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import get_model as jget_model
from repro.models import layers as JL
from repro.models import param_count as jparam_count
from repro.models.registry import active_param_count as jactive_count
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve
from repro_torch.models import (active_param_count, get_model,
                                layers as TL, param_count)
from repro_torch.parallel.axes import init_params, tree_leaves_with_path

CPU = "cpu"
DENSE = [a for a in tconfigs.ARCH_IDS
         if tconfigs.get_arch(a).family == "dense"]
PORTED = list(tconfigs.ARCH_IDS)
PARITY_ARCHS = ["mistral-nemo-12b", "stablelm-1.6b"]
RECURRENT = ["rwkv6-1.6b", "zamba2-1.2b"]
# the moe, vlm and audio families
ZOO = ["deepseek-moe-16b", "qwen3-moe-235b-a22b", "llama-3.2-vision-90b",
       "whisper-large-v3"]
# the leaf whose logical axes each family's test checks
AXES_LEAF = {"dense": (("blocks", "attn", "wq"),
                       ("layers", "embed", "heads", "head_dim")),
             "ssm": (("blocks", "tm", "bonus"),
                     ("layers", "heads", "head_dim")),
             "hybrid": (("shared", "attn", "wq"),
                        ("embed", "heads", "head_dim")),
             "moe": (("blocks", "moe", "wg"),
                     ("layers", "experts", "embed", "expert_ff")),
             "vlm": (("cross_blocks", "gate_attn"), ("layers", None)),
             "audio": (("dec_blocks", "xattn", "wk"),
                       ("layers", "embed", "kv_heads", "head_dim"))}
MODEL_TOL = dict(rtol=2e-4, atol=2e-3)
LAYER_TOL = 1e-5


def _as_dict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(jnp.dtype(cfg.dtype)) if not isinstance(
        cfg.dtype, torch.dtype) else str(cfg.dtype).removeprefix("torch.")
    return d


@pytest.mark.parametrize("arch_id", jconfigs.ARCH_IDS)
def test_arch_config_matches_reference(arch_id):
    j, t = jconfigs.get_arch(arch_id), tconfigs.get_arch(arch_id)
    assert _as_dict(t) == _as_dict(j)
    assert _as_dict(tconfigs.smoke_reduce(t)) \
        == _as_dict(jconfigs.smoke_reduce(j))
    for name, shape in jconfigs.SHAPES.items():
        assert dataclasses.asdict(tconfigs.SHAPES[name]) \
            == dataclasses.asdict(shape)
        assert tconfigs.cell_supported(t, tconfigs.SHAPES[name]) \
            == jconfigs.cell_supported(j, shape)


def test_arch_ids_and_dtypes():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    cfg = tconfigs.get_arch("mistral-nemo-12b")
    assert cfg.dtype is torch.bfloat16
    assert tconfigs.smoke_reduce(cfg).dtype is torch.float32


def test_param_count_mistral_nemo():
    cfg = tconfigs.get_arch("mistral-nemo-12b")
    assert param_count(cfg) == 12_247_782_400
    assert cfg.param_count() == jparam_count(jconfigs.get_arch(cfg.name))


@pytest.mark.parametrize("arch_id,count", [("rwkv6-1.6b", 1_599_672_320),
                                           ("zamba2-1.2b", 1_170_473_856)])
def test_param_count_recurrent(arch_id, count):
    cfg = tconfigs.get_arch(arch_id)
    assert param_count(cfg) == count == jparam_count(jconfigs.get_arch(arch_id))


@pytest.mark.parametrize("arch_id,count,active", [
    ("deepseek-moe-16b", 16_377_694_208, 2_830_616_576),
    ("qwen3-moe-235b-a22b", 235_093_610_496, 22_190_739_456),
    ("llama-3.2-vision-90b", 87_666_794_536, 87_666_794_536),
    ("whisper-large-v3", 1_601_198_080, 1_601_198_080)])
def test_param_count_zoo(arch_id, count, active):
    """Total and activated parameters (the MoE's top-k and shared experts
    only) equal the reference's."""
    cfg, jcfg = tconfigs.get_arch(arch_id), jconfigs.get_arch(arch_id)
    assert param_count(cfg) == count == jparam_count(jcfg)
    assert active_param_count(cfg) == active == jactive_count(jcfg)


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch_id", PORTED)
def test_param_tree_paths_and_shapes(arch_id, reduce):
    j, t = jconfigs.get_arch(arch_id), tconfigs.get_arch(arch_id)
    if reduce:
        j, t = jconfigs.smoke_reduce(j), tconfigs.smoke_reduce(t)
    want = {tuple(k.key for k in path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                jget_model(j).abstract_params())}
    got = {path: (tuple(leaf.shape), str(leaf.dtype).removeprefix("torch."))
           for path, leaf in tree_leaves_with_path(
               get_model(t).abstract_params())}
    assert got == want
    assert all(leaf.device.type == "meta" for _, leaf in
               tree_leaves_with_path(get_model(t).abstract_params()))
    # the logical axes stay on the definitions, as the reference's
    jdefs, tdefs = jget_model(j).param_defs(), get_model(t).param_defs()
    path, axes = AXES_LEAF[t.family]
    for key in path:
        jdefs, tdefs = jdefs[key], tdefs[key]
    assert tdefs.axes == jdefs.axes == axes


def test_unknown_family_raises():
    cfg = dataclasses.replace(
        tconfigs.smoke_reduce(tconfigs.get_arch("mistral-nemo-12b")),
        family="diffusion")
    with pytest.raises(ValueError, match="unknown family"):
        get_model(cfg)


def test_init_params_rules_and_seeding():
    cfg = tconfigs.smoke_reduce(tconfigs.get_arch("mistral-nemo-12b"))
    defs = get_model(cfg).param_defs()
    a = init_params(defs, 0, torch.float32, CPU)
    b = init_params(defs, 0, torch.float32, CPU)
    c = init_params(defs, 1, torch.float32, CPU)
    for (path, x), (_, y), (_, z) in zip(tree_leaves_with_path(a),
                                         tree_leaves_with_path(b),
                                         tree_leaves_with_path(c)):
        assert torch.equal(x, y), path
        if path[-1] != "scale":
            assert not torch.equal(x, z), path
    blocks = a["blocks"]
    assert torch.equal(blocks["ln1"]["scale"], torch.ones(4, 128))
    # scaled: scale / sqrt(shape[-2]); normal: 0.02
    wu = blocks["mlp"]["wu"]                                  # (4, 128, 256)
    assert abs(wu.std().item() - 128 ** -0.5) < 0.01
    assert not torch.equal(wu[0], wu[1])                      # per layer
    assert abs(a["embed"]["embedding"].std().item() - 0.02) < 0.002


# ---------------------------------------------------------------------------
# numerics against the JAX model, weights carried across
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=PARITY_ARCHS)
def pair(request):
    jcfg = jconfigs.smoke_reduce(jconfigs.get_arch(request.param))
    jmodel = jget_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                 device=CPU)
    cfg = tconfigs.smoke_reduce(tconfigs.get_arch(request.param))
    return jcfg, jmodel, jparams, cfg, get_model(cfg), tparams


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _layer_close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= LAYER_TOL * scale, (err, scale)


def _x(rs, *shape):
    a = rs.randn(*shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def test_layers_match_reference(pair):
    jcfg, _, jp, cfg, _, tp = pair
    jblk = jax.tree.map(lambda a: a[1], jp["blocks"])
    tblk = {k: {n: t[1] for n, t in v.items()} for k, v in tp["blocks"].items()}
    rs = np.random.RandomState(0)
    B, S, hd = 2, 12, cfg.resolved_head_dim
    jx, tx = _x(rs, B, S, cfg.d_model)
    _layer_close(TL.norm_apply(tblk["ln1"], tx),
                 jax.jit(JL.norm_apply)(jblk["ln1"], jx))
    jq, tq = _x(rs, B, S, cfg.n_heads, hd)
    pos = np.arange(S)[None].repeat(B, 0)
    _layer_close(TL.rope_apply(tq, torch.from_numpy(pos), cfg.rope_theta),
                 jax.jit(JL.rope_apply, static_argnums=2)(
                     jq, jnp.asarray(pos), jcfg.rope_theta))
    _layer_close(TL.mlp_apply(tblk["mlp"], tx), jax.jit(JL.mlp_apply)(jblk["mlp"], jx))
    # the LayerNorm and GELU variants (no dense config uses them) and the
    # tied LM head, on the same weights
    ln = {"scale": jblk["ln2"]["scale"], "bias": jblk["ln1"]["scale"] - 1.5}
    _layer_close(TL.norm_apply(lm_params_from_jax(ln, device=CPU), tx),
                 jax.jit(JL.norm_apply)(ln, jx))
    gelu = {k: jblk["mlp"][k] for k in ("wu", "wd")}
    _layer_close(TL.mlp_apply(lm_params_from_jax(gelu, device=CPU), tx),
                 jax.jit(JL.mlp_apply)(gelu, jx))
    tied = {"embedding": jp["embed"]["embedding"]}
    _layer_close(TL.lm_head_apply(lm_params_from_jax(tied, device=CPU), tx),
                 jax.jit(JL.lm_head_apply)(tied, jx))
    cache_len = S + 4
    ty, (tk, tv) = TL.attn_prefill(tblk["attn"], tx,
                                   positions=torch.from_numpy(pos),
                                   theta=cfg.rope_theta, cache_len=cache_len)
    jy, (jk, jv) = jax.jit(JL.attn_prefill,
                           static_argnames=("theta", "cache_len"))(
        jblk["attn"], jx, positions=jnp.asarray(pos), theta=jcfg.rope_theta,
        cache_len=cache_len)
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        _layer_close(got, want)
    # one decode step at ragged positions, into the prefilled caches
    jx1, tx1 = _x(rs, B, 1, cfg.d_model)
    p1 = np.array([S, S - 3], np.int32)
    ty1, (tk1, _) = TL.attn_decode(tblk["attn"], tx1, tk, tv,
                                   torch.from_numpy(p1), theta=cfg.rope_theta)
    jy1, (jk1, _) = jax.jit(JL.attn_decode, static_argnames=("theta",))(
        jblk["attn"], jx1, jk, jv, jnp.asarray(p1), theta=jcfg.rope_theta)
    _layer_close(ty1, jy1)
    _layer_close(tk1, jk1)
    assert tk1 is tk                               # updated in place


def test_model_matches_reference(pair):
    """apply, prefill and 8 greedy decode steps: logits within the smoke
    tolerance, greedy tokens equal."""
    _, jmodel, jp, cfg, model, tp = pair
    B, S, steps = 2, 16, 8
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (B, S + 1))
    apply = jax.jit(jmodel.apply)
    prefill = jax.jit(jmodel.prefill, static_argnames=("max_len",))
    decode = jax.jit(jmodel.decode)
    jl, _ = apply(jp, jnp.asarray(toks, jnp.int32))
    tl, aux = model.apply(tp, torch.from_numpy(toks), device=CPU)
    assert tl.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(_np(tl), _np(jl), **MODEL_TOL)

    jlog, jcache = prefill(jp, jnp.asarray(toks[:, :S], jnp.int32),
                           max_len=S + steps)
    tlog, tcache = model.prefill(tp, torch.from_numpy(toks[:, :S]),
                                 max_len=S + steps, device=CPU)
    np.testing.assert_allclose(_np(tlog), _np(jlog), **MODEL_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                   **MODEL_TOL)
    pos = np.full((B,), S, np.int32)
    for _ in range(steps):
        jtok = np.asarray(jnp.argmax(jlog, -1))[:, None]
        ttok = tlog.argmax(-1)[:, None]
        assert np.array_equal(ttok.numpy(), jtok)
        jlog, jcache = decode(jp, jcache, jnp.asarray(jtok, jnp.int32),
                              jnp.asarray(pos))
        tlog, tcache = model.decode(tp, tcache, ttok, pos, device=CPU)
        np.testing.assert_allclose(_np(tlog), _np(jlog), **MODEL_TOL)
        pos = pos + 1
    np.testing.assert_allclose(_np(tcache["k"]), _np(jcache["k"]),
                               **MODEL_TOL)


@pytest.mark.parametrize("arch_id", PORTED)
def test_decode_matches_prefill_tail(arch_id):
    """The port's own KV-cache path (its own seeded init): prefill S tokens,
    decode token S; the logits match a full forward's last position (as
    tests/test_smoke_archs.py holds the reference).  The vlm and audio
    models take seeded media, and the vlm cross blocks' zero-initialised
    gates are opened to 0.5 so that their attention counts."""
    cfg = tconfigs.smoke_reduce(tconfigs.get_arch(arch_id))
    model = get_model(cfg)
    params = model.init(0, device=CPU)
    if "cross_blocks" in params:
        for gate in ("gate_attn", "gate_mlp"):
            params["cross_blocks"][gate].fill_(0.5)
    B, S = 2, 16
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen)
    ms = model.media_struct(B)
    media = None if ms is None else 0.02 * torch.randn(ms.shape,
                                                       generator=gen)
    want, _ = model.apply(params, tokens, media=media, device=CPU)
    _, cache = model.prefill(params, tokens[:, :S], media=media,
                             max_len=S + 1, device=CPU)
    got, _ = model.decode(params, cache, tokens[:, S:], torch.full((B,), S),
                          device=CPU)
    np.testing.assert_allclose(_np(got), _np(want[:, -1]), **MODEL_TOL)


def test_serve_main_on_cpu(capsys):
    res = serve.main(["--arch", "mistral-nemo-12b", "--batch", "2",
                      "--prompt-len", "8", "--tokens", "5", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    assert lines[0].startswith("[serve] mistral-nemo-12b-smoke: prefill 2x8 "
                               "in ")
    assert "decoded 10 tokens in" in lines[0]
    assert lines[1].startswith("[serve] sample: [")
    assert res["tokens"].shape == (2, 5)
    assert res["cache"]["k"].shape == (4, 2, 13, 2, 32)


def test_generate_is_greedy_decode():
    """generate's tokens are the argmax chain of prefill + decode."""
    cfg = tconfigs.smoke_reduce(tconfigs.get_arch("stablelm-1.6b"))
    model = get_model(cfg)
    params = model.init(3, device=CPU)
    prompt = serve.prompts(2, 6, cfg.vocab_size, CPU)
    res = serve.generate(model, params, prompt, 4, device=CPU,
                         keep_logits=True)
    assert res["logits"].shape == (4, 2, cfg.vocab_size)
    assert np.array_equal(res["tokens"], res["logits"].argmax(-1).T.numpy())
    logits, cache = model.prefill(params, prompt, max_len=10, device=CPU)
    assert torch.equal(logits, res["logits"][0])


# ---------------------------------------------------------------------------
# the recurrent families against the JAX model, weights carried across
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=RECURRENT)
def rpair(request):
    jcfg = jconfigs.smoke_reduce(jconfigs.get_arch(request.param))
    jparams = jget_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                 device=CPU)
    cfg = tconfigs.smoke_reduce(tconfigs.get_arch(request.param))
    return jcfg, jparams, cfg, tparams


def _perturbed(blk, rs):
    """Layer 1's parameters with every zero- or one-initialised leaf moved
    off its constant (bonus, mu, decay0, a_log, dt_bias, conv_b, d_skip,
    norms), so each term of the layer is exercised: numpy leaves for JAX,
    tensors for the port."""
    def move(a):
        a = np.asarray(a, np.float32)
        if np.all(a == a.flat[0]):
            a = a + (0.3 * rs.randn(*a.shape)).astype(np.float32)
        return a
    jblk = jax.tree.map(lambda a: move(np.asarray(a)[1]), blk)
    return jblk, lm_params_from_jax(jblk, device=CPU)


def test_recurrent_layers_match_reference(rpair):
    """group_norm_apply and the family's layer functions, from random inputs
    and states, each within 1e-5 of its output's scale."""
    jcfg, jp, cfg, _ = rpair
    rs = np.random.RandomState(3)
    jblk, tblk = _perturbed(jp["blocks"], rs)
    B, S, D = 2, 12, cfg.d_model
    jx, tx = _x(rs, B, S, D)
    jrow, trow = _x(rs, B, D)
    if cfg.family == "ssm":
        H, Dh = TL.rwkv_heads(cfg), cfg.ssm.head_dim
        _layer_close(TL.group_norm_apply(tblk["tm"]["ln_x"], tx, H),
                     JL.group_norm_apply(jblk["tm"]["ln_x"], jx, H))
        jprev, tprev = _x(rs, B, S, D)
        for got, want in zip(TL._rwkv6_projections(tblk, tx, tprev, cfg),
                             JL._rwkv6_projections(jblk, jx, jprev, jcfg)):
            _layer_close(got, want)
        js0, ts0 = _x(rs, B, H, Dh, Dh)
        ty, (tlast, tst) = TL.rwkv6_time_mix(tblk, tx, trow, ts0, cfg)
        jy, (jlast, jst) = JL.rwkv6_time_mix(jblk, jx, jrow, js0, jcfg)
        for got, want in ((ty, jy), (tlast, jlast), (tst, jst)):
            _layer_close(got, want)
        ty, tlast = TL.rwkv6_channel_mix(tblk, tx, trow)
        jy, jlast = JL.rwkv6_channel_mix(jblk, jx, jrow)
        _layer_close(ty, jy)
        _layer_close(tlast, jlast)
    else:
        s = cfg.ssm
        d_inner = s.expand * D
        H = d_inner // s.head_dim
        jg, tg = _x(rs, B, S, d_inner)
        _layer_close(TL.group_norm_apply(tblk["mamba"]["norm"], tg, H),
                     JL.group_norm_apply(jblk["mamba"]["norm"], jg, H))
        jc, tc = _x(rs, B, s.conv_width - 1, d_inner + 2 * s.state_dim)
        js0, ts0 = _x(rs, B, H, s.head_dim, s.state_dim)
        ty, (tconv, tssd) = TL.mamba2_apply(tblk["mamba"], tx, tc, ts0, cfg)
        jy, (jconv, jssd) = JL.mamba2_apply(jblk["mamba"], jx, jc, js0, jcfg)
        for got, want in ((ty, jy), (tconv, jconv), (tssd, jssd)):
            _layer_close(got, want)


def test_recurrent_model_matches_reference(rpair):
    """apply, prefill with its whole cache and 8 greedy decode steps (the
    cache after them too): within the smoke tolerance, greedy tokens
    equal."""
    jcfg, jp, cfg, tp = rpair
    jmodel, model = jget_model(jcfg), get_model(cfg)
    B, S, steps = 2, 16, 8
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (B, S + 1))
    jl, _ = jax.jit(jmodel.apply)(jp, jnp.asarray(toks, jnp.int32))
    tl, _ = model.apply(tp, torch.from_numpy(toks), device=CPU)
    np.testing.assert_allclose(_np(tl), _np(jl), **MODEL_TOL)
    _greedy_parity(jmodel, jp, model, tp, toks[:, :S], S + steps, steps)


def _greedy_parity(jmodel, jp, model, tp, prompt, max_len, steps,
                   media=None):
    B, S = prompt.shape
    jmedia, tmedia = (None, None) if media is None else \
        (jnp.asarray(media), torch.from_numpy(media))
    jlog, jcache = jax.jit(jmodel.prefill, static_argnames=("max_len",))(
        jp, jnp.asarray(prompt, jnp.int32), media=jmedia, max_len=max_len)
    tlog, tcache = model.prefill(tp, torch.from_numpy(prompt), media=tmedia,
                                 max_len=max_len, device=CPU)
    np.testing.assert_allclose(_np(tlog), _np(jlog), **MODEL_TOL)
    assert set(tcache) == set(jcache)
    for name in jcache:
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                   **MODEL_TOL, err_msg=name)
    decode = jax.jit(jmodel.decode)
    pos = np.full((B,), S, np.int32)
    for _ in range(steps):
        jtok = np.asarray(jnp.argmax(jlog, -1))[:, None]
        ttok = tlog.argmax(-1)[:, None]
        assert np.array_equal(ttok.numpy(), jtok)
        jlog, jcache = decode(jp, jcache, jnp.asarray(jtok, jnp.int32),
                              jnp.asarray(pos))
        tlog, tcache = model.decode(tp, tcache, ttok, pos, device=CPU)
        np.testing.assert_allclose(_np(tlog), _np(jlog), **MODEL_TOL)
        pos = pos + 1
    for name in jcache:
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                   **MODEL_TOL, err_msg=name)


def test_hybrid_window_wraps_like_reference():
    """zamba2 with an 8-token window: prefill keeps the trailing window of
    the 16 prompt rows, and 8 decode steps write slots pos % 8, wrapping
    round the window cache, with kv_len = min(pos + 1, 8)."""
    arch = "zamba2-1.2b"
    jcfg = dataclasses.replace(jconfigs.smoke_reduce(
        jconfigs.get_arch(arch)), sliding_window=8)
    cfg = dataclasses.replace(tconfigs.smoke_reduce(tconfigs.get_arch(arch)),
                              sliding_window=8)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(1))
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), device=CPU)
    prompt = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, 16))
    _greedy_parity(jget_model(jcfg), jp, get_model(cfg), tp, prompt, 16, 8)


@pytest.mark.parametrize("arch_id", RECURRENT)
def test_serve_main_on_cpu_recurrent(arch_id, capsys):
    res = serve.main(["--arch", arch_id, "--batch", "2", "--prompt-len", "8",
                      "--tokens", "5", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    assert lines[0].startswith(f"[serve] {arch_id}-smoke: prefill 2x8 in ")
    assert "decoded 10 tokens in" in lines[0]
    assert lines[1].startswith("[serve] sample: [")
    assert res["tokens"].shape == (2, 5)


# ---------------------------------------------------------------------------
# the moe, vlm and audio families against the JAX model, weights carried
# across
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ZOO)
def zpair(request):
    """The smoke config's JAX init, with the vlm cross blocks' gates
    opened (they start at zero and tanh(0) = 0, which would keep the cross
    attention and its MLP out of the logits), and seeded media for the vlm
    and audio models (random, so that the keys differ)."""
    jcfg = jconfigs.smoke_reduce(jconfigs.get_arch(request.param))
    jmodel = jget_model(jcfg)
    jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(4)
    if "cross_blocks" in jparams:
        for gate in ("gate_attn", "gate_mlp"):
            shape = jparams["cross_blocks"][gate].shape
            jparams["cross_blocks"][gate] = rs.uniform(
                0.3, 0.8, shape).astype(np.float32)
    ms = jmodel.media_struct(2)
    media = None if ms is None else \
        (0.02 * rs.randn(*ms.shape)).astype(np.float32)
    cfg = tconfigs.smoke_reduce(tconfigs.get_arch(request.param))
    return jcfg, jparams, cfg, lm_params_from_jax(jparams, device=CPU), media


def test_zoo_model_matches_reference(zpair):
    """apply (logits and the MoE aux loss), prefill with its whole cache
    (the cross-attention keys and values included) and 8 greedy decode
    steps: within the smoke tolerance, greedy tokens equal."""
    jcfg, jp, cfg, tp, media = zpair
    jmodel, model = jget_model(jcfg), get_model(cfg)
    B, S, steps = 2, 16, 8
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (B, S + 1))
    jmedia = None if media is None else jnp.asarray(media)
    tmedia = None if media is None else torch.from_numpy(media)
    jl, jaux = jax.jit(jmodel.apply)(jp, jnp.asarray(toks, jnp.int32),
                                     media=jmedia)
    tl, taux = model.apply(tp, torch.from_numpy(toks), media=tmedia,
                           device=CPU)
    np.testing.assert_allclose(_np(tl), _np(jl), **MODEL_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **MODEL_TOL)
    assert (float(taux) > 0) == (cfg.family == "moe")
    _greedy_parity(jmodel, jp, model, tp, toks[:, :S], S + steps, steps,
                   media)


@pytest.mark.parametrize("arch_id", ZOO)
def test_serve_main_on_cpu_zoo(arch_id, capsys):
    """serve.main for the moe, vlm and audio families, the latter two with
    the reference's stub media."""
    res = serve.main(["--arch", arch_id, "--batch", "2", "--prompt-len", "8",
                      "--tokens", "5", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    assert lines[0].startswith(f"[serve] {arch_id}-smoke: prefill 2x8 in ")
    assert "decoded 10 tokens in" in lines[0]
    assert res["tokens"].shape == (2, 5)
    cfg = tconfigs.smoke_reduce(tconfigs.get_arch(arch_id))
    assert ("xk" in res["cache"]) == (cfg.family in ("vlm", "audio"))


@pytest.mark.parametrize("arch_id", ZOO)
def test_train_step_trains_the_zoo(arch_id):
    """make_train_step trains the moe, vlm and audio families too: its
    loss and aux loss are train_loss's at the state it was given (seeded
    media for vlm and audio), and the step moves the parameters.  Parity
    with the reference's step is tests/test_torch_train.py's."""
    from repro_torch.models.steps import (init_train_state, make_train_step,
                                          train_loss)
    from repro_torch.optim import AdamWConfig
    cfg = tconfigs.smoke_reduce(tconfigs.get_arch(arch_id))
    opt = AdamWConfig(warmup_steps=1, total_steps=2)
    state = init_train_state(cfg, 0, opt, device=CPU)
    gen = torch.Generator().manual_seed(9)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    ms = get_model(cfg).media_struct(2)
    media = None if ms is None else 0.02 * torch.randn(ms.shape,
                                                       generator=gen)
    batch = {"tokens": tokens} if media is None else {"tokens": tokens,
                                                      "media": media}
    new, m = make_train_step(cfg, opt)[0](state, batch)
    with torch.no_grad():
        loss, aux = train_loss(cfg, state["params"], tokens, media=media)
    assert float(m["loss"]) == float(loss)
    assert float(m["aux_loss"]) == float(aux)
    assert (float(aux) > 0) == (cfg.family == "moe")
    assert int(new["step"]) == 1
    emb = (new["params"]["embed"]["embedding"],
           state["params"]["embed"]["embedding"])
    assert not torch.equal(*emb)
