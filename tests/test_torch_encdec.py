"""Parity of the port's cross-attention and encoder-decoder pieces with the
JAX package on the CPU: attention with ``kv_x`` (more and fewer keys than
queries), prefill without RoPE, decode against a static cross cache
(``cross_kv``) and without RoPE (repro_torch.models.layers); Whisper's
sinusoid, encoder and decoder block (repro_torch.models.encdec); the vlm
cross block with its tanh gates (repro_torch.models.lm).

Weights are the smoke-reduced whisper-large-v3's and
llama-3.2-vision-90b's JAX init carried across with
``convert.lm_params_from_jax``, the vlm gates opened from their zero init;
inputs come from numpy seeds.  Each output is held to 1e-5 of the
reference output's largest value.  The whole models are held in
tests/test_torch_lm.py (test_zoo_model_matches_reference)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, smoke_reduce as jsmoke
from repro.models import encdec as JE
from repro.models import get_model as jget_model
from repro.models import layers as JL
from repro.models import lm as JLM
from repro_torch.configs import get_arch, smoke_reduce
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM

LAYER_TOL = 1e-5
CPU = "cpu"


@pytest.fixture(scope="module")
def whisper():
    jcfg = jsmoke(jget_arch("whisper-large-v3"))
    jp = jax.tree.map(np.asarray, jget_model(jcfg).init(jax.random.PRNGKey(0)))
    return jcfg, jp, smoke_reduce(get_arch("whisper-large-v3")), \
        lm_params_from_jax(jp, device=CPU)


def _layer(tree, i=1):
    """Layer i of a stacked tree: numpy leaves for JAX, tensors for the
    port."""
    jblk = jax.tree.map(lambda a: np.asarray(a)[i], tree)
    return jblk, lm_params_from_jax(jblk, device=CPU)


def _x(rs, *shape):
    a = rs.randn(*shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= LAYER_TOL * scale, (err, scale)


@pytest.mark.parametrize("S,M", [(12, 24), (24, 5), (7, 7)],
                         ids=["fewer_queries", "fewer_keys", "equal"])
def test_cross_attention_matches_reference(whisper, S, M):
    """attn_apply with kv_x: keys and values from the media, never causal,
    no RoPE on either side; M < S is the flash launcher's Skv < S."""
    _, jp, cfg, _ = whisper
    jblk, tblk = _layer(jp["dec_blocks"])
    rs = np.random.RandomState(0)
    jx, tx = _x(rs, 2, S, cfg.d_model)
    jm, tm = _x(rs, 2, M, cfg.d_model)
    pos = np.arange(S)[None].repeat(2, 0)
    for positions, use_rope in ((None, False), (pos, True)):
        want = JL.attn_apply(jblk["xattn"], jx, positions=None if positions
                             is None else jnp.asarray(positions),
                             causal=False, kv_x=jm, use_rope=use_rope)
        got = TL.attn_apply(tblk["xattn"], tx, positions=None if positions
                            is None else torch.from_numpy(positions),
                            causal=False, kv_x=tm, use_rope=use_rope)
        _close(got, want)


def test_prefill_and_decode_without_rope_match_reference(whisper):
    """attn_prefill(use_rope=False) and its cache, then one decode step with
    use_rope=False written in place at ragged positions, and one decode
    step against a static cross cache (cross_kv), which leaves the self
    cache as it was."""
    _, jp, cfg, _ = whisper
    jblk, tblk = _layer(jp["dec_blocks"])
    rs = np.random.RandomState(1)
    B, S, M = 2, 10, 24
    jx, tx = _x(rs, B, S, cfg.d_model)
    ty, (tk, tv) = TL.attn_prefill(tblk["attn"], tx, positions=None,
                                   theta=0.0, cache_len=S + 3, use_rope=False)
    jy, (jk, jv) = JL.attn_prefill(jblk["attn"], jx, positions=None,
                                   theta=0.0, cache_len=S + 3, use_rope=False)
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        _close(got, want)
    jx1, tx1 = _x(rs, B, 1, cfg.d_model)
    p1 = np.array([S, S - 4], np.int32)
    ty1, (tk1, _) = TL.attn_decode(tblk["attn"], tx1, tk, tv,
                                   torch.from_numpy(p1), theta=0.0,
                                   use_rope=False)
    jy1, (jk1, _) = JL.attn_decode(jblk["attn"], jx1, jk, jv, jnp.asarray(p1),
                                   theta=0.0, use_rope=False)
    _close(ty1, jy1)
    _close(tk1, jk1)
    assert tk1 is tk
    jck, tck = _x(rs, B, M, cfg.n_kv_heads, cfg.resolved_head_dim)
    jcv, tcv = _x(rs, B, M, cfg.n_kv_heads, cfg.resolved_head_dim)
    before = tk.clone()
    ty2, (tk2, tv2) = TL.attn_decode(tblk["xattn"], tx1, tk, tv,
                                     torch.from_numpy(p1), theta=0.0,
                                     cross_kv=(tck, tcv))
    jy2, _ = JL.attn_decode(jblk["xattn"], jx1, jk, jv, jnp.asarray(p1),
                            theta=0.0, cross_kv=(jck, jcv))
    _close(ty2, jy2)
    assert tk2 is tk and tv2 is tv and torch.equal(tk, before)


def _angle_tol(S):
    """sin and cos of float32 angles up to S radians: one rounding of the
    angle (and of its frequency) moves them by up to S * 2^-23 each."""
    return 1e-6 + 2 * S * 2.0 ** -23


def test_sinusoid_matches_reference():
    """The encoder's and the prompt's positions, and decode's per-row
    positions, each in float32 as the reference computes them."""
    for S, D in ((24, 128), (1500, 1280)):
        got = TE._sinusoid_at(torch.arange(S), D)
        np.testing.assert_allclose(got.numpy(), np.asarray(JE._sinusoid(S, D)),
                                   rtol=0, atol=_angle_tol(S))
    pos = torch.tensor([3, 17, 440], dtype=torch.int32)
    full = np.asarray(JE._sinusoid(441, 1280))
    np.testing.assert_allclose(TE._sinusoid_at(pos, 1280).numpy(),
                               full[[3, 17, 440]], rtol=0,
                               atol=_angle_tol(441))


def test_encoder_matches_reference(whisper):
    """encode: the sinusoid, two non-causal blocks and the final
    LayerNorm, on random frames (the LayerNorm biases moved off zero).  A
    stack, held as the whole models are (rtol 2e-4 / atol 2e-3): the
    final LayerNorm divides the residual stream (about 50 at its largest
    here) down to unit scale, and its rounding with it."""
    jcfg, jp, cfg, _ = whisper
    rs = np.random.RandomState(2)
    jp = {**jp, "enc_blocks": jax.tree.map(
        lambda a: a + (0.1 * rs.randn(*a.shape)).astype(np.float32)
        if np.all(a == 0) else a, jp["enc_blocks"])}
    tp = lm_params_from_jax(jp, device=CPU)
    jf, tf = _x(rs, 2, cfg.enc_dec.n_frames, cfg.d_model)
    np.testing.assert_allclose(TE.encode(tp, cfg, tf).numpy(),
                               np.asarray(JE.encode(jp, jcfg, jf)),
                               rtol=2e-4, atol=2e-3)


def test_decoder_block_matches_reference(whisper):
    """One decoder block of the full-sequence path: causal self-attention
    without RoPE, cross-attention to the encoder output, the GELU MLP."""
    jcfg, jp, cfg, _ = whisper
    jblk, tblk = _layer(jp["dec_blocks"])
    rs = np.random.RandomState(3)
    jx, tx = _x(rs, 2, 9, cfg.d_model)
    je, te = _x(rs, 2, cfg.enc_dec.n_frames, cfg.d_model)
    want = JE._dec_block(jcfg, jblk, jx, je, jnp.arange(9)[None], JL.NO_SHARD)
    h = TL.attn_apply(tblk["attn"], TL.norm_apply(tblk["ln1"], tx),
                      causal=True, use_rope=False)
    got = TE._mlp(tblk, TE._cross(tblk, tx + h, te, TL.NO_SHARD),
                  TL.NO_SHARD)
    _close(got, want)


def test_vlm_cross_block_matches_reference():
    """The vlm cross block: gated cross-attention and gated MLP, gates
    opened to seeded values (zero-initialised, they would hide both)."""
    jcfg = jsmoke(jget_arch("llama-3.2-vision-90b"))
    jp = jax.tree.map(np.asarray, jget_model(jcfg).init(jax.random.PRNGKey(0)))
    cfg = smoke_reduce(get_arch("llama-3.2-vision-90b"))
    rs = np.random.RandomState(5)
    jblk = jax.tree.map(lambda a: np.asarray(a)[0], jp["cross_blocks"])
    jblk["gate_attn"] = rs.uniform(0.3, 0.8, (1,)).astype(np.float32)
    jblk["gate_mlp"] = rs.uniform(-0.8, -0.3, (1,)).astype(np.float32)
    tblk = lm_params_from_jax(jblk, device=CPU)
    jx, tx = _x(rs, 2, 11, cfg.d_model)
    jm, tm = _x(rs, 2, cfg.cross_attn.n_media_tokens, cfg.d_model)
    want = JLM._cross_block_apply(jcfg, jblk, jx, 0.02 * jm, JL.NO_SHARD)
    got = TLM._cross_block_apply(cfg, tblk, tx, 0.02 * tm, TL.NO_SHARD)
    _close(got, want)
    shut = {**tblk, "gate_attn": torch.zeros(1), "gate_mlp": torch.zeros(1)}
    assert torch.equal(TLM._cross_block_apply(cfg, shut, tx, tm, TL.NO_SHARD),
                       tx)


def test_media_device_and_presence_are_checked(whisper):
    """Media on another device than the parameters raises, as does a vlm or
    audio call without media."""
    _, _, cfg, tp = whisper
    from repro_torch.models import get_model
    model = get_model(cfg)
    toks = torch.zeros((2, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="needs media"):
        model.prefill(tp, toks, device=CPU)
    media = torch.empty(model.media_struct(2).shape, device="meta")
    with pytest.raises(ValueError, match="media is on meta"):
        model.apply(tp, toks, media=media, device=CPU)
