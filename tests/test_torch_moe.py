"""Parity of the port's Mixture of Experts (repro_torch.models.layers:
moe_defs, moe_capacity, moe_route, moe_apply) with the JAX package's on the
CPU, on tests/test_moe.py's cases: tight capacity with drops against
generous capacity, dropless, permutation invariance, one group against
two, the shared expert, chunked dispatch and the aux loss; and router ties,
which ``jax.lax.top_k`` breaks toward the lower expert id.

Weights are the JAX package's init carried across with
``convert.lm_params_from_jax``; inputs come from numpy seeds.  Outputs and
the aux loss are held to 1e-5 of the reference output's largest value (the
two packages sum float32 products in different orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, smoke_reduce as jsmoke
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import layers as JL
from repro.parallel.axes import init_params as jinit
from repro_torch.configs import get_arch, smoke_reduce
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import layers as TL

LAYER_TOL = 1e-5
# name: (MoEConfig fields, dropless, n_groups, x shape (B, S))
CASES = {
    "tight": (dict(capacity_factor=0.126), False, 1, (1, 64)),
    "loose": (dict(capacity_factor=8.0), False, 1, (1, 64)),
    "capacity_1": (dict(capacity_factor=1.0), False, 1, (2, 16)),
    "dropless": (dict(capacity_factor=0.126), True, 1, (2, 16)),
    "groups_2": (dict(capacity_factor=1.0), False, 2, (2, 16)),
    "groups_3_ragged": (dict(capacity_factor=1.25), False, 3, (1, 20)),
    "shared": (dict(capacity_factor=0.01, n_shared_experts=1), False, 1,
               (1, 32)),
    "chunked": (dict(capacity_factor=1.0, chunk_tokens=10), False, 1,
                (2, 20)),
    "chunked_groups": (dict(capacity_factor=1.0, chunk_tokens=6), False, 2,
                       (2, 12)),
    "top_1": (dict(capacity_factor=1.0, top_k=1), False, 1, (2, 16)),
    "top_4": (dict(capacity_factor=2.0, top_k=4), False, 1, (2, 16)),
}


def _cfgs(d_model=32, **moe):
    """tests/test_moe.py's config: the smoke deepseek-moe-16b at
    d_model 32 with 8 experts of width 16, top 2, no dense first layer."""
    kw = dict(n_experts=8, top_k=2, expert_ff=16, n_shared_experts=0,
              capacity_factor=1.0, first_dense=0)
    kw.update(moe)
    j = dataclasses.replace(jsmoke(jget_arch("deepseek-moe-16b")),
                            d_model=d_model, moe=JMoEConfig(**kw))
    t = dataclasses.replace(smoke_reduce(get_arch("deepseek-moe-16b")),
                            d_model=d_model, moe=MoEConfig(**kw))
    return j, t


def _params(jcfg, key=0):
    jp = jax.tree.map(np.asarray, jinit(JL.moe_defs(jcfg),
                                        jax.random.PRNGKey(key), jnp.float32))
    return jp, lm_params_from_jax(jp, device="cpu")


def _run(jcfg, tcfg, jp, tp, x, dropless=False, n_groups=1):
    jy, jaux = JL.moe_apply(jp, jnp.asarray(x), jcfg,
                            JL.ShardCtx(n_groups=n_groups), dropless=dropless)
    ty, taux = TL.moe_apply(tp, torch.from_numpy(x), tcfg,
                            TL.ShardCtx(n_groups=n_groups), dropless=dropless)
    return (np.asarray(jy), float(jaux)), (ty.numpy(), float(taux))


def _close(got, want):
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= LAYER_TOL * scale, (err, scale)


@pytest.mark.parametrize("case", CASES)
def test_moe_apply_matches_reference(case):
    moe, dropless, groups, (B, S) = CASES[case]
    jcfg, tcfg = _cfgs(**moe)
    jp, tp = _params(jcfg)
    x = np.random.RandomState(1).randn(B, S, 32).astype(np.float32)
    (jy, jaux), (ty, taux) = _run(jcfg, tcfg, jp, tp, x, dropless, groups)
    _close(ty, jy)
    assert abs(taux - jaux) <= LAYER_TOL * abs(jaux)
    assert np.isfinite(ty).all() and taux >= 0.0


def test_tight_capacity_drops_tokens():
    """At capacity_factor 0.126 one slot per expert: most pairs drop and
    the output's norm falls below the drop-free one's (both as the
    reference's)."""
    jt, tt = _cfgs(capacity_factor=0.126)
    jl, tl = _cfgs(capacity_factor=8.0)
    assert TL.moe_capacity(tt, 64, False) == 2
    assert TL.moe_capacity(tl, 64, False) == 128
    assert TL.moe_capacity(tt, 64, True) == 128
    jp, tp = _params(jt)
    x = np.random.RandomState(3).randn(1, 64, 32).astype(np.float32)
    (jy_t, _), (ty_t, _) = _run(jt, tt, jp, tp, x)
    (jy_l, _), (ty_l, _) = _run(jl, tl, jp, tp, x)
    _close(ty_t, jy_t)
    _close(ty_l, jy_l)
    assert np.linalg.norm(ty_t) < np.linalg.norm(ty_l)


def test_dropless_is_permutation_invariant():
    """Dropless: shuffling the tokens of the single group shuffles the
    outputs and changes nothing else."""
    _, tcfg = _cfgs()
    _, tp = _params(_cfgs()[0])
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 32, 32)
                         .astype(np.float32))
    perm = torch.from_numpy(np.random.RandomState(0).permutation(32))
    y, _ = TL.moe_apply(tp, x, tcfg, dropless=True)
    y2, _ = TL.moe_apply(tp, x[:, perm], tcfg, dropless=True)
    torch.testing.assert_close(y[:, perm], y2, rtol=2e-5, atol=2e-6)


def test_dropless_groups_agree():
    """n_groups 2 against 1, dropless: the groups are independent and no
    capacity couples them."""
    _, tcfg = _cfgs()
    _, tp = _params(_cfgs()[0])
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 16, 32)
                         .astype(np.float32))
    y1, _ = TL.moe_apply(tp, x, tcfg, TL.ShardCtx(n_groups=1), dropless=True)
    y2, _ = TL.moe_apply(tp, x, tcfg, TL.ShardCtx(n_groups=2), dropless=True)
    torch.testing.assert_close(y1, y2, rtol=2e-5, atol=2e-6)


def test_shared_expert_always_active():
    """With nearly every routed pair dropped the shared expert still
    flows, as the reference's."""
    jcfg, tcfg = _cfgs(capacity_factor=0.01, n_shared_experts=1)
    jp, tp = _params(jcfg)
    x = np.random.RandomState(4).randn(1, 32, 32).astype(np.float32)
    (jy, _), (ty, _) = _run(jcfg, tcfg, jp, tp, x)
    _close(ty, jy)
    assert np.linalg.norm(ty) > 0.0
    shared = TL.mlp_apply(tp["shared"], torch.from_numpy(x)).numpy()
    assert np.abs(ty - shared).max() > 0.0          # the one kept slot


def _tied_router(jp):
    """A router whose experts come in pairs with equal columns (2i and
    2i + 1): every token's probabilities tie pairwise, so each top-k cut
    through a pair is decided by the tie order alone."""
    r = np.asarray(jp["router"]).copy()
    r[:, 1::2] = r[:, 0::2]
    return {**jp, "router": r}


@pytest.mark.parametrize("top_k", [1, 3])
def test_router_ties_go_to_the_lower_expert(top_k):
    """Equal router probabilities: the port's top-k picks the lower expert
    id first, as jax.lax.top_k does, so the routing and the output equal
    the reference's."""
    jcfg, tcfg = _cfgs(capacity_factor=1.0, top_k=top_k)
    jp, _ = _params(jcfg)
    jp = _tied_router(jp)
    tp = lm_params_from_jax(jp, device="cpu")
    x = np.random.RandomState(7).randn(2, 16, 32).astype(np.float32)
    _, ttopv, ttopi = TL.moe_route(tp, torch.from_numpy(x).reshape(1, 32, 32),
                                   tcfg)
    logits = jnp.einsum("gtd,de->gte", jnp.asarray(x).reshape(1, 32, 32),
                        jp["router"]).astype(jnp.float32)
    jtopv, jtopi = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
    np.testing.assert_array_equal(ttopi.numpy(), np.asarray(jtopi))
    _close(ttopv.numpy(), np.asarray(jtopv) / np.asarray(jtopv).sum(
        -1, keepdims=True))
    probs = torch.softmax(torch.from_numpy(np.array(logits)), -1)
    # the ties are real: each pair's two probabilities are bitwise equal
    assert torch.equal(probs[..., 0::2], probs[..., 1::2])
    # an odd top-k cuts a pair at its last pick: the lower (even) id is kept
    if top_k % 2:
        assert bool((ttopi[..., -1] % 2 == 0).all())
    (jy, jaux), (ty, taux) = _run(jcfg, tcfg, jp, tp, x)
    _close(ty, jy)
    assert abs(taux - jaux) <= LAYER_TOL * abs(jaux)


def test_chunked_dispatch_is_the_chunks_in_turn():
    """chunk_tokens below the group size: the output is each chunk's own
    dispatch (capacity per chunk) and the aux loss the chunks' mean."""
    _, tcfg = _cfgs(capacity_factor=1.0, chunk_tokens=8)
    _, whole = _cfgs(capacity_factor=1.0)
    _, tp = _params(_cfgs()[0])
    x = torch.from_numpy(np.random.RandomState(8).randn(1, 24, 32)
                         .astype(np.float32))
    y, aux = TL.moe_apply(tp, x, tcfg)
    parts = [TL.moe_apply(tp, x[:, i:i + 8], whole) for i in (0, 8, 16)]
    torch.testing.assert_close(y, torch.cat([p[0] for p in parts], 1),
                               rtol=0, atol=0)
    torch.testing.assert_close(aux, torch.stack([p[1] for p in parts]).mean(),
                               rtol=0, atol=0)
