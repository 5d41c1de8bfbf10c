"""Plain torch versions of the port's kernels.

They serve CPU tensors, and on the card they are the oracle that
``chip_smoke.py`` holds each CUDA kernel against.  The forest versions'
arithmetic is the kernels' own, step for step, so both are bitwise equal to
the numpy mirror ``ml.forest.forest_predict_np``:

- the same float32 compare ``x > threshold``;
- an exact integer leaf index, level 0 the most significant bit;
- the leaf values summed strictly in tree order in float32;
- one IEEE division by the float32 tree count.

The last two differ on purpose from the JAX oracle's ``vals.mean(axis=1)``
(``repro/kernels/ref.py``), whose reduction order depends on the shape.

The attention versions follow the JAX oracles of ``repro/kernels/ref.py``:
q (B, S, H, D); k/v (B, Skv, Hkv, D); GQA with H = G * Hkv, query head
``h`` reading kv head ``h // G``; float32 scores, softmax and accumulators,
the result cast back to q's dtype.  Masked scores are ``NEG_INF`` (a finite
-0.7 * float32 max, so a wholly masked block gives exp(0) terms that the
next live block's rescale wipes) and the denominator is floored at 1e-37.
Unlike the oracles, neither length needs to be a multiple of a chunk: the
last chunk is ragged.

The recurrences (RWKV6's WKV6 scan, Mamba2's SSD scan and their one-step
decode forms) are the reference's forward oracles: a loop over t in
float32, y cast back to the input's dtype."""

from __future__ import annotations

import math

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _leaf_index(bits: torch.Tensor) -> torch.Tensor:
    """(..., D) bool -> (...,) int64 leaf index, level 0 the MSB."""
    D = bits.shape[-1]
    weights = 1 << torch.arange(D - 1, -1, -1, device=bits.device)
    return (bits.long() * weights).sum(-1)


def _sum_in_tree_order(vals: torch.Tensor) -> torch.Tensor:
    """(R, T) -> (R,) float32, accumulated tree 0, 1, ..., T-1."""
    acc = vals[:, 0].clone()
    for t in range(1, vals.shape[1]):
        acc = acc + vals[:, t]
    return acc


def forest_infer_ref(x, feat_idx, thresholds, leaves):
    """Mean leaf value of one oblivious forest.

    x: (B, F) float32; feat_idx: (T, D) int; thresholds: (T, D) float32;
    leaves: (T, 2^D) float32.  Tree t at level d tests
    ``x[:, feat_idx[t, d]] > thresholds[t, d]``.  Returns (B,) float32."""
    B = x.shape[0]
    T, D = feat_idx.shape
    g = x.float()[:, feat_idx.reshape(-1).long()].reshape(B, T, D)
    leaf = _leaf_index(g > thresholds.float()[None])              # (B, T)
    vals = torch.gather(leaves.float()[None].expand(B, -1, -1), 2,
                        leaf[..., None])[..., 0]                  # (B, T)
    return _sum_in_tree_order(vals) / torch.tensor(T, dtype=torch.float32,
                                                   device=x.device)


def forest_infer_grouped_ref(x, seg_ids, feat_idx, thresholds, leaves,
                             n_trees):
    """Block-diagonal pass: row r is scored only by model seg_ids[r].

    x: (R, F) rows stacked segment by segment; seg_ids: (R,) int model index
    per row; feat_idx/thresholds: (M, T, D) padded blocks (+inf thresholds on
    padded levels, so their bits are False); leaves: (M, T, 2^D), zero on
    padded trees; n_trees: (M,) true tree counts.  Padded trees add exactly
    0.0 to the tree-order sum, and the division is by the true count, so a
    row's score equals its own model's unpadded forest_infer_ref."""
    R = x.shape[0]
    M, T, D = feat_idx.shape
    seg = seg_ids.long()
    fi = feat_idx.reshape(M, T * D).long()[seg]                   # (R, T*D)
    th = thresholds.reshape(M, T * D).float()[seg]
    g = torch.gather(x.float(), 1, fi)
    leaf = _leaf_index((g > th).reshape(R, T, D))                 # (R, T)
    vals = torch.gather(leaves.float()[seg], 2, leaf[..., None])[..., 0]
    return _sum_in_tree_order(vals) / n_trees.float()[seg]


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _mask(qpos, kpos, *, causal, window):
    """(..., Sq, Sk) bool: key kpos is visible from query qpos."""
    m = torch.ones(qpos.shape[0], kpos.shape[0], dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window:
        m &= kpos[None, :] > qpos[:, None] - window
    return m


def attention_naive(q, k, v, *, causal=True, window=0):
    """O(S^2)-memory attention; only for small shapes.  Queries are
    right-aligned: query i sits at position i + Skv - S."""
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = q.float().reshape(B, S, Hkv, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) / math.sqrt(D)
    qpos = torch.arange(S, device=q.device) + (Skv - S)
    mask = _mask(qpos, torch.arange(Skv, device=q.device), causal=causal,
                 window=window)
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal=True, window=0, q_chunk=512,
                        kv_chunk=512):
    """Chunked online-softmax attention, float32 accumulators: the plain
    version of the flash kernel.  Every (q chunk, kv chunk) pair is computed
    and masked; the kernel skips wholly masked blocks instead."""
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    offset = Skv - S
    kf, vf = k.float(), v.float()
    out = torch.empty(B, S, Hkv, G, D, dtype=torch.float32, device=q.device)
    for q0 in range(0, S, q_chunk):
        qblk = q[:, q0:q0 + q_chunk].float().reshape(B, -1, Hkv, G, D) * scale
        qpos = torch.arange(q0, q0 + qblk.shape[1], device=q.device) + offset
        acc = torch.zeros_like(qblk)
        m = torch.full(qblk.shape[:-1], NEG_INF, device=q.device)
        l = torch.zeros(qblk.shape[:-1], device=q.device)
        for k0 in range(0, Skv, kv_chunk):
            kblk, vblk = kf[:, k0:k0 + kv_chunk], vf[:, k0:k0 + kv_chunk]
            s = torch.einsum("bqhgd,bkhd->bqhgk", qblk, kblk)
            kpos = torch.arange(k0, k0 + kblk.shape[1], device=q.device)
            mask = _mask(qpos, kpos, causal=causal, window=window)
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p, vblk)
            m = m_new
        out[:, q0:q0 + qblk.shape[1]] = acc / torch.clamp(l[..., None],
                                                          min=1e-37)
    return out.reshape(B, S, H, D).to(q.dtype)


def decode_attention_ref(q, k, v, kv_len, *, window=0, kv_chunk=1024):
    """One query token per sequence against a KV cache: q (B, 1, H, D),
    k/v (B, Smax, Hkv, D), kv_len (B,) live prefix lengths; positions at or
    past kv_len, and with a window those at or before kv_len - 1 - window,
    are masked.  Online softmax over kv chunks, float32 accumulators: the
    plain version of the decode kernel."""
    B, _, H, D = q.shape
    Smax, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qf = (q.float() * scale).reshape(B, Hkv, G, D)
    lens = kv_len.to(device=q.device, dtype=torch.int64)[:, None]
    acc = torch.zeros(B, Hkv, G, D, device=q.device)
    m = torch.full((B, Hkv, G), NEG_INF, device=q.device)
    l = torch.zeros(B, Hkv, G, device=q.device)
    for k0 in range(0, Smax, kv_chunk):
        kblk = k[:, k0:k0 + kv_chunk].float()
        vblk = v[:, k0:k0 + kv_chunk].float()
        s = torch.einsum("bhgd,bkhd->bhgk", qf, kblk)
        kpos = torch.arange(k0, k0 + kblk.shape[1], device=q.device)[None]
        mask = kpos < lens
        if window:
            mask &= kpos > lens - 1 - window
        s = torch.where(mask[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgk,bkhd->bhgd", p, vblk)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-37)
    return out.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Recurrences: RWKV6 (WKV6) and Mamba2 (SSD)
# ---------------------------------------------------------------------------
#
# Forward only, sequential in t, in float32, with y cast back to the input's
# dtype: the reference's oracles (repro/kernels/ref.py:rwkv6_scan_ref,
# mamba2_ssd_ref) without their custom VJPs, which come with training.

def rwkv6_scan_ref(r, k, v, w, u, state0):
    """Sequential WKV6: per head, y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),
    S_t = diag(w_t) S_{t-1} + k_t^T v_t.

    r, k, v, w: (B, S, H, Dh); u: (H, Dh); state0: (B, H, Dh, Dh) float32
    [key x value dims].  Returns y (B, S, H, Dh) in r's dtype and the final
    state in float32."""
    B, S, H, Dh = r.shape
    uf = u.float()[None, :, :, None]
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    state = state0.float()
    y = torch.empty(B, S, H, Dh, dtype=torch.float32, device=r.device)
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]      # (B, H, Dh, Dh)
        y[:, t] = torch.einsum("bhk,bhkv->bhv", rf[:, t], state + uf * kv)
        state = wf[:, t, :, :, None] * state + kv
    return y.to(r.dtype), state


def rwkv6_step_ref(r, k, v, w, u, state):
    """One decode step: r, k, v, w (B, H, Dh); state (B, H, Dh, Dh).
    Returns y (B, H, Dh) in r's dtype and the new float32 state."""
    kv = k.float()[..., :, None] * v.float()[..., None, :]
    sf = state.float()
    y = torch.einsum("bhk,bhkv->bhv", r.float(),
                     sf + u.float()[None, :, :, None] * kv)
    return y.to(r.dtype), w.float()[..., :, None] * sf + kv


def mamba2_ssd_ref(x, dt, A, Bmat, Cmat, state0):
    """Sequential SSD: per head h with state (P, N),
    S_t = exp(dt_t A_h) S_{t-1} + dt_t x_t B_t^T,  y_t = S_t C_t.

    x: (B, S, H, P); dt: (B, S, H); A: (H,) (negative); B, C: (B, S, N);
    state0: (B, H, P, N) float32.  Returns y (B, S, H, P) in x's dtype and
    the final state in float32."""
    Bb, S, H, P = x.shape
    Af = A.float()[None, :]
    xf, dtf, bf, cf = (t.float() for t in (x, dt, Bmat, Cmat))
    state = state0.float()
    y = torch.empty(Bb, S, H, P, dtype=torch.float32, device=x.device)
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af)                       # (B, H)
        inject = (dtf[:, t, :, None] * xf[:, t])[..., :, None] \
            * bf[:, t, None, None, :]
        state = decay[..., None, None] * state + inject         # (B, H, P, N)
        y[:, t] = torch.einsum("bhpn,bn->bhp", state, cf[:, t])
    return y.to(x.dtype), state


def mamba2_step_ref(x, dt, A, Bvec, Cvec, state):
    """One decode step: x (B, H, P); dt (B, H); B, C (B, N); state
    (B, H, P, N).  Returns y (B, H, P) in x's dtype and the new float32
    state."""
    dtf = dt.float()
    decay = torch.exp(dtf * A.float()[None, :])
    inject = (dtf[..., None] * x.float())[..., :, None] \
        * Bvec.float()[:, None, None, :]
    state = decay[..., None, None] * state.float() + inject
    y = torch.einsum("bhpn,bn->bhp", state, Cvec.float())
    return y.to(x.dtype), state


def bf16_pair(x):
    """x (float32) as the sum of two bf16 values hi + lo, returned as one
    float32 tensor: what a tensor-core product sees of a float32 operand
    that enters it as a bf16 pair (hi = bf16(x), lo = bf16(x - hi)); the
    sum is exact in float32."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float()


def mamba2_ssd_chunked_ref(x, dt, A, Bmat, Cmat, state0, *, chunk=64,
                           split_bf16=True):
    """The bf16 SSD kernel's algorithm (``csrc/recurrence.cu:
    mamba2_ssd_chunked_kernel``) in torch, for the tests: the chunked
    "state-space dual" form of ``mamba2_ssd_ref``, never used by a path on
    the card.

    Per chunk of ``chunk`` steps, with a_s = dt_s A_h and cs the inclusive
    cumulative sum of a over the chunk,
        G = C B^T,  M[t, s] = G[t, s] exp(cs_t - cs_s) dt_s  (s <= t, else 0)
        y = M X + diag(exp(cs)) C S_in^T
        S_out = exp(cs_last) S_in + (diag(exp(cs_last - cs_s) dt_s) X)^T B
    Every decay is exp of a difference cs_t - cs_s <= 0, never a ratio of
    cumulative products, so none overflows.  With ``split_bf16`` the
    float32 operands of the products (M, the scaled X, S_in) are rounded to
    the kernel's bf16 pairs (``bf16_pair``); x, B and C are taken as they
    are (exact in bf16 when the inputs are bf16).  A ragged last chunk is
    the kernel's zero-padded one: padding adds nothing and decays nothing.
    Shapes and dtypes as ``mamba2_ssd_ref``."""
    Bb, S, H, P = x.shape
    rnd = bf16_pair if split_bf16 else (lambda t: t)
    xf, dtf, bf, cf = (t.float() for t in (x, dt, Bmat, Cmat))
    Af = A.float()
    state = state0.float()
    y = torch.empty(Bb, S, H, P, dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        X, dtc = xf[:, c0:c0 + chunk], dtf[:, c0:c0 + chunk]
        Bc, Cc = bf[:, c0:c0 + chunk], cf[:, c0:c0 + chunk]
        n = X.shape[1]
        cs = torch.cumsum(dtc * Af, dim=1)                      # (B, n, H)
        causal = torch.ones(n, n, dtype=torch.bool,
                            device=x.device).tril()[None, :, :, None]
        seg = torch.where(causal, cs[:, :, None] - cs[:, None],
                          -math.inf)                            # (B, t, s, H)
        G = torch.einsum("btn,bsn->bts", Cc, Bc)
        M = G[..., None] * torch.exp(seg) * dtc[:, None]
        y[:, c0:c0 + n] = torch.einsum(
            "btn,bhpn->bthp", Cc, rnd(state)) * torch.exp(cs)[..., None] \
            + torch.einsum("btsh,bshp->bthp", rnd(M), X)
        f = torch.exp(cs[:, -1:] - cs) * dtc                    # (B, n, H)
        state = torch.exp(cs[:, -1])[..., None, None] * state + torch.einsum(
            "bshp,bsn->bhpn", rnd(f[..., None] * X), Bc)
    return y.to(x.dtype), state
