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
float32, y cast back to the input's dtype.  Their gradients are the
reference's chunked adjoints (``repro/kernels/ref.py:_rwkv6_fwd/_rwkv6_bwd``
and ``_ssd_fwd/_ssd_bwd``), as ``torch.autograd.Function``s whose forward
is any scan of the chunk (the plain loop here, or the CUDA kernel through
``kernels.ops``).  On ``meta`` under ``launch/cost.py``'s counting mode an
adjoint runs one chunk, and one step of each per-step loop, and has it
counted for all (``cost.repeat``): every chunk and step dispatches the
same operations on the same shapes."""

from __future__ import annotations

import math

import torch

from repro_torch.launch import cost

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


def decode_attention_xla(q, k, v, kv_len, *, window=0):
    """One-token decode attention as one masked softmax over the whole
    cache: the reference's model-path decode (``repro/kernels/ref.py:
    decode_attention_xla``), whose max, sum and contraction over the cache's
    sequence GSPMD turns into the partial-softmax merge when the cache is
    sharded along it.  The port merges such slices itself
    (``decode_attention_partial_ref`` / the kernel's partial mode, then
    ``merge_partials``); this form is their oracle.  Shapes as
    ``decode_attention_ref``."""
    B, _, H, D = q.shape
    Smax, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = (q.float() * (1.0 / math.sqrt(D))).reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k.float())
    kpos = torch.arange(Smax, device=q.device)[None, :]
    lens = kv_len.to(device=q.device, dtype=torch.int64)[:, None]
    mask = kpos < lens
    if window:
        mask &= kpos > lens - 1 - window
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    out = out / torch.clamp(l[..., None], min=1e-37)
    return out.reshape(B, 1, H, D).to(q.dtype)


def decode_attention_partial_ref(q, k, v, kv_len, *, start, window=0):
    """The plain version of the decode kernel's partial mode: q (B, 1, H, D)
    against one slice k/v (B, Smax, Hkv, D) of a cache cut along its
    sequence, holding global positions [start, start + Smax); kv_len (B,)
    and ``window`` are the whole cache's (a live key is at a position p <
    kv_len, and p > kv_len - 1 - window with a window).  Returns float32 (o
    (B, 1, H, D), m (B, H), l (B, H)): the output against its max m, not
    divided by the sum l of its weights.  A sequence with no live key in
    the slice gets o = 0, l = 0 and m = -inf."""
    B, _, H, D = q.shape
    Smax, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = (q.float() * (1.0 / math.sqrt(D))).reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k.float())
    kpos = torch.arange(start, start + Smax, device=q.device)[None, :]
    lens = kv_len.to(device=q.device, dtype=torch.int64)[:, None]
    mask = kpos < lens
    if window:
        mask &= kpos > lens - 1 - window
    mask = mask[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    m = torch.where(l > 0, m, -math.inf)
    return o.reshape(B, 1, H, D), m.reshape(B, H), l.reshape(B, H)


def merge_partials(m, l, o):
    """Merge R slices' partials, stacked on a leading rank dimension: m, l
    (R, B, H), o (R, B, 1, H, D), float32, as the partial mode and
    ``decode_attention_partial_ref`` give them.  Returns the normalised
    output (B, 1, H, D) float32: each slice weighed by exp(m_r - max_r
    m_r), the weighted sums divided by the weighted l (floored at 1e-37).
    A slice with no live key (m = -inf, l = 0, o = 0) weighs 0, and a
    sequence with no live key in any slice gets 0, never NaN."""
    top = m.amax(0)
    top = torch.where(torch.isinf(top), 0.0, top)
    w = torch.where(torch.isinf(m), 0.0, torch.exp(m - top))    # (R, B, H)
    den = (w * l).sum(0)
    num = (w[:, :, None, :, None] * o).sum(0)
    return num / torch.clamp(den, min=1e-37)[:, None, :, None]


# ---------------------------------------------------------------------------
# Recurrences: RWKV6 (WKV6) and Mamba2 (SSD)
# ---------------------------------------------------------------------------
#
# Sequential in t, in float32, with y cast back to the input's dtype: the
# reference's oracles (repro/kernels/ref.py:rwkv6_scan_ref, mamba2_ssd_ref).
# Their custom VJPs are RWKV6Scan and SSDScan below.

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


# ---------------------------------------------------------------------------
# The recurrences' chunked adjoints (training)
# ---------------------------------------------------------------------------
#
# Both recurrences are linear in the state, so the backward pass is the
# analytic adjoint recurrence run in reverse, with the forward states
# recomputed chunk by chunk from the states at the chunk boundaries, which
# the forward saves once per chunk: O(S / c + c) states, where autograd
# through the stepwise loop would keep every step's state.  The chunk is the
# reference's: the largest divisor of S up to 128.
#
# Within a chunk the two recurrences (the states forward, the state adjoints
# backward) run step by step for WKV6, one fused multiply-add per step (its
# per-channel decays may be exactly 0, so no log-domain form), and as
# products with the chunk's decay matrix for the SSD (one scalar decay per
# step and head); every gradient is then one batched product over the
# chunk's steps.  The reference computes the same terms inside its per-step
# scan body.

RWKV_CHUNK = 128
SSD_CHUNK = 128


def divisor_chunk(n: int, want: int) -> int:
    """Largest divisor of n that is <= want (``repro/kernels/ref.py:47``)."""
    c = min(want, n)
    while n % c:
        c -= 1
    return c


def _time_major(x, c0, c):
    """Steps c0 .. c0 + c - 1 of a (B, S, ...) tensor as float32 (c, B, ...)."""
    return x[:, c0:c0 + c].float().movedim(1, 0)


def _chunked_forward(scan, xs, rest, state0, chunk):
    """Run ``scan(*chunk_inputs, *rest, state)`` chunk by chunk from state0.
    Returns y (B, S, ...) in the scan's dtype, the final state and the
    states each chunk started from, stacked (n_chunks, ...)."""
    S = xs[0].shape[1]
    state, ys, bounds = state0.float(), [], []
    for c0 in range(0, S, chunk):
        bounds.append(state)
        y, state = scan(*(x[:, c0:c0 + chunk].contiguous() for x in xs),
                        *rest, state)
        ys.append(y)
    return torch.cat(ys, dim=1), state, torch.stack(bounds)


def _rwkv6_bwd(r, k, v, w, u, bounds, chunk, ybar, sbar):
    """The WKV6 adjoint: gradients of (r, k, v, w, u, state0) given those
    of y (B, S, H, Dh) and of the final state, all float32."""
    B, S, H, Dh = r.shape
    uf = u.float()
    grads = [torch.empty(B, S, H, Dh, device=r.device) for _ in range(4)]
    ubar = torch.zeros(H, Dh, device=r.device)
    sbar = sbar.float()
    with cost.repeat(r, S // chunk) as n_chunks:   # every chunk alike
        for ci in list(reversed(range(S // chunk)))[:n_chunks]:
            sbar = _rwkv6_bwd_chunk(r, k, v, w, uf, bounds, chunk, ybar,
                                    sbar, grads, ubar, ci)
    return (*grads, ubar, sbar)


def _rwkv6_bwd_chunk(r, k, v, w, uf, bounds, chunk, ybar, sbar, grads,
                     ubar, ci):
    """Chunk ci of the WKV6 adjoint: writes its rows of ``grads``, adds
    to ``ubar`` and returns the adjoint of the chunk's first state."""
    c0 = ci * chunk
    rc, kc, vc, wc, yb = (_time_major(t, c0, chunk)
                          for t in (r, k, v, w, ybar))   # (c, B, H, Dh)
    kv = kc[..., :, None] * vc[..., None, :]             # (c, B, H, K, V)
    # the chunk's states: states[t] = S_{t-1}, the state before step t
    states = torch.empty((chunk + 1,) + sbar.shape, device=r.device)
    states[0] = bounds[ci]
    with cost.repeat(r, chunk) as steps:   # every step alike
        for t in range(steps):
            torch.addcmul(kv[t], wc[t][..., None], states[t],
                          out=states[t + 1])
    s_prev = states[:chunk]
    # the state adjoints: sbars[t] = dL/dS_t, S_t the state after step t
    ry = rc[..., :, None] * yb[..., None, :]             # output path
    sbars = torch.empty_like(s_prev)
    sbars[chunk - 1] = sbar
    with cost.repeat(r, chunk - 1) as steps:
        for t in range(chunk - 1, chunk - 1 - steps, -1):
            torch.addcmul(ry[t], wc[t][..., None], sbars[t],
                          out=sbars[t - 1])
    sbar = torch.addcmul(ry[0], wc[0][..., None], sbars[0])
    m = s_prev + uf[None, None, :, :, None] * kv
    yv = (yb * vc).sum(-1)                               # (c, B, H)
    rbar = torch.einsum("tbhkv,tbhv->tbhk", m, yb)
    kbar = torch.einsum("tbhkv,tbhv->tbhk", sbars, vc) \
        + uf * rc * yv[..., None]
    vbar = torch.einsum("tbhkv,tbhk->tbhv", sbars, kc) \
        + yb * (rc * uf * kc).sum(-1)[..., None]
    wbar = (sbars * s_prev).sum(-1)
    ubar += torch.einsum("tbhk,tbh->hk", rc * kc, yv)
    for g, gc in zip(grads, (rbar, kbar, vbar, wbar)):
        g[:, c0:c0 + chunk] = gc.movedim(0, 1)
    return sbar


class RWKV6Scan(torch.autograd.Function):
    """WKV6 with the chunked adjoint as its backward.  ``scan(r, k, v, w,
    u, state) -> (y, state)`` computes one chunk's forward: the plain
    ``rwkv6_scan_ref`` or the CUDA kernel (``kernels.ops.rwkv6_scan``)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0, scan):
        chunk = divisor_chunk(r.shape[1], RWKV_CHUNK)
        y, state, bounds = _chunked_forward(scan, (r, k, v, w), (u,), state0,
                                            chunk)
        ctx.save_for_backward(r, k, v, w, u, bounds)
        ctx.chunk, ctx.state_dtype = chunk, state0.dtype
        return y, state

    @staticmethod
    def backward(ctx, ybar, sbar):
        r, k, v, w, u, bounds = ctx.saved_tensors
        rb, kb, vb, wb, ub, sb = _rwkv6_bwd(r, k, v, w, u, bounds, ctx.chunk,
                                            ybar, sbar)
        return (rb.to(r.dtype), kb.to(k.dtype), vb.to(v.dtype),
                wb.to(w.dtype), ub.to(u.dtype), sb.to(ctx.state_dtype), None)


def rwkv6_scan_chunked(r, k, v, w, u, state0, scan=rwkv6_scan_ref):
    """``rwkv6_scan_ref``'s function, differentiable by the chunked adjoint
    (the reference's custom VJP), its forward run chunk by chunk through
    ``scan``."""
    return RWKV6Scan.apply(r, k, v, w, u, state0, scan)


def _ssd_bwd(x, dt, A, Bmat, Cmat, bounds, chunk, ybar, sbar):
    """The SSD adjoint: gradients of (x, dt, A, B, C, state0) given those of
    y (B, S, H, P) and of the final state, all float32.

    The decay is one scalar per (step, head), so within a chunk both
    recurrences are products with the chunk's decay matrix
    L[t, s] = exp(cs_t - cs_s) (s <= t; cs the inclusive cumulative sum of
    dt A over the chunk, every exponent <= 0), the form of the bf16 SSD
    kernel (``mamba2_ssd_chunked_ref``): S_t = exp(cs_t) S_0 + sum_s L[t, s]
    dt_s x_s B_s^T, and the adjoint the same with L transposed."""
    Bb, S, H, P = x.shape
    N = Bmat.shape[-1]
    Af = A.float()
    gx = torch.empty(Bb, S, H, P, device=x.device)
    gdt = torch.empty(Bb, S, H, device=x.device)
    gB = torch.empty(Bb, S, N, device=x.device)
    gC = torch.empty(Bb, S, N, device=x.device)
    Abar = torch.zeros(H, device=x.device)
    sbar = sbar.float()
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()
    with cost.repeat(x, S // chunk) as n_chunks:   # every chunk alike
        for ci in list(reversed(range(S // chunk)))[:n_chunks]:
            sbar = _ssd_bwd_chunk(x, dt, Af, Bmat, Cmat, bounds, chunk, ybar,
                                  sbar, (gx, gdt, gB, gC), Abar, causal, ci)
    return gx, gdt, Abar, gB, gC, sbar


def _ssd_bwd_chunk(x, dt, Af, Bmat, Cmat, bounds, chunk, ybar, sbar, grads,
                   Abar, causal, ci):
    """Chunk ci of the SSD adjoint: writes its rows of ``grads`` (x, dt,
    B, C), adds to ``Abar`` and returns the adjoint of the chunk's first
    state."""
    Bb, _, H, P = x.shape
    N = Bmat.shape[-1]

    def by_step(flat):                       # (B, H, c, P*N) -> (c, B, H, P, N)
        return flat.reshape(Bb, H, chunk, P, N).permute(2, 0, 1, 3, 4)

    def flat(t):                             # (c, B, H, P, N) -> (B, H, c, P*N)
        return t.permute(1, 2, 0, 3, 4).reshape(Bb, H, chunk, P * N)

    c0 = ci * chunk
    xc, dtc, bc, cc, yb = (_time_major(t, c0, chunk)
                           for t in (x, dt, Bmat, Cmat, ybar))
    log_decay = dtc * Af                                 # (c, B, H)
    decay = torch.exp(log_decay)
    cs = torch.cumsum(log_decay, dim=0).permute(1, 2, 0)  # (B, H, c)
    L = torch.exp(torch.where(causal, cs[..., :, None] - cs[..., None, :],
                              -math.inf))                # (B, H, t, s)
    s0 = bounds[ci].reshape(Bb, H, 1, P * N)
    inject = (dtc[..., None] * xc)[..., :, None] * bc[:, :, None, None, :]
    s_t = by_step(L @ flat(inject) + torch.exp(cs)[..., None] * s0)
    s_prev = torch.cat([bounds[ci][None], s_t[:-1]])
    # sbt[t] = dL/dS_t with step t's output term yb_t C_t^T, carried back
    # through the decays; the adjoint of the chunk's first state is
    # decay_0 sbt[0]
    yc = yb[..., :, None] * cc[:, :, None, None, :]
    sbt = by_step(L.transpose(-1, -2) @ flat(yc)
                  + torch.exp(cs[..., -1:] - cs)[..., None]
                  * sbar.reshape(Bb, H, 1, P * N))
    sbar = decay[0][..., None, None] * sbt[0]
    cbar = torch.einsum("tbhpn,tbhp->tbn", s_t, yb)
    abar = (sbt * s_prev).sum((-2, -1))                  # d/d decay
    sb_b = torch.einsum("tbhpn,tbn->tbhp", sbt, bc)
    dtbar = abar * decay * Af + (sb_b * xc).sum(-1)
    xbar = dtc[..., None] * sb_b
    bbar = torch.einsum("tbhpn,tbhp->tbn", sbt, dtc[..., None] * xc)
    Abar += torch.einsum("tbh,tbh->h", abar * decay, dtc)
    for g, gc in zip(grads, (xbar, dtbar, bbar, cbar)):
        g[:, c0:c0 + chunk] = gc.movedim(0, 1)
    return sbar


class SSDScan(torch.autograd.Function):
    """The Mamba2 SSD with the chunked adjoint as its backward.  ``scan(x,
    dt, B, C, A, state) -> (y, state)`` computes one chunk's forward (note
    the argument order: the per-step inputs first)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bmat, Cmat, state0, scan):
        chunk = divisor_chunk(x.shape[1], SSD_CHUNK)
        y, state, bounds = _chunked_forward(scan, (x, dt, Bmat, Cmat), (A,),
                                            state0, chunk)
        ctx.save_for_backward(x, dt, A, Bmat, Cmat, bounds)
        ctx.chunk, ctx.state_dtype = chunk, state0.dtype
        return y, state

    @staticmethod
    def backward(ctx, ybar, sbar):
        x, dt, A, Bmat, Cmat, bounds = ctx.saved_tensors
        gx, gdt, gA, gB, gC, gs = _ssd_bwd(x, dt, A, Bmat, Cmat, bounds,
                                           ctx.chunk, ybar, sbar)
        return (gx.to(x.dtype), gdt.to(dt.dtype), gA.to(A.dtype),
                gB.to(Bmat.dtype), gC.to(Cmat.dtype),
                gs.to(ctx.state_dtype), None)


def ssd_chunk_ref(x, dt, Bmat, Cmat, A, state):
    """``mamba2_ssd_ref`` with the per-step inputs first, as ``SSDScan``
    calls a chunk's scan."""
    return mamba2_ssd_ref(x, dt, A, Bmat, Cmat, state)


def mamba2_ssd_chunked(x, dt, A, Bmat, Cmat, state0, scan=ssd_chunk_ref):
    """``mamba2_ssd_ref``'s function, differentiable by the chunked adjoint
    (the reference's custom VJP), its forward run chunk by chunk through
    ``scan`` (per-step inputs first, as ``SSDScan`` calls it)."""
    return SSDScan.apply(x, dt, A, Bmat, Cmat, state0, scan)
