"""Oblivious decision trees / forests in PyTorch — the training and scoring
side of the ATLAS failure predictors.

Oblivious trees (one (feature, threshold) test per level, CatBoost-style):
every level of a tree tests one feature, so inference is D gathers and
compares per tree (``kernels/csrc/forest.cu``).  Training is histogram-based
and vectorised: all trees are fitted at once as a batch of per-sample weight
vectors — bootstrap resampling is just weights.

The split criterion is weighted variance reduction, which for {0,1} targets is
equivalent to Gini impurity up to a monotone transform; "ctree" mode normalises
the gain by pooled variance (a t-statistic-like score), approximating
conditional inference trees' test-based selection.

Parity with the JAX package.  The bootstrap weights come from the same
``np.random.RandomState(seed)`` stream.  For {0,1} targets and Poisson
weights the split statistics are sums of integers, exact in float32 in any
order; the per-leaf gains are summed leaf by leaf in a fixed order, the
matmuls run in full float32 (TF32 off) and ``torch.argmax`` keeps the first
maximum, as ``jnp.argmax`` does.  Scoring is bitwise equal to the numpy
mirror ``forest_predict_np`` on every path (numpy, plain torch, CUDA)."""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ops import resolve_device


def _on_device(obj, device, arrays) -> tuple:
    """``arrays`` as contiguous tensors on ``device``, copied once per device
    and kept on ``obj``, so that scoring moves only the feature rows.  The
    arrays are treated as immutable once ``obj`` is built."""
    cache = obj.__dict__.setdefault("_on_device", {})
    key = str(torch.device(device))
    hit = cache.get(key)
    if hit is None:
        hit = cache[key] = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays)
    return hit


@dataclasses.dataclass
class ForestParams:
    feat_idx: np.ndarray    # (T, D) int32
    thresholds: np.ndarray  # (T, D) float32
    leaves: np.ndarray      # (T, 2^D) float32  (mean target per leaf)

    def on(self, device) -> tuple:
        """(feat_idx int32, thresholds, leaves) as tensors on ``device``,
        cached on this object (see ``_on_device``)."""
        return _on_device(self, device, (
            np.asarray(self.feat_idx, np.int32),
            np.asarray(self.thresholds, np.float32),
            np.asarray(self.leaves, np.float32)))


def make_bins(X: np.ndarray, n_bins: int) -> np.ndarray:
    """Per-feature candidate thresholds from quantiles: (F, Q).

    Quantiles of constant / low-cardinality features repeat, and every repeat
    is the same zero-information candidate split occupying a slot in the
    (feature, quantile) candidate grid.  Each feature row keeps only its
    distinct thresholds (ascending); the tail is padded with +inf sentinels
    whose ``x > thr`` bits are identically False — a degenerate all-right
    split with exactly zero gain, so argmax never prefers one over a real
    candidate (ties resolve to the lowest flat index, which is finite)."""
    qs = np.linspace(0.05, 0.95, n_bins)
    thr = np.quantile(X, qs, axis=0).T.astype(np.float32)      # (F, Q)
    out = np.full_like(thr, np.inf)
    for f in range(thr.shape[0]):
        uniq = np.unique(thr[f])                               # sorted, distinct
        out[f, :uniq.size] = uniq
    return out


@contextlib.contextmanager
def _full_fp32_matmuls():
    """Float32 matmuls in full float32 on the card: TF32 would round the
    split statistics of float targets and move argmax ties."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _sum_leaves(v: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1 (leaves) of (T, L, ...) leaf by leaf, in leaf order."""
    acc = v[:, 0]
    for leaf in range(1, v.shape[1]):
        acc = acc + v[:, leaf]
    return acc


def _best_split(bits, w, wy, wyy, leaf, *, n_leaves: int, criterion: str):
    """One oblivious level for a batch of trees.

    bits: (N, FQ) f32 — precomputed X[:,f] > thr[f,q] indicators.
    w/wy/wyy: (T, N) — per-tree sample weights, weight*target, weight*target^2.
    leaf: (T, N) int64 current leaf of each sample.
    Returns the best flat candidate per tree (T,)."""
    ohT = torch.nn.functional.one_hot(leaf, n_leaves).to(bits.dtype) \
        .transpose(1, 2)                                       # (T, L, N)
    tot = ohT @ torch.stack([w, wy, wyy], dim=2)               # (T, L, 3)
    lw = (ohT * w[:, None, :]) @ bits                          # (T, L, FQ)
    ly = (ohT * wy[:, None, :]) @ bits
    lyy = (ohT * wyy[:, None, :]) @ bits
    rw = tot[..., 0:1] - lw
    ry = tot[..., 1:2] - ly
    ryy = tot[..., 2:3] - lyy
    eps = 1e-9

    def sse(s_w, s_y, s_yy):
        return s_yy - s_y * s_y / torch.clamp(s_w, min=eps)

    parent = sse(tot[..., 0:1], tot[..., 1:2], tot[..., 2:3])
    child = sse(lw, ly, lyy) + sse(rw, ry, ryy)
    gain = _sum_leaves(parent - child)                         # (T, FQ)
    if criterion == "ctree":
        pooled = _sum_leaves(child) / torch.clamp(
            _sum_leaves(tot[..., 0]), min=eps)[:, None]
        gain = gain / torch.sqrt(pooled + eps)
    # degenerate splits (all left / all right) get zero gain naturally
    return torch.argmax(gain, dim=1)


def _leaf_values(w, wy, leaf, *, n_leaves: int):
    ohT = torch.nn.functional.one_hot(leaf, n_leaves).to(w.dtype) \
        .transpose(1, 2)                                       # (T, L, N)
    sw = (ohT @ w[..., None])[..., 0]
    sy = (ohT @ wy[..., None])[..., 0]
    return sy / torch.clamp(sw, min=1e-9)


def fit_oblivious_forest(X: np.ndarray, y: np.ndarray, *, n_trees: int = 24,
                         depth: int = 5, n_bins: int = 8, bootstrap: bool = True,
                         criterion: str = "var", seed: int = 0,
                         sample_weight: np.ndarray | None = None,
                         fold_masks: np.ndarray | None = None,
                         device=None) -> ForestParams:
    """Fit ``n_trees`` oblivious trees of given depth on ``device``.

    fold_masks: optional (K, N) {0,1} — trains ``n_trees`` trees *per fold*
    in one batch (weights zeroed on the fold's test samples); returns K*T
    trees ordered fold-major, which ``tree_slice`` picks apart."""
    dev = resolve_device(device)
    N, F = X.shape
    thr = make_bins(X, n_bins)                                 # (F, Q)
    Q = thr.shape[1]
    bits_np = (X[:, :, None] > thr[None]).astype(np.float32).reshape(N, F * Q)

    rng = np.random.RandomState(seed)
    T = n_trees * (1 if fold_masks is None else fold_masks.shape[0])
    if bootstrap:
        w_np = rng.poisson(1.0, size=(T, N)).astype(np.float32)
    else:
        w_np = np.ones((T, N), np.float32)
    if fold_masks is not None:
        w_np = w_np * np.repeat(fold_masks, n_trees, axis=0)   # fold-major
    if sample_weight is not None:
        w_np = w_np * sample_weight[None, :]

    bits = torch.from_numpy(bits_np).to(dev)
    w = torch.from_numpy(np.ascontiguousarray(w_np, np.float32)).to(dev)
    yt = torch.from_numpy(np.asarray(y, np.float32)).to(dev)
    wy = w * yt[None]
    wyy = wy * yt[None]
    leaf = torch.zeros((T, N), dtype=torch.int64, device=dev)

    feat_idx = np.zeros((T, depth), np.int32)
    thresholds = np.zeros((T, depth), np.float32)
    thr_flat = thr.reshape(-1)
    with _full_fp32_matmuls():
        for d in range(depth):
            best = _best_split(bits, w, wy, wyy, leaf,
                               n_leaves=1 << d, criterion=criterion)
            best_np = best.cpu().numpy()
            feat_idx[:, d] = best_np // Q
            thresholds[:, d] = thr_flat[best_np]
            leaf = leaf * 2 + bits[:, best].T.to(torch.int64)  # (T, N)
        leaves = _leaf_values(w, wy, leaf, n_leaves=1 << depth).cpu().numpy()
    # empty leaves fall back to the tree prior
    prior = float(np.average(y, weights=np.maximum(w_np.sum(0), 1e-9)))
    counts = torch.zeros((T, 1 << depth), dtype=w.dtype, device=dev) \
        .scatter_add_(1, leaf, w).cpu().numpy()
    leaves = np.where(counts > 0, leaves, prior).astype(np.float32)
    return ForestParams(feat_idx=feat_idx, thresholds=thresholds, leaves=leaves)


def _mean_over_trees(vals: np.ndarray) -> np.ndarray:
    """Mean over axis 1 with a fixed, batch-shape-independent accumulation order.

    ``np.mean`` re-associates its pairwise reduction depending on the array
    shape, so the same row can round differently inside different batches
    (observed 1-2 ulp).  The online broker memoises probabilities and must
    return bit-identical values however requests are batched, so the tree sum
    is accumulated strictly in tree order — per-row arithmetic that cannot see
    the batch it rides in.  The CUDA kernels and ``kernels.ref`` do the same."""
    acc = vals[:, 0].astype(np.float32)                        # always a copy
    for t in range(1, vals.shape[1]):
        acc += vals[:, t]
    return acc / np.float32(vals.shape[1])


def _leaf_votes_np(fi, th, lv, x: np.ndarray) -> np.ndarray:
    """Per-(row, tree) leaf values for an oblivious forest: (B, T) float32.

    Bit patterns -> leaf indices go through a float32 dot with the power-of-two
    weights (exact for 0/1 bits and D <= 24)."""
    B = x.shape[0]
    T, D = fi.shape
    g = np.take(x, fi.reshape(-1), axis=1)                      # (B, T*D)
    bits = (g > th.reshape(1, T * D).astype(np.float32))
    weights = (1 << np.arange(D - 1, -1, -1)).astype(np.float32)
    leaf_idx = (bits.reshape(B * T, D).astype(np.float32) @ weights) \
        .astype(np.intp).reshape(B, T)
    flat_idx = leaf_idx + (np.arange(T) * lv.shape[1])[None, :]
    return np.take(lv.astype(np.float32).reshape(-1), flat_idx)


def _sliced(params: ForestParams, tree_slice: slice | None) -> ForestParams:
    """The trees ``tree_slice`` selects (one fold of a fold-major fit)."""
    if tree_slice is None:
        return params
    return ForestParams(feat_idx=params.feat_idx[tree_slice],
                        thresholds=params.thresholds[tree_slice],
                        leaves=params.leaves[tree_slice])


def forest_predict_np(params: ForestParams, X: np.ndarray,
                      tree_slice: slice | None = None) -> np.ndarray:
    """Pure-numpy mirror of ``kernels.ref.forest_infer_ref``: the bitwise
    oracle of every scoring path of the port."""
    params = _sliced(params, tree_slice)
    return _mean_over_trees(_leaf_votes_np(
        params.feat_idx, params.thresholds, params.leaves,
        np.asarray(X, np.float32)))


# ---------------------------------------------------------------------------
# Block-diagonal grouped inference: the serving-path hot loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PackedForests:
    """Many forests packed into one padded block-diagonal tensor layout.

    All models of a flush are padded to a common (T, D): padded levels test
    feature 0 against +inf (bits identically False), padded trees have all-zero
    leaves.  A model of true depth d stores leaf ``l`` at index ``l << (D-d)``
    so the padded bit arithmetic lands on exactly the original leaf value —
    votes for real trees are bit-identical to the unpadded model.

    The same layout feeds the numpy pass (``_leaf_votes_blockdiag``), the
    plain torch version and the grouped CUDA kernel."""
    feat_idx: np.ndarray    # (M, T, D) int32, zero-padded
    thresholds: np.ndarray  # (M, T, D) float32, +inf-padded
    leaves: np.ndarray      # (M, T, 2^D) float32, zero-padded / shifted
    n_trees: np.ndarray     # (M,) int32 true per-model tree counts

    def on(self, device) -> tuple:
        """(feat_idx, thresholds, leaves, n_trees) as tensors on ``device``,
        cached on this object: a flush of a cached pack moves only rows."""
        return _on_device(self, device, (self.feat_idx, self.thresholds,
                                         self.leaves, self.n_trees))


def pack_forests(params_list) -> PackedForests:
    """Pack per-model (T_m, D_m) forests into one padded (M, T, D) block."""
    M = len(params_list)
    T = max(p.feat_idx.shape[0] for p in params_list)
    D = max(p.feat_idx.shape[1] for p in params_list)
    if D > 24:
        raise ValueError(f"depth {D} > 24 breaks exact float32 leaf indexing")
    fi = np.zeros((M, T, D), np.int32)
    th = np.full((M, T, D), np.inf, np.float32)
    lv = np.zeros((M, T, 1 << D), np.float32)
    n_trees = np.empty(M, np.int32)
    for m, p in enumerate(params_list):
        t, d = p.feat_idx.shape
        fi[m, :t, :d] = p.feat_idx
        th[m, :t, :d] = p.thresholds
        lv[m, :t][:, np.arange(1 << d) << (D - d)] = p.leaves
        n_trees[m] = t
    return PackedForests(fi, th, lv, n_trees)


# Flush-to-flush the broker scores the same model set, so the padded blocks
# (and their device copies) are cached by model identity (strong refs in the
# value keep the id()s from being recycled while an entry is alive).  Flushes
# can run concurrently from independent brokers, so mutation is locked.
_PACK_CACHE: dict[tuple, tuple[list, PackedForests]] = {}
_PACK_CACHE_MAX = 32
_PACK_LOCK = threading.Lock()


def _packed_for(params_list) -> PackedForests:
    key = tuple(id(p) for p in params_list)
    with _PACK_LOCK:
        hit = _PACK_CACHE.get(key)
        if hit is not None and all(a is b for a, b in
                                   zip(hit[0], params_list)):
            return hit[1]
    packed = pack_forests(params_list)
    with _PACK_LOCK:
        if len(_PACK_CACHE) >= _PACK_CACHE_MAX:
            _PACK_CACHE.pop(next(iter(_PACK_CACHE)), None)
        _PACK_CACHE[key] = (list(params_list), packed)
    return packed


def _leaf_votes_blockdiag(packed: PackedForests, x: np.ndarray,
                          seg_ids: np.ndarray) -> np.ndarray:
    """Per-(row, tree) leaf values where row r reads ONLY model seg_ids[r]'s
    block: (R, T) float32, bit-identical to ``_leaf_votes_np`` on r's own
    model."""
    M, T, D = packed.feat_idx.shape
    L = packed.leaves.shape[2]
    R = x.shape[0]
    fi = packed.feat_idx.reshape(M, T * D)
    th = packed.thresholds.reshape(M, T * D)
    g = np.take_along_axis(x, fi[seg_ids], axis=1)              # (R, T*D)
    bits = g > th[seg_ids]
    weights = (1 << np.arange(D - 1, -1, -1)).astype(np.float32)
    leaf_idx = (bits.reshape(R * T, D).astype(np.float32) @ weights) \
        .astype(np.intp).reshape(R, T)
    flat = (seg_ids[:, None] * T + np.arange(T)[None, :]) * L + leaf_idx
    return packed.leaves.reshape(-1).take(flat)


def _check_width(owner, n_features: int):
    """The kernels gather x[:, feat_idx] unchecked: validate on the host.
    ``owner`` (a ForestParams or PackedForests) keeps the feature counts its
    ``feat_idx`` array passed, so a decision does not recompute the max."""
    feat_idx = owner.feat_idx
    passed = owner.__dict__.setdefault("_width_checked", {})
    if passed.get(n_features) is feat_idx:
        return
    if feat_idx.size and int(feat_idx.max()) >= n_features:
        raise ValueError(f"forest tests feature {int(feat_idx.max())} but "
                         f"rows have {n_features} features")
    passed[n_features] = feat_idx


def _rows_on(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def _capacity(n: int) -> int:
    """Buffer size for n words: the next power of two, at least 1024."""
    return max(1024, 1 << max(n - 1, 0).bit_length())


_VIEWS_MAX = 256        # shapes whose staging views one thread keeps


class _Views(NamedTuple):
    """The staging buffers cut to one call's shape."""
    rows: np.ndarray        # (R, F) pinned host rows, filled by the caller
    offsets: np.ndarray     # (M+1,) int32 pinned host segment offsets
    x: torch.Tensor         # (R, F) device rows
    seg_start: torch.Tensor  # (M+1,) int32 device offsets
    out: torch.Tensor       # (R,) device scores
    host: tuple             # (pinned input words, pinned scores)
    scores: np.ndarray      # (R,) the pinned scores, read after the call


class _Staging:
    """One thread's reused scoring buffers on one CUDA device: a pinned host
    input (rows, then the grouped path's int32 offsets), its device copy, a
    device output and a pinned host output, each grown by powers of two.

    A call fills ``rows`` (and ``offsets``) and passes ``x``, ``out`` and
    ``host`` to the kernel, whose C entry point copies the input to the
    card, launches into the device output and copies the scores back, all
    on one stream, and synchronises once (``kernels.forest.forest_infer``'s
    ``host``); the caller then copies ``scores``, which the next call
    overwrites.  Views are kept by shape, since the scheduler scores the
    same few shapes again and again."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host_in = self.dev_in = self.dev_out = self.host_out = None
        self.views: dict = {}

    def _grow(self, n_in: int, n_out: int):
        if self.host_in is None or self.host_in.numel() < n_in:
            cap = _capacity(n_in)
            self.host_in = torch.empty(cap, dtype=torch.float32,
                                       pin_memory=True)
            self.dev_in = torch.empty(cap, dtype=torch.float32,
                                      device=self.device)
            self.views.clear()
        if self.dev_out is None or self.dev_out.numel() < n_out:
            cap = _capacity(n_out)
            self.dev_out = torch.empty(cap, dtype=torch.float32,
                                       device=self.device)
            self.host_out = torch.empty(cap, dtype=torch.float32,
                                        pin_memory=True)
            self.views.clear()

    def views_for(self, rows: int, width: int, n_offsets: int = 0) -> _Views:
        """The buffers cut to ``rows`` rows of ``width`` features and
        ``n_offsets`` int32 offsets after them."""
        key = (rows, width, n_offsets)
        hit = self.views.get(key)
        if hit is None:
            n_x, n_in = rows * width, rows * width + n_offsets
            self._grow(n_in, rows)
            if len(self.views) >= _VIEWS_MAX:     # flush sizes vary widely
                self.views.clear()
            host = self.host_in.numpy()
            hit = self.views[key] = _Views(
                rows=host[:n_x].reshape(rows, width),
                offsets=host[n_x:n_in].view(np.int32),
                x=self.dev_in[:n_x].view(rows, width),
                seg_start=self.dev_in[n_x:n_in].view(torch.int32),
                out=self.dev_out[:rows],
                host=(self.host_in[:n_in], self.host_out[:rows]),
                scores=self.host_out.numpy()[:rows])
        return hit


_STAGING = threading.local()


def _staging(device: torch.device) -> _Staging:
    """This thread's buffers on ``device`` (the broker scores from client
    threads; a buffer must not change while its copies are in flight)."""
    per_device = _STAGING.__dict__.setdefault("by_device", {})
    st = per_device.get(device)
    if st is None:
        st = per_device[device] = _Staging(device)
    return st


def warm_up(device) -> None:
    """Ready the calling thread for its first scoring call on ``device``
    without launching a kernel: on the card, build (or load) the kernel
    library and allocate this thread's pinned staging buffers.  A serving
    thread calls it before it takes requests, so that no request waits on
    the build or the first pinned allocation; the launch counts do not
    move."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return
    from repro_torch.kernels import _build
    _build.load()
    _staging(dev)._grow(1, 1)


def forest_predict_grouped(groups, *, impl: str | None = None,
                           device=None) -> tuple[list, int]:
    """One block-diagonal inference pass over many (ForestParams, X) groups.

    Rows are stacked segment-by-segment (one segment per distinct model), the
    models' tree blocks are packed into one padded tensor (``pack_forests``),
    and each row is scored against ONLY its own segment's block.  Each row's
    probability is bit-identical to ``forest_predict_np(its_params,
    its_rows)`` regardless of which other groups share the flush, on every
    path.

    Returns ``(outs, n_passes)``: one score array per group and the number of
    fused passes issued (one for the whole flush).  Groups that reference the
    *same* ForestParams object share one segment.

    impl: None (the grouped CUDA kernel on the card, its plain torch version
    on the CPU), "numpy" (the numpy block-diagonal pass, no device), or
    "cuda"/"torch" to force a path on ``device``."""
    outs: list = [None] * len(groups)
    by_params: dict[int, list[int]] = {}      # id(params) -> group indices
    params_of: dict[int, ForestParams] = {}
    counts: dict[int, int] = {}
    order: list[int] = []                     # pids in first-appearance order
    total = 0
    for i, (params, X) in enumerate(groups):
        if X.shape[0] == 0:
            outs[i] = np.zeros(0, np.float32)
            continue
        pid = id(params)
        if pid not in by_params:
            by_params[pid] = []
            params_of[pid] = params
            counts[pid] = 0
            order.append(pid)
        by_params[pid].append(i)
        counts[pid] += X.shape[0]
        total += X.shape[0]
    if not total:
        return outs, 0

    # columnar row assembly: one block, segments contiguous (on the card
    # straight into the pinned staging buffer)
    first = groups[by_params[order[0]][0]][1]
    width = first.shape[1]
    group_span: list = [None] * len(groups)
    seg_start: dict[int, int] = {}
    staged = None
    if impl != "numpy":
        dev = resolve_device(device)
        packed = _packed_for([params_of[p] for p in order])
        _check_width(packed, width)
        if dev.type == "cuda" and impl != "torch":
            staged = _staging(dev).views_for(total, width, len(order) + 1)
            x, offsets = staged.rows, staged.offsets
    if staged is None and len(by_params) == 1 \
            and len(by_params[order[0]]) == 1:
        # one model, one row block (e.g. a broker column view): use it as-is
        i = by_params[order[0]][0]
        x = np.ascontiguousarray(first, np.float32)
        group_span[i] = (0, total)
        seg_start[order[0]] = 0
    else:
        if staged is None:
            x = np.empty((total, width), np.float32)
        pos = 0
        for pid in order:
            seg_start[pid] = pos
            for i in by_params[pid]:
                b = groups[i][1].shape[0]
                x[pos:pos + b] = groups[i][1]
                group_span[i] = (pos, pos + b)
                pos += b

    if impl != "numpy":
        if staged is None:
            offsets = np.empty(len(order) + 1, np.int32)
        offsets[0] = 0
        np.cumsum([counts[p] for p in order], out=offsets[1:])
        model = packed.on(dev)
        if staged is not None:
            ops.forest_infer_grouped(staged.x, staged.seg_start, *model,
                                     impl=impl, out=staged.out,
                                     host=staged.host)
            scores = staged.scores.copy()
        else:
            scores = ops.forest_infer_grouped(
                _rows_on(x, dev), torch.from_numpy(offsets).to(dev), *model,
                impl=impl).cpu().numpy()
        for i, span in enumerate(group_span):
            if span is not None:
                outs[i] = scores[span[0]:span[1]]
        return outs, 1

    if len(order) == 1:
        # single model: the numpy mirror (shared tree block over the
        # stacked rows) — same arithmetic, no per-row index plumbing
        p = params_of[order[0]]
        votes = _leaf_votes_np(p.feat_idx, p.thresholds, p.leaves, x)
        means = {order[0]: _mean_over_trees(votes)}
    else:
        packed = _packed_for([params_of[p] for p in order])
        seg_ids = np.repeat(np.arange(len(order), dtype=np.intp),
                            [counts[p] for p in order])
        votes = _leaf_votes_blockdiag(packed, x, seg_ids)      # (R, T_pad)
        means = {}
        for pid in order:
            s = seg_start[pid]
            t = params_of[pid].feat_idx.shape[0]
            # fixed-order mean over the model's TRUE tree count: the padded
            # tail never enters the accumulation
            means[pid] = _mean_over_trees(votes[s:s + counts[pid], :t])
    for pid in order:
        s = seg_start[pid]
        block = means[pid]
        for i in by_params[pid]:
            gs, ge = group_span[i]
            outs[i] = block[gs - s:ge - s]
    return outs, 1


def forest_predict(params: ForestParams, X: np.ndarray, *,
                   impl: str | None = None, tree_slice: slice | None = None,
                   device=None) -> np.ndarray:
    """Mean leaf value over trees — a probability for {0,1} targets.

    impl=None scores on ``device`` at every batch size: the CUDA kernel on
    the card, its plain torch version on the CPU.  "numpy" takes the numpy
    mirror; "cuda"/"torch" force a path.  All are bitwise equal.  On the
    card the rows go through this thread's staging buffers (one copy each
    way, one synchronisation) unless ``impl="torch"``; the result is a new
    array either way.  ``tree_slice`` scores only those trees (a sliced
    model is a new object, so its device copy is not cached)."""
    if impl == "numpy":
        return forest_predict_np(params, X, tree_slice)
    params = _sliced(params, tree_slice)
    dev = resolve_device(device)
    _check_width(params, X.shape[1])
    model = params.on(dev)
    if dev.type != "cuda" or impl == "torch":
        return ops.forest_infer(_rows_on(X, dev), *model,
                                impl=impl).cpu().numpy()
    staged = _staging(dev).views_for(*X.shape)
    staged.rows[...] = X
    ops.forest_infer(staged.x, *model, impl=impl, out=staged.out,
                     host=staged.host)
    return staged.scores.copy()
