"""Plain torch versions of the port's kernels.

They serve CPU tensors, and on the card they are the oracle that
``chip_smoke.py`` holds each CUDA kernel against.  The arithmetic is the
kernels' own, step for step, so both are bitwise equal to the numpy mirror
``ml.forest.forest_predict_np``:

- the same float32 compare ``x > threshold``;
- an exact integer leaf index, level 0 the most significant bit;
- the leaf values summed strictly in tree order in float32;
- one IEEE division by the float32 tree count.

The last two differ on purpose from the JAX oracle's ``vals.mean(axis=1)``
(``repro/kernels/ref.py``), whose reduction order depends on the shape."""

from __future__ import annotations

import torch


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
