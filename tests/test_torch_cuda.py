"""The CUDA forest kernels on the card, against their plain torch versions
and the numpy mirror: bitwise.  Marked ``cuda``; without a GPU they skip.

    python -m pytest -q -m cuda tests/test_torch_cuda.py"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.ml import forest

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _forest(rs, T, D, F):
    return forest.ForestParams(
        feat_idx=rs.randint(0, F, (T, D)).astype(np.int32),
        thresholds=rs.randn(T, D).astype(np.float32),
        leaves=rs.randn(T, 1 << D).astype(np.float32))


@pytest.mark.parametrize("B,F,T,D", [
    (1, 22, 24, 5), (13, 22, 1, 6), (100, 32, 64, 6), (4096, 22, 24, 5),
])
def test_forest_infer_kernel_bitwise(dev, B, F, T, D):
    rs = np.random.RandomState(B)
    p = _forest(rs, T, D, F)
    x = rs.randn(B, F).astype(np.float32)
    args = (torch.from_numpy(x).to(dev), *p.on(dev))
    before = ops.launch_counts()["forest_infer"]
    got = ops.forest_infer(*args)
    assert ops.launch_counts()["forest_infer"] == before + 1
    assert torch.equal(got, ops.forest_infer(*args, impl="torch"))
    assert np.array_equal(got.cpu().numpy(), forest.forest_predict_np(p, x))


@pytest.mark.parametrize("sizes", [(1,), (0, 5, 0, 7), (2048, 2048),
                                   (65, 1, 5, 12)])
def test_forest_infer_grouped_kernel_bitwise(dev, sizes):
    rs = np.random.RandomState(len(sizes))
    shapes = [(24, 5), (8, 3), (16, 4), (1, 6)]
    models = [_forest(rs, *shapes[i % 4], 22) for i in range(len(sizes))]
    x = rs.randn(sum(sizes), 22).astype(np.float32)
    groups, at = [], 0
    for m, b in zip(models, sizes):
        groups.append((m, x[at:at + b]))
        at += b
    outs, passes = forest.forest_predict_grouped(groups, device=dev)
    assert passes == 1
    for (m, rows), out in zip(groups, outs):
        assert np.array_equal(out, forest.forest_predict_np(m, rows))
    packed = forest.pack_forests(models)
    offsets = np.zeros(len(sizes) + 1, np.int32)
    np.cumsum(sizes, out=offsets[1:])
    args = (torch.from_numpy(x).to(dev), torch.from_numpy(offsets).to(dev),
            *packed.on(dev))
    assert torch.equal(ops.forest_infer_grouped(*args, impl="cuda"),
                       ops.forest_infer_grouped(*args, impl="torch"))


def test_kernel_rejects_bad_input(dev):
    p = _forest(np.random.RandomState(0), 4, 3, 8)
    fi, th, lv = p.on(dev)
    x = torch.zeros((4, 8), device=dev)
    with pytest.raises(TypeError):
        ops.forest_infer(x.double(), fi, th, lv)
    with pytest.raises(ValueError):
        ops.forest_infer(x, fi, th, lv.cpu())
    with pytest.raises(ValueError):
        ops.forest_infer(x.t(), fi, th, lv)
