"""The port's int8 error-feedback compression (``optim/compression.py``)
against the JAX package on the CPU.

(a) tests/test_runtime.py's three compression cases on the port, with
their tolerances: the round trip's error within half a block's scale
(+1e-6) and the residual equal to g - dequantised(g) (rtol 1e-5, atol
1e-6); error feedback's time average within rtol 0.05 / atol 0.02 of the
true gradient over 50 steps; compressed_psum on one process within rtol
1e-2 of g.
(b) ``compress`` equal to the reference's on the same inputs, exactly: the
int8 values, the float16 scales and the residual, for float32 and bf16
gradients, a ragged last block, an all-zero block and values that round
half to even; ``decompress`` and ``compressed_psum`` (one process) equal
too; the residual of ``compressed_psum`` is equal but where the
reference's jit fuses a product the port rounds (named in the test).
(c) ``compressed_psum`` over a two-process gloo group sums the
dequantised gradients (each process's own error feedback).  The workers
run under ``torch.multiprocessing.spawn``."""

import datetime
import os
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.optim import compression as jcz
from repro_torch.optim import compression as cz


# ---------------------------------------------------------------------------
# (a) tests/test_runtime.py's cases
# ---------------------------------------------------------------------------

def test_compress_roundtrip_error_bounded():
    g = torch.randn(1000, generator=torch.Generator().manual_seed(0)) * 3.0
    q, scale, resid = cz.compress(g)
    deq = cz.decompress(q, scale, g.shape)
    err = (deq - g).abs().numpy()
    per_block_scale = np.repeat(scale.float().numpy(), cz.BLOCK)[:g.numel()]
    assert (err <= per_block_scale * 0.5 + 1e-6).all()
    np.testing.assert_allclose(resid.numpy(), (g - deq).numpy(), rtol=1e-5,
                               atol=1e-6)


def test_error_feedback_mean_converges():
    rs = np.random.RandomState(0)
    g_true = torch.as_tensor(rs.randn(512).astype(np.float32))
    resid = torch.zeros_like(g_true)
    total = torch.zeros_like(g_true)
    T = 50
    for _ in range(T):
        q, scale, resid = cz.compress(g_true + resid)
        total = total + cz.decompress(q, scale, g_true.shape)
    np.testing.assert_allclose((total / T).numpy(), g_true.numpy(),
                               rtol=0.05, atol=0.02)


def test_compressed_psum_single_process():
    g = torch.ones(300) * 0.5
    out, resid = cz.compressed_psum(g)
    np.testing.assert_allclose(out.numpy(), 0.5, rtol=1e-2)
    assert out.dtype == resid.dtype == torch.float32


# ---------------------------------------------------------------------------
# (b) equal to the reference
# ---------------------------------------------------------------------------

def _input(case):
    rs = np.random.RandomState(3)
    if case == "ragged":
        return (rs.randn(3, 5 * cz.BLOCK // 3 + 7) * 2.0).astype(np.float32)
    if case == "zero_block":
        g = rs.randn(4 * cz.BLOCK).astype(np.float32)
        g[cz.BLOCK:2 * cz.BLOCK] = 0.0
        return g
    if case == "half_to_even":
        # max |g| = 127 makes the scale 1.0: the halves round to even
        return np.concatenate([[127.0], np.arange(-6.5, 6.5, 0.5),
                               np.zeros(cz.BLOCK - 27)]).astype(np.float32)
    if case == "tiny":
        return (rs.randn(2 * cz.BLOCK) * 1e-9).astype(np.float32)
    return (rs.randn(6, 4, cz.BLOCK) * 0.01).astype(np.float32)


CASES = ("ragged", "zero_block", "half_to_even", "tiny", "stack")


def _equal(got, want):
    want = np.asarray(want)
    got = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    if want.dtype == jnp.bfloat16:
        want = want.astype(np.float32)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_compress_equals_reference(case, dtype):
    g = _input(case)
    jg = jnp.asarray(g).astype(dtype)
    tg = torch.as_tensor(g).to(getattr(torch, dtype))
    want, got = jcz.compress(jg), cz.compress(tg)
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.float16
    assert got[2].dtype == tg.dtype
    for a, b in zip(got, want):
        _equal(a, b)
    _equal(cz.decompress(*got[:2], tg.shape),
           jcz.decompress(*want[:2], jg.shape))
    if case == "half_to_even":
        assert got[0][0, 1:27].tolist() == np.round(
            np.arange(-6.5, 6.5, 0.5)).astype(int).tolist()


@pytest.mark.parametrize("case", CASES)
def test_compressed_psum_equals_reference(case):
    """On one process (a mesh of one device in the reference, under jit):
    three steps of error feedback, each step from the reference's residual.
    The summed gradient is equal.  The residual is equal but in blocks
    whose float16 scale rounds to 0 (the "tiny" case): there the scale is
    the float32 clamp 1e-12, q x scale is not exact, and XLA may fuse g - q
    x scale into one rounding (jax 0.9.0 on the CPU does) where the port,
    like the reference's eager ``compress``, rounds twice; there the port
    equals the two roundings and the reference one of the two forms,
    element for element."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    g = _input(case)
    mesh = jax.make_mesh((1,), ("x",))
    jstep = jax.jit(shard_map(lambda g, r: jcz.compressed_psum(g, "x", r),
                              mesh=mesh, in_specs=(P(), P()),
                              out_specs=(P(), P())))
    jr = np.zeros(g.shape, np.float32)
    for k in range(3):
        gk = (g * (1.0 + 0.25 * k)).astype(np.float32)
        jout, jr_new = (np.array(a) for a in jstep(jnp.asarray(gk),
                                                     jnp.asarray(jr)))
        tout, tr = cz.compressed_psum(torch.as_tensor(gk),
                                      resid=torch.as_tensor(jr))
        _equal(tout, jout)
        gin = (gk + jr).reshape(-1)
        q, scale, _ = cz.compress(torch.as_tensor(gin))
        clamped = np.repeat(scale.numpy() == 0, cz.BLOCK)[:gin.size]
        s32 = np.repeat(np.maximum(scale.float().numpy(), np.float32(1e-12)),
                        cz.BLOCK)[:gin.size]
        qf = q.reshape(-1)[:gin.size].float().numpy()
        fused = (gin.astype(np.float64) - qf.astype(np.float64)
                 * s32.astype(np.float64)).astype(np.float32)
        twice = gin - (qf * s32).astype(np.float32)
        got, want = tr.numpy().reshape(-1), jr_new.reshape(-1)
        assert tr.dtype == torch.float32
        assert np.array_equal(got[~clamped], want[~clamped])
        assert np.array_equal(got[clamped], twice[clamped])
        assert ((want[clamped] == fused[clamped])
                | (want[clamped] == twice[clamped])).all()
        jr = jr_new


# ---------------------------------------------------------------------------
# (c) two processes
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


PG_TIMEOUT_S = 120         # a dead peer fails the collective, not hangs
JOIN_DEADLINE_S = 300      # then the test fails instead of holding a worker


def _worker(rank, world, port, out_dir):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        g = torch.as_tensor(_input("ragged")) * (rank + 1)
        resid = None
        for _ in range(2):
            out, resid = cz.compressed_psum(g, resid=resid)
        torch.save({"out": out, "resid": resid},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_compressed_psum_sums_over_a_process_group(tmp_path):
    world = 2
    ctx = mp.start_processes(_worker, args=(world, _free_port(),
                                            str(tmp_path)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_DEADLINE_S
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, \
                f"ranks still running after {JOIN_DEADLINE_S} s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    res = [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]
    want = torch.zeros(_input("ragged").shape)
    for r in range(world):
        g = torch.as_tensor(_input("ragged")) * (r + 1)
        resid = None
        for _ in range(2):       # each process's own error feedback
            deq, resid = cz.compressed_psum(g, resid=resid)
        want_resid = resid
        assert torch.equal(res[r]["resid"], want_resid)
        want = want + deq
    for r in range(world):
        assert torch.equal(res[r]["out"], want)
