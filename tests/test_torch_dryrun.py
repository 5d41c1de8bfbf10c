"""The port's cost count and dry run (``launch/cost.py``,
``launch/dryrun.py``, the meta path of ``kernels/ops.py``): hand-checked
counts, the kernels' work formulas against the bounds PERF.md records, and
the count of whole steps against the reference's compiled HLO
(``repro.launch.hlo_cost.analyze``).

The reference compiles in a subprocess with 8 forced host devices (the
device count is fixed at JAX's first initialisation), its (4, 2) mesh of
``AxisType.Auto`` axes: under jax 0.9 ``jax.make_mesh`` makes ``Explicit``
axes, which the reference's ``ShardCtx.constrain`` refuses
(``with_sharding_constraint`` takes only Auto axes), so
``tests/test_dryrun_integration.py``'s own mesh fails there.

Where the port's count and the reference's differ, the difference is
accounted for op by op below and then held exactly."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, get_arch, smoke_reduce
from repro_torch.kernels import ops, ref
from repro_torch.launch import cost, dryrun, specs
from repro_torch.launch.mesh import Mesh, one_card_mesh
from repro_torch.models.layers import ShardCtx
from repro_torch.models.registry import get_model
from repro_torch.models.steps import (abstract_train_state, init_train_state,
                                      make_decode_step, make_prefill_step,
                                      make_train_step)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMOKE_ARCHS = ("stablelm-1.6b", "rwkv6-1.6b", "deepseek-moe-16b")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------- by hand

def test_one_matmul_counts_exactly():
    M, K, N = 64, 32, 48
    got = cost.count(torch.matmul, _meta(M, K), _meta(K, N))
    assert got["flops"] == 2 * M * K * N
    assert got["traffic_bytes"] >= 4 * (M * K + K * N + M * N)
    assert got["outputs"].shape == (M, N) and got["outputs"].is_meta


def test_batched_matmul_and_a_loop_of_layers():
    B, M, K, N = 4, 16, 32, 24
    got = cost.count(lambda a, b: torch.einsum("bmk,bkn->bmn", a, b),
                     _meta(B, M, K), _meta(B, K, N))
    assert got["flops"] == 2 * B * M * K * N

    L, D = 10, 64

    def layers(x, w):
        for _ in range(L):
            x = torch.tanh(x @ w)
        return x
    one = cost.count(lambda x, w: torch.tanh(x @ w), _meta(D, D),
                     _meta(D, D))
    many = cost.count(layers, _meta(D, D), _meta(D, D))
    for key in ("flops", "traffic_bytes", "transcendentals"):
        assert many[key] == L * one[key], key
    assert one["transcendentals"] == D * D
    assert many["traffic_bytes"] >= L * 4 * (3 * D * D)


def test_temp_bytes_is_the_peak_of_live_allocations():
    x = torch.ones(1000)
    got = cost.count(lambda t: (t * 2) + 1, x)
    assert got["temp_bytes"] == 8000       # t * 2 and the sum, both live
    got = cost.count(lambda t: (t * 2) + 1, _meta(1000))
    assert got["temp_bytes"] == 8000
    # an in-place update of an argument allocates nothing
    assert cost.count(lambda t: t.add_(1), _meta(1000))["temp_bytes"] == 0


def test_causal_flash_counts_visible_pairs_and_launches_nothing():
    B, S, H, D = 2, 100, 4, 32
    q = _meta(B, S, H, D, dtype=torch.bfloat16)
    k = v = _meta(B, S, 2, D, dtype=torch.bfloat16)
    before = ops.launch_counts()
    got = cost.count(lambda q, k, v: ops.flash_attention(q, k, v), q, k, v)
    assert ops.launch_counts() == before
    rec = got["kernels"]["flash_attention"]
    assert rec["launches"] == 1 and not rec["refused"]
    assert rec["flops"] == got["flops"] == 4 * D * H * B * S * (S + 1) // 2
    assert got["outputs"].shape == q.shape and got["outputs"].is_meta
    nbytes, flops, dt = cost.flash_work(B, S, S, H, 2, D, True, 0,
                                        "bfloat16")
    assert rec["bound_ms"] == cost.bound_ms(nbytes, flops, dt)[0]
    # a window of 16 keys
    got = cost.count(lambda q, k, v: ops.flash_attention(q, k, v, window=16),
                     q, k, v)
    pairs = sum(min(i + 1, 16) for i in range(S))
    assert got["flops"] == 4 * D * H * B * pairs


def test_kernel_on_meta_outside_the_mode_raises():
    q = k = v = _meta(1, 8, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.rwkv6_scan(*(_meta(1, 8, 2, 16),) * 4, _meta(2, 16),
                       _meta(1, 2, 16, 16), impl="cuda")
    # impl None on meta outside the mode is the plain version
    assert ops.flash_attention(q, k, v).shape == q.shape


def test_kernel_refusal_is_recorded_not_raised():
    """A head_dim the attention kernels do not take (48): counted, with the
    launcher's own message."""
    q = k = v = _meta(1, 64, 2, 48, dtype=torch.bfloat16)
    got = cost.count(lambda q, k, v: ops.flash_attention(q, k, v), q, k, v)
    rec = got["kernels"]["flash_attention"]
    assert rec["launches"] == 1
    assert rec["refused"] == [
        "head_dim must be one of (32, 64, 128, 160), got 48"]
    assert got["outputs"].shape == q.shape


def test_decode_and_scans_count_their_work_formulas():
    B, Smax, H, Hkv, D = 3, 50, 8, 2, 64
    got = cost.count(
        lambda q, k, v, n: ops.decode_attention(q, k, v, n, window=20),
        _meta(B, 1, H, D), _meta(B, Smax, Hkv, D), _meta(B, Smax, Hkv, D),
        _meta(B, dtype=torch.int32))
    # on meta the cache is full: kv_len = Smax for every sequence
    assert got["kernels"]["decode_attention"]["flops"] == \
        cost.decode_work(B, Smax, H, Hkv, D, 20, [Smax] * B, "float32")[1] \
        == 4 * D * H * B * 20
    r = _meta(2, 64, 4, 16, dtype=torch.bfloat16)
    got = cost.count(lambda *a: ops.rwkv6_scan(*a), r, r, r, r,
                     _meta(4, 16, dtype=torch.bfloat16), _meta(2, 4, 16, 16))
    assert got["kernels"]["rwkv6_scan"]["flops"] == \
        cost.RWKV_OPS_PER_ELEMENT * 2 * 64 * 4 * 16 * 16
    x = _meta(2, 64, 4, 16, dtype=torch.bfloat16)
    got = cost.count(lambda *a: ops.mamba2_ssd(*a), x,
                     _meta(2, 64, 4, dtype=torch.bfloat16), _meta(4),
                     _meta(2, 64, 16, dtype=torch.bfloat16),
                     _meta(2, 64, 16, dtype=torch.bfloat16),
                     _meta(2, 4, 16, 16))
    assert got["kernels"]["mamba2_ssd"]["flops"] == \
        cost.ssd_chunked_flop(2, 64, 4, 16, 16)


@pytest.mark.parametrize("scan", ["rwkv6", "ssd"])
def test_meta_adjoint_repeat_counts_every_chunk_and_step(scan):
    """On meta the chunked adjoints run one chunk (and one step of each
    per-step loop) counted for all (cost.repeat); on the CPU they run every
    one: the counts are equal."""
    rng = np.random.RandomState(0)
    B, S, H, K = 1, 256, 2, 16              # two chunks of 128

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32),
                            requires_grad=True)
    if scan == "rwkv6":
        args = [t(B, S, H, K) for _ in range(3)] + \
            [torch.tensor(rng.uniform(0.5, 0.99, (B, S, H, K)).astype(
                np.float32), requires_grad=True), t(H, K), t(B, H, K, K)]
        fn = ref.rwkv6_scan_chunked
    else:
        args = [t(B, S, H, K), t(B, S, H).abs().detach().requires_grad_(),
                (-t(H).abs()).detach().requires_grad_(), t(B, S, 8),
                t(B, S, 8), t(B, H, K, 8)]
        fn = ref.mamba2_ssd_chunked

    def step(*a):
        y, st = fn(*a)
        return torch.autograd.grad((y.sum() + st.sum()), a)
    cpu = cost.count(step, *args)
    meta = cost.count(step, *(a.detach().to("meta").requires_grad_()
                              for a in args))
    for key in ("flops", "traffic_bytes", "transcendentals"):
        assert meta[key] == cpu[key], key
    assert all(g.shape == a.shape for g, a in zip(meta["outputs"], args))


def test_formulas_reproduce_the_recorded_bounds():
    """PERF.md's kernel table: flash at nemo's shape 0.0348 ms (34.4 GFLOP
    at 989 TFLOP/s), decode 0.00534 ms (17.8 MB), rwkv6 0.0561 ms and the
    bf16 SSD 0.0230 ms."""
    work = cost.flash_work(4, 1024, 1024, 32, 8, 128, True, 0, "bfloat16")
    assert round(work[1] / 1e9, 1) == 34.4
    assert cost.bound_ms(*work) == (pytest.approx(0.0348, abs=5e-5),
                                    "operations")
    work = cost.decode_work(4, 1088, 32, 8, 128, 0, (1088,) * 4, "bfloat16")
    assert round(work[0] / 1e6, 1) == 17.9 and work[0] // 100_000 == 178
    assert cost.bound_ms(*work) == (pytest.approx(0.00534, abs=5e-6),
                                    "bytes")
    assert cost.bound_ms(*cost.rwkv6_work(4, 1024, 32, 64, "bfloat16")) == \
        (pytest.approx(0.0561, abs=5e-5), "operations")
    assert cost.bound_ms(*cost.ssd_work(4, 1024, 64, 64, 64, "bfloat16")) == \
        (pytest.approx(0.0230, abs=5e-5), "bytes")
    assert cost.visible_pairs(1024, 1024, True, 0) == 1024 * 1025 // 2
    assert cost.visible_pairs(8, 4, False, 0) == 32   # cross: every pair


# ---------------------------------------------------------------- steps

_REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json
import jax, jax.numpy as jnp
from repro.configs import get_arch, smoke_reduce, SHAPES
from repro.launch import hlo_cost
from repro.launch.specs import build_cell
from repro.models.registry import get_model
from repro.models.steps import (abstract_train_state, make_decode_step,
                                make_prefill_step, make_train_step)
out = {}
arch = dataclasses.replace(smoke_reduce(get_arch("stablelm-1.6b")),
                           accum_steps=2)
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=128, global_batch=8)
mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
with mesh:
    cell = build_cell(arch, shape, mesh)
    c = jax.jit(cell["fn"], in_shardings=cell["in_shardings"],
                out_shardings=cell["out_shardings"],
                donate_argnums=cell["donate_argnums"]) \
        .lower(*cell["args"]).compile()
    out["argument_bytes_4x2"] = c.memory_analysis().argument_size_in_bytes
step, opt = make_train_step(arch)
c = jax.jit(step).lower(abstract_train_state(arch, opt), {
    "tokens": jax.ShapeDtypeStruct((8, 128), jnp.int32)}).compile()
out["train"] = hlo_cost.analyze(c.as_text())["flops"]
sds = jax.ShapeDtypeStruct
for aid in ARCHS:
    a = smoke_reduce(get_arch(aid))
    m = get_model(a)
    p = m.abstract_params()
    c = jax.jit(make_prefill_step(a)).lower(
        p, {"tokens": sds((2, 32), jnp.int32)}).compile()
    out[aid + "/prefill"] = hlo_cost.analyze(c.as_text())["flops"]
    c = jax.jit(make_decode_step(a)).lower(
        p, m.cache_struct(2, 32), sds((2, 1), jnp.int32),
        sds((2,), jnp.int32)).compile()
    out[aid + "/decode"] = hlo_cost.analyze(c.as_text())["flops"]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", f"ARCHS = {SMOKE_ARCHS!r}\n" + _REFERENCE],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _train_cell():
    arch = dataclasses.replace(smoke_reduce(get_arch("stablelm-1.6b")),
                               accum_steps=2)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=128,
                                global_batch=8)
    return arch, shape


def test_train_step_against_reference_hlo(reference):
    """The smoke stablelm-1.6b train step (accum 2, 8 x 128 tokens) on one
    device, counted with the plain versions (ShardCtx(impl="torch")),
    against hlo_cost.analyze of the reference's compiled step:
    5,632,950,272 against 5,499,781,120 FLOP (+2.4 %).  Op by op the
    products agree (attention: 8 of 2 S Skv D H b FLOP a call in both,
    the forward's QK and PV, their recomputation in the backward, by the
    reference's ``jax.checkpoint`` blocks and the port's attention
    Function, and the backward's four; the projections, MLPs and their
    gradients alike) but for the LM head: the port recomputes each
    cross-entropy chunk's logits in the backward (torch.utils.checkpoint),
    where XLA's CSE merges the reference's ``jax.checkpoint``
    recomputation with the forward when nothing forces the remat.  That is one (B/A)(S-1) x D x V product per microbatch:
    2 x 2 * 4 * 127 * 128 * 512 = 133,169,152 FLOP, the whole gap, held
    exactly.  Through the kernels (impl None on meta) the flash forward
    counts only the causal pairs, 8 launches of 4 D H b S(S+1)/2 in place
    of the plain version's 4 D H b S S, held exactly too."""
    arch, shape = _train_cell()
    B, S, A = shape.global_batch, shape.seq_len, arch.accum_steps
    tokens = _meta(B, S, dtype=torch.int32)
    counts = {}
    for impl in ("torch", None):
        step, opt = make_train_step(arch, None, ShardCtx(impl=impl))
        counts[impl] = cost.count(step, abstract_train_state(arch, opt),
                                  {"tokens": tokens})
    head = A * 2 * (B // A) * (S - 1) * arch.d_model * arch.vocab_size
    assert head == 133_169_152
    assert counts["torch"]["flops"] == reference["train"] + head
    assert reference["train"] == 5_499_781_120
    flash = counts[None]["kernels"]["flash_attention"]
    H, D, b = arch.n_heads, arch.resolved_head_dim, B // A
    assert flash["launches"] == arch.n_layers * A
    plain_fwd = flash["launches"] * 4 * D * H * b * S * S
    assert flash["flops"] == flash["launches"] * 4 * D * H * b * \
        S * (S + 1) // 2
    assert counts[None]["flops"] == counts["torch"]["flops"] \
        - plain_fwd + flash["flops"]


def test_train_cell_argument_bytes_equal_reference(reference):
    """Per-device argument bytes of the same cell on a (4, 2) mesh, from
    the port's shardings: the reference's compiled
    argument_size_in_bytes."""
    arch, shape = _train_cell()
    cell = specs.build_cell(arch, shape, Mesh(("data", "model"), (4, 2)))
    assert dryrun.sharded_bytes(cell["args"], cell["in_shardings"]) == \
        reference["argument_bytes_4x2"] == 4_733_448
    assert dryrun.sharded_bytes(cell["args"], cell["in_shardings"], {0}) \
        == dryrun.sharded_bytes(cell["args"][:1], cell["in_shardings"][:1])


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch_id", SMOKE_ARCHS)
def test_prefill_and_decode_against_reference_hlo(reference, arch_id, kind):
    """A dense, an ssm and a moe smoke arch's prefill (2 x 32 tokens) and
    decode step (a cache of 32) with the plain versions: equal to the
    reference's FLOPs exactly (no recomputation outside training)."""
    arch = smoke_reduce(get_arch(arch_id))
    model = get_model(arch)
    params = model.abstract_params()
    ctx = ShardCtx(impl="torch")
    if kind == "prefill":
        got = cost.count(make_prefill_step(arch, ctx), params,
                         {"tokens": _meta(2, 32, dtype=torch.int32)})
    else:
        got = cost.count(make_decode_step(arch, ctx), params,
                         model.cache_struct(2, 32),
                         _meta(2, 1, dtype=torch.int32),
                         _meta(2, dtype=torch.int32))
    assert got["flops"] == reference[f"{arch_id}/{kind}"]


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_meta_count_equals_cpu_count(kind):
    """The same plain step on meta and on real CPU tensors counts the same
    FLOPs, bytes, transcendentals and peak of temporaries; the train step
    (accum 2) on meta runs one microbatch counted twice (cost.repeat), on
    the CPU both."""
    arch = dataclasses.replace(smoke_reduce(get_arch("stablelm-1.6b")),
                               accum_steps=2)
    model = get_model(arch)
    tokens = torch.tensor(np.random.RandomState(0).randint(
        0, arch.vocab_size, (4, 32)), dtype=torch.int32)
    if kind == "prefill":
        step = make_prefill_step(arch, ShardCtx(impl="torch"))
        real, abstract = model.init(0, device="cpu"), model.abstract_params()
    else:
        step, opt = make_train_step(arch, None, ShardCtx(impl="torch"))
        real = init_train_state(arch, 0, opt, device="cpu")
        abstract = abstract_train_state(arch, opt)
    cpu = cost.count(step, real, {"tokens": tokens})
    meta = cost.count(step, abstract, {"tokens": tokens.to("meta")})
    for key in ("flops", "traffic_bytes", "transcendentals", "temp_bytes"):
        assert meta[key] == cpu[key], key
    assert all(bool(torch.isfinite(t).all()) for t in
               cost.tensors(cpu["outputs"]) if t.is_floating_point())


# ---------------------------------------------------------------- run_cell

def test_run_cell_records(tmp_path):
    rec = dryrun.run_cell("rwkv6-1.6b", "long_500k", out_dir=tmp_path,
                          verbose=False)
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["n_groups"] == 16 and rec["collectives"] is None
    m = rec["memory"]
    assert m["fits_one_h100"] and m["argument_bytes"] > 0
    assert m["one_device_argument_bytes"] >= m["argument_bytes"]
    assert rec["cost"]["kernels"]["rwkv6_scan"]["launches"] == 0   # decode
    on_disk = json.loads((tmp_path / "rwkv6-1.6b__long_500k__pod16x16.json")
                         .read_text())
    assert on_disk == json.loads(json.dumps(rec))
    # reused unless forced
    assert dryrun.run_cell("rwkv6-1.6b", "long_500k", out_dir=tmp_path) == \
        on_disk
    skip = dryrun.run_cell("stablelm-1.6b", "long_500k", multi_pod=True,
                           out_dir=tmp_path)
    from repro.configs import SHAPES as R_SHAPES, cell_supported, get_arch as g
    assert skip == {"arch": "stablelm-1.6b", "shape": "long_500k",
                    "mesh": "pod2x16x16", "status": "skipped",
                    "reason": cell_supported(g("stablelm-1.6b"),
                                             R_SHAPES["long_500k"])[1]}


def test_one_card_train_cell_counts_the_whole_step():
    """On h100x1 a train cell keeps the config's microbatches (n_groups =
    1): the kernels' launches are layers x accum_steps."""
    arch, shape = _train_cell()
    cell, counted = dryrun.trace_cell(arch, shape, one_card_mesh())
    assert counted["kernels"]["flash_attention"]["launches"] == \
        arch.n_layers * arch.accum_steps
    mem = dryrun.memory_record(cell, counted)
    assert mem["argument_bytes"] == mem["one_device_argument_bytes"] == \
        cost.tree_bytes(cell["args"])
    assert mem["alias_bytes"] == cost.tree_bytes(cell["args"][0])
    assert 0 < mem["temp_bytes"] and mem["fits_one_h100"]
