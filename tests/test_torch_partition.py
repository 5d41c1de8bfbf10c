"""The sharded step: ``build_cell``'s train, prefill and decode steps run
on a (data, model) = (2, 2) mesh through DTensor
(``parallel/partition.py:run_cell``, ``launch/mesh.py:device_mesh``,
``NamedSharding.placements``), held against the port's unsharded step and
the reference's sharded step.

Four processes are spawned once for the module over gloo, each with one
thread, a process-group timeout of PG_TIMEOUT_S and a join deadline of
JOIN_DEADLINE_S, so a dead rank fails the tests instead of holding the
worker; each task's failure is recorded as its traceback and fails its own
test.  They run:

- the train step of the four archs of ``tests/test_sharding.py:94`` under
  ``smoke_reduce`` (seq 64, batch 4, accum 1) from the port's seeded state,
  and for stablelm-1.6b and deepseek-moe-16b from the reference's
  ``PRNGKey(0)`` state, whose sharded loss the reference computes in a
  subprocess on its own (2, 2) mesh of 4 forced host devices with
  ``AxisType.Auto`` axes (jax 0.9's ``jax.make_mesh`` axes are
  ``Explicit``, which the reference's ``ShardCtx.constrain`` refuses);
- stablelm-1.6b's prefill and decode cells with ``kv_seq`` sharded over
  ``model`` (the decode merges two cache slices, some empty: ragged
  positions), from the reference's draw and from the draw with the
  attention fan-in of d_model (``_fan_in_d_model``);
- ``compressed_psum`` over the mesh's ``data`` group;
- a checkpoint saved from DTensors sharded over 4 ranks, then restored
  onto a mesh of 2 by a second group of 2 processes.

The reference's tolerance for a sharded step is rtol 5e-3, atol 5e-4
(``tests/test_sharding.py:127``).  The model axis cuts the contractions
over heads and the MLP's hidden width into partial sums, so sharded and
unsharded results differ by float32 rounding; under the reference's init
(ROADMAP section 3: its attention fan-in) the smoke model turns a 1e-7
relative change of one weight into ~2e-4 on prefill's logits, which
``test_sharded_prefill_matches_unsharded`` measures and holds the reference
draw to; the fan-in-fixed draw is held to 1e-4."""

import dataclasses
import json
import math
import os
import pathlib
import pickle
import socket
import subprocess
import sys
import time
import traceback
import types
import zipfile
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import SHAPES, get_arch, smoke_reduce
from repro_torch.launch import specs
from repro_torch.launch.mesh import Mesh, device_mesh, one_card_mesh
from repro_torch.models.registry import get_model
from repro_torch.models.steps import (init_train_state, make_decode_step,
                                      make_prefill_step, make_train_step)
from repro_torch.optim import adamw
from repro_torch.optim import compression as cz
from repro_torch.parallel.axes import (NamedSharding, PartitionSpec,
                                       logical_to_spec, tree_leaves_with_path)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
PG_TIMEOUT_S = 120
JOIN_DEADLINE_S = 480
MESH22 = Mesh(("data", "model"), (2, 2))
ARCHS = ("stablelm-1.6b", "deepseek-moe-16b", "rwkv6-1.6b", "zamba2-1.2b")
REF_ARCHS = ("stablelm-1.6b", "deepseek-moe-16b")
RTOL, ATOL = 5e-3, 5e-4             # tests/test_sharding.py:127
LOGIT_TOL = 1e-4
B, S = 4, 64
PROMPT = 40
POS = (40, 17, 33, 5)               # slice 1 of 2 is empty for the last two
DECODE_STEPS = 3
DRAWS = ("reference", "fan_in")
# the cross-attention families: whisper's frames (encdec.py's constrain)
# and the vlm's media, prefill and one decode step each
MEDIA_ARCHS = ("whisper-large-v3", "llama-3.2-vision-90b")
TREE_SEED = 7


def _arch(arch_id, remat=False):
    """The smoke config at accum 1; with ``remat`` every layer recomputed
    in the backward pass and the batch in 2 microbatches."""
    return dataclasses.replace(smoke_reduce(get_arch(arch_id)),
                               accum_steps=2 if remat else 1,
                               remat="full" if remat else "none")


def _shape(kind):
    name = {"train": "train_4k", "prefill": "prefill_32k",
            "decode": "decode_32k"}[kind]
    return dataclasses.replace(SHAPES[name], seq_len=S, global_batch=B)


def _opt():
    return adamw.AdamWConfig(warmup_steps=1, total_steps=4)


def _tokens(arch, seed, shape=(B, S)):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, arch.vocab_size, shape))


def _fan_in_d_model(cfg, params):
    """The attention projections rescaled from the reference's fan-in (the
    heads of wq/wk/wv, the head dim of wo) to that of all their input axes
    (chip_smoke.py's draw for training)."""
    attn = params["blocks"]["attn"]
    for name in ("wq", "wk", "wv"):
        attn[name].mul_((attn[name].shape[-2] / cfg.d_model) ** 0.5)
    attn["wo"].mul_(attn["wo"].shape[-3] ** -0.5)
    return params


def _serving(draw):
    arch = _arch("stablelm-1.6b")
    params = get_model(arch).init(0, device="cpu")
    if draw == "fan_in":
        _fan_in_d_model(arch, params)
    return arch, params


def _prompt_cache(arch, params):
    """The cache of a PROMPT-token prompt, padded to S (unsharded)."""
    prompt = _tokens(arch, 2, (B, PROMPT))
    logits, cache = make_prefill_step(arch)(params, {"tokens": prompt})
    # a full cache of S rows: the prompt's, then rows past it
    full = {k: torch.zeros(*v.shape[:2], S, *v.shape[3:], dtype=v.dtype)
            for k, v in cache.items()}
    for k in cache:
        full[k][:, :, :PROMPT] = cache[k]
    return torch.argmax(logits, -1).to(torch.int32)[:, None], full


def _media_case(arch_id):
    """(arch, params, prompt, media): the vlm's gates opened (they start
    at zero, which hides its cross blocks)."""
    arch = _arch(arch_id)
    model = get_model(arch)
    params = model.init(0, device="cpu")
    for name in ("gate_attn", "gate_mlp"):
        if "cross_blocks" in params:
            params["cross_blocks"][name].fill_(0.5)
    rng = np.random.default_rng(4)
    media = torch.from_numpy(rng.standard_normal(
        (B, *model.media_struct(B).shape[1:])).astype(np.float32))
    return arch, params, _tokens(arch, 5, (B, PROMPT)), media


def _media_steps(arch, params, prompt, media, step):
    """Prefill of the prompt (max_len S) and one decode step after it,
    each through ``step(kind, args)`` (the cell's step, or run_cell)."""
    from repro_torch.models.registry import family_module
    logits, cache = step("prefill", (params, {"tokens": prompt,
                                              "media": media}))
    _, full = family_module(arch).prefill(params, arch, prompt, media=media,
                                          max_len=S)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    pos = torch.full((B,), PROMPT, dtype=torch.int32)
    nxt, step_logits, _ = step("decode", (params, full, tok, pos))
    return {"prefill": logits, "next": nxt, "decode": step_logits}


def _tree():
    """The checkpointed tree: an even, an uneven bf16 and an int leaf."""
    rng = np.random.default_rng(TREE_SEED)
    return {"w": torch.arange(32, dtype=torch.float32).reshape(8, 4),
            "b": torch.from_numpy(rng.standard_normal((6, 3)).astype(
                np.float32)).to(torch.bfloat16),
            "n": torch.arange(5, dtype=torch.int32)}


# ---------------------------------------------------------------------------
# the spawned ranks
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(fn, world, *args):
    """Start ``fn(rank, world, port, *args)`` in ``world`` spawned
    processes; ``_join`` waits for them."""
    ctx = mp.start_processes(fn, args=(world, _free_port(), *args),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, time.monotonic() + JOIN_DEADLINE_S


def _join(spawned):
    """Wait for the spawned ranks; kill them all if they have not ended by
    the deadline."""
    ctx, deadline = spawned
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after "
                                   f"{JOIN_DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def _publish(out_dir, ref_states):
    """Hand the reference's states to the ranks (atomically)."""
    tmp = pathlib.Path(out_dir) / "ref_states.tmp"
    torch.save(ref_states, tmp)
    tmp.rename(pathlib.Path(out_dir) / "ref_states.pt")


def _ref_states(out_dir):
    """The reference's states once the test process has published them."""
    path = pathlib.Path(out_dir) / "ref_states.pt"
    deadline = time.monotonic() + JOIN_DEADLINE_S
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError("the reference's states never came")
        time.sleep(0.2)
    states = torch.load(path, weights_only=False)
    if states is None:
        raise RuntimeError("the reference's subprocess failed")
    return states


def _group(rank, world, port):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=PG_TIMEOUT_S))


def _run_tasks(path, tasks):
    results = {}
    for name, fn in tasks:
        try:
            results[name] = fn()
        except Exception:               # its test fails with this
            results[name] = {"error": traceback.format_exc()}
    torch.save(results, path)


def _task_train(arch_id, state, remat=False):
    from repro_torch.parallel.partition import gather_tree, run_cell
    arch = _arch(arch_id, remat)
    dm = device_mesh(MESH22, "cpu")
    cell = specs.build_cell(arch, _shape("train"), MESH22)
    if state is None:
        state = init_train_state(arch, 0, _opt(), device="cpu")
        tokens = _tokens(arch, 1)
    else:
        state, tokens = state
    new_state, metrics = gather_tree(run_cell(
        cell, dm, args=(state, {"tokens": tokens})))
    return {"params": new_state["params"],
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _local_bytes(dargs, shardings):
    """Each leaf's local bytes, its sharding's shard_bytes, global and
    local shapes."""
    out = []
    def tree(xs):
        return {str(i): x for i, x in enumerate(xs)}
    for (path, t), (_, sh) in zip(tree_leaves_with_path(tree(dargs)),
                                  tree_leaves_with_path(tree(shardings))):
        local = t.to_local()
        sh = sh or NamedSharding(MESH22, PartitionSpec())
        spec = tuple(sh.spec) + (None,) * (t.dim() - len(sh.spec))
        out.append({"path": "/".join(map(str, path)),
                    "shape": tuple(t.shape), "local": tuple(local.shape),
                    "split": tuple(math.prod(
                        MESH22.shape[a] for a in ((part,) if isinstance(
                            part, str) else part or ())) for part in spec),
                    "local_bytes": local.numel() * local.element_size(),
                    "shard_bytes": sh.shard_bytes(t),
                    "shard_shape": sh.shard_shape(t.shape)})
    return out


def _task_decode(draw):
    from repro_torch.parallel.partition import (distribute_tree, gather_tree,
                                                run_cell)
    arch, params = _serving(draw)
    dm = device_mesh(MESH22, "cpu")
    cell = specs.build_cell(arch, _shape("decode"), MESH22)
    tok, cache = _prompt_cache(arch, params)
    pos = torch.tensor(POS, dtype=torch.int32)
    args = distribute_tree((params, cache, tok, pos), cell["in_shardings"],
                           dm)
    record = _local_bytes(args, cell["in_shardings"])
    dparams, dcache = args[0], args[1]
    steps = []
    for i in range(DECODE_STEPS):
        nxt, logits, dcache = run_cell(cell, dm, args=(
            dparams, dcache, tok, pos + i))
        nxt, logits = gather_tree((nxt, logits))
        steps.append({"next": nxt, "logits": logits})
        tok = nxt[:, None]
    return {"steps": steps, "cache": gather_tree(dcache),
            "arg_bytes": record}


def _task_prefill(draw):
    from repro_torch.parallel.partition import gather_tree, run_cell
    arch, params = _serving(draw)
    dm = device_mesh(MESH22, "cpu")
    cell = specs.build_cell(arch, _shape("prefill"), MESH22)
    logits, cache = gather_tree(run_cell(
        cell, dm, args=(params, {"tokens": _tokens(arch, 3)})))
    return {"logits": logits, "cache": cache}


def _psum_input(rank):
    rng = np.random.default_rng(11)
    return torch.from_numpy(rng.standard_normal(1000).astype(
        np.float32)) * (rank + 1)


def _task_media(arch_id):
    from repro_torch.parallel.partition import gather_tree, run_cell
    arch, params, prompt, media = _media_case(arch_id)
    dm = device_mesh(MESH22, "cpu")
    cells = {k: specs.build_cell(arch, _shape(k), MESH22)
             for k in ("prefill", "decode")}
    return _media_steps(arch, params, prompt, media, lambda kind, args:
                        gather_tree(run_cell(cells[kind], dm, args=args)))


def _task_psum(rank):
    dm = device_mesh(MESH22, "cpu")
    resid = None
    for _ in range(2):
        out, resid = cz.compressed_psum(_psum_input(rank), dm, resid)
    return {"out": out, "resid": resid,
            "data_group": dist.get_process_group_ranks(
                dm.get_group("data"))}


def _task_save(out_dir):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.parallel.partition import distribute_tree
    mesh4 = Mesh(("data",), (4,))
    dm = device_mesh(mesh4, "cpu")
    row = NamedSharding(mesh4, PartitionSpec("data", None))
    tree = distribute_tree(_tree(), {"w": row, "b": row, "n": None}, dm)
    CheckpointManager(pathlib.Path(out_dir) / "ckpt",
                      async_write=False).save(1, tree)
    return {"local_w": tree["w"].to_local()}


def _main_worker(rank, world, port, out_dir):
    _group(rank, world, port)
    try:
        tasks = [(f"train/{a}", lambda a=a: _task_train(a, None))
                 for a in ARCHS]
        tasks += [("train_remat/stablelm-1.6b",
                   lambda: _task_train("stablelm-1.6b", None, remat=True))]
        tasks += [(f"decode/{d}", lambda d=d: _task_decode(d)) for d in DRAWS]
        tasks += [(f"prefill/{d}", lambda d=d: _task_prefill(d))
                  for d in DRAWS]
        tasks += [(f"media/{a}", lambda a=a: _task_media(a))
                  for a in MEDIA_ARCHS]
        tasks += [("psum", lambda: _task_psum(rank)),
                  ("save", lambda: _task_save(out_dir))]
        # last, so the reference's subprocess runs beside the tasks above
        tasks += [(f"train_ref/{a}", lambda a=a: _task_train(
            a, _ref_states(out_dir)[a])) for a in REF_ARCHS]
        _run_tasks(pathlib.Path(out_dir) / f"rank{rank}.pt", tasks)
    finally:
        dist.destroy_process_group()


def _restore_worker(rank, world, port, out_dir):
    _group(rank, world, port)
    try:
        def restore():
            from repro_torch.checkpoint import CheckpointManager
            from repro_torch.parallel.partition import gather_tree
            half = Mesh(("data",), (world,))
            row = NamedSharding(half, PartitionSpec("data", None))
            like = {k: torch.zeros_like(v) for k, v in _tree().items()}
            got = CheckpointManager(pathlib.Path(out_dir) / "ckpt",
                                    async_write=False).restore(
                1, like, shardings={"w": row, "b": row, "n": None})
            return {"local": {k: v.to_local() for k, v in got.items()},
                    "mesh_size": {k: v.device_mesh.size()
                                  for k, v in got.items()},
                    "whole": gather_tree(got)}
        _run_tasks(pathlib.Path(out_dir) / f"restore{rank}.pt",
                   [("restore", restore)])
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference's sharded step, in a subprocess
# ---------------------------------------------------------------------------

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, pickle
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_arch, smoke_reduce, SHAPES
from repro.launch.specs import build_cell
from repro.models.steps import init_train_state
from repro.optim import AdamWConfig
out = {}
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=4)
opt = AdamWConfig(warmup_steps=1, total_steps=4)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
for aid in ARCHS:
    arch = dataclasses.replace(smoke_reduce(get_arch(aid)), accum_steps=1)
    state = init_train_state(arch, jax.random.PRNGKey(0), opt)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 64), 0,
                                arch.vocab_size, jnp.int32)
    with mesh:
        cell = build_cell(arch, shape, mesh)
        f = jax.jit(cell["fn"], in_shardings=cell["in_shardings"],
                    out_shardings=cell["out_shardings"])
        _, m_sh = f(init_train_state(arch, jax.random.PRNGKey(0), opt),
                    {"tokens": tokens})
    out[aid] = {"state": jax.tree.map(np.asarray, state),
                "tokens": np.asarray(tokens),
                "sharded_loss": float(m_sh["loss"])}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def _reference_process(path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(
        [sys.executable, "-c", f"ARCHS = {REF_ARCHS!r}\n" + _REFERENCE,
         str(path)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """{"ranks": [rank 0's .. rank 3's results], "restore": [2 ranks'],
    "reference": the reference's states, tokens and losses}."""
    from repro_torch.convert import train_state_from_jax
    out = tmp_path_factory.mktemp("sharded")
    ref_path = out / "reference.pkl"
    proc = _reference_process(ref_path)
    ranks = _spawn(_main_worker, WORLD, str(out))
    ref_states = None
    try:
        _, err = proc.communicate(timeout=JOIN_DEADLINE_S)
        assert proc.returncode == 0, err[-3000:]
        with open(ref_path, "rb") as f:
            reference = pickle.load(f)
        ref_states = {a: (train_state_from_jax(r["state"], device="cpu"),
                          torch.from_numpy(r["tokens"]).long())
                      for a, r in reference.items()}
    finally:
        # the ranks wait for the reference's states (None: it failed)
        _publish(out, ref_states)
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        _join(ranks)
    ranks_results = [torch.load(out / f"rank{r}.pt", weights_only=False)
                     for r in range(WORLD)]
    _join(_spawn(_restore_worker, 2, str(out)))
    return {"ranks": ranks_results,
            "restore": [torch.load(out / f"restore{r}.pt",
                                   weights_only=False) for r in range(2)],
            "reference": reference, "ckpt": out / "ckpt"}


def _result(sharded, name, rank=0):
    res = sharded["ranks"][rank][name]
    assert "error" not in res, res["error"]
    return res


# ---------------------------------------------------------------------------
# placements (no processes)
# ---------------------------------------------------------------------------

def _fake_device_mesh(mesh):
    """What ``placements`` reads of a DeviceMesh: its dimension names."""
    return types.SimpleNamespace(mesh_dim_names=mesh.axis_names,
                                 ndim=len(mesh.axis_names))


@pytest.mark.parametrize("mesh", [MESH22, Mesh(("pod", "data", "model"),
                                               (2, 2, 2))],
                         ids=["2x2", "2x2x2"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch_id", ARCHS)
def test_placements_follow_the_rules(arch_id, shape, mesh):
    """Every leaf's placements on a DeviceMesh of the mesh, for every rule
    variant arch_rules gives (fsdp, kv heads, kv_seq over model or over
    every axis): Shard(dim) on each mesh dimension its spec names at dim,
    Replicate on the others."""
    from torch.distributed.tensor import Replicate, Shard
    arch = get_arch(arch_id)
    rules = specs.arch_rules(arch, SHAPES[shape], mesh)
    model = get_model(arch)
    trees = [model.params_axes(), model.cache_axes(),
             {"b": ("batch", "seq"), "t": ("batch", None), "p": ("batch",),
              "l": ("batch", "vocab"), "m": ("batch", "frames", None)}]
    dm = _fake_device_mesh(mesh)
    seen = 0
    for tree in trees:
        for _, axes in tree_leaves_with_path(tree):
            spec = logical_to_spec(axes, rules, mesh)
            got = NamedSharding(mesh, spec).placements(dm)
            want = [Replicate()] * len(mesh.axis_names)
            for dim, part in enumerate(spec):
                for a in () if part is None else \
                        (part,) if isinstance(part, str) else part:
                    want[mesh.axis_names.index(a)] = Shard(dim)
            assert got == tuple(want), (axes, spec, got)
            seen += sum(p.is_shard() for p in got)
    assert seen     # the rules shard something on this mesh


def test_placements_of_a_tuple_entry_shard_each_axis():
    from torch.distributed.tensor import Replicate, Shard
    mesh = Mesh(("pod", "data", "model"), (2, 2, 2))
    ns = NamedSharding(mesh, PartitionSpec(("pod", "data"), None, "model"))
    assert ns.placements(_fake_device_mesh(mesh)) == (Shard(0), Shard(0),
                                                      Shard(2))
    assert NamedSharding(mesh, PartitionSpec()).placements(
        _fake_device_mesh(mesh)) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="device mesh axes"):
        ns.placements(_fake_device_mesh(MESH22))


def test_device_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        device_mesh(MESH22, "cpu")


def test_device_mesh_follows_the_device_rule():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        device_mesh(MESH22)             # None means CUDA, which is absent


def test_compressed_psum_group_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        cz.compressed_psum(torch.ones(4), group=object())


# ---------------------------------------------------------------------------
# the sharded steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", [f"train/{a}" for a in ARCHS]
                         + ["train_remat/stablelm-1.6b"])
def test_sharded_train_step_matches_unsharded(sharded, task):
    """The 2x2 step from the port's seeded state: loss, aux loss and grad
    norm, and every updated parameter after gathering, against the port's
    one-device step (the reference's tolerance); train_remat recomputes
    every layer in the backward pass and accumulates 2 microbatches, each
    split over the data shards."""
    kind, arch_id = task.split("/")
    arch = _arch(arch_id, remat=kind == "train_remat")
    step, _ = make_train_step(arch, _opt())
    state, metrics = step(init_train_state(arch, 0, _opt(), device="cpu"),
                          {"tokens": _tokens(arch, 1)})
    got = _result(sharded, task)
    for key in ("loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][key], float(metrics[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    for (path, a), (_, b) in zip(tree_leaves_with_path(got["params"]),
                                 tree_leaves_with_path(state["params"])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg="/".join(path))
    for r in range(1, WORLD):          # every rank saw the same metrics
        assert _result(sharded, task, r)["metrics"] == got["metrics"]


@pytest.mark.parametrize("arch_id", REF_ARCHS)
def test_sharded_loss_matches_reference(sharded, arch_id):
    """From the reference's PRNGKey(0) state and tokens: the port's 2x2
    loss against the reference's 2x2 loss."""
    ref = sharded["reference"][arch_id]
    got = _result(sharded, f"train_ref/{arch_id}")["metrics"]["loss"]
    np.testing.assert_allclose(got, ref["sharded_loss"], rtol=RTOL,
                               atol=ATOL)


def _decode_unsharded(draw):
    arch, params = _serving(draw)
    tok, cache = _prompt_cache(arch, params)
    step = make_decode_step(arch)
    pos = torch.tensor(POS, dtype=torch.int32)
    out = []
    for i in range(DECODE_STEPS):
        nxt, logits, cache = step(params, cache, tok, pos + i)
        out.append({"next": nxt, "logits": logits})
        tok = nxt[:, None]
    return out, cache


@pytest.mark.parametrize("draw", DRAWS)
def test_sharded_decode_matches_unsharded(sharded, draw):
    """Three decode steps with the cache's sequence cut over model (the
    partial softmax of each slice merged; a slice with no live key for the
    short sequences): next tokens equal, logits within LOGIT_TOL, the
    cache's written rows too."""
    want, want_cache = _decode_unsharded(draw)
    got = _result(sharded, f"decode/{draw}")
    for i, (g, w) in enumerate(zip(got["steps"], want)):
        assert torch.equal(g["next"], w["next"]), i
        torch.testing.assert_close(g["logits"], w["logits"], rtol=0,
                                   atol=LOGIT_TOL)
    for k in want_cache:
        torch.testing.assert_close(got["cache"][k], want_cache[k], rtol=0,
                                   atol=LOGIT_TOL)


def _prefill_sensitivity(arch, params, tokens, logits):
    """How far prefill's logits move when attention's wo changes by a
    relative 1e-7 (a float32 ulp or so): the floor under any two float32
    evaluations that round differently."""
    rng = np.random.default_rng(5)
    wo = params["blocks"]["attn"]["wo"]
    noise = torch.from_numpy(rng.standard_normal(wo.shape).astype(
        np.float32))
    p2 = {**params, "blocks": {**params["blocks"], "attn": {
        **params["blocks"]["attn"], "wo": wo * (1 + 1e-7 * noise)}}}
    moved, _ = make_prefill_step(arch)(p2, {"tokens": tokens})
    return float((moved - logits).abs().max())


@pytest.mark.parametrize("draw", DRAWS)
def test_sharded_prefill_matches_unsharded(sharded, draw):
    """Prefill with kv_seq sharded: the cache after gathering and the last
    logits against the unsharded prefill.  The fan-in draw's logits within
    LOGIT_TOL; the reference draw's within twice the unsharded model's own
    1-ulp sensitivity (measured here, ~2e-4), its argmax equal."""
    arch, params = _serving(draw)
    tokens = _tokens(arch, 3)
    logits, cache = make_prefill_step(arch)(params, {"tokens": tokens})
    got = _result(sharded, f"prefill/{draw}")
    assert torch.equal(got["logits"].argmax(-1), logits.argmax(-1))
    gap = float((got["logits"] - logits).abs().max())
    if draw == "fan_in":
        assert gap <= LOGIT_TOL, gap
    else:
        floor = _prefill_sensitivity(arch, params, tokens, logits)
        assert gap <= 2 * floor, (gap, floor)
    for k in cache:
        torch.testing.assert_close(got["cache"][k], cache[k], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("arch_id", MEDIA_ARCHS)
def test_sharded_cross_attention_families(sharded, arch_id):
    """whisper-large-v3 (its frames constrained as the reference's
    encdec.py:60) and llama-3.2-vision-90b (gates opened), smoke-reduced:
    the 2x2 prefill's last logits and the decode step's next tokens and
    logits against the unsharded cells' steps."""
    arch, params, prompt, media = _media_case(arch_id)
    steps = {k: specs.build_cell(arch, _shape(k), one_card_mesh())[
        "fn"] for k in ("prefill", "decode")}
    want = _media_steps(arch, params, prompt, media,
                        lambda kind, args: steps[kind](*args))
    got = _result(sharded, f"media/{arch_id}")
    assert torch.equal(got["next"], want["next"])
    for k in ("prefill", "decode"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=LOGIT_TOL)


def test_local_argument_bytes_are_shard_bytes(sharded):
    """Each rank's block of every decode argument: NamedSharding's
    shard_bytes where every sharded dim divides, less by the padding of an
    uneven dim where one does not; the ranks' blocks cover each leaf once
    per replica."""
    per_rank = [_result(sharded, "decode/reference", r)["arg_bytes"]
                for r in range(WORLD)]
    assert len(per_rank[0]) > 10
    for leaves in zip(*per_rank):
        first = leaves[0]
        even = all(n % k == 0 for n, k in zip(first["shape"],
                                               first["split"]))
        for rec in leaves:
            for n, k, got, pad in zip(rec["shape"], rec["split"],
                                      rec["local"], rec["shard_shape"]):
                assert got == n // k if n % k == 0 else got <= pad, rec
            if even:
                assert rec["local_bytes"] == rec["shard_bytes"], rec
            else:
                assert rec["local_bytes"] <= rec["shard_bytes"], rec
        replicas = WORLD // math.prod(first["split"])
        assert sum(math.prod(r["local"]) for r in leaves) == \
            replicas * math.prod(first["shape"]), first
    # the cache's sequence is cut in two over model, its batch over data
    k = next(r for r in per_rank[0] if r["path"] == "1/k")
    assert k["local"] == (k["shape"][0], B // 2, S // 2, *k["shape"][3:])


def test_compressed_psum_over_the_data_group(sharded):
    """Each rank's sum is over its data group (the ranks of its model
    column), each with its own error feedback."""
    for r in range(WORLD):
        got = _result(sharded, "psum", r)
        group = got["data_group"]
        assert r in group and len(group) == 2
        assert all(g % 2 == r % 2 for g in group)     # mesh [[0, 1], [2, 3]]
        want = torch.zeros(1000)
        for g in group:
            resid = None
            for _ in range(2):
                deq, resid = cz.compressed_psum(_psum_input(g), resid=resid)
            want += deq
        torch.testing.assert_close(got["out"], want, rtol=0, atol=1e-5)


def _members(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in sorted(zf.namelist())}


def test_restore_onto_a_smaller_mesh(sharded, tmp_path):
    """Saved from 4 ranks (rows over data), restored by 2: every leaf a
    DTensor on the 2-rank mesh, each rank's block its rows, the gathered
    leaves equal to the tree; the checkpoint's members byte for byte what
    the reference writes for the same tree, the digests equal."""
    import jax.numpy as jnp
    from repro.checkpoint import CheckpointManager as RefManager
    tree = _tree()
    assert "error" not in sharded["ranks"][0]["save"], \
        sharded["ranks"][0]["save"]["error"]
    for r in range(2):
        res = sharded["restore"][r]["restore"]
        assert "error" not in res, res["error"]
        assert res["mesh_size"] == {"w": 2, "b": 2, "n": 2}
        assert torch.equal(res["local"]["w"], tree["w"][4 * r:4 * r + 4])
        assert torch.equal(res["local"]["b"], tree["b"][3 * r:3 * r + 3])
        assert torch.equal(res["local"]["n"], tree["n"])
        for k, v in tree.items():
            assert res["whole"][k].dtype == v.dtype
            assert res["whole"][k].view(torch.uint8 if v.dtype !=
                                        torch.bfloat16 else torch.int16
                                        ).equal(v.view(
                                            torch.uint8 if v.dtype !=
                                            torch.bfloat16 else torch.int16))
    ref_tree = {"w": jnp.asarray(tree["w"].numpy()),
                "b": jnp.asarray(tree["b"].float().numpy()).astype(
                    jnp.bfloat16),
                "n": jnp.asarray(tree["n"].numpy())}
    RefManager(tmp_path, async_write=False).save(1, ref_tree)
    ours = sharded["ckpt"] / "step_000000001"
    theirs = tmp_path / "step_000000001"
    assert _members(ours / "shard_00000.npz") == \
        _members(theirs / "shard_00000.npz")
    meta = [json.loads((d / "meta.json").read_text()) for d in (ours, theirs)]
    assert meta[0]["digests"] == meta[1]["digests"]
