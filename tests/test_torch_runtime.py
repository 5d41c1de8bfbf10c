"""The port's runtime (``checkpoint/store.py``, ``runtime/trainer.py``,
``launch/train.py``) against the JAX package on the CPU.

(f) tests/test_runtime.py's four checkpoint cases on the port; cross-loading
(a checkpoint of either package restores in the port; a float32 one of the
port restores in the reference), exact; a bf16 tree's shard members (each
``leaf_i.npy``'s bytes) and digests equal to the reference's; and
tests/test_elastic_restore.py's replay case on the port, bitwise.
(g) tests/test_runtime.py's three ElasticTrainer cases on the port, then
the port against the reference on those configurations from the
reference's initial state (``convert.train_state_from_jax``): the same
counters (the chaos draws, ATLAS's GLM decisions, checkpoints, rollbacks)
and the losses within LOSS_RTOL (float32 sums in another order; at count 1
Adam moves a parameter by about lr x sign(g), so a gradient within rounding
of zero can move it the other way, and the runs part by that much).
(h) ``launch.train.main`` prints the reference's result keys.
(i) The moe, vlm and audio families (smoke configs): the ElasticTrainer
with ``DataConfig(media_shape=...)`` for whisper and the vlm (its gates
opened to 0.5 in both packages' states), under chaos, against the
reference's trainer as in (g), losses within LOSS_RTOL; and the train
states of deepseek-moe (bf16 parameters and moments, as its config keeps
them), the vlm (stacked cross blocks) and whisper (encoder and decoder
stacks): a port round trip exact, the same state saved by both packages
in equal shard bytes and digests, the reference's checkpoint restored in
the port exactly, and a float32 port checkpoint restored in the reference
exactly (the reference cannot restore bf16 leaves, ROADMAP section 3)."""

import contextlib
import dataclasses
import io
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_arch as jget_arch, smoke_reduce as jsmoke
from repro.data import DataConfig as JDataConfig
from repro.runtime import ElasticTrainer as JElasticTrainer
from repro.runtime import RuntimeConfig as JRuntimeConfig
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch, smoke_reduce
from repro_torch.convert import train_state_from_jax
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.launch import train
from repro_torch.models.steps import init_train_state, make_train_step
from repro_torch.optim import AdamWConfig
from repro_torch.parallel.axes import tree_leaves
from repro_torch.runtime import ElasticTrainer, RuntimeConfig

CPU = "cpu"
LOSS_RTOL = 1e-3
COUNTERS = ("steps", "committed", "rollbacks", "lost_steps",
            "duplicated_shards", "wasted_shards", "checkpoints",
            "hazard_checkpoints")


# ---------------------------------------------------------------------------
# (f) checkpoints
# ---------------------------------------------------------------------------

def _tree(seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((16, 8), generator=g).to(dtype),
            "b": {"c": torch.arange(5, dtype=torch.int32),
                  "d": torch.tensor(3.5)}}


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_roundtrip(tmp_path, dtype):
    mgr = CheckpointManager(tmp_path, async_write=False)
    t = _tree(dtype=dtype)
    mgr.save(7, t)
    assert _equal(mgr.restore(7, t), t)


def test_checkpoint_gc_keeps_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_detects_corruption(tmp_path):
    mgr = CheckpointManager(tmp_path, async_write=False)
    t = _tree()
    mgr.save(1, t)
    shard = next((tmp_path / "step_000000001").glob("*.npz"))
    data = dict(np.load(shard))
    data["leaf_0"] = data["leaf_0"] + 1.0
    np.savez(shard, **data)
    with pytest.raises(IOError, match="digest"):
        mgr.restore(1, t)


def test_checkpoint_async_write(tmp_path):
    mgr = CheckpointManager(tmp_path, async_write=True)
    mgr.save(3, _tree())
    mgr.wait()
    assert mgr.latest_step() == 3


def _jtree(dtype):
    k = jax.random.PRNGKey(0)
    return {"a": jax.random.normal(k, (16, 8)).astype(dtype),
            "b": {"c": jnp.arange(5, dtype=jnp.int32), "d": jnp.float32(3.5)},
            "e": jnp.zeros((0, 3), dtype)}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_reference_checkpoint_restores_in_port(tmp_path, dtype):
    jt = _jtree(dtype)
    JCheckpointManager(tmp_path, async_write=False).save(2, jt)
    like = train_state_from_jax(jax.tree.map(np.asarray, jt), device=CPU)
    got = CheckpointManager(tmp_path).restore(2, like)
    assert _equal(got, like)


def test_port_checkpoint_restores_in_reference(tmp_path):
    t = _tree()
    CheckpointManager(tmp_path, async_write=False).save(5, t)
    like = jax.tree.map(lambda x: jnp.asarray(x.numpy()), t)
    got = JCheckpointManager(tmp_path).restore(5, like)
    for a, b in zip(jax.tree.leaves(got), tree_leaves(t)):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_bf16_shards_and_digests_equal_reference(tmp_path):
    jt = _jtree(jnp.bfloat16)
    JCheckpointManager(tmp_path / "ref", async_write=False).save(1, jt)
    CheckpointManager(tmp_path / "port", async_write=False).save(
        1, train_state_from_jax(jax.tree.map(np.asarray, jt), device=CPU))
    step = "step_000000001"
    ref = zipfile.ZipFile(tmp_path / "ref" / step / "shard_00000.npz")
    port = zipfile.ZipFile(tmp_path / "port" / step / "shard_00000.npz")
    assert ref.namelist() == port.namelist()
    for name in ref.namelist():
        assert ref.read(name) == port.read(name), name
    metas = [json.loads((tmp_path / d / step / "meta.json").read_text())
             for d in ("ref", "port")]
    for key in ("step", "n_leaves", "digests", "shapes", "dtypes"):
        assert metas[0][key] == metas[1][key], key
    assert metas[1]["dtypes"] == ["bfloat16", "int32", "float32", "bfloat16"]


def test_restore_replays_identical_training(tmp_path):
    """Save at step k, keep training; restore at k and replay the same data
    stream: the same state at k + n, bit for bit."""
    arch = dataclasses.replace(smoke_reduce(get_arch("stablelm-1.6b")),
                               n_layers=2, d_model=64, d_ff=128,
                               vocab_size=128, n_heads=2, n_kv_heads=2,
                               head_dim=32)
    opt = AdamWConfig(warmup_steps=1, total_steps=10)
    step_fn = make_train_step(arch, opt)[0]
    stream = SyntheticStream(DataConfig(vocab_size=128, seq_len=32,
                                        global_batch=4, seed=0))
    mgr = CheckpointManager(tmp_path, async_write=False)
    state = init_train_state(arch, 0, opt, device=CPU)
    for s in range(3):
        state, _ = step_fn(state, stream.batch(s, 0, 1))
    mgr.save(3, state)
    for s in range(3, 6):
        state, _ = step_fn(state, stream.batch(s, 0, 1))
    replay = mgr.restore(3, state)
    for s in range(3, 6):
        replay, _ = step_fn(replay, stream.batch(s, 0, 1))
    assert _equal(replay, state)


# ---------------------------------------------------------------------------
# (g) the elastic trainer
# ---------------------------------------------------------------------------

def _tiny(get, smoke):
    return dataclasses.replace(smoke(get("stablelm-1.6b")), n_layers=2,
                               d_model=64, d_ff=128, vocab_size=256,
                               n_heads=2, n_kv_heads=2, head_dim=32)


CASES = {
    "no_chaos": dict(n_hosts=4, steps=12, fail_rate=0.0, degrade_rate=0.0,
                     checkpoint_every=5, seed=0),
    "chaos": dict(n_hosts=4, steps=15, fail_rate=0.06, degrade_rate=0.15,
                  checkpoint_every=3, seed=1),
    "atlas_off": dict(n_hosts=4, steps=20, fail_rate=0.05, degrade_rate=0.2,
                      checkpoint_every=4, atlas=False, seed=7),
    "atlas_on": dict(n_hosts=4, steps=20, fail_rate=0.05, degrade_rate=0.2,
                     checkpoint_every=4, atlas=True, seed=7),
}


def _port_run(tmp_path, case, state=None):
    arch = _tiny(get_arch, smoke_reduce)
    trainer = ElasticTrainer(
        arch, RuntimeConfig(**CASES[case]), tmp_path / f"port_{case}",
        data_cfg=DataConfig(vocab_size=arch.vocab_size, seq_len=32,
                            global_batch=8), device=CPU)
    if state is not None:
        trainer.state = train_state_from_jax(state, device=CPU)
    return trainer.run(), trainer.losses


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """Each case through the reference's trainer: its initial state, result
    and losses."""
    arch = _tiny(jget_arch, jsmoke)
    out = {}
    for case, kw in CASES.items():
        trainer = JElasticTrainer(
            arch, JRuntimeConfig(**kw),
            tmp_path_factory.mktemp(f"ref_{case}"),
            data_cfg=JDataConfig(vocab_size=arch.vocab_size, seq_len=32,
                                 global_batch=8))
        start = jax.tree.map(np.asarray, trainer.state)
        out[case] = (start, trainer.run(), list(trainer.losses))
    return out


def test_elastic_trainer_no_chaos_trains(tmp_path):
    out, _ = _port_run(tmp_path, "no_chaos")
    assert out["committed"] == 12
    assert out["rollbacks"] == 0
    assert out["final_loss"] < out["first_loss"]


def test_elastic_trainer_survives_chaos(tmp_path):
    out, _ = _port_run(tmp_path, "chaos")
    assert out["committed"] >= 15
    assert np.isfinite(out["final_loss"])


def test_atlas_reduces_lost_steps_vs_baseline(tmp_path):
    on, _ = _port_run(tmp_path, "atlas_on")
    off, _ = _port_run(tmp_path, "atlas_off")
    assert on["lost_steps"] <= off["lost_steps"] + 1


@pytest.mark.parametrize("case", list(CASES))
def test_elastic_trainer_matches_reference(tmp_path, reference_runs, case):
    start, want, want_losses = reference_runs[case]
    got, losses = _port_run(tmp_path, case, state=start)
    assert {k: got[k] for k in COUNTERS} == {k: want[k] for k in COUNTERS}
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert set(got) == set(want)


# ---------------------------------------------------------------------------
# (h) the launcher
# ---------------------------------------------------------------------------

def test_launch_train_prints_reference_keys(tmp_path, reference_runs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = train.main(["--arch", "stablelm-1.6b", "--steps", "2",
                          "--hosts", "2", "--seq-len", "32",
                          "--global-batch", "4", "--checkpoint-dir",
                          str(tmp_path), "--device", "cpu"])
    lines = buf.getvalue().splitlines()
    cfg = smoke_reduce(get_arch("stablelm-1.6b"))
    assert lines[0] == (f"[train] arch={cfg.name} layers={cfg.n_layers} "
                        f"d_model={cfg.d_model} atlas=True")
    keys = list(reference_runs["no_chaos"][1])
    assert [ln.split(":")[0] for ln in lines[1:]] == [f"[train] {k}"
                                                     for k in keys]
    assert list(out) == keys and out["committed"] == 2
    assert (tmp_path / cfg.name).is_dir()


def test_launch_train_layers_cuts_depth(tmp_path):
    """--layers trains the config at that depth with its widths; a depth
    outside 1..n_layers is refused."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = train.main(["--arch", "stablelm-1.6b", "--steps", "1",
                          "--hosts", "2", "--seq-len", "32",
                          "--global-batch", "4", "--layers", "1",
                          "--checkpoint-dir", str(tmp_path),
                          "--device", "cpu"])
    cfg = smoke_reduce(get_arch("stablelm-1.6b"))
    assert buf.getvalue().splitlines()[0] == (
        f"[train] arch={cfg.name} layers=1 d_model={cfg.d_model} atlas=True")
    assert out["committed"] >= 1 and np.isfinite(out["final_loss"])
    for bad in ("0", str(cfg.n_layers + 1)):
        with pytest.raises(SystemExit), contextlib.redirect_stderr(
                io.StringIO()):
            train.main(["--arch", "stablelm-1.6b", "--layers", bad,
                        "--device", "cpu"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_checkpoint_digests_are_array_digests(dtype):
    """The store hashes each leaf's buffer in place: the same digest as
    util.array_digest's copy."""
    from repro_torch.checkpoint.store import _digest, _host
    from repro_torch.util import array_digest
    for t in (torch.arange(12).reshape(3, 4).to(dtype),
              torch.zeros(0, 2, dtype=dtype), torch.tensor(7).to(dtype)):
        arr, _ = _host(t)
        assert _digest(arr) == array_digest(arr)


# ---------------------------------------------------------------------------
# (i) the moe, vlm and audio families
# ---------------------------------------------------------------------------

MEDIA_RUN = dict(n_hosts=4, steps=6, fail_rate=0.06, degrade_rate=0.15,
                 checkpoint_every=3, seed=1)


def _open_gates(params, full):
    cross = params.get("cross_blocks")
    if cross is not None:
        for gate in ("gate_attn", "gate_mlp"):
            cross[gate] = full(cross[gate], 0.5)
    return params


def _media_data(arch, make):
    M = arch.cross_attn.n_media_tokens if arch.family == "vlm" \
        else arch.enc_dec.n_frames
    return make(vocab_size=arch.vocab_size, seq_len=16, global_batch=8,
                media_shape=(M, arch.d_model))


@pytest.mark.parametrize("arch_id", ["whisper-large-v3",
                                     "llama-3.2-vision-90b"])
def test_elastic_trainer_with_media_matches_reference(tmp_path, arch_id):
    jarch = jsmoke(jget_arch(arch_id))
    ref = JElasticTrainer(jarch, JRuntimeConfig(**MEDIA_RUN), tmp_path / "r",
                          data_cfg=_media_data(jarch, JDataConfig))
    start = jax.tree.map(np.asarray, ref.state)
    _open_gates(start["params"], np.full_like)
    ref.state = jax.tree.map(jnp.asarray, start)
    want = ref.run()
    arch = smoke_reduce(get_arch(arch_id))
    port = ElasticTrainer(arch, RuntimeConfig(**MEDIA_RUN), tmp_path / "p",
                          data_cfg=_media_data(arch, DataConfig), device=CPU)
    port.state = train_state_from_jax(start, device=CPU)
    got = port.run()
    assert {k: got[k] for k in COUNTERS} == {k: want[k] for k in COUNTERS}
    assert got["committed"] >= MEDIA_RUN["steps"]
    np.testing.assert_allclose(port.losses, ref.losses, rtol=LOSS_RTOL)


FAMILY_STATES = {"deepseek-moe-16b": "bf16", "llama-3.2-vision-90b": "fp32",
                 "whisper-large-v3": "fp32"}


@pytest.mark.parametrize("arch_id", list(FAMILY_STATES))
def test_family_train_state_checkpoints_cross_packages(tmp_path, arch_id):
    from repro.models.steps import init_train_state as jinit
    from repro.optim import AdamWConfig as JAdamW
    bf16 = FAMILY_STATES[arch_id] == "bf16"
    jarch = jsmoke(jget_arch(arch_id))
    if bf16:
        jarch = dataclasses.replace(jarch, dtype=jnp.bfloat16)
    jstate = jinit(jarch, jax.random.PRNGKey(0), JAdamW(
        moment_dtype=FAMILY_STATES[arch_id]))
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                 device=CPU)
    leaves = tree_leaves(state)
    assert any(t.dtype == torch.bfloat16 for t in leaves) == bf16
    # the port's round trip
    mgr = CheckpointManager(tmp_path / "port", async_write=False)
    mgr.save(3, state)
    assert _equal(mgr.restore(3, state), state)
    # the same state saved by the reference: equal bytes and digests
    JCheckpointManager(tmp_path / "ref", async_write=False).save(3, jstate)
    step = "step_000000003"
    shards = sorted(p.name for p in (tmp_path / "ref" / step).glob("*.npz"))
    assert shards == sorted(
        p.name for p in (tmp_path / "port" / step).glob("*.npz"))
    for name in shards:
        a = zipfile.ZipFile(tmp_path / "ref" / step / name)
        b = zipfile.ZipFile(tmp_path / "port" / step / name)
        assert a.namelist() == b.namelist()
        assert all(a.read(m) == b.read(m) for m in a.namelist()), name
    metas = [json.loads((tmp_path / d / step / "meta.json").read_text())
             for d in ("ref", "port")]
    for key in ("n_leaves", "digests", "shapes", "dtypes"):
        assert metas[0][key] == metas[1][key], key
    # the reference's checkpoint in the port; the port's in the reference
    assert _equal(CheckpointManager(tmp_path / "ref").restore(3, state),
                  state)
    if not bf16:
        got = JCheckpointManager(tmp_path / "port").restore(3, jstate)
        for a, b in zip(jax.tree.leaves(got), leaves):
            assert np.array_equal(np.asarray(a), b.numpy())
