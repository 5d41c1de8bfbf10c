"""The port stands alone: it imports neither JAX nor the JAX package (it
schedules, serves and trains with JAX unimportable), its defaults need a
GPU and never fall back to the CPU, and a kernel is never asked to run on a
CPU tensor."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.cluster import fleet, search
from repro_torch.configs import get_arch, smoke_reduce
from repro_torch.convert import lm_params_from_jax
from repro_torch.core.predictor import TaskPredictor
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.models import get_model
from repro_torch.ml import forest as tforest
from repro_torch.obs import live as obs_live
from repro_torch.ml import models
from repro_torch.ml.cv import cross_validate
from repro_torch.online.broker import BrokerPredictor, PredictionBroker
from repro_torch.models.steps import init_train_state
from repro_torch.online.server import AsyncBroker
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import ElasticTrainer, RuntimeConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + sorted((ROOT / "examples").glob("torch_*.py")) + [ROOT / "chip_smoke.py"]

_NO_JAX_RUN = """
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
from repro_torch.cluster import WorkloadConfig
from repro_torch.cluster.experiment import ExperimentConfig, compare
cfg = ExperimentConfig(
    workload=WorkloadConfig(n_single=6, n_chains=1, chain_len_range=(3, 4),
                            maps_range=(4, 8), reduces_range=(2, 6),
                            submit_horizon=2400.0),
    min_samples=40, max_train=40, device="cpu", check_invariants=True)
out = compare("fifo", cfg)
assert out["atlas"]["invariant_violations"] == 0
assert out["atlas"]["atlas"]["predictions"] > 0
import dataclasses
from repro_torch.cluster.experiment import run_scheduler
from repro_torch.cluster.fleet import SweepSpec, run_sweep
from repro_torch.ml.cv import cross_validate
drifted, _, _ = run_scheduler("atlas-fifo", dataclasses.replace(cfg, drift=True))
assert drifted["atlas"]["refreshes"] > 0
sweep = run_sweep(SweepSpec(workloads=("smoke",), seeds=1, min_samples=40),
                  executor="broker", device="cpu", log=lambda *a: None)
assert sweep["perf"]["broker"]["dispatches"] > 0
import numpy as np
X = np.random.RandomState(0).rand(60, 3).astype(np.float32)
for algo in ("Glm", "N.N."):
    cross_validate(algo, X, (X[:, 0] > 0.5).astype(np.float32), k=2,
                   device="cpu")
from repro_torch.ml.models import ALL_MODELS
from repro_torch.online.server import AsyncBroker, BrokerClient
model = ALL_MODELS["R.F."](device="cpu").fit(X, (X[:, 0] > 0.5).astype(
    np.float32))
with AsyncBroker({"map": model}, device="cpu") as server:
    for address in ("", "tcp://127.0.0.1:0"):
        client = BrokerClient(server.serve(address), server.loop,
                              request_timeout_s=60)
        try:
            assert np.array_equal(client.predict("map", X[:3]),
                                  model.predict_proba(X[:3]))
            (served,) = client.submit([(model, X[3:5])]) if not address \
                else (client.predict("map", X[3:5]),)
            assert np.array_equal(served, model.predict_proba(X[3:5]))
        finally:
            client.close()
    assert server.stats()["requests"] == 4
asynced = run_sweep(SweepSpec(workloads=("smoke",), seeds=1, min_samples=40),
                    executor="async", device="cpu", log=lambda *a: None)
assert asynced["perf"] == sweep["perf"]
import tempfile
from repro_torch.obs import read_ndjson, render_html
with tempfile.TemporaryDirectory() as td:
    observed = compare("fifo", dataclasses.replace(cfg, obs_path=f"{td}/f.ndjson"))
    assert observed["atlas"]["obs"]["frames"] > 0
    assert {k: v for k, v in observed["atlas"].items() if k != "obs"} \
        == out["atlas"]
    frames = read_ndjson(f"{td}/f__atlas.ndjson")
    assert frames[-1]["type"] == "final"
    assert render_html(frames).startswith("<!DOCTYPE html>")
leaked = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
print("ran", out["atlas"]["atlas"]["predictions"])
"""


def test_runs_with_jax_unimportable():
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_RUN], capture_output=True, text=True,
        timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ran ")


_NO_JAX_SERVE = """
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
from repro_torch.launch import serve, train
for arch in sys.argv[1:]:
    res = serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "8",
                      "--tokens", "4", "--device", "cpu"])
    assert res["tokens"].shape == (2, 4)
leaked = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
"""
SERVED = ("mistral-nemo-12b", "rwkv6-1.6b", "zamba2-1.2b")


def test_serves_with_jax_unimportable():
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SERVE, *SERVED], capture_output=True,
        text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 2 * len(SERVED)
    for arch, first, second in zip(SERVED, lines[::2], lines[1::2]):
        assert first.startswith(f"[serve] {arch}-smoke: prefill 2x8")
        assert second.startswith("[serve] sample:")


_NO_JAX_TRAIN = """
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
from repro_torch.launch import train
out = train.main(["--arch", "stablelm-1.6b", "--steps", "2", "--hosts", "2",
                  "--seq-len", "16", "--global-batch", "4",
                  "--checkpoint-dir", sys.argv[1], "--device", "cpu"])
assert out["committed"] == 2 and out["checkpoints"] >= 1
leaked = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
"""


def test_trains_with_jax_unimportable(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_TRAIN, str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("[train] arch=stablelm-1.6b-smoke")
    assert "[train] committed: 2" in lines


_NO_JAX_FAMILIES = """
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import dataclasses
import numpy as np
import torch
from repro_torch.configs import get_arch, smoke_reduce
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.models.steps import init_train_state, make_train_step
from repro_torch.optim import AdamWConfig
from repro_torch.optim.compression import compressed_psum
for arch in ("deepseek-moe-16b", "llama-3.2-vision-90b", "whisper-large-v3"):
    cfg = dataclasses.replace(smoke_reduce(get_arch(arch)), accum_steps=2,
                              dtype=torch.bfloat16)
    media = None
    if cfg.family == "vlm":
        media = (cfg.cross_attn.n_media_tokens, cfg.d_model)
    elif cfg.family == "audio":
        media = (cfg.enc_dec.n_frames, cfg.d_model)
    stream = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=16, global_batch=4,
                                        media_shape=media))
    opt = AdamWConfig(warmup_steps=1, total_steps=2)
    step, _ = make_train_step(cfg, opt)
    state, m = step(init_train_state(cfg, 0, opt, device="cpu"),
                    stream.batch(0, 0, 1))
    assert np.isfinite(float(m["loss"])), arch
    g = state["opt"]["m"]["embed"]["embedding"]
    summed, resid = compressed_psum(g)
    assert summed.shape == g.shape and resid.dtype == torch.float32
    print(arch, float(m["loss"]))
leaked = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
"""


def test_trains_the_media_and_moe_families_with_jax_unimportable():
    """A bf16 train step of each smoke family that serves media or experts
    (float32 media from the data stream), and the compressed gradient
    sum, without JAX."""
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_FAMILIES], capture_output=True,
        text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    assert [ln.split()[0] for ln in proc.stdout.splitlines()] == [
        "deepseek-moe-16b", "llama-3.2-vision-90b", "whisper-large-v3"]


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    lambda: ops.resolve_device(None),
    lambda: ops.resolve_device("cuda"),
    lambda: TaskPredictor(),
    lambda: BrokerPredictor(),
    lambda: PredictionBroker(),
    lambda: AsyncBroker(),
    lambda: tforest.fit_oblivious_forest(np.ones((4, 2), np.float32),
                                         np.ones(4, np.float32)),
    lambda: models.GLM(),
    lambda: models.NeuralNet(),
    lambda: cross_validate("Glm", np.ones((8, 2), np.float32),
                           np.ones(8, np.float32), k=2),
    lambda: fleet.run_sweep(fleet.SweepSpec(workloads=("smoke",), seeds=1),
                            executor="serial", log=lambda *a: None),
    lambda: search.run_search(search.SearchConfig(budget=1),
                              log=lambda *a: None),
    lambda: obs_live.main([]),
    lambda: train.main(["--arch", "stablelm-1.6b", "--steps", "1"]),
    lambda: ElasticTrainer(smoke_reduce(get_arch("stablelm-1.6b")),
                           RuntimeConfig(steps=1), "unused"),
    lambda: init_train_state(smoke_reduce(get_arch("stablelm-1.6b")), 0,
                             AdamWConfig()),
], ids=["resolve_none", "resolve_cuda", "TaskPredictor", "BrokerPredictor",
        "PredictionBroker", "AsyncBroker", "fit_oblivious_forest", "GLM", "NeuralNet",
        "cross_validate", "run_sweep", "run_search", "obs_live_main",
        "launch_train_main", "ElasticTrainer", "init_train_state"])
def test_defaults_raise_without_gpu(no_cuda, entry):
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


@pytest.fixture(scope="module", params=SERVED)
def smoke_lm(request):
    model = get_model(smoke_reduce(get_arch(request.param)))
    params = model.init(0, device="cpu")
    _, cache = model.prefill(params, torch.zeros((1, 4), dtype=torch.long),
                             max_len=6, device="cpu")
    return request.param, model, params, cache


def test_serving_defaults_raise_without_gpu(no_cuda, smoke_lm):
    arch, model, params, cache = smoke_lm
    tokens = torch.zeros((1, 4), dtype=torch.long)
    for entry in (lambda: model.init(0),
                  lambda: model.init_cache(1, 6),
                  lambda: model.apply(params, tokens),
                  lambda: model.prefill(params, tokens, max_len=6),
                  lambda: model.decode(params, cache, tokens[:, :1],
                                       torch.tensor([4])),
                  lambda: serve.main(["--arch", arch]),
                  lambda: lm_params_from_jax({"w": np.zeros(2, np.float32)})):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()


def test_attention_cuda_impl_on_cpu_tensor_raises():
    q = torch.zeros((1, 4, 4, 32))
    k = torch.zeros((1, 4, 2, 32))
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.flash_attention(q, k, k, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.decode_attention(q[:, :1], k, k, torch.tensor([4], dtype=torch.int32),
                             impl="cuda")
    assert ops.launch_counts() == before


def test_recurrence_cuda_impl_on_cpu_tensor_raises():
    r = torch.zeros((1, 4, 2, 16))
    u, s0 = torch.zeros((2, 16)), torch.zeros((1, 2, 16, 16))
    x, dt, A = torch.zeros((1, 4, 2, 16)), torch.zeros((1, 4, 2)), \
        torch.zeros(2)
    bc = torch.zeros((1, 4, 16))
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.rwkv6_scan(r, r, r, r, u, s0, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.mamba2_ssd(x, dt, A, bc, bc, s0, impl="cuda")
    assert ops.launch_counts() == before


def _forest():
    rs = np.random.RandomState(0)
    return tforest.ForestParams(
        feat_idx=rs.randint(0, 4, (3, 2)).astype(np.int32),
        thresholds=rs.randn(3, 2).astype(np.float32),
        leaves=rs.rand(3, 4).astype(np.float32))


def test_scoring_defaults_raise_without_gpu(no_cuda):
    p, x = _forest(), np.zeros((2, 4), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tforest.forest_predict(p, x)
    with pytest.raises(RuntimeError, match="CUDA"):
        tforest.forest_predict_grouped([(p, x)])


def test_cuda_impl_on_cpu_tensor_raises():
    p = _forest()
    x = torch.zeros((2, 4))
    fi, th, lv = p.on("cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.forest_infer(x, fi, th, lv, impl="cuda")
    packed = tforest.pack_forests([p])
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.forest_infer_grouped(x, torch.tensor([0, 2], dtype=torch.int32),
                                 *packed.on("cpu"), impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tforest.forest_predict(p, x.numpy(), device="cpu", impl="cuda")
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_feature_width_checked_before_launch():
    p = _forest()
    with pytest.raises(ValueError, match="features"):
        tforest.forest_predict(p, np.zeros((2, 2), np.float32), device="cpu")
