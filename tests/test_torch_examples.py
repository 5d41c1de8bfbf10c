"""The five examples on the port (``examples/torch_*.py``) against the JAX
package's (``examples/*.py``) on the CPU: each runs at small arguments
with ``--device cpu`` and prints what the reference example prints for
the same arguments, apart from wall times.

Where the two packages draw their own random numbers the reference's draw
is handed to the port: the trainers of torch_quickstart and
torch_chaos_train start from the reference trainers' initial states
(``convert.train_state_from_jax``), and torch_serve_atlas's ``serve``
gets the reference's ``PRNGKey(0)`` weights (``convert.lm_params_from_jax``)
and its ``PRNGKey(1)`` prompts; its tokens must equal the reference's.  The
trained losses are held to tests/test_torch_runtime.py's LOSS_RTOL (the
float32 sums run in another order); every other number is equal.

hadoop_sim's smallest arguments (``--seeds 1``) take minutes in the
reference alone (six simulations of the paper's workload), so both
packages' examples run it on a small workload (tests/test_torch_isolation.py's
job sizes, 12 single jobs and 2 chains, the predictor trained from 40
samples: ``WorkloadConfig`` and ``ExperimentConfig`` patched alike in both
example modules) at ``--intensity 9``, where jobs fail and ATLAS changes
the outcome.  The sweep's "Produced by" line is each package's provenance
and is not compared."""

import functools
import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.runtime.trainer as jtrainer
from repro.configs import get_arch as jget_arch, smoke_reduce as jsmoke
from repro.models import get_model as jget_model
from repro_torch.configs import get_arch, smoke_reduce
from repro_torch.convert import lm_params_from_jax, train_state_from_jax
from repro_torch.models import get_model
import repro_torch.runtime.trainer as ttrainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
LOSS_RTOL = 1e-3                  # tests/test_torch_runtime.py
NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference(name, argv, capsys, monkeypatch, **patch):
    """The reference example's stdout for ``argv`` (its ``main`` reads
    sys.argv), with ``patch`` set on its module first."""
    mod = _load(name)
    for attr, value in patch.items():
        monkeypatch.setattr(mod, attr, value)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


def _port(name, argv, capsys, monkeypatch, **patch):
    mod = _load(f"torch_{name}")
    for attr, value in patch.items():
        monkeypatch.setattr(mod, attr, value)
    capsys.readouterr()
    mod.main([*argv, "--device", "cpu"])
    return capsys.readouterr().out


def _same_output(got: str, want: str, rtol=0.0, atol=0.0):
    """Line for line: the text between numbers equal, every number within
    rtol / atol."""
    got_lines, want_lines = got.splitlines(), want.splitlines()
    assert len(got_lines) == len(want_lines), (got, want)
    for g, w in zip(got_lines, want_lines):
        assert NUMBER.split(g) == NUMBER.split(w), (g, w)
        gn = [float(x) for x in NUMBER.findall(g)]
        wn = [float(x) for x in NUMBER.findall(w)]
        np.testing.assert_allclose(gn, wn, rtol=rtol, atol=atol,
                                   err_msg=f"{g!r} vs {w!r}")


def _reference_states(monkeypatch):
    """Record every initial state the reference's ElasticTrainer draws, and
    start each port trainer from the next one recorded."""
    states = []
    draw = jtrainer.init_train_state

    def record(*a, **kw):
        state = draw(*a, **kw)
        states.append(jax.tree.map(np.asarray, state))
        return state

    def replay(arch, seed, opt_cfg, *, device=None):
        return train_state_from_jax(states.pop(0), device=device)
    monkeypatch.setattr(jtrainer, "init_train_state", record)
    monkeypatch.setattr(ttrainer, "init_train_state", replay)
    return states


def test_quickstart(capsys, monkeypatch, tmp_path):
    argv = ["--steps", "6", "--d-model", "64", "--layers", "1", "--vocab",
            "256", "--hosts", "2"]
    states = _reference_states(monkeypatch)
    want = _reference("quickstart", [*argv, "--ckpt", str(tmp_path / "j")],
                      capsys, monkeypatch)
    assert len(states) == 1
    got = _port("quickstart", [*argv, "--ckpt", str(tmp_path / "t")],
                capsys, monkeypatch)
    assert not states
    wall = re.compile(r"^  wall_s: .*$", re.M)
    assert len(wall.findall(got)) == len(wall.findall(want)) == 1
    _same_output(wall.sub("", got), wall.sub("", want), rtol=LOSS_RTOL,
                 atol=LOSS_RTOL)


def test_chaos_train(capsys, monkeypatch):
    argv = ["--steps", "6", "--hosts", "2"]
    states = _reference_states(monkeypatch)
    want = _reference("chaos_train", argv, capsys, monkeypatch)
    assert len(states) == 2                   # baseline, then ATLAS
    got = _port("chaos_train", argv, capsys, monkeypatch)
    assert not states
    wall = re.compile(r"^wall_s .*$", re.M)
    _same_output(wall.sub("", got), wall.sub("", want), rtol=LOSS_RTOL,
                 atol=LOSS_RTOL)


def test_hadoop_sim(capsys, monkeypatch):
    import repro.cluster.experiment as jexp
    import repro.cluster.workload as jwork
    import repro_torch.cluster.experiment as texp
    import repro_torch.cluster.workload as twork
    small = dict(n_single=12, n_chains=2, chain_len_range=(3, 4),
                 maps_range=(4, 8), reduces_range=(2, 6),
                 submit_horizon=2400.0)
    trained = dict(min_samples=40, max_train=40)

    def patches(work, exp):
        return {"WorkloadConfig": functools.partial(work.WorkloadConfig,
                                                    **small),
                "ExperimentConfig": functools.partial(exp.ExperimentConfig,
                                                      **trained)}
    argv = ["--seeds", "1", "--intensity", "9"]
    want = _reference("hadoop_sim", argv, capsys, monkeypatch,
                      **patches(jwork, jexp))
    got = _port("hadoop_sim", argv, capsys, monkeypatch,
                **patches(twork, texp))
    assert len(got.splitlines()) == 11
    _same_output(got, want)


def test_fleet_sweep():
    """Both examples as scripts (the spawn pool re-imports them): equal
    output apart from the waves' wall times, the device the port's log
    line names and the provenance line."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}

    def run(*argv):
        proc = subprocess.run([sys.executable, *argv], capture_output=True,
                              text=True, timeout=240, cwd=ROOT, env=env)
        assert proc.returncode == 0, proc.stderr
        out = re.sub(r" \([\d.]+s( total)?\)", "", proc.stdout)
        return re.sub(r"^Produced by: .*$", "", out, flags=re.M)
    want = run(str(EXAMPLES / "fleet_sweep.py"))
    got = run(str(EXAMPLES / "torch_fleet_sweep.py"), "--device", "cpu")
    assert ", device=cpu" in got
    _same_output(got.replace(", device=cpu", ""), want)


class _Recorder:
    """numpy, with every ``stack`` result kept (the reference example
    prints only the first row of its tokens)."""

    def __init__(self):
        self.stacked = []

    def __getattr__(self, name):
        return getattr(np, name)

    def stack(self, *a, **kw):
        out = np.stack(*a, **kw)
        self.stacked.append(out)
        return out


def test_serve_atlas(capsys, monkeypatch):
    batch, prompt_len, tokens = 2, 8, 8
    argv = ["--batch", str(batch), "--prompt-len", str(prompt_len),
            "--tokens", str(tokens)]
    rec = _Recorder()
    want = _reference("serve_atlas", argv, capsys, monkeypatch, np=rec)
    want_tokens = rec.stacked[-1]
    assert want_tokens.shape == (batch, tokens)

    jcfg = jsmoke(jget_arch("stablelm-1.6b"))
    jparams = jget_model(jcfg).init(jax.random.PRNGKey(0))
    prompts = jax.random.randint(jax.random.PRNGKey(1), (batch, prompt_len),
                                 0, jcfg.vocab_size, jnp.int32)
    cfg = smoke_reduce(get_arch("stablelm-1.6b"))
    mod = _load("torch_serve_atlas")
    res = mod.serve(get_model(cfg),
                    lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                       device="cpu"),
                    torch.from_numpy(np.asarray(prompts, np.int64)),
                    tokens=tokens, replicas=2, kill_replica_at=6,
                    device="cpu")
    assert res["failovers"] == 1
    assert np.array_equal(res["tokens"], want_tokens)
    capsys.readouterr()
    mod.report(res, batch, "cpu")
    got = capsys.readouterr().out
    wall = re.compile(r" in [\d.]+s \([\d.]+ tok/s")
    _same_output(wall.sub("", got), wall.sub("", want))
    # its own main: the port's seeded weights, the same two lines
    own = _port("serve_atlas", argv, capsys, monkeypatch)
    assert NUMBER.split(wall.sub("", own))[:3] == \
        NUMBER.split(wall.sub("", want))[:3]


@pytest.mark.parametrize("name", ["quickstart", "hadoop_sim", "fleet_sweep",
                                  "serve_atlas", "chaos_train"])
def test_examples_raise_without_gpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _load(f"torch_{name}").main([])

