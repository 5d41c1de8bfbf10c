"""repro_torch — the ATLAS decision loop and LM serving (dense, RWKV6 and the
Mamba2 hybrid) ported to PyTorch, with their kernels written by hand in
CUDA C++ for Hopper (sm_90a).

The JAX package ``repro`` stays the reference; this package mirrors its module
tree and public names and imports nothing from it.  Ported so far:

  cluster/     discrete-event fleet simulator, chaos, workload, telemetry,
               invariants, scenarios, the §5 experiment driver, the fleet
               sweep engine and the adversarial scenario search.
  sched/       FIFO / Fair / Capacity baselines.
  core/        ATLAS scheduler (Algorithm 1), adaptive heartbeat, predictor.
  ml/          oblivious forests (fit + inference), the paper's six
               models (GLM, Tree, CTree, R.F., Boost, N.N.) and the 10-fold
               CV harness.
  online/      the batched prediction broker, the model registry, the
               drift-aware refresher, the transport, the AsyncBroker
               service with fault injection, and the load bench.
  obs/         telemetry: the metrics core, simulator and broker observers,
               NDJSON / transport sinks, the live collector and HTTP
               server, and the HTML dashboards.
  configs/    the model zoo's ten arch configs and shapes.
  parallel/    parameter definitions with logical axes; seeded init.
  models/      the model zoo's six families: the dense, moe, ssm (RWKV6),
               hybrid (Mamba2 + shared attention) and vlm (cross-attention)
               LMs and the audio encoder-decoder (layers, prefill, cached
               decode) and the Model facade.
  launch/      serve.py: batched prefill, then greedy decode.
  kernels/     CUDA forest, attention and scan kernels (csrc/), their plain
               torch versions (ref.py) and the device dispatch (ops.py).
  convert.py   carries trained predictors, GLM / N.N. weights and LM
               parameters across from the JAX package.

Device rule: every entry point that touches tensors takes ``device``;
``None`` means CUDA and raises when no GPU is present (see
``kernels.ops.resolve_device``).  CPU runs pass ``device="cpu"``.
"""

__version__ = "0.2.0"

# Stamped into SWEEP.json / SEARCH.json under provenance.pr (the JAX
# package's key), so an artifact says which package and version produced it.
PR_TAG = f"repro_torch-{__version__}"
