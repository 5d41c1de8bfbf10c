"""Hand-written CUDA kernels for Hopper, with their plain torch versions.

  csrc/forest.cu      oblivious-forest inference: single forest and the
                      block-diagonal multi-model pass (one thread per row)
  csrc/flash_attention.cu
                      flash attention (prefill), GQA, float32 softmax: bf16
                      on the tensor cores (wgmma), float32 on the CUDA
                      cores
  csrc/decode_attention.cu
                      decode attention against a KV cache: one launch, a
                      block cluster per (sequence, kv head) merged through
                      distributed shared memory
  csrc/attention_common.cuh
                      what the two attention sources share
  csrc/recurrence.cu  the RWKV6 (WKV6) and Mamba2 (SSD) scans, one block per
                      (batch row, head), the state in registers
  _build.py           nvcc build of csrc/*.cu into build/repro_torch/, keyed
                      by a hash of every file under csrc/ and the flags;
                      ptxas and SASS reports
  forest.py,          ctypes launchers
  attention.py,
  recurrence.py
  ref.py              plain torch versions (the CPU path and the kernels'
                      oracle)
  ops.py              device dispatch: "torch" for CPU tensors, "cuda" for
                      CUDA tensors; launch counters; ``resolve_device``
                      implements the device rule
"""

from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
