"""Build the port's CUDA sources into one shared library and load it.

``csrc/*.cu`` are compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``build/repro_torch/`` at the
root of the checkout: one ``nvcc`` per source, all started together, then
one link.  The file name carries a hash of the sources and the
flags, so a change to either builds anew and a stale library is never
loaded.  The build uses only the sources in the repository.  A missing
``nvcc``, a failed compile or a failed load raises: no caller falls back to
the plain versions."""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else the toolkit's default install."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    if shutil.which("nvcc"):
        candidates.append(pathlib.Path(shutil.which("nvcc")))
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"repro_torch_kernels_{h.hexdigest()[:16]}.so"


def _run(cmd: list[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(jobs: list):
    """Wait for every (process, command); raise on the first that failed,
    after all have ended, so that no compiler outlives the build."""
    failed = None
    for proc, cmd in jobs:
        output, _ = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                      f"{output}")
    if failed:
        raise RuntimeError(failed)


def build() -> pathlib.Path:
    """Compile the sources unless the library for this hash exists: every
    source to an object at once, in parallel, then one shared library."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    # private names, then a rename: a concurrent build never loads a
    # half-written library
    work = pathlib.Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs, jobs = [], []
        for src in sources():
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((_run(cmd), cmd))
            objs.append(str(obj))
        _wait(jobs)
        lib = work / "lib.so"
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *objs]
        _wait([(_run(cmd), cmd)])
        os.replace(lib, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, with every entry
    point's argument types declared (a pointer passed without them would be
    cut to 32 bits)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.forest_infer_launch.argtypes = [p, i, i, p, p, p, i, i, p, p]
            lib.forest_infer_launch.restype = i
            lib.forest_infer_grouped_launch.argtypes = [
                p, i, i, p, i, p, p, p, p, i, i, p, p]
            lib.forest_infer_grouped_launch.restype = i
            lib.flash_attention_launch.argtypes = [
                p, p, p, p, i, i, i, i, i, i, i, i, i, p]
            lib.flash_attention_launch.restype = i
            lib.decode_attention_chunks.argtypes = [i]
            lib.decode_attention_chunks.restype = i
            lib.decode_attention_launch.argtypes = [
                p, p, p, p, p, i, i, i, i, i, i, i, p, p, p, p]
            lib.decode_attention_launch.restype = i
            lib.rwkv6_scan_launch.argtypes = [p] * 8 + [i] * 5 + [p]
            lib.rwkv6_scan_launch.restype = i
            lib.mamba2_ssd_launch.argtypes = [p] * 8 + [i] * 6 + [p]
            lib.mamba2_ssd_launch.restype = i
            _LIB = lib
        return _LIB
