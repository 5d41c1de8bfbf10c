"""Build the port's CUDA sources into one shared library and load it.

``csrc/*.cu`` are compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``build/repro_torch/`` at the
root of the checkout: one ``nvcc`` per source, all started together, then
one link.  The file name carries a hash of every file under ``csrc/`` (the
sources and the headers they include) and of the flags, so a change to
any of them builds anew and a stale library is never loaded.  The build
uses only the sources in the repository.  A missing ``nvcc``, a failed
compile or link, or a failed load raises: no caller falls back to the plain
versions.

``ptxas`` reports each kernel's registers and spills (``-Xptxas=-v``); the
report is kept beside the library (``ptxas_report``, parsed by
``ptxas_usage``), and ``tensor_core_instructions`` counts the tensor-core
instructions of each kernel in the built library's SASS."""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

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
    """The translation units: one object each."""
    return sorted(CSRC.glob("*.cu"))


def inputs() -> list[pathlib.Path]:
    """Every file under ``csrc/`` the build may read: the sources and the
    headers they include."""
    return sorted(p for p in CSRC.rglob("*") if p.is_file())


def library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for src in inputs():
        h.update(str(src.relative_to(CSRC)).encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"repro_torch_kernels_{h.hexdigest()[:16]}.so"


def ptxas_report() -> pathlib.Path:
    """The compilers' output of the build of ``library_path()``."""
    return library_path().with_suffix(".ptxas.txt")


def _run(cmd: list[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(jobs: list) -> str:
    """Wait for every (process, command); raise on the first that failed,
    after all have ended, so that no compiler outlives the build.  Returns
    their output."""
    failed, outputs = None, []
    for proc, cmd in jobs:
        output, _ = proc.communicate()
        outputs.append(output)
        if proc.returncode != 0 and failed is None:
            failed = (f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                      f"{output}")
    if failed:
        raise RuntimeError(failed)
    return "".join(outputs)


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
        report = _wait(jobs)
        lib = work / "lib.so"
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *objs]
        _wait([(_run(cmd), cmd)])
        (work / "ptxas.txt").write_text(report)
        os.replace(work / "ptxas.txt", ptxas_report())
        os.replace(lib, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, with every entry
    point's argument types declared (a pointer passed without them would be
    cut to 32 bits).  Once loaded it is returned without taking the lock:
    every kernel launch asks for it."""
    global _LIB
    lib = _LIB
    if lib is not None:
        return lib
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.forest_infer_launch.argtypes = [
                p, i, i, p, p, p, i, i, p, p, ll, p, p]
            lib.forest_infer_launch.restype = i
            lib.forest_infer_grouped_launch.argtypes = [
                p, i, i, p, i, p, p, p, p, i, i, p, p, ll, p, p]
            lib.forest_infer_grouped_launch.restype = i
            lib.flash_attention_launch.argtypes = [
                p, p, p, p, i, i, i, i, i, i, i, i, i, p]
            lib.flash_attention_launch.restype = i
            lib.decode_attention_launch.argtypes = [
                p, p, p, p, p, i, i, i, i, i, i, i, i, p]
            lib.decode_attention_launch.restype = i
            lib.decode_attention_partial_launch.argtypes = [
                p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
            lib.decode_attention_partial_launch.restype = i
            lib.rwkv6_scan_launch.argtypes = [p] * 8 + [i] * 5 + [p]
            lib.rwkv6_scan_launch.restype = i
            lib.mamba2_ssd_launch.argtypes = [p] * 8 + [i] * 6 + [p]
            lib.mamba2_ssd_launch.restype = i
            lib.rwkv6_scan_geometry.argtypes = [i, i, p]
            lib.rwkv6_scan_geometry.restype = i
            lib.mamba2_ssd_geometry.argtypes = [i, i, i, p]
            lib.mamba2_ssd_geometry.restype = i
            _LIB = lib
        return _LIB


def ptxas_usage(report: str) -> dict:
    """{kernel (mangled name): {"registers", "spill_stores", "spill_loads"}}
    from ``ptxas -v`` output (bytes for the spills)."""
    usage: dict = {}
    current = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = usage.setdefault(m.group(1), {})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            current["spill_stores"] = int(m.group(1))
            current["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    return usage


def sass_tensor_core_counts(sass: str) -> dict:
    """{kernel (mangled name): number of HMMA/HGMMA instructions} from
    ``cuobjdump -sass`` output."""
    counts: dict = {}
    current = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = m.group(1)
            counts.setdefault(current, 0)
        elif current is not None and re.search(r"\bH(G)?MMA\b", line):
            counts[current] += 1
    return counts


def _toolkit_tool(name: str) -> str | None:
    tool = pathlib.Path(nvcc_path()).parent / name
    return str(tool) if tool.is_file() else shutil.which(name)


def tensor_core_instructions() -> dict | None:
    """Tensor-core instructions per kernel in the built library's SASS, or
    None when the toolkit has no ``cuobjdump``."""
    tool = _toolkit_tool("cuobjdump")
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(build())], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return sass_tensor_core_counts(sass)


def demangle(names) -> dict:
    """{mangled: readable} through the toolkit's ``cu++filt``; names it
    cannot read, or all of them without the tool, map to themselves."""
    names = list(names)
    tool = _toolkit_tool("cu++filt")
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True, timeout=60).stdout.splitlines()
    return {n: _short(o) if o else n for n, o in zip(names, out)}


def _short(demangled: str) -> str:
    """``void <unnamed>::k<float, (int)64>(const float *, ...)`` ->
    ``k<float, 64>``."""
    s = re.sub(r"\((?:int|unsigned int)\)", "", demangled)
    for ns in ("(anonymous namespace)::", "<unnamed>::"):
        s = s.replace(ns, "")
    s = s.removeprefix("void ")
    return s.split("(")[0].strip()
