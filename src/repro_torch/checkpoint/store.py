"""Async checkpointing with integrity digests and restore onto the current
device.

The port's copy of ``repro/checkpoint/store.py``, with the same layout (one
directory per step):
    <root>/step_000123/
        meta.json              step, leaf paths, shapes, dtypes, digests
        shard_00000.npz        the flattened leaves, leaf_0 .. leaf_{n-1}
Leaves are flattened in sorted-key order, JAX's order for dicts, so leaf i
is the same leaf in both packages.  Writes are atomic (a tmp dir, then a
rename), keep the newest ``keep`` steps, and can run on a background thread
after the leaves were copied to the host.  Each leaf's digest is
``util.array_digest``'s: the first 16 hex digits of the sha256 of its raw
bytes.

bf16 leaves are written as their raw bits under the ``<V2`` descriptor,
byte for byte what the JAX package's ``np.savez`` writes for a bfloat16
array, with "bfloat16" in ``meta["dtypes"]``; restore reinterprets such
bytes as bf16.  No ``ml_dtypes`` is needed on either side.  So a checkpoint
written by either package restores in the port; one without bf16 leaves
also restores in the JAX package, whose restore cannot cast the ``<V2``
bytes back (ROADMAP section 3).  ``meta["treedef"]`` holds the port's
sorted leaf paths; restore does not read it (nor does the reference's).

A tree of DTensors (a train state on a mesh, ``parallel/partition.py``)
is saved whole: every rank gathers each leaf (a collective, so every rank
calls ``save``), rank 0 alone writes the same single ``shard_00000.npz``
as an unsharded tree's, blocking, and every rank waits until it has.
``restore(..., shardings=)`` lays each restored leaf out on a DeviceMesh,
whatever mesh wrote it: the fleet may have shrunk or grown since."""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import json
import pathlib
import shutil
import struct
import threading
import time
import zipfile

import numpy as np
import torch

from repro_torch.parallel.axes import (tree_leaves, tree_leaves_with_path,
                                       tree_unflatten)
from repro_torch.parallel.partition import (distribute, distribute_tree,
                                           is_dtensor)

BF16_BITS = np.dtype("V2")        # a bf16 leaf's bytes on the host
BF16_DESCR = "<V2"                # numpy's descriptor for ml_dtypes bfloat16
_DIGEST_THREADS = 8


def _host(x) -> tuple:
    """(numpy array, dtype name) of one leaf; a bf16 tensor's bits as V2;
    a DTensor gathered whole (every rank must call this for it)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if is_dtensor(x):
            x = x.full_tensor()
        if x.dtype == torch.bfloat16:
            return (x.view(torch.int16).cpu().numpy().view(BF16_BITS),
                    "bfloat16")
        a = x.cpu().numpy()
    else:
        a = np.asarray(x)
    return a, str(a.dtype)


def _digest(arr: np.ndarray) -> str:
    """``util.array_digest(arr)`` (sha256 of the raw bytes) hashed from the
    array's own buffer instead of a ``tobytes`` copy, so that threads hash
    side by side: sha256 lets go of the GIL on a buffer, a copy does not."""
    raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return hashlib.sha256(raw).hexdigest()[:16]


def _write_npz(path: pathlib.Path, leaves) -> tuple:
    """``np.savez(path, leaf_0=..., ...)`` of the (array, dtype name) pairs
    that ``leaves`` yields, with bf16 bits under the ``<V2`` descriptor: the
    same zip layout (stored, zip64 members) and the same member bytes as
    the JAX package's checkpoints.  Each array is hashed on a thread pool
    once written, so only the leaves in flight stay on the host when
    ``leaves`` copies them one by one.  Returns the digests, shapes and
    dtype names."""
    futures, shapes, dtypes = [], [], []
    with concurrent.futures.ThreadPoolExecutor(_DIGEST_THREADS) as pool, \
            zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                            allowZip64=True) as zf:
        for i, (a, dt) in enumerate(leaves):
            with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as f:
                if dt != "bfloat16":
                    np.lib.format.write_array(f, a, allow_pickle=False)
                else:
                    a = np.ascontiguousarray(a)
                    np.lib.format.write_array_header_1_0(
                        f, {"descr": BF16_DESCR, "fortran_order": False,
                            "shape": a.shape})
                    f.write(a.data.cast("B") if a.size else b"")
            futures.append(pool.submit(_digest, a))
            shapes.append(list(a.shape))
            dtypes.append(dt)
        digests = [f.result() for f in futures]
    return digests, shapes, dtypes


def _read_npz(path: pathlib.Path, n: int):
    """Yield leaf_0 .. leaf_{n-1} of a shard.  Its members are stored, not
    compressed (``np.savez``), so each array is read straight from the
    file after its npy header, without zipfile's CRC pass: the sha256
    digests are the integrity check, and ``restore(verify=False)`` makes
    none.  (``np.load`` reads the same arrays through the CRC pass, which
    takes longer than the read itself.)"""
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for i in range(n):
            info = zf.getinfo(f"leaf_{i}.npy")
            f.seek(info.header_offset)
            local = f.read(30)               # the member's local file header
            if local[:4] != b"PK\x03\x04" \
                    or info.compress_type != zipfile.ZIP_STORED:
                raise IOError(f"{path}: leaf {i} is not a stored member")
            name_len, extra_len = struct.unpack("<HH", local[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0
                           if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            arr = np.empty(shape[::-1] if fortran else shape, dtype)
            raw = arr.reshape(-1).view(np.uint8)
            if f.readinto(raw) != raw.size:
                raise IOError(f"{path}: leaf {i} is truncated")
            yield arr.T if fortran else arr


def _restored(arr: np.ndarray, dtype_name: str, like) -> torch.Tensor:
    """A loaded leaf as a tensor of ``like``'s dtype on ``like``'s
    device."""
    if dtype_name == "bfloat16" or arr.dtype.kind == "V":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if is_dtensor(like):
        return distribute(t.to(dtype=like.dtype), like.device_mesh,
                          like.placements)
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


@dataclasses.dataclass
class CheckpointManager:
    root: pathlib.Path
    keep: int = 3
    async_write: bool = True

    def __post_init__(self):
        self.root = pathlib.Path(self.root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._thread: threading.Thread | None = None
        self.last_saved_step: int = -1
        self.save_count: int = 0

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, *, block: bool = False):
        """Snapshot ``tree``.  On a background thread (``async_write`` and
        not ``block``) every leaf is copied to the host now; a blocking save
        copies the leaves one at a time as it writes them, so a 16 GB state
        never sits on the host whole."""
        paths = ["/".join(p) for p, _ in tree_leaves_with_path(tree)]
        sharded = any(is_dtensor(x) for x in tree_leaves(tree))
        background = self.async_write and not block and not sharded
        leaves = [_host(x) for x in tree_leaves(tree)] if background \
            else (_host(x) for x in tree_leaves(tree))
        self.wait()
        if sharded:
            import torch.distributed as dist
            if dist.get_rank() != 0:
                for _ in leaves:        # the gathers rank 0 writes from
                    pass
                dist.barrier()
                return

        def write():
            tmp = self.root / f".tmp_step_{step:09d}"
            final = self.root / f"step_{step:09d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            digests, shapes, dtypes = _write_npz(tmp / "shard_00000.npz",
                                                 leaves)
            meta = {
                "step": step,
                "n_leaves": len(paths),
                "digests": digests,
                "treedef": paths,
                "shapes": shapes,
                "dtypes": dtypes,
                "time": time.time(),
            }
            (tmp / "meta.json").write_text(json.dumps(meta))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self.last_saved_step = step
            self.save_count += 1
            self._gc()

        if background:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
        if sharded:
            dist.barrier()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.root / f"step_{s:09d}", ignore_errors=True)

    # ------------------------------------------------------------------ load
    def all_steps(self):
        out = []
        for p in self.root.glob("step_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like_tree, *, shardings=None,
                verify: bool = True):
        """Restore into the structure of ``like_tree``: each leaf with its
        dtype, on its device.  With ``shardings`` (a tree of
        ``NamedSharding`` records, or None leaves for replicated) each leaf
        comes back as a DTensor laid out by them on the DeviceMesh of the
        shardings' mesh over the current process group, on the device type
        of ``like_tree``'s leaves, as the
        reference restores onto the current mesh.  A DTensor leaf of
        ``like_tree`` (without ``shardings``) comes back laid out as it is.
        Raises IOError if a leaf's bytes do not match their digest."""
        d = self.root / f"step_{step:09d}"
        meta = json.loads((d / "meta.json").read_text())
        leaves = tree_leaves(like_tree)
        assert meta["n_leaves"] == len(leaves), "tree structure changed"
        out, futures = [], []
        # one leaf on the host at a time (besides those being hashed); the
        # restored tree is returned only once every digest matched
        with concurrent.futures.ThreadPoolExecutor(_DIGEST_THREADS) as pool:
            for i, (arr, ref) in enumerate(zip(
                    _read_npz(d / "shard_00000.npz", len(leaves)), leaves)):
                assert tuple(arr.shape) == tuple(ref.shape), \
                    f"leaf {i}: {arr.shape} vs {tuple(ref.shape)}"
                if verify:
                    futures.append(pool.submit(_digest, arr))
                out.append(_restored(arr, meta["dtypes"][i], ref))
            for i, fut in enumerate(futures):
                if fut.result() != meta["digests"][i]:
                    raise IOError(f"checkpoint leaf {i} digest mismatch "
                                  "(corrupt?)")
        tree = tree_unflatten(like_tree, out)
        if shardings is None:
            return tree
        from repro_torch.launch.mesh import device_mesh
        mesh = next(s.mesh for s in tree_leaves(shardings) if s is not None)
        dev = next(x.device_mesh.device_type if is_dtensor(x)
                   else x.device.type for x in leaves
                   if isinstance(x, torch.Tensor))
        return distribute_tree(tree, shardings, device_mesh(mesh, dev))
