"""Versioned model registry: trained ForestParams survive across processes.

Fleet cells ship *model versions* instead of raw training traces: the wave-1
worker trains once per (base, env), publishes, and every ATLAS cell on that env
loads the version — bit-identical scoring, no arrays over the process boundary.

Layout (one directory per version, ``checkpoint.store`` discipline — atomic
tmp-dir + rename, sha256 digests verified on load):

    <root>/<name>/
        v_000001/
            meta.json        algo/seed/fits, array digests+shapes, user meta
            params.npz       map__/reduce__ {feat_idx, thresholds, leaves}
        v_000002/ ...
        HEAD                 serving version (atomic os.replace)
        events.jsonl         append-only publish/promote/rollback ledger

Concurrent publishers of *different* names are safe (the fleet trains one
model per env).  Two writers racing on the same name would collide on the
version rename — by design loudly, not silently.

The layout, file names and digests are the JAX package's
(``repro/online/registry.py``), so a version published by either package
loads in the other and scores bitwise equal."""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import time

import numpy as np

from repro_torch.ml.forest import ForestParams
from repro_torch.util import array_digest

_ARRAYS = ("feat_idx", "thresholds", "leaves")


class ModelRegistry:
    def __init__(self, root):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------ paths
    def _dir(self, name: str) -> pathlib.Path:
        d = self.root / name
        if not d.resolve().is_relative_to(self.root.resolve()):
            raise ValueError(f"model name escapes the registry root: {name!r}")
        return d

    def _vdir(self, name: str, version: int) -> pathlib.Path:
        return self._dir(name) / f"v_{version:06d}"

    # ------------------------------------------------------------ queries
    def versions(self, name: str) -> list[int]:
        d = self._dir(name)
        out = []
        for p in d.glob("v_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def head(self, name: str) -> int | None:
        p = self._dir(name) / "HEAD"
        if not p.exists():
            return None
        return int(p.read_text().strip())

    def history(self, name: str) -> list[dict]:
        p = self._dir(name) / "events.jsonl"
        if not p.exists():
            return []
        return [json.loads(line) for line in p.read_text().splitlines() if line]

    # ------------------------------------------------------------ write
    def _record(self, name: str, event: dict):
        event = {"time": time.time(), **event}
        with (self._dir(name) / "events.jsonl").open("a") as f:
            f.write(json.dumps(event) + "\n")

    def publish(self, name: str, snapshot: dict, *, meta: dict | None = None,
                promote: bool = True) -> int:
        """Persist a ``TaskPredictor.snapshot()`` as the next version.
        ``promote=False`` archives a candidate without moving HEAD (the drift
        refresher records rejected candidates this way)."""
        d = self._dir(name)
        d.mkdir(parents=True, exist_ok=True)
        version = (self.versions(name) or [0])[-1] + 1
        tmp = d / f".tmp_v_{version:06d}"
        final = self._vdir(name, version)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

        arrays, digests, shapes = {}, {}, {}
        for kind in ("map", "reduce"):
            params = snapshot["models"].get(kind)
            if params is None:
                continue
            for field in _ARRAYS:
                arr = np.asarray(getattr(params, field))
                key = f"{kind}__{field}"
                arrays[key] = arr
                digests[key] = array_digest(arr)
                shapes[key] = list(arr.shape)
        np.savez(tmp / "params.npz", **arrays)
        (tmp / "meta.json").write_text(json.dumps({
            "version": version,
            "algo": snapshot["algo"], "seed": snapshot["seed"],
            "min_samples": snapshot["min_samples"],
            "max_train": snapshot["max_train"], "fits": snapshot["fits"],
            "kinds": sorted(k for k, v in snapshot["models"].items()
                            if v is not None),
            "digests": digests, "shapes": shapes,
            "meta": meta or {},
            "time": time.time(),
        }))
        tmp.rename(final)                       # atomic publish
        self._record(name, {"event": "publish", "version": version,
                            "promoted": promote, "meta": meta or {}})
        if promote:
            self._set_head(name, version, event=None)
        return version

    def _set_head(self, name: str, version: int, *, event: str | None):
        d = self._dir(name)
        tmp = d / ".HEAD.tmp"
        tmp.write_text(str(version))
        os.replace(tmp, d / "HEAD")             # atomic promote
        if event:
            self._record(name, {"event": event, "version": version})

    def promote(self, name: str, version: int):
        if version not in self.versions(name):
            raise KeyError(f"{name}: no version {version}")
        self._set_head(name, version, event="promote")

    def rollback(self, name: str) -> int:
        """Move HEAD to the newest version older than the current HEAD."""
        cur = self.head(name)
        older = [v for v in self.versions(name) if cur is None or v < cur]
        if not older:
            raise KeyError(f"{name}: nothing to roll back to")
        self._set_head(name, older[-1], event="rollback")
        return older[-1]

    # ------------------------------------------------------------ read
    def load(self, name: str, version: int | None = None,
             *, verify: bool = True) -> dict:
        """Load a version (default: HEAD) back into ``snapshot()`` form."""
        if version is None:
            version = self.head(name)
            if version is None:
                versions = self.versions(name)
                if not versions:
                    raise KeyError(f"{name}: no published versions")
                version = versions[-1]
        d = self._vdir(name, version)
        meta = json.loads((d / "meta.json").read_text())
        data = np.load(d / "params.npz")
        models: dict = {"map": None, "reduce": None}
        for kind in meta["kinds"]:
            fields = {}
            for field in _ARRAYS:
                key = f"{kind}__{field}"
                arr = data[key]
                if verify and array_digest(arr) != meta["digests"][key]:
                    raise IOError(
                        f"{name} v{version}: {key} digest mismatch (corrupt?)")
                fields[field] = arr
            models[kind] = ForestParams(**fields)
        return {"algo": meta["algo"], "seed": meta["seed"],
                "min_samples": meta["min_samples"],
                "max_train": meta["max_train"], "fits": meta["fits"],
                "models": models}
