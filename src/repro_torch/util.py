"""Small shared utilities with no heavy dependencies."""

from __future__ import annotations

import hashlib

import numpy as np


def array_digest(arr: np.ndarray, n_hex: int = 16) -> str:
    """Short content digest of an array's raw bytes (sha256 prefix) — the
    integrity stamp used by both the model registry and checkpoint store."""
    return hashlib.sha256(np.asarray(arr).tobytes()).hexdigest()[:n_hex]
