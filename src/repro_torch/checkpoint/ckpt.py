"""Checkpointing in the JAX package's file format: a zstd-compressed pickle
of a tree with numpy leaves (zlib when ``zstandard`` is not installed; a
magic prefix keeps the two self-describing). Atomic write via rename.

The port's copy of ``repro.checkpoint.ckpt``. Tensors are converted to
numpy on save; :func:`load` returns numpy leaves. The trainer launcher
saves its state in the JAX layout (``convert.params_to_jax`` /
``opt_state_to_jax``), so one file resumes in either package.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import zlib

import torch

try:
    import zstandard as zstd
except ModuleNotFoundError:          # optional dep: degrade to stdlib zlib
    zstd = None

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"    # zstd frame header (RFC 8878)


def _compress(raw: bytes) -> bytes:
    if zstd is not None:
        return zstd.ZstdCompressor(level=3).compress(raw)
    return zlib.compress(raw, 6)


def _decompress(blob: bytes) -> bytes:
    if blob[:4] == _ZSTD_MAGIC:
        if zstd is None:
            raise ModuleNotFoundError(
                "checkpoint is zstd-compressed but zstandard is not installed")
        return zstd.ZstdDecompressor().decompress(blob)
    return zlib.decompress(blob)


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def save(path: str, tree) -> None:
    host = _to_host(tree)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(_compress(pickle.dumps(host, protocol=4)))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(path: str):
    """The saved tree, numpy leaves."""
    with open(path, "rb") as f:
        return pickle.loads(_decompress(f.read()))

