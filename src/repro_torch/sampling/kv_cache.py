"""Cache backends for the slot-pool inference engine.

The engine keeps a *fixed pool* of ``N'`` slots; every slot owns a region of
the batched KV cache, a list of per-layer ``{"k", "v"}`` tensors of shape
``(pool, max_len, KV, hd)``. The engine never touches the layout directly: it
goes through a :class:`CacheBackend`.

Ported: :class:`DenseCache` (one dense ``max_len`` region per slot, with
per-slot snapshots for the ``kv_snapshot`` resume strategy) and the prefill
insert :func:`dense_insert_rows`. The paged backend is the next slice.
Writes are in place on the cache tensors.
"""
from __future__ import annotations

import numpy as np
import torch


def dense_insert_rows(cache, scratch, slot_ids, row_map):
    """Prefill insert: ``scratch`` (a stack cache with batch = prefill rows,
    length S) holds one row per *unique* prefill; ``row_map`` maps each output
    slot to its scratch row (clipped into range). Only the first S positions
    of each slot are written; positions beyond S keep stale data from the
    slot's previous occupant, which is safe because decode writes position c
    before any step attends it (write-before-read along the length axis,
    masked by cache_len). Slot ids outside ``[0, pool)`` — the padding rows —
    are dropped. ``slot_ids`` / ``row_map`` are host integer arrays."""
    slot_ids = np.asarray(slot_ids, np.int64)
    row_map = np.asarray(row_map, np.int64)
    pool, n_rows = cache[0]["k"].shape[0], scratch[0]["k"].shape[0]
    keep = (slot_ids >= 0) & (slot_ids < pool)
    if not keep.any():
        return cache
    dev = cache[0]["k"].device
    dst = torch.from_numpy(slot_ids[keep]).to(dev)
    src = torch.from_numpy(np.clip(row_map[keep], 0, n_rows - 1)).to(dev)
    for big_layer, small_layer in zip(cache, scratch):
        for name, big in big_layer.items():
            small = small_layer[name]
            big[dst, :small.shape[1]] = small[src].to(big.dtype)
    return cache


class CacheBackend:
    """Backend-agnostic slot-cache interface used by the rollout engine.

    ``cache`` is the per-layer tensor list handed to the model's prefill /
    decode functions, which update it in place. The paged backend's page
    accounting (admission, growth, copy-on-write) joins this interface with
    the paged slice."""

    cache: object = None

    def free_slot(self, slot: int):
        pass

    def extract_snapshot(self, slot: int):
        raise NotImplementedError

    def insert_snapshot(self, snap, slot: int):
        raise NotImplementedError


class DenseCache(CacheBackend):
    """One dense ``max_len`` KV region per slot."""

    def __init__(self, model_cfg, pool: int, max_len: int, dtype=None,
                 device=None):
        from repro_torch.models import model as M
        self.pool = pool
        self.max_len = max_len
        self.cache = M.init_cache(model_cfg, pool, max_len, dtype, device)

    # snapshots: a copy of the slot's cache slice
    def extract_snapshot(self, slot: int):
        return [{name: t[slot:slot + 1].clone() for name, t in layer.items()}
                for layer in self.cache]

    def insert_snapshot(self, snap, slot: int):
        for layer, small in zip(self.cache, snap):
            for name, t in layer.items():
                t[slot:slot + 1] = small[name]
        return True


def make_backend(name: str, model_cfg, pool: int, max_len: int, *,
                 dtype=None, device=None) -> CacheBackend:
    if name == "dense":
        return DenseCache(model_cfg, pool, max_len, dtype, device)
    if name == "paged":
        raise NotImplementedError(
            "kv_backend='paged' (PagedCache with the paged_decode_attn "
            "kernel) is the next slice of the port; use kv_backend='dense'")
    raise ValueError(f"unknown kv backend {name!r} (dense|paged)")
