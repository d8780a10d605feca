"""Cache backends for the slot-pool inference engine.

The engine keeps a *fixed pool* of ``N'`` slots; every slot owns a region of
the batched cache, a list of per-layer dicts of tensors: attention K/V
(``"k"``, ``"v"``) and per-slot leaves: the recurrent block kinds' state
(hymba's ``ssm``/``conv``, rwkv's ``wkv``/``tm_prev``/``cm_prev``) and the
VLM's media K/V (xattn's ``mk``/``mv``, written at prefill, read at every
decode step). The engine never touches the layout directly: it goes
through a :class:`CacheBackend`.
Two implementations, as in the reference:

* :class:`DenseCache` — one dense ``max_len`` region per slot: per-layer
  tensors ``(pool, max_len, KV, hd)``, with per-slot snapshots for the
  ``kv_snapshot`` resume strategy;
* :class:`PagedCache` — vLLM-style paged KV: per-layer physical page pools
  ``(num_pages, page_size, KV, hd)`` shared by all slots, with a host-side
  block table ``(pool, max_pages)`` mapping each slot's logical pages to
  physical pages; per-slot state keeps its slot axis. Pages carry refcounts, so a GRPO group's G samples can
  *share* their common prompt prefix (one prefill, copy-on-write on the
  first divergent write), and admission can be gated on free **pages**
  instead of free slots.

Writes are in place on the cache tensors. The host-side arrays handed to the
device helpers (slot ids, flat positions, page copy lists) are filtered on
the host: out-of-range entries — padding and the block-table sentinel — are
dropped before any tensor is indexed.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.partitioning import (gather_dims, local_shard,
                                             shard_start)


KV_KEYS = ("k", "v")


def _is_kv(name: str) -> bool:
    """Attention K/V leaves are exactly the keys "k" and "v" of a layer's
    cache dict (paged where the backend pages); every other leaf (hymba's
    ``ssm``/``conv``, rwkv's ``wkv``/``tm_prev``/``cm_prev``, xattn's media
    K/V ``mk``/``mv``) has no length axis and stays per slot in both
    backends: inserted at prefill, copied into snapshots and back."""
    return name in KV_KEYS


def _leaves(cache, kv: bool):
    """(layer index, name, tensor) of every K/V leaf (``kv``) or every
    per-slot leaf."""
    return [(i, name, t) for i, layer in enumerate(cache)
            for name, t in layer.items() if _is_kv(name) == kv]


def _device(cache):
    return next(t for layer in cache for t in layer.values()).device


def _slot_rows(slot_ids, row_map, pool, n_rows, device):
    """Device (dst slot, src row) index pairs of the in-range slot ids (the
    padding rows carry slot id ``pool`` and are dropped), or None."""
    slot_ids = np.asarray(slot_ids, np.int64)
    row_map = np.asarray(row_map, np.int64)
    keep = (slot_ids >= 0) & (slot_ids < pool)
    if not keep.any():
        return None
    dst = torch.from_numpy(slot_ids[keep]).to(device)
    src = torch.from_numpy(np.clip(row_map[keep], 0, n_rows - 1)).to(device)
    return dst, src


def dense_insert_rows(cache, scratch, slot_ids, row_map):
    """Prefill insert: ``scratch`` (a stack cache with batch = prefill rows,
    length S) holds one row per *unique* prefill; ``row_map`` maps each output
    slot to its scratch row (clipped into range). Of each K/V leaf only the
    first S positions of each slot are written; positions beyond S keep
    stale data from the slot's previous occupant, which is safe because
    decode writes position c before any step attends it (write-before-read
    along the length axis, masked by cache_len). Per-slot state leaves are
    written whole. Slot ids outside ``[0, pool)`` — the padding rows — are
    dropped. ``slot_ids`` / ``row_map`` are host integer arrays.

    On a mesh (``DTensor`` leaves, the scratch in the cache's layout) each
    rank writes its own shard of the cache in place: the scratch gathered
    to every row and position (a slot's scratch row may live on another
    data rank, and the scratch's length slices are not the cache's; its
    heads, where the cache shards them, stay), then the slots among the
    rank's own rows written at the positions of its own length slice."""
    pool = next(iter(cache[0].values())).shape[0]     # every leaf's axis 0
    n_rows = next(iter(scratch[0].values())).shape[0]
    slot_ids = np.asarray(slot_ids, np.int64)
    row_map = np.clip(np.asarray(row_map, np.int64), 0, n_rows - 1)
    keep = (slot_ids >= 0) & (slot_ids < pool)
    dev = _device(cache)
    pairs = {}                   # (first row, rows) -> device (dst, src)
    for big_layer, small_layer in zip(cache, scratch):
        for name, big in big_layer.items():
            local = local_shard(big)
            whole = local_shard(gather_dims(small_layer[name], (0, 1)))
            r0, p0 = shard_start(big, 0), shard_start(big, 1)
            end = min(small_layer[name].shape[1], p0 + local.shape[1])
            key = (r0, local.shape[0])
            if key not in pairs:
                mine = keep & (slot_ids >= r0) & (slot_ids < r0 + key[1])
                pairs[key] = None if not mine.any() else (
                    torch.from_numpy(slot_ids[mine] - r0).to(dev),
                    torch.from_numpy(row_map[mine]).to(dev))
            if pairs[key] is None or end <= p0:
                continue
            dst, src = pairs[key]
            local[dst, :end - p0] = whole[src, p0:end].to(local.dtype)
    return cache


def paged_insert_rows(cache, scratch, slot_ids, row_map, flat_pos):
    """Paged prefill insert. K/V leaves: ``flat_pos`` (host, (rows, S))
    holds, per scratch row, the physical flat position (page * page_size +
    offset) of each prompt token, which the host computed from the block
    table; padding and unmapped positions carry an out-of-range sentinel
    and are dropped. Per-slot state leaves scatter by ``slot_ids`` after
    gathering ``row_map``, as in :func:`dense_insert_rows`, so each
    prefix-shared sample gets its own copy of the state."""
    dev = _device(cache)
    kv = _leaves(cache, kv=True)
    if kv:
        flat_pos = np.asarray(flat_pos, np.int64)
        NP, ps = kv[0][2].shape[:2]
        rows, cols = np.nonzero((flat_pos >= 0) & (flat_pos < NP * ps))
        if rows.size:
            dst = torch.from_numpy(flat_pos[rows, cols]).to(dev)
            r = torch.from_numpy(rows).to(dev)
            c = torch.from_numpy(cols).to(dev)
            for i, name, big in kv:
                flat = big.view(NP * ps, *big.shape[2:])
                flat[dst] = scratch[i][name][r, c].to(big.dtype)
    state = _leaves(cache, kv=False)
    if state:
        n_rows = scratch[state[0][0]][state[0][1]].shape[0]
        idx = _slot_rows(slot_ids, row_map, state[0][2].shape[0], n_rows,
                         dev)
        if idx is not None:
            dst, src = idx
            for i, name, big in state:
                big[dst] = scratch[i][name][src].to(big.dtype)
    return cache


def _paged_copy_pages(cache, src_ids, dst_ids):
    """Copy physical pages src -> dst in every K/V pool (copy-on-write);
    per-slot state is untouched. Pairs whose dst is out of range are
    dropped."""
    kv = _leaves(cache, kv=True)
    if not kv:
        return cache
    src_ids = np.asarray(src_ids, np.int64)
    dst_ids = np.asarray(dst_ids, np.int64)
    NP = kv[0][2].shape[0]
    keep = (dst_ids >= 0) & (dst_ids < NP)
    if not keep.any():
        return cache
    dev = _device(cache)
    src = torch.from_numpy(np.clip(src_ids[keep], 0, NP - 1)).to(dev)
    dst = torch.from_numpy(dst_ids[keep]).to(dev)
    for _, _, big in kv:
        big[dst] = big[src]        # the gather copies before the write
    return cache


def _paged_extract(cache, slot, page_ids):
    """Page-list snapshot: a copy of the given pages of every K/V pool and
    of the slot's row of every per-slot state leaf."""
    ids = torch.from_numpy(np.asarray(page_ids, np.int64)).to(_device(cache))
    return [{name: (big[ids] if _is_kv(name) else big[slot:slot + 1].clone())
             for name, big in layer.items()}
            for layer in cache]


def _paged_insert_snapshot(cache, snap, slot, page_ids):
    """Inverse of :func:`_paged_extract`: write the snapshot's pages into
    the (freshly allocated) physical pages ``page_ids`` and its state into
    the slot's row."""
    ids = torch.from_numpy(np.asarray(page_ids, np.int64)).to(_device(cache))
    for layer, small in zip(cache, snap):
        for name, big in layer.items():
            if _is_kv(name):
                big[ids] = small[name].to(big.dtype)
            else:
                big[slot:slot + 1] = small[name]
    return cache


# ---------------------------------------------------------------------------
# CacheBackend API
# ---------------------------------------------------------------------------


class CacheBackend:
    """Backend-agnostic slot-cache interface used by the rollout engine.

    ``cache`` is the per-layer tensor list handed to the model's prefill /
    decode functions, which update it in place. Host-side page bookkeeping
    (block tables, refcounts, free lists) lives on the backend."""

    is_paged: bool = False
    supports_sharing: bool = False
    cache: object = None

    # --- capacity / admission ---------------------------------------
    def free_page_count(self) -> Optional[int]:
        """Free physical pages (None = not page-limited)."""
        return None

    def admission_pages(self, total_len: int, *, lookahead: int = 0,
                        shared: bool = False) -> int:
        """Worst-case pages a new admission of ``total_len`` prompt+response
        tokens needs through its first ``lookahead`` decode steps."""
        return 0

    def snapshot_pages(self, snap) -> int:
        """Pages needed to restore a kv_snapshot blob."""
        return 0

    # --- slot lifecycle ----------------------------------------------
    def alloc_slot_prefix(self, slot: int, length: int):
        """Map pages covering [0, length) for ``slot``; returns the flat
        physical positions (np.int32 (length,)) for the prefill insert, or
        None for backends that don't page."""
        return None

    def share_slots(self, src_slot: int, dst_slot: int, length: int):
        raise NotImplementedError

    def grow(self, slot: int, upto: int, write_from: int,
             copies: List[Tuple[int, int]]) -> bool:
        """Ensure positions [0, upto) are mapped and pages in the write range
        [write_from, upto) are exclusively owned (COW). Appends (src, dst)
        page copies to ``copies``; returns False on page exhaustion."""
        return True

    def apply_copies(self, copies: List[Tuple[int, int]]):
        pass

    def free_slot(self, slot: int):
        pass

    # --- snapshots (kv_snapshot resume strategy) ---------------------
    def extract_snapshot(self, slot: int):
        raise NotImplementedError

    def insert_snapshot(self, snap, slot: int):
        raise NotImplementedError

    # --- decode-time view --------------------------------------------
    def block_table_device(self):
        """Device block table of the paged decode path (None for dense)."""
        return None


class DenseCache(CacheBackend):
    """One dense ``max_len`` KV region per slot. On a mesh every leaf (K/V,
    recurrent state, media K/V) is laid out by
    ``launch/sharding.cache_placements``, in the ``shard_seq`` layout for
    a pool of one slot (``models/model.init_cache``)."""

    def __init__(self, model_cfg, pool: int, max_len: int, dtype=None,
                 device=None, mesh=None):
        from repro_torch.models import model as M
        self.pool = pool
        self.max_len = max_len
        self.cache = M.init_cache(model_cfg, pool, max_len, dtype, device,
                                  mesh=mesh)

    # snapshots: a copy of the slot's cache slice
    def extract_snapshot(self, slot: int):
        return [{name: t[slot:slot + 1].clone() for name, t in layer.items()}
                for layer in self.cache]

    def insert_snapshot(self, snap, slot: int):
        for layer, small in zip(self.cache, snap):
            for name, t in layer.items():
                t[slot:slot + 1] = small[name]
        return True


class PageExhausted(RuntimeError):
    """Raised when the physical page pool cannot satisfy a request that the
    engine's admission gate should have prevented."""


class PagedCache(CacheBackend):
    """Paged KV cache: physical page pools + per-slot block tables.

    A model with no attention (rwkv) has no pools: the page accounting
    still runs, as in the reference, and only the per-slot state is
    stored.

    * K/V pools: ``(num_pages, page_size, KV, hd)`` per layer. One *logical*
      page index maps to the same physical page in every layer's pool, so
      the allocator is layer-agnostic.
    * ``block_table`` (host, np.int32 ``(pool, max_pages)``): physical page
      per logical page; unmapped entries hold the sentinel ``num_pages``,
      which the model's paged write drops and its paged read never
      dereferences.
    * ``refcount`` per physical page enables prefix sharing: a group's G
      slots point at the same prompt pages; the first write into a shared
      page triggers copy-on-write (see :meth:`grow`).
    """

    is_paged = True
    supports_sharing = True

    def __init__(self, model_cfg, pool: int, max_len: int, *,
                 page_size: int, num_pages: int = 0, dtype=None,
                 device=None):
        from repro_torch.models import model as M
        if max_len % page_size != 0:
            raise ValueError(
                f"kv_page_size={page_size} must divide the engine max_len="
                f"{max_len} (max_len is rounded to the 64-token prefill "
                "bucket, so any power of two <= 64 works)")
        self.pool = pool
        self.max_len = max_len
        self.page_size = page_size
        self.max_pages = max_len // page_size
        self.num_pages = num_pages or pool * self.max_pages
        if self.num_pages < self.max_pages:
            raise ValueError(
                f"kv_num_pages={self.num_pages} cannot hold even one full-"
                f"length trajectory ({self.max_pages} pages of "
                f"{page_size} tokens)")
        self.cache = M.init_paged_cache(model_cfg, pool, max_len,
                                        page_size=page_size,
                                        num_pages=self.num_pages, dtype=dtype,
                                        device=device)
        self.device = _device(self.cache)
        self.block_table = np.full((pool, self.max_pages), self.num_pages,
                                   np.int32)
        self.refcount = np.zeros(self.num_pages, np.int32)
        # LIFO free list, lowest ids first — allocation order is a pure
        # function of the (deterministic) host replay, so paged runs are
        # reproducible
        self._free = list(range(self.num_pages - 1, -1, -1))
        self.pages_allocated = 0
        self.cow_copies = 0

    # --- allocator ----------------------------------------------------
    def free_page_count(self) -> int:
        return len(self._free)

    def _pages_for(self, n: int) -> int:
        return -(-n // self.page_size)

    def admission_pages(self, total_len: int, *, lookahead: int = 0,
                        shared: bool = False) -> int:
        """Conservative page bill for admitting a trajectory whose prompt+
        response is ``total_len`` tokens, through ``lookahead`` decode steps.
        A prefix-shared group member only pays for the pages past the shared
        full prompt pages (its partial-page COW + growth)."""
        end = min(total_len + 1 + lookahead, self.max_len)
        need = self._pages_for(end)
        if shared:
            need -= total_len // self.page_size   # full pages ride for free
        return max(need, 0)

    def snapshot_pages(self, snap) -> int:
        return snap["page_count"]

    def _alloc(self) -> int:
        if not self._free:
            raise PageExhausted("physical KV page pool exhausted")
        p = self._free.pop()
        self.refcount[p] = 1
        self.pages_allocated += 1
        return p

    def _decref(self, p: int):
        self.refcount[p] -= 1
        if self.refcount[p] == 0:
            self._free.append(p)

    # --- slot lifecycle ----------------------------------------------
    def _mapped_pages(self, slot: int) -> int:
        row = self.block_table[slot]
        n = int(np.argmax(row == self.num_pages))
        if n == 0 and row[0] != self.num_pages:
            return self.max_pages
        return n

    def alloc_slot_prefix(self, slot: int, length: int) -> np.ndarray:
        need = self._pages_for(length)
        if len(self._free) < need:
            raise PageExhausted(
                f"prefill of {length} tokens needs {need} pages, "
                f"{len(self._free)} free — the admission gate must prevent "
                "this")
        row = self.block_table[slot]
        assert (row == self.num_pages).all(), \
            "alloc_slot_prefix on a slot with mapped pages (free_slot first)"
        for pg in range(need):
            row[pg] = self._alloc()
        return self.flat_positions(slot, 0, length)

    def flat_positions(self, slot: int, start: int, end: int) -> np.ndarray:
        """Physical flat positions for logical positions [start, end);
        unmapped pages yield the out-of-range sentinel
        (num_pages * page_size)."""
        pos = np.arange(start, end)
        phys = self.block_table[slot, pos // self.page_size].astype(np.int64)
        return (phys * self.page_size + pos % self.page_size).astype(np.int32)

    def share_slots(self, src_slot: int, dst_slot: int, length: int):
        """Point ``dst_slot``'s table at ``src_slot``'s pages for the first
        ``length`` tokens (incref). Includes the trailing partial page —
        exclusivity is restored lazily by COW on first write."""
        npg = self._pages_for(length)
        src = self.block_table[src_slot, :npg]
        assert (src < self.num_pages).all(), "sharing unmapped pages"
        dst_row = self.block_table[dst_slot]
        assert (dst_row == self.num_pages).all(), \
            "share_slots target must be empty"
        dst_row[:npg] = src
        for p in src:
            self.refcount[p] += 1

    def grow(self, slot: int, upto: int, write_from: int,
             copies: List[Tuple[int, int]]) -> bool:
        row = self.block_table[slot]
        first_write_pg = write_from // self.page_size
        need_pgs = self._pages_for(upto)
        # fail fast without mutating: count pages this growth will consume
        want = 0
        for pg in range(first_write_pg, need_pgs):
            p = row[pg]
            if p == self.num_pages or self.refcount[p] > 1:
                want += 1
        if want > len(self._free):
            return False
        for pg in range(first_write_pg, need_pgs):
            p = row[pg]
            if p == self.num_pages:
                row[pg] = self._alloc()
            elif self.refcount[p] > 1:                 # copy-on-write
                fresh = self._alloc()
                copies.append((int(p), fresh))
                self._decref(int(p))
                row[pg] = fresh
                self.cow_copies += 1
        return True

    def apply_copies(self, copies: List[Tuple[int, int]]):
        if not copies:
            return
        src, dst = zip(*copies)
        _paged_copy_pages(self.cache, src, dst)

    def free_slot(self, slot: int):
        row = self.block_table[slot]
        for pg in range(self.max_pages):
            if row[pg] == self.num_pages:
                break
            self._decref(int(row[pg]))
            row[pg] = self.num_pages

    # --- snapshots ----------------------------------------------------
    def extract_snapshot(self, slot: int):
        """A page-list snapshot: copies of the slot's mapped pages, never a
        dense slice, and of its per-slot state."""
        npg = self._mapped_pages(slot)
        pages = _paged_extract(self.cache, slot, self.block_table[slot, :npg])
        return {"pages": pages, "page_count": npg}

    def insert_snapshot(self, snap, slot: int):
        npg = snap["page_count"]
        if len(self._free) < npg:
            raise PageExhausted(
                f"snapshot restore needs {npg} pages, {len(self._free)} free")
        row = self.block_table[slot]
        assert (row == self.num_pages).all(), \
            "insert_snapshot target must be empty"
        for pg in range(npg):
            row[pg] = self._alloc()
        _paged_insert_snapshot(self.cache, snap["pages"], slot, row[:npg])
        return True

    # --- decode-time view --------------------------------------------
    def block_table_device(self):
        """A fresh device copy of the block table, (pool, max_pages) int32:
        the host table changes between decode chunks."""
        return torch.tensor(self.block_table, dtype=torch.int32,
                            device=self.device)


def make_backend(name: str, model_cfg, pool: int, max_len: int, *,
                 page_size: int = 16, num_pages: int = 0, dtype=None,
                 device=None, mesh=None) -> CacheBackend:
    if name == "dense":
        return DenseCache(model_cfg, pool, max_len, dtype, device, mesh=mesh)
    if name == "paged":
        if mesh is not None:
            raise NotImplementedError(
                "PagedCache on a mesh is not ported (ROADMAP queue 1): the "
                "reference has no sharding rule for page pools")
        return PagedCache(model_cfg, pool, max_len, page_size=page_size,
                          num_pages=num_pages, dtype=dtype, device=device)
    raise ValueError(f"unknown kv backend {name!r} (dense|paged)")


# ---------------------------------------------------------------------------
# deprecated free-function API (thin shims over the dense layout)
# ---------------------------------------------------------------------------


def _deprecated(name: str):
    import warnings
    warnings.warn(
        f"repro_torch.sampling.kv_cache.{name} is deprecated: use the "
        "CacheBackend API (DenseCache / PagedCache methods) instead — the "
        "free functions only understand the dense slot layout",
        DeprecationWarning, stacklevel=3)


def insert_slots(cache, new_cache, slot_ids):
    """DEPRECATED — scatter full-length per-slot state ``new_cache``
    (batch = len(slot_ids)) into ``cache`` in place at ``slot_ids``;
    out-of-range ids are dropped. Returns ``cache``."""
    _deprecated("insert_slots")
    return dense_insert_rows(cache, new_cache, slot_ids,
                             np.arange(len(slot_ids)))


def insert_slots_prefix(cache, new_cache, slot_ids):
    """DEPRECATED — dense prefill insert: the first S positions of each
    slot, S the length of ``new_cache``."""
    _deprecated("insert_slots_prefix")
    return dense_insert_rows(cache, new_cache, slot_ids,
                             np.arange(len(slot_ids)))


def extract_slots(cache, slot_ids):
    """DEPRECATED — dense per-slot snapshot gather (a copy)."""
    _deprecated("extract_slots")
    ids = torch.as_tensor(np.asarray(slot_ids, np.int64),
                          device=_device(cache))
    return [{name: t.index_select(0, ids) for name, t in layer.items()}
            for layer in cache]


def zero_slots(cache, slot_ids):
    """DEPRECATED — dense slot reset, in place; out-of-range ids are
    dropped. Returns ``cache``."""
    _deprecated("zero_slots")
    pool = next(iter(cache[0].values())).shape[0]
    ids = np.asarray(slot_ids, np.int64)
    ids = torch.from_numpy(ids[(ids >= 0) & (ids < pool)]).to(_device(cache))
    for layer in cache:
        for t in layer.values():
            t[ids] = 0
    return cache
