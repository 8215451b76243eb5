"""KV-cache utilities for the serving path (PyTorch counterpart of
``repro/serve/kv_cache.py``).

Three cache regimes, as in the reference:

* ``extend_cache`` — the per-request regime: a prefill cache is padded up
  to prompt + max_new so one batch can decode
  (``RoutedServer.generate(engine=False)``).
* the **slot pool** — one persistent cache per model with ``slots``
  sequence rows of ``max_seq`` positions each; ``write_slot`` copies a
  request's prefill K/V into its row.
* the **page pool** — one flat pool of fixed-size pages shared by every
  in-flight request, addressed through per-request page tables
  (``PageTable``). Page 0 is the **trash page**: never handed out, the
  scatter target of inactive decode rows and the table filler past a
  request's reservation — reads from it are masked by validity.

A speculative lane also keeps, per drafter, a uniform slot pool with
``spec_k`` positions of headroom (``alloc_draft_pool``).

The pools are written in place (the reference donates their buffers).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F


def extend_cache(cache, new_len: int):
    """Pad the seq dim of the attention leaves (``k``/``v``, dim 3 of the
    stacked (L, B, Hkv, S, hd) layout) of a prefill cache up to
    ``new_len`` — used to continue decoding. SSM leaves (``conv``,
    ``state``) are not positional and pass through unchanged."""
    def leaf(name, a):
        pad = new_len - a.shape[3] if name in ("k", "v") else 0
        return F.pad(a, (0, 0, 0, pad)) if pad > 0 else a
    return {name: {k: leaf(k, v) for k, v in layer.items()}
            for name, layer in cache.items()}


def alloc_slot_pool(cfg, slots: int, max_seq: int, *, device):
    """The persistent slot-pool cache for one model: ``slots`` sequence
    rows of ``max_seq`` positions, zero-filled."""
    from repro_torch.models import model as mdl
    return mdl.init_decode_cache(cfg, slots, max_seq, device=device)


def write_slot(pool, prefill_cache, slot: int):
    """Copy a single-sequence prefill cache (leaves (L, 1, Hkv, S, hd))
    into row ``slot`` of the pool, positions [0, S). Anything beyond stays
    whatever the previous occupant wrote, masked by per-slot validity."""
    for name, layer in pool.items():
        for k, p in layer.items():
            u = prefill_cache[name][k]
            p[:, slot, :, :u.shape[3]] = u[:, 0].to(p.dtype)
    return pool


def alloc_draft_pool(cfg, slots: int, max_seq: int, spec_k: int, *, device):
    """The drafter's slot pool for a speculative lane: a uniform pool with
    ``spec_k`` positions of write-ahead headroom past the target's region.
    The drafter decodes sequentially through the speculative window, and
    its last draft for a request ending flush at ``max_seq`` writes at
    position ``max_seq + spec_k - 1``; without the headroom the clamped
    one-token write would land on the region's live tail (costing
    acceptance, never correctness: the verify decides every token)."""
    return alloc_slot_pool(cfg, slots, max_seq + spec_k, device=device)


def alloc_page_pool(cfg, pages: int, page_size: int, *, device):
    """The persistent paged cache for one model: leaves
    (n_units, pages + 1, Hkv, page_size, hd) — ``pages`` allocatable pages
    plus the trash page at index 0. Zero-filled."""
    from repro_torch.models import model as mdl
    return mdl.init_paged_cache(cfg, pages + 1, page_size, device=device)


class PageTable:
    """Host-side page bookkeeping for one engine lane: a free list over
    pool pages [1, pages] (0 is the trash page) and one table row per
    decode slot mapping logical blocks → pool pages. Unassigned entries
    stay 0. Recycling a slot returns its pages to the free list and zeroes
    its row; no data moves."""

    def __init__(self, slots: int, pages: int, page_size: int, max_seq: int):
        self.page_size = page_size
        self.pages = pages
        self.max_pages = -(-max_seq // page_size)    # table width (static)
        self.table = np.zeros((slots, self.max_pages), np.int32)
        self.free: List[int] = list(range(pages, 0, -1))   # pop() → page 1
        self._held: Dict[int, List[int]] = {}              # slot → pages

    def pages_needed(self, region_len: int) -> int:
        return -(-region_len // self.page_size)

    @property
    def available(self) -> int:
        return len(self.free)

    def held(self, slot: int) -> int:
        """Pages currently held by ``slot`` (0 if none)."""
        return len(self._held.get(slot, ()))

    def alloc(self, slot: int, n: int) -> np.ndarray:
        """Claim n pages for ``slot``; returns their pool indices in
        logical-block order. Raises if the pool is exhausted (callers gate
        admission on ``available``)."""
        if n > len(self.free):
            raise RuntimeError(f"page pool exhausted: need {n}, "
                               f"have {len(self.free)}")
        if slot in self._held:
            raise RuntimeError(f"slot {slot} already holds pages")
        got = [self.free.pop() for _ in range(n)]
        self.table[slot, :n] = got
        self.table[slot, n:] = 0
        self._held[slot] = got
        return np.asarray(got, np.int32)

    def grow(self, slot: int, n: int) -> np.ndarray:
        """On-demand growth: append ``n`` more pages to a slot that already
        holds some (initial reservation: the engine grows a request's row
        right before its writes cross a page boundary). Raises on a slot
        holding nothing (growth is not admission), past the table width,
        and on exhaustion (callers preempt a victim first)."""
        if slot not in self._held:
            raise RuntimeError(f"slot {slot} holds no pages — grow() "
                               "extends an existing reservation; use "
                               "alloc() to admit")
        held = self._held[slot]
        if len(held) + n > self.max_pages:
            raise RuntimeError(
                f"slot {slot} cannot grow to {len(held) + n} pages: the "
                f"table row is {self.max_pages} wide (max_seq-bound)")
        if n > len(self.free):
            raise RuntimeError(f"page pool exhausted: grow needs {n}, "
                               f"have {len(self.free)}")
        got = [self.free.pop() for _ in range(n)]
        self.table[slot, len(held):len(held) + n] = got
        held.extend(got)
        return np.asarray(got, np.int32)

    def release(self, slot: int) -> bool:
        """Return a slot's pages to the free list and zero its row.
        Deterministic under the cancel, expiry and preemption paths: a slot
        holding nothing (a double release included) is a no-op returning
        False, so the free list is never corrupted; a slot outside the
        table is a caller's bug and raises IndexError."""
        if not 0 <= int(slot) < self.table.shape[0]:
            raise IndexError(
                f"slot {slot} outside the page table "
                f"(slots={self.table.shape[0]})")
        pages = self._held.pop(slot, None)
        if pages is None:
            return False
        self.free.extend(pages)
        self.table[slot] = 0
        return True


def write_prefill_pages(pool, prefill_cache, pages_mat):
    """Scatter a batched prefill cache (leaves (L, B, Hkv, S_b, hd)) into
    the page pool (leaves (L, P, Hkv, ps, hd)): row b's logical positions
    [i*ps, (i+1)*ps) land in pool page ``pages_mat[b, i]``. ``pages_mat``
    is (B, n_pp) with n_pp = ceil(S_b / ps); pad rows of a coalesced batch
    point every entry at the trash page. S_b short of a page multiple is
    zero-padded (masked until decode overwrites it)."""
    idx = torch.as_tensor(np.asarray(pages_mat), dtype=torch.long)
    n_pp = idx.shape[1]
    for name, layer in pool.items():
        for k, p in layer.items():
            u = prefill_cache[name][k]
            L, B, Hkv, S_b, hd = u.shape
            ps = p.shape[3]
            if S_b < n_pp * ps:
                u = F.pad(u, (0, 0, 0, n_pp * ps - S_b))
            u = u.reshape(L, B, Hkv, n_pp, ps, hd).transpose(2, 3)
            p[:, idx.to(p.device)] = u.to(p.dtype)
    return pool
