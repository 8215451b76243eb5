"""Continuous-batching serving engine with a persistent paged KV pool
(PyTorch counterpart of ``repro/serve/engine.py``).

Per routed model the engine keeps one persistent cache pool and decodes
every in-flight request together:

  admission  — ``submit()`` queues a request; when capacity frees up it is
               prefilled in its pow2 length bucket and its K/V written
               into the pool in place. Same-bucket admissions on a paged
               lane coalesce into one (B_b, S_b) prefill with per-row
               ``last_pos``.
  decode     — ``step()`` decodes ONE chunk of ``chunk`` greedy tokens over
               the whole decode batch, each row at its own position. The
               tokens stay on the device for the chunk and are copied to
               the host once at its end.
  completion — a request that has emitted ``max_new`` tokens frees its
               slot and pages at the next chunk boundary.

KV memory comes in two regimes (``EngineConfig.page_size``): the paged
pool (default; decode through the ``paged_decode_attention`` kernel on
CUDA) and the uniform slot pool (``page_size=None``; the
``decode_attention`` kernel). Greedy decode is prefix-stable, so a
request's tokens equal those of serving it alone
(``RoutedServer.generate(engine=False)``).

Not ported yet, each raising ``NotImplementedError`` (queued in
ROADMAP.md): speculative decode (``spec_k > 0``, ``draft``),
``reserve="initial"`` with preemption, bounded queues (``queue_cap``,
``lane_quotas``), deadlines and the cross-silo ``mesh``.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as mdl
from repro_torch.serve.kv_cache import (PageTable, alloc_page_pool,
                                        alloc_slot_pool, write_prefill_pages,
                                        write_slot)


def next_pow2(v: int) -> int:
    return 1 << (max(v, 1) - 1).bit_length()


def region_len(n_tokens: int, max_new: int, chunk: int) -> int:
    """Positions a request writes over its lifetime: the pow2 prefill
    bucket or prompt + whole decode chunks, whichever is larger."""
    steps = -(-max_new // chunk) * chunk
    return max(next_pow2(n_tokens), n_tokens + steps)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine shape (the reference's fields; the ones whose
    features are not ported must keep their defaults)."""
    slots: int = 8     #: concurrent sequences per model (decode batch rows)
    max_seq: int = 256  #: max per-request region: prompt bucket + decode room
    chunk: int = 8     #: decode tokens per chunk (admission period)
    done_buffer: int = 1024  #: finished results kept for drain()
    page_size: Optional[int] = 16  #: page length; None → uniform slot pool
    pages: int = 0  #: allocatable pages; 0 → slots * ceil(max_seq / page_size)
    reserve: str = "lifetime"  #: only "lifetime" is ported
    queue_cap: Optional[int] = None  #: not ported (None only)
    shed_policy: str = "reject-newest"
    lane_quotas: Tuple[Tuple[int, int], ...] = ()  #: not ported (() only)
    spec_k: int = 0  #: speculative decode — not ported (0 only)
    draft: Optional[int] = None  #: not ported (None only)

    @property
    def resolved_pages(self) -> int:
        """Allocatable pages (excluding the trash page)."""
        if not self.page_size:
            return 0
        return self.pages or self.slots * (-(-self.max_seq // self.page_size))


def _unported(ecfg: EngineConfig, mesh) -> Optional[str]:
    if ecfg.spec_k or ecfg.draft is not None:
        return "speculative decode (spec_k > 0 / draft)"
    if ecfg.reserve != "lifetime":
        return f"reserve={ecfg.reserve!r} (initial reservation and preemption)"
    if ecfg.queue_cap is not None or ecfg.lane_quotas:
        return "bounded admission queues (queue_cap / lane_quotas)"
    if mesh is not None:
        return "cross-silo mesh execution"
    return None


@dataclasses.dataclass
class _Active:
    rid: int
    max_new: int
    chunks: List[np.ndarray] = dataclasses.field(default_factory=list)
    emitted: int = 0


@dataclasses.dataclass
class _Pending:
    rid: int
    toks: np.ndarray           # (S,) int32 prompt tokens, unpadded
    max_new: int


class _Lane:
    """Per-model engine state: the KV pool (paged or uniform) and the
    host-side slot and page bookkeeping."""

    def __init__(self, pm, ecfg: EngineConfig, device: torch.device):
        self.pm = pm
        self.paged = bool(ecfg.page_size)
        if self.paged:
            self.pool = alloc_page_pool(pm.cfg, ecfg.resolved_pages,
                                        ecfg.page_size, device=device)
            self.pt = PageTable(ecfg.slots, ecfg.resolved_pages,
                                ecfg.page_size, ecfg.max_seq)
        else:
            self.pool = alloc_slot_pool(pm.cfg, ecfg.slots, ecfg.max_seq,
                                        device=device)
            self.pt = None
        self.free: List[int] = list(range(ecfg.slots))[::-1]
        self.active: Dict[int, _Active] = {}             # slot -> request
        self.queue: Deque[_Pending] = collections.deque()
        self.tok = np.zeros((ecfg.slots,), np.int32)     # next token to feed
        self.pos = np.zeros((ecfg.slots,), np.int32)     # its write position


def _prefill(cfg: ModelConfig, params, toks: np.ndarray, last_pos,
             device) -> tuple:
    """Prefill one prompt bucket → (first greedy token (B,), KV cache).
    The same math as the gateway's per-request prefill (same q_chunk, same
    last_pos unembed), so engine tokens equal solo tokens."""
    t = torch.as_tensor(toks, device=device)
    lp = torch.as_tensor(last_pos, device=device)
    logits, _, cache = mdl.forward(params, cfg, tokens=t,
                                   logits_last_only=True, last_pos=lp,
                                   return_cache=True, q_chunk=64)
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache


class ServeEngine:
    """Admission queue + KV pools over a model pool (dense archs).

    ``submit`` enqueues, ``step`` admits + decodes one chunk per lane,
    ``drain`` steps until idle and returns {request id: np tokens}. Runs
    on the CUDA device unless ``device`` names another; the pool's
    parameters must live there.
    """

    def __init__(self, pool: List, ecfg: Optional[EngineConfig] = None, *,
                 mesh=None, device: DeviceLike = None):
        self.ecfg = ecfg or EngineConfig()
        what = _unported(self.ecfg, mesh)
        if what is not None:
            raise NotImplementedError(f"ServeEngine: {what} is not ported to "
                                      "the PyTorch engine yet")
        self.device = resolve_device(device)
        self.pool = pool
        self._lanes: Dict[int, _Lane] = {}
        self._next_rid = 0
        self._done: Dict[int, np.ndarray] = {}
        self._events: List[Tuple[int, np.ndarray]] = []

    def _region_len(self, n_tokens: int, max_new: int) -> int:
        return region_len(n_tokens, max_new, self.ecfg.chunk)

    def fits(self, n_tokens: int, max_new: int) -> bool:
        """Whether a request can ever be admitted: its written region must
        stay inside ``max_seq``, and on paged lanes its page count must
        not exceed the whole pool."""
        region = self._region_len(n_tokens, max_new)
        if region > self.ecfg.max_seq:
            return False
        if self.ecfg.page_size:
            need = -(-region // self.ecfg.page_size)
            return need <= self.ecfg.resolved_pages
        return True

    def n_active(self) -> int:
        """Requests currently holding decode capacity (all lanes)."""
        return sum(len(lane.active) for lane in self._lanes.values())

    # ------------------------------------------------------------- submit
    def submit(self, model_idx: int, toks: np.ndarray, max_new: int, *,
               deadline: Optional[int] = None,
               draft: Optional[int] = None) -> int:
        """Enqueue a request; returns its rid."""
        if deadline is not None:
            raise NotImplementedError("ServeEngine.submit: deadlines are not "
                                      "ported to the PyTorch engine yet")
        if draft is not None:
            raise ValueError("submit(draft=...) needs a speculative engine, "
                             "which is not ported yet")
        pm = self.pool[int(model_idx)]
        if pm.cfg.arch_type != "dense":
            raise NotImplementedError(f"{pm.cfg.name}: only dense archs are "
                                      "ported to the PyTorch engine")
        toks = np.asarray(toks, np.int32).reshape(-1)
        if not self.fits(len(toks), max_new):
            raise ValueError(
                f"prompt ({len(toks)} tokens, pow2 bucket "
                f"{next_pow2(len(toks))}) + whole decode chunks for "
                f"max_new={max_new} exceed the per-request region "
                f"max_seq={self.ecfg.max_seq}"
                + (f" or the page pool ({self.ecfg.resolved_pages} pages of "
                   f"{self.ecfg.page_size})" if self.ecfg.page_size else "")
                + " — raise EngineConfig.max_seq/pages or shorten the "
                "request (RoutedServer.generate falls back to the per-call "
                "path automatically)")
        rid = self._next_rid
        self._next_rid += 1
        lane = self._lanes.get(int(model_idx))
        if lane is None:
            if mdl.params_device(pm.params) != self.device:
                raise ValueError(
                    f"{pm.name}: params live on "
                    f"{mdl.params_device(pm.params)}, the engine on "
                    f"{self.device}")
            lane = self._lanes[int(model_idx)] = _Lane(pm, self.ecfg,
                                                       self.device)
        lane.queue.append(_Pending(rid, toks, max_new))
        return rid

    def _record(self, rid: int, tokens: np.ndarray) -> None:
        self._events.append((rid, tokens))
        self._done[rid] = tokens

    def _release_slot(self, lane: _Lane, slot: int) -> None:
        """Free a slot between chunks: slot to the free list, pages to the
        page free list, carry zeroed. Host bookkeeping only."""
        del lane.active[slot]
        lane.free.append(slot)
        if lane.paged:
            lane.pt.release(slot)
        lane.tok[slot] = 0
        lane.pos[slot] = 0

    # --------------------------------------------------------------- step
    def step(self) -> List[Tuple[int, np.ndarray]]:
        """Admit, then decode one chunk on every busy lane. Returns the
        requests that completed this step as (rid, np tokens); they are
        also kept for ``drain()`` (up to ``done_buffer``, oldest evicted)."""
        for lane in self._lanes.values():
            self._admit(lane)
        for lane in self._lanes.values():
            if lane.active:
                self._decode_chunk(lane)
        finished = self._events
        self._events = []
        while len(self._done) > self.ecfg.done_buffer:
            self._done.pop(next(iter(self._done)))
        return finished

    @property
    def busy(self) -> bool:
        return any(l.queue or l.active for l in self._lanes.values())

    def drain(self, rids=None) -> Dict[int, np.ndarray]:
        """Step until completion and return {rid: np tokens}. With
        rids=None, runs until every lane is idle and returns (and clears)
        everything; with an iterable of request ids, runs until exactly
        those complete and leaves other results in place."""
        if rids is None:
            out = dict(self._done)
            while self.busy:
                out.update(self.step())
            out.update(self._done)
            self._done = {}
            self._events = []
            return out
        want = set(rids)
        out = {r: self._done.pop(r) for r in want if r in self._done}
        self._events = [(r, p) for r, p in self._events if r not in out]
        while want - out.keys():
            if not self.busy:
                raise KeyError(f"unknown request ids: "
                               f"{sorted(want - out.keys())}")
            for rid, payload in self.step():
                if rid in want:
                    out[rid] = payload
                    self._done.pop(rid, None)
        return out

    # ------------------------------------------------------------ internals
    def _activate(self, lane: _Lane, req: _Pending, slot: int, tok0: int,
                  S: int) -> None:
        lane.tok[slot] = tok0
        lane.pos[slot] = S          # first decode token writes K/V at S
        lane.active[slot] = _Active(req.rid, req.max_new)

    def _admit(self, lane: _Lane) -> None:
        if lane.paged:
            self._admit_paged(lane)
            return
        cfg, params = lane.pm.cfg, lane.pm.params
        while lane.free and lane.queue:
            req = lane.queue.popleft()
            slot = lane.free.pop()
            S = len(req.toks)
            toks_p = np.zeros((1, next_pow2(S)), np.int32)
            toks_p[0, :S] = req.toks
            tok0, kv = _prefill(cfg, params, toks_p, S - 1, self.device)
            write_slot(lane.pool, kv, slot)
            self._activate(lane, req, slot, int(tok0[0]), S)

    def _admit_paged(self, lane: _Lane) -> None:
        """Paged admission: claim a decode slot + the pages of the whole
        region (FIFO — the head waits for pages rather than being
        overtaken), then COALESCE everything admitted this boundary by
        prompt bucket: one (B_b, S_b) prefill per bucket with per-row
        ``last_pos`` and one page scatter. Pad rows of a non-pow2 group
        prefill garbage into the trash page."""
        ps = self.ecfg.page_size
        admitted = []                   # (req, slot, S, S_b, pages)
        while lane.queue:
            req = lane.queue[0]
            S = len(req.toks)
            need = lane.pt.pages_needed(self._region_len(S, req.max_new))
            if not lane.free or need > lane.pt.available:
                break
            lane.queue.popleft()
            slot = lane.free.pop()
            pages = lane.pt.alloc(slot, need)
            admitted.append((req, slot, S, next_pow2(S), pages))
        groups: Dict[int, list] = {}
        for item in admitted:
            groups.setdefault(item[3], []).append(item)
        cfg, params = lane.pm.cfg, lane.pm.params
        for S_b, items in sorted(groups.items()):
            B_b = next_pow2(len(items))
            n_pp = -(-S_b // ps)        # pages the prefill bucket covers
            toks_p = np.zeros((B_b, S_b), np.int32)
            last = np.zeros((B_b,), np.int64)
            pages_mat = np.zeros((B_b, n_pp), np.int32)   # pad rows → trash
            for r, (req, slot, S, _, pages) in enumerate(items):
                toks_p[r, :S] = req.toks
                last[r] = S - 1
                pages_mat[r] = pages[:n_pp]
            tok0, kv = _prefill(cfg, params, toks_p, last, self.device)
            write_prefill_pages(lane.pool, kv, pages_mat)
            tok0 = tok0.cpu().numpy()
            for r, (req, slot, S, _, _) in enumerate(items):
                self._activate(lane, req, slot, int(tok0[r]), S)

    def _decode_chunk(self, lane: _Lane) -> None:
        """``chunk`` greedy steps over the whole decode batch. Free rows
        decode garbage at (tok 0, pos 0): on a paged lane their table row
        is all trash page, and on a uniform lane the next occupant's
        prefill and decode write every position before validity reaches
        it, so nothing they write is ever attended."""
        cfg, ecfg, params = lane.pm.cfg, self.ecfg, lane.pm.params
        dev = self.device
        tok = torch.as_tensor(lane.tok, device=dev)
        pos = torch.as_tensor(lane.pos, device=dev)
        table = (torch.as_tensor(lane.pt.table, device=dev) if lane.paged
                 else None)
        out = []
        for _ in range(ecfg.chunk):
            if lane.paged:
                logits, _ = mdl.decode_step_paged(
                    params, lane.pool, cfg, tokens=tok[:, None],
                    page_table=table, pos=pos)
            else:
                logits, _ = mdl.decode_step(params, lane.pool, cfg,
                                            tokens=tok[:, None], pos=pos)
            out.append(tok)
            tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
            pos = pos + 1
        # one device → host copy per chunk: the emitted tokens + the carry
        out_np = torch.stack(out + [tok], dim=1).cpu().numpy()
        active = np.zeros((ecfg.slots,), bool)
        active[list(lane.active)] = True
        lane.tok = np.where(active, out_np[:, -1], 0).astype(np.int32)
        lane.pos = np.where(active, lane.pos + ecfg.chunk, 0).astype(np.int32)
        out_np = out_np[:, :-1]
        for slot in list(lane.active):
            st = lane.active[slot]
            st.chunks.append(out_np[slot])
            st.emitted += ecfg.chunk
            if st.emitted >= st.max_new:
                tokens = np.concatenate(st.chunks)[:st.max_new]
                self._release_slot(lane, slot)
                self._record(st.rid, tokens)
