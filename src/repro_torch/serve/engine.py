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

**Overload.** A request may carry a ``deadline`` (engine steps) and may be
cancelled; both release its slot and pages between chunks. Paged lanes
with ``reserve="initial"`` claim only the prefill bucket's pages at
admission and grow on demand before each chunk; under page pressure the
engine preempts the lowest-priority request (latest deadline, then fewest
tokens generated) and re-queues it as a prefill of prompt + tokens so far,
so its tokens equal those of never preempting it. A bounded queue
(``queue_cap``, per-model ``lane_quotas``) sheds excess load. Every
request ends in exactly one terminal status — ``DONE``,
``PREEMPTED-resumed``, ``EXPIRED``, ``CANCELLED`` or ``SHED`` — surfaced
through ``step()``, ``drain()`` and ``status()``; ``counters()`` holds the
exact accounting.

**Speculative decode** (``spec_k > 0``): each round a drafter (the target
itself, ``EngineConfig.draft``, or ``submit(draft=)``, which the gateway
picks by the router's ranking) decodes ``spec_k`` tokens ahead in its own
uniform slot pool, the target verifies them in one multi-position call
(``models.decode_verify[_paged]``: on CUDA through the same decode
kernels, at the same ``n_valid``, as the plain step), and the longest
matching prefix commits with the verify's correction token. Tokens equal
the non-speculative engine's.

**Architectures.** Dense, MoE and VLM models decode here (MoE layers in
the dense dispatch, so a token's output does not depend on its batch
mates). SSM and hybrid models are refused with ``TypeError``, as in the
reference: their state integrates every position, pad included, so they
cannot share padded buckets; the gateway serves them per call.

**Cross-silo mesh** (``mesh=``, a ``DeviceMesh`` from ``sharding`` over
the whole default process group, one process per device: nccl with CUDA,
gloo with the CPU). Every process runs the same host bookkeeping — the
caller submits the same requests in every process, the usual SPMD driver
— and holds its block of each KV pool (``sharding.shard_kv_pool``): its
slots over ``"data"`` and its KV heads over ``"heads"``. Every process
prefills each admission (the same prefill as solo); a slot's owner writes
its block of heads into its pool. Each process decodes its slots
(``sharding.SlotBlock``), and one all-gather over ``"data"`` of the chunk's
``(slots/n, chunk + 1)`` int32 tokens replaces the chunk's one
device-to-host copy, so every process sees the whole batch; over
``"heads"`` each layer attends over the process's heads and all-gathers
their outputs in head order (``models/attention.py``). Speculative rounds
split the drafter pools the same way, and gather the drafts and the
verify's argmax. Tokens and ``counters()`` equal the solo engine's. A
paged lane keeps its page pool whole on the page dimension in every
process (the reference's ``kv_pool_spec`` would split pages over
``"data"`` where they divide it): its slots are split, each process writes
only its slots' pages, and the page table stays the same host state in
every process. Without a mesh the engine runs as it always did.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import sharding as shd
from repro_torch import tracing
from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as mdl
from repro_torch.serve.kv_cache import (PageTable, alloc_draft_pool,
                                        alloc_page_pool, alloc_slot_pool,
                                        write_prefill_pages, write_slot)


def next_pow2(v: int) -> int:
    return 1 << (max(v, 1) - 1).bit_length()


def region_len(n_tokens: int, max_new: int, chunk: int) -> int:
    """Positions a request writes over its lifetime: the pow2 prefill
    bucket or prompt + whole decode chunks, whichever is larger."""
    steps = -(-max_new // chunk) * chunk
    return max(next_pow2(n_tokens), n_tokens + steps)


#: typed terminal statuses. A completed request (DONE, or
#: PREEMPTED-resumed after >= 1 preemption) surfaces its np token array;
#: EXPIRED / CANCELLED / SHED surface an ``Outcome`` with any partial
#: tokens.
DONE = "DONE"
PREEMPTED_RESUMED = "PREEMPTED-resumed"
EXPIRED = "EXPIRED"
CANCELLED = "CANCELLED"
SHED = "SHED"
TERMINAL_STATUSES = (DONE, PREEMPTED_RESUMED, EXPIRED, CANCELLED, SHED)

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class Outcome:
    """Terminal record of a request that did NOT complete: ``status`` is
    EXPIRED / CANCELLED / SHED and ``tokens`` holds what it emitted before
    (None if nothing). Surfaced in place of the token array."""
    rid: int
    status: str
    tokens: Optional[np.ndarray] = None


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine shape."""
    slots: int = 8     #: concurrent sequences per model (decode batch rows)
    max_seq: int = 256  #: max per-request region: prompt bucket + decode room
    chunk: int = 8     #: decode tokens per chunk (admission period)
    done_buffer: int = 1024  #: finished results kept for drain()
    page_size: Optional[int] = 16  #: page length; None → uniform slot pool
    pages: int = 0  #: allocatable pages; 0 → slots * ceil(max_seq / page_size)
    #: "lifetime" claims every page a request can write at admission
    #: (admission waits for pages, never preempts); "initial" claims the
    #: prefill bucket's pages, grows per chunk and preempts under pressure
    reserve: str = "lifetime"
    queue_cap: Optional[int] = None  #: queued requests per lane; None = no cap
    #: which request a full lane queue sheds: "reject-newest" (the incoming
    #: one) or "reject-latest-deadline" (of queue ∪ incoming, the latest
    #: effective deadline, newest rid on ties)
    shed_policy: str = "reject-newest"
    lane_quotas: Tuple[Tuple[int, int], ...] = ()  #: (model_idx, cap) overrides
    spec_k: int = 0  #: tokens drafted per speculative round; 0 = plain decode
    draft: Optional[int] = None  #: default drafter; None → the target itself

    @property
    def resolved_pages(self) -> int:
        """Allocatable pages (excluding the trash page)."""
        if not self.page_size:
            return 0
        return self.pages or self.slots * (-(-self.max_seq // self.page_size))


def _empty_toks() -> np.ndarray:
    return np.zeros((0,), np.int32)


@dataclasses.dataclass
class _Active:
    rid: int
    max_new: int               # total decode budget (prefix included)
    toks: np.ndarray           # the original prompt (for a preemption)
    deadline: Optional[int] = None   # absolute engine-step bound
    #: tokens emitted before the last preemption (this tenure prefilled
    #: prompt + prefix; ``chunks`` holds only the current tenure's)
    prefix: np.ndarray = dataclasses.field(default_factory=_empty_toks)
    #: committed tokens only: a speculative round appends its accepted
    #: prefix after the verify, never raw drafts
    chunks: List[np.ndarray] = dataclasses.field(default_factory=list)
    emitted: int = 0           # total emitted, prefix included
    preempts: int = 0
    draft: int = -1            # drafter pool index (spec mode)
    #: len(prompt) + max_new: speculative page growth stops here (the
    #: write-ahead past it lands in the trash page)
    region: int = 0


@dataclasses.dataclass
class _Pending:
    rid: int
    toks: np.ndarray           # (S,) int32 prompt tokens, unpadded
    max_new: int
    deadline: Optional[int] = None
    #: tokens emitted before a preemption: admission prefills prompt +
    #: prefix (recompute on resume)
    prefix: np.ndarray = dataclasses.field(default_factory=_empty_toks)
    preempts: int = 0
    draft: int = -1

    def eff_deadline(self) -> float:
        return _INF if self.deadline is None else float(self.deadline)


class _Lane:
    """Per-model engine state: the KV pool (paged or uniform), the
    drafters' pools, and the host-side slot and page bookkeeping."""

    def __init__(self, index: int, pm, ecfg: EngineConfig,
                 device: torch.device, mesh=None):
        self.index = index          #: the model's pool index
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
        #: speculative mode: drafter pool index → its uniform slot pool
        #: (``alloc_draft_pool``), allocated at first use. Row s mirrors
        #: slot s; a row holds garbage until the draft prefill of its next
        #: occupant drafting with that model overwrites it.
        self.draft_pools: Dict[int, dict] = {}
        #: on a mesh: this process's block of the slots (``rows`` are the
        #: slots it decodes) and of the KV heads of the target and of each
        #: drafter; None where that dimension is not split
        self.slots: Optional[shd.SlotBlock] = None
        self.heads: Optional[shd.HeadBlock] = None
        self.draft_heads: Dict[int, Optional[shd.HeadBlock]] = {}
        self.rows = slice(0, ecfg.slots)
        if mesh is not None:
            shd.replicate(pm.params, mesh)
            self.slots = shd.SlotBlock.of(mesh, ecfg.slots)
            self.heads = shd.HeadBlock.of(mesh, pm.cfg.n_kv_heads)
            if self.slots is not None:
                self.rows = self.slots.rows
            self.pool = shd.shard_kv_pool(self.pool, mesh, paged=self.paged)

    def write_slot(self, pool: dict, heads, kv: dict, slot: int) -> None:
        """Write a one-row prefill cache into row ``slot`` of a slot pool
        (the target's or a drafter's, whose head block is ``heads``): on a
        mesh only the slot's owner writes, and only its heads."""
        if self.slots is not None:
            if not self.slots.owns(slot):
                return
            slot -= self.slots.lo
        write_slot(pool, kv if heads is None else heads.kv(kv), slot)

    def host(self, t: torch.Tensor) -> np.ndarray:
        """(rows, ...) results of the slots this process decodes →
        (slots, ...) numpy: on a slot-split lane one all-gather over
        "data" first, then the one device-to-host copy."""
        if self.slots is not None:
            t = self.slots.gather(t)
        return t.cpu().numpy()


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
    """Admission queue + KV pools over a model pool (attention archs).

    ``submit`` enqueues, ``step`` admits + decodes one chunk per lane,
    ``drain`` steps until idle and returns {request id: result}. Runs on
    the CUDA device unless ``device`` names another; the pool's parameters
    must live there.
    """

    def __init__(self, pool: List, ecfg: Optional[EngineConfig] = None, *,
                 mesh=None, device: DeviceLike = None):
        self.ecfg = ecfg = ecfg or EngineConfig()
        self.device = resolve_device(device)
        #: the cross-silo mesh (see the module doc); None runs solo
        self.mesh = mesh
        if mesh is not None:
            names = getattr(mesh, "mesh_dim_names", None)
            if names is None:
                raise TypeError(
                    "ServeEngine mesh= must be a DeviceMesh with a \"data\" "
                    "and/or \"heads\" dimension (sharding.data_mesh()/"
                    f"head_mesh()/make_mesh()), got {type(mesh).__name__}")
            if not any(a in names for a in ("data", "heads")):
                raise ValueError(
                    f"ServeEngine mesh carries axes {tuple(names)} — the "
                    "engine shards over \"data\" (slot-parallel) and/or "
                    "\"heads\" (tensor-parallel); build one with "
                    "sharding.data_mesh()/head_mesh()/make_mesh()")
            if mesh.device_type != self.device.type:
                raise ValueError(
                    f"ServeEngine mesh is over {mesh.device_type} devices "
                    f"(nccl runs CUDA, gloo the CPU), the engine on "
                    f"{self.device}")
        if ecfg.reserve not in ("lifetime", "initial"):
            raise ValueError(f"EngineConfig.reserve={ecfg.reserve!r}: "
                             "expected 'lifetime' or 'initial'")
        if ecfg.reserve == "initial" and not ecfg.page_size:
            raise ValueError("reserve='initial' is a paged-pool feature — "
                             "uniform slot lanes reserve max_seq per slot "
                             "by construction (set page_size)")
        if ecfg.shed_policy not in ("reject-newest", "reject-latest-deadline"):
            raise ValueError(
                f"EngineConfig.shed_policy={ecfg.shed_policy!r}: expected "
                "'reject-newest' or 'reject-latest-deadline'")
        if ecfg.spec_k < 0:
            raise ValueError(f"EngineConfig.spec_k={ecfg.spec_k}: the "
                             "drafted window cannot be negative")
        if ecfg.draft is not None:
            if ecfg.spec_k == 0:
                raise ValueError("EngineConfig.draft without spec_k > 0: a "
                                 "drafter only exists in speculative mode")
            if not 0 <= int(ecfg.draft) < len(pool):
                raise ValueError(
                    f"EngineConfig.draft={ecfg.draft}: not a model pool "
                    f"index (pool has {len(pool)} models)")
        self.pool = pool
        self._lanes: Dict[int, _Lane] = {}
        self._next_rid = 0
        self._done: Dict[int, object] = {}
        self._lane_caps = dict(ecfg.lane_quotas)
        #: step() calls so far — the deadline clock
        self._steps = 0
        self._status: Dict[int, str] = {}   # rid → terminal status, bounded
        #: terminal records since the last step()/drain() flush
        self._events: List[Tuple[int, object]] = []
        #: exact accounting; reset by assigning 0
        self.sheds = 0
        self.preemptions = 0
        self.expiries = 0
        self.cancels = 0
        #: prompt + prefix positions re-prefilled by preemption resumes
        self.resume_recompute_toks = 0
        self.queue_depth_hw = 0      #: queue-depth high-water across lanes
        #: high-water of concurrently admitted requests, sampled between
        #: admission and decode
        self.peak_active = 0
        #: speculative rounds, tokens drafted (spec_k per active row per
        #: round), accepted and rejected; acceptance rate =
        #: spec_accepted / spec_drafted
        self.spec_rounds = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_rejected = 0

    def _region_len(self, n_tokens: int, max_new: int) -> int:
        return region_len(n_tokens, max_new, self.ecfg.chunk)

    def _region_cap(self, n_tokens: int, max_new: int) -> int:
        """Worst-case region a request may ever need. Under initial
        reservation it also covers the worst resume: a request preempted
        after k emitted tokens re-prefills n_tokens + k in its pow2 bucket,
        and the last chunk boundary before max_new is the largest such k.
        Admitting only requests whose worst resume fits keeps every
        preempted request resumable and lets a lone request always
        complete (no preemption livelock)."""
        region = self._region_len(n_tokens, max_new)
        if self.ecfg.page_size and self.ecfg.reserve == "initial":
            chunk = self.ecfg.chunk
            k_max = (-(-max_new // chunk) - 1) * chunk
            region = max(region, next_pow2(n_tokens + k_max))
        return region

    def fits(self, n_tokens: int, max_new: int) -> bool:
        """Whether a request can ever be admitted: its region (with the
        worst resume bucket under initial reservation, ``_region_cap``)
        must stay inside ``max_seq``, and on paged lanes its page count
        must not exceed the whole pool."""
        region = self._region_cap(n_tokens, max_new)
        if region > self.ecfg.max_seq:
            return False
        if self.ecfg.page_size:
            need = -(-region // self.ecfg.page_size)
            return need <= self.ecfg.resolved_pages
        return True

    def kv_pool_bytes(self) -> int:
        """Bytes held by every lane's persistent KV pool (paged pools
        include the trash page)."""
        return sum(t.numel() * t.element_size()
                   for lane in self._lanes.values()
                   for layer in lane.pool.values() for t in layer.values())

    def n_active(self) -> int:
        """Requests currently holding decode capacity (all lanes)."""
        return sum(len(lane.active) for lane in self._lanes.values())

    def _check_device(self, pm) -> None:
        if mdl.params_device(pm.params) != self.device:
            raise ValueError(f"{pm.name}: params live on "
                             f"{mdl.params_device(pm.params)}, the engine "
                             f"on {self.device}")

    def _resolve_draft(self, model_idx: int, draft, pm) -> int:
        """A request's drafter (spec mode): ``submit(draft=)``, else
        ``EngineConfig.draft``, else the target itself. It must share the
        target's vocabulary and be an attention arch (its cache rolls back
        by position)."""
        d = int(draft if draft is not None
                else (self.ecfg.draft if self.ecfg.draft is not None
                      else model_idx))
        if not 0 <= d < len(self.pool):
            raise ValueError(f"draft={d}: not a model pool index "
                             f"(pool has {len(self.pool)} models)")
        dcfg = self.pool[d].cfg
        if dcfg.arch_type in ("ssm", "hybrid"):
            raise TypeError(f"{dcfg.name}: SSM/hybrid drafters cannot roll "
                            "back a rejected suffix (state is not "
                            "positional) — pick an attention drafter")
        if dcfg.vocab != pm.cfg.vocab:
            raise ValueError(
                f"drafter {dcfg.name} (vocab {dcfg.vocab}) and target "
                f"{pm.cfg.name} (vocab {pm.cfg.vocab}) don't share a token "
                "space — drafted tokens would be meaningless to verify")
        if d != model_idx:
            self._check_device(self.pool[d])
        return d

    # ------------------------------------------------------------- submit
    def submit(self, model_idx: int, toks: np.ndarray, max_new: int, *,
               deadline: Optional[int] = None,
               draft: Optional[int] = None) -> int:
        """Enqueue a request; returns its rid. ``deadline``: after that
        many further ``step()`` calls an unfinished request EXPIREs (None:
        never). A full lane queue (``queue_cap`` / ``lane_quotas``) SHEDs
        per ``shed_policy``; the shed rid still comes back and its
        ``Outcome`` surfaces through the next step()/drain(). ``draft``
        (speculative mode only) picks this request's drafter by pool
        index."""
        pm = self.pool[int(model_idx)]
        if pm.cfg.arch_type in ("ssm", "hybrid"):
            raise TypeError(
                f"{pm.cfg.name}: SSM/hybrid archs integrate state over pad "
                "positions and can't share right-padded slot buckets — use "
                "RoutedServer.generate (it serves them per call)")
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
        if deadline is not None and int(deadline) < 1:
            raise ValueError(f"deadline={deadline}: a request needs at "
                             "least one engine step to make progress")
        lane = self._lanes.get(int(model_idx))
        if lane is None:
            self._check_device(pm)
        if self.ecfg.spec_k > 0:
            draft_idx = self._resolve_draft(int(model_idx), draft, pm)
        elif draft is not None:
            raise ValueError("submit(draft=...) needs EngineConfig.spec_k "
                             "> 0 — the non-speculative engine has no "
                             "drafter")
        else:
            draft_idx = -1
        rid = self._next_rid
        self._next_rid += 1
        if lane is None:
            lane = self._lanes[int(model_idx)] = _Lane(
                int(model_idx), pm, self.ecfg, self.device, self.mesh)
        pend = _Pending(rid, toks, max_new,
                        deadline=(self._steps + int(deadline)
                                  if deadline is not None else None),
                        draft=draft_idx)
        cap = self._lane_caps.get(int(model_idx), self.ecfg.queue_cap)
        if cap is not None and len(lane.queue) >= cap:
            victim = pend
            if self.ecfg.shed_policy == "reject-latest-deadline":
                # shed whichever of queue ∪ {incoming} can best afford it
                qv = max(lane.queue, key=lambda q: (q.eff_deadline(), q.rid))
                if ((qv.eff_deadline(), qv.rid)
                        > (pend.eff_deadline(), pend.rid)):
                    lane.queue.remove(qv)
                    lane.queue.append(pend)
                    victim = qv
            self.sheds += 1
            self._record(victim.rid, SHED, tokens=self._prefix_of(victim))
        else:
            lane.queue.append(pend)
        depth = sum(len(l.queue) for l in self._lanes.values())
        self.queue_depth_hw = max(self.queue_depth_hw, depth)
        return rid

    # ---------------------------------------------------------- lifecycle
    def _record(self, rid: int, status: str, tokens=None) -> None:
        """Write a request's one terminal record: np tokens for a
        completion, an ``Outcome`` otherwise, into the step() events and
        the drain() buffer; its status into the bounded status map."""
        payload = (tokens if status in (DONE, PREEMPTED_RESUMED)
                   else Outcome(rid, status, tokens))
        self._events.append((rid, payload))
        self._done[rid] = payload
        self._status[rid] = status
        while len(self._status) > 4 * self.ecfg.done_buffer:
            self._status.pop(next(iter(self._status)))

    @staticmethod
    def _prefix_of(req: _Pending) -> Optional[np.ndarray]:
        return req.prefix.copy() if len(req.prefix) else None

    @staticmethod
    def _partial_tokens(st: _Active) -> Optional[np.ndarray]:
        parts = ([st.prefix] if len(st.prefix) else []) + st.chunks
        if not parts or st.emitted == 0:
            return None
        return np.concatenate(parts)[:st.emitted]

    def _release_slot(self, lane: _Lane, slot: int) -> None:
        """Free a slot between chunks: slot to the free list, pages to the
        page free list, carry zeroed. Host bookkeeping only."""
        del lane.active[slot]
        lane.free.append(slot)
        if lane.paged:
            lane.pt.release(slot)
        lane.tok[slot] = 0
        lane.pos[slot] = 0

    def cancel(self, rid: int) -> str:
        """Cancel a request wherever it is: a queued (or preempted) one
        leaves the queue; an active one releases its slot and pages now.
        A terminal rid is a no-op returning its status; an unknown rid
        raises KeyError. The CANCELLED record (with any partial tokens)
        surfaces through the next step()/drain()."""
        if rid in self._status:
            return self._status[rid]
        for lane in self._lanes.values():
            for q in lane.queue:
                if q.rid == rid:
                    lane.queue.remove(q)
                    self.cancels += 1
                    self._record(rid, CANCELLED, tokens=self._prefix_of(q))
                    return CANCELLED
            for slot, st in list(lane.active.items()):
                if st.rid == rid:
                    toks = self._partial_tokens(st)
                    self._release_slot(lane, slot)
                    self.cancels += 1
                    self._record(rid, CANCELLED, tokens=toks)
                    return CANCELLED
        raise KeyError(f"unknown request id {rid}")

    def status(self, rid: int) -> str:
        """A terminal status once the request ended, else "ACTIVE"
        (holding a slot), "PREEMPTED" (queued for its resume) or "QUEUED".
        KeyError for a rid the engine never saw, or whose terminal record
        aged out of the bounded status map."""
        if rid in self._status:
            return self._status[rid]
        for lane in self._lanes.values():
            for st in lane.active.values():
                if st.rid == rid:
                    return "ACTIVE"
            for q in lane.queue:
                if q.rid == rid:
                    return "PREEMPTED" if q.preempts else "QUEUED"
        raise KeyError(f"unknown request id {rid} (never submitted, or its "
                       "terminal record aged out of the status buffer)")

    def counters(self) -> Dict[str, int]:
        """Snapshot of the resilience and speculative counters."""
        return {"sheds": self.sheds, "preemptions": self.preemptions,
                "expiries": self.expiries, "cancels": self.cancels,
                "resume_recompute_toks": self.resume_recompute_toks,
                "queue_depth_hw": self.queue_depth_hw,
                "peak_active": self.peak_active,
                "spec_rounds": self.spec_rounds,
                "spec_drafted": self.spec_drafted,
                "spec_accepted": self.spec_accepted,
                "spec_rejected": self.spec_rejected}

    def _expire(self, lane: _Lane) -> None:
        """EXPIRE every active or queued request whose deadline has
        passed; slot and pages release now, partial tokens ride in the
        Outcome."""
        now = self._steps
        for slot, st in sorted(lane.active.items()):
            if st.deadline is not None and now >= st.deadline:
                toks = self._partial_tokens(st)
                self._release_slot(lane, slot)
                self.expiries += 1
                self._record(st.rid, EXPIRED, tokens=toks)
        if any(q.deadline is not None and now >= q.deadline
               for q in lane.queue):
            keep: Deque[_Pending] = collections.deque()
            for q in lane.queue:
                if q.deadline is not None and now >= q.deadline:
                    self.expiries += 1
                    self._record(q.rid, EXPIRED, tokens=self._prefix_of(q))
                else:
                    keep.append(q)
            lane.queue = keep

    # --------------------------------------------------------------- step
    def step(self) -> List[Tuple[int, object]]:
        """Expire, admit (preempting under page pressure with initial
        reservation), sample ``peak_active``, grow page reservations, then
        decode one chunk (or one speculative round) on every busy lane.
        Returns the requests that reached a terminal state this step as
        (rid, result): np tokens for completions, an ``Outcome`` for the
        rest. They are also kept for ``drain()`` (up to ``done_buffer``,
        oldest evicted)."""
        for lane in self._lanes.values():
            self._expire(lane)
        for lane in self._lanes.values():
            self._admit(lane)
        self.peak_active = max(self.peak_active, self.n_active())
        for lane in self._lanes.values():
            if lane.active and lane.paged and self.ecfg.reserve == "initial":
                self._grow_for_chunk(lane)
            if lane.active:
                if self.ecfg.spec_k:
                    self._decode_spec_round(lane)
                else:
                    self._decode_chunk(lane)
        self._steps += 1
        finished = self._events
        self._events = []
        while len(self._done) > self.ecfg.done_buffer:
            self._done.pop(next(iter(self._done)))
        return finished

    @property
    def busy(self) -> bool:
        return any(l.queue or l.active for l in self._lanes.values())

    def drain(self, rids=None) -> Dict[int, object]:
        """Step until completion and return {rid: result} (np tokens, or an
        ``Outcome`` for expired / cancelled / shed requests). With
        rids=None, runs until every lane is idle and returns (and clears)
        everything; with an iterable of request ids, runs until exactly
        those reach a terminal state and leaves other results in place. A
        wanted rid that already ended returns its typed record; only a rid
        the engine has no record of raises KeyError."""
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
        # a terminal rid whose payload left the done buffer still resolves
        # through the status map (its tokens are gone)
        for r in want - out.keys():
            if r in self._status and self._status[r] not in (
                    DONE, PREEMPTED_RESUMED):
                out[r] = Outcome(r, self._status[r])
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
    @staticmethod
    def _full_prompt(req: _Pending) -> np.ndarray:
        """What admission prefills: the prompt, plus after a preemption
        every token already emitted (recompute on resume)."""
        if len(req.prefix):
            return np.concatenate([req.toks, req.prefix])
        return req.toks

    def _activate(self, lane: _Lane, req: _Pending, slot: int, tok0: int,
                  S: int) -> None:
        if req.preempts:
            self.resume_recompute_toks += S
        lane.tok[slot] = tok0
        lane.pos[slot] = S          # first decode token writes K/V at S
        lane.active[slot] = _Active(
            req.rid, req.max_new, req.toks, deadline=req.deadline,
            prefix=req.prefix, emitted=len(req.prefix),
            preempts=req.preempts, draft=req.draft,
            region=len(req.toks) + req.max_new)

    def _pick_victim(self, lane: _Lane,
                     before: Optional[float] = None) -> Optional[int]:
        """The eviction policy: latest effective deadline (None → +inf),
        then fewest tokens generated, then the youngest rid. With
        ``before`` (admission preemption) only a STRICTLY later deadline
        qualifies, so deadline-less traffic never preempts at admission.
        Returns the victim's slot, or None."""
        best_key, best_slot = None, None
        for slot, st in sorted(lane.active.items()):
            dl = _INF if st.deadline is None else float(st.deadline)
            if before is not None and not dl > before:
                continue
            key = (dl, -st.emitted, st.rid)
            if best_key is None or key > best_key:
                best_key, best_slot = key, slot
        return best_slot

    def _preempt(self, lane: _Lane, slot: int) -> None:
        """Evict one in-flight request: pages and slot freed, the request
        re-queued at the back as a prefill of prompt + tokens so far."""
        st = lane.active[slot]
        prefix = self._partial_tokens(st)
        self._release_slot(lane, slot)
        self.preemptions += 1
        lane.queue.append(_Pending(
            st.rid, st.toks, st.max_new, deadline=st.deadline,
            prefix=(np.asarray(prefix, np.int32) if prefix is not None
                    else _empty_toks()),
            preempts=st.preempts + 1, draft=st.draft))

    def _grow_for_chunk(self, lane: _Lane) -> None:
        """Initial reservation, right before a decode chunk: every active
        slot's pages must cover its next writes — [pos, pos + chunk), or
        [pos, pos + spec_k) clamped to the request's region in a
        speculative round. Grow on demand; under pool pressure preempt
        victims (``_pick_victim``) until the survivors fit. ``fits()``
        guarantees a lone request covers itself, so this ends."""
        ps = self.ecfg.page_size
        span = self.ecfg.spec_k or self.ecfg.chunk
        while lane.active:
            need: Dict[int, int] = {}
            for slot in sorted(lane.active):
                hi = int(lane.pos[slot]) + span
                if self.ecfg.spec_k:
                    hi = min(hi, lane.active[slot].region)
                short = -(-hi // ps) - lane.pt.held(slot)
                if short > 0:
                    need[slot] = short
            if sum(need.values()) <= lane.pt.available:
                for slot, n in sorted(need.items()):
                    lane.pt.grow(slot, n)
                return
            self._preempt(lane, self._pick_victim(lane))

    def _admit_draft(self, lane: _Lane, slot: int, draft_idx: int,
                     full: np.ndarray) -> None:
        """Speculative admission: prefill the request's prompt through its
        drafter into the drafter's slot pool (allocated at first use). The
        drafter's own first token is discarded: drafting starts from the
        target's committed ``lane.tok``."""
        dpm = self.pool[draft_idx]
        if draft_idx not in lane.draft_pools:
            dpool = alloc_draft_pool(dpm.cfg, self.ecfg.slots,
                                     self.ecfg.max_seq, self.ecfg.spec_k,
                                     device=self.device)
            if self.mesh is not None:
                if dpm is not lane.pm:      # a target's lane replicated it
                    shd.replicate(dpm.params, self.mesh)
                dpool = shd.shard_kv_pool(dpool, self.mesh)
                lane.draft_heads[draft_idx] = shd.HeadBlock.of(
                    self.mesh, dpm.cfg.n_kv_heads)
            lane.draft_pools[draft_idx] = dpool
        S = len(full)
        toks_p = np.zeros((1, next_pow2(S)), np.int32)
        toks_p[0, :S] = full
        _, kv = _prefill(dpm.cfg, dpm.params, toks_p, S - 1, self.device)
        lane.write_slot(lane.draft_pools[draft_idx],
                        lane.draft_heads.get(draft_idx), kv, slot)

    def _admit(self, lane: _Lane) -> None:
        if lane.paged:
            self._admit_paged(lane)
            return
        cfg, params = lane.pm.cfg, lane.pm.params
        while lane.free and lane.queue:
            req = lane.queue.popleft()
            slot = lane.free.pop()
            full = self._full_prompt(req)
            S = len(full)
            with tracing.span("engine.prefill", model=lane.index, rows=1,
                              batch=1, bucket=next_pow2(S), tokens=S):
                toks_p = np.zeros((1, next_pow2(S)), np.int32)
                toks_p[0, :S] = full
                tok0, kv = _prefill(cfg, params, toks_p, S - 1, self.device)
                lane.write_slot(lane.pool, lane.heads, kv, slot)
                tok0 = int(tok0[0])
                tracing.mark("engine.first_token", rid=req.rid,
                             model=lane.index)
            if self.ecfg.spec_k:
                self._admit_draft(lane, slot, req.draft, full)
            self._activate(lane, req, slot, tok0, S)

    def _admit_paged(self, lane: _Lane) -> None:
        """Paged admission: claim a decode slot + pages (FIFO — the head
        waits for pages rather than being overtaken), then coalesce
        everything admitted this boundary by prompt bucket: one (B_b, S_b)
        prefill per bucket with per-row ``last_pos`` and one page scatter;
        pad rows of a non-pow2 group prefill into the trash page. Lifetime
        reservation claims the whole region; initial reservation claims
        the prefill bucket's pages and may preempt a strictly
        later-deadline victim for the queue head. A resume prefills
        prompt + emitted tokens in its own bucket."""
        ps = self.ecfg.page_size
        initial = self.ecfg.reserve == "initial"
        admitted = []                   # (req, slot, S, S_b, pages)
        while lane.queue:
            req = lane.queue[0]
            S = len(req.toks) + len(req.prefix)
            S_b = next_pow2(S)
            if initial:
                need = lane.pt.pages_needed(S_b)
            else:
                need = lane.pt.pages_needed(
                    self._region_len(S, req.max_new - len(req.prefix)))
            if not lane.free or need > lane.pt.available:
                if not initial:
                    break
                victim = self._pick_victim(lane, before=req.eff_deadline())
                if victim is None:
                    break
                self._preempt(lane, victim)
                continue
            lane.queue.popleft()
            slot = lane.free.pop()
            pages = lane.pt.alloc(slot, need)
            admitted.append((req, slot, S, S_b, pages))
        groups: Dict[int, list] = {}
        for item in admitted:
            groups.setdefault(item[3], []).append(item)
        cfg, params = lane.pm.cfg, lane.pm.params
        for S_b, items in sorted(groups.items()):
            B_b = next_pow2(len(items))
            with tracing.span("engine.prefill", model=lane.index,
                              rows=len(items), batch=B_b, bucket=S_b,
                              tokens=sum(it[2] for it in items)):
                n_pp = -(-S_b // ps)        # pages the prefill bucket covers
                toks_p = np.zeros((B_b, S_b), np.int32)
                last = np.zeros((B_b,), np.int64)
                pages_mat = np.zeros((B_b, n_pp), np.int32)  # pad → trash
                for r, (req, slot, S, _, pages) in enumerate(items):
                    toks_p[r, :S] = self._full_prompt(req)
                    last[r] = S - 1
                    pages_mat[r] = pages[:n_pp]
                tok0, kv = _prefill(cfg, params, toks_p, last, self.device)
                if lane.slots is not None:      # only this process's slots
                    mine = [r for r, it in enumerate(items)
                            if lane.slots.owns(it[1])]
                    kv = {n: {k: t[:, mine] for k, t in layer.items()}
                          for n, layer in kv.items()}
                    pages_mat = pages_mat[mine]
                if lane.heads is not None:
                    kv = lane.heads.kv(kv)
                if len(pages_mat):
                    write_prefill_pages(lane.pool, kv, pages_mat)
                tok0 = tok0.cpu().numpy()
                for req, *_ in items:
                    tracing.mark("engine.first_token", rid=req.rid,
                                 model=lane.index)
            for r, (req, slot, S, _, _) in enumerate(items):
                if self.ecfg.spec_k:
                    self._admit_draft(lane, slot, req.draft,
                                      self._full_prompt(req))
                self._activate(lane, req, slot, int(tok0[r]), S)

    def _finish(self, lane: _Lane, slot: int, st: _Active) -> None:
        parts = ([st.prefix] if len(st.prefix) else []) + st.chunks
        tokens = np.concatenate(parts)[:st.max_new]
        status = PREEMPTED_RESUMED if st.preempts else DONE
        self._release_slot(lane, slot)
        self._record(st.rid, status, tokens=tokens)

    def _draft(self, lane: _Lane, d: int, slots: List[int]) -> np.ndarray:
        """``spec_k`` greedy steps of drafter ``d`` on its slot pool for
        ``slots`` (other rows run masked at tok 0, pos 0, below any later
        occupant's prefill); returns the drafted (slots, spec_k) tokens."""
        dpm = self.pool[d]
        mask = np.zeros((self.ecfg.slots,), bool)
        mask[slots] = True
        r = lane.rows
        tok = torch.as_tensor(np.where(mask, lane.tok, 0)[r].astype(np.int32),
                              device=self.device)
        pos = torch.as_tensor(np.where(mask, lane.pos, 0)[r].astype(np.int32),
                              device=self.device)
        heads = lane.draft_heads.get(d)
        out = []
        for _ in range(self.ecfg.spec_k):
            logits, _ = mdl.decode_step(dpm.params, lane.draft_pools[d],
                                        dpm.cfg, tokens=tok[:, None], pos=pos,
                                        heads=heads)
            tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
            out.append(tok)
            pos = pos + 1
        return lane.host(torch.stack(out, dim=1))

    def _decode_spec_round(self, lane: _Lane) -> None:
        """One draft/verify round (in place of ``_decode_chunk`` when
        ``spec_k > 0``):

        1. draft — per drafter, its pool decodes ``spec_k`` tokens ahead.
        2. verify — ONE target call over ``spec_k`` positions per row: the
           pending committed token and the first spec_k - 1 drafts, each
           offset attending below its own causal bound, so offset j's
           argmax is what the one-token chain would give there.
        3. commit / roll back (host) — the longest prefix of drafts that
           matches the verify's argmax commits, plus the verify's
           correction token on a mismatch: 1 to spec_k tokens per row. On
           FULL acceptance the carry is the last draft, not the bonus
           token: the drafter has only ingested spec_k - 1 drafts past the
           carry, so taking the bonus would skip a position of its cache.
           A rejected suffix rolls back by not advancing ``pos``; its
           stale K/V stays masked and is overwritten before it could be
           attended. Only committed tokens enter ``st.chunks``.
        """
        cfg, ecfg, dev = lane.pm.cfg, self.ecfg, self.device
        k = ecfg.spec_k
        drafted = np.zeros((ecfg.slots, k), np.int32)
        by_draft: Dict[int, List[int]] = {}
        for slot, st in lane.active.items():
            by_draft.setdefault(st.draft, []).append(slot)
        for d, slots in sorted(by_draft.items()):
            drafted[slots] = self._draft(lane, d, slots)[slots]
        ver_tok = np.concatenate([lane.tok[:, None], drafted[:, :k - 1]],
                                 axis=1)
        r = lane.rows
        if lane.paged:
            logits, _ = mdl.decode_verify_paged(
                lane.pm.params, lane.pool, cfg, tokens=ver_tok[r],
                page_table=lane.pt.table[r], pos=lane.pos[r],
                heads=lane.heads)
        else:
            logits, _ = mdl.decode_verify(lane.pm.params, lane.pool, cfg,
                                          tokens=ver_tok[r], pos=lane.pos[r],
                                          heads=lane.heads)
        g = lane.host(torch.argmax(logits, dim=-1).to(torch.int32))
        self.spec_rounds += 1
        for slot in list(lane.active):
            st = lane.active[slot]
            ds, gs = drafted[slot], g[slot]
            m = 0
            while m < k and ds[m] == gs[m]:
                m += 1
            self.spec_drafted += k
            self.spec_accepted += m
            self.spec_rejected += k - m
            # commit the carry and the accepted drafts; the next carry is
            # the correction gs[m], or on full acceptance the last draft
            # (verified: it equals gs[k - 1]) — see the docstring
            adv = min(m + 1, k)
            committed = np.concatenate(
                ([lane.tok[slot]], ds[:adv - 1])).astype(np.int32)
            lane.tok[slot] = gs[m] if m < k else ds[k - 1]
            lane.pos[slot] += adv
            st.chunks.append(committed)
            st.emitted += adv
            if st.emitted >= st.max_new:
                self._finish(lane, slot, st)

    def _decode_chunk(self, lane: _Lane) -> None:
        """``chunk`` greedy steps over the whole decode batch. Free rows
        decode garbage at (tok 0, pos 0): on a paged lane their table row
        is all trash page, and on a uniform lane the next occupant's
        prefill and decode write every position before validity reaches
        it, so nothing they write is ever attended."""
        cfg, ecfg, params = lane.pm.cfg, self.ecfg, lane.pm.params
        dev, r, heads = self.device, lane.rows, lane.heads
        with tracing.span("engine.decode", model=lane.index,
                          rows=len(lane.active), passes=ecfg.chunk):
            tok = torch.as_tensor(lane.tok[r], device=dev)
            pos = torch.as_tensor(lane.pos[r], device=dev)
            table = (torch.as_tensor(lane.pt.table[r], device=dev)
                     if lane.paged else None)
            out = []
            for _ in range(ecfg.chunk):
                if lane.paged:
                    logits, _ = mdl.decode_step_paged(
                        params, lane.pool, cfg, tokens=tok[:, None],
                        page_table=table, pos=pos, heads=heads)
                else:
                    logits, _ = mdl.decode_step(params, lane.pool, cfg,
                                                tokens=tok[:, None], pos=pos,
                                                heads=heads)
                out.append(tok)
                tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
                pos = pos + 1
            # one device → host copy per chunk (on a slot-split lane after
            # one all-gather): the emitted tokens + the carry
            out_np = lane.host(torch.stack(out + [tok], dim=1))
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
                self._finish(lane, slot, st)
