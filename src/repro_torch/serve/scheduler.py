"""Continuous-batching scheduler over the engine's pool step.

Port of the JAX package's ``serve/scheduler.py``: slot and paged pools,
plain and speculative segments, and the failure model (integrity guard,
quarantine and dense retry, seeded faults, stalls and the watchdog's
abort).  ``Engine.generate`` serves one
fixed batch of equal-length prompts for a fixed ``max_new``; real traffic
is ragged.  :class:`Scheduler` keeps a fixed pool of in-flight *slots* and
alternates two phases:

  admission   free slots are filled with queued requests whose arrival time
              has passed, highest priority first (arrival order breaks
              ties).  With ``admission="batched"`` the round's arrivals are
              grouped into prompt-length buckets, each primed in one masked
              prefill (``Engine.prime_many``) and written into its slots in
              one in-place scatter per cache leaf
              (``models.cache.write_slots``); ``"sequential"`` primes each
              request alone at its exact length (``Engine.prime``), on
              either pool.
  decode      one *segment*: ``segment`` replays of the pool step (all
              slots, captured in a CUDA graph on the card), then one fetch
              of the (slots, segment) tokens and integrity flags; finished
              slots (EOS or budget) retire and free up for the next round.
              First-token EOS/budget checks are deferred to this sync, so
              admission never waits for the device.  On a speculative
              engine each replay is one draft/verify *round* of every slot
              (``Engine._pool_spec_round``): a slot advances 1 ..
              ``draft_k`` + 1 tokens a round, the grids come back a round
              wide with each round's emitted count, and the host consumes
              ``tokens[i, r, :nem[i, r]]``, cutting at EOS or a tripped
              flag inside the round.

The pool is one decode cache whose batch axis is the slot axis, each row
with its own ``pos`` (the reference vmaps B = 1 caches; the packed kernels
cannot be vmapped).  The pool step computes every norm, attend and dense
product one row at a time and the packed kernels on all rows (their row b
does not depend on B), so row b is bitwise a B = 1 step on its cache row;
each slot has its own emitted count and its own Gumbel noise rows, the
rows one-shot ``generate`` draws at B = 1 from the request's seed.  So
under sequential admission every completed request's tokens are
bit-identical to a one-shot ``Engine.generate`` of the same prompt at
B = 1 with ``ServeConfig.seed`` = the request's seed: the scheduler changes
*when* work runs, never *what* it computes.  Batched admission primes a
prompt at another row count, which is not bitwise (ROADMAP C9).  Free
slots decode along with the pool; their output is discarded and their
state is replaced at the next admission.  The recurrent families (hybrid,
ssm) have no masked prefill: ``admission="batched"`` primes each request
alone, as ``"sequential"`` does, and a page size is ignored (their state
is no sequence), as in the reference; an admission rewrites the slot's
whole state (``h``, ``state``, ``conv`` and the ring), so nothing of the
slot's previous request leaks into the next.  The vlm and encdec families
are refused: a request carries no patches or frames.

Hardening rides the same sync points: deadlines (shed at admission when the
queue wait already blew them, retired TIMEOUT at a sync otherwise),
cancellation (queued: at once; in flight: at the next sync), ``queue_cap``
with three shed policies, priorities, and the integrity guard.  A slot
whose ``isfinite`` flag trips is cut at the first bad position; under
packed weights the pack is quarantined (``Engine.quarantine_packed``: the
pool switches to its dense graph) and the request is re-admitted once,
re-primed from its prompt with its own seed, so it completes
``FAILED_FALLBACK_OK`` with the tokens of a clean dense run; a second trip
is terminal ``FAILED``.  A seeded fault plan (``ServeConfig.faults``)
poisons admitted requests' caches (the paged pool privatizes a block first,
so poison never reaches a shared one) and stalls admission or decode in
interruptible waits; ``abort`` (the streaming front end's watchdog) ends a
run at the next wait or sync: each in-flight request is re-queued once,
then retired ``STALLED``.

Paged KV pool (``ServeConfig.page_size > 0``): the slot pool is replaced by
a shared block arena plus per-slot block tables (``models.cache``).  The run
loop is unchanged, but admission allocates blocks lazily (pages covering the
prompt up front, decode pages extended before each segment), retirement
refcount-frees them, and identical prompt prefixes share read-only blocks
through the allocator's hash registry (full pages by refcount, partial tail
pages by copy-on-write).  Mid-flight arena exhaustion preempts the
latest-admitted slot (its request re-queues and re-primes with its own
seed), so the earliest admission always progresses.  With
``prefill_chunk > 0`` long prompts prefill in chunks between segments, one
chunk per round per admitting slot.  The block tables and positions the
captured step reads are device tensors updated in place at host-driven
events (bind, rebind, extend, preempt); the host mirrors (``_rows``,
``_pos``) stay exact, so no event reads the device back.

On a mesh every rank runs this loop.  Each round reads one time, rank 0's
run-relative clock broadcast over the whole mesh, and every admission,
shed and timeout decision is a function of the queue and that time, so
the ranks decide alike whatever their own clocks say and their
collectives stay paired.
"""

from __future__ import annotations

import bisect
import dataclasses
import enum
import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.cache import (
    BlockAllocator,
    PagedLayout,
    bind_slot_pages,
    copy_block,
    paged_block_bytes,
    paged_host_mirror,
    paged_poison_block,
    paged_pool_bytes,
    paged_reset_slot,
    poison_slot,
    prefix_page_digests,
    prefix_tail_digests,
    write_prefill_pages,
    write_slots,
    zero_blocks,
)
from ..dist.comm import axis_index, broadcast, broadcast_mesh
from .engine import Engine, choose_tokens
from .metrics import acceptance_rate, tok_per_s

__all__ = ["Request", "Completion", "Scheduler", "Status"]


class _PoolWrites:
    """The scheduler's device writes to its pool, in global slot and block
    ids.  Every rank of a data mesh axis runs the same host loop; on a pool
    split over that axis (``Engine.new_pool``) each rank applies the writes
    of its own slots and blocks, translated to its local indices, and drops
    the rest.  On an unsplit pool they pass through."""

    def __init__(self, engine: Engine, pool, layout: Optional[PagedLayout], axes):
        self.cache, self.layout, self.axes = pool.cache, layout, axes
        self.split = pool.rows is not None
        self.mesh = engine.mesh
        self.rank = axis_index(engine.mesh, "data") if self.split else 0
        self.lo = pool.rows.start if self.split else 0
        self.n = pool.rows.stop - pool.rows.start if self.split else len(pool.count)

    def owns(self, i: int) -> bool:
        return self.lo <= i < self.lo + self.n

    def slots(self, idx) -> np.ndarray:
        """Global slots as this rank's pool rows; others out of range."""
        idx = np.asarray(idx, np.int64)
        loc = idx - self.lo
        return np.where((loc >= 0) & (loc < self.n), loc, self.n)

    def blocks(self, ids) -> np.ndarray:
        """Global block ids as this rank's arena indices; others out of
        range."""
        return self.layout.to_local(ids, self.rank) if self.split else np.asarray(ids, np.int64)

    # slot pool
    def write_slots(self, idx, cache: dict, lengths) -> None:
        write_slots(self.cache, self.slots(idx), cache, self.axes, lengths)

    def poison_slot(self, i: int) -> None:
        if self.owns(i):
            poison_slot(self.cache, i - self.lo, self.axes)

    # paged pool
    def zero_blocks(self, ids) -> None:
        zero_blocks(self.cache["arena"], self.blocks(ids))

    def copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write within one rank (a slot's blocks are its rank's)."""
        if not self.split or self.layout.block_rank(dst) == self.rank:
            copy_block(self.cache["arena"], int(self.blocks(src)), int(self.blocks(dst)))

    def write_prefill_pages(self, page_tables, primed: dict) -> None:
        write_prefill_pages(self.cache["arena"], self.blocks(page_tables), primed)

    def bind(self, idx, rows, lengths) -> None:
        bind_slot_pages(self.cache["table"], self.cache["pos"], self.slots(idx),
                        self.blocks(rows), lengths)

    def reset_slot(self, i: int) -> None:
        if self.owns(i):
            paged_reset_slot(self.cache, i - self.lo,
                             int(self.blocks(self.layout.scratch_block(i))))

    def poison_block(self, blk: int) -> None:
        if not self.split or self.layout.block_rank(blk) == self.rank:
            paged_poison_block(self.cache["arena"], int(self.blocks(blk)))

    def from_owner(self, t: Optional[torch.Tensor], i: int, like: torch.Tensor) -> torch.Tensor:
        """``t``, computed by the rank that owns slot ``i`` (None on the
        others), broadcast to every rank of the data axis."""
        if not self.split:
            return t
        if t is None:
            t = torch.empty_like(like)
        return broadcast(t.contiguous(), self.mesh, "data", src=self.layout.slot_rank(i))


class Status(str, enum.Enum):
    """Terminal state of a request (``Completion.status``)."""

    OK = "OK"
    TIMEOUT = "TIMEOUT"  # deadline blown — queued (never primed) or in flight
    CANCELLED = "CANCELLED"
    REJECTED = "REJECTED"  # backpressure: refused at submit, or shed from the queue
    FAILED_FALLBACK_OK = "FAILED_FALLBACK_OK"  # guard tripped, the dense retry delivered
    FAILED = "FAILED"  # guard tripped, and the bounded retry tripped too
    STALLED = "STALLED"  # watchdog abort: a segment hung past the stall timeout


@dataclasses.dataclass
class Request:
    """One generation request.  ``arrival_s`` is an offset from ``run()``
    start (0 = already queued); ``seed`` seeds this request's Gumbel noise,
    as ``ServeConfig.seed`` does in one-shot generate.  ``deadline_s`` is
    relative to arrival (None = no deadline); higher ``priority`` admits
    first and survives ``shed-lowest-priority``."""

    prompt: np.ndarray  # (S,) int32
    max_new: int = 32
    eos_id: Optional[int] = None
    seed: int = 0
    arrival_s: float = 0.0
    deadline_s: Optional[float] = None
    priority: int = 0


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: np.ndarray  # (<= max_new,) int32, truncated just after eos_id
    arrival_s: float
    admit_s: float
    finish_s: float
    status: Status = Status.OK
    ttft_s: float = float("nan")  # time to first token, from arrival

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s


@dataclasses.dataclass
class _PrefillJob:
    """Host state of an in-progress paged prefill: chunked long-prompt
    admission, prefix-suffix recompute after a partial prefix hit, or the
    1-token re-peek of a fully prefix-matched prompt (``write_from == L``:
    attention over the shared blocks, no writes)."""

    prompt: np.ndarray
    L: int
    start: int  # next chunk's first sequence position
    write_from: int  # first row this request may write (rows below are shared)
    chunk: int  # chunk width
    poisoned: bool = False  # fault plan: the poison fires when the prefill completes


@dataclasses.dataclass
class _Slot:
    """Host-side bookkeeping for one in-flight slot."""

    rid: int = -1
    tokens: Optional[List[int]] = None
    first: Optional[torch.Tensor] = None  # deferred first token (device, (1, 1))
    remaining: int = 0
    eos_id: Optional[int] = None
    arrival_s: float = 0.0
    admit_s: float = 0.0
    deadline: float = float("inf")  # absolute run-relative deadline
    ttft_s: float = float("nan")
    req: Optional[Request] = None  # kept for the preemption and retry requeues
    prefill: Optional[_PrefillJob] = None  # paged: chunked admission in flight
    last_emit_t: float = float("nan")  # last sync that emitted tokens (ITL)

    @property
    def active(self) -> bool:
        return self.rid >= 0


_SHED_POLICIES = ("reject", "shed-oldest", "shed-lowest-priority")


class Scheduler:
    """Continuous-batching run loop over an :class:`Engine`'s pool step."""

    def __init__(
        self,
        engine: Engine,
        slots: int = 4,
        segment: int = 8,
        admission: str = "batched",
        queue_cap: Optional[int] = None,
        shed_policy: str = "reject",
        clock: Optional[Callable[[], float]] = None,
        sleep: Optional[Callable[[float], None]] = None,
    ):
        if not engine.sc.fused:
            raise ValueError("Scheduler requires a fused-decode engine (ServeConfig.fused)")
        if engine.cfg.family in ("vlm", "encdec"):
            what = "patch embeddings" if engine.cfg.family == "vlm" else "audio frames"
            extra = "patches" if engine.cfg.family == "vlm" else "frames"
            raise ValueError(
                f"the scheduler serves token prompts only: a Request carries no {what} "
                f"(as in the reference), so a {engine.cfg.family} model serves through "
                f"Engine.generate(prompts, extras={{'{extra}': ...}})"
            )
        if slots < 1 or segment < 1:
            raise ValueError(f"need slots >= 1 and segment >= 1, got {slots}, {segment}")
        if admission not in ("batched", "sequential"):
            raise ValueError(f"admission must be 'batched' or 'sequential', got {admission!r}")
        if queue_cap is not None and queue_cap < 1:
            raise ValueError(f"queue_cap must be None or >= 1, got {queue_cap}")
        if shed_policy not in _SHED_POLICIES:
            raise ValueError(f"shed_policy must be one of {_SHED_POLICIES}, got {shed_policy!r}")
        self.eng = engine
        self.model = engine.model
        self.slots = slots
        self.segment = segment
        self.admission = admission
        self.queue_cap = queue_cap
        self.shed_policy = shed_policy
        # injectable time sources: tests drive deadlines and cancellation
        # with a fake clock instead of real sleeps; the clock defaults to
        # the engine's, so engine and scheduler timings share one timeline
        self._clock = clock or engine._clock
        self._sleep = sleep or time.sleep
        # (arrival_s, rid, Request), kept sorted by (arrival_s, rid) at
        # submit time so arrived requests are always a front prefix
        self._queue: List[tuple] = []
        self._completions: Dict[int, Completion] = {}
        self._next_rid = 0
        self._slot: List[_Slot] = [_Slot() for _ in range(slots)]
        sc = engine.sc
        # speculative decoding: each replay is one draft/verify round that
        # writes up to draft_k + 1 rows per slot, so every worst-case KV
        # growth bound uses span = segment * (draft_k + 1)
        self.speculative = bool(sc.speculative)
        self._draft_k = sc.draft_k if self.speculative else 0
        self._span = segment * (self._draft_k + 1)
        self.paged = bool(sc.page_size) and engine.paged_supported
        self._prefix_on = self.paged and sc.prefix_cache
        self._chunk_cfg = sc.prefill_chunk if self.paged else 0
        if self.paged:
            # on a data axis that divides the slots, each rank owns a
            # contiguous slot range and block range (``PagedLayout``)
            self._layout = PagedLayout.build(
                slots, sc.max_len, sc.page_size, sc.arena_blocks,
                shards=engine.dp if engine._rows(slots) is not None else 1)
            self._alloc = BlockAllocator(self._layout)
            self._pool = engine.new_pool(slots, segment, self._layout, spec=self.speculative)
            self._pstate = self._pool.cache
            self._block_bytes = paged_block_bytes(self._pstate)
            self._arena_bytes = paged_pool_bytes(self._pstate)
            # host mirrors of the device tables and positions, kept exact
            # (every mutation is host-driven), so table extension and page
            # accounting never read the device back
            self._rows = np.stack([np.full(self._layout.n_pages, self._layout.scratch_block(i),
                                           np.int64) for i in range(slots)])
            self._pos = [0] * slots
            self._slot_blocks: List[List[int]] = [[] for _ in range(slots)]
            self._slot_private: List[List[int]] = [[] for _ in range(slots)]
            self._slot_npages = [0] * slots
            self._batch_axes = None
            self._slot_bytes = self._arena_bytes // max(slots, 1)
            # the shape of a chunk's (1, V) logits, for the ranks that
            # receive them (``_step_prefills``)
            self._chunk_logits = torch.empty((1, self.eng.cfg.padded_vocab),
                                             dtype=torch.float32, device=engine.device)
        else:
            self._pool = engine.new_pool(slots, segment, spec=self.speculative)
            self._batch_axes = self.model.cache_batch_axes(sc.max_len)
            self._slot_bytes = sum(t.numel() * t.element_size()
                                   for t in self._pool.cache.values()) // max(slots, 1)
        self._dev = _PoolWrites(engine, self._pool, self._layout if self.paged else None,
                                self._batch_axes)
        self._cancel: set = set()  # in-flight rids to retire at the next sync
        self._retried: set = set()  # rids that used their bounded dense retry
        self._fallback_rids: set = set()  # rids now on the dense retry
        self._fault_fired: set = set()  # rids whose one-shot cache fault ran
        self._counters: Dict[str, int] = dict(
            rejected=0, shed=0, timed_out=0, cancelled=0,
            fallback=0, failed=0, quarantined=0, preempted=0, stalled=0,
            spec_proposed=0, spec_accepted=0,
        )
        # streaming and watchdog state.  `_abort_status` is the flag another
        # thread (the streaming front end's watchdog) sets: the run loop
        # reads it at every sync and inside every injected stall wait,
        # re-queues or retires the in-flight work and returns.  `_draining`
        # stops admission: in-flight work finishes, the queue survives (clean
        # shutdown, hot pack swaps).  `_stall_fired` makes seeded decode
        # stalls one-shot per rid; `_stall_retried` bounds the watchdog's
        # re-queue as `_retried` bounds the dense retry.
        self._abort_status: Optional[Status] = None
        self._draining = False
        self._stall_fired: set = set()
        self._stall_retried: set = set()
        self._itl: List[float] = []  # inter-token latency samples
        self._ran = False  # True after run(): the next mutation starts a new epoch
        self._run_now: Optional[Callable[[], float]] = None
        # run stats
        self._seg_steps = 0
        self._segments = 0
        self._chunks = 0  # prefill chunks run (paged chunked admission)
        self._active_slot_steps = 0
        self._decode_s = 0.0
        self._admit_s = 0.0
        # Σ used-KV bytes and Σ active slots, sampled once per segment sync:
        # their ratio is the HBM-bytes-per-active-request gauge
        self._kv_used_acc = 0
        self._kv_active_acc = 0
        self._alloc_snap = (0, 0, 0, 0)  # (hits, lookups, cow, evictions) at epoch start

    # -- epoch ----------------------------------------------------------------

    def _maybe_reset(self) -> None:
        """Start a fresh stats/completions epoch on the first mutation after a
        finished run.  Resetting lazily (not at the top of ``run``) lets
        submit-time rejections land in the same epoch as the run that
        follows them."""
        if not self._ran:
            return
        self._ran = False
        self._completions = {}
        self._cancel = set()
        self._retried = set()
        self._fallback_rids = set()
        self._fault_fired = set()
        # _stall_fired and _stall_retried survive the epoch: a watchdog abort
        # ends the run, and the re-queue it leaves is consumed by the next
        # run(); wiping them would re-fire one-shot stalls and unbound the
        # retry (rids never repeat, so stale entries cannot collide)
        self._itl = []
        for k in self._counters:
            self._counters[k] = 0
        self._seg_steps = self._segments = self._chunks = 0
        self._active_slot_steps = 0
        self._decode_s = self._admit_s = 0.0
        self._kv_used_acc = self._kv_active_acc = 0
        if self.paged:
            # the prefix registry persists across epochs (a warm cache is the
            # point); only the rate counters snapshot per epoch
            self._alloc_snap = (self._alloc.hits, self._alloc.lookups,
                                self._alloc.cow_copies, self._alloc.evictions)

    # -- submission -----------------------------------------------------------

    def submit(self, req: Request, rid: Optional[int] = None) -> int:
        """Queue a request; returns its request id.  Under a full queue
        (``queue_cap``) the shed policy decides who pays: the newcomer is
        REJECTED, or a queued victim is shed (also REJECTED, counted under
        ``shed``) to make room.  ``rid`` pins the id explicitly."""
        self._maybe_reset()
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if req.max_new < 1:  # before the budget check: a negative max_new
            raise ValueError("max_new must be >= 1")  # could slip past it
        # worst-case KV rows this request can occupy: a slot decodes whole
        # segments (of rounds, speculative)
        budget = prompt.shape[0] + req.max_new + self._span
        if budget > self.eng.sc.max_len:
            raise ValueError(
                f"prompt({prompt.shape[0]}) + max_new({req.max_new}) + "
                f"segment span({self._span}) = {budget} exceeds max_len "
                f"{self.eng.sc.max_len}"
            )
        if self.paged:
            worst = -(-budget // self._layout.page)
            if worst > self._layout.rank_user_blocks:
                raise ValueError(
                    f"worst-case pages {worst} for this request exceed the "
                    f"arena's {self._layout.rank_user_blocks} user blocks "
                    f"(page_size={self._layout.page}, "
                    f"arena_blocks={self.eng.sc.arena_blocks}) — even an "
                    "empty pool could never hold it"
                )
        if rid is None:
            rid = self._next_rid
            self._next_rid += 1
        else:
            if rid in self._completions or any(r == rid for _, r, _ in self._queue) or any(
                s.active and s.rid == rid for s in self._slot
            ):
                raise ValueError(f"rid {rid} is already live or terminal")
            self._next_rid = max(self._next_rid, rid + 1)
        req = dataclasses.replace(req, prompt=prompt)
        if self.queue_cap is not None and len(self._queue) >= self.queue_cap:
            if not self._make_room(req):
                self._finish_unadmitted(rid, req, Status.REJECTED)
                self._counters["rejected"] += 1
                return rid
        bisect.insort(self._queue, (req.arrival_s, rid, req))
        return rid

    def _make_room(self, req: Request) -> bool:
        """Apply the shed policy to a full queue; True if a place was freed
        for ``req``.  ``shed-oldest`` evicts the longest-waiting entry;
        ``shed-lowest-priority`` evicts the lowest-priority one (latest
        arrival breaks ties) and only when the newcomer strictly outranks
        it, so equal-priority traffic cannot churn the queue."""
        if self.shed_policy == "reject":
            return False
        if self.shed_policy == "shed-oldest":
            j = 0
        else:  # shed-lowest-priority
            j = min(
                range(len(self._queue)),
                key=lambda t: (self._queue[t][2].priority, -self._queue[t][0],
                               -self._queue[t][1]),
            )
            if self._queue[j][2].priority >= req.priority:
                return False
        _, vrid, vreq = self._queue.pop(j)
        self._finish_unadmitted(vrid, vreq, Status.REJECTED)
        self._counters["shed"] += 1
        return True

    def cancel(self, rid: int) -> bool:
        """Cancel a request: queued requests complete CANCELLED at once;
        in-flight ones retire (with their partial tokens) at the next
        segment sync.  Returns False when ``rid`` is unknown or already
        terminal — cancellation never raises."""
        self._maybe_reset()
        for j, (_, r, req) in enumerate(self._queue):
            if r == rid:
                del self._queue[j]
                now = self._run_now() if self._run_now is not None else float("nan")
                self._finish_unadmitted(rid, req, Status.CANCELLED, finish=now)
                self._counters["cancelled"] += 1
                return True
        for s in self._slot:
            if s.active and s.rid == rid:
                self._cancel.add(rid)
                return True
        return False

    # -- streaming control plane ----------------------------------------------

    def drain(self) -> None:
        """Stop admission: in-flight requests finish normally, queued ones
        stay queued, and ``run()`` returns once no slot is active.  Safe to
        call from another thread (a flag read at sync points)."""
        self._draining = True

    def resume_admission(self) -> None:
        """Re-open admission after :meth:`drain`."""
        self._draining = False

    @property
    def draining(self) -> bool:
        return self._draining

    def abort(self, status: Status = Status.STALLED) -> None:
        """Fail fast (the watchdog's call when a segment stalls past its
        timeout): the run loop notices at the next interruptible point
        (syncs and every injected stall or idle wait), deals with the
        in-flight work and returns.  Each in-flight request is re-queued
        once (its re-execution under its own seed emits the same stream);
        one caught in a second abort retires with ``status``.  Safe to call
        from another thread."""
        self._abort_status = status

    def refresh_decode(self) -> None:
        """Drop the pool's captured graphs after ``Engine.reload_packed`` (a
        hot swap already drops every graph of the engine; this covers a
        scheduler whose engine swapped by other means): the next ``run``
        captures them afresh against the new pack.  Only between runs or
        while drained."""
        self.eng.release_pool(self._pool)

    @property
    def has_work(self) -> bool:
        """True while anything is queued or in flight."""
        return bool(self._queue) or any(s.active for s in self._slot)

    def inflight_tokens(self) -> Dict[int, List[int]]:
        """Host snapshot of every in-flight request's tokens so far."""
        return {s.rid: list(s.tokens) for s in self._slot if s.active and s.tokens is not None}

    def completions_so_far(self) -> Dict[int, Completion]:
        """Snapshot of this epoch's terminal completions (usable mid-run from
        ``on_sync``)."""
        return dict(self._completions)

    def itl_samples(self) -> List[float]:
        """This epoch's inter-token-latency samples, one per *emission
        event*: tokens surface only at segment syncs, so everything a slot
        emits at one sync counts as one ``t - last_emit_t`` interval.  A
        stream's first emission only sets the baseline (TTFT owns the first
        token)."""
        return list(self._itl)

    def verify_paged_mirror(self) -> bool:
        """The host block-table and position mirrors must agree with the
        device's (one small fetch of each; a test tool, never on the hot
        path).  True, or raises; True on slot-pool schedulers."""
        if not self.paged:
            return True
        table, pos = paged_host_mirror(self._pstate)
        for i, s in enumerate(self._slot):
            if not (s.active and s.prefill is None) or not self._dev.owns(i):
                continue  # free and admitting slots legitimately drift
            j = i - self._dev.lo
            if (not np.array_equal(table[j], self._dev.blocks(self._rows[i]))
                    or int(pos[j]) != self._pos[i]):
                raise AssertionError(
                    f"paged host mirror diverged for slot {i}: "
                    f"host pos {self._pos[i]} vs device {int(pos[j])}"
                )
        return True

    def _finish_unadmitted(self, rid: int, req: Request, status: Status,
                           finish: float = float("nan")) -> None:
        """Record a terminal completion for a request that never held a slot
        (rejected, shed, cancelled while queued, deadline-shed).  Timing
        fields that never happened stay NaN."""
        self._completions[rid] = Completion(
            rid=rid, tokens=np.zeros(0, np.int32), arrival_s=req.arrival_s,
            admit_s=float("nan"), finish_s=finish, status=status,
        )

    # -- device writes of admission -------------------------------------------

    def _seat(self, idx: List[int], first: torch.Tensor, reqs: List[Request]) -> None:
        """Set slots ``idx``' first tokens (``first`` (N, 1) on the device),
        zero their emitted counts and, when sampling, copy in their noise
        rows: the (max_new - 1, 1, V) table ``Engine.gumbel_noise`` draws at
        B = 1 from the request's seed, the rows one-shot generate uses."""
        st = self._pool
        dst = torch.as_tensor(idx, dtype=torch.long, device=st.token.device)
        st.token.index_copy_(0, dst, first.to(st.token.dtype))
        st.count.index_fill_(0, dst, 0)
        if st.noise is not None:
            for i, req in zip(idx, reqs):
                n = req.max_new - 1
                st.noise[i, :n].copy_(self.eng.gumbel_noise(n, 1, seed=req.seed)[:, 0])

    def _bind_slot(self, i: int, rid: int, req: Request, first, now: float) -> None:
        slot = self._slot[i]
        slot.rid, slot.tokens, slot.first = rid, [], first
        slot.remaining = req.max_new - 1
        slot.arrival_s, slot.admit_s = req.arrival_s, now
        slot.eos_id = req.eos_id
        slot.deadline = (req.arrival_s + req.deadline_s if req.deadline_s is not None
                         else float("inf"))
        slot.ttft_s = float("nan")
        slot.req = req
        slot.prefill = None

    # -- admission / retirement ----------------------------------------------

    def _admit(self, i: int, rid: int, req: Request, now: float) -> None:
        """Per-request exact-length admission (``admission="sequential"``):
        a B = 1 prime, the one-shot path's own prefill, written into slot
        ``i``.  First-token EOS/budget checks wait for the segment sync."""
        t0 = self._clock()
        nxt, cache = self.eng.prime(req.prompt[None])
        self._dev.write_slots([i], cache, [len(req.prompt)])
        self._seat([i], nxt, [req])
        self._bind_slot(i, rid, req, nxt, now)
        self._admit_s += self._clock() - t0

    def _groups(self, entries) -> Dict[int, list]:
        """Entries grouped by the prompt-length bucket of their request (the
        third element of each entry), in order of first appearance."""
        groups: Dict[int, list] = {}
        for e in entries:
            groups.setdefault(self.eng.bucket_len(len(e[2].prompt)), []).append(e)
        return groups

    def _bucket_batch(self, blen: int, reqs: List[Request]):
        """The (N, blen) right-padded prompts and (N,) true lengths of one
        bucket.  The reference pads N to a power of two to bound its XLA
        compiles; the port's eager prefill has none to bound, so N is the
        group's own size."""
        tokens = np.zeros((len(reqs), blen), np.int32)
        lengths = np.zeros(len(reqs), np.int64)
        for j, req in enumerate(reqs):
            tokens[j, : len(req.prompt)] = req.prompt
            lengths[j] = len(req.prompt)
        return tokens, lengths

    def _admit_batched(self, free: List[int], picked, now: float) -> None:
        """Bucketed admission: group this round's arrivals by prompt-length
        bucket, prime each bucket in one masked prefill, write each into its
        slots with one in-place scatter per cache leaf."""
        t0 = self._clock()
        entries = [(i, rid, req) for i, (rid, req) in zip(free, picked)]
        for blen, group in self._groups(entries).items():
            reqs = [req for _, _, req in group]
            tokens, lengths = self._bucket_batch(blen, reqs)
            nxt, cache = self.eng.prime_many(tokens, lengths)
            idx = [i for i, _, _ in group]
            self._dev.write_slots(idx, cache, lengths)
            self._seat(idx, nxt, reqs)
            for j, (i, rid, req) in enumerate(group):
                self._bind_slot(i, rid, req, nxt[j : j + 1], now)
        self._admit_s += self._clock() - t0

    # -- paged admission ------------------------------------------------------

    def _admit_paged(self, free: List[int], picked, now: float) -> list:
        """Paged admission round: per request, consult the prefix cache,
        allocate the prompt's blocks, then either join this round's bucketed
        whole-prompt prefill (no prefix hit, short prompt) or start a
        chunked prefill job (long prompt, or a prefix hit whose suffix must
        be recomputed against the shared blocks).  If the arena cannot cover
        a request *right now* it re-queues — no admission-time preemption,
        so two big prompts never thrash each other out; mid-flight extension
        is where preemption lives.  Returns the ``(slot, rid, req)`` triples
        admitted."""
        t0 = self._clock()
        admitted, whole = [], []
        pairs = list(zip(free, picked))
        for n_done, (i, (rid, req)) in enumerate(pairs):
            if not self._plan_paged_one(i, rid, req, now, whole):
                for _, (rid2, req2) in pairs[n_done:]:
                    bisect.insort(self._queue, (req2.arrival_s, rid2, req2))
                break
            admitted.append((i, rid, req))
        if whole:
            self._prime_whole_paged(whole)
        self._admit_s += self._clock() - t0
        return admitted

    def _plan_paged_one(self, i: int, rid: int, req: Request, now: float, whole) -> bool:
        """Allocate or share blocks for one request and choose its prefill
        path.  False = the arena cannot cover its prompt pages right now
        (matched references are returned before bailing)."""
        prompt, L = req.prompt, len(req.prompt)
        page = self._layout.page
        poisoned = self._wants_poison(rid)
        rank = self._layout.slot_rank(i)
        full = prefix_page_digests(prompt, page) if self._prefix_on else []
        shared = self._alloc.match_pages(full, rank) if self._prefix_on else []
        k = len(shared)
        cow = None
        if self._prefix_on and L % page and k == L // page:
            # every full page matched: probe the partial tail for a COW source
            seed = full[-1] if full else b""
            cow = self._alloc.match_tail(prefix_tail_digests(seed, prompt[k * page:]), rank)
        n_prompt_pages = -(-L // page)
        got = self._alloc.alloc(n_prompt_pages - k, rank)
        if got is None:
            if shared:
                self._alloc.free(shared)  # hashed: parked back in the cached pool
            return False
        priv, scrub = got
        if scrub:
            self._dev.zero_blocks(scrub)
        row = self._rows[i]
        row[:] = self._layout.scratch_block(i)
        row[:k] = shared
        row[k:n_prompt_pages] = priv
        self._slot_blocks[i] = list(shared) + list(priv)
        self._slot_private[i] = list(priv)
        self._slot_npages[i] = n_prompt_pages
        start = k * page
        if cow is not None:
            src, rows_m = cow
            # copy the matched tail rows into our private tail page; the
            # sharer keeps reading the original
            self._dev.copy_block(src, priv[0])
            start += rows_m
        self._bind_slot(i, rid, req, None, now)
        if start == 0 and (self._chunk_cfg == 0 or L <= self._chunk_cfg):
            whole.append((i, rid, req, poisoned))
            return True
        if start >= L:
            # fully matched prompt: no re-prefill; one 1-token re-peek chunk
            # recomputes the last position's logits against the shared
            # blocks (write_from = L: no arena writes)
            job = _PrefillJob(prompt, L, start=L - 1, write_from=L,
                              chunk=self._chunk_cfg or self.eng.bucket_len(1),
                              poisoned=poisoned)
        else:
            cw = self._chunk_cfg or self.eng.bucket_len(max(L - start, 1))
            job = _PrefillJob(prompt, L, start=start, write_from=start, chunk=cw,
                              poisoned=poisoned)
        self._slot[i].prefill = job
        return True

    def _prime_whole_paged(self, whole) -> None:
        """Whole-prompt prefill of this round's no-prefix-hit requests,
        written into their arena pages and bound: bucketed, the paged mirror
        of ``_admit_batched`` in the same groups, so the two pools prime
        identical batches; with ``admission="sequential"`` each request
        alone at its exact length (``Engine.prime``), the one-shot path's
        own prefill, as ``_admit`` does for the slot pool.  A poisoned
        request's pages are never registered: no later prompt may match
        into them."""
        n_pages = self._layout.n_pages
        if self.admission == "sequential":
            batches = [[e] for e in whole]
        else:
            batches = list(self._groups(whole).values())
        for group in batches:
            reqs = [req for _, _, req, _ in group]
            # the primed cache spans max_len rows; pages past the prompt
            # carry the sentinel and are dropped
            pt = np.full((len(group), n_pages), self._layout.oob, np.int64)
            for j, (i, _, _, _) in enumerate(group):
                npp = self._slot_npages[i]
                pt[j, :npp] = self._rows[i][:npp]
            if self.admission == "sequential":
                lengths = np.asarray([len(reqs[0].prompt)], np.int64)
                nxt, cache = self.eng.prime(reqs[0].prompt[None])
            else:
                blen = self.eng.bucket_len(len(reqs[0].prompt))
                tokens, lengths = self._bucket_batch(blen, reqs)
                nxt, cache = self.eng.prime_many(tokens, lengths)
            self._dev.write_prefill_pages(
                pt, {name: cache[name] for name in self._pstate["arena"]})
            idx = [i for i, _, _, _ in group]
            self._dev.bind(idx, self._rows[idx], lengths)
            self._seat(idx, nxt, reqs)
            for j, (i, _, req, poisoned) in enumerate(group):
                self._slot[i].first = nxt[j : j + 1]
                self._pos[i] = len(req.prompt)
                if not poisoned:
                    self._register_prompt(i, req.prompt)

    def _register_prompt(self, i: int, prompt: np.ndarray) -> None:
        """Hash-register slot ``i``'s prompt pages for future prefix sharing
        (first writer wins; already-shared pages re-register as no-ops)."""
        if not self._prefix_on:
            return
        page = self._layout.page
        full = prefix_page_digests(prompt, page)
        row = self._rows[i]
        for p, d in enumerate(full):
            self._alloc.register_page(d, int(row[p]))
        tail_len = len(prompt) % page
        if tail_len:
            seed = full[-1] if full else b""
            td = prefix_tail_digests(seed, prompt[len(full) * page:])
            self._alloc.register_tail(td[-1], int(row[len(full)]), tail_len)

    def _step_prefills(self) -> None:
        """Advance every in-flight prefill job by ONE chunk, between decode
        segments, so a long admission never stalls decoding slots.  A
        completed job binds its slot (table row, position, first token,
        noise rows) and registers its prefix hashes."""
        if not self.paged:
            return
        t0 = self._clock()
        for i, slot in enumerate(self._slot):
            job = slot.prefill
            if job is None or not slot.active:
                continue
            s = job.start
            n = min(job.chunk, job.L - s)
            toks = np.zeros((1, job.chunk), np.int32)
            toks[0, :n] = job.prompt[s : s + n]
            # the rank that owns the slot holds its blocks: it runs the
            # chunk and hands the logits to the others
            logits = None
            if self._dev.owns(i):
                logits, _ = self.eng.prefill_chunk(toks, self._pstate["arena"],
                                                   self._dev.blocks(self._rows[i]), s, n,
                                                   job.write_from)
                logits = logits.float()
            elif self.eng.steps_span_data:
                # the chunk's layers gather over data: the other ranks run it
                # too, on a table of block 0, writing nothing
                self.eng.prefill_chunk(toks, self._pstate["arena"],
                                       np.zeros(self._layout.n_pages, np.int64), s, n, s + n)
            logits = self._dev.from_owner(logits, i, self._chunk_logits)
            job.start = s + n
            self._chunks += 1
            if job.start >= job.L:
                self._complete_prefill(i, job, choose_tokens(logits.float(),
                                                             self.eng.cfg.vocab)[:, None])
        self._admit_s += self._clock() - t0

    def _complete_prefill(self, i: int, job: _PrefillJob, first) -> None:
        slot = self._slot[i]
        self._dev.bind([i], self._rows[i][None], [job.L])
        self._seat([i], first, [slot.req])
        self._pos[i] = job.L
        slot.first = first
        slot.prefill = None
        if job.poisoned:
            self._fault_fired.add(slot.rid)
            self._apply_paged_poison(i)
        else:
            self._register_prompt(i, job.prompt)

    def _extend_paged(self) -> None:
        """Lazy decode-page extension before each segment: every decoding
        slot's table must cover the rows this segment writes.  Arena
        exhaustion preempts the latest-admitted other slot (its request
        re-queues and re-primes later with its own seed); the earliest
        admission is never the victim, so the pool always progresses."""
        if not self.paged:
            return
        t0 = self._clock()
        for i in range(self.slots):
            slot = self._slot[i]
            if not slot.active or slot.prefill is not None:
                continue
            needed = min(-(-(self._pos[i] + self._span) // self._layout.page),
                         self._layout.n_pages)
            cur = self._slot_npages[i]
            if needed <= cur:
                continue
            ids = self._alloc_or_preempt(needed - cur, protect=i)
            self._rows[i][cur:needed] = ids
            self._slot_blocks[i] += list(ids)
            self._slot_private[i] += list(ids)
            self._slot_npages[i] = needed
            self._rebind_row(i)
        self._admit_s += self._clock() - t0

    def _alloc_or_preempt(self, n: int, protect: int) -> list:
        rank = self._layout.slot_rank(protect)
        got = self._alloc.alloc(n, rank)
        while got is None:
            # only a slot of the same rank frees blocks this one can take
            cands = [j for j, s in enumerate(self._slot) if s.active and j != protect
                     and self._layout.slot_rank(j) == rank]
            if not cands:
                raise RuntimeError(
                    "paged arena exhausted with nothing left to preempt "
                    "(the submit-time worst-case check should make this unreachable)"
                )
            victim = max(cands, key=lambda j: (self._slot[j].admit_s, j))
            self._preempt(victim)
            got = self._alloc.alloc(n, rank)
        ids, scrub = got
        if scrub:
            self._dev.zero_blocks(scrub)
        return ids

    def _preempt(self, j: int) -> None:
        """Evict slot ``j`` mid-flight: free its blocks and re-queue its
        request.  Re-admission re-primes from the prompt with the request's
        own seed."""
        slot = self._slot[j]
        rid, req = slot.rid, slot.req
        self._release_slot_pages(j)
        self._slot[j] = _Slot()
        self._counters["preempted"] += 1
        bisect.insort(self._queue, (req.arrival_s, rid, req))

    def _rebind_row(self, i: int) -> None:
        self._dev.bind([i], self._rows[i][None], [self._pos[i]])

    def _release_slot_pages(self, i: int) -> None:
        """Return slot ``i``'s blocks to the allocator (hashed blocks park in
        the cached pool keeping their bytes; unhashed dead blocks are zeroed
        at once) and detach its table back to scratch."""
        blocks = self._slot_blocks[i]
        if blocks:
            dead = self._alloc.free(blocks)
            if dead:
                self._dev.zero_blocks(dead)
        self._slot_blocks[i] = []
        self._slot_private[i] = []
        self._slot_npages[i] = 0
        self._rows[i][:] = self._layout.scratch_block(i)
        self._pos[i] = 0
        self._dev.reset_slot(i)

    # -- fault injection -------------------------------------------------------

    def _wants_poison(self, rid: int) -> bool:
        """The fault plan poisons this admission of ``rid``: selected, and
        not already fired when the fault is one-shot (``cache_nan_once``)."""
        f = self.eng.sc.faults
        return (f is not None and f.wants_cache_nan(rid)
                and (not f.cache_nan_once or rid not in self._fault_fired))

    def _apply_paged_poison(self, i: int) -> None:
        """Cache poisoning on the paged layout: NaN the slot's first
        *private* block.  A fully prefix-shared prompt owns none, so one is
        privatized first (copy-on-write): poison never reaches a block
        another request reads.  The block's hash registration is dropped,
        so no later prompt can match into the poisoned bytes, and it dies
        unhashed when the slot releases it, which zeroes it."""
        if not self._slot_blocks[i]:
            return
        if self._slot_private[i]:
            blk = self._slot_private[i][0]
        else:
            [blk] = self._alloc_or_preempt(1, protect=i)
            old = int(self._rows[i][0])
            self._dev.copy_block(old, blk)
            self._rows[i][0] = blk
            bl = self._slot_blocks[i]
            bl[bl.index(old)] = blk
            self._slot_private[i].insert(0, blk)
            dead = self._alloc.free([old])
            if dead:
                self._dev.zero_blocks(dead)
            self._rebind_row(i)
        dead = self._alloc.forget(blk)
        if dead:
            self._dev.zero_blocks(dead)
        self._dev.poison_block(blk)

    def _inject_admission_faults(self, free: List[int], picked) -> None:
        """Apply the fault plan to this admission round: admission stalls
        (a slow host) and cache poisoning of the selected requests.
        ``cache_nan_once`` fires a rid's fault on its first admission only,
        so its dense retry runs clean; ``False`` fires it again on the
        retry, a persistent fault the bounded retry cannot outrun."""
        f = self.eng.sc.faults
        if f is None:
            return
        t0 = self._clock()
        for i, (rid, req) in zip(free, picked):
            if f.wants_stall(rid):
                self._sleep(f.stall_s)
            if self._wants_poison(rid):
                if self.paged:
                    if self._slot[i].prefill is not None:
                        # chunked admission: the chunks would overwrite poison
                        # written now; the job fires it at completion
                        continue
                    self._fault_fired.add(rid)
                    self._apply_paged_poison(i)
                else:
                    self._fault_fired.add(rid)
                    self._dev.poison_slot(i)
        self._admit_s += self._clock() - t0

    def _stall_wait(self, secs: float) -> None:
        """Sleep ``secs`` (inf: a hang) in short interruptible waits, bailing
        out the moment :meth:`abort` fires, so an injected stall is
        escapable: the watchdog's abort lands between waits."""
        t0 = self._clock()
        while self._abort_status is None:
            left = secs - (self._clock() - t0)
            if left <= 0:
                return
            self._sleep(min(left, 0.02) if math.isfinite(left) else 0.02)

    def _inject_decode_stall(self, active_idx: List[int]) -> None:
        """Seeded decode stall or hang right before a segment's dispatch,
        when an active rid is selected: finite (``decode_stall_s``, a slow
        device) or unbounded (``decode_hang_rids``, a wedged device only the
        watchdog's abort ends).  One-shot per rid by default
        (``decode_stall_once``), so the re-queue after an abort runs
        clean."""
        f = self.eng.sc.faults
        if f is None or not f.stalls_decode():
            return
        for i in active_idx:
            rid = self._slot[i].rid
            if f.decode_stall_once and rid in self._stall_fired:
                continue
            hang = f.wants_decode_hang(rid)
            if hang or f.wants_decode_stall(rid):
                self._stall_fired.add(rid)
                self._stall_wait(math.inf if hang else f.decode_stall_s)
                if self._abort_status is not None:
                    return

    def _abort_epilogue(self, now: float) -> None:
        """The fail-fast exit: every in-flight slot is re-queued (first abort
        of its rid: the re-execution under its own seed emits the same
        stream, the consumer sees the tail late) or retired with the abort's
        status (second abort: the retry is bounded), then the flag clears so
        the next ``run`` starts clean."""
        status = self._abort_status or Status.STALLED
        for i, slot in enumerate(self._slot):
            if not slot.active:
                continue
            if slot.rid in self._stall_retried:
                self._counters["stalled"] += 1
                self._retire(i, now, status)
            else:
                self._stall_retried.add(slot.rid)
                rid, req = slot.rid, slot.req
                if self.paged:
                    self._release_slot_pages(i)
                self._slot[i] = _Slot()
                self._counters["preempted"] += 1
                bisect.insort(self._queue, (req.arrival_s, rid, req))
        self._abort_status = None

    def _pop_arrived(self, k: int, now: float) -> list:
        """Take up to ``k`` queued requests whose arrival time has passed:
        highest priority first, earliest arrival breaking ties.  The queue is
        arrival-sorted, so the arrived set is a front prefix.  Requests whose
        queue wait already blew their deadline are shed here as TIMEOUT."""
        n = 0
        while n < len(self._queue) and self._queue[n][0] <= now:
            n += 1
        arrived, ready = self._queue[:n], []
        del self._queue[:n]
        for entry in arrived:
            _, rid, req = entry
            if req.deadline_s is not None and now > req.arrival_s + req.deadline_s:
                self._finish_unadmitted(rid, req, Status.TIMEOUT, finish=now)
                self._counters["timed_out"] += 1
                continue
            ready.append(entry)
        ready.sort(key=lambda e: (-e[2].priority, e[0], e[1]))
        take, leftover = ready[:k], ready[k:]
        for e in leftover:  # back into arrival order for the next round
            bisect.insort(self._queue, e)
        return [(rid, req) for _, rid, req in take]

    def _note_emission(self, slot: _Slot, n_before: int, t: float) -> None:
        """One ITL sample per emission event (see :meth:`itl_samples`)."""
        emitted = (len(slot.tokens) if slot.tokens is not None else 0) - n_before
        if emitted <= 0:
            return
        if not math.isnan(slot.last_emit_t):
            self._itl.append(t - slot.last_emit_t)
        slot.last_emit_t = t

    def _retire(self, i: int, now: float, status: Status = Status.OK) -> Completion:
        slot = self._slot[i]
        if status is Status.OK and slot.rid in self._fallback_rids:
            status = Status.FAILED_FALLBACK_OK
        done = Completion(
            rid=slot.rid, tokens=np.asarray(slot.tokens, np.int32), arrival_s=slot.arrival_s,
            admit_s=slot.admit_s, finish_s=now, status=status, ttft_s=slot.ttft_s,
        )
        self._completions[slot.rid] = done
        self._cancel.discard(slot.rid)
        if self.paged:
            self._release_slot_pages(i)
        self._slot[i] = _Slot()
        return done

    def _fail_slot(self, i: int, now: float) -> None:
        """Slot ``i`` tripped the non-finite guard.  Under packed weights the
        pack is quarantined (the corrupt bytes may be anywhere in it) and
        the whole pool continues dense.  The request gets one re-admission,
        re-primed from its prompt with its own seed, so its tokens are those
        of a clean dense run; a second trip is terminal ``FAILED``, never a
        loop.  A retry starts from a clean cache: the slot pool's admission
        rewrites the slot's whole ``max_len`` row, and the paged pool zeroes
        the poisoned private block when it dies here."""
        slot = self._slot[i]
        rid, req = slot.rid, slot.req
        if self.eng.packed_active and self.eng.quarantine_packed():
            self._counters["quarantined"] += 1
        if rid in self._retried:
            self._counters["failed"] += 1
            self._retire(i, now, Status.FAILED)
            return
        self._retried.add(rid)
        self._fallback_rids.add(rid)
        self._counters["fallback"] += 1
        if self.paged:
            self._release_slot_pages(i)
        self._slot[i] = _Slot()
        bisect.insort(self._queue, (req.arrival_s, rid, req))

    # -- run loop -------------------------------------------------------------

    def run(
        self,
        requests: Optional[List[Request]] = None,
        on_sync: Optional[Callable[["Scheduler"], None]] = None,
    ) -> Dict[int, Completion]:
        """Drain the queue (plus ``requests``), honouring arrival times.
        Returns ``{rid: Completion}``: every submitted rid, whatever its
        terminal status; aggregate numbers via :meth:`stats`.  ``on_sync``
        (if given) fires after each segment sync."""
        self._maybe_reset()
        for r in requests or []:
            self.submit(r)
        # every slot is free here: the pool step's capture may run its warm-up
        self.eng.prepare_pool(self._pool)
        t_start = self._clock()

        def now() -> float:
            return self._clock() - t_start

        def shared_now() -> float:
            """The run-relative time every decision of this round reads: on
            a mesh, rank 0's, broadcast to every rank (one fp64 scalar), so
            every rank admits, sheds and times out in the same round and
            their collectives pair; rank-local clocks only time waits."""
            t = now()
            if self.eng.mesh is None:
                return t
            dev = "cpu" if dist.get_backend() == "gloo" else self.eng.device
            buf = torch.tensor([t], dtype=torch.float64, device=dev)
            return float(broadcast_mesh(buf, self.eng.mesh)[0])

        self._run_now = now
        try:
            while self._queue or any(s.active for s in self._slot):
                if self._abort_status is not None:
                    self._abort_epilogue(now())
                    break
                if self._draining and not any(s.active for s in self._slot):
                    break  # drained: queued requests survive for the next run
                t = shared_now()
                free = [i for i, s in enumerate(self._slot) if not s.active]
                if free and self._queue and not self._draining:
                    picked = self._pop_arrived(len(free), t)
                    if picked:
                        if self.paged:
                            admitted = self._admit_paged(free[: len(picked)], picked, t)
                            self._inject_admission_faults(
                                [i for i, _, _ in admitted],
                                [(rid, req) for _, rid, req in admitted])
                        else:
                            if self.admission == "batched" and self.eng.batched_prefill:
                                self._admit_batched(free[: len(picked)], picked, t)
                            else:
                                for i, (rid, req) in zip(free, picked):
                                    self._admit(i, rid, req, t)
                            self._inject_admission_faults(free, picked)
                if self.paged:
                    # one prefill chunk per admitting slot, then make sure
                    # every decoding slot's table covers this segment's rows
                    self._step_prefills()
                    self._extend_paged()
                active_idx = [i for i, s in enumerate(self._slot) if s.active]
                if not active_idx:
                    if not self._queue:
                        continue  # drained; the loop condition exits
                    # nothing in flight: sleep until the queue head arrives,
                    # in short waits so drain() and abort() can interrupt
                    wait = self._queue[0][0] - now()
                    while wait > 0 and self._abort_status is None and not self._draining:
                        self._sleep(min(wait, 0.02))
                        wait = self._queue[0][0] - now()
                    continue
                # a seeded decode stall rides right before the dispatch; an
                # abort fired during it exits here instead of dispatching
                self._inject_decode_stall(active_idx)
                if self._abort_status is not None:
                    self._abort_epilogue(now())
                    break
                self._segment(active_idx, shared_now)
                if on_sync is not None:
                    on_sync(self)
        finally:
            self._run_now = None
        self._ran = True
        return self._completions

    def _fetch_segment(self):
        """Decode one segment and fetch its grids in one transfer: tokens and
        flags (segment, slots, S) and emitted counts (segment, slots), S =
        ``draft_k`` + 1 rounds wide, or S = 1 (one token a step) for plain
        decode, so one consumption loop serves both."""
        grid = self.eng.pool_segment(self._pool).cpu().numpy()  # the one fetch
        if self.speculative:
            S = self._draft_k + 1
            toks = grid[:, :, :S].transpose(1, 0, 2)
            oks = grid[:, :, S : 2 * S].transpose(1, 0, 2).astype(bool)
            return toks, oks, grid[:, :, 2 * S].T
        toks, oks = grid[0].T[:, :, None], grid[1].T[:, :, None].astype(bool)
        return toks, oks, np.ones(toks.shape[:2], np.int64)

    def _segment(self, active_idx: List[int], now) -> None:
        """Decode one segment and sync once: tokens, integrity flags and
        (speculative) emitted counts come back in the same fetch, then every
        active slot consumes its rounds of the grid, ``tokens[r, i,
        :nem[r, i]]`` in order."""
        t0 = self._clock()
        toks_np, ok_np, nem_np = self._fetch_segment()
        self._decode_s += self._clock() - t0
        self._segments += 1
        self._seg_steps += self.segment
        self._active_slot_steps += len(active_idx) * self.segment
        if self.paged:  # each slot advanced by its own emitted total
            self._pos = [p + int(nem_np[:, i].sum()) for i, p in enumerate(self._pos)]
        self._kv_active_acc += len(active_idx)
        self._kv_used_acc += (self._alloc.live_blocks * self._block_bytes if self.paged
                              else len(active_idx) * self._slot_bytes)
        t = now()
        for i in active_idx:
            slot = self._slot[i]
            n_before = len(slot.tokens) if slot.tokens is not None else 0
            if slot.prefill is not None:
                # mid-chunked-prefill: no tokens yet; only deadlines and
                # cancellation apply at this sync
                if slot.rid in self._cancel:
                    self._counters["cancelled"] += 1
                    self._retire(i, t, Status.CANCELLED)
                elif t > slot.deadline:
                    self._counters["timed_out"] += 1
                    self._retire(i, t, Status.TIMEOUT)
                continue
            if slot.rid in self._cancel:
                self._counters["cancelled"] += 1
                self._retire(i, t, Status.CANCELLED)
                continue
            if slot.first is not None:
                # deferred first token: EOS/budget checked here, at the
                # segment sync, never in the admission path
                first = int(slot.first.reshape(-1)[0])
                slot.tokens.append(first)
                slot.first = None
                slot.ttft_s = t - slot.arrival_s
                if slot.remaining == 0 or (slot.eos_id is not None and first == slot.eos_id):
                    self._note_emission(slot, n_before, t)
                    self._retire(i, t)
                    continue
            stop = False
            for step in range(self.segment):
                if stop or slot.remaining <= 0:
                    break
                used = 0
                for j in range(int(nem_np[step, i])):
                    if not ok_np[step, i, j]:
                        # non-finite logits: every token from this position
                        # on is garbage; cut there, retry dense or fail
                        self._fail_slot(i, t)
                        stop = True
                        break
                    tok = int(toks_np[step, i, j])
                    slot.tokens.append(tok)
                    slot.remaining -= 1
                    used += 1
                    if (slot.eos_id is not None and tok == slot.eos_id) or slot.remaining == 0:
                        self._retire(i, t)
                        stop = True
                        break
                if self.speculative and used:
                    # per consumed round: draft_k proposals, used - 1 of them
                    # accepted (the first emission is the round's pending
                    # token, not a draft)
                    self._counters["spec_proposed"] += self._draft_k
                    self._counters["spec_accepted"] += used - 1
            self._note_emission(slot, n_before, t)
            slot = self._slot[i]  # may have retired or failed above
            if slot.active and t > slot.deadline:
                self._counters["timed_out"] += 1
                self._retire(i, t, Status.TIMEOUT)

    def stats(self) -> Dict[str, float]:
        """Aggregate serve metrics for the most recent :meth:`run` epoch.
        Latency/TTFT/ITL percentiles are over the completions that have the
        timing (NaN entries excluded) and are NaN when none do: an empty run
        must not read as an infinitely fast one."""
        done = sorted(self._completions.values(), key=lambda c: c.rid)
        lat = np.asarray([c.latency_s for c in done], np.float64)
        lat = lat[np.isfinite(lat)]
        ttft = np.asarray([c.ttft_s for c in done], np.float64)
        ttft = ttft[np.isfinite(ttft)]
        itl = np.asarray(self._itl, np.float64)
        itl = itl[np.isfinite(itl)]
        decoded = sum(max(len(c.tokens) - 1, 0) for c in done)
        busy = self._decode_s + self._admit_s

        def pct(a, q):
            return float(np.percentile(a, q)) if a.size else float("nan")

        out = {
            "requests": len(done),
            "decoded_tokens": decoded,
            "sustained_tok_per_s": decoded / max(busy, 1e-9),
            "decode_s": self._decode_s,
            "admit_s": self._admit_s,
            "latency_p50_s": pct(lat, 50),
            "latency_p95_s": pct(lat, 95),
            "latency_p99_s": pct(lat, 99),
            "ttft_p50_s": pct(ttft, 50),
            "ttft_p95_s": pct(ttft, 95),
            "ttft_p99_s": pct(ttft, 99),
            "itl_p50_s": pct(itl, 50),
            "itl_p95_s": pct(itl, 95),
            "itl_p99_s": pct(itl, 99),
            "slot_occupancy": self._active_slot_steps / max(self.slots * self._seg_steps, 1),
            "tok_per_s": tok_per_s(decoded, self._decode_s),
            "acceptance_rate": acceptance_rate(self._counters["spec_accepted"],
                                               self._counters["spec_proposed"]),
            # the port's own counts beside the reference's keys: segments
            # decoded and paged prefill chunks run this epoch
            "segments": self._segments,
            "prefill_chunks": self._chunks,
        }
        # cache gauges: always present, NaN where a gauge does not apply
        # (slot-pool mode, or an epoch with no traffic)
        if self.paged:
            h0, l0, c0, e0 = self._alloc_snap
            hits = self._alloc.hits - h0
            lookups = self._alloc.lookups - l0
            out.update({
                "kv_pool_bytes": float(self._arena_bytes),
                "kv_block_bytes": float(self._block_bytes),
                "blocks_total": float(self._layout.user_blocks),
                "blocks_live": float(self._alloc.live_blocks),
                "blocks_free": float(self._alloc.free_blocks),
                "blocks_cached": float(self._alloc.cached_blocks),
                "prefix_lookups": float(lookups),
                "prefix_hits": float(hits),
                "prefix_hit_rate": hits / lookups if lookups else float("nan"),
                "cow_copies": float(self._alloc.cow_copies - c0),
                "cache_evictions": float(self._alloc.evictions - e0),
            })
        else:
            out.update({
                "kv_pool_bytes": float(self._slot_bytes * self.slots),
                "kv_block_bytes": float(self._slot_bytes),
                "blocks_total": float("nan"),
                "blocks_live": float("nan"),
                "blocks_free": float("nan"),
                "blocks_cached": float("nan"),
                "prefix_lookups": 0.0,
                "prefix_hits": 0.0,
                "prefix_hit_rate": float("nan"),
                "cow_copies": 0.0,
                "cache_evictions": 0.0,
            })
        out["hbm_bytes_per_active_request"] = (
            self._kv_used_acc / self._kv_active_acc if self._kv_active_acc else float("nan")
        )
        out.update(self._counters)
        return out
