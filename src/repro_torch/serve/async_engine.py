"""Asyncio streaming front end over the Scheduler.

Port of the JAX package's ``serve/async_engine.py``.

:class:`AsyncEngine` runs the blocking continuous-batching loop on a worker
thread and bridges it to an asyncio event loop:

* ``submit()`` returns a :class:`TokenStream` — an ``AsyncIterator[int]``
  that yields tokens as segment syncs surface them (tokens are only
  *observable* at syncs; the per-sync push costs zero extra device traffic
  because the scheduler's token lists already live on the host).
* Every externally visible event is journaled through
  :class:`~.journal.JournalTap` (submit / admit / token-batch / retire),
  fsync'd once per segment sync.  :meth:`recover` rebuilds a crashed
  engine from its journal: proven completions come back verbatim, in-flight
  requests re-execute under their ORIGINAL rids and seeds, so the token
  streams are bit-identical to a crash-free run.
* A watchdog task converts a wedged segment (real, or injected via
  ``FaultConfig.decode_hang_rids``) into a fail-fast ``STALLED`` abort
  instead of hanging the event loop: the scheduler re-queues each in-flight
  request once (re-execution is bit-identical; consumers just see the tail
  late) and terminally retires repeat offenders.
* ``drain()`` stops admission and waits for in-flight work; ``hot_swap()``
  drains, rebuilds the VUSA pack via ``Engine.reload_packed`` (which drops
  the engine's captured CUDA graphs; the next run captures them against the
  new pack), journals the new pack's fingerprint, and resumes — zero
  dropped requests.

Threading model: the event loop owns submission and consumption; the worker
thread owns the scheduler.  Submissions are buffered under a lock and
injected into the scheduler only from the worker (at syncs, or between
runs), so the scheduler itself is never touched from two threads — the only
cross-thread calls into it are the documented flag-setters ``drain`` /
``resume_admission`` / ``abort``.  The worker sets the engine's CUDA device
and captures and replays the pool's graphs on its own current stream
(``Scheduler.run`` prepares the pool at its start, on the worker).  A hot
swap rebuilds the pack from the event loop's thread while the worker is
idle (drained), as the reference does.
"""

from __future__ import annotations

import asyncio
import threading
from typing import AsyncIterator, Dict, List, Optional, Tuple

import numpy as np

from .journal import Journal, JournalTap, recover_into
from .scheduler import Completion, Request, Scheduler, Status

__all__ = ["AsyncEngine", "TokenStream"]

_EOS = object()  # stream sentinel


class TokenStream:
    """Async iterator over one request's tokens, ending with its Completion.

    Tokens arrive in segment-sync batches; iteration yields them one at a
    time.  After exhaustion :meth:`completion` returns immediately (it can
    also be awaited without iterating — a non-streaming caller's one-shot)."""

    def __init__(self, rid: int, loop: asyncio.AbstractEventLoop):
        self.rid = rid
        self._q: asyncio.Queue = asyncio.Queue()
        self._loop = loop
        self._done: asyncio.Future = loop.create_future()

    def __aiter__(self) -> AsyncIterator[int]:
        return self

    async def __anext__(self) -> int:
        if self._done.done() and self._q.empty():
            raise StopAsyncIteration
        item = await self._q.get()
        if item is _EOS:
            raise StopAsyncIteration
        return item

    async def completion(self) -> Completion:
        """The request's terminal Completion (status + full token array)."""
        return await asyncio.shield(self._done)

    # -- worker-thread side (called via call_soon_threadsafe) ----------------

    def _feed(self, toks: List[int]) -> None:
        for t in toks:
            self._q.put_nowait(t)

    def _finish(self, comp: Completion) -> None:
        self._q.put_nowait(_EOS)
        if not self._done.done():
            self._done.set_result(comp)

    def _fail(self, exc: BaseException) -> None:
        """The worker died: end the stream, and ``completion`` raises."""
        self._q.put_nowait(_EOS)
        if not self._done.done():
            self._done.set_exception(exc)


class AsyncEngine:
    """Crash-safe asyncio front end over a :class:`Scheduler`.

    ``watchdog_s`` arms the stall watchdog: a running scheduler that has not
    completed a segment sync for this long is aborted ``STALLED``.  ``None``
    disarms it (trust the device).  ``journal`` persists every request event
    for :meth:`recover`; ``None`` serves memory-only.
    """

    def __init__(
        self,
        sched: Scheduler,
        journal: Optional[Journal] = None,
        watchdog_s: Optional[float] = None,
        completed: Optional[Dict[int, Completion]] = None,
    ):
        self.sched = sched
        self.journal = journal
        self.watchdog_s = watchdog_s
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._lock = threading.Lock()
        self._pending: List[Tuple[int, Request]] = []  # event loop -> worker
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._watchdog_task: Optional[asyncio.Task] = None
        self._streams: Dict[int, TokenStream] = {}
        # completions the journal proved before this process started
        # (recovery), merged with everything retired since
        self._completed: Dict[int, Completion] = dict(completed or {})
        self._next_rid = (
            max(self._completed, default=-1) + 1 if self._completed else 0
        )
        self._tap = JournalTap(
            journal, on_new_tokens=self._on_tokens, on_retire=self._on_retire
        )
        # lifetime SLO series (scheduler stats reset per run epoch; a
        # long-lived server wants the union)
        self._ttft: List[float] = []
        self._latency: List[float] = []
        self._itl_all: List[float] = []  # finished epochs' ITL samples
        self._last_sync = sched._clock()
        self._recovered_rids: List[int] = []

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> "AsyncEngine":
        """Bind to the running event loop and start the worker thread (and
        the watchdog, if armed).  Idempotent per engine."""
        if self._thread is not None:
            return self
        self._loop = asyncio.get_running_loop()
        self._thread = threading.Thread(
            target=self._worker, name="async-engine", daemon=True
        )
        self._thread.start()
        if self.watchdog_s is not None:
            self._watchdog_task = self._loop.create_task(self._watchdog())
        # recovered requests are already queued in the scheduler: kick the
        # worker so their re-execution starts without waiting for traffic
        if self.sched.has_work:
            self._wake.set()
        return self

    async def __aenter__(self) -> "AsyncEngine":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def close(self, clean: bool = True) -> None:
        """Stop the worker and close the journal.  ``clean`` appends the
        close marker — a journal without one reads as a crash (which is
        exactly right for tests that simulate one)."""
        self._stop = True
        self.sched.drain()
        self._wake.set()
        if self._watchdog_task is not None:
            self._watchdog_task.cancel()
            self._watchdog_task = None
        if self._thread is not None:
            await asyncio.get_running_loop().run_in_executor(
                None, self._thread.join
            )
            self._thread = None
        if self.journal is not None:
            self.journal.close(clean=clean)
        self.sched.resume_admission()  # leave the scheduler reusable

    @classmethod
    def recover(
        cls,
        path,
        sched: Scheduler,
        watchdog_s: Optional[float] = None,
    ) -> "AsyncEngine":
        """Rebuild an engine from a crashed journal: proven completions are
        served from the journal verbatim (no recompute), every non-retired
        request is re-queued under its original rid/seed, and the journal is
        reopened (torn tail truncated, ``recover`` marker fsync'd).  Start
        the returned engine with :meth:`start`; re-executed streams are
        journaled and streamed from token 0."""
        journal, completed, recovered = recover_into(path, sched)
        eng = cls(sched, journal=journal, watchdog_s=watchdog_s, completed=completed)
        eng._recovered_rids = recovered
        eng._next_rid = max(
            [eng._next_rid] + [r + 1 for r in recovered]
        )
        return eng

    # -- submission / streaming ----------------------------------------------

    def submit(self, req: Request, rid: Optional[int] = None) -> TokenStream:
        """Queue a request; returns its :class:`TokenStream` immediately.
        The submit record is journaled now (durable at the next segment
        sync — an ack that races a crash is re-submitted by the client,
        classic WAL semantics); the scheduler sees the request at the next
        sync boundary or idle wakeup."""
        if self._loop is None:
            raise RuntimeError("AsyncEngine.submit before start()")
        if self._stop:
            raise RuntimeError("AsyncEngine is closed")
        if self.sched.draining:
            raise RuntimeError("AsyncEngine is draining — admission is closed")
        with self._lock:
            if rid is None:
                rid = self._next_rid
            self._next_rid = max(self._next_rid, rid + 1)
            stream = TokenStream(rid, self._loop)
            self._streams[rid] = stream
            self._pending.append((rid, req))
        self._tap.note_submit(rid, req)
        self._wake.set()
        return stream

    def stream_for(self, rid: int) -> Optional[TokenStream]:
        """Re-attach to a live request's stream (e.g. one recovered from the
        journal, whose original consumer died with the process)."""
        if self._loop is None:
            raise RuntimeError("AsyncEngine.stream_for before start()")
        with self._lock:
            if rid in self._streams:
                return self._streams[rid]
            if rid in self._completed:
                stream = TokenStream(rid, self._loop)
                comp = self._completed[rid]
                stream._feed([int(t) for t in comp.tokens])
                stream._finish(comp)
                self._streams[rid] = stream
                return stream
            # live in the scheduler (recovered, or submitted earlier):
            # tokens already streamed are gone with the old consumer; the
            # tap's emitted counts make the new stream carry the rest.
            # Recovery resets those counts, so a recovered rid's stream
            # re-plays from token 0.
            stream = TokenStream(rid, self._loop)
            self._streams[rid] = stream
            return stream

    @property
    def recovered_rids(self) -> List[int]:
        return list(self._recovered_rids)

    def completion_for(self, rid: int) -> Optional[Completion]:
        return self._completed.get(rid)

    # -- drain / hot swap ----------------------------------------------------

    async def drain(self, timeout_s: Optional[float] = None) -> bool:
        """Stop admission and wait for in-flight work to finish (queued
        requests survive for after :meth:`resume`).  On timeout the stuck
        work is aborted ``CANCELLED`` (bounded re-queue first, as always)
        and False is returned — drain never hangs shutdown."""
        self.sched.drain()
        self._wake.set()
        deadline = (
            None if timeout_s is None else self.sched._clock() + timeout_s
        )
        while True:
            busy = not self._idle.is_set() or any(
                s.active for s in self.sched._slot
            )
            if not busy:
                return True
            if deadline is not None and self.sched._clock() > deadline:
                self.sched.abort(Status.CANCELLED)
                while not self._idle.is_set():
                    await asyncio.sleep(0.005)
                return False
            await asyncio.sleep(0.005)

    def resume(self) -> None:
        """Re-open admission after :meth:`drain`."""
        self.sched.resume_admission()
        self._wake.set()

    async def hot_swap(
        self, params=None, timeout_s: Optional[float] = None
    ) -> bool:
        """Zero-downtime pack swap: drain in-flight work, rebuild the VUSA
        pack (``Engine.reload_packed``, which drops the captured graphs; the
        next run captures them against the new pack), journal the swap
        fingerprint, and resume admission.  Queued requests ride through untouched — nothing
        is dropped.  Returns True if a pack was actually swapped (False on a
        dense engine; admission still cycles cleanly)."""
        await self.drain(timeout_s)
        try:
            swapped = self.sched.eng.reload_packed(params)
            if swapped:
                self.sched.refresh_decode()
                if self.journal is not None:
                    from .packed import pack_fingerprint

                    self.journal.append(
                        {"t": "swap", "fp": pack_fingerprint(self.sched.eng.packed)}
                    )
                    self.journal.sync()
        finally:
            self.resume()
        return swapped

    # -- stats ---------------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        """Lifetime SLO view: TTFT / end-to-end latency / ITL percentiles
        over every completion this engine has seen (scheduler ``stats()``
        covers only the latest run epoch), plus journal and recovery
        counters.  NaN on empty series — an idle server must not read as an
        infinitely fast one."""

        def pct(vals: List[float], q: float) -> float:
            a = np.asarray(vals, np.float64)
            a = a[np.isfinite(a)]
            return float(np.percentile(a, q)) if a.size else float("nan")

        itl = list(self._itl_all)
        if not self._idle.is_set():
            # mid-run: the current epoch's samples are not yet harvested
            itl += self.sched.itl_samples()
        out = {
            "requests_completed": float(len(self._completed)),
            "recovered_requests": float(len(self._recovered_rids)),
            "ttft_p50_s": pct(self._ttft, 50),
            "ttft_p95_s": pct(self._ttft, 95),
            "ttft_p99_s": pct(self._ttft, 99),
            "latency_p50_s": pct(self._latency, 50),
            "latency_p95_s": pct(self._latency, 95),
            "latency_p99_s": pct(self._latency, 99),
            "itl_p50_s": pct(itl, 50),
            "itl_p95_s": pct(itl, 95),
            "itl_p99_s": pct(itl, 99),
            "journal_records": float(
                self.journal.records_written if self.journal else 0
            ),
            "journal_syncs": float(self.journal.syncs if self.journal else 0),
        }
        for k, v in self.sched.stats().items():
            out.setdefault(k, v)
        return out

    # -- worker thread --------------------------------------------------------

    def _drain_pending(self) -> None:
        """Inject buffered submissions into the scheduler (worker thread
        only — the scheduler is single-threaded by design)."""
        with self._lock:
            pending, self._pending = self._pending, []
        for rid, req in pending:
            self.sched.submit(req, rid=rid)

    def _on_sync(self, sched: Scheduler) -> None:
        self._drain_pending()
        self._tap.on_sync(sched)
        self._last_sync = sched._clock()

    def _worker(self) -> None:
        """The worker thread: serve, and if serving raises, fail every open
        stream with the error (its consumer sees it at ``completion``)
        instead of leaving it waiting, then re-raise."""
        try:
            self._serve()
        except BaseException as exc:
            self._idle.set()
            with self._lock:
                open_streams = [s for s in self._streams.values() if not s._done.done()]
            for stream in open_streams:
                self._loop.call_soon_threadsafe(stream._fail, exc)
            raise

    def _serve(self) -> None:
        dev = self.sched.eng.device
        if dev.type == "cuda":
            import torch

            torch.cuda.set_device(dev)
        while not self._stop:
            self._drain_pending()
            if self.sched.has_work and not (
                self.sched.draining
                and not any(s.active for s in self.sched._slot)
            ):
                self._idle.clear()
                self._last_sync = self.sched._clock()
                try:
                    self.sched.run(on_sync=self._on_sync)
                finally:
                    # harvest retirements that landed without a trailing
                    # sync (rejections, abort retirements, deadline sheds)
                    # and this epoch's ITL series before the next epoch
                    # resets it
                    self._drain_pending()
                    self._tap.on_sync(self.sched)
                    self._itl_all.extend(self.sched.itl_samples())
                    self._idle.set()
            else:
                self._idle.set()
                self._wake.wait(timeout=0.02)
                self._wake.clear()

    def _on_tokens(self, rid: int, toks: List[int]) -> None:
        stream = self._streams.get(rid)
        if stream is not None and self._loop is not None:
            self._loop.call_soon_threadsafe(stream._feed, list(toks))

    def _on_retire(self, rid: int, comp: Completion) -> None:
        # lock pairs with stream_for: a re-attach racing this retirement
        # either sees the live stream (finished below) or the completion
        with self._lock:
            self._completed[rid] = comp
            stream = self._streams.get(rid)
        if np.isfinite(comp.ttft_s):
            self._ttft.append(float(comp.ttft_s))
        if np.isfinite(comp.latency_s):
            self._latency.append(float(comp.latency_s))
        if stream is not None and self._loop is not None:
            self._loop.call_soon_threadsafe(stream._finish, comp)

    # -- watchdog -------------------------------------------------------------

    async def _watchdog(self) -> None:
        """Fail-fast stall detection: while the worker is mid-run, a sync
        gap longer than ``watchdog_s`` means the segment (or an injected
        hang) is wedged — abort ``STALLED`` so the run loop's interruptible
        waits bail out instead of hanging every consumer."""
        assert self.watchdog_s is not None
        tick = max(self.watchdog_s / 4, 0.005)
        while not self._stop:
            await asyncio.sleep(tick)
            busy = not self._idle.is_set()
            if busy and self.sched._clock() - self._last_sync > self.watchdog_s:
                self.sched.abort(Status.STALLED)
                self._last_sync = self.sched._clock()  # rearm for the retry
