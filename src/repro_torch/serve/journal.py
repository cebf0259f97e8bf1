"""Crash-safe write-ahead request journal for the serving stack.

Port of the JAX package's ``serve/journal.py``, with the same record schema
and the same CRC32 framing (``checkpoint/ckpt.py``), so a journal written by
either package replays under the other.

Every externally visible serving event is appended to an append-only log of
CRC32-framed JSON records (framing from ``checkpoint.ckpt``):

  submit   the request itself — prompt, budget, seed, deadline, priority
  admit    rid entered a slot (observability; recovery does not need it)
  tokens   a batch of tokens emitted for rid at a segment sync
  retire   rid reached a terminal status with its final token count
  recover  a recovery epoch began: partial token state of every non-retired
           rid is reset, because those requests re-execute from scratch
  swap     the engine hot-swapped its packed weights (fingerprint logged)
  close    clean shutdown marker (a journal without one crashed)

Durability contract: records are buffered in-process and flushed+fsync'd
ONLY at segment syncs (``Journal.sync``), piggybacking on the scheduler's
existing one-sync-per-segment cadence — journaling adds zero extra host
transfers and zero extra syncs.  Consequently a crash loses at most the
events since the last segment sync: tokens past the last fsync are
*re-decoded* on recovery (same request seed => bit-identical stream), never
lost; submissions past the last fsync are gone and must be re-submitted by
the client (the submit ack races the crash — classic WAL semantics).

Replay (:func:`replay`) is a pure function of the file: the same journal
always rebuilds the same state, and a torn or CRC-corrupt tail ends replay
cleanly at the last good record.  :func:`recover_into` re-queues every
non-retired request into a fresh Scheduler under its ORIGINAL rid and seed,
so the re-executed token streams are bit-identical to a crash-free run;
``tests/test_torch_streaming.py`` asserts exactly that across dense,
packed, quantized and paged modes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..checkpoint.ckpt import append_record, read_records
from .scheduler import Completion, Request, Scheduler, Status

__all__ = ["Journal", "JournalState", "JournalTap", "replay", "recover_into"]


class Journal:
    """Append-only journal writer.  Thread-safe (the async engine appends
    submit records from the event-loop thread while the scheduler worker
    appends token batches); every mutation happens under one lock."""

    def __init__(self, path: str | Path, truncate_at: Optional[int] = None):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        if truncate_at is not None and self.path.exists():
            # recovery reopens after a crash: drop the torn tail so new
            # records append to the clean prefix (replay stops at the first
            # bad frame — bytes after it would be unreachable forever)
            with open(self.path, "r+b") as fh:
                fh.truncate(truncate_at)
        self._fh = open(self.path, "ab")
        self.records_written = 0
        self.syncs = 0

    def append(self, rec: dict) -> None:
        """Buffer one record (durable only after the next :meth:`sync`)."""
        payload = json.dumps(rec, separators=(",", ":")).encode()
        with self._lock:
            append_record(self._fh, payload)
            self.records_written += 1

    def sync(self) -> None:
        """Flush + fsync — the durability point, called at segment syncs."""
        with self._lock:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self.syncs += 1

    def close(self, clean: bool = True) -> None:
        with self._lock:
            if self._fh.closed:
                return
        if clean:
            self.append({"t": "close"})
        self.sync()
        with self._lock:
            self._fh.close()

    # -- record constructors ------------------------------------------------

    @staticmethod
    def submit_record(rid: int, req: Request) -> dict:
        return {
            "t": "submit",
            "rid": rid,
            "prompt": np.asarray(req.prompt).reshape(-1).tolist(),
            "max_new": int(req.max_new),
            "eos_id": None if req.eos_id is None else int(req.eos_id),
            "seed": int(req.seed),
            "arrival_s": float(req.arrival_s),
            "deadline_s": None if req.deadline_s is None else float(req.deadline_s),
            "priority": int(req.priority),
        }

    @staticmethod
    def admit_record(rid: int) -> dict:
        return {"t": "admit", "rid": rid}

    @staticmethod
    def tokens_record(rid: int, toks) -> dict:
        return {"t": "tokens", "rid": rid, "toks": [int(t) for t in toks]}

    @staticmethod
    def retire_record(rid: int, status: Status, n_tokens: int) -> dict:
        return {"t": "retire", "rid": rid, "status": status.value, "n": int(n_tokens)}


@dataclasses.dataclass
class JournalState:
    """Result of :func:`replay`: what the journal proves happened."""

    completed: Dict[int, Tuple[Status, np.ndarray]]  # rid -> (status, tokens)
    pending: Dict[int, Request]  # submitted, never retired — re-execute
    partial: Dict[int, List[int]]  # journaled-but-unretired token prefixes
    next_rid: int
    clean_bytes: int  # truncate the file here before appending again
    clean: bool  # False = torn/corrupt tail (the expected crash artifact)
    closed: bool  # True = a clean-shutdown close record was replayed


def _req_from_record(rec: dict) -> Request:
    return Request(
        prompt=np.asarray(rec["prompt"], np.int32),
        max_new=rec["max_new"],
        eos_id=rec["eos_id"],
        seed=rec["seed"],
        # the original arrival offset was relative to a run() epoch that died
        # with the process; on recovery the request is simply due now
        arrival_s=0.0,
        deadline_s=rec["deadline_s"],
        priority=rec["priority"],
    )


def replay(path: str | Path) -> JournalState:
    """Rebuild serving state from a journal.  Pure and idempotent: replaying
    the same file twice yields the same state; a truncated or CRC-corrupt
    tail ends replay at the last good record (``clean=False``) instead of
    raising.  Records for unknown rids (their submit record died after the
    last fsync) are ignored — a journal can never prove more than it holds."""
    records, clean_bytes, clean = read_records(path)
    pending: Dict[int, Request] = {}
    partial: Dict[int, List[int]] = {}
    completed: Dict[int, Tuple[Status, np.ndarray]] = {}
    next_rid = 0
    closed = False
    for payload in records:
        rec = json.loads(payload)
        t = rec.get("t")
        if t == "submit":
            rid = rec["rid"]
            pending[rid] = _req_from_record(rec)
            partial[rid] = []
            next_rid = max(next_rid, rid + 1)
        elif t == "tokens":
            if rec["rid"] in pending:
                partial[rec["rid"]].extend(rec["toks"])
        elif t == "retire":
            rid = rec["rid"]
            if rid in pending:
                toks = np.asarray(partial.pop(rid, []), np.int32)
                completed[rid] = (Status(rec["status"]), toks[: rec["n"]])
                del pending[rid]
        elif t == "recover":
            # a recovery epoch re-executes every non-retired request from
            # scratch: their re-journaled streams restart at token 0, so the
            # pre-crash partials must not be prepended to them
            for rid in pending:
                partial[rid] = []
        elif t == "close":
            closed = True
        # admit / swap records carry no recovery state
    return JournalState(
        completed=completed,
        pending=pending,
        partial=partial,
        next_rid=next_rid,
        clean_bytes=clean_bytes,
        clean=clean,
        closed=closed,
    )


def recover_into(
    path: str | Path, sched: Scheduler
) -> Tuple[Journal, Dict[int, Completion], List[int]]:
    """Crash recovery: replay ``path``, re-queue every non-retired request
    into ``sched`` under its ORIGINAL rid (and therefore its original seed —
    the re-executed stream is bit-identical to what a crash-free run would
    have produced), and reopen the journal for appending with the torn tail
    truncated and a ``recover`` marker fsync'd.

    Returns ``(journal, completed, recovered_rids)``: completions the
    journal already proves (their token streams need no recompute), and the
    rids now back in the queue."""
    state = replay(path)
    journal = Journal(path, truncate_at=state.clean_bytes)
    journal.append({"t": "recover"})
    journal.sync()
    completed = {
        rid: Completion(
            rid=rid,
            tokens=toks,
            arrival_s=float("nan"),
            admit_s=float("nan"),
            finish_s=float("nan"),
            status=status,
        )
        for rid, (status, toks) in state.completed.items()
    }
    recovered = sorted(state.pending)
    for rid in recovered:
        sched.submit(state.pending[rid], rid=rid)
    return journal, completed, recovered


class JournalTap:
    """Bridges scheduler events to a :class:`Journal`.

    One instance rides a Scheduler run via the existing ``on_sync`` hook:
    at every segment sync it diffs per-rid emitted-token counts against what
    it already journaled, appends the deltas (admits, token batches,
    retirements) and fsyncs ONCE — the journal's only durability point, on
    the sync the scheduler was paying for anyway.  The same diffing makes
    re-execution after recovery or a watchdog re-queue transparent: a rid
    whose tokens restart from scratch only journals (and only streams) the
    tokens beyond what was already delivered, and the already-delivered
    prefix is bit-identical by the scheduler's same-seed replay contract.

    After recovery the tap starts with empty counts on purpose: the
    ``recover`` marker told replay to reset every non-retired rid's partial
    tokens, so re-executed streams re-journal (and re-stream) from token 0
    — the journal stays self-contained and a consumer re-attaching after
    the crash sees the whole stream.  ``emitted`` seeds the counts for
    callers that want pure-tail semantics instead; ``on_new_tokens`` /
    ``on_retire`` are the streaming callbacks the async engine hangs its
    per-request token queues on.
    """

    def __init__(
        self,
        journal: Optional[Journal],
        emitted: Optional[Dict[int, int]] = None,
        on_new_tokens=None,
        on_retire=None,
    ):
        self.journal = journal
        self._emitted: Dict[int, int] = dict(emitted or {})
        self._admitted: set = set()
        self._retired: set = set()
        self.on_new_tokens = on_new_tokens
        self.on_retire = on_retire

    def note_submit(self, rid: int, req: Request) -> None:
        if self.journal is not None:
            self.journal.append(Journal.submit_record(rid, req))

    def emitted(self, rid: int) -> int:
        return self._emitted.get(rid, 0)

    def _push(self, rid: int, toks: List[int]) -> None:
        n0 = self._emitted.get(rid, 0)
        new = toks[n0:]
        if not new:
            return
        if self.journal is not None:
            self.journal.append(Journal.tokens_record(rid, new))
        self._emitted[rid] = len(toks)
        if self.on_new_tokens is not None:
            self.on_new_tokens(rid, new)

    def on_sync(self, sched: Scheduler) -> None:
        """The scheduler's ``on_sync`` hook: journal this sync's deltas and
        fsync once.  Also usable as a manual harvest after ``run`` returns
        (completions recorded without a sync — rejections, deadline sheds,
        abort retirements — land here)."""
        inflight = sched.inflight_tokens()
        for rid in inflight:
            if rid not in self._admitted:
                self._admitted.add(rid)
                if self.journal is not None:
                    self.journal.append(Journal.admit_record(rid))
        for rid, toks in inflight.items():
            self._push(rid, toks)
        for rid, comp in sched.completions_so_far().items():
            if rid in self._retired:
                continue
            self._retired.add(rid)
            self._push(rid, [int(t) for t in comp.tokens])
            if self.journal is not None:
                self.journal.append(
                    Journal.retire_record(rid, comp.status, len(comp.tokens))
                )
            if self.on_retire is not None:
                self.on_retire(rid, comp)
        if self.journal is not None:
            self.journal.sync()
