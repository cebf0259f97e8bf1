"""Port: the CRC32-framed record log, the request journal and the pack
fingerprint, against ``repro``'s.

Tolerances: exact throughout.  The frame is ``<u32 length><u32 crc32>
payload`` in both packages, so a log written by either reads under the
other byte for byte; a journal the port's scheduler writes replays under
``repro.serve.journal.replay`` to the state the port's own ``replay``
rebuilds (statuses compared by value: the two packages have their own
``Status`` enums); ``pack_fingerprint`` of the port's pack of the
converted params equals ``repro``'s (every leaf of the two packs is
byte-identical: fp32 or bf16 values, int8 positions, int8 value bytes,
fp32 scales), for float, int8 and int4 values.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest

from repro.checkpoint import ckpt as ref_ckpt
from repro.configs import get_smoke_config as ref_smoke
from repro.core.pruning import prune_tree as ref_prune
from repro.models import build_model as ref_build
from repro.serve import journal as ref_journal
from repro.serve import packed as ref_packed
from repro_torch.checkpoint.ckpt import append_record, read_records
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.serve import Engine, Request, Scheduler, ServeConfig, Status
from repro_torch.serve import packed
from repro_torch.serve.journal import Journal, JournalTap, recover_into, replay


@pytest.fixture(scope="module")
def vusa():
    cfg = ref_smoke("vusa_edge")
    params = ref_prune(ref_build(cfg).init(jax.random.key(0)), 0.85)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return cfg, params, tparams


def _write(path, payloads, append=append_record):
    with open(path, "wb") as fh:
        for p in payloads:
            append(fh, p)
    return path


PAYLOADS = [b"", b"a", b"\x00\xff" * 40, json.dumps({"t": "close"}).encode(), bytes(range(256))]


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "repro"])
def test_record_roundtrip_across_packages(tmp_path, writer):
    """Round trip, and the same bytes as the reference's framing: each
    package reads the other's log."""
    ours, theirs = _write(tmp_path / "a", PAYLOADS), _write(tmp_path / "b", PAYLOADS,
                                                           ref_ckpt.append_record)
    assert ours.read_bytes() == theirs.read_bytes()
    path = ours if writer == "port" else theirs
    out, clean_bytes, clean = read_records(path)
    assert out == PAYLOADS and clean and clean_bytes == path.stat().st_size
    assert ref_ckpt.read_records(path) == (out, clean_bytes, clean)


def test_empty_log_reads_clean(tmp_path):
    path = tmp_path / "log"
    path.write_bytes(b"")
    assert read_records(path) == ([], 0, True)


def test_torn_header(tmp_path):
    path = _write(tmp_path / "log", [b"abc"])
    raw = path.read_bytes()
    path.write_bytes(raw + b"\x05\x00")  # two bytes of a next header
    out, clean_bytes, clean = read_records(path)
    assert out == [b"abc"] and not clean and clean_bytes == len(raw)


@pytest.mark.parametrize("at", [-1, 9, 12])
def test_crc_flip_ends_the_read(tmp_path, at):
    """A flipped byte in a payload (or a header's CRC) ends the read at the
    record before it, never raises, never yields a corrupt payload."""
    path = _write(tmp_path / "log", [b"abc", b"defg"])
    raw = bytearray(path.read_bytes())
    raw[at] ^= 0xFF
    path.write_bytes(bytes(raw))
    out, clean_bytes, clean = read_records(path)
    assert not clean and out == ([b"abc"] if at != 9 else [])
    assert ref_ckpt.read_records(path) == (out, clean_bytes, clean)


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------


def _engine(tparams, **kw):
    return Engine(get_smoke_config("vusa_edge"), tparams,
                  ServeConfig(max_len=64, temperature=1.0, **kw), device="cpu")


def _reqs(n=4):
    rng = np.random.default_rng(11)
    return [Request(prompt=rng.integers(1, 100, 4 + 3 * i).astype(np.int32), max_new=9,
                    seed=i, eos_id=None if i else 5, deadline_s=None if i else 60.0,
                    priority=i % 2) for i in range(n)]


def _same_state(ours, theirs):
    assert {r: (s.value, list(t)) for r, (s, t) in ours.completed.items()} == \
        {r: (s.value, list(t)) for r, (s, t) in theirs.completed.items()}
    assert sorted(ours.pending) == sorted(theirs.pending)
    for rid, req in ours.pending.items():
        other = theirs.pending[rid]
        assert list(req.prompt) == list(other.prompt)
        assert (req.max_new, req.eos_id, req.seed, req.deadline_s, req.priority) == (
            other.max_new, other.eos_id, other.seed, other.deadline_s, other.priority)
    assert ours.partial == theirs.partial
    assert (ours.next_rid, ours.clean_bytes, ours.clean, ours.closed) == (
        theirs.next_rid, theirs.clean_bytes, theirs.clean, theirs.closed)


class _Crash(RuntimeError):
    """Stands in for the process dying mid-run."""


def _journaled_run(tparams, path, crash_at_sync=None):
    """A scheduler run journaled through a tap; with ``crash_at_sync`` the
    run dies before that sync's tap (the journal then holds only the
    fsync'd prefix and no close marker)."""
    journal = Journal(path)
    tap = JournalTap(journal)
    sched = Scheduler(_engine(tparams), slots=2, segment=2, admission="sequential")
    for r in _reqs():
        tap.note_submit(sched.submit(r), r)
    journal.sync()
    syncs = []

    def hook(s):
        syncs.append(1)
        if crash_at_sync is not None and len(syncs) > crash_at_sync:
            raise _Crash()
        tap.on_sync(s)

    if crash_at_sync is None:
        done = sched.run(on_sync=hook)
        tap.on_sync(sched)
        journal.close()
        return done
    with pytest.raises(_Crash):
        sched.run(on_sync=hook)
    journal._fh.close()
    return None


@pytest.mark.parametrize("crash_at_sync", [None, 3])
def test_port_journal_replays_under_reference(vusa, tmp_path, crash_at_sync):
    """A journal the port writes (a clean run, or one that crashed mid-run)
    replays under ``repro.serve.journal.replay`` to the port's own replay
    state; a clean run's replay proves every completion's tokens."""
    _, _, tparams = vusa
    path = tmp_path / "journal"
    done = _journaled_run(tparams, path, crash_at_sync)
    ours, theirs = replay(path), ref_journal.replay(path)
    _same_state(ours, theirs)
    if done is None:
        assert ours.pending and not ours.closed
    else:
        assert ours.closed and ours.clean and not ours.pending
        assert {r: list(t) for r, (_, t) in ours.completed.items()} == \
            {r: [int(x) for x in c.tokens] for r, c in done.items()}


def test_recover_into_requeues_under_original_rids(vusa, tmp_path):
    """Recovery from a crashed journal: proven completions come back as they
    are, the rest re-queue under their rids and re-execute to the tokens of
    a crash-free run; the closed journal then proves the whole history."""
    _, _, tparams = vusa
    want = _journaled_run(tparams, tmp_path / "clean")
    path = tmp_path / "journal"
    _journaled_run(tparams, path, crash_at_sync=3)
    mid = replay(path)
    sched = Scheduler(_engine(tparams), slots=2, segment=2, admission="sequential")
    journal, completed, recovered = recover_into(path, sched)
    assert recovered == sorted(mid.pending) and set(completed) == set(mid.completed)
    tap = JournalTap(journal)
    done = sched.run(on_sync=tap.on_sync)
    tap.on_sync(sched)
    journal.close()
    for rid in recovered:
        np.testing.assert_array_equal(done[rid].tokens, want[rid].tokens)
    for rid, c in completed.items():
        np.testing.assert_array_equal(c.tokens, want[rid].tokens)
    final = replay(path)
    assert final.closed and not final.pending
    assert {r: list(t) for r, (_, t) in final.completed.items()} == \
        {r: [int(x) for x in c.tokens] for r, c in want.items()}
    _same_state(final, ref_journal.replay(path))


def _mk_journal(path, events):
    j = Journal(path)
    for ev in events:
        kind = ev[0]
        if kind == "submit":
            j.append(Journal.submit_record(ev[1], Request(prompt=np.asarray([1, 2], np.int32))))
        elif kind == "tokens":
            j.append(Journal.tokens_record(ev[1], ev[2]))
        elif kind == "retire":
            j.append(Journal.retire_record(ev[1], Status.OK, ev[2]))
        else:
            j.append({"t": kind})
    j.sync()
    j._fh.close()


def test_recover_marker_resets_partials(tmp_path):
    path = tmp_path / "journal"
    _mk_journal(path, [("submit", 0), ("submit", 1), ("tokens", 0, [1, 2, 3]),
                       ("tokens", 1, [7]), ("retire", 1, 1), ("recover",),
                       ("tokens", 0, [1, 2, 3, 4]), ("retire", 0, 4)])
    state = replay(path)
    assert [list(state.completed[r][1]) for r in (0, 1)] == [[1, 2, 3, 4], [7]]
    assert not state.closed
    _same_state(state, ref_journal.replay(path))


def test_tokens_for_unknown_rid_ignored(tmp_path):
    path = tmp_path / "journal"
    _mk_journal(path, [("submit", 0), ("tokens", 7, [1, 2]), ("retire", 7, 2),
                       ("tokens", 0, [5])])
    state = replay(path)
    assert sorted(state.pending) == [0] and state.partial[0] == [5] and not state.completed
    _same_state(state, ref_journal.replay(path))


def test_submit_record_roundtrips_request_fields(tmp_path):
    req = Request(prompt=np.asarray([4, 5, 6], np.int32), max_new=3, eos_id=2, seed=9,
                  deadline_s=1.5, priority=2)
    rec = Journal.submit_record(11, req)
    assert rec == ref_journal.Journal.submit_record(11, dataclasses.replace(req))
    path = tmp_path / "journal"
    j = Journal(path)
    j.append(rec)
    j.close()
    got = replay(path).pending[11]
    assert list(got.prompt) == [4, 5, 6]
    assert (got.max_new, got.eos_id, got.seed, got.deadline_s, got.priority) == (3, 2, 9, 1.5, 2)
    assert got.arrival_s == 0.0


# ---------------------------------------------------------------------------
# the pack fingerprint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("value_dtype", ["dense", "int8", "int4"])
def test_pack_fingerprint_equals_reference(vusa, value_dtype):
    cfg, params, tparams = vusa
    rp = ref_packed.pack_lm_weights(cfg, params, 128, 16, scope="all", value_dtype=value_dtype)
    tp = packed.pack_lm_weights(get_smoke_config("vusa_edge"), tparams, 128, 16, scope="all",
                                value_dtype=value_dtype)
    assert packed.pack_fingerprint(tp) == ref_packed.pack_fingerprint(rp)
    # and it sees a change: another sparsity, another pack
    other = packed.pack_lm_weights(
        get_smoke_config("vusa_edge"),
        params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_prune(params, 0.9)), "cpu"),
        128, 16, scope="all", value_dtype=value_dtype)
    assert packed.pack_fingerprint(other) != packed.pack_fingerprint(tp)
