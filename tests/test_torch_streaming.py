"""Port: the asyncio streaming front end, crash recovery, the watchdog,
drain and the hot swap.

The port's own numpy-seeded init of the ``vusa_edge`` smoke config,
magnitude-pruned to 85 % (``tests/_crash_child.py``'s workload, with the
port's parameters), so that the SIGKILL child below (this file run as a
script) needs nothing but the port.  Tolerance: bitwise within the port.
Every run admits sequentially (a B = 1 prime per request, on the slot
and the paged pool; the pool step's rows B = 1 steps), so a request's
tokens do not depend on when or beside whom it runs: streamed tokens, a
blocking run's, a recovered run's and a watchdog re-queue's are the same
bits, sampled.

    python tests/test_torch_streaming.py JOURNAL SEED N [PACE_S]

serves N requests through a journaled AsyncEngine, paced by the seeded
decode stall so that a parent can kill it mid-stream.
"""

import asyncio
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.ckpt import read_records
from repro_torch.configs import get_smoke_config
from repro_torch.core.pruning import prune_tree
from repro_torch.models import build_model
from repro_torch.serve import (
    AsyncEngine,
    Engine,
    FaultConfig,
    Journal,
    JournalTap,
    Request,
    Scheduler,
    ServeConfig,
    Status,
    replay,
)
from repro_torch.serve.packed import pack_fingerprint

MODES = {
    "dense": dict(temperature=1.0),
    "packed": dict(temperature=1.0, packed_weights="all"),
    "int8": dict(temperature=1.0, packed_weights="all", packed_values="int8"),
    "paged": dict(temperature=1.0, page_size=8),
}
PROMPT_LENS = (6, 13, 9, 17, 5, 24)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run many tiny ops: one intra-op thread runs them faster
    than many, and keeps them from contending for the cores with the test
    workers beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mk_reqs(n, seed=7, max_new=8):
    """Requests as a pure function of (seed, index): parent and child build
    the same ones."""
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(1, 90, size=PROMPT_LENS[i % 6]).astype(np.int32),
                    max_new=max_new, seed=i) for i in range(n)]


def mk_params(sparsity=0.85):
    cfg = get_smoke_config("vusa_edge")
    return cfg, prune_tree(build_model(cfg).init(0, device="cpu"), sparsity)


def mk_engine(mode="dense", faults=None, params=None):
    cfg, p = mk_params() if params is None else (get_smoke_config("vusa_edge"), params)
    return Engine(cfg, p, ServeConfig(max_len=64, faults=faults, **MODES[mode]), device="cpu")


def mk_sched(eng, slots=3, segment=8):
    return Scheduler(eng, slots=slots, segment=segment, admission="sequential")


def _run_ref(eng, reqs, slots=3):
    """A crash-free blocking run: the streams every other path reproduces."""
    sched = mk_sched(eng, slots)
    rids = [sched.submit(dataclasses.replace(r)) for r in reqs]
    done = sched.run()
    assert all(done[r].status is Status.OK for r in rids)
    return {r: [int(t) for t in done[r].tokens] for r in rids}


@pytest.fixture(scope="module")
def engines():
    cache = {}

    def get(mode):
        if mode not in cache:
            cache[mode] = mk_engine(mode)
        return cache[mode]

    return get


@pytest.fixture(scope="module")
def ref_tokens(engines):
    cache = {}

    def get(mode, n=6, seed=7):
        if (mode, n, seed) not in cache:
            cache[mode, n, seed] = _run_ref(engines(mode), mk_reqs(n, seed))
        return cache[mode, n, seed]

    return get


def _go(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _consume(stream):
    toks = [t async for t in stream]
    return toks, await stream.completion()


# ---------------------------------------------------------------------------
# streaming parity, stats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["dense", "packed"])
def test_async_streaming_matches_blocking_run(engines, ref_tokens, mode):
    """Streamed tokens == the Completion's == a blocking run's, per request;
    the lifetime SLO stats are populated and ordered."""
    eng, ref = engines(mode), ref_tokens(mode)

    async def go():
        async with AsyncEngine(mk_sched(eng, segment=4)) as engine:
            streams = [engine.submit(r) for r in mk_reqs(6)]
            outs = [await _consume(s) for s in streams]
            return outs, engine.stats()

    outs, st = _go(go())
    for rid, (toks, comp) in enumerate(outs):
        assert comp.status is Status.OK
        assert toks == [int(t) for t in comp.tokens] == ref[rid]
    assert st["requests_completed"] == 6 and st["journal_records"] == 0
    for k in ("ttft", "latency", "itl"):
        assert 0 <= st[f"{k}_p50_s"] <= st[f"{k}_p99_s"] < float("inf")


def test_stats_nan_safe_on_empty():
    class _NullSched:
        _clock = staticmethod(time.monotonic)

        def stats(self):
            return {"itl_p99_s": 0.0}

        def itl_samples(self):
            return []

    st = AsyncEngine(_NullSched()).stats()
    assert st["requests_completed"] == 0
    for k in ("ttft_p99_s", "latency_p99_s", "itl_p50_s", "itl_p99_s"):
        assert np.isnan(st[k])


# ---------------------------------------------------------------------------
# crash recovery
# ---------------------------------------------------------------------------


class _Boom(RuntimeError):
    """Stands in for the process dying mid-run."""


def _crash_run(eng, reqs, path, crash_at_sync):
    """Journal a run and kill it after ``crash_at_sync`` fsync'd syncs: the
    exception fires before the next sync's tap, so everything after the
    last fsync is lost, as in a real crash."""
    journal = Journal(path)
    tap = JournalTap(journal)
    sched = mk_sched(eng, segment=2)
    for r in reqs:
        tap.note_submit(sched.submit(r), r)
    journal.sync()
    syncs = 0

    def crash(s):
        nonlocal syncs
        syncs += 1
        if syncs > crash_at_sync:
            raise _Boom()
        tap.on_sync(s)

    with pytest.raises(_Boom):
        sched.run(on_sync=crash)
    journal._fh.close()  # no close marker, no sync: the journal reads as a crash


def _recover_all(eng, path, n):
    async def go():
        engine = AsyncEngine.recover(path, mk_sched(eng))
        recovered = engine.recovered_rids
        async with engine:
            outs = {rid: await _consume(engine.stream_for(rid)) for rid in range(n)}
            return recovered, outs, engine.stats()

    return _go(go())


@pytest.mark.parametrize("mode", list(MODES))
def test_crash_recovery_bit_parity(engines, ref_tokens, tmp_path, mode):
    """Kill a journaled run mid-stream, recover into a fresh scheduler:
    every completion, journal-proven and re-executed alike, is bitwise a
    crash-free run's; streams re-attach with ``stream_for`` and replay in
    full; the closed journal then proves the whole history."""
    eng, ref = engines(mode), ref_tokens(mode)
    path = tmp_path / "journal"
    _crash_run(eng, mk_reqs(6), path, crash_at_sync=5)
    mid = replay(path)
    assert mid.pending and mid.completed and not mid.closed
    recovered, outs, st = _recover_all(eng, path, 6)
    assert set(recovered) == set(mid.pending)
    for rid, (toks, comp) in outs.items():
        assert comp.status is Status.OK and toks == ref[rid], f"{mode}: rid {rid}"
    assert st["recovered_requests"] == len(mid.pending)
    final = replay(path)
    assert final.closed and final.clean and not final.pending
    assert {rid: list(t) for rid, (_, t) in final.completed.items()} == ref


def test_recovery_from_submits_only(engines, ref_tokens, tmp_path):
    eng, ref = engines("dense"), ref_tokens("dense")
    path = tmp_path / "journal"
    _crash_run(eng, mk_reqs(6), path, crash_at_sync=0)
    assert sorted(replay(path).pending) == list(range(6))
    recovered, outs, _ = _recover_all(eng, path, 6)
    assert recovered == list(range(6))
    assert {r: toks for r, (toks, _) in outs.items()} == ref


def test_sigkill_crash_recovery(engines, ref_tokens, tmp_path):
    """A real crash: a child server (this file as a script, paced by the
    seeded decode stall) is SIGKILLed once the journal proves tokens
    durable; recovery here reproduces the crash-free streams bitwise."""
    path = tmp_path / "journal"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (os.path.join(root, "src"), os.environ.get("PYTHONPATH")) if p)}
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), str(path), "7", "6"],
                            cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        while True:
            if proc.poll() is not None:
                pytest.fail(f"child exited before the kill (rc={proc.returncode}):\n"
                            f"{proc.communicate()[0]}")
            if path.exists():
                state = replay(path)
                durable = (sum(len(t) for t in state.partial.values())
                           + sum(len(t) for _, t in state.completed.values()))
                if durable >= 4:
                    break
            if time.monotonic() > deadline:
                proc.kill()
                pytest.fail("journal never held tokens:\n" + proc.communicate()[0])
            time.sleep(0.1)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    mid = replay(path)
    assert not mid.closed and mid.pending
    ref = ref_tokens("dense")
    _, outs, _ = _recover_all(engines("dense"), path, 6)
    for rid, (toks, comp) in outs.items():
        assert comp.status is Status.OK and toks == ref[rid], f"rid {rid}"
    final = replay(path)
    assert final.closed and not final.pending
    assert {rid: list(t) for rid, (_, t) in final.completed.items()} == ref


# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------


def _uniform_reqs(seeds, plen=8, max_new=8):
    rng = np.random.default_rng(11)
    prompts = {s: rng.integers(1, 90, size=plen).astype(np.int32) for s in seeds}
    return [Request(prompt=prompts[s], max_new=max_new, seed=s) for s in seeds]


def test_watchdog_transient_hang_requeues_bitwise(engines, monkeypatch):
    """A one-shot decode hang: the watchdog aborts, each in-flight request
    gets its one re-queue, the re-execution streams the same tokens, and
    every request ends OK.  The windows sit well above a sync gap of this
    workload on a loaded CPU."""
    eng = engines("dense")
    reqs = _uniform_reqs([0, 1])
    ref = _run_ref(eng, reqs, slots=2)
    sched = mk_sched(eng, slots=2)
    monkeypatch.setattr(eng.sc, "faults", FaultConfig(decode_hang_rids=(0,)))

    async def go():
        async with AsyncEngine(sched, watchdog_s=2.0) as engine:
            streams = [engine.submit(r) for r in reqs]
            return [await _consume(s) for s in streams], engine.stats()

    t0 = time.monotonic()
    outs, st = _go(go())
    for (toks, comp), want in zip(outs, ref.values()):
        assert comp.status is Status.OK and toks == want
    assert 0 in sched._stall_retried and st["preempted"] >= 0
    assert time.monotonic() - t0 < 30


def test_watchdog_persistent_hang_is_terminal_stalled(engines, monkeypatch):
    """A persistent hang exhausts the bounded re-queue: STALLED within about
    two watchdog windows, with no unproven tokens streamed, and the engine
    serves fresh traffic afterwards."""
    eng = engines("dense")
    (hang_req,), (after_req,) = _uniform_reqs([0]), _uniform_reqs([5])
    (ref_after,) = _run_ref(eng, _uniform_reqs([5]), slots=2).values()
    sched = mk_sched(eng, slots=2)
    monkeypatch.setattr(eng.sc, "faults",
                        FaultConfig(decode_hang_rids=(0,), decode_stall_once=False))

    async def go():
        async with AsyncEngine(sched, watchdog_s=1.5) as engine:
            toks, comp = await _consume(engine.submit(hang_req))
            stalled = engine.stats()["stalled"]
            toks2, comp2 = await _consume(engine.submit(after_req))
        return toks, comp, stalled, toks2, comp2

    t0 = time.monotonic()
    toks, comp, stalled, toks2, comp2 = _go(go())
    assert comp.status is Status.STALLED and toks == [] and stalled >= 1
    assert comp2.status is Status.OK and toks2 == ref_after
    assert time.monotonic() - t0 < 30


# ---------------------------------------------------------------------------
# drain, resume, the hot swap
# ---------------------------------------------------------------------------


def test_drain_and_resume_preserve_the_queue(engines, ref_tokens):
    eng, ref = engines("dense"), ref_tokens("dense")

    async def go():
        sched = mk_sched(eng)
        async with AsyncEngine(sched) as engine:
            streams = [engine.submit(r) for r in mk_reqs(6)]
            first0 = await streams[0].__anext__()
            assert await engine.drain(timeout_s=60) is True
            assert not any(s.active for s in sched._slot)
            with pytest.raises(RuntimeError, match="draining"):
                engine.submit(mk_reqs(7)[6])
            engine.resume()
            outs = [await _consume(s) for s in streams]
            outs[0] = ([first0] + outs[0][0], outs[0][1])
        return outs

    outs = _go(go())
    assert all(comp.status is Status.OK for _, comp in outs)
    assert [toks for toks, _ in outs] == [ref[r] for r in range(6)]


def _swap_records(path):
    payloads, _, _ = read_records(path)
    return [r for r in map(json.loads, payloads) if r.get("t") == "swap"]


def test_hot_swap_drops_nothing(engines, ref_tokens, tmp_path):
    """A swap to a pack of the same params mid-traffic: in-flight requests
    finish, queued ones ride through, every stream is bitwise a swap-free
    run's, and the swap's fingerprint (the same pack's) lands in the
    journal."""
    eng, ref = engines("packed"), ref_tokens("packed")
    path = tmp_path / "journal"
    fp0 = pack_fingerprint(eng.packed)

    async def go():
        async with AsyncEngine(mk_sched(eng), journal=Journal(path)) as engine:
            streams = [engine.submit(r) for r in mk_reqs(6)]
            first0 = await streams[0].__anext__()
            assert await engine.hot_swap(timeout_s=60) is True
            outs = [await _consume(s) for s in streams]
            outs[0] = ([first0] + outs[0][0], outs[0][1])
            late = [engine.submit(r) for r in mk_reqs(8)[6:]]
            return outs + [await _consume(s) for s in late]

    outs = _go(go())
    assert all(comp.status is Status.OK for _, comp in outs)
    for rid, (toks, _) in enumerate(outs[:6]):
        assert toks == ref[rid], f"rid {rid} changed across the hot swap"
    state = replay(path)
    assert state.closed and sorted(state.completed) == list(range(8))
    assert [r["fp"] for r in _swap_records(path)] == [fp0]


def test_hot_swap_serves_the_new_pack(tmp_path):
    """A swap to a pack of other params (90 % pruned): the wave admitted
    before it completes on the old pack, the wave after it on the new one,
    bitwise a fresh engine on each; a swap back journals the first pack's
    fingerprint again."""
    _, p85 = mk_params(0.85)
    _, p90 = mk_params(0.90)
    eng = mk_engine("packed", params=p85)
    fresh = mk_engine("packed", params=p90)
    wave1, wave2 = mk_reqs(3, seed=1), mk_reqs(3, seed=2)
    want1 = _run_ref(mk_engine("packed", params=p85), wave1)
    want2 = _run_ref(fresh, wave2)
    assert _run_ref(mk_engine("packed", params=p85), wave2) != want2  # the packs tell apart
    path = tmp_path / "journal"

    async def go():
        async with AsyncEngine(mk_sched(eng), journal=Journal(path)) as engine:
            first = [engine.submit(r, rid=i) for i, r in enumerate(wave1)]
            outs1 = [await _consume(s) for s in first]
            assert await engine.hot_swap(p90, timeout_s=60) is True
            second = [engine.submit(r, rid=3 + i) for i, r in enumerate(wave2)]
            outs2 = [await _consume(s) for s in second]
            assert await engine.hot_swap(p85, timeout_s=60) is True
            return outs1, outs2

    outs1, outs2 = _go(go())
    assert [t for t, _ in outs1] == list(want1.values())
    assert [t for t, _ in outs2] == list(want2.values())
    fps = [r["fp"] for r in _swap_records(path)]
    assert fps == [pack_fingerprint(fresh.packed), pack_fingerprint(mk_engine(
        "packed", params=p85).packed)] and fps[0] != fps[1]


def test_worker_failure_fails_open_streams(engines):
    """If serving raises on the worker thread, every open stream ends and
    its ``completion`` raises the error: no consumer is left waiting."""
    sched = mk_sched(engines("dense"))

    def boom(on_sync=None):
        raise RuntimeError("device lost")

    sched.run = boom

    async def go():
        engine = AsyncEngine(sched)
        await engine.start()
        stream = engine.submit(mk_reqs(1)[0])
        toks = [t async for t in stream]
        with pytest.raises(RuntimeError, match="device lost"):
            await stream.completion()
        return toks

    assert _go(go(), timeout=30) == []


def test_scheduler_stats_have_p99_and_itl(engines):
    sched = mk_sched(engines("dense"), slots=2, segment=4)
    for r in mk_reqs(3):
        sched.submit(r)
    sched.run()
    st = sched.stats()
    for k in ("latency_p99_s", "ttft_p99_s", "itl_p50_s", "itl_p95_s", "itl_p99_s"):
        assert np.isfinite(st[k])
    # each 8-token stream surfaces at two syncs: one ITL sample each
    assert len(sched.itl_samples()) == 3


# ---------------------------------------------------------------------------
# the SIGKILL child
# ---------------------------------------------------------------------------


async def _child(path, seed, n, pace):
    eng = mk_engine(faults=FaultConfig(decode_stall_s=pace, decode_stall_rate=1.0,
                                       decode_stall_once=False))
    async with AsyncEngine(mk_sched(eng), journal=Journal(path)) as engine:
        for s in [engine.submit(r) for r in mk_reqs(n, seed=seed)]:
            await s.completion()


if __name__ == "__main__":
    pace = float(sys.argv[4]) if len(sys.argv) > 4 else 0.25
    asyncio.run(_child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), pace))
    print("child finished cleanly", flush=True)  # the parent kills it first
