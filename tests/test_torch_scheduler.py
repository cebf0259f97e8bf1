"""Port: the continuous-batching scheduler (slot pool).

Parameters come from ``repro`` (the ``vusa_edge`` smoke config, init at
``key(0)``, magnitude-pruned to 85 %) and cross to the port as numpy.

Tolerances:
- under sequential admission every completion equals the port's one-shot
  ``generate`` of its prompt at B = 1 with its seed, bitwise, greedy and
  sampled, dense and packed with fp32, int8 and int4 values: the pool step
  computes norms, attends and dense products one row at a time and the
  packed kernels' plain versions multiply one row at a time, so each row is
  a B = 1 step;
- batched admission primes a prompt at another row count (ROADMAP C9): its
  greedy tokens equal sequential admission's on this 2-layer config;
- across frameworks, greedy only: the port's completions equal
  ``repro``'s ``Scheduler``'s for the same requests (sampled tokens cannot
  cross frameworks: different generators).
Deadlines, cancellation and the shed policies run on an injected clock, as
the reference's tests do.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.core.pruning import prune_tree as ref_prune
from repro.models import build_model as ref_build
from repro.serve import Engine as RefEngine
from repro.serve import Request as RefRequest
from repro.serve import Scheduler as RefScheduler
from repro.serve import ServeConfig as RefServeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import Engine, Request, Scheduler, ServeConfig, Status

ROUTES = {
    "dense": {},
    "fp32": {"packed_weights": "all"},
    "int8": {"packed_weights": "all", "packed_values": "int8"},
    "int4": {"packed_weights": "all", "packed_values": "int4"},
}


@pytest.fixture(scope="module")
def vusa():
    cfg = ref_smoke("vusa_edge")
    params = ref_prune(ref_build(cfg).init(jax.random.key(0)), 0.85)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return cfg, params, tparams


def _engine(tparams, clock=None, **kw):
    return Engine(get_smoke_config("vusa_edge"), tparams, ServeConfig(**kw), device="cpu",
                  clock=clock)


def _one_shot(eng, prompt, max_new, seed):
    """The port's one-shot generate of one prompt at B = 1 with ``seed``."""
    eng.sc.seed = seed
    return eng.generate(np.asarray(prompt)[None], max_new=max_new)["tokens"][0]


def _check_parity(oracle, done, reqs):
    assert sorted(done) == list(range(len(reqs)))
    for rid, c in sorted(done.items()):
        r = reqs[rid]
        one = _one_shot(oracle, r.prompt, r.max_new, r.seed)
        if r.eos_id is not None and (one == r.eos_id).any():
            one = one[: int(np.argmax(one == r.eos_id)) + 1]
        np.testing.assert_array_equal(c.tokens, one, err_msg=f"rid {rid}")


def _reqs(rng, spec, **kw):
    return [Request(prompt=rng.integers(1, 500, n).astype(np.int32), max_new=m, seed=i, **kw)
            for i, (n, m) in enumerate(spec)]


class TickClock:
    """A clock that moves 1 ms at every read, so a zero deadline has passed
    by the first admission."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1e-3
        return self.t


class FakeClock:
    """Injectable monotonic clock: deadlines fire exactly when a test says."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s


# ---------------------------------------------------------------------------
# parity with one-shot generate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temperature", [0.0, 1.0])
@pytest.mark.parametrize("route", list(ROUTES))
def test_sequential_admission_bitwise_one_shot(vusa, route, temperature):
    """Ragged prompts, staggered arrivals: every completion is bitwise the
    one-shot B = 1 generate of its prompt with its seed."""
    _, _, tparams = vusa
    kw = dict(max_len=64, temperature=temperature, **ROUTES[route])
    rng = np.random.default_rng(0)
    reqs = _reqs(rng, [(4, 12), (9, 6), (6, 10), (4, 8), (13, 9)])
    clk = FakeClock()
    reqs = [dataclasses.replace(r, arrival_s=0.01 * i) for i, r in enumerate(reqs)]
    sched = Scheduler(_engine(tparams, clock=clk, **kw), slots=3, segment=4,
                      admission="sequential", sleep=clk.sleep)
    done = sched.run(reqs)
    _check_parity(_engine(tparams, **kw), done, reqs)
    assert all(c.status is Status.OK for c in done.values())


@pytest.mark.parametrize("route", ["dense", "fp32"])
def test_batched_admission_greedy_equals_sequential(vusa, route):
    """Bucketed admission primes prompts at another row count (not bitwise,
    ROADMAP C9); on the smoke config its greedy tokens still equal
    sequential admission's and one-shot generate's."""
    _, _, tparams = vusa
    kw = dict(max_len=64, **ROUTES[route])
    rng = np.random.default_rng(1)
    reqs = _reqs(rng, [(3, 8), (9, 8), (5, 8), (12, 8), (4, 8), (7, 8)])
    seq = Scheduler(_engine(tparams, **kw), slots=3, segment=4, admission="sequential").run(
        [dataclasses.replace(r) for r in reqs])
    bat = Scheduler(_engine(tparams, **kw), slots=3, segment=4, admission="batched").run(
        [dataclasses.replace(r) for r in reqs])
    for rid in seq:
        np.testing.assert_array_equal(bat[rid].tokens, seq[rid].tokens, err_msg=f"rid {rid}")
    _check_parity(_engine(tparams, **kw), bat, reqs)


@pytest.mark.parametrize("packed", [False, "all"])
def test_greedy_completions_match_reference_scheduler(vusa, packed):
    """Across frameworks, greedy: the port's batched slot-pool completions
    equal ``repro``'s ``Scheduler``'s for the same requests."""
    cfg, params, tparams = vusa
    rng = np.random.default_rng(2)
    spec = [(6, 10), (13, 8), (9, 12), (17, 6), (5, 9)]
    prompts = [rng.integers(1, 500, n).astype(np.int32) for n, _ in spec]
    ref = RefScheduler(RefEngine(cfg, params, RefServeConfig(max_len=64, packed_weights=packed)),
                       slots=3, segment=4)
    want = ref.run([RefRequest(prompt=p, max_new=m, seed=i)
                    for i, (p, (_, m)) in enumerate(zip(prompts, spec))])
    got = Scheduler(_engine(tparams, max_len=64, packed_weights=packed), slots=3,
                    segment=4).run([Request(prompt=p, max_new=m, seed=i)
                                    for i, (p, (_, m)) in enumerate(zip(prompts, spec))])
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, np.asarray(want[rid].tokens),
                                      err_msg=f"rid {rid}")


# ---------------------------------------------------------------------------
# slot lifecycle
# ---------------------------------------------------------------------------


def test_eos_retires_and_frees_slot(vusa):
    """EOS mid-stream retires the request, truncates its tokens just after
    the EOS and frees the slot for the queued request, whose bitwise output
    shows the slot was fully replaced."""
    _, _, tparams = vusa
    oracle = _engine(tparams, max_len=64)
    rng = np.random.default_rng(4)
    p0, p1 = (rng.integers(1, 500, 6).astype(np.int32) for _ in range(2))
    one0 = _one_shot(oracle, p0, 12, seed=3)
    eos = int(one0[3])
    sched = Scheduler(_engine(tparams, max_len=64), slots=1, segment=4)
    done = sched.run([Request(prompt=p0, max_new=12, eos_id=eos, seed=3),
                      Request(prompt=p1, max_new=8, seed=7)])
    n = int(np.argmax(one0 == eos)) + 1
    np.testing.assert_array_equal(done[0].tokens, one0[:n])
    assert done[0].tokens[-1] == eos
    np.testing.assert_array_equal(done[1].tokens, _one_shot(oracle, p1, 8, seed=7))
    assert done[1].admit_s >= done[0].finish_s


def test_queued_request_admitted_mid_stream(vusa):
    """A queued request enters the short request's slot while the long one
    still decodes, not after the whole pool drains."""
    _, _, tparams = vusa
    rng = np.random.default_rng(5)
    reqs = _reqs(rng, [(6, 40), (6, 6), (6, 6)])
    sched = Scheduler(_engine(tparams, max_len=96), slots=2, segment=4)
    done = sched.run(reqs)
    _check_parity(_engine(tparams, max_len=96), done, reqs)
    assert done[1].finish_s <= done[2].admit_s <= done[0].finish_s
    assert sched.stats()["slot_occupancy"] > 0.5


def test_instant_completion_at_admission(vusa):
    """max_new = 1 completes with just its deferred first token at the first
    segment sync."""
    _, _, tparams = vusa
    p = np.random.default_rng(6).integers(1, 500, 6).astype(np.int32)
    done = Scheduler(_engine(tparams, max_len=64), slots=1, segment=4).run(
        [Request(prompt=p, max_new=1, seed=0)])
    np.testing.assert_array_equal(done[0].tokens, _one_shot(_engine(tparams, max_len=64), p, 1, 0))


def test_submit_validates_budget_and_engine(vusa):
    _, _, tparams = vusa
    sched = Scheduler(_engine(tparams, max_len=32), slots=1, segment=8)
    with pytest.raises(ValueError, match="max_len"):
        sched.submit(Request(prompt=np.ones(8, np.int32), max_new=30))
    with pytest.raises(ValueError, match="max_new"):
        sched.submit(Request(prompt=np.ones(8, np.int32), max_new=0))
    with pytest.raises(ValueError, match="fused"):
        Scheduler(_engine(tparams, max_len=32, fused=False))
    # a speculative engine is served (its rounds write up to draft_k + 1
    # rows a step, so a segment spans segment x (draft_k + 1) rows)
    spec = Scheduler(_engine(tparams, max_len=64, packed_weights="all", speculative=True),
                     segment=4)
    assert spec.speculative and spec._span == 4 * 5
    with pytest.raises(ValueError, match="segment span"):
        spec.submit(Request(prompt=np.ones(30, np.int32), max_new=20))
    with pytest.raises(ValueError, match="admission"):
        Scheduler(_engine(tparams, max_len=32), admission="eager")


def test_integrity_guard_fails_the_slot(vusa):
    """A slot whose logits go non-finite is cut at the first bad step and
    retried once from its prompt: it completes FAILED_FALLBACK_OK with the
    tokens of a clean run; a second trip completes FAILED with the retry's
    tokens cut there.  Its neighbour's tokens stay bitwise.  The cache is
    poisoned after the first sync (which delivered the first token and one
    segment's 4) and, in the second run, after the retry's first sync too."""
    _, _, tparams = vusa
    rng = np.random.default_rng(7)
    reqs = _reqs(rng, [(6, 20), (6, 20)])
    oracle = _engine(tparams, max_len=64)
    want = [_one_shot(oracle, r.prompt, 20, i) for i, r in enumerate(reqs)]
    for trips, status in ((1, Status.FAILED_FALLBACK_OK), (2, Status.FAILED)):
        sched = Scheduler(_engine(tparams, max_len=64), slots=2, segment=4,
                          admission="sequential")
        fired = []

        def poison(s):
            slot = s._slot[1]
            if len(fired) < trips and slot.rid == 1 and len(slot.tokens) == 5:
                fired.append(True)
                s._pool.cache["k"][:, 1].fill_(float("nan"))

        done = sched.run([dataclasses.replace(r) for r in reqs], on_sync=poison)
        assert done[1].status is status
        st = sched.stats()
        assert (st["fallback"], st["failed"], st["quarantined"]) == (1, trips - 1, 0)
        np.testing.assert_array_equal(done[1].tokens, want[1] if trips == 1 else want[1][:5])
        np.testing.assert_array_equal(done[0].tokens, want[0])


# ---------------------------------------------------------------------------
# deadlines, cancellation, backpressure, priorities
# ---------------------------------------------------------------------------


def test_deadline_sheds_before_admission(vusa):
    _, _, tparams = vusa
    sched = Scheduler(_engine(tparams, max_len=64), slots=2, segment=4, clock=TickClock())
    rng = np.random.default_rng(8)
    reqs = _reqs(rng, [(6, 8), (6, 8)])
    reqs[1] = dataclasses.replace(reqs[1], deadline_s=0.0)
    done = sched.run(reqs)
    assert done[1].status is Status.TIMEOUT and len(done[1].tokens) == 0
    assert np.isnan(done[1].admit_s)
    np.testing.assert_array_equal(
        done[0].tokens, _one_shot(_engine(tparams, max_len=64), reqs[0].prompt, 8, 0))
    st = sched.stats()
    assert st["timed_out"] == 1 and st["requests"] == 2


def test_deadline_in_flight_timeout(vusa):
    _, _, tparams = vusa
    clk = FakeClock()
    sched = Scheduler(_engine(tparams, max_len=96), slots=2, segment=4, clock=clk,
                      sleep=clk.sleep)
    rng = np.random.default_rng(9)
    reqs = _reqs(rng, [(6, 24), (6, 24)])
    reqs[1] = dataclasses.replace(reqs[1], deadline_s=5.0)

    def advance(s):  # the second sync sees t > 5
        clk.t += 10.0

    done = sched.run(reqs, on_sync=advance)
    oracle = _engine(tparams, max_len=96)
    assert done[1].status is Status.TIMEOUT and 0 < len(done[1].tokens) < 24
    np.testing.assert_array_equal(
        done[1].tokens, _one_shot(oracle, reqs[1].prompt, 24, 1)[: len(done[1].tokens)])
    assert done[0].status is Status.OK
    np.testing.assert_array_equal(done[0].tokens, _one_shot(oracle, reqs[0].prompt, 24, 0))
    assert sched.stats()["timed_out"] == 1


def test_cancel_queued_and_in_flight(vusa):
    _, _, tparams = vusa
    rng = np.random.default_rng(10)
    reqs = _reqs(rng, [(6, 24), (6, 24), (6, 8)])
    sched = Scheduler(_engine(tparams, max_len=96), slots=2, segment=4)
    for r in reqs:
        sched.submit(r)
    assert sched.cancel(2) is True  # queued: at once
    assert sched.cancel(99) is False  # unknown rid never raises
    fired = []

    def hook(s):
        if not fired:
            fired.append(True)
            assert s.cancel(1) is True  # in flight: at the next sync

    done = sched.run(on_sync=hook)
    oracle = _engine(tparams, max_len=96)
    assert done[2].status is Status.CANCELLED and len(done[2].tokens) == 0
    assert done[1].status is Status.CANCELLED and 0 < len(done[1].tokens) < 24
    np.testing.assert_array_equal(
        done[1].tokens, _one_shot(oracle, reqs[1].prompt, 24, 1)[: len(done[1].tokens)])
    np.testing.assert_array_equal(done[0].tokens, _one_shot(oracle, reqs[0].prompt, 24, 0))
    assert sched.stats()["cancelled"] == 2


@pytest.mark.parametrize("policy,victim,ok", [
    ("reject", 2, (0, 1)),
    ("shed-oldest", 0, (1, 2)),
])
def test_backpressure(vusa, policy, victim, ok):
    _, _, tparams = vusa
    sched = Scheduler(_engine(tparams, max_len=64), slots=1, segment=4, queue_cap=2,
                      shed_policy=policy)
    rng = np.random.default_rng(11)
    reqs = _reqs(rng, [(6, 6)] * 3)
    rids = [sched.submit(r) for r in reqs]
    done = sched.run()
    assert done[rids[victim]].status is Status.REJECTED
    assert len(done[rids[victim]].tokens) == 0
    oracle = _engine(tparams, max_len=64)
    for rid in ok:
        assert done[rid].status is Status.OK
        np.testing.assert_array_equal(done[rid].tokens,
                                      _one_shot(oracle, reqs[rid].prompt, 6, rid))
    st = sched.stats()
    assert (st["rejected"], st["shed"]) == ((1, 0) if policy == "reject" else (0, 1))


def test_backpressure_shed_lowest_priority(vusa):
    _, _, tparams = vusa
    sched = Scheduler(_engine(tparams, max_len=64), slots=1, segment=4, queue_cap=2,
                      shed_policy="shed-lowest-priority")
    rng = np.random.default_rng(12)
    base = _reqs(rng, [(6, 6)] * 4)
    prio = (5, 1, 3, 0)  # 3 outranks 1 and evicts it; 0 outranks nobody
    rids = [sched.submit(dataclasses.replace(r, priority=p)) for r, p in zip(base, prio)]
    done = sched.run()
    assert done[rids[1]].status is Status.REJECTED  # shed victim
    assert done[rids[3]].status is Status.REJECTED  # rejected newcomer
    assert done[rids[0]].status is Status.OK and done[rids[2]].status is Status.OK
    st = sched.stats()
    assert st["shed"] == 1 and st["rejected"] == 1


def test_priority_and_no_head_of_line_blocking(vusa):
    """The higher-priority request is admitted first; a queue head arriving
    in the future does not idle a free slot."""
    _, _, tparams = vusa
    rng = np.random.default_rng(13)
    reqs = _reqs(rng, [(6, 6), (6, 6)])
    reqs[1] = dataclasses.replace(reqs[1], priority=9)
    done = Scheduler(_engine(tparams, max_len=64), slots=1, segment=4).run(reqs)
    assert done[1].finish_s <= done[0].admit_s
    clk = FakeClock()
    late = dataclasses.replace(reqs[0], arrival_s=0.35)
    early = dataclasses.replace(reqs[1], arrival_s=0.0, priority=0)
    done = Scheduler(_engine(tparams, max_len=64), slots=1, segment=4, clock=clk,
                     sleep=clk.sleep).run([late, early])
    assert done[1].admit_s < 0.35 and done[1].finish_s <= done[0].admit_s
    assert done[0].admit_s >= 0.35


# ---------------------------------------------------------------------------
# stats and epochs
# ---------------------------------------------------------------------------


def test_stats_counters_ttft_and_itl(vusa):
    _, _, tparams = vusa
    sched = Scheduler(_engine(tparams, max_len=64), slots=2, segment=4)
    st = sched.stats()  # empty epoch: NaN percentiles, zero counters
    for k in ("latency_p50_s", "latency_p99_s", "ttft_p50_s", "ttft_p99_s", "itl_p50_s",
              "hbm_bytes_per_active_request", "prefix_hit_rate", "blocks_total"):
        assert math.isnan(st[k]), k
    for k in ("rejected", "shed", "timed_out", "cancelled", "fallback", "failed",
              "quarantined", "preempted", "stalled"):
        assert st[k] == 0, k
    assert st["requests"] == 0 and st["sustained_tok_per_s"] == 0.0
    rng = np.random.default_rng(14)
    done = sched.run(_reqs(rng, [(6, 10)] * 3))
    st = sched.stats()
    assert st["requests"] == 3 and st["decoded_tokens"] == 27
    assert np.isfinite(st["ttft_p50_s"]) and st["ttft_p99_s"] >= st["ttft_p50_s"] - 1e-12
    assert all(np.isfinite(c.ttft_s) and c.ttft_s <= c.latency_s for c in done.values())
    assert len(sched.itl_samples()) > 0 and st["itl_p50_s"] >= 0
    assert st["kv_pool_bytes"] > 0 and st["hbm_bytes_per_active_request"] > 0


def test_epoch_reset_on_next_submit(vusa):
    """A second run starts a fresh epoch, but a submit-time rejection before
    it survives into its results."""
    _, _, tparams = vusa
    sched = Scheduler(_engine(tparams, max_len=64), slots=1, segment=4, queue_cap=1)
    rng = np.random.default_rng(15)
    r0, r1, r2 = _reqs(rng, [(6, 6)] * 3)
    assert set(sched.run([r0])) == {0}
    rid1, rid2 = sched.submit(r1), sched.submit(r2)  # cap 1: rid2 rejected
    done = sched.run()
    assert set(done) == {rid1, rid2} and done[rid2].status is Status.REJECTED
    assert sched.stats()["rejected"] == 1 and sched.stats()["requests"] == 2
    assert not sched.has_work and sched.inflight_tokens() == {}


def test_drain_keeps_the_queue(vusa):
    _, _, tparams = vusa
    sched = Scheduler(_engine(tparams, max_len=64), slots=1, segment=4)
    rng = np.random.default_rng(16)
    reqs = _reqs(rng, [(6, 6)] * 2)
    for r in reqs:
        sched.submit(r)
    sched.drain()
    assert sched.draining and sched.run() == {} and sched.has_work
    sched.resume_admission()
    seen = []
    done = sched.run(on_sync=lambda s: seen.append((s.completions_so_far(),
                                                    s.inflight_tokens())))
    assert seen and all(set(c).isdisjoint(f) for c, f in seen)
    assert sorted(done) == [0, 1]
    _check_parity(_engine(tparams, max_len=64), done, reqs)


def test_launcher_serves_requests(capsys):
    done = launch_serve.main(["--arch", "vusa_edge", "--smoke", "--device", "cpu",
                              "--requests", "5", "--slots", "2", "--prompt-len", "6",
                              "--max-new", "6", "--packed", "all"])
    assert len(done) == 5 and all(c.status is Status.OK for c in done.values())
    assert "5 completions" in capsys.readouterr().out
    done = launch_serve.main(["--arch", "vusa_edge", "--smoke", "--device", "cpu",
                              "--requests", "2", "--speculative", "--packed", "all",
                              "--prompt-len", "6", "--max-new", "6"])
    assert all(c.status is Status.OK for c in done.values())
    assert "speculative: acceptance" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "vusa_edge", "--smoke", "--device", "cpu",
                           "--batch", "2", "--speculative"])


def test_pool_step_rows_equal_b1_steps(vusa):
    """The pool step at 4 rows, row by row against a B = 1 step on the same
    cache row, logits bitwise, dense and packed."""
    _, _, tparams = vusa
    rng = np.random.default_rng(17)
    for route in ("dense", "fp32", "int4"):
        eng = _engine(tparams, max_len=32, **ROUTES[route])
        primed = [eng.prime(rng.integers(1, 500, (1, n)).astype(np.int32)) for n in (3, 7, 5, 11)]
        token = torch.cat([t for t, _ in primed])
        pool = eng.model.init_slot_cache(4, 32, device="cpu")
        from repro_torch.models.cache import write_slots

        batched = {k: torch.cat([c[k] for _, c in primed], dim=1) for k in ("k", "v")}
        write_slots(pool, [0, 1, 2, 3], {**batched, "pos": None},
                    eng.model.cache_batch_axes(32), [3, 7, 5, 11])
        with torch.no_grad():
            many = eng._logits(token, pool, eng.packed, rowwise=True)
            for i, (_, c) in enumerate(primed):
                assert torch.equal(many[i : i + 1], eng._logits(token[i : i + 1], c, eng.packed))


# C17 (``test_torch_engine.py`` has the setup): with the padding columns the
# largest logits, no completion of the scheduler holds a padding id, on the
# slot and paged pools, under batched and sequential admission (the
# prefill's first token), through chunked prefill (its last chunk's), greedy
# and at T = 1, and through the speculative pool rounds at T = 1 (the
# drafter's greedy choices and the verifier's draws)
C17_POOLS = [
    ("slot-batched", 0.0), ("slot-batched", 1.0), ("slot-sequential", 0.0),
    ("slot-sequential", 1.0), ("paged-chunked", 0.0), ("paged-chunked", 1.0),
    ("speculative", 1.0)]
C17_KW = {
    "slot-batched": dict(admission="batched"),
    "slot-sequential": dict(admission="sequential"),
    "paged-chunked": dict(admission="batched", page_size=8, prefill_chunk=8),
    "speculative": dict(admission="batched", speculative=True, draft_k=3),
}


@pytest.mark.parametrize("pool,temperature", C17_POOLS, ids=[f"{p}-{t}" for p, t in C17_POOLS])
def test_c17_no_padding_id_in_any_pool(pool, temperature):
    from torch_tp_cases import padding_first_config, padding_first_tree

    cfg = padding_first_config()
    kw = dict(C17_KW[pool])
    admission = kw.pop("admission")
    eng = Engine(cfg, params_from_numpy(padding_first_tree(), "cpu"),
                 ServeConfig(max_len=32, temperature=temperature, **kw), device="cpu")
    reqs = _reqs(np.random.default_rng(2), [(5, 4), (11, 3), (3, 5)])
    done = Scheduler(eng, slots=2, segment=3, admission=admission).run(reqs)
    assert sorted(done) == [0, 1, 2]
    for c in done.values():
        assert c.status is Status.OK and len(c.tokens) > 0
        assert int(np.max(c.tokens)) < cfg.vocab, c.tokens
