"""Port: the scheduler's speculative segments on the slot and paged pools.

Parameters come from ``repro`` (the ``vusa_edge`` smoke config, init at
``key(0)``) with the tier structure of ``tests/test_spec_decode.py`` (a
1 % core and a 14 % detail tier, so a 99 %-sparse drafter is often right)
and cross to the port as numpy.

Tolerances:
- within the port, bitwise: the speculative scheduler's completions equal
  the plain scheduler's, greedy and sampled, slot and paged pools
  (sequential admission, re-admitting mid-run; or batched, every request
  admitted in one round, so both runs prime the same batches); row b of
  the pool's
  speculative round equals a B = 1 ``_spec_round`` on that slot's cache
  row (tokens, flags, emitted count, cache rows), since the round runs
  ``rowwise`` and the kernels' plain versions multiply one row at a time;
- ``paged_scatter_rows`` writes the same arena as ``repro``'s, bitwise (a
  copy of values);
- across frameworks, greedy only: the port's speculative completions equal
  ``repro``'s speculative ``Scheduler``'s (sampled tokens cannot cross
  frameworks: different generators).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import build_model as ref_build
from repro.models import cache as ref_cache
from repro.serve import Engine as RefEngine
from repro.serve import Request as RefRequest
from repro.serve import Scheduler as RefScheduler
from repro.serve import ServeConfig as RefServeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import cache
from repro_torch.serve import Engine, Request, Scheduler, ServeConfig, Status
from repro_torch.serve.engine import _SpecLoop

ROUTES = {"dense": {}, "fp32": {"packed_weights": "all"},
          "int8": {"packed_weights": "all", "packed_values": "int8"}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run many tiny ops: one intra-op thread runs them faster
    than many, and keeps them from contending for the cores with the test
    workers beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiered(tree, detail=0.03):
    """``tests/test_spec_decode.py::_tiered`` on a numpy tree."""
    if isinstance(tree, dict):
        return {k: _tiered(v, detail) for k, v in tree.items()}
    w = np.asarray(tree)
    if w.ndim < 2:
        return w
    a = np.abs(w)
    srt = np.sort(a.ravel())[::-1]
    t1 = srt[max(int(0.01 * a.size) - 1, 0)]
    t2 = srt[max(int(0.15 * a.size) - 1, 0)]
    return np.where(a >= t1, w, np.where(a >= t2, w * detail, 0.0)).astype(w.dtype)


@pytest.fixture(scope="module")
def tiered():
    cfg = ref_smoke("vusa_edge")
    t = _tiered(jax.tree_util.tree_map(np.asarray, ref_build(cfg).init(jax.random.key(0))))
    return cfg, jax.tree_util.tree_map(jnp.asarray, t), params_from_numpy(t, "cpu")


def _engine(tparams, spec=False, **kw):
    sc = ServeConfig(max_len=96, speculative=spec, draft_k=4, draft_sparsity=0.99, **kw)
    return Engine(get_smoke_config("vusa_edge"), tparams, sc, device="cpu")


def _reqs(n=4, seed=0, max_new=8, **kw):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(1, 100, 3 + 2 * i).astype(np.int32), max_new=max_new,
                    seed=i, **kw) for i in range(n)]


def _run(eng, reqs, **kw):
    sched = Scheduler(eng, **{"slots": 3, "segment": 3, **kw})
    return sched, sched.run([dataclasses.replace(r) for r in reqs])


def _same(a, b):
    assert sorted(a) == sorted(b)
    for rid in a:
        np.testing.assert_array_equal(a[rid].tokens, b[rid].tokens, err_msg=f"rid {rid}")


# ---------------------------------------------------------------------------
# speculative scheduler == plain scheduler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temperature", [0.0, 1.0])
@pytest.mark.parametrize("route", list(ROUTES))
def test_spec_scheduler_bitwise_plain_slot_pool(tiered, route, temperature):
    """Slot pool, sequential admission, 3 slots for 4 requests (a slot is
    re-admitted mid-run): every completion bitwise the plain scheduler's;
    the acceptance counters live in stats()."""
    _, _, tparams = tiered
    kw = dict(temperature=temperature, **ROUTES[route])
    _, want = _run(_engine(tparams, **kw), _reqs(), admission="sequential")
    sched, got = _run(_engine(tparams, spec=True, **kw), _reqs(), admission="sequential")
    _same(got, want)
    assert all(c.status is Status.OK for c in got.values())
    st = sched.stats()
    assert st["spec_proposed"] > 0 and 0.0 <= st["acceptance_rate"] <= 1.0
    if temperature == 0.0:
        assert st["spec_accepted"] > 0


@pytest.mark.parametrize("admission,route,temperature", [
    ("sequential", "fp32", 0.0), ("sequential", "fp32", 1.0), ("sequential", "dense", 1.0),
    ("batched", "int8", 0.0), ("batched", "dense", 0.0)])
def test_spec_scheduler_bitwise_plain_paged(tiered, admission, route, temperature):
    """Paged pool, pages of 8: bitwise the plain paged scheduler and the
    speculative slot pool; the host mirrors equal the device's tables at
    every sync.  Sequential admission primes each request alone (3 slots
    for 4 requests, re-admitting mid-run); batched admission primes in
    buckets, so every request is admitted in the first round (4 slots) and
    the runs prime the same batches."""
    _, _, tparams = tiered
    kw = dict(temperature=temperature, **ROUTES[route])
    reqs = _reqs()
    slots = 3 if admission == "sequential" else 4
    _, want = _run(_engine(tparams, page_size=8, **kw), reqs, slots=slots, admission=admission)
    checks = []
    sched = Scheduler(_engine(tparams, spec=True, page_size=8, **kw), slots=slots, segment=3,
                      admission=admission)
    got = sched.run([dataclasses.replace(r) for r in reqs],
                    on_sync=lambda s: checks.append(s.verify_paged_mirror()))
    assert sched.paged and checks and all(checks)
    _same(got, want)
    _, slot = _run(_engine(tparams, spec=True, **kw), reqs, slots=slots, admission=admission)
    _same(got, slot)


def test_spec_greedy_tokens_match_reference(tiered):
    """Greedy, fp32-value verifier: the port's speculative completions equal
    ``repro``'s speculative scheduler's (Pallas in interpret mode)."""
    cfg, params, tparams = tiered
    reqs = _reqs(3, max_new=8)
    _, got = _run(_engine(tparams, spec=True, packed_weights="all"), reqs, slots=2,
                  admission="sequential")
    ref_sc = RefServeConfig(max_len=96, packed_weights="all", speculative=True, draft_k=4,
                            draft_sparsity=0.99)
    ref = RefScheduler(RefEngine(cfg, params, ref_sc), slots=2, segment=3).run(
        [RefRequest(prompt=r.prompt, max_new=r.max_new, seed=r.seed) for r in reqs])
    for rid in ref:
        np.testing.assert_array_equal(got[rid].tokens, np.asarray(ref[rid].tokens),
                                      err_msg=f"rid {rid}")


def test_eos_mid_round_stops_stream(tiered):
    """EOS inside a speculative round: the host consumes the round in order
    and retires at the first EOS; nothing past it leaks out, and the stream
    equals the plain scheduler's EOS run."""
    _, _, tparams = tiered
    probe = _engine(tparams, packed_weights="all")
    prompt = np.random.default_rng(7).integers(1, 100, 6).astype(np.int32)
    stream = probe.generate(prompt[None], max_new=12)["tokens"][0]
    eos = int(stream[5])
    req = [Request(prompt=prompt, max_new=12, seed=0, eos_id=eos)]
    _, want = _run(_engine(tparams, packed_weights="all"), req, slots=2)
    _, got = _run(_engine(tparams, spec=True, packed_weights="all"), req, slots=2)
    np.testing.assert_array_equal(got[0].tokens, want[0].tokens)
    toks = np.asarray(got[0].tokens)
    hits = np.flatnonzero(toks == eos)
    assert hits.size >= 1 and hits[0] == len(toks) - 1


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


@pytest.mark.parametrize("speculative", [False, True])
def test_itl_one_sample_per_emission_event(tiered, speculative):
    """Tokens surface only at syncs, so each sync's emission is one event:
    with a clock that moves exactly 1 s per sync every ITL sample is 1.0,
    however many tokens a speculative round emitted."""
    _, _, tparams = tiered
    clk = _FakeClock()
    eng = _engine(tparams, spec=speculative, packed_weights="all")
    sched = Scheduler(eng, slots=1, segment=1 if speculative else 3, clock=clk,
                      sleep=clk.sleep)
    for r in _reqs(1, max_new=12):
        sched.submit(r)
    done = sched.run(on_sync=lambda s: clk.sleep(1.0))
    assert len(done[0].tokens) == 12
    samples = sched.itl_samples()
    assert samples and set(samples) == {1.0}
    st = sched.stats()
    assert st["itl_p50_s"] == 1.0 and st["itl_p99_s"] == 1.0


# ---------------------------------------------------------------------------
# the pool round against a B = 1 round; the paged scatter against repro's
# ---------------------------------------------------------------------------


def _primed_pool(eng, lens, paged, seed=17):
    """A speculative pool of ``len(lens)`` slots holding caches primed from
    prompts of ``lens`` tokens (slot pool, or paged with pages of 8), and
    the primed (first token, B = 1 cache) pairs."""
    rng = np.random.default_rng(seed)
    primed = [eng.prime(rng.integers(1, 500, (1, n)).astype(np.int32)) for n in lens]
    n, max_len = len(lens), eng.sc.max_len
    batched = {k: torch.cat([c[k] for _, c in primed], dim=1) for k in ("k", "v")}
    if paged:
        lay = cache.PagedLayout.build(n, max_len, 8)
        st = eng.new_pool(n, 2, lay, spec=True)
        rows = (lay.reserved + np.arange(n * lay.n_pages)).reshape(n, -1)
        cache.write_prefill_pages(st.cache["arena"], rows, batched)
        cache.bind_slot_pages(st.cache["table"], st.cache["pos"], list(range(n)), rows, lens)
    else:
        st = eng.new_pool(n, 2, spec=True)
        cache.write_slots(st.cache, list(range(n)), {**batched, "pos": None},
                          eng.model.cache_batch_axes(max_len), lens)
    st.token.copy_(torch.cat([t for t, _ in primed]))
    return st, primed


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("route", list(ROUTES))
def test_pool_round_rows_equal_b1_rounds(tiered, route, paged):
    """Two pool rounds at 4 slots at ragged positions, sampled (the noise
    rows per slot): row b bitwise two B = 1 ``_spec_round``s on slot b's
    cache (tokens, flags, emitted counts, K/V rows up to the new pos)."""
    _, _, tparams = tiered
    eng = _engine(tparams, spec=True, temperature=1.0, **ROUTES[route])
    lens = [3, 9, 5, 12]
    st, primed = _primed_pool(eng, lens, paged)
    noise = [eng.gumbel_noise(40, 1, seed=30 + b) for b in range(len(lens))]
    st.noise = torch.zeros((len(lens), eng.sc.max_len, eng.cfg.padded_vocab))
    for b, g in enumerate(noise):
        st.noise[b, :40] = g[:, 0]
    with torch.no_grad():
        eng._pool_spec_round(st)
        eng._pool_spec_round(st)
        S = eng.sc.draft_k + 1
        for b, (tok, c) in enumerate(primed):
            one = _SpecLoop(tok.clone(), {k: v.clone() for k, v in c.items()},
                            torch.zeros((), dtype=torch.long), torch.zeros((), dtype=torch.long),
                            torch.zeros((2 * S + 1,), dtype=torch.long),
                            torch.ones((2 * S + 1,), dtype=torch.bool), noise[b])
            col = 0
            for r in range(2):
                n0 = int(one.count)
                eng._spec_round(one)
                nem = int(one.count) - n0
                assert nem == int(st.nems[b, r]), (b, r)
                assert torch.equal(one.buf[n0 : n0 + nem], st.toks[b, r, :nem]), (b, r)
                assert torch.equal(one.okb[n0 : n0 + S], st.oks[b, r]), (b, r)
                col += nem
            assert torch.equal(one.token, st.token[b : b + 1])
            if paged:
                row = cache.paged_read_slot(st.cache, b, eng.sc.max_len)
            else:
                row = cache.read_slot(st.cache, b, eng.model.cache_batch_axes(eng.sc.max_len))
            p = int(one.cache["pos"])
            assert p == int(row["pos"]) == lens[b] + col
            for k in ("k", "v"):
                assert torch.equal(one.cache[k][:, :, :p], row[k][:, :, :p]), (b, k)


def test_paged_scatter_rows_matches_reference():
    """The same arena, tables, start positions and rows through the port's
    ``paged_scatter_rows`` (per layer, in place) and ``repro``'s (all
    layers, functional): byte-equal arenas; the rows past a slot's pages
    land in the block its table holds there (its scratch block)."""
    rng = np.random.default_rng(3)
    L, slots, page, n_pages, S, kvh, hd = 2, 3, 4, 4, 5, 2, 3
    lay = cache.PagedLayout.build(slots, page * n_pages, page)
    arena = rng.standard_normal((L, lay.n_blocks, page, kvh, hd)).astype(np.float32)
    table = np.stack([np.full(n_pages, lay.scratch_block(i)) for i in range(slots)])
    table[0, :2] = [lay.reserved, lay.reserved + 1]  # slot 0: 2 pages, rows past go to scratch
    table[1, :] = lay.reserved + 2 + np.arange(n_pages)  # slot 1: every page
    start = np.array([5, 11, 2])  # slot 2 free: its table is all scratch
    rows = rng.standard_normal((slots, L, 1, S, kvh, hd)).astype(np.float32)
    want = ref_cache.paged_scatter_rows(
        {"arena": {"k": jnp.asarray(arena)}, "table": jnp.asarray(table, jnp.int32),
         "pos": jnp.asarray(start, jnp.int32)},
        {"k_new": jnp.asarray(rows)}, jnp.asarray(start, jnp.int32),
        jnp.asarray([2, 5, 1], jnp.int32))
    got = torch.from_numpy(arena.copy())
    for layer in range(L):
        cache.paged_scatter_rows(got[layer], torch.from_numpy(table),
                                 torch.from_numpy(start), torch.from_numpy(rows[:, layer, 0]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want["arena"]["k"]))
    np.testing.assert_array_equal(np.asarray(want["pos"]), start + [2, 5, 1])


def test_scheduler_accepts_speculative_engine_and_budgets_rounds(tiered):
    """A speculative engine serves through the scheduler on both pools; its
    worst-case KV growth per segment is segment x (draft_k + 1) rows."""
    _, _, tparams = tiered
    for page in (0, 8):
        sched = Scheduler(_engine(tparams, spec=True, page_size=page), slots=2, segment=3)
        assert sched.speculative and sched._span == 3 * 5
        with pytest.raises(ValueError, match="segment span"):
            sched.submit(Request(prompt=np.ones(40, np.int32), max_new=50))
        sched.submit(Request(prompt=np.ones(40, np.int32), max_new=40))
