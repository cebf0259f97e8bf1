"""Port: the paged KV pool (block arena, prefix sharing, chunked prefill).

Parameters come from ``repro`` (the ``vusa_edge`` smoke config, init at
``key(0)``, magnitude-pruned to 85 %) and cross to the port as numpy.

Tolerances:
- the paged pool without prefix sharing or chunking is bitwise the slot
  pool under batched admission (the same prefill batches; the gathered
  block view is the slot pool's cache shape), greedy and sampled;
- prefix hits, copy-on-write tails, chunked prefill and preemption prime a
  suffix, a chunk or a re-admitted prompt at another row count (ROADMAP
  C9): their greedy tokens equal the slot pool's on this config;
- ``lm_prefill_chunk`` against ``repro``'s within 1e-5 of the largest
  logit and K/V value (the same fp32 arithmetic, summed in another order);
- the allocator and the blake2b digests are copies: their digests are
  byte-equal to ``repro.models.cache``'s;
- across frameworks, greedy: the port's paged completions with prefix
  sharing equal ``repro``'s paged ``Scheduler``'s.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.core.pruning import prune_tree as ref_prune
from repro.models import build_model as ref_build
from repro.models import cache as ref_cache
from repro.serve import Engine as RefEngine
from repro.serve import Request as RefRequest
from repro.serve import Scheduler as RefScheduler
from repro.serve import ServeConfig as RefServeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model
from repro_torch.models import cache
from repro_torch.serve import Engine, Request, Scheduler, ServeConfig, Status


@pytest.fixture(scope="module")
def vusa():
    cfg = ref_smoke("vusa_edge")
    params = ref_prune(ref_build(cfg).init(jax.random.key(0)), 0.85)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return cfg, params, tparams


def _run(tparams, reqs, slots=3, segment=4, on_sync=None, **kw):
    sched = Scheduler(Engine(get_smoke_config("vusa_edge"), tparams, ServeConfig(**kw),
                             device="cpu"), slots=slots, segment=segment)
    return sched, sched.run([dataclasses.replace(r) for r in reqs], on_sync=on_sync)


def _same(a, b):
    assert sorted(a) == sorted(b)
    for rid in a:
        np.testing.assert_array_equal(a[rid].tokens, b[rid].tokens, err_msg=f"rid {rid}")


def _ragged(rng, spec):
    return [Request(prompt=rng.integers(1, 500, n).astype(np.int32), max_new=m, seed=i)
            for i, (n, m) in enumerate(spec)]


# ---------------------------------------------------------------------------
# host side: layout, allocator, digests
# ---------------------------------------------------------------------------


def test_layout_and_allocator():
    lay = cache.PagedLayout.build(2, 64, 8)
    assert (lay.n_pages, lay.reserved, lay.user_blocks, lay.oob) == (8, 3, 16, 19)
    assert cache.PagedLayout.build(2, 64, 8, blocks=5).user_blocks == 5
    with pytest.raises(ValueError, match="divide"):
        cache.PagedLayout.build(2, 60, 8)
    al = cache.BlockAllocator(cache.PagedLayout.build(1, 16, 8, blocks=3))
    ids, scrub = al.alloc(2)
    assert ids == [2, 3] and scrub == [] and al.live_blocks == 2
    assert al.alloc(2) is None  # only one left
    assert al.register_page(b"a", ids[0]) and not al.register_page(b"a", ids[1])
    assert al.register_tail(b"t", ids[1], 3)
    assert al.free([ids[1]]) == []  # hashed: parked in the cached pool
    assert al.cached_blocks == 1 and al.match_tail([b"x", b"y", b"t"]) == (ids[1], 3)
    assert al.match_pages([b"a", b"b"]) == [ids[0]] and al.refcount(ids[0]) == 2
    assert al.free([ids[0], ids[0]]) == [] and al.cached_blocks == 2
    with pytest.raises(ValueError, match="underflow"):
        al.free([ids[0]])
    got, scrub = al.alloc(3)  # the free block, then both cached ones, LRU first
    assert sorted(got) == [2, 3, 4] and sorted(scrub) == [2, 3] and al.evictions == 2
    assert al.match_pages([b"a"]) == []  # the eviction dropped the registration
    assert al.hits == 2 and al.cow_copies == 1 and 0 < al.hit_rate < 1


@pytest.mark.parametrize("n", [0, 7, 16, 21])
def test_digests_byte_equal_reference(n):
    toks = np.random.default_rng(n).integers(0, 5000, n).astype(np.int32)
    full = cache.prefix_page_digests(toks, 8)
    assert full == ref_cache.prefix_page_digests(toks, 8)
    seed = full[-1] if full else b""
    tail = toks[len(full) * 8:]
    assert cache.prefix_tail_digests(seed, tail) == ref_cache.prefix_tail_digests(seed, tail)


# ---------------------------------------------------------------------------
# device side: arena helpers
# ---------------------------------------------------------------------------


def test_copy_block_and_zero_blocks_keep_bytes(vusa):
    model = build_model(get_smoke_config("vusa_edge"))
    lay = cache.PagedLayout.build(2, 64, 8)
    pool = model.init_paged_pool(lay, 64, device="cpu")
    rng = np.random.default_rng(13)
    for a in pool["arena"].values():
        a.copy_(torch.from_numpy(rng.normal(size=a.shape).astype(np.float32)))
    before = {k: a.clone() for k, a in pool["arena"].items()}
    src, dst = lay.reserved, lay.reserved + 1
    cache.copy_block(pool["arena"], src, dst)
    cache.zero_blocks(pool["arena"], [lay.reserved + 2, lay.oob])
    for name, a in pool["arena"].items():
        assert torch.equal(a[:, dst], before[name][:, src])
        assert not a[:, lay.reserved + 2].any()
        others = [b for b in range(a.shape[1]) if b not in (dst, lay.reserved + 2)]
        assert torch.equal(a[:, others], before[name][:, others])


def test_prefill_pages_bind_and_read_back(vusa):
    """A primed cache written into arena pages and bound to a slot reads
    back (``paged_read_slot``, the gathered view) as the contiguous cache."""
    _, _, tparams = vusa
    cfg = get_smoke_config("vusa_edge")
    model = build_model(cfg)
    lay = cache.PagedLayout.build(2, 32, 8)
    pool = model.init_paged_pool(lay, 32, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(1, 500, (1, 11))).long()
    _, primed = model.prefill(tparams, {"tokens": toks}, 32)
    rows = np.full((1, lay.n_pages), lay.oob)
    rows[0, :2] = [lay.reserved + 5, lay.reserved + 2]  # two pages cover 11 rows
    cache.write_prefill_pages(pool["arena"], rows, primed)
    table_row = np.array([[lay.reserved + 5, lay.reserved + 2, 1, 1], [0, 0, 0, 0]])
    cache.bind_slot_pages(pool["table"], pool["pos"], [1, lay.slots], table_row, [11, 3])
    got = cache.paged_read_slot(pool, 1, 32)
    for name in ("k", "v"):
        assert torch.equal(got[name][:, :, :16], primed[name][:, :, :16])
    assert int(got["pos"]) == 11 and pool["table"][0].tolist() == [1] * 4
    table, pos = cache.paged_host_mirror(pool)
    assert table[1].tolist() == table_row[0].tolist() and pos.tolist() == [0, 11]
    cache.paged_reset_slot(pool, 1, lay.scratch_block(1))
    assert pool["table"][1].tolist() == [2] * 4 and int(pool["pos"][1]) == 0


def test_prefill_chunk_matches_reference(vusa):
    """Two chunks of a 13-token prompt through ``lm_prefill_chunk`` against
    ``repro``'s: last-token logits and the arena's K/V rows."""
    cfg, params, tparams = vusa
    tcfg = get_smoke_config("vusa_edge")
    lay = cache.PagedLayout.build(1, 32, 8)
    pool = build_model(tcfg).init_paged_pool(lay, 32, device="cpu")
    ref_pool = ref_build(cfg).init_paged_pool(ref_cache.PagedLayout.build(1, 32, 8), 32)
    table = np.array([2, 3, 4, 1], np.int64)
    prompt = np.random.default_rng(5).integers(1, 500, 13).astype(np.int32)
    ref_arena = ref_pool["arena"]
    for start, n in ((0, 8), (8, 5)):
        toks = np.zeros((1, 8), np.int32)
        toks[0, :n] = prompt[start : start + n]
        got, _ = build_model(tcfg).prefill_chunk(tparams, torch.from_numpy(toks).long(),
                                                 pool["arena"], torch.from_numpy(table),
                                                 start, n, start)
        want, ref_arena = ref_build(cfg).prefill_chunk(
            params, jnp.asarray(toks), ref_arena, jnp.asarray(table, jnp.int32),
            jnp.int32(start), jnp.int32(n), jnp.int32(start))
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * max(np.abs(want).max(), 1.0)
    for name in ("k", "v"):
        w = np.asarray(ref_arena[name])
        assert np.abs(pool["arena"][name].numpy() - w).max() <= 1e-5 * max(np.abs(w).max(), 1.0)


# ---------------------------------------------------------------------------
# paged scheduler against the slot pool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temperature", [0.0, 1.0])
@pytest.mark.parametrize("packed", [False, "all"])
def test_paged_bitwise_slot_pool(vusa, packed, temperature):
    _, _, tparams = vusa
    rng = np.random.default_rng(0)
    reqs = _ragged(rng, [(6, 10), (13, 8), (9, 12), (17, 6), (5, 9), (24, 7)])
    kw = dict(max_len=64, temperature=temperature, packed_weights=packed)
    _, ref = _run(tparams, reqs, **kw)
    sp, got = _run(tparams, reqs, page_size=8, prefix_cache=False, **kw)
    assert sp.paged
    _same(ref, got)


def test_paged_bitwise_slot_pool_int8(vusa):
    _, _, tparams = vusa
    rng = np.random.default_rng(2)
    reqs = _ragged(rng, [(6, 8), (9, 6), (11, 7)])
    kw = dict(max_len=64, packed_weights="all", packed_values="int8")
    _, ref = _run(tparams, reqs, slots=2, **kw)
    _, got = _run(tparams, reqs, slots=2, page_size=8, **kw)
    _same(ref, got)


def test_prefix_cache_hit_skips_reprefill(vusa):
    """The same page-aligned prompt twice: the second serve matches every
    page, never calls prime_many, and gives the same tokens."""
    _, _, tparams = vusa
    p = np.random.default_rng(4).integers(1, 500, 16).astype(np.int32)
    sched = Scheduler(Engine(get_smoke_config("vusa_edge"), tparams,
                             ServeConfig(max_len=64, page_size=8), device="cpu"),
                      slots=2, segment=4)
    calls = []
    inner = sched.eng.prime_many
    sched.eng.prime_many = lambda *a, **k: (calls.append(1), inner(*a, **k))[1]
    d1 = sched.run([Request(prompt=p, max_new=8, seed=5)])
    assert calls and sched.stats()["prefix_hits"] == 0
    calls.clear()
    d2 = sched.run([Request(prompt=p.copy(), max_new=8, seed=5)])
    st = sched.stats()
    assert not calls, "a full prefix hit must not re-prefill"
    assert st["prefix_hits"] > 0 and st["prefix_hit_rate"] == 1.0
    np.testing.assert_array_equal(d1[0].tokens, d2[1].tokens)


def test_prefix_cow_partial_tail(vusa):
    _, _, tparams = vusa
    p = np.random.default_rng(5).integers(1, 500, 21).astype(np.int32)  # 2 pages + 5 rows
    sched = Scheduler(Engine(get_smoke_config("vusa_edge"), tparams,
                             ServeConfig(max_len=64, page_size=8), device="cpu"),
                      slots=2, segment=4)
    d1 = sched.run([Request(prompt=p, max_new=8, seed=6)])
    d2 = sched.run([Request(prompt=p.copy(), max_new=8, seed=6)])
    st = sched.stats()
    assert st["prefix_hits"] > 0 and st["cow_copies"] >= 1
    np.testing.assert_array_equal(d1[0].tokens, d2[1].tokens)


def test_prefix_cache_off_never_shares(vusa):
    _, _, tparams = vusa
    p = np.random.default_rng(6).integers(1, 500, 16).astype(np.int32)
    sched = Scheduler(Engine(get_smoke_config("vusa_edge"), tparams,
                             ServeConfig(max_len=64, page_size=8, prefix_cache=False),
                             device="cpu"), slots=2, segment=4)
    d1 = sched.run([Request(prompt=p, max_new=6, seed=0)])
    d2 = sched.run([Request(prompt=p.copy(), max_new=6, seed=0)])
    st = sched.stats()
    assert st["prefix_hits"] == 0 and st["prefix_lookups"] == 0
    np.testing.assert_array_equal(d1[0].tokens, d2[1].tokens)


def test_shared_prefix_traffic_matches_slot_pool_and_reference(vusa):
    """A shared 16-token system prompt before ragged suffixes: greedy tokens
    equal the slot pool's and ``repro``'s paged scheduler's; prefix pages
    are shared; the host mirrors equal the device's tables at every sync."""
    cfg, params, tparams = vusa
    rng = np.random.default_rng(9)
    prefix = rng.integers(1, 500, 16)
    prompts = [np.concatenate([prefix, rng.integers(1, 500, n)]).astype(np.int32)
               for n in (3, 9, 5, 12, 1)]
    reqs = [Request(prompt=p, max_new=8, seed=i, arrival_s=0.0) for i, p in enumerate(prompts)]
    _, ref = _run(tparams, reqs, slots=2, max_len=64)
    syncs = []
    sp, got = _run(tparams, reqs, slots=2, max_len=64, page_size=8,
                   on_sync=lambda s: syncs.append(s.verify_paged_mirror()))
    _same(ref, got)
    assert sp.stats()["prefix_hits"] > 0 and syncs and all(syncs)
    want = RefScheduler(RefEngine(cfg, params, RefServeConfig(max_len=64, page_size=8)),
                        slots=2, segment=4).run(
        [RefRequest(prompt=r.prompt, max_new=r.max_new, seed=r.seed) for r in reqs])
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, np.asarray(want[rid].tokens),
                                      err_msg=f"rid {rid}")


def test_chunked_prefill_parity_and_liveness(vusa):
    """A 70-token admission chunked at 16 tokens a round: the decoding slot
    keeps emitting while the long prompt prefills, and both requests' tokens
    equal the unchunked slot pool's."""
    _, _, tparams = vusa
    rng = np.random.default_rng(7)
    reqs = [Request(prompt=rng.integers(1, 500, 9).astype(np.int32), max_new=40, seed=0),
            Request(prompt=rng.integers(1, 500, 70).astype(np.int32), max_new=10, seed=1)]
    _, ref = _run(tparams, reqs, slots=2, max_len=128)
    snaps = []

    def on_sync(s):
        snaps.append([(sl.rid, len(sl.tokens or []), sl.prefill is not None) for sl in s._slot])

    sp, got = _run(tparams, reqs, slots=2, max_len=128, page_size=8, prefill_chunk=16,
                   on_sync=on_sync)
    _same(ref, got)
    assert sp.stats()["prefill_chunks"] >= 5
    overlapped = any(
        any(pa and pb for (_, _, pa), (_, _, pb) in zip(a, b))
        and any(tb > ta for (_, ta, pa), (_, tb, pb) in zip(a, b) if not (pa or pb))
        for a, b in zip(snaps, snaps[1:])
    )
    assert overlapped, "decode slots must keep stepping during chunked admission"


def test_preemption_parity_tiny_arena(vusa):
    """An arena far below slots x pages: mid-flight extension preempts the
    latest admission and the re-served requests give the same tokens."""
    _, _, tparams = vusa
    rng = np.random.default_rng(8)
    reqs = _ragged(rng, [(6, 10), (13, 8), (9, 12), (17, 6)])
    _, ref = _run(tparams, reqs, slots=4, max_len=64)
    sp, got = _run(tparams, reqs, slots=4, max_len=64, page_size=8, arena_blocks=10)
    _same(ref, got)
    assert sp.stats()["preempted"] >= 1
    assert all(c.status is Status.OK for c in got.values())


def test_submit_rejects_impossible_arena_budget(vusa):
    _, _, tparams = vusa
    sched = Scheduler(Engine(get_smoke_config("vusa_edge"), tparams,
                             ServeConfig(max_len=64, page_size=8, arena_blocks=2), device="cpu"),
                      slots=1, segment=4)
    with pytest.raises(ValueError, match="arena"):
        sched.submit(Request(prompt=np.ones(30, np.int32), max_new=20))
    with pytest.raises(ValueError, match="page_size"):
        ServeConfig(max_len=60, page_size=8)
    with pytest.raises(ValueError, match="prefill_chunk"):
        ServeConfig(max_len=64, prefill_chunk=16)
    with pytest.raises(ValueError, match="multiple"):
        ServeConfig(max_len=64, page_size=8, prefill_chunk=12)


def test_stats_paged_gauges(vusa):
    _, _, tparams = vusa
    empty = Scheduler(Engine(get_smoke_config("vusa_edge"), tparams,
                             ServeConfig(max_len=64, page_size=8), device="cpu"),
                      slots=2, segment=4).stats()
    assert math.isnan(empty["prefix_hit_rate"])
    assert math.isnan(empty["hbm_bytes_per_active_request"])
    assert empty["kv_pool_bytes"] > 0 and empty["kv_block_bytes"] > 0
    assert not math.isnan(empty["blocks_total"])
    rng = np.random.default_rng(12)
    sp, _ = _run(tparams, _ragged(rng, [(6, 8), (9, 6)]), slots=2, max_len=64, page_size=8)
    st = sp.stats()
    assert st["hbm_bytes_per_active_request"] > 0
    assert st["blocks_total"] == sp._layout.user_blocks
    assert st["blocks_live"] + st["blocks_free"] + st["blocks_cached"] == st["blocks_total"]
    slot_bytes = Scheduler(Engine(get_smoke_config("vusa_edge"), tparams,
                                  ServeConfig(max_len=64), device="cpu"),
                           slots=2, segment=4).stats()["kv_block_bytes"]
    assert st["hbm_bytes_per_active_request"] < slot_bytes
