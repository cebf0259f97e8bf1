"""Port: the failure model — seeded faults, the integrity guard, quarantine
and the bounded dense retry.

Parameters come from ``repro`` (the ``vusa_edge`` smoke config, init at
``key(0)``, magnitude-pruned to 85 %) and cross to the port as numpy.

Tolerances:
- ``FaultConfig`` draws are numpy's ``default_rng((seed, salt, rid))`` in
  both packages: equal, rid for rid; the port's packs are byte-identical to
  ``repro``'s, so the seeded corruption lands on the same element;
- tokens, bitwise within the port: under sequential admission every
  request a fault touches completes ``FAILED_FALLBACK_OK`` with the tokens
  of a clean dense run (one-shot ``generate`` at B = 1 with its seed), and
  every other request ``OK`` with its clean tokens; after a mid-run
  quarantine the other slots' tokens are the packed steps up to the
  quarantine followed by dense steps, bitwise.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.core.pruning import prune_tree as ref_prune
from repro.models import build_model as ref_build
from repro.serve import FaultConfig as RefFaultConfig
from repro.serve import faults as ref_faults
from repro.serve import packed as ref_packed
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.serve import Engine, FaultConfig, Request, Scheduler, ServeConfig, Status
from repro_torch.serve import faults, packed


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run many tiny ops: one intra-op thread runs them faster
    than many, and keeps them from contending for the cores with the test
    workers beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vusa():
    cfg = ref_smoke("vusa_edge")
    params = ref_prune(ref_build(cfg).init(jax.random.key(0)), 0.85)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return cfg, params, tparams


def _engine(tparams, **kw):
    return Engine(get_smoke_config("vusa_edge"), tparams, ServeConfig(**{"max_len": 64, **kw}),
                  device="cpu")


def _reqs(n, seed, max_new=8):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(1, 100, 6).astype(np.int32), max_new=max_new, seed=i)
            for i in range(n)]


def _run(eng, reqs, slots=2, segment=4, admission="sequential", **kw):
    sched = Scheduler(eng, slots=slots, segment=segment, admission=admission, **kw)
    return sched, sched.run([dataclasses.replace(r) for r in reqs])


def _clean_dense(tparams, req, temperature=0.0):
    """The tokens a dense retry must reproduce: one-shot generate at B = 1."""
    eng = _engine(tparams, temperature=temperature, seed=req.seed)
    return eng.generate(np.asarray(req.prompt)[None], max_new=req.max_new)["tokens"][0]


# ---------------------------------------------------------------------------
# the plan and the pack corruption
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_fault_config_draws_equal_reference(seed):
    kw = dict(seed=seed, cache_nan_rate=0.3, stall_s=0.1, stall_rate=0.4,
              decode_stall_s=0.2, decode_stall_rate=0.5, cache_nan_rids=(3,),
              decode_hang_rids=(5,))
    port, ref = FaultConfig(**kw), RefFaultConfig(**kw)
    for rid in range(40):
        for name in ("wants_cache_nan", "wants_stall", "wants_decode_stall", "wants_decode_hang"):
            assert getattr(port, name)(rid) == getattr(ref, name)(rid), (name, rid)
    assert port.stalls_decode() == ref.stalls_decode()
    assert FaultConfig(decode_stall_s=1.0).stalls_decode() is False
    assert FaultConfig(decode_hang_rids=(0,)).stalls_decode() is True


@pytest.mark.parametrize("value_dtype", ["dense", "int8"])
def test_corruption_lands_where_reference_puts_it(vusa, value_dtype):
    """Equal packs, equal plan: the value NaN (int8: the slot's scale) and
    the position flip land on the same element as ``repro``'s."""
    cfg, params, tparams = vusa
    rp = ref_packed.pack_lm_weights(cfg, params, 128, 16, scope="all", value_dtype=value_dtype)
    tp = packed.pack_lm_weights(get_smoke_config("vusa_edge"), tparams, 128, 16, scope="all",
                                value_dtype=value_dtype)
    plan = dict(seed=3, pack_value_nans=2, pack_position_flips=2)
    for fn in ("corrupt_pack_values", "corrupt_pack_positions"):
        r = ref_packed._flat_entries(getattr(ref_faults, fn)(rp, RefFaultConfig(**plan)))
        t = packed._flat_entries(getattr(faults, fn)(tp, FaultConfig(**plan)))
        for name in r:
            for leaf in ("values", "positions", "scales"):
                if leaf not in r[name]:
                    continue
                a, b = np.asarray(r[name][leaf]), t[name][leaf].float().numpy()
                np.testing.assert_array_equal(np.isnan(a.astype(np.float32)), np.isnan(b))
                np.testing.assert_array_equal(a.astype(np.float32) == -2, b == -2)
    # only the corrupted tensors are copies: the clean pack is untouched
    packed.validate_packed(tp)


def test_engine_refuses_corrupt_positions(vusa):
    """A flipped position byte makes Engine init fail: the pack is never
    served; the same plan corrupts the same byte."""
    _, _, tparams = vusa
    with pytest.raises(ValueError, match="outside"):
        _engine(tparams, packed_weights="mlp", faults=FaultConfig(pack_position_flips=1))
    tp = _engine(tparams, packed_weights="mlp").packed
    a = faults.corrupt_pack_positions(tp, FaultConfig(pack_position_flips=1))
    b = faults.corrupt_pack_positions(tp, FaultConfig(pack_position_flips=1))
    for name in a["mlp"]:
        assert torch.equal(a["mlp"][name]["positions"], b["mlp"][name]["positions"])
    with pytest.raises(ValueError, match="outside"):
        packed.validate_packed(a)


# ---------------------------------------------------------------------------
# the guard, quarantine and the dense retry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("value_dtype", ["bf16", "int8"])
def test_value_nans_quarantine_and_fall_back_dense(vusa, value_dtype):
    """NaN values in the pack (after validation, so only the guard sees
    them): the pack is quarantined, every request completes
    FAILED_FALLBACK_OK with the tokens of a clean dense run."""
    _, _, tparams = vusa
    eng = _engine(tparams, packed_weights="all", packed_values=value_dtype,
                  faults=FaultConfig(pack_value_nans=2))
    assert eng.packed_active
    reqs = _reqs(3, 2)
    sched, done = _run(eng, reqs, slots=3)
    assert eng.quarantined and not eng.packed_active
    for rid, c in done.items():
        assert c.status is Status.FAILED_FALLBACK_OK, (rid, c.status)
        np.testing.assert_array_equal(c.tokens, _clean_dense(tparams, reqs[rid]))
    st = sched.stats()
    assert st["fallback"] == 3 and st["quarantined"] == 1 and st["failed"] == 0


@pytest.mark.parametrize("temperature", [0.0, 1.0])
@pytest.mark.parametrize("page", [0, 8])
def test_cache_poison_retries_without_quarantine(vusa, page, temperature):
    """A one-shot cache NaN on a dense engine, slot pool and paged pool:
    the request retries once and completes FAILED_FALLBACK_OK with its
    clean tokens; its neighbours complete OK, bitwise clean; nothing is
    quarantined."""
    _, _, tparams = vusa
    eng = _engine(tparams, temperature=temperature, page_size=page,
                  faults=FaultConfig(cache_nan_rids=(1,)))
    reqs = _reqs(3, 3)
    sched, done = _run(eng, reqs)
    assert not eng.quarantined
    assert [done[r].status for r in range(3)] == [Status.OK, Status.FAILED_FALLBACK_OK,
                                                  Status.OK]
    for rid, c in done.items():
        np.testing.assert_array_equal(c.tokens, _clean_dense(tparams, reqs[rid], temperature),
                                      err_msg=f"rid {rid}")
    st = sched.stats()
    assert st["fallback"] == 1 and st["quarantined"] == 0 and st["failed"] == 0


@pytest.mark.parametrize("page", [0, 8])
def test_persistent_poison_bounded_retry(vusa, page):
    """``cache_nan_once=False`` poisons the retry too: FAILED after exactly
    one retry, never a loop; the neighbours stay bitwise clean."""
    _, _, tparams = vusa
    eng = _engine(tparams, page_size=page,
                  faults=FaultConfig(cache_nan_rids=(1,), cache_nan_once=False))
    reqs = _reqs(3, 4)
    sched, done = _run(eng, reqs)
    assert done[1].status is Status.FAILED
    for rid in (0, 2):
        assert done[rid].status is Status.OK
        np.testing.assert_array_equal(done[rid].tokens, _clean_dense(tparams, reqs[rid]))
    st = sched.stats()
    assert st["fallback"] == 1 and st["failed"] == 1


@pytest.mark.parametrize("page", [0, 8])
def test_clean_request_reuses_poisoned_slot_and_block(vusa, page):
    """One slot: a poisoned request, its retry, then two clean ones all pass
    through slot 0 (and, paged, through the poisoned block, which is zeroed
    when it dies): every one completes with its clean tokens."""
    _, _, tparams = vusa
    eng = _engine(tparams, page_size=page, arena_blocks=8 if page else 0,
                  faults=FaultConfig(cache_nan_rids=(0,)))
    sched = Scheduler(eng, slots=1, segment=4, admission="sequential")
    poisoned, owners = [], []
    if page:
        real = sched._apply_paged_poison

        def spy(i):
            real(i)
            poisoned.append(sched._slot_private[i][0])

        sched._apply_paged_poison = spy
    reqs = _reqs(3, 5)
    done = sched.run([dataclasses.replace(r) for r in reqs],
                     on_sync=lambda s: owners.append(
                         (s._slot[0].rid, list(s._slot_blocks[0]) if page else [])))
    assert done[0].status is Status.FAILED_FALLBACK_OK
    assert done[1].status is Status.OK and done[2].status is Status.OK
    for rid, c in done.items():
        np.testing.assert_array_equal(c.tokens, _clean_dense(tparams, reqs[rid]))
    if page:
        assert len(poisoned) == 1
        reused = {rid for rid, blocks in owners if poisoned[0] in blocks}
        assert reused - {0}, f"block {poisoned[0]} never reused by a clean request: {owners}"


def test_mid_run_quarantine_leaves_other_slots_bitwise(vusa):
    """A cache NaN under packed weights quarantines the pack at the first
    sync; the pool goes dense from the next segment.  The other slots'
    tokens are bitwise a B = 1 run that takes one packed segment, then
    switches dense: the switch touches nothing else of theirs."""
    _, _, tparams = vusa
    seg = 4
    eng = _engine(tparams, packed_weights="all", faults=FaultConfig(cache_nan_rids=(1,)))
    reqs = _reqs(3, 6, max_new=12)
    sched, done = _run(eng, reqs, slots=3, segment=seg)
    assert eng.quarantined and sched.stats()["quarantined"] == 1
    assert done[1].status is Status.FAILED_FALLBACK_OK
    np.testing.assert_array_equal(done[1].tokens, _clean_dense(tparams, reqs[1]))
    for rid in (0, 2):
        oracle = _engine(tparams, packed_weights="all")
        with torch.no_grad():
            first, c = oracle.prime(reqs[rid].prompt[None])
            a, _, last, c = oracle.decode_segment(first, c, seg)
            assert oracle.quarantine_packed()
            b, _, _, _ = oracle.decode_segment(last, c, reqs[rid].max_new - 1 - seg)
        want = torch.cat([first, a, b], dim=1)[0].numpy()
        assert done[rid].status is Status.OK
        np.testing.assert_array_equal(done[rid].tokens, want, err_msg=f"rid {rid}")


def test_spec_quarantine_falls_back_dense(vusa):
    """NaN values in the verifier's pack under speculative serving: the pack
    is quarantined, rounds go on with the dense verifier (the drafter keeps
    its own pack) and every request completes FAILED_FALLBACK_OK with the
    tokens of a clean dense scheduler."""
    _, _, tparams = vusa
    eng = _engine(tparams, max_len=96, packed_weights="all", speculative=True,
                  faults=FaultConfig(pack_value_nans=2))
    reqs = _reqs(3, 2)
    sched, done = _run(eng, reqs, slots=3, segment=3)
    assert eng.quarantined
    _, clean = _run(_engine(tparams, max_len=96), reqs, slots=3, segment=3)
    for rid, c in done.items():
        assert c.status is Status.FAILED_FALLBACK_OK, (rid, c.status)
        np.testing.assert_array_equal(c.tokens, clean[rid].tokens, err_msg=f"rid {rid}")
    st = sched.stats()
    assert st["quarantined"] == 1 and st["failed"] == 0


def test_admission_stall_lands_in_admit_time(vusa):
    _, _, tparams = vusa
    eng = _engine(tparams, faults=FaultConfig(stall_s=0.05, stall_rids=(0,)))
    sched, done = _run(eng, _reqs(2, 5))
    assert all(c.status is Status.OK for c in done.values())
    assert sched.stats()["admit_s"] >= 0.05


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_sweep_no_corrupt_ok(vusa, seed):
    """``tests/test_faults.py``'s sweep on the port: a 30 % seeded cache
    fault rate, 8 requests on 4 slots; every completion OK or
    FAILED_FALLBACK_OK, every token stream bitwise the clean run."""
    _, _, tparams = vusa
    eng = _engine(tparams, faults=FaultConfig(seed=seed, cache_nan_rate=0.3))
    reqs = _reqs(8, seed)
    sched, done = _run(eng, reqs, slots=4)
    assert set(done) == set(range(8))
    n_fallback = 0
    for rid, c in done.items():
        assert c.status in (Status.OK, Status.FAILED_FALLBACK_OK), (rid, c.status)
        n_fallback += c.status is Status.FAILED_FALLBACK_OK
        np.testing.assert_array_equal(c.tokens, _clean_dense(tparams, reqs[rid]),
                                      err_msg=f"rid {rid}")
    assert sched.stats()["fallback"] == n_fallback
    assert n_fallback == sum(eng.sc.faults.wants_cache_nan(r) for r in range(8))
