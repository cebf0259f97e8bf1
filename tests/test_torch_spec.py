"""Port vs reference: multi-token decode and self-speculative decoding.

Parameters come from ``repro`` (the ``vusa_edge`` smoke config, init at
``key(0)``) and cross to the port as numpy.  ``_tiered`` gives them the
tier structure of ``tests/test_spec_decode.py`` (a 1 % core and a 14 %
detail tier), so a 99 %-sparse drafter is often right.

Tolerances:
- within the port, the multi-token verify (the dense chain, the partial
  pack's chain and the full pack's batched pass) equals s sequential
  single-token steps bitwise, logits and cache: the kernels' plain
  versions on the CPU are row-stable (one row at a time) and the attend
  runs one query row at a time;
- against the reference's sequential steps (Pallas kernels in interpret
  mode), 1e-5 of the largest logit: the same fp32 arithmetic, summed in
  another order;
- tokens: greedy speculative tokens equal the reference's exactly, and
  within the port speculative tokens equal plain decode's exactly, greedy
  and sampled (sampled tokens cannot cross frameworks: different
  generators).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.core.pruning import prune_tree as ref_prune
from repro.models import build_model as ref_build
from repro.serve import Engine as RefEngine
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import packed as ref_packed
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model
from repro_torch.models.layers import _write_rows
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve import packed
from repro_torch.serve.metrics import acceptance_rate

MODES = ["dense", "all", "int8"]


def _tiered(tree, detail=0.03):
    """``tests/test_spec_decode.py::_tiered`` on a numpy tree: the top 1 % of
    magnitudes kept, the next 14 % scaled by ``detail``, zeros elsewhere."""
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
def vusa():
    cfg = ref_smoke("vusa_edge")
    tree = jax.tree_util.tree_map(np.asarray, ref_build(cfg).init(jax.random.key(0)))
    return cfg, tree


@pytest.fixture(scope="module")
def tiered(vusa):
    cfg, tree = vusa
    t = _tiered(tree)
    return cfg, jax.tree_util.tree_map(jnp.asarray, t), params_from_numpy(t, "cpu")


@pytest.fixture(scope="module")
def pruned(vusa):
    cfg, tree = vusa
    p = ref_prune(jax.tree_util.tree_map(jnp.asarray, tree), 0.85)
    return cfg, p, params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")


def _prompts():
    """The reference test's prompt (``_prompt(3)``) and one over the whole
    vocabulary, whose tokens vary more."""
    return [np.random.default_rng(3).integers(1, hi, (1, 6)).astype(np.int32)
            for hi in (100, 512)]


def _sc(mode, **kw):
    return dict(max_len=96, packed_weights=False if mode == "dense" else "all",
                packed_values="int8" if mode == "int8" else "bf16", **kw)


def _port(tparams, mode, **kw):
    return Engine(get_smoke_config("vusa_edge"), tparams, ServeConfig(**_sc(mode, **kw)),
                  device="cpu")


def _pair(tparams, mode, temperature=0.0, **spec_kw):
    """(plain, speculative) port engines with the same seed."""
    spec = {"speculative": True, "draft_k": 4, "draft_sparsity": 0.99, **spec_kw}
    return (_port(tparams, mode, temperature=temperature),
            _port(tparams, mode, temperature=temperature, **spec))


# ---------------------------------------------------------------------------
# multi-token decode: bitwise the sequential steps, near the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["dense", "mlp", "all", "int8"])
def test_multitoken_verify_bitwise_and_near_reference(pruned, mode):
    cfg, params, tparams = pruned
    tcfg = get_smoke_config("vusa_edge")
    scope = {"dense": None, "mlp": "mlp", "all": "all", "int8": "all"}[mode]
    vdt = "int8" if mode == "int8" else "dense"
    model, ref_model = build_model(tcfg), ref_build(cfg)
    pk = None if scope is None else packed.pack_lm_weights(tcfg, tparams, scope=scope,
                                                           value_dtype=vdt)
    ref_pk = None if scope is None else ref_packed.pack_lm_weights(cfg, params, scope=scope,
                                                                   value_dtype=vdt)

    def step(tok, cache):
        if pk is None:
            return model.decode_step(tparams, tok, cache)
        return packed.lm_decode_step_packed(tparams, pk, tok, cache, tcfg)

    rng = np.random.default_rng(2)
    prompt = rng.integers(1, cfg.vocab, (1, 5)).astype(np.int32)
    toks = rng.integers(1, cfg.vocab, (1, 5)).astype(np.int32)
    _, multi_cache = model.prefill(tparams, {"tokens": torch.from_numpy(prompt).long()}, 16)
    _, seq_cache = model.prefill(tparams, {"tokens": torch.from_numpy(prompt).long()}, 16)
    with torch.no_grad():
        multi, multi_cache = step(torch.from_numpy(toks).long(), multi_cache)
        seq = torch.cat([step(torch.from_numpy(toks[:, i : i + 1]).long(), seq_cache)[0]
                         for i in range(toks.shape[1])], dim=1)
    assert torch.equal(multi, seq)
    for name in ("k", "v"):
        assert torch.equal(multi_cache[name], seq_cache[name])
    assert int(multi_cache["pos"]) == int(seq_cache["pos"]) == 10

    _, ref_cache = ref_model.prefill(params, {"tokens": jnp.asarray(prompt)}, 16)
    want = []
    for i in range(toks.shape[1]):
        tok = jnp.asarray(toks[:, i : i + 1])
        if ref_pk is None:
            lg, ref_cache = ref_model.decode_step(params, tok, ref_cache)
        else:
            lg, ref_cache = ref_packed.lm_decode_step_packed(params, ref_pk, tok, ref_cache, cfg)
        want.append(np.asarray(lg))
    want = np.concatenate(want, axis=1)
    err = float(np.abs(multi.numpy() - want).max())
    assert err <= 1e-5 * max(float(np.abs(want).max()), 1.0), err


def test_rows_past_the_cache_end_are_dropped():
    """A write window that runs past the cache keeps the rows inside it and
    drops the rest; nothing lands on the last slot by clamping."""
    for pos, want in ((4, [0, 0, 0, 0, 1, 2, 3, 0]), (6, [0] * 6 + [1, 2]),
                      (7, [0] * 7 + [1]), (8, [0] * 8), (11, [0] * 8)):
        cache = torch.zeros(1, 8, 1, 1)
        rows = torch.arange(1.0, 4.0).view(1, 3, 1, 1)
        _write_rows(cache, torch.tensor(pos) + torch.arange(3), rows)
        assert cache.flatten().tolist() == want, pos


# ---------------------------------------------------------------------------
# speculative generate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_greedy_spec_tokens_match_reference(tiered, mode):
    cfg, params, tparams = tiered
    ref = RefEngine(cfg, params, RefServeConfig(**_sc(mode, speculative=True)))
    port = _port(tparams, mode, speculative=True)
    for prompt in _prompts():
        want = ref.generate(prompt, max_new=24)
        got = port.generate(prompt, max_new=24)
        np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
        assert got["finite"]
        for key in ("spec_rounds", "spec_proposed", "spec_accepted"):
            assert got[key] == want[key], key


@pytest.mark.parametrize("temperature", [0.0, 1.0])
@pytest.mark.parametrize("mode", MODES)
def test_spec_equals_plain_decode(tiered, mode, temperature):
    """Greedy and sampled: each emitted token's logits equal the plain
    step's bitwise and its draw uses the plain step's noise row."""
    _, _, tparams = tiered
    plain, spec = _pair(tparams, mode, temperature)
    for prompt in _prompts():
        want = plain.generate(prompt, max_new=24)
        got = spec.generate(prompt, max_new=24)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        assert got["finite"] and got["spec_rounds"] >= 1
        assert got["spec_proposed"] == 4 * got["spec_rounds"]
        assert 0.0 <= got["acceptance_rate"] <= 1.0
    if temperature > 0:
        greedy = _port(tparams, mode).generate(_prompts()[1], max_new=24)["tokens"]
        assert not np.array_equal(got["tokens"], greedy)


def test_k1_degenerate(tiered):
    _, _, tparams = tiered
    plain, spec = _pair(tparams, "all", draft_k=1)
    prompt = np.random.default_rng(4).integers(1, 100, (1, 6)).astype(np.int32)
    want = plain.generate(prompt, max_new=16)["tokens"]
    got = spec.generate(prompt, max_new=16)
    np.testing.assert_array_equal(got["tokens"], want)
    assert got["spec_rounds"] <= 15  # every round emits at least one token


def test_all_accept_when_drafter_is_verifier(pruned):
    """draft_sparsity 0: the drafter packs the verifier's own weights, every
    draft is accepted, and each round emits k + 1 tokens."""
    _, _, tparams = pruned
    plain, spec = _pair(tparams, "all", draft_sparsity=0.0)
    prompt = np.random.default_rng(5).integers(1, 100, (1, 6)).astype(np.int32)
    want = plain.generate(prompt, max_new=21)["tokens"]
    got = spec.generate(prompt, max_new=21)
    np.testing.assert_array_equal(got["tokens"], want)
    assert got["acceptance_rate"] == 1.0
    assert got["spec_rounds"] == 4  # 20 decode tokens / (k + 1) = 5 per round


def test_mostly_reject_still_bit_identical(pruned):
    """Random-init magnitude tiers carry no structure: a 99 %-sparse drafter
    is mostly wrong, and the tokens are still plain decode's."""
    _, _, tparams = pruned
    plain, spec = _pair(tparams, "all")
    prompt = np.random.default_rng(6).integers(1, 100, (1, 6)).astype(np.int32)
    want = plain.generate(prompt, max_new=20)["tokens"]
    got = spec.generate(prompt, max_new=20)
    np.testing.assert_array_equal(got["tokens"], want)
    assert got["acceptance_rate"] <= 0.3


@pytest.mark.parametrize("bad", [
    {"draft_k": 0}, {"draft_sparsity": 1.0}, {"draft_sparsity": -0.1}, {"fused": False},
])
def test_serve_config_refuses_what_the_reference_refuses(bad):
    kw = {"speculative": True, **bad}
    with pytest.raises(ValueError) as ref_err:
        RefServeConfig(**kw)
    with pytest.raises(ValueError) as port_err:
        ServeConfig(**kw)
    assert str(port_err.value) == str(ref_err.value)
    ServeConfig(**{**kw, "speculative": False})  # only speculative decoding checks them


def test_spec_guards(pruned):
    _, _, tparams = pruned
    eng = _port(tparams, "all", speculative=True)
    with pytest.raises(ValueError, match="B=1"):
        eng.generate(np.ones((2, 6), np.int32), max_new=4)
    # 6 + 87 fits max_len 96 without the draft_k = 4 rows of headroom, not with them
    with pytest.raises(ValueError, match="spec headroom"):
        eng.generate(np.ones((1, 6), np.int32), max_new=87)
    assert np.isnan(acceptance_rate(0, 0))
    assert acceptance_rate(3, 4) == 0.75
    out = _port(tparams, "all").generate(np.ones((1, 6), np.int32), max_new=4)
    assert "acceptance_rate" not in out


def test_eager_loop_equals_fused_on_cpu(pruned):
    """``fused=False`` keeps the eager loop; on the CPU ``fused=True`` runs
    the same step eagerly, so both give the same sampled tokens."""
    _, _, tparams = pruned
    prompts = np.random.default_rng(0).integers(1, 512, (2, 6)).astype(np.int32)
    a = _port(tparams, "all", temperature=1.0).generate(prompts, max_new=8)
    b = _port(tparams, "all", temperature=1.0, fused=False).generate(prompts, max_new=8)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert ServeConfig().fused is True
