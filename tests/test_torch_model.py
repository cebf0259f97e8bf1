"""Port vs reference: the dense LM, dense and VUSA-packed.

Parameters come from ``repro``'s ``build_model(cfg).init(key(0))``, cross to
the port as numpy through ``convert.params_from_numpy``, and both packages
run the same inputs.  Forward, prefill (with and without ``lengths``), eight
decode steps and the packed decode step must agree to 1e-5 of the largest
magnitude compared (fp32 configs: the same arithmetic, only the summation
order differs, so rounding scales with the terms summed).  ``vusa_edge`` covers the
untied head; ``llama3_2_1b`` covers GQA and tied embeddings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.core.pruning import prune_tree as ref_prune
from repro.models import build_model as ref_build
from repro.serve import packed as ref_packed
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import build_model
from repro_torch.serve import packed

ARCHS = ["vusa_edge", "llama3_2_1b"]


def _close(got, want, what=""):
    """max |got - want| <= 1e-5 * max(|want|, 1)."""
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * max(float(np.abs(want).max()), 1.0), (what, err)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    cfg = ref_smoke(arch)
    params = ref_build(cfg).init(jax.random.key(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return arch, cfg, params, params_from_numpy(tree, "cpu")


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def test_config_and_params_roundtrip(pair):
    arch, cfg, params, tparams = pair
    assert get_smoke_config(arch).__dict__ == cfg.__dict__
    back = params_to_numpy(tparams)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert set(build_model(get_smoke_config(arch)).specs()) == set(params)


def test_forward_matches(pair):
    arch, cfg, params, tparams = pair
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 12)).astype(np.int32)
    want, _ = ref_build(cfg).forward(params, {"tokens": jnp.asarray(tokens)})
    got, aux = build_model(get_smoke_config(arch))(tparams, {"tokens": torch.from_numpy(tokens).long()})
    assert aux == 0.0
    _close(got, want)


@pytest.mark.parametrize("use_lengths", [False, True])
def test_prefill_and_eight_decode_steps_match(pair, use_lengths):
    arch, cfg, params, tparams = pair
    rng = np.random.default_rng(1)
    b, s, max_len = 3, 10, 24
    tokens = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    lengths = np.array([10, 7, 4], np.int32) if use_lengths else None
    ref_m, m = ref_build(cfg), build_model(get_smoke_config(arch))
    want_logits, ref_cache = ref_m.prefill(
        params, {"tokens": jnp.asarray(tokens)}, max_len,
        lengths=None if lengths is None else jnp.asarray(lengths),
    )
    got_logits, cache = m.prefill(
        tparams, {"tokens": torch.from_numpy(tokens).long()}, max_len,
        lengths=None if lengths is None else torch.from_numpy(lengths).long(),
    )
    _close(got_logits, want_logits)
    for name in ("k", "v"):
        _close(cache[name], ref_cache[name])
    assert cache["pos"].ndim == 0 and cache["pos"].dtype == torch.long
    assert int(cache["pos"]) == int(ref_cache["pos"]) == s
    if use_lengths:
        return  # decode after masked prefill needs per-row pos (the scheduler's job)
    ref_step = jax.jit(ref_m.decode_step)
    for step in range(8):
        tok = rng.integers(0, cfg.vocab, size=(b, 1)).astype(np.int32)
        want, ref_cache = ref_step(params, jnp.asarray(tok), ref_cache)
        got, cache = m.decode_step(tparams, torch.from_numpy(tok).long(), cache)
        _close(got, want, f"step {step}")
    assert int(cache["pos"]) == int(ref_cache["pos"]) == s + 8


@pytest.mark.parametrize("scope", ["mlp", "all"])
def test_packed_decode_step_matches_reference(pair, scope):
    """Packed-step logits equal ``repro.serve.packed.lm_decode_step_packed``
    (Pallas kernels in interpret mode) and the port's own dense step."""
    arch, cfg, params, _ = pair
    params = ref_prune(params, 0.85)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    tcfg = get_smoke_config(arch)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab, size=(2, 6)).astype(np.int32)
    ref_pack = ref_packed.pack_lm_weights(cfg, params, scope=scope)
    pack = packed.pack_lm_weights(tcfg, tparams, scope=scope)
    assert packed.packed_byte_ratios(pack) == ref_packed.packed_byte_ratios(ref_pack)
    _, ref_cache = ref_build(cfg).prefill(params, {"tokens": jnp.asarray(tokens)}, 16)
    m = build_model(tcfg)
    _, cache = m.prefill(tparams, {"tokens": torch.from_numpy(tokens).long()}, 16)
    _, dense_cache = m.prefill(tparams, {"tokens": torch.from_numpy(tokens).long()}, 16)
    for step in range(2):
        tok = rng.integers(0, cfg.vocab, size=(2, 1)).astype(np.int32)
        want, ref_cache = ref_packed.lm_decode_step_packed(
            params, ref_pack, jnp.asarray(tok), ref_cache, cfg
        )
        got, cache = packed.lm_decode_step_packed(
            tparams, pack, torch.from_numpy(tok).long(), cache, tcfg
        )
        dense, dense_cache = m.decode_step(tparams, torch.from_numpy(tok).long(), dense_cache)
        _close(got, want, f"step {step}")
        _close(got, _np(dense), f"step {step}")


def test_multi_token_decode_is_not_ported_yet(pair):
    """Multi-token decode (the speculative verify), once refused, now runs:
    two tokens in one call give the logits and cache of two single-token
    calls, bitwise (the dense path chains single-token steps)."""
    arch, _, _, tparams = pair
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    toks = torch.tensor([[3, 5]])
    multi, cache = model.decode_step(tparams, toks, model.init_cache(1, 8, device="cpu"))
    seq_cache = model.init_cache(1, 8, device="cpu")
    seq = torch.cat([model.decode_step(tparams, toks[:, i : i + 1], seq_cache)[0]
                     for i in range(2)], dim=1)
    assert torch.equal(multi, seq) and torch.equal(cache["k"], seq_cache["k"])
    assert int(cache["pos"]) == 2
