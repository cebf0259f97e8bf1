"""Port vs reference: the legacy MLP-only pack (``pack_lm_mlps``: a flat
``{w_gate, w_up, w_down}`` dict, ``w_down`` in its dense orientation) and
the flat-dict branch of ``lm_decode_step_packed``, where every MLP runs
three row-packed products (B1) and no fused MLP (B2).

Parameters are the reference's smoke ``vusa_edge`` init at ``key(0)``,
magnitude-pruned to 85 %, crossed as numpy.  Logits agree within 1e-5 of
the largest (fp32 on both sides, only the summation order differs, as in
``tests/test_torch_model.py``); greedy tokens are equal.
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
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.serve import packed


@pytest.fixture(scope="module")
def pruned():
    cfg = ref_smoke("vusa_edge")
    params = ref_prune(ref_build(cfg).init(jax.random.key(0)), 0.85)
    return cfg, params, params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * max(float(np.abs(want).max()), 1.0), err


@pytest.mark.parametrize("a", [16, 8])
def test_pack_lm_mlps_byte_identical(pruned, a):
    cfg, params, tparams = pruned
    want = ref_packed.pack_lm_mlps(cfg, params, m=128, a=a)
    got = packed.pack_lm_mlps(get_smoke_config("vusa_edge"), tparams, m=128, a=a)
    assert set(got) == set(want) == {"w_gate", "w_up", "w_down"}
    for name, e in want.items():
        g = got[name]
        assert {k: g[k] for k in ("k", "c", "m", "a")} == {k: e[k] for k in ("k", "c", "m", "a")}
        assert g["a"] == a and g["values"].shape[-1] % a == 0
        for leaf in ("values", "positions"):
            assert g[leaf].numpy().tobytes() == np.asarray(e[leaf]).tobytes(), (name, leaf)
    # w_down keeps its dense orientation: windows over d_model
    assert got["w_down"]["k"] == cfg.d_ff and got["w_down"]["c"] == cfg.d_model


def test_flat_pack_validates_and_accounts_like_reference(pruned):
    cfg, params, tparams = pruned
    want = ref_packed.pack_lm_mlps(cfg, params)
    got = packed.pack_lm_mlps(get_smoke_config("vusa_edge"), tparams)
    packed.validate_packed(got)
    assert packed.packed_byte_ratios(got) == ref_packed.packed_byte_ratios(want)
    assert packed.packed_byte_ratios(got, 2) == ref_packed.packed_byte_ratios(want, 2)
    assert packed.pack_fingerprint(got) == ref_packed.pack_fingerprint(want)
    bad = {**got, "w_up": {**got["w_up"], "positions": got["w_up"]["positions"].clone()}}
    bad["w_up"]["positions"][0, 0, 0, 0] = -5
    with pytest.raises(ValueError, match="w_up"):
        packed.validate_packed(bad)


def test_flat_pack_decode_matches_reference(pruned, monkeypatch):
    """Prefill, then four decode steps, each side fed its own greedy token:
    logits within 1e-5, tokens equal, and every layer's MLP three B1 calls
    and no B2 call."""
    cfg, params, tparams = pruned
    tcfg = get_smoke_config("vusa_edge")
    calls = {"b1": 0, "b2": 0}
    b1, b2 = ops.vusa_packed_matmul, ops.vusa_fused_mlp_matmul

    def count(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(ops, "vusa_packed_matmul", count("b1", b1))
    monkeypatch.setattr(ops, "vusa_fused_mlp_matmul", count("b2", b2))
    ref_pack = ref_packed.pack_lm_mlps(cfg, params)
    pack = packed.pack_lm_mlps(tcfg, tparams)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, size=(3, 7)).astype(np.int32)
    _, ref_cache = ref_build(cfg).prefill(params, {"tokens": jnp.asarray(tokens)}, 16)
    _, cache = build_model(tcfg).prefill(tparams, {"tokens": torch.from_numpy(tokens).long()},
                                         16)
    tok = ref_tok = tokens[:, -1:]
    for _ in range(4):
        want, ref_cache = ref_packed.lm_decode_step_packed(params, ref_pack,
                                                           jnp.asarray(ref_tok), ref_cache, cfg)
        got, cache = packed.lm_decode_step_packed(tparams, pack, torch.from_numpy(tok).long(),
                                                  cache, tcfg)
        _close(got.numpy(), want)
        tok = got[:, -1].argmax(-1, keepdim=True).numpy().astype(np.int32)
        ref_tok = np.asarray(jnp.argmax(want[:, -1], axis=-1))[:, None].astype(np.int32)
        np.testing.assert_array_equal(tok, ref_tok)
    assert calls == {"b1": 4 * 3 * cfg.n_layers, "b2": 0}
