"""Port vs reference: the serving engine on the main path.

The ``vusa_pruned`` params of ``tests/test_faults.py`` (the ``vusa_edge``
smoke config, ``repro`` init at ``key(0)``, magnitude-pruned to 85 %) serve
through both engines.  Greedy tokens must be identical across frameworks for
dense, ``"mlp"`` and ``"all"`` packing (fp32 smoke config), and within the
port packed must equal dense and the three-call MLP the fused one.  Sampled
tokens cannot cross frameworks (different generators), so the port only has
to repeat itself for a seed.
"""

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as ref_smoke
from repro.core.pruning import prune_tree as ref_prune
from repro.models import build_model as ref_build
from repro.serve import Engine as RefEngine
from repro.serve import ServeConfig as RefServeConfig
from repro.serve.packed import packed_byte_ratios as ref_byte_ratios
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.packed import packed_byte_ratios, validate_packed

MAX_NEW = 8


@pytest.fixture(scope="module")
def vusa_pruned():
    cfg = ref_smoke("vusa_edge")
    params = ref_prune(ref_build(cfg).init(jax.random.key(0)), 0.85)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    prompts = np.random.default_rng(0).integers(1, cfg.vocab, size=(2, 6)).astype(np.int32)
    return cfg, params, tparams, prompts


def _port(tparams, packed, **kw):
    sc = ServeConfig(max_len=24, packed_weights=packed, **kw)
    return Engine(get_smoke_config("vusa_edge"), tparams, sc, device="cpu")


@pytest.mark.parametrize("packed", [False, "mlp", "all"])
def test_greedy_tokens_match_reference(vusa_pruned, packed):
    cfg, params, tparams, prompts = vusa_pruned
    ref_eng = RefEngine(cfg, params, RefServeConfig(max_len=24, packed_weights=packed))
    want = ref_eng.generate(prompts, max_new=MAX_NEW)
    eng = _port(tparams, packed)
    got = eng.generate(prompts, max_new=MAX_NEW)
    assert got["finite"] and want["finite"]
    assert got["tokens"].shape == (2, MAX_NEW) and got["tokens"].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    if packed:
        assert packed_byte_ratios(eng.packed) == ref_byte_ratios(ref_eng._packed)


def test_packed_equals_dense_and_unfused_equals_fused(vusa_pruned):
    _, _, tparams, prompts = vusa_pruned
    dense = _port(tparams, False).generate(prompts, max_new=MAX_NEW)["tokens"]
    fused = _port(tparams, "all").generate(prompts, max_new=MAX_NEW)["tokens"]
    unfused_eng = _port(tparams, "all", fused_mlp=False)
    assert "w_down" in unfused_eng.packed["mlp"] and "w_down_t" not in unfused_eng.packed["mlp"]
    unfused = unfused_eng.generate(prompts, max_new=MAX_NEW)["tokens"]
    np.testing.assert_array_equal(fused, dense)
    np.testing.assert_array_equal(unfused, fused)


def test_byte_ratios_match_reference_three_call_layout(vusa_pruned):
    cfg, params, tparams, _ = vusa_pruned
    from repro.serve.packed import pack_lm_weights as ref_pack
    from repro_torch.serve.packed import pack_lm_weights

    want = ref_byte_ratios(ref_pack(cfg, params, scope="all", fused_mlp=False))
    got = packed_byte_ratios(
        pack_lm_weights(get_smoke_config("vusa_edge"), tparams, scope="all", fused_mlp=False)
    )
    assert got == want


def test_max_len_guard(vusa_pruned):
    _, _, tparams, prompts = vusa_pruned
    eng = _port(tparams, "all")
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.generate(prompts, max_new=24 - prompts.shape[1] + 1)
    with pytest.raises(ValueError, match="outside"):
        eng.generate(np.full((1, 4), 10**6, np.int32), max_new=2)
    with pytest.raises(ValueError, match="packed_weights"):
        ServeConfig(packed_weights="attn")
    with pytest.raises(ValueError, match="packed_weights"):
        ServeConfig(packed_weights=True)


def test_seeded_sampling_repeats(vusa_pruned):
    _, _, tparams, prompts = vusa_pruned
    runs = [
        _port(tparams, "all", temperature=1.0, seed=seed).generate(prompts, max_new=MAX_NEW)
        for seed in (3, 3, 4)
    ]
    np.testing.assert_array_equal(runs[0]["tokens"], runs[1]["tokens"])
    assert not np.array_equal(runs[0]["tokens"], runs[2]["tokens"])
    assert all(r["finite"] for r in runs)
    greedy = _port(tparams, "all").generate(prompts, max_new=MAX_NEW)["tokens"]
    assert not np.array_equal(runs[0]["tokens"], greedy)


def test_validate_packed_rejects_corruption(vusa_pruned):
    """A flipped position byte or a non-finite value is refused before serving."""
    _, _, tparams, _ = vusa_pruned
    eng = _port(tparams, "all")
    validate_packed(eng.packed)
    q = eng.packed["attn"]["wq"]["positions"]
    saved = q[0, 0, 3, 0].item()
    q[0, 0, 3, 0] = -5
    with pytest.raises(ValueError, match="wq: position -5 .* corrupt metadata"):
        validate_packed(eng.packed)
    q[0, 0, 3, 0] = saved
    eng.packed["head"]["values"][1, 2, 0] = float("nan")
    with pytest.raises(ValueError, match="lm_head: non-finite"):
        validate_packed(eng.packed)
