"""Port vs reference: the int8/int4 packed decode path of ``vusa_edge``.

The ``vusa_pruned`` params of ``tests/test_torch_engine.py`` (the
``vusa_edge`` smoke config, ``repro`` init at ``key(0)``, magnitude-pruned to
85 %) are packed and served by both packages with quantized values.  The
packs (values, positions, scales), their byte ratios and the
quantize-dequantize oracle ``qdq_lm_params`` must equal ``repro``'s exactly;
int8 greedy tokens must equal both the port's dense engine on
``qdq_lm_params`` and ``repro``'s int8 engine, and first-step logits must lie
within 1e-4 of the largest logit of ``repro``'s (fp32 smoke config: the same
``q * scale`` values, only the summation order differs).

The quantized engine prefills dense, on the unquantized weights, while the
oracle prefills on the qdq weights, so the decode paths are also compared
from one primed cache.
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
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import build_model
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve import packed

MAX_NEW = 8
MAX_LEN = 24
QDTYPES = ["int8", "int4"]


@pytest.fixture(scope="module")
def vusa_pruned():
    cfg = ref_smoke("vusa_edge")
    params = ref_prune(ref_build(cfg).init(jax.random.key(0)), 0.85)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    prompts = np.random.default_rng(0).integers(1, cfg.vocab, size=(2, 6)).astype(np.int32)
    return cfg, params, tparams, prompts


def _port(tparams, **kw):
    sc = ServeConfig(max_len=MAX_LEN, **kw)
    return Engine(get_smoke_config("vusa_edge"), tparams, sc, device="cpu")


def _ref_flat(p):
    return ref_packed._flat_entries(p)


# ---------------------------------------------------------------------------
# the pack, its byte ratios and the qdq oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", QDTYPES)
@pytest.mark.parametrize("fused_mlp", [True, False])
def test_quantized_pack_matches_reference(vusa_pruned, dt, fused_mlp):
    cfg, params, tparams, _ = vusa_pruned
    want = ref_packed.pack_lm_weights(cfg, params, scope="all", fused_mlp=fused_mlp,
                                      value_dtype=dt)
    got = packed.pack_lm_weights(get_smoke_config("vusa_edge"), tparams, scope="all",
                                 fused_mlp=fused_mlp, value_dtype=dt)
    gflat, wflat = packed._flat_entries(got), _ref_flat(want)
    assert sorted(gflat) == sorted(wflat)
    for name, w in wflat.items():
        g = gflat[name]
        for key in ("k", "c", "m", "a", "value_dtype", "dense_itemsize"):
            assert g[key] == w[key], (name, key)
        for leaf in ("values", "positions", "scales"):
            gv, wv = g[leaf].numpy(), np.asarray(w[leaf])
            assert gv.dtype == wv.dtype and gv.shape == wv.shape, (name, leaf)
            assert gv.tobytes() == wv.tobytes(), (name, leaf)
    assert packed.packed_byte_ratios(got) == ref_packed.packed_byte_ratios(want)


@pytest.mark.parametrize("dt,ceiling", [("int8", 0.25), ("int4", 0.15)])
def test_quantized_byte_ratio_ceilings(vusa_pruned, dt, ceiling):
    """The reference's budget at 85 % sparsity: int8 total <= 0.25 of the
    dense bytes, int4 <= 0.15, both below the float-value pack."""
    _, _, tparams, _ = vusa_pruned
    cfg = get_smoke_config("vusa_edge")
    ratios = packed.packed_byte_ratios(packed.pack_lm_weights(cfg, tparams, value_dtype=dt))
    assert ratios["total"] <= ceiling, ratios
    dense = packed.packed_byte_ratios(packed.pack_lm_weights(cfg, tparams))
    assert ratios["total"] < dense["total"]


@pytest.mark.parametrize("dt", QDTYPES)
@pytest.mark.parametrize("fused_mlp", [True, False])
def test_qdq_lm_params_match_reference(vusa_pruned, dt, fused_mlp):
    cfg, params, tparams, _ = vusa_pruned
    want = ref_packed.qdq_lm_params(cfg, params, fused_mlp=fused_mlp, value_dtype=dt)
    got = params_to_numpy(packed.qdq_lm_params(get_smoke_config("vusa_edge"), tparams,
                                               fused_mlp=fused_mlp, value_dtype=dt))
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for key in path:
            node = node[key.key]
        wv = np.asarray(leaf)
        assert node.dtype == wv.dtype and node.tobytes() == wv.tobytes(), path
        n += 1
    assert n == len(jax.tree_util.tree_leaves(params))


def test_qdq_lm_params_keep_bf16(vusa_pruned):
    """bf16 params stay bf16: the qdq values round once, as the reference's
    ``astype(ws.dtype)`` does."""
    cfg, params, tparams, _ = vusa_pruned
    bf = params_from_numpy(params_to_numpy(tparams), "cpu", torch.bfloat16)
    got = packed.qdq_lm_params(get_smoke_config("vusa_edge"), bf)
    want = ref_packed.qdq_lm_params(
        cfg, jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params))
    g, w = got["layers"]["ffn"]["w_down"], np.asarray(want["layers"]["ffn"]["w_down"])
    assert g.dtype == torch.bfloat16
    np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32))


def test_validate_packed_quantized_rejections(vusa_pruned):
    _, _, tparams, _ = vusa_pruned
    base = packed.pack_lm_weights(get_smoke_config("vusa_edge"), tparams, value_dtype="int8")
    packed.validate_packed(base)

    def mutate(fn, match):
        pk = {k: (dict(v) if isinstance(v, dict) else v) for k, v in base.items()}
        e = dict(pk["mlp"]["w_gate"])
        fn(e)
        pk["mlp"]["w_gate"] = e
        with pytest.raises(ValueError, match=match):
            packed.validate_packed(pk)

    def set_scale(value):
        def fn(e):
            s = e["scales"].clone()
            s[0, 0, 0] = value
            e["scales"] = s
        return fn

    mutate(lambda e: e.pop("scales"), "missing its scales")
    mutate(lambda e: e.update(scales=e["scales"][..., :-1]), "scales shape")
    mutate(set_scale(float("nan")), "non-finite dequant scale")
    mutate(set_scale(float("inf")), "non-finite dequant scale")
    mutate(set_scale(0.0), "non-positive dequant scale")
    mutate(set_scale(-1.0), "non-positive dequant scale")
    mutate(lambda e: e.update(values=e["values"].float()), "values dtype must be int8")
    mutate(lambda e: e.update(values=e["values"][..., :-1]), "does not decode")
    mutate(lambda e: e.update(value_dtype="int4"), "does not decode")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def test_serveconfig_packed_values():
    assert ServeConfig().packed_values == "bf16"
    for v in ("bf16", "int8", "int4"):
        assert ServeConfig(packed_values=v).packed_values == v
    with pytest.raises(ValueError, match="packed_values"):
        ServeConfig(packed_values="fp8")


def test_bf16_pack_is_the_float_pack(vusa_pruned):
    """``packed_values="bf16"`` keeps the params' own dtype (no cast, no
    scales): the same pack as the default, and the dense engine's tokens."""
    cfg, _, tparams, prompts = vusa_pruned
    eng = _port(tparams, packed_weights="all", packed_values="bf16")
    default = packed.pack_lm_weights(get_smoke_config("vusa_edge"), tparams)
    for name, e in packed._flat_entries(eng.packed).items():
        assert "scales" not in e and e.get("value_dtype", "dense") == "dense"
        assert e["values"].dtype == torch.float32
        d = packed._flat_entries(default)[name]
        assert torch.equal(e["values"], d["values"]) and torch.equal(e["positions"], d["positions"])
    dense = _port(tparams).generate(prompts, max_new=MAX_NEW)["tokens"]
    np.testing.assert_array_equal(eng.generate(prompts, max_new=MAX_NEW)["tokens"], dense)


def _copy_cache(cache):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in cache.items()}


@pytest.mark.parametrize("fused_mlp", [True, False])
def test_int8_tokens_match_qdq_oracle_and_reference(vusa_pruned, fused_mlp):
    """int8 greedy tokens equal the port's dense engine on ``qdq_lm_params``
    (through ``generate``, and decoding from one primed cache) and
    ``repro``'s int8 engine."""
    cfg, params, tparams, prompts = vusa_pruned
    tcfg = get_smoke_config("vusa_edge")
    eng = _port(tparams, packed_weights="all", packed_values="int8", fused_mlp=fused_mlp)
    got = eng.generate(prompts, max_new=MAX_NEW)
    oracle = _port(packed.qdq_lm_params(tcfg, tparams, fused_mlp=fused_mlp, value_dtype="int8"))
    assert got["finite"]
    np.testing.assert_array_equal(got["tokens"],
                                  oracle.generate(prompts, max_new=MAX_NEW)["tokens"])
    tok, cache = eng.prime(prompts)
    a = eng.decode_segment(tok, _copy_cache(cache), MAX_NEW)[0]
    b = oracle.decode_segment(tok, _copy_cache(cache), MAX_NEW)[0]
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    ref_eng = RefEngine(cfg, params, RefServeConfig(
        max_len=MAX_LEN, packed_weights="all", packed_values="int8", fused_mlp=fused_mlp))
    np.testing.assert_array_equal(got["tokens"],
                                  np.asarray(ref_eng.generate(prompts, max_new=MAX_NEW)["tokens"]))


@pytest.mark.parametrize("dt", QDTYPES)
def test_first_step_logits_match_reference(vusa_pruned, dt):
    """One quantized packed decode step from the same prefill: logits within
    1e-4 of the largest logit of ``repro``'s (Pallas kernels in interpret
    mode)."""
    cfg, params, tparams, prompts = vusa_pruned
    tcfg = get_smoke_config("vusa_edge")
    want_pack = ref_packed.pack_lm_weights(cfg, params, value_dtype=dt)
    pack = packed.pack_lm_weights(tcfg, tparams, value_dtype=dt)
    _, ref_cache = ref_build(cfg).prefill(params, {"tokens": jnp.asarray(prompts)}, MAX_LEN)
    _, cache = build_model(tcfg).prefill(tparams, {"tokens": torch.from_numpy(prompts).long()},
                                         MAX_LEN)
    tok = np.array([[3], [7]], np.int32)
    want, _ = ref_packed.lm_decode_step_packed(params, want_pack, jnp.asarray(tok), ref_cache, cfg)
    got, _ = packed.lm_decode_step_packed(tparams, pack, torch.from_numpy(tok).long(), cache, tcfg)
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-4 * float(np.abs(want).max()), err


def test_int4_engine_serves_and_validates(vusa_pruned):
    """int4 promises no token parity with the qdq oracle (the oracle
    prefills on qdq weights); it must validate and emit finite, in-vocab
    tokens, and decode from one primed cache exactly as the oracle does."""
    cfg, _, tparams, prompts = vusa_pruned
    tcfg = get_smoke_config("vusa_edge")
    eng = _port(tparams, packed_weights="all", packed_values="int4")
    packed.validate_packed(eng.packed)
    out = eng.generate(prompts, max_new=MAX_NEW)
    assert out["finite"] and out["tokens"].shape == (2, MAX_NEW)
    assert (out["tokens"] >= 0).all() and (out["tokens"] < cfg.vocab).all()
    oracle = _port(packed.qdq_lm_params(tcfg, tparams, value_dtype="int4"))
    tok, cache = eng.prime(prompts)
    a = eng.decode_segment(tok, _copy_cache(cache), MAX_NEW)[0]
    b = oracle.decode_segment(tok, _copy_cache(cache), MAX_NEW)[0]
    np.testing.assert_array_equal(a.numpy(), b.numpy())
