"""Port vs reference: the dense family's qkv-bias, qk-norm and tied-head
options (``internlm2_1_8b``, ``qwen2_0_5b``: qkv bias and a tied head,
``qwen3_8b``: qk norm), dense and VUSA-packed.

Smoke configs; parameters from ``repro`` with the biases and norm scales
drawn from a seed (``torch_family_pairs``), both sides with
``attn_bf16_probs`` off, as the reference's model tests run.  Forward,
prefill (with and without ``lengths``), eight decode steps and the packed
decode step (scope mlp/all, fp32/int8/int4 values, Pallas kernels in
interpret mode on the reference side) agree to 1e-5 of the largest
magnitude.  Within the port: the pool step's rows (``rowwise``) are bitwise
B = 1 steps and within 1e-5 of the batched step; the packed speculative
verify is bitwise the chain of single steps; speculative ``generate`` is
bitwise plain ``generate``.  The row plan's workspace at the untied heads of
the full-size ``qwen3_8b`` and ``internlm2_1_8b`` is what the wrapper
allocates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pruning import prune_tree as ref_prune
from repro.serve import packed as ref_packed
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import row_plan
from repro_torch.serve import Engine, ServeConfig, packed
from torch_family_pairs import Pair, close, fp32_attention_probs, np_  # noqa: F401

pytestmark = pytest.mark.usefixtures("fp32_attention_probs")

ARCHS = ["internlm2_1_8b", "qwen2_0_5b", "qwen3_8b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return Pair(request.param)


@pytest.fixture(scope="module")
def pruned(pair):
    """The pair pruned to 85 % on the reference side, crossed to the port."""
    params = ref_prune(pair.params, 0.85)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return params, params_from_numpy(tree, "cpu")


def test_config_and_params_roundtrip(pair):
    assert pair.cfg.__dict__ == pair.ref_cfg.__dict__
    spec = pair.model.specs()
    flat = jax.tree_util.tree_flatten_with_path(pair.params)[0]
    for path, leaf in flat:
        node = spec
        for key in path:
            node = node[key.key]
        assert node.shape == leaf.shape, path
    assert set(spec["layers"]["attn"]) == set(pair.params["layers"]["attn"])
    opts = {"qwen2_0_5b": {"bq", "bk", "bv"}, "qwen3_8b": {"q_norm", "k_norm"}}
    assert opts.get(pair.arch, set()) == set(spec["layers"]["attn"]) - {"wq", "wk", "wv", "wo"}
    assert ("lm_head" in spec) == (pair.arch != "qwen2_0_5b")
    for name in ("bq", "q_norm"):  # the perturbed leaves are not zero any more
        if name in pair.tparams["layers"]["attn"]:
            assert float(pair.tparams["layers"]["attn"][name].abs().min()) > 0


def test_forward_matches(pair):
    tokens = np.random.default_rng(0).integers(0, pair.cfg.vocab, (2, 12)).astype(np.int32)
    want, _ = pair.ref_model.forward(pair.params, {"tokens": jnp.asarray(tokens)})
    got, aux = pair.model(pair.tparams, {"tokens": torch.from_numpy(tokens).long()})
    assert aux == 0.0
    close(got, want)


@pytest.mark.parametrize("use_lengths", [False, True])
def test_prefill_and_eight_decode_steps_match(pair, use_lengths):
    rng = np.random.default_rng(1)
    b, s, max_len = 3, 10, 24
    tokens = rng.integers(0, pair.cfg.vocab, (b, s)).astype(np.int32)
    lengths = np.array([10, 7, 4], np.int32) if use_lengths else None
    want, ref_cache = pair.ref_model.prefill(
        pair.params, {"tokens": jnp.asarray(tokens)}, max_len,
        lengths=None if lengths is None else jnp.asarray(lengths))
    got, cache = pair.model.prefill(
        pair.tparams, {"tokens": torch.from_numpy(tokens).long()}, max_len,
        lengths=None if lengths is None else torch.from_numpy(lengths).long())
    close(got, want, "prefill")
    for name in ("k", "v"):
        close(cache[name], ref_cache[name], name)
    if use_lengths:
        return
    step = jax.jit(pair.ref_model.decode_step)
    for i in range(8):
        tok = rng.integers(0, pair.cfg.vocab, (b, 1)).astype(np.int32)
        want, ref_cache = step(pair.params, jnp.asarray(tok), ref_cache)
        got, cache = pair.model.decode_step(pair.tparams, torch.from_numpy(tok).long(), cache)
        close(got, want, f"step {i}")


@pytest.mark.parametrize("scope,values", [("mlp", "dense"), ("all", "dense"), ("all", "int8"),
                                          ("all", "int4")])
def test_packed_decode_step_matches_reference(pair, pruned, scope, values):
    """Packed-step logits equal ``repro``'s packed step (Pallas kernels in
    interpret mode), one step after a prefill."""
    params, tparams = pruned
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, pair.cfg.vocab, (2, 6)).astype(np.int32)
    ref_pack = ref_packed.pack_lm_weights(pair.ref_cfg, params, scope=scope, value_dtype=values)
    pack = packed.pack_lm_weights(pair.cfg, tparams, scope=scope, value_dtype=values)
    assert (pack["head"] is None) == (scope == "mlp" or pair.cfg.tie_embeddings)
    assert packed.packed_byte_ratios(pack) == ref_packed.packed_byte_ratios(ref_pack)
    _, ref_cache = pair.ref_model.prefill(params, {"tokens": jnp.asarray(tokens)}, 16)
    _, cache = pair.model.prefill(tparams, {"tokens": torch.from_numpy(tokens).long()}, 16)
    tok = rng.integers(0, pair.cfg.vocab, (2, 1)).astype(np.int32)
    want, _ = ref_packed.lm_decode_step_packed(params, ref_pack, jnp.asarray(tok), ref_cache,
                                               pair.ref_cfg)
    got, _ = packed.lm_decode_step_packed(tparams, pack, torch.from_numpy(tok).long(), cache,
                                          pair.cfg)
    close(got, want)


ROUTES = {"dense": {}, "fp32": {"packed_weights": "all"},
          "int8": {"packed_weights": "all", "packed_values": "int8"}}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_pool_step_rows_equal_b1_steps(pair, pruned, route):
    """The pool step at 3 rows (``rowwise``) on ragged caches: row b bitwise
    a B = 1 step on its own cache, and within 1e-5 of the batched step."""
    _, tparams = pruned
    eng = Engine(pair.cfg, tparams, ServeConfig(max_len=32, **ROUTES[route]), device="cpu")
    rng = np.random.default_rng(3)
    primed = [eng.prime(rng.integers(1, pair.cfg.vocab, (1, n)).astype(np.int32))
              for n in (3, 7, 5)]
    token = torch.cat([t for t, _ in primed])

    def pool():
        c = {k: torch.cat([c[k] for _, c in primed], dim=1).clone() for k in ("k", "v")}
        c["pos"] = torch.tensor([3, 7, 5])
        return c

    with torch.no_grad():
        many = eng._logits(token, pool(), eng.packed, rowwise=True)
        batched = eng._logits(token, pool(), eng.packed)
        for i, (_, c) in enumerate(primed):
            assert torch.equal(many[i : i + 1], eng._logits(token[i : i + 1], c, eng.packed))
    close(batched, np_(many))


def test_packed_verify_is_the_single_step_chain(pair, pruned):
    """The speculative verify (s = 3 tokens in one packed step) is bitwise
    three single-token steps, and matches ``repro``'s multi-token packed
    step; a tied head (qwen2) is no full pack, so the step chains."""
    params, tparams = pruned
    pack = packed.pack_lm_weights(pair.cfg, tparams, scope="all")
    ref_pack = ref_packed.pack_lm_weights(pair.ref_cfg, params, scope="all")
    assert packed._full_pack(pack) == (not pair.cfg.tie_embeddings)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, pair.cfg.vocab, (1, 5)).astype(np.int32)
    toks = rng.integers(0, pair.cfg.vocab, (1, 3)).astype(np.int32)
    _, c1 = pair.model.prefill(tparams, {"tokens": torch.from_numpy(prompt).long()}, 16)
    _, c2 = pair.model.prefill(tparams, {"tokens": torch.from_numpy(prompt).long()}, 16)
    multi, c1 = packed.lm_decode_step_packed(tparams, pack, torch.from_numpy(toks).long(), c1,
                                             pair.cfg)
    seq = torch.cat([packed.lm_decode_step_packed(tparams, pack, torch.from_numpy(
        toks[:, i : i + 1]).long(), c2, pair.cfg)[0] for i in range(3)], dim=1)
    assert torch.equal(multi, seq) and torch.equal(c1["k"], c2["k"])
    _, rc = pair.ref_model.prefill(params, {"tokens": jnp.asarray(prompt)}, 16)
    want, _ = ref_packed.lm_decode_step_packed(params, ref_pack, jnp.asarray(toks), rc,
                                               pair.ref_cfg)
    close(multi, want)


def test_speculative_generate_is_plain_generate(pair, pruned):
    _, tparams = pruned
    prompt = np.random.default_rng(5).integers(1, pair.cfg.vocab, (1, 6)).astype(np.int32)
    plain = Engine(pair.cfg, tparams, ServeConfig(max_len=24, packed_weights="all"),
                   device="cpu").generate(prompt, max_new=8)
    spec = Engine(pair.cfg, tparams, ServeConfig(max_len=24, packed_weights="all",
                                                 speculative=True, draft_k=3),
                  device="cpu").generate(prompt, max_new=8)
    np.testing.assert_array_equal(spec["tokens"], plain["tokens"])
    assert spec["spec_rounds"] >= 1


@pytest.mark.parametrize("arch,ncols", [("qwen3_8b", 152064), ("internlm2_1_8b", 92672)])
def test_row_plan_workspace_at_the_untied_heads(arch, ncols):
    """At the full-size untied heads one BT-row tile's fp32 partials exceed
    ``WORKSPACE_BYTES`` (311 MB at qwen3's, 95 MB at internlm2's): a launch
    then takes one tile, and ``workspace_bytes`` is what the wrapper
    allocates for it, never more rows than the call has."""
    cfg = get_config(arch)
    k = cfg.d_model
    assert -(-cfg.padded_vocab // 128) * 128 == ncols
    p = row_plan.row_plan(k)
    assert p.slices == k // row_plan.ROWS
    tile = p.slices * row_plan.BT * ncols * 4
    assert tile > row_plan.WORKSPACE_BYTES
    assert row_plan.tile_bytes(p, ncols) == tile
    for b in (1, 4, 5, 8, 40):
        chunks = row_plan.row_chunks(p, b, ncols)
        assert chunks == [(r, min(r + row_plan.BT, b)) for r in range(0, b, row_plan.BT)]
        assert row_plan.workspace_bytes(p, b, ncols) == p.slices * min(b, row_plan.BT) * ncols * 4
        assert row_plan.cuda_launches(p, b, ncols) == 2 * len(chunks)
    # a shape whose tile fits keeps the cap: vusa_edge's head, 12 slices x 32000 columns
    p = row_plan.row_plan(768)
    assert row_plan.workspace_bytes(p, 4096, 32000) <= row_plan.WORKSPACE_BYTES


@pytest.mark.parametrize("value_dtype", ["dense", "int8", "int4"])
def test_window_sliced_packing_is_pack_rows(monkeypatch, value_dtype):
    """The host packer's window slices, packed in threads and merged, give
    ``pack_rows``'s pack byte for byte (slices of 2 windows here, a partial
    last window, an empty window, a transposed stack)."""
    from repro_torch.core.packing import pack_rows, pack_rows_t
    from repro_torch.kernels import ops

    monkeypatch.setattr(ops, "JOB_ENTRIES", 2 * 128 * 40)
    rng = np.random.default_rng(6)
    w = rng.standard_normal((2, 40, 700)).astype(np.float32)
    w *= rng.random(w.shape) >= 0.85
    w[1, :, 300:420] = 0.0
    tw = torch.from_numpy(w)
    assert len(ops._window_slices(40, 700, 128)) == 3
    assert len(ops._window_slices(700, 40, 128)) == 1
    for transposed, packer in ((False, pack_rows), (True, pack_rows_t)):
        got = packed._stack_layers(tw, 128, 16, transposed, value_dtype)
        want = packed._stack_packs([ops.linear_from_pack(packer(w[i], m=128, a=16), tw.dtype,
                                                         "cpu", value_dtype, 4)
                                    for i in range(2)])
        for key in ("values", "positions", "scales"):
            if want.get(key) is not None:
                assert torch.equal(got[key], want[key]), (transposed, key)


@pytest.mark.parametrize("family", ["hybrid", "ssm", "encdec"])
def test_unported_families_are_refused_naming_a13(family):
    """The three families A13 ported last build now and are named in the
    refusal of a family that is none of the reference's."""
    import dataclasses

    from repro_torch.models import build_model

    arch = {"hybrid": "recurrentgemma_9b", "ssm": "mamba2_2_7b", "encdec": "whisper_tiny"}
    assert build_model(get_config(arch[family])).cfg.family == family
    cfg = dataclasses.replace(get_config("qwen2_0_5b"), family=f"{family}_v2")
    with pytest.raises(NotImplementedError, match="A13") as err:
        build_model(cfg)
    assert f"'{family}'" in str(err.value)
