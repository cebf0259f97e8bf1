"""Port vs reference: the performance flags (``models/opt_flags.py``) and
every baseline route they select.

Each flag with a numeric path runs on both sides with the same setting,
the whole baseline (``set_baseline``) and the whole optimised profile
(``set_opt``), at smoke size:

* ``flash_custom_vjp`` / ``xent_lse`` / ``attn_bf16_probs``: loss within
  1e-5 and gradients within 1e-4 of the largest with the baseline (fp32
  throughout, autodiff through the chunked forward on both sides) and
  within 5e-3 with the optimised profile (the hand-written backward's bf16
  rounding points, ``tests/test_torch_train.py``'s bound);
* ``decode_direct``: decode logits within 1e-5 (dense), and within 1e-4 on
  the hybrid's ring under its local window (``tests/test_torch_hybrid.py``'s
  bound: the scan order, amplified as ROADMAP C6 says);
* ``moe_sort_positions`` / ``moe_shard_capacity``: each MoE layer within
  1e-5, at a capacity that drops assignments and at a dropless one;
* ``ssd_small_chunk``: the SSD forward within 1e-5 with ``ssm_chunk`` 128.

The reference runs without ``jax.jit`` here, or jitted through a new
function object: its flags are read while tracing, and a jit cache keyed
on an equal model would replay a trace made under the other setting.  Within the port, the baseline and the optimised
profile agree within bf16 rounding (2e-2 of the largest, the reference's
``test_bf16_probs_precision`` bound), and the two flags with nothing to
change here are bitwise on and off.  Every test leaves both packages'
flags as it found them.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import opt_flags as ref_flags
from repro_torch.models import layers, opt_flags
from repro_torch.optim.adamw import tree_items
from torch_family_pairs import Pair, close, np_, ref_leaf


@pytest.fixture(autouse=True)
def restore_flags():
    saved = dict(opt_flags.FLAGS), dict(ref_flags.FLAGS)
    yield
    opt_flags.FLAGS.update(saved[0])
    ref_flags.FLAGS.update(saved[1])
    assert opt_flags.FLAGS == saved[0] and ref_flags.FLAGS == saved[1]


def _variant(name: str, **over) -> None:
    for mod in (opt_flags, ref_flags):
        (mod.set_baseline if name == "baseline" else mod.set_opt)()
        mod.FLAGS.update(over)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def test_flags_are_the_references():
    assert opt_flags.FLAGS == ref_flags.FLAGS
    assert list(opt_flags.FLAGS) == list(ref_flags.FLAGS)
    assert layers.FLAGS is opt_flags.FLAGS
    opt_flags.set_baseline()
    assert not any(opt_flags.FLAGS.values())
    opt_flags.set_opt()
    assert opt_flags.FLAGS == ref_flags._OPT_PROFILE


@pytest.mark.parametrize("variant,grad_tol", [("baseline", 1e-4), ("opt", 5e-3)])
def test_loss_and_grads_match_reference(variant, grad_tol, monkeypatch):
    _variant(variant)
    pair = Pair("llama3_2_1b")
    tokens = _tokens(pair.cfg, 2, 24)
    custom = []
    apply = layers._FlashAttention.apply
    monkeypatch.setattr(layers._FlashAttention, "apply",
                        lambda *a: custom.append(1) or apply(*a))
    want_loss, want_g = jax.jit(jax.value_and_grad(lambda p, b: pair.ref_model.loss(p, b)))(
        pair.params, {"tokens": jnp.asarray(tokens)})
    for _, leaf in tree_items(pair.tparams):
        leaf.requires_grad_(True)
    loss = pair.model.loss(pair.tparams, {"tokens": torch.from_numpy(tokens).long()})
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    loss.backward()
    assert bool(custom) == (variant == "opt")  # the hand-written backward, or autograd
    for path, w in jax.tree_util.tree_flatten_with_path(want_g)[0]:
        name = "/".join(k.key for k in path)
        close(ref_leaf(pair.tparams, name).grad, w, name, grad_tol)


@pytest.mark.parametrize("xent_lse", [False, True])
def test_cross_entropy_routes_match_reference(xent_lse):
    """``xent_lse`` alone, on logits whose log-softmax loses digits in bf16."""
    from repro.models.families import _xent as ref_xent
    from repro_torch.models.families import _xent

    _variant("opt", xent_lse=xent_lse)
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(3, 7, 50)) * 8).astype(np.float32)
    labels = rng.integers(0, 56, (3, 7)).astype(np.int32)  # ids >= 50 are padding
    want = ref_xent(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels), 50)
    got = _xent(torch.from_numpy(logits).to(torch.bfloat16), torch.from_numpy(labels), 50)
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def _decode_both(pair, tokens, cache, ref_cache, tol=1e-5):
    # a new function object: its own jit cache, traced under the flags set now
    step = jax.jit(lambda p, t, c: pair.ref_model.decode_step(p, t, c))
    out = []
    for t in range(tokens.shape[1]):
        tok = tokens[:, t : t + 1]
        want, ref_cache = step(pair.params, jnp.asarray(tok), ref_cache)
        got, cache = pair.model.decode_step(pair.tparams, torch.from_numpy(tok).long(), cache)
        close(got, want, f"step {t}", tol)
        out.append(got)
    return torch.cat(out, 1)


@pytest.mark.parametrize("variant", ["baseline", "opt"])
def test_dense_decode_matches_reference(variant):
    _variant(variant)
    pair = Pair("llama3_2_1b")
    prompt = _tokens(pair.cfg, 2, 9, seed=2)
    want, ref_cache = pair.ref_model.prefill(pair.params, {"tokens": jnp.asarray(prompt)}, 24)
    got, cache = pair.model.prefill(pair.tparams, {"tokens": torch.from_numpy(prompt).long()}, 24)
    close(got, want, "prefill")
    _decode_both(pair, _tokens(pair.cfg, 2, 4, seed=3), cache, ref_cache)


@pytest.mark.parametrize("variant", ["baseline", "opt"])
def test_ring_decode_matches_reference(variant):
    """The hybrid's local attention on a ring cache that wraps (the
    ``decode_direct`` site with a window)."""
    _variant(variant)
    pair = Pair("recurrentgemma_9b")
    tokens = _tokens(pair.cfg, 2, pair.cfg.local_window + 5, seed=4)
    max_len = pair.cfg.local_window
    _decode_both(pair, tokens, pair.model.init_cache(2, max_len, device="cpu"),
                 pair.ref_model.init_cache(2, max_len), tol=1e-4)


@pytest.mark.parametrize("sort,shard_cap", list(itertools.product([False, True], repeat=2)))
@pytest.mark.parametrize("cf", [0.25, 4.0])
def test_moe_routes_match_reference(sort, shard_cap, cf):
    """One MoE layer on seeded inputs, at a capacity that drops assignments
    (0.25) and a dropless one (4.0).  A layer and not the whole forward:
    ``moe_shard_capacity`` widens the reference's expert products from
    cap + 1 to cap + 256 rows, whose XLA products round differently in the
    last bit, and a routing near-tie in the next layer turns that into a
    different expert choice (6.7e-4 of the logits at the smoke config)."""
    from repro.models import layers as ref_layers

    _variant("opt", moe_sort_positions=sort, moe_shard_capacity=shard_cap)
    pair = Pair("olmoe_1b_7b")
    x = np.random.default_rng(5).standard_normal((2, 16, pair.cfg.d_model)).astype(np.float32)
    for layer in range(pair.cfg.n_layers):
        lp_ref = jax.tree_util.tree_map(lambda v: v[layer], pair.params["layers"]["ffn"])
        lp = {k: v[layer] for k, v in pair.tparams["layers"]["ffn"].items()}
        want, want_aux = ref_layers.moe(lp_ref, jnp.asarray(x), pair.ref_cfg, capacity_factor=cf)
        got, aux = layers.moe(lp, torch.from_numpy(x), pair.cfg, capacity_factor=cf)
        close(got, want, f"layer {layer}")
        assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)


@pytest.mark.parametrize("small", [False, True])
def test_ssd_chunk_routes_match_reference(small):
    _variant("opt", ssd_small_chunk=small)
    pair = Pair("mamba2_2_7b", ssm_chunk=128)
    tokens = _tokens(pair.cfg, 2, 200, seed=6)  # 2 chunks of 128, or 4 of 64
    want, _ = pair.ref_model.forward(pair.params, {"tokens": jnp.asarray(tokens)})
    got, _ = pair.model.forward(pair.tparams, {"tokens": torch.from_numpy(tokens).long()})
    close(got, want, "logits")


def test_port_baseline_within_bf16_rounding_of_opt():
    pair = Pair("llama3_2_1b")
    tokens = torch.from_numpy(_tokens(pair.cfg, 2, 20, seed=7)).long()
    out = {}
    for variant in ("baseline", "opt"):
        _variant(variant)
        fwd, _ = pair.model.forward(pair.tparams, {"tokens": tokens})
        _, cache = pair.model.prefill(pair.tparams, {"tokens": tokens[:, :12]}, 20)
        dec = torch.cat([pair.model.decode_step(pair.tparams, tokens[:, t : t + 1], cache)[0]
                         for t in range(12, 20)], 1)
        out[variant] = fwd, dec
    for ref, got in zip(out["opt"], out["baseline"]):
        err = float((got - ref).abs().max())
        assert 0 < err < 0.02 * max(float(ref.abs().max()), 1.0), err


def test_shard_capacity_and_seq_shard_change_nothing_here():
    """``moe_shard_capacity`` at a dropless capacity (its rounding drops
    nothing either way) and ``attn_seq_shard`` with no mesh are bitwise on
    and off; at a capacity that binds, the rounded capacity keeps more."""
    moe = Pair("olmoe_1b_7b")
    tokens = torch.from_numpy(_tokens(moe.cfg, 2, 16, seed=8)).long()
    dropless = moe.cfg.n_experts / moe.cfg.top_k
    outs = {}
    for on in (False, True):
        _variant("opt", moe_shard_capacity=on, attn_seq_shard=on)
        p = moe.tparams["layers"]
        lp = {k: v[0] for k, v in p["ffn"].items()}
        x = torch.randn(2, 16, moe.cfg.d_model, generator=torch.Generator().manual_seed(0))
        outs[on] = (layers.moe(lp, x, moe.cfg, capacity_factor=dropless)[0],
                    layers.moe(lp, x, moe.cfg, capacity_factor=0.25)[0],
                    moe.model.prefill(moe.tparams, {"tokens": tokens}, 16)[0])
    assert torch.equal(outs[False][0], outs[True][0])
    assert not torch.equal(outs[False][1], outs[True][1])
    assert torch.equal(outs[False][2], outs[True][2])
    assert np_(outs[True][1]).any()
