"""Port vs reference: the hybrid family (``recurrentgemma_9b``: RG-LRU blocks
and local attention on a ring cache).

The smoke config (window 32, pattern rglru, rglru, attn) at its own 3
layers (one group, an empty tail) and at 5 (one group and a two-layer
RG-LRU tail, so both code paths run), with every zeros and ones leaf
(``conv_b``, ``b_a``, ``b_i``, ``lam``, the norms) redrawn from a seed
(``torch_family_pairs``).  Forward logits, loss and every leaf's gradient
against ``jax.grad``, each decode step's logits and cache leaves, and
greedy ``generate`` match within 1e-4 of the largest reference value: the
RG-LRU's doubling scan adds in another order than
``jax.lax.associative_scan``, and the init's wide attention weights (C6)
amplify fp32 rounding to about 1.5e-5 here.  The ring: past the window
with a 32-row ring, the port's decode reproduces its forward's local mask
within 2e-4 (``tests/test_models.py``'s check) and the reference's decode;
with ``max_len`` 16 < window the ring evicts keys the window allows, as
the reference's does.  The scheduler's completions are bitwise one-shot
``generate`` at B = 1 and its greedy tokens the reference scheduler's.  A
tree checkpoint of the nested params crosses both ways under the
reference's leaf keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.models import layers as ref_layers
from repro_torch.checkpoint import restore, save
from repro_torch.checkpoint.ckpt import _flatten
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import layers
from torch_family_pairs import (  # noqa: F401
    Pair, check_cache, check_generate_matches_reference, check_graph_decode_in_chunks,
    check_loss_and_grads, check_pool_rows, check_prime_many_refused, check_reference_scheduler,
    check_scheduler_bitwise, check_slot_roundtrip, close, decode_both, fp32_attention_probs,
    np_, port_batch, ref_batch,
)

pytestmark = pytest.mark.usefixtures("fp32_attention_probs")

TOL = 1e-4  # the scan order and C6's amplification (module docstring)


@pytest.fixture(scope="module", params=[3, 5], ids=["3_layers", "5_layers"])
def pair(request):
    return Pair("recurrentgemma_9b", n_layers=request.param)


@pytest.fixture(scope="module")
def pair5():
    return Pair("recurrentgemma_9b", n_layers=5)


def _tokens(pair, b=2, s=20, seed=0):
    return np.random.default_rng(seed).integers(0, pair.cfg.vocab, (b, s)).astype(np.int32)


def test_layout_groups_and_tail(pair):
    n = pair.cfg.n_layers
    assert pair.cfg.__dict__ == pair.ref_cfg.__dict__
    assert set(pair.tparams["groups"]) == {"p0_rglru", "p1_rglru", "p2_attn"}
    assert set(pair.tparams["tail"]) == ({"t0_rglru", "t1_rglru"} if n == 5 else set())
    assert pair.tparams["groups"]["p0_rglru"]["mixer"]["w_x"].shape[0] == 1
    specs = pair.model.cache_specs(2, 48)
    assert specs["groups/p2_attn/k"][0] == (1, 2, 32, 1, 16)  # the ring: min(window, max_len)
    assert pair.model.cache_specs(2, 16)["groups/p2_attn/k"][0][2] == 16
    assert specs["groups/p0_rglru/conv"][0] == (1, 2, 3, 64)
    assert ("tail/t1_rglru/h" in specs) == (n == 5)


def test_local_and_full_masks_match_reference():
    q, k = np.arange(40), np.arange(40)
    for kind in ("local", "full", "causal"):
        want = ref_layers.MaskSpec(kind, window=7)(jnp.asarray(q), jnp.asarray(k))
        got = layers.MaskSpec(kind, window=7)(torch.from_numpy(q), torch.from_numpy(k))
        np.testing.assert_array_equal(np_(got), np.asarray(want))
    ring = layers.MaskSpec("local", window=3)(torch.tensor([[5], [9]]), torch.tensor(
        [[4, 5, 2], [9, 6, 7]]))  # per-row slot positions, as the ring passes them
    assert ring.tolist() == [[[True, True, False]], [[True, False, True]]]


def test_forward_loss_and_grads_match(pair):
    batch = {"tokens": _tokens(pair, s=40)}  # past the 32-token window
    want, _ = pair.ref_model.forward(pair.params, ref_batch(batch))
    got, aux = pair.model(pair.tparams, port_batch(batch))
    assert aux == 0.0
    close(got, want, tol=TOL)
    check_loss_and_grads(pair, batch, tol=TOL)


def test_linear_scan_is_the_sequential_recurrence():
    from repro_torch.models.ssm import linear_scan

    g = torch.Generator().manual_seed(0)
    a, b = torch.rand((2, 37, 5), generator=g), torch.randn((2, 37, 5), generator=g)
    h, want = torch.zeros((2, 5)), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    close(linear_scan(a, b), np_(torch.stack(want, 1)))


def test_decode_matches_reference_and_forward(pair):
    tokens = _tokens(pair, s=12, seed=1)
    cache = pair.model.init_cache(2, 48, device="cpu")
    dec, cache, ref_cache = decode_both(pair, tokens, cache, pair.ref_model.init_cache(2, 48),
                                        tol=TOL)
    check_cache(cache, ref_cache, tol=TOL)
    tf, _ = pair.model(pair.tparams, port_batch({"tokens": tokens}))
    close(dec, np_(tf), tol=2e-4)


def test_ring_wraps_past_the_window(pair5):
    """50 positions through a 32-row ring (``max_len`` 40): decode against
    the forward's local mask and against the reference's decode."""
    pair = pair5
    tokens = _tokens(pair, b=1, s=50, seed=2)
    cache = pair.model.init_cache(1, 40, device="cpu")
    assert cache["groups/p2_attn/k"].shape[2] == 32
    dec, cache, ref_cache = decode_both(pair, tokens, cache, pair.ref_model.init_cache(1, 40),
                                        tol=TOL)
    check_cache(cache, ref_cache, tol=TOL)
    tf, _ = pair.model(pair.tparams, port_batch({"tokens": tokens}))
    close(dec, np_(tf), tol=2e-4)


def test_short_ring_evicts_as_the_reference(pair5):
    """``max_len`` 16 < window 32: a 16-row ring drops keys the window would
    allow, on both sides; the forward (the full window) differs."""
    pair = pair5
    tokens = _tokens(pair, b=2, s=40, seed=3)
    dec, cache, ref_cache = decode_both(pair, tokens, pair.model.init_cache(2, 16, device="cpu"),
                                        pair.ref_model.init_cache(2, 16), tol=TOL)
    check_cache(cache, ref_cache, tol=TOL)
    tf, _ = pair.model(pair.tparams, port_batch({"tokens": tokens}))
    assert float((dec[:, 16:] - tf[:, 16:]).abs().max()) > 1e-3


def test_generate_matches_reference_past_max_len(pair5):
    check_generate_matches_reference(pair5, prompt_len=10, max_new=20, max_len=16)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
@pytest.mark.parametrize("admission", ["sequential", "batched"])
def test_scheduler_bitwise_one_shot_generate(pair5, temperature, admission):
    check_scheduler_bitwise(pair5, temperature, admission)


def test_scheduler_ignores_a_page_size(pair5):
    check_scheduler_bitwise(pair5, 0.0, "sequential", page_size=8)


def test_scheduler_greedy_equals_reference_scheduler(pair5):
    check_reference_scheduler(pair5)


def test_slot_roundtrip_leaves_neighbours(pair5):
    check_slot_roundtrip(pair5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_step_rows_equal_b1_steps(pair5, dtype):
    check_pool_rows(pair5, dtype)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_graph_decode_past_max_len_keeps_one_step_graph(pair5, temperature):
    check_graph_decode_in_chunks(pair5, temperature)


def test_prime_many_and_prefill_refused(pair5):
    check_prime_many_refused(pair5)


def test_tree_checkpoint_crosses_both_ways(pair5, tmp_path):
    """The nested params (``params/groups/p0_rglru/mixer/w_x``,
    ``params/tail/t0_rglru/...``) saved by the port restore in the
    reference bitwise, and the reference's restore in the port, under the
    same leaf keys; numpy crosses both ways unchanged."""
    pair = pair5
    save(tmp_path / "port", 1, {"params": pair.tparams})
    back = ref_ckpt.restore(tmp_path / "port", 1, {"params": pair.params})
    for path, w in jax.tree_util.tree_flatten_with_path(back["params"])[0]:
        node = pair.tree
        for key in path:
            node = node[key.key]
        assert np.asarray(w).tobytes() == node.tobytes(), path
    ref_ckpt.save(tmp_path / "ref", 1, {"params": pair.params})
    like = {"params": params_from_numpy(pair.tree, "cpu")}
    got = restore(tmp_path / "ref", 1, like)
    keys = set(_flatten(got))
    assert "params/groups/p0_rglru/mixer/w_x" in keys and "params/tail/t1_rglru/mixer/lam" in keys
    assert keys == set(ref_ckpt._flatten({"params": pair.params}))
    flat = params_to_numpy(got["params"])
    for path, w in jax.tree_util.tree_flatten_with_path(pair.params)[0]:
        node = flat
        for key in path:
            node = node[key.key]
        assert node.tobytes() == np.asarray(w).tobytes(), path
