"""Port vs reference: AdamW, global-norm clipping, the LR schedules, the
pruning schedule and masks, and int8 gradient compression.

The optimizer runs on identical inputs in both packages (one numpy tree of
params, grads and moments), so the update is the same arithmetic and only
fp32 rounding may differ: 1e-6 of each leaf's largest magnitude.  The
weight decay goes on every leaf of rank >= 2, the stacked norm scales
``(L, d)`` and the embedding included, as in the reference.  Pruning masks
are compared exactly on identical inputs.  Grad compression draws its noise
from torch's generator, which cannot reproduce threefry (ROADMAP.md C3), so
its deterministic part is held against the formula.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pruning as ref_pruning
from repro.optim import AdamState as RefAdamState
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import cosine_schedule as ref_cosine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (
    adam_state_from_numpy, adam_state_to_numpy, params_from_numpy, params_to_numpy,
)
from repro_torch.core import pruning
from repro_torch.models import build_model
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm, cosine_schedule
from repro_torch.optim.adamw import tree_items
from repro_torch.train import TrainConfig, Trainer, TrainHParams
from repro_torch.train.step import compress_grads


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread runs them faster than many and
    leaves the cores to the test workers beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree_like(params, rng, scale=1.0, positive=False):
    def leaf(a):
        x = rng.standard_normal(a.shape).astype(np.float32) * scale
        return np.abs(x) if positive else x

    return jax.tree_util.tree_map(leaf, params)


def _leaves(tree):
    return [np.asarray(v) for _, v in sorted(
        ("/".join(str(k.key) for k in p), v) for p, v in
        jax.tree_util.tree_flatten_with_path(tree)[0])]


def _close(got, want, rel=1e-6):
    for g, w in zip(_leaves(got), _leaves(want)):
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= rel * max(float(np.abs(w).max()), 1e-30)


@pytest.fixture(scope="module")
def state():
    """Smoke-``vusa_edge`` params, grads and moments at step 3, as numpy."""
    rng = np.random.default_rng(0)
    params = params_to_numpy(build_model(get_smoke_config("vusa_edge")).init(0, device="cpu"))
    params = jax.tree_util.tree_map(lambda a: a + 0.1 * rng.standard_normal(a.shape)
                                    .astype(np.float32), params)  # norm scales off zero
    grads = _tree_like(params, rng)
    mu = _tree_like(params, rng, 0.1)
    nu = _tree_like(params, rng, 0.1, positive=True)
    return params, grads, mu, nu


@pytest.mark.parametrize("max_norm", [1.0, 1e6])  # clipping active / inactive
def test_adamw_update_matches_reference(state, max_norm):
    params, grads, mu, nu = state
    lr = 3e-4
    ref_p, ref_s, ref_g = ref_adamw_update(
        jax.tree_util.tree_map(jnp.asarray, params), jax.tree_util.tree_map(jnp.asarray, grads),
        RefAdamState(step=jnp.int32(3), mu=jax.tree_util.tree_map(jnp.asarray, mu),
                     nu=jax.tree_util.tree_map(jnp.asarray, nu)),
        lr, max_grad_norm=max_norm)
    tp = params_from_numpy(params, "cpu")
    opt = adam_state_from_numpy(RefAdamState(np.int32(3), mu, nu), "cpu")
    tg = [g for _, g in tree_items(params_from_numpy(grads, "cpu"))]
    tp2, opt2, gnorm = adamw_update(tp, tg, opt, lr, max_grad_norm=max_norm)
    assert tp2 is tp and opt2 is opt  # in place
    assert abs(float(gnorm) / float(ref_g) - 1) <= 1e-6
    _close(params_to_numpy(tp), ref_p)
    got = adam_state_to_numpy(opt)
    assert got["step"].dtype == np.int32 and int(got["step"]) == int(ref_s.step) == 4
    _close(got["mu"], ref_s.mu)
    _close(got["nu"], ref_s.nu)


def test_weight_decay_on_every_leaf_of_rank_two_or_more(state):
    """Zero grads and moments: the update is the decay alone, ``p * (1 -
    lr * wd)``, on the stacked norm scales and the embedding too; the
    rank-1 final norm does not move."""
    params = state[0]
    tp = params_from_numpy(params, "cpu")
    zeros = [torch.zeros_like(g) for _, g in tree_items(tp)]
    adamw_update(tp, zeros, adamw_init(tp), 0.5, weight_decay=0.1)
    got = params_to_numpy(tp)
    for path in (("layers", "norm1"), ("layers", "norm2"), ("embed",), ("layers", "attn", "wq")):
        want = params
        node = got
        for k in path:
            want, node = want[k], node[k]
        assert want.ndim >= 2
        np.testing.assert_allclose(node, want - 0.5 * (0.1 * want), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got["final_norm"], params["final_norm"])
    ref_p, _, _ = ref_adamw_update(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.zeros_like, params),
        RefAdamState(jnp.int32(0), jax.tree_util.tree_map(jnp.zeros_like, params),
                     jax.tree_util.tree_map(jnp.zeros_like, params)), 0.5)
    _close(got, ref_p)


def test_clip_by_global_norm_matches_reference(state):
    grads = state[1]
    for max_norm in (0.5, 1e6):
        want, want_n = ref_clip(jax.tree_util.tree_map(jnp.asarray, grads), max_norm)
        got, n = clip_by_global_norm([g for _, g in tree_items(params_from_numpy(grads, "cpu"))],
                                     max_norm)
        assert abs(float(n) / float(want_n) - 1) <= 1e-6
        for g, w in zip(got, _leaves(want)):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-9)


def test_schedules_match_reference():
    for step in range(0, 130, 3):
        want = float(ref_cosine(jnp.int32(step), 10, 100, 3e-4))
        assert cosine_schedule(step, 10, 100, 3e-4) == pytest.approx(want, rel=1e-6)
    assert cosine_schedule(0, 0, 0, 1.0) == pytest.approx(float(ref_cosine(jnp.int32(0), 0, 0,
                                                                             1.0)))


# ---------------------------------------------------------------------------
# pruning schedule and masks
# ---------------------------------------------------------------------------


def test_polynomial_sparsity_matches_reference():
    for step in range(0, 40):
        for begin, end in ((4, 8), (5, 30), (10, 10)):
            assert pruning.polynomial_sparsity(step, begin, end, 0.85) == \
                ref_pruning.polynomial_sparsity(step, begin, end, 0.85)


@pytest.mark.parametrize("sparsity", [0.0, 0.3, 0.85, 1.0])
def test_masks_tree_and_apply_masks_match_reference(state, sparsity):
    params = state[0]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want_masks = ref_pruning.masks_tree(jp, sparsity)
    want = ref_pruning.apply_masks(jp, want_masks)
    tp = params_from_numpy(params, "cpu")
    masks = pruning.masks_tree(tp, sparsity)
    for path, m in jax.tree_util.tree_flatten_with_path(want_masks,
                                                        is_leaf=lambda x: x is None)[0]:
        node = masks
        for k in path:
            node = node[k.key]
        if m is None:
            assert node is None, path
        else:
            np.testing.assert_array_equal(node.numpy(), np.asarray(m))
    assert pruning.apply_masks(tp, masks) is None  # in place
    for g, w in zip(_leaves(params_to_numpy(tp)), _leaves(want)):
        np.testing.assert_array_equal(g, w)
        assert not np.signbit(g[g == 0]).any()  # pruned to +0.0, as jnp.where
    assert pruning.tree_sparsity(tp) == ref_pruning.tree_sparsity(want)


# ---------------------------------------------------------------------------
# grad compression
# ---------------------------------------------------------------------------


def test_grad_compression_grid_scale_and_clip():
    """Each tensor comes back as ``q * scale``: ``scale = max|g| / 127``
    (at least 1e-12 / 127), q an integer in [-127, 127] within one step of
    ``g / scale`` (stochastic rounding), the extremes exact; an all-zero
    tensor stays zero; the same step draws the same noise."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal((64, 33)).astype(np.float32))
    g[0, 0] = 5.0  # the extreme: 5 / scale = 127 exactly
    grads = [g, torch.zeros(7), torch.full((3,), -2.5)]
    out = compress_grads(grads, step=3)
    for src, got in zip(grads, out):
        scale = max(float(src.abs().max()), 1e-12) / 127.0
        q = got.double() / scale
        assert torch.allclose(q, q.round(), atol=1e-4)
        assert float(q.abs().max()) <= 127 + 1e-4
        assert bool(((q - src.double() / scale).abs() <= 1 + 1e-4).all())
    assert float(out[0][0, 0]) == pytest.approx(5.0, rel=1e-6)
    assert float(out[1].abs().max()) == 0.0
    assert torch.equal(out[2], grads[2])  # |g| = max everywhere: q = -127 exactly
    assert all(torch.equal(a, b) for a, b in zip(out, compress_grads(grads, step=3)))
    assert not torch.equal(out[0], compress_grads(grads, step=4)[0])
    # unbiased: averaged over many steps, the dequantized value approaches g
    mean = sum(compress_grads([g], step=s)[0] for s in range(200)) / 200
    assert float((mean - g).abs().max()) <= 0.3 * 5.0 / 127


def test_grad_compression_trains():
    cfg = get_smoke_config("vusa_edge")
    tc = TrainConfig(steps=6, global_batch=4, seq_len=32, prune_begin=4, prune_end=8,
                     prune_every=2, log_every=100, token_range=16,
                     hp=TrainHParams(lr=3e-3, warmup=2, total_steps=6, grad_compress=True))
    tr = Trainer(cfg, tc, device="cpu")
    out = tr.train()
    assert np.isfinite(out["final_loss"])
    assert out["final_loss"] < tr.metrics_log[0]["loss"]
