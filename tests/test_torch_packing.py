"""Port vs reference: the row-wise VUSA pack and magnitude pruning.

The port's vectorised ``pack_rows``/``pack_rows_t`` must be byte-identical to
``repro.core.packing`` (same slot order, job count, idle encoding), and its
tensor pruning must produce the same masks as ``repro.core.pruning`` on the
same numpy weights (exact: both pick the same k-th largest magnitude).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as ref_packing
from repro.core import pruning as ref_pruning
from repro.configs import get_smoke_config as ref_smoke
from repro.models import build_model as ref_build
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import packing, pruning


def _sparse(rng, k, c, sparsity):
    w = rng.normal(size=(k, c)) * (rng.random((k, c)) >= sparsity)
    return w.astype(np.float32)


def _assert_same_pack(got, want):
    assert (got.k, got.c, got.m, got.a) == (want.k, want.c, want.m, want.a)
    assert got.values.dtype == want.values.dtype
    assert got.row_positions.dtype == want.row_positions.dtype == np.int8
    assert got.values.tobytes() == want.values.tobytes()
    assert got.row_positions.tobytes() == want.row_positions.tobytes()


@pytest.mark.parametrize("sparsity", [0.0, 0.85, 0.99])
@pytest.mark.parametrize("k,c,m,a", [(64, 256, 128, 16), (48, 200, 128, 8), (33, 70, 32, 4)])
def test_pack_rows_byte_identical(sparsity, k, c, m, a):
    """Sparsities 0/.85/.99, C % m != 0 (200, 70), small windows."""
    rng = np.random.default_rng(0)
    w = _sparse(rng, k, c, sparsity)
    got = packing.pack_rows(w, m=m, a=a)
    _assert_same_pack(got, ref_packing.pack_rows(w, m=m, a=a))
    packing.validate_rows(got)
    np.testing.assert_array_equal(packing.unpack_rows(got), w)


@pytest.mark.parametrize("sparsity", [0.0, 0.85, 0.99])
def test_pack_rows_t_byte_identical(sparsity):
    rng = np.random.default_rng(1)
    w = _sparse(rng, 200, 48, sparsity)  # (ff, d): the down-projection layout
    got = packing.pack_rows_t(w, a=8)
    _assert_same_pack(got, ref_packing.pack_rows_t(w, a=8))
    np.testing.assert_array_equal(packing.unpack_rows(got), w.T)


def test_pack_rows_all_zero_rows_and_matrix():
    """All-zero rows are idle throughout; an all-zero matrix keeps one job."""
    rng = np.random.default_rng(2)
    w = _sparse(rng, 64, 256, 0.85)
    w[10:30] = 0.0
    w[:, 40:80] = 0.0
    _assert_same_pack(packing.pack_rows(w, a=8), ref_packing.pack_rows(w, a=8))
    z = np.zeros((16, 130), np.float32)
    got = packing.pack_rows(z, a=8)
    _assert_same_pack(got, ref_packing.pack_rows(z, a=8))
    assert got.n_jobs == 1 and (got.row_positions == -1).all()


def test_validate_rows_rejects_corrupt_position():
    rng = np.random.default_rng(3)
    p = packing.pack_rows(_sparse(rng, 16, 256, 0.8), m=128, a=4)
    p.row_positions[0, 3, 0] = 127
    packing.validate_rows(p)  # still in range
    p.row_positions[0, 3, 0] = -2
    with pytest.raises(ValueError, match="corrupt metadata"):
        packing.validate_rows(p)


@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.85, 0.99, 1.0])
def test_magnitude_mask_matches_reference(sparsity):
    rng = np.random.default_rng(4)
    w = rng.normal(size=(3, 40, 24)).astype(np.float32)  # layer-stacked leaf
    w[0, 0, :4] = 0.5  # ties at a magnitude keep extra, in both
    want = np.asarray(ref_pruning.magnitude_mask(jnp.asarray(w), sparsity))
    got = pruning.magnitude_mask(torch.from_numpy(w), sparsity).numpy()
    np.testing.assert_array_equal(got, want)


def test_prune_tree_matches_reference():
    """Whole-model prune: every prunable leaf (lm_head, stacked attention and
    MLP weights) equals the reference; embed and norms are untouched."""
    cfg = ref_smoke("vusa_edge")
    params = ref_build(cfg).init(jax.random.key(0))
    want = jax.tree_util.tree_map(np.asarray, ref_pruning.prune_tree(params, 0.85))
    tree = jax.tree_util.tree_map(np.asarray, params)
    got = params_to_numpy(pruning.prune_tree(params_from_numpy(tree, "cpu"), 0.85))
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_want) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in flat_want:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf, err_msg=str(path))
    np.testing.assert_array_equal(got["embed"], tree["embed"])
    assert pruning.tree_sparsity(params_from_numpy(got, "cpu")) == pytest.approx(
        ref_pruning.tree_sparsity(want), abs=0.0
    )
