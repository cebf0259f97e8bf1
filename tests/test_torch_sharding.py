"""Port: the mesh placement rules and the window padding of sharded packs.

The port's ``dist/sharding.py`` returns placements, one entry per tensor
dim (None, a mesh axis, or a tuple of axes): the counterpart of the
reference's PartitionSpecs.  Held equal, exactly, to the reference's
``param_sharding``, ``batch_sharding``, ``serve_shardings``,
``window_sharding`` and ``block_sharding`` on JAX meshes of the 8 CPU
devices ``tests/conftest.py`` forces, at 1x1, 2x4, 4x2, 1x8 and 8x1, for
every family's parameter specs (smoke and full widths, so the divisible
and the fallback cases both occur), and the port's ParamSpec axes equal
the reference's leaf by leaf.  ``shard_windows`` and
``shard_linear_windows`` pad byte-identically to the reference's (values
0, positions -1, scales 1.0).  The rank-split paged layout and allocator
are checked on the host: a slot of rank r only gets blocks of rank r's
range, and global ids map to rank-local arena indices.
"""

import jax
import numpy as np
import pytest

from conftest import requires_devices
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.core.packing import pack_rows as ref_pack_rows
from repro.core.packing import shard_windows as ref_shard_windows
from repro.dist import sharding as ref_sharding
from repro.kernels import ops as ref_ops
from repro.models import build_model as ref_build
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.packing import pack_rows, shard_windows
from repro_torch.dist import sharding
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models import cache
from repro_torch.models.cache import BlockAllocator, PagedLayout

MESHES = [(1, 1), (2, 4), (4, 2), (1, 8), (8, 1)]


def _jax_mesh(shape):
    return jax.make_mesh(shape, ("data", "model"), devices=jax.devices()[: shape[0] * shape[1]])


def _spec(named, ndim: int) -> tuple:
    """A NamedSharding's PartitionSpec as a placement of ``ndim`` entries."""
    parts = tuple(named.spec)
    return parts + (None,) * (ndim - len(parts))


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _spec_pairs(smoke: bool):
    get_p, get_r = (get_smoke_config, ref_smoke) if smoke else (get_config, ref_config)
    for arch in ARCH_IDS:
        port = dict(_leaves(build_model(get_p(arch)).specs()))
        ref = dict(_leaves(ref_build(get_r(arch)).specs()))
        yield arch, port, ref


def test_arch_ids_match():
    assert sorted(ARCH_IDS) == sorted(REF_ARCH_IDS)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_param_specs_carry_the_reference_axes(smoke):
    for arch, port, ref in _spec_pairs(smoke):
        assert port.keys() == ref.keys(), arch
        for path, spec in port.items():
            assert tuple(spec.shape) == tuple(ref[path].shape), (arch, path)
            assert tuple(spec.axes) == tuple(ref[path].axes), (arch, path)


@requires_devices(8)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_param_sharding_matches_reference(shape, smoke):
    mesh = _jax_mesh(shape)
    port_mesh = {"data": shape[0], "model": shape[1]}
    sharded = 0
    for arch, port, ref in _spec_pairs(smoke):
        for path, spec in port.items():
            want = _spec(ref_sharding.param_sharding(ref[path], mesh), len(spec.shape))
            got = sharding.param_sharding(spec, port_mesh)
            assert got == want, (arch, path, got, want)
            sharded += any(got)
    assert sharded > 0 or shape == (1, 1)


@requires_devices(8)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_params_shardings_tree_matches_reference(shape):
    mesh = _jax_mesh(shape)
    for arch in ("vusa_edge", "recurrentgemma_9b", "whisper_tiny"):
        port = sharding.params_shardings(build_model(get_config(arch)).specs(),
                                         {"data": shape[0], "model": shape[1]})
        ref = ref_sharding.params_shardings(ref_build(ref_config(arch)).specs(), mesh)
        ref_leaves = dict(_leaves(ref))
        for path, got in _leaves(port):
            assert got == _spec(ref_leaves[path], len(got)), (arch, path)


@requires_devices(8)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_batch_window_block_shardings_match_reference(shape):
    mesh = _jax_mesh(shape)
    pm = {"data": shape[0], "model": shape[1]}
    for n in (1, 2, 3, 4, 6, 8, 16, 250, 252):
        for ndim in (1, 2, 3, 4):
            assert sharding.batch_sharding(pm, n, ndim) == _spec(
                ref_sharding.batch_sharding(mesh, n, ndim), ndim)
            for axis in range(min(ndim, 2)):
                assert sharding.window_sharding(pm, n, ndim, axis) == _spec(
                    ref_sharding.window_sharding(mesh, n, ndim, axis), ndim)
            if ndim >= 2:
                assert sharding.block_sharding(pm, n, ndim) == _spec(
                    ref_sharding.block_sharding(mesh, n, ndim), ndim)
    batch = {"tokens": np.zeros((8, 16)), "labels": np.zeros((8, 16)), "w": np.zeros((3,))}
    got = sharding.batch_shardings(pm, batch)
    want = ref_sharding.batch_shardings(mesh, batch)
    assert got == {k: _spec(v, batch[k].ndim) for k, v in want.items()}


@requires_devices(8)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("structural", [False, True], ids=["guess", "axes"])
def test_serve_shardings_match_reference(shape, structural):
    mesh = _jax_mesh(shape)
    pm = {"data": shape[0], "model": shape[1]}
    for b in (1, 2, 4, 8):
        cache = {"k": jax.ShapeDtypeStruct((2, b, 32, 4, 16), np.float32),
                 "v": jax.ShapeDtypeStruct((2, b, 32, 4, 16), np.float32),
                 "pos": jax.ShapeDtypeStruct((b,), np.int32)}
        axes = {"k": 1, "v": 1, "pos": 0} if structural else None
        got = sharding.serve_shardings(cache, pm, b, axes)
        want = ref_sharding.serve_shardings(cache, mesh, b, axes)
        assert got == {k: _spec(v, len(cache[k].shape)) for k, v in want.items()}, b


def test_act_rules_match_reference():
    for shape in ((1, 1), (2, 1)):
        mesh = _jax_mesh(shape)
        assert sharding.act_rules({"data": shape[0], "model": shape[1]}) == \
            ref_sharding.act_rules(mesh)


def _sparse(rng, k, c, sparsity=0.85):
    w = rng.standard_normal((k, c)).astype(np.float32)
    w[rng.random((k, c)) < sparsity] = 0
    return w


@pytest.mark.parametrize("c", [100, 256, 300, 1000])
def test_shard_windows_byte_identical(c):
    rng = np.random.default_rng(c)
    w = _sparse(rng, 48, c)
    p, r = pack_rows(w, m=128, a=16), ref_pack_rows(w, m=128, a=16)
    for n in (1, 2, 3, 4, 5):
        got, want = shard_windows(p, n), ref_shard_windows(r, n)
        assert got.values.shape[0] % n == 0
        assert got.values.tobytes() == np.asarray(want.values).tobytes()
        assert got.row_positions.tobytes() == np.asarray(want.row_positions).tobytes()
        assert (got.k, got.c, got.m, got.a) == (want.k, want.c, want.m, want.a)
    with pytest.raises(ValueError):
        shard_windows(p, 0)


@pytest.mark.parametrize("value_dtype", ["dense", "int8", "int4"])
def test_shard_linear_windows_byte_identical(value_dtype):
    rng = np.random.default_rng(7)
    w = _sparse(rng, 64, 300)
    p = ops.pack_linear_rows(w, device="cpu", value_dtype=value_dtype)
    r = ref_ops.pack_linear_rows(w, value_dtype=value_dtype)
    for n in (1, 2, 4, 5):
        got, want = ops.shard_linear_windows(p, n), ref_ops.shard_linear_windows(r, n)
        assert got.values.numpy().tobytes() == np.asarray(want.values).tobytes()
        assert got.positions.numpy().tobytes() == np.asarray(want.positions).tobytes()
        if value_dtype != "dense":
            assert got.scales.numpy().tobytes() == np.asarray(want.scales).tobytes()
        assert (got.k, got.c, got.m) == (want.k, want.c, want.m)


def test_sharded_paged_layout_and_allocator():
    lay = PagedLayout.build(4, 64, 16, blocks=10, shards=2)
    assert lay.rank_slots == 2 and lay.rank_blocks == 1 + 2 + 5
    assert lay.n_blocks == 16 and lay.user_blocks == 10 and lay.rank_user_blocks == 5
    assert [lay.scratch_block(i) for i in range(4)] == [1, 2, 9, 10]
    assert [lay.slot_rank(i) for i in range(4)] == [0, 0, 1, 1]
    assert lay.local() == PagedLayout(slots=2, page=16, n_pages=4, n_blocks=8)
    assert lay.to_local([3, 7, 8, 11, 15, lay.oob], 1).tolist() == [8, 8, 0, 3, 7, 8]
    al = BlockAllocator(lay)
    assert al.available_in(0) == al.available_in(1) == 5 and al.free_blocks == 10
    ids1, _ = al.alloc(3, rank=1)
    assert ids1 == [11, 12, 13] and all(lay.block_rank(b) == 1 for b in ids1)
    ids0, _ = al.alloc(5, rank=0)
    assert ids0 == [3, 4, 5, 6, 7] and al.alloc(1, rank=0) is None
    assert al.available_in(1) == 2
    # a prefix registered in rank 1's blocks never matches for rank 0
    assert al.register_page(b"d0", ids1[0])
    assert al.match_pages([b"d0"], rank=0) == [] and al.match_pages([b"d0"], rank=1) == [11]
    assert al.free(ids0) == ids0 and al.available_in(0) == 5
    with pytest.raises(ValueError):
        PagedLayout.build(3, 64, 16, shards=2)
    one = PagedLayout.build(2, 64, 8)
    assert (one.n_blocks, one.reserved, one.scratch_block(1), one.local()) == (19, 3, 2, one)


def test_pool_placements_follow_the_batch_rules():
    """The slot pool's slot axis and the paged arena's block axis go over
    ``data`` when it divides them (the reference's ``slot_shardings`` and
    ``paged_shardings``), and stay whole when it does not."""
    model = build_model(get_smoke_config("vusa_edge"))
    slots = model.init_slot_cache(4, 32, device="cpu")
    axes = model.cache_batch_axes(32)
    for dp, want in ((2, "data"), (3, None), (1, None)):
        got = cache.slot_shardings(slots, {"data": dp, "model": 2}, axes)
        for name, leaf in slots.items():
            assert got[name][axes[name]] == want and sum(p is not None for p in got[name]) == (
                want is not None), (dp, name)
    lay = PagedLayout.build(4, 32, 8, shards=2)
    pool = model.init_paged_pool(lay, 32, device="cpu")
    got = cache.paged_shardings(pool, {"data": 2, "model": 2})
    assert all(p[1] == "data" for p in got["arena"].values())
    assert got["table"] == ("data", None) and got["pos"] == ("data",)


@pytest.mark.parametrize("value_dtype", ["dense", "int8", "int4"])
@pytest.mark.parametrize("shards", [2, 3, 4])
def test_rank_packs_are_the_cut_of_the_whole_pack(value_dtype, shards):
    """``pack_lm_weights(shards=n, rank=r)`` packs rank r's windows alone:
    each entry equals windows [r*T/n, (r+1)*T/n) of the whole padded pack
    slot for slot, with at most fewer trailing idle slots, and keeps the
    whole ``c``."""
    import torch

    from repro_torch.core.pruning import prune_tree
    from repro_torch.serve.packed import _flat_entries, pack_lm_weights

    cfg = get_smoke_config("vusa_edge")
    params = prune_tree(build_model(cfg).init(0, device="cpu"), 0.85)
    whole = _flat_entries(pack_lm_weights(cfg, params, scope="all", value_dtype=value_dtype,
                                          shards=shards))
    nib = 2 if value_dtype == "int4" else 1
    for r in range(shards):
        part = _flat_entries(pack_lm_weights(cfg, params, scope="all", value_dtype=value_dtype,
                                             shards=shards, rank=r))
        for name, e in part.items():
            w = whole[name]
            axis = w["positions"].ndim - 3
            t = w["positions"].shape[axis] // shards
            assert e["shards"] == shards and e["c"] == w["c"], name
            cut = {k: w[k].narrow(axis, r * t, t) for k in ("values", "positions", "scales")
                   if w.get(k) is not None}
            s = e["positions"].shape[-1]
            assert torch.equal(e["positions"], cut["positions"][..., :s]), name
            assert bool((cut["positions"][..., s:] == -1).all()), name
            assert torch.equal(e["values"], cut["values"][..., : s // nib]), name
            if "scales" in cut:
                assert torch.equal(e["scales"], cut["scales"]), name
