"""Port: sharded serving on a (data, model) mesh of gloo ranks on the CPU.

The ranks are processes started by ``repro_torch.launch.mesh.spawn`` (a
rendezvous file under ``tmp_path``), few per file: one 2x2 world serves its
whole mesh, its ``model`` sub-mesh (1x2) and its ``data`` sub-mesh (2x1);
one 1x4 world gives four tensor-parallel ranks (pad windows, qwen2's
sequence-sharded prefill attention); one 1x1 world is the degenerate mesh.
Each rank computes every case and returns its results; the cases are
checked here, each rank against the single-device port:

- the sharded appliers (column windows all-gathered; the fused MLP's
  window partials all-gathered and summed by the kernel's own ordered
  sum) are bitwise the single-device appliers, fp32/int8/int4 values,
  B = 1 and 3, with pad windows (200 and 300 columns over 2 and 4 ranks);
- ``Engine.generate`` on 1x2, 2x1 and 2x2 (and 1x4): every rank's tokens
  equal the port's single-device tokens bitwise, dense and packed, greedy
  and sampled, and greedy they equal ``repro``'s single-device tokens
  (the reference's sharded modes are not an oracle: ROADMAP C1);
- a 1x1 mesh is no mesh: the same packs, no pad window, the same tokens;
- qwen2-smoke (4 heads, 2 kv heads) on 1x4 takes the sequence-sharded
  attention (its call count) and its tokens equal the single-device ones;
- speculative ``generate`` at B = 1 (the drafter's pack sharded too) on
  1x2 and 2x2, and the speculative scheduler on 2x2, equal one device's;
- the scheduler on 2x2 with sequential admission is bitwise the
  single-device scheduler on the slot pool and on the paged pool (with and
  without the prefix cache; with chunked prefill), sampled too; batched
  admission too on this 2-layer config (C9 does not part it here);
- ``launch/serve.py --mesh 2,2 --dist-backend gloo --device cpu`` runs,
  and ``nccl`` with fewer GPUs than ranks raises.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import spawn
from repro_torch.models import build_model
from repro_torch.serve import Engine, Request, Scheduler, ServeConfig

VALUE_DTYPES = ("dense", "int8", "int4")
GEN_ROUTES = {
    "dense": {},
    "fp32": {"packed_weights": "all"},
    "int8": {"packed_weights": "all", "packed_values": "int8"},
    "mlp3": {"packed_weights": "mlp", "fused_mlp": False, "packed_values": "int4"},
}
TEMPS = (0.0, 0.8)
SUBMESHES = ("1x2", "2x1", "2x2")
SCHED = {
    "slot-seq": ({}, "sequential"),
    "paged-seq": ({"page_size": 16, "prefix_cache": False}, "sequential"),
    "paged-prefix-seq": ({"page_size": 16}, "sequential"),
    "paged-chunk-seq": ({"page_size": 16, "prefill_chunk": 16}, "sequential"),
    "slot-batched": ({}, "batched"),
}


def _sparse(rng, k, c, sparsity=0.85):
    w = rng.standard_normal((k, c)).astype(np.float32)
    w[rng.random((k, c)) < sparsity] = 0
    return w


def _applier_cases(mesh):
    """(single-device, sharded) outputs of both appliers on every value
    route, B = 1 and 3."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)
    out = {}
    for vd in VALUE_DTYPES:
        w = _sparse(rng, 64, 300)
        wg, wu, wd = _sparse(rng, 64, 200), _sparse(rng, 64, 200), _sparse(rng, 200, 48)
        p = ops.pack_linear_rows(w, device="cpu", value_dtype=vd)
        g, u = (ops.pack_linear_rows(m, device="cpu", value_dtype=vd) for m in (wg, wu))
        d = ops.pack_linear_rows_t(wd, device="cpu", value_dtype=vd)
        for b in (1, 3):
            x = torch.from_numpy(rng.standard_normal((b, 64)).astype(np.float32))
            local = [ops.local_windows(q, mesh) for q in (p, g, u, d)]
            out[("row", vd, b)] = (ops.apply_row_packed(x, p),
                                   ops.apply_row_packed_sharded(x, local[0], mesh))
            out[("mlp", vd, b)] = (ops.apply_fused_mlp(x, g, u, d),
                                   ops.apply_fused_mlp_sharded(x, *local[1:], mesh))
    return out


def _vusa_params(params_np):
    return params_from_numpy(params_np, "cpu")


def _generate(params, mesh, route, temp, arch="vusa_edge"):
    cfg = get_smoke_config(arch)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (4, 8))
    sc = ServeConfig(max_len=64, temperature=temp, seed=3, **GEN_ROUTES[route])
    return Engine(cfg, params, sc, device="cpu", mesh=mesh).generate(prompts, max_new=8)["tokens"]


def _requests():
    rng = np.random.default_rng(5)
    shared = rng.integers(1, 500, 16).astype(np.int32)  # one full page shared by half of them
    reqs = []
    for i in range(8):
        tail = rng.integers(1, 500, int(rng.integers(2, 12))).astype(np.int32)
        prompt = np.concatenate([shared, tail]) if i % 2 else tail
        reqs.append(Request(prompt=prompt, max_new=int(rng.integers(2, 10)), seed=i))
    return reqs


def _speculative(params, mesh, temp):
    """Speculative ``generate`` at B = 1: the drafter's pack window-sharded
    too; one row does not split over ``data``, so it stays whole there."""
    cfg = get_smoke_config("vusa_edge")
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (1, 8))
    sc = ServeConfig(max_len=64, temperature=temp, seed=3, packed_weights="all",
                     speculative=True, draft_k=3, draft_sparsity=0.9)
    return Engine(cfg, params, sc, device="cpu", mesh=mesh).generate(prompts, max_new=10)["tokens"]


def _schedule(params, mesh, case, temp=0.0, **extra):
    kw, admission = SCHED[case]
    cfg = get_smoke_config("vusa_edge")
    sc = ServeConfig(max_len=64, temperature=temp, packed_weights="all", **kw, **extra)
    sched = Scheduler(Engine(cfg, params, sc, device="cpu", mesh=mesh), slots=4, segment=4,
                      admission=admission)
    done = sched.run(_requests())
    assert sched.verify_paged_mirror()
    return {rid: c.tokens.tolist() for rid, c in done.items()}


def _routes(mesh: str) -> list:
    """The generate routes of a mesh: the three-call MLP (int4) on 2x2 only."""
    return [r for r in GEN_ROUTES if r != "mlp3" or mesh == "2x2"]


def _ranks_2x2(mesh, device, params_np):
    """Every case of the 2x2 world on this rank."""
    params = _vusa_params(params_np)
    meshes = {"1x2": mesh["model"], "2x1": mesh["data"], "2x2": mesh}
    out = {"appliers": _applier_cases(mesh["model"])}
    out["gen"] = {(name, route, t): _generate(params, m, route, t)
                  for name, m in meshes.items() for route in _routes(name) for t in TEMPS}
    out["sched"] = {case: _schedule(params, mesh, case) for case in SCHED}
    out["sched_sampled"] = _schedule(params, mesh, "paged-seq", temp=0.8)
    out["spec"] = {(name, t): _speculative(params, meshes[name], t)
                   for name in ("1x2", "2x2") for t in TEMPS}
    out["spec_sched"] = _schedule(params, mesh, "paged-seq", speculative=True, draft_k=3,
                                  draft_sparsity=0.9)
    return out


def _placed_packs(mesh, params_np) -> bool:
    """``shard_packed`` of the whole padded pack keeps this rank's windows
    of every entry: what ``pack_lm_weights(rank=...)`` packs alone, slot for
    slot (the rank's pack may end its rows with fewer idle slots)."""
    from repro_torch.dist.comm import axis_index
    from repro_torch.serve.packed import _flat_entries, pack_lm_weights, shard_packed

    cfg, params = get_smoke_config("vusa_edge"), _vusa_params(params_np)
    placed = _flat_entries(shard_packed(pack_lm_weights(cfg, params, shards=4), mesh))
    own = _flat_entries(pack_lm_weights(cfg, params, shards=4, rank=axis_index(mesh, "model")))
    for name, e in own.items():
        s = e["positions"].shape[-1]
        if not (placed[name]["shards"] == 4 and torch.equal(
                placed[name]["positions"][..., :s], e["positions"])
                and torch.equal(placed[name]["values"][..., :s], e["values"])):
            return False
    return True


def _ranks_1x4(mesh, device, params_np):
    from repro_torch.models.layers import _maybe_seq_sharded_attention

    out = {"appliers": _applier_cases(mesh), "placed": _placed_packs(mesh, params_np)}
    out["gen"] = {(route, t): _generate(_vusa_params(params_np), mesh, route, t)
                  for route in ("fp32", "int8") for t in TEMPS}
    qwen = build_model(get_smoke_config("qwen2_0_5b")).init(0, device="cpu")
    before = _maybe_seq_sharded_attention.calls
    out["qwen2"] = _generate(qwen, mesh, "fp32", 0.0, arch="qwen2_0_5b")
    out["seq_shard_calls"] = _maybe_seq_sharded_attention.calls - before
    return out


def _ranks_1x1(mesh, device, params_np):
    params = _vusa_params(params_np)
    cfg = get_smoke_config("vusa_edge")
    eng = Engine(cfg, params, ServeConfig(max_len=64, packed_weights="all"), device="cpu",
                 mesh=mesh)
    packs = {k: (e["values"].clone(), e.get("shards", 1)) for k, e in eng.packed["mlp"].items()}
    return {"mesh": eng.mesh, "packs": packs, "gen": _generate(params, mesh, "fp32", 0.0)}


@pytest.fixture(scope="module")
def vusa_np():
    """The reference's smoke init at key(0), pruned to 85 %, as numpy."""
    import jax

    from repro.configs import get_smoke_config as ref_smoke
    from repro.core.pruning import prune_tree as ref_prune
    from repro.models import build_model as ref_build

    cfg = ref_smoke("vusa_edge")
    params = ref_prune(ref_build(cfg).init(jax.random.key(0)), 0.85)
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), params)


@pytest.fixture(scope="module")
def world_2x2(vusa_np, tmp_path_factory):
    return spawn(_ranks_2x2, 2, 2, "gloo", "cpu", str(tmp_path_factory.mktemp("mesh2x2")),
                 args=(vusa_np,))


@pytest.fixture(scope="module")
def world_1x4(vusa_np, tmp_path_factory):
    return spawn(_ranks_1x4, 1, 4, "gloo", "cpu", str(tmp_path_factory.mktemp("mesh1x4")),
                 args=(vusa_np,))


@pytest.fixture(scope="module")
def single(vusa_np):
    """The single-device port's results of every case."""
    params = _vusa_params(vusa_np)
    gen = {(route, t): _generate(params, None, route, t) for route in GEN_ROUTES for t in TEMPS}
    sched = {case: _schedule(params, None, case) for case in SCHED}
    qwen = build_model(get_smoke_config("qwen2_0_5b")).init(0, device="cpu")
    return {"gen": gen, "sched": sched, "sched_sampled": _schedule(params, None, "paged-seq",
                                                                   temp=0.8),
            "qwen2": _generate(qwen, None, "fp32", 0.0, arch="qwen2_0_5b"),
            "spec": {t: _speculative(params, None, t) for t in TEMPS},
            "spec_sched": _schedule(params, None, "paged-seq", speculative=True, draft_k=3,
                                    draft_sparsity=0.9)}


@pytest.fixture(scope="module")
def repro_greedy(vusa_np):
    """``repro``'s single-device greedy tokens of the generate cases."""
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as ref_smoke
    from repro.serve import Engine as RefEngine
    from repro.serve import ServeConfig as RefServeConfig

    cfg = ref_smoke("vusa_edge")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (4, 8))
    params = {k: v for k, v in vusa_np.items()}
    out = {}
    for route, kw in GEN_ROUTES.items():
        eng = RefEngine(cfg, _jnp_tree(params, jnp), RefServeConfig(max_len=64, **kw))
        out[route] = np.asarray(eng.generate(prompts, max_new=8)["tokens"])
    return out


def _jnp_tree(tree, jnp):
    return {k: _jnp_tree(v, jnp) if isinstance(v, dict) else jnp.asarray(np.array(v, copy=True))
            for k, v in tree.items()}


@pytest.mark.parametrize("shape", ["2x2", "1x4"])
@pytest.mark.parametrize("kind", ["row", "mlp"])
@pytest.mark.parametrize("value_dtype", VALUE_DTYPES)
@pytest.mark.parametrize("b", [1, 3])
def test_sharded_appliers_bitwise(shape, kind, value_dtype, b, request):
    world = request.getfixturevalue(f"world_{shape}")
    for rank in world:
        want, got = rank["appliers"][(kind, value_dtype, b)]
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(got, want), (shape, kind, value_dtype, b)


@pytest.mark.parametrize("mesh,route", [(m, r) for m in SUBMESHES for r in _routes(m)])
@pytest.mark.parametrize("temp", TEMPS, ids=["greedy", "sampled"])
def test_generate_on_mesh_equals_single_device(world_2x2, single, repro_greedy, mesh, route,
                                               temp):
    want = single["gen"][(route, temp)]
    for rank in world_2x2:
        np.testing.assert_array_equal(rank["gen"][(mesh, route, temp)], want)
    if temp == 0.0:
        np.testing.assert_array_equal(want, repro_greedy[route])


@pytest.mark.parametrize("route", ["fp32", "int8"])
@pytest.mark.parametrize("temp", TEMPS, ids=["greedy", "sampled"])
def test_generate_on_four_model_ranks(world_1x4, single, route, temp):
    for rank in world_1x4:
        np.testing.assert_array_equal(rank["gen"][(route, temp)], single["gen"][(route, temp)])


def test_shard_packed_keeps_each_ranks_windows(world_1x4):
    assert all(rank["placed"] for rank in world_1x4)


def test_qwen2_takes_the_sequence_sharded_attention(world_1x4, single):
    for rank in world_1x4:
        assert rank["seq_shard_calls"] == 2  # one prefill, two layers
        np.testing.assert_array_equal(rank["qwen2"], single["qwen2"])


def test_one_by_one_mesh_is_no_mesh(vusa_np, single, tmp_path):
    (got,) = spawn(_ranks_1x1, 1, 1, "gloo", "cpu", str(tmp_path), args=(vusa_np,))
    assert got["mesh"] is None
    eng = Engine(get_smoke_config("vusa_edge"), _vusa_params(vusa_np),
                 ServeConfig(max_len=64, packed_weights="all"), device="cpu")
    for name, (values, shards) in got["packs"].items():
        assert shards == 1 and torch.equal(values, eng.packed["mlp"][name]["values"])
    np.testing.assert_array_equal(got["gen"], single["gen"][("fp32", 0.0)])


@pytest.mark.parametrize("case", list(SCHED))
def test_scheduler_on_2x2_equals_single_device(world_2x2, single, case):
    for rank in world_2x2:
        assert rank["sched"][case] == single["sched"][case], case


def test_scheduler_on_2x2_sampled(world_2x2, single):
    for rank in world_2x2:
        assert rank["sched_sampled"] == single["sched_sampled"]


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("temp", TEMPS, ids=["greedy", "sampled"])
def test_speculative_generate_on_mesh(world_2x2, single, mesh, temp):
    for rank in world_2x2:
        np.testing.assert_array_equal(rank["spec"][(mesh, temp)], single["spec"][temp])


def test_speculative_scheduler_on_2x2(world_2x2, single):
    for rank in world_2x2:
        assert rank["spec_sched"] == single["spec_sched"]


def test_sharded_appliers_and_shard_packed_refuse_whole_packs():
    """The appliers take one rank's windows and never cut a whole pack per
    call; ``shard_packed`` takes whole packs padded for the axis."""
    from repro_torch.kernels import ops
    from repro_torch.serve.packed import pack_lm_weights, shard_packed

    rng = np.random.default_rng(0)
    p = ops.pack_linear_rows(_sparse(rng, 64, 300), device="cpu")
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="rank"):
        ops.apply_row_packed_sharded(x, p, {"model": 2})
    with pytest.raises(ValueError, match="rank"):
        ops.apply_fused_mlp_sharded(x, p, p, p, {"model": 2})
    with pytest.raises(ValueError, match="rank"):
        ops.apply_row_packed_sharded(x, dataclasses.replace(p, shards=2), None)
    cfg = get_smoke_config("vusa_edge")
    params = build_model(cfg).init(0, device="cpu")
    with pytest.raises(ValueError, match="shards=3"):
        shard_packed(pack_lm_weights(cfg, params), {"model": 3})


def test_launcher_serves_on_a_mesh():
    out = launch_serve.main(["--arch", "vusa_edge", "--smoke", "--packed", "all", "--mesh",
                             "2,2", "--dist-backend", "gloo", "--device", "cpu", "--max-new",
                             "4", "--prompt-len", "8"])
    assert out["finite"] and out["tokens"].shape == (4, 4)


def test_launcher_refuses_what_cannot_run():
    base = ["--arch", "vusa_edge", "--smoke", "--device", "cpu"]
    with pytest.raises(ValueError, match="nccl"):
        launch_serve.main(base + ["--mesh", "2,2", "--dist-backend", "nccl"])
    with pytest.raises(ValueError, match="nccl needs one GPU per rank"):
        launch_serve.main(["--arch", "vusa_edge", "--smoke", "--device", "cuda", "--mesh",
                           "1,2", "--dist-backend", "nccl"])
    with pytest.raises(SystemExit):
        launch_serve.main(base + ["--mesh", "2,2"])  # no backend given
    with pytest.raises(ValueError, match="dp,tp"):
        launch_serve.main(base + ["--mesh", "2x2", "--dist-backend", "gloo"])
