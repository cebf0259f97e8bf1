"""``launch/op_cost.py``, the port's counterpart of ``repro.launch.hlo_cost``,
must count exactly on known programs: the five of ``tests/test_hlo_cost.py``
written in torch (eager loops need no trip-count weighting: every
iteration dispatches), its byte and collective conventions, and the
smoke ``vusa_edge`` prefill against ``hlo_cost`` of the reference's
jitted prefill.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.checkpoint import checkpoint
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_smoke_config as ref_smoke
from repro.launch.hlo_cost import hlo_cost
from repro.models import build_model as ref_build
from repro_torch.configs import get_smoke_config
from repro_torch.dist import comm
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.op_cost import OpCounter, op_cost
from repro_torch.models import build_model


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_single_matmul_flops_and_bytes():
    _, c = op_cost(lambda x, y: x @ y, _meta(64, 128), _meta(128, 256))
    assert c["dot_flops"] == 2 * 64 * 128 * 256
    assert c["bytes"] == 4 * (64 * 128 + 128 * 256 + 64 * 256)  # operands + result
    assert c["transcendentals"] == 0 and c["collectives"] == {}


def test_loop_counts_every_iteration():
    def g(x, w):
        for _ in range(10):
            x = torch.tanh(x @ w)
        return x

    _, c = op_cost(g, _meta(128, 128), _meta(128, 128))
    assert c["dot_flops"] == 10 * 2 * 128**3
    assert c["transcendentals"] == 10 * 128 * 128


def test_nested_loops_multiply():
    def g(x, w):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x

    _, c = op_cost(g, _meta(64, 64), _meta(64, 64))
    assert c["dot_flops"] == 15 * 2 * 64**3


def _grad_program(remat: bool):
    def loss(w, x):
        f = lambda x: torch.tanh(x @ w)  # noqa: E731
        h = checkpoint(f, x, use_reentrant=False) if remat else f(x)
        return torch.tanh(h @ w).sum()

    def g(w, x):
        return torch.autograd.grad(loss(w, x), w)

    return g


def test_checkpoint_recompute_counted():
    """Recomputation under ``torch.utils.checkpoint`` shows up as extra
    FLOPs in the backward: 2 forward products + 3 backward without it, one
    more with it; the count equals ``FlopCounterMode``'s."""
    w = torch.randn(128, 128, requires_grad=True)
    x = torch.randn(128, 128)
    unit = 2 * 128**3
    plain = op_cost(_grad_program(False), w, x)[1]["dot_flops"]
    remat = op_cost(_grad_program(True), w, x)[1]["dot_flops"]
    assert plain == 5 * unit and remat == 6 * unit
    with FlopCounterMode(display=False) as fc:
        _grad_program(True)(w, x)
    assert fc.get_total_flops() == remat


def _site_a(x, w):
    return torch.exp(x @ w)


def _site_b(x, w):
    return (x @ w) @ w


def test_sites_key_the_counts_by_function():
    x, w = _meta(32, 64), _meta(64, 64)
    with OpCounter(sites=True) as oc:
        _site_a(x, w)
        _site_b(x, w)
    sites = dict(oc.top_sites(10))
    unit = 2 * 32 * 64 * 64
    assert sites[f"{__name__}._site_a"]["dot_flops"] == unit
    assert sites[f"{__name__}._site_a"]["transcendentals"] == 32 * 64
    assert sites[f"{__name__}._site_b"]["dot_flops"] == 2 * unit
    assert sum(s["bytes"] for s in sites.values()) == oc.totals["bytes"]
    assert oc.top_sites(1)[0][0] == f"{__name__}._site_b"  # the most bytes
    with pytest.raises(ValueError):
        OpCounter().top_sites(1)


def test_slice_and_slice_write_conventions():
    """A slice counts twice its result and an in-place write twice the
    update, as ``hlo_cost`` counts dynamic-slice / dynamic-update-slice;
    views and allocations move nothing."""
    def g(x, y):
        x[:, :8].copy_(y)  # slice view (2 x 16x8) + write of the update (2 x 16x8)
        return x.view(-1).t()

    _, c = op_cost(g, _meta(16, 32), _meta(16, 8))
    assert c["bytes"] == 4 * (2 * 16 * 8 + 2 * 16 * 8)
    _, c = op_cost(lambda: torch.empty(1000, device="meta"))
    assert c["bytes"] == 0


def test_temp_peak_tracks_live_tensors():
    def g(x):
        a = x * 2  # 4 KB
        b = a + 1  # 8 KB live
        del a
        return b.sum()  # b and the scalar: 4 KB + 4

    _, c = op_cost(g, _meta(1000))
    assert c["temp_size_in_bytes"] == 8000


def test_collectives_come_from_comm_counters():
    with fake_world(4):
        mesh = make_local_mesh(2, 2)
        t = _meta(8, 16)
        with OpCounter() as oc:
            comm.all_gather(t, mesh, "model", dim=0)
            comm.all_gather(t, mesh, "data", dim=1)
            comm.sum_in_rank_order(t, mesh, "data")
    assert oc.cost()["collectives"] == {"all-gather": {"count": 2, "bytes": 2 * 8 * 16 * 4},
                                        "all-reduce": {"count": 1, "bytes": 8 * 16 * 4}}


def test_prefill_dot_flops_equal_reference_hlo_cost():
    """The smoke ``vusa_edge`` prefill: the port's counted products equal
    ``hlo_cost``'s loop-weighted dots of the reference's compiled prefill,
    exactly.  Both run the same products: q/k/v/o, the MLP trio and the
    head at the last position, and the attention's two einsums per KV
    chunk (one chunk at 16 tokens); the embedding is a gather on both
    sides, and XLA's fusions keep their dots, which ``hlo_cost`` counts."""
    cfg = ref_smoke("vusa_edge")
    model = ref_build(cfg)
    tok = jax.ShapeDtypeStruct((2, 16), jnp.int32)
    text = jax.jit(lambda p, b: model.prefill(p, b, 32)).lower(
        model.abstract_params(), {"tokens": tok}).compile().as_text()
    want = hlo_cost(text)["dot_flops"]
    port = build_model(get_smoke_config("vusa_edge"))
    batch = {"tokens": torch.empty((2, 16), dtype=torch.int32, device="meta")}
    _, c = op_cost(lambda: port.prefill(port.abstract_params(), batch, 32))
    assert c["dot_flops"] == want
