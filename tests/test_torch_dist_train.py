"""Port: the sharded trainer on a (data, model) mesh of gloo ranks on the CPU.

One 2x2 world (``launch/mesh.spawn``, a rendezvous file under
``tmp_path``) trains the ``vusa_edge`` smoke config on its ``model``
sub-mesh (1x2), its ``data`` sub-mesh (2x1) and the whole mesh, with the
pruning masks refreshed on the way:

- 1x2 is the tensor-parallel trainer (``dist.tp.training_plan``): its
  ordered sums add the ranks' partials in another order than one device's
  products, so it is the single-device trainer within rounding, not
  bitwise: the loss every step within 1e-5 relative (measured 5.0e-6),
  the parameters within the bound Adam's steps put on a weight's move
  (measured 8.1e-5, bound about 1e-2), both moments within 1e-2 of each
  leaf's largest (measured 4.0e-3 and 3.7e-3, ``wv``: the gradients part
  by up to 5e-4 of the largest a step where the flash attention's bf16
  probabilities round apart, and the moments carry that over 4 steps),
  and the pruned sparsity equal (the ranks' bits agree with each other,
  ``test_ranks_agree``);
- 2x1 (each data rank takes half the batch, the gradients summed over the
  data ranks in rank order) stays within 1e-5 relative of the
  single-device loss at each of its 4 steps; the gap grows with steps, as
  Adam moves a weight whose tiny gradient changed sign;
- 2x1 in lockstep (each step from one device's state): the loss within
  1e-5 relative of the single-device step's; the summed gradients
  bitwise one device's step over the same batch in two microbatches, cut
  to the rank's shards (each layer's leaves gathered at use, their
  gradients reduce-scattered in rank order), the global norm within 1e-6
  of that step's (an ordered sum of the shards' squares), and each rank's
  updated shards bitwise one device's update of those gradients at the
  step's clip scale, so a wrong gradient sum or a wrong sharded update
  fails;
- a checkpoint written on 2x2 holds the logical tree, and 1x1 restores it
  bitwise equal to the 2x2 run's gathered state;
- the placements store each leaf as its shard: a rank holds half of
  ``embed`` on ``data`` and half of the vocabulary on ``model``;
- ``launch/train.py --data 2 --dist-backend gloo --device cpu`` runs.
"""

import dataclasses
import functools
from collections.abc import Mapping

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.ckpt import restore
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.dist.sharding import shard_tree
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import spawn
from repro_torch.models import build_model
from repro_torch.optim import AdamState, adamw_init
from repro_torch.optim.adamw import tree_items
from repro_torch.train import TrainConfig, Trainer, TrainHParams

STEPS = 4


def _tc(ckpt=None):
    return TrainConfig(steps=STEPS, global_batch=4, seq_len=16, ckpt_dir=ckpt,
                       ckpt_every=STEPS, token_range=64, prune_begin=1, prune_end=3,
                       prune_every=2, log_every=1,
                       hp=TrainHParams(lr=1e-3, warmup=1, total_steps=STEPS))


def _flat(tree, prefix=""):
    """Every leaf of ``tree`` (on a mesh the trainer's views of the whole
    tree: each leaf gathered as it is read, in sorted key order) by path."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _flat(v, f"{prefix}{k}/")
        elif v is not None:
            yield prefix + k, v.detach().cpu()


def _train(mesh, ckpt=None):
    tr = Trainer(get_smoke_config("vusa_edge"), _tc(ckpt), device="cpu", mesh=mesh)
    out = tr.train()
    return {"losses": [r["loss"] for r in tr.metrics_log],
            "params": dict(_flat(out["params"])), "mu": dict(_flat(out["opt"].mu)),
            "nu": dict(_flat(out["opt"].nu)), "sparsity": out["sparsity"]}


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(tree_items(a), tree_items(b)))


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _lockstep(mesh):
    """Each step of the data-parallel trainer on ``mesh`` taken from this
    rank's shards of the single-device state and its rows of the batch,
    beside one device's whole-batch step and its step over the same batch
    in two microbatches (the ranks' rows): per step, the loss gap to the
    whole-batch step (relative), the global norm's gap to the microbatched
    step's (relative: the norm is an ordered sum of the shards' squares,
    another order than one device's sum over each whole leaf), and whether
    the summed gradients (``return_grads``) equal the microbatched step's
    bitwise, cut to this rank's shards, and the updated shards (params,
    both moments) equal one device's AdamW update of those gradients at
    the step's own clip scale bitwise."""
    from repro_torch.dist.sharding import local_shard
    from repro_torch.optim import adamw_update

    cfg = get_smoke_config("vusa_edge")
    tc = _tc()
    one, dp = Trainer(cfg, tc, device="cpu"), Trainer(cfg, tc, device="cpu", mesh=mesh)
    halves = Trainer(cfg, dataclasses.replace(tc, hp=dataclasses.replace(tc.hp, microbatches=2)),
                     device="cpu")
    params, opt = one.init_state()
    data = iter(SyntheticDataset(cfg, tc.global_batch, tc.seq_len, seed=tc.seed,
                                 token_range=tc.token_range))
    shard = functools.partial(shard_tree, placements=dp.p_shard, mesh=mesh)
    spec = [pl for _, pl in tree_items(dp.p_shard)]
    out = []
    for _ in range(STEPS):
        host = next(data)
        batch = {k: torch.from_numpy(v) for k, v in host.items()}
        rows = {k: torch.from_numpy(v[dp.rows]) for k, v in host.items()}
        new, state, got = dp.step_fn(shard(params), AdamState(opt.step.clone(), shard(opt.mu),
                                                              shard(opt.nu)), rows,
                                     return_grads=True)
        _, _, split = halves.step_fn(
            _clone(params), AdamState(opt.step.clone(), _clone(opt.mu), _clone(opt.nu)), batch,
            return_grads=True)
        scale = torch.clamp(tc.hp.max_grad_norm / torch.clamp_min(got["gnorm"], 1e-9), max=1.0)
        ref, ref_opt = _clone(params), AdamState(opt.step.clone(), _clone(opt.mu), _clone(opt.nu))
        adamw_update(ref, [g * scale for g in split["grads"]], ref_opt, got["lr"],
                     weight_decay=tc.hp.weight_decay, max_grad_norm=float("inf"))
        params, opt, want = one.step_fn(params, opt, batch)
        grads = all(torch.equal(g, local_shard(w, pl, mesh))
                    for g, w, pl in zip(got["grads"], split["grads"], spec))
        out.append((abs(float(got["loss"]) / float(want["loss"]) - 1),
                    abs(float(got["gnorm"]) / float(split["gnorm"]) - 1),
                    grads and _equal(new, shard(ref)) and _equal(state.mu, shard(ref_opt.mu))
                    and _equal(state.nu, shard(ref_opt.nu))))
    return out


def _ranks(mesh, device, ckpt):
    trainer = Trainer(get_smoke_config("vusa_edge"), _tc(), device="cpu", mesh=mesh)
    params, _ = trainer.init_state()
    shapes = {k: tuple(v.shape) for k, v in _flat(params)}
    return {"1x2": _train(mesh["model"]), "2x1": _train(mesh["data"]),
            "2x1 lockstep": _lockstep(mesh["data"]), "2x2": _train(mesh, ckpt),
            "shapes": shapes}


@pytest.fixture(scope="module")
def single():
    return _train(None)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    return spawn(_ranks, 2, 2, "gloo", "cpu", str(tmp_path_factory.mktemp("mesh")),
                 args=(ckpt,)), ckpt


def _adam_move(tc) -> float:
    """The most a weight can move apart between two runs over ``tc``'s
    steps: each step at most 2 x lr x (Adam's largest |m_hat / sqrt(v_hat)|
    at that step, by Cauchy-Schwarz, plus the decay of a weight below 1)."""
    from repro_torch.optim.schedule import cosine_schedule

    hp, b1, b2 = tc.hp, 0.9, 0.95
    total = 0.0
    for t in range(1, tc.steps + 1):
        w = [((1 - b1) * b1 ** (t - i)) ** 2 / ((1 - b2) * b2 ** (t - i)) for i in range(1, t + 1)]
        bound = np.sqrt(sum(w)) * np.sqrt(1 - b2**t) / (1 - b1**t)
        total += 2 * cosine_schedule(t - 1, hp.warmup, hp.total_steps, hp.lr) * (
            bound + hp.weight_decay)
    return total


def test_model_axis_training_within_tolerance(world, single):
    for rank in world[0]:
        got = rank["1x2"]
        rel = np.abs(np.asarray(got["losses"]) - single["losses"]) / np.abs(single["losses"])
        assert len(got["losses"]) == STEPS and rel.max() <= 1e-5, rel
        move = _adam_move(_tc())
        for k, v in single["params"].items():
            assert float((got["params"][k] - v).abs().max()) <= move, k
        for leaf in ("mu", "nu"):
            for k, v in single[leaf].items():
                gap = float((got[leaf][k] - v).abs().max())
                assert gap <= 1e-2 * float(v.abs().max()), (leaf, k, gap)
        assert got["sparsity"] == single["sparsity"] > 0


def test_data_axis_training_within_tolerance(world, single):
    for rank in world[0]:
        got = rank["2x1"]["losses"]
        assert len(got) == STEPS
        rel = np.abs(np.asarray(got) - single["losses"]) / np.abs(single["losses"])
        assert rel.max() <= 1e-5, rel


def test_data_axis_step_matches_the_single_device_step(world):
    for rank in world[0]:
        gaps, norms, bitwise = zip(*rank["2x1 lockstep"])
        assert len(gaps) == STEPS and max(gaps) <= 1e-5, gaps
        assert max(norms) <= 1e-6, norms
        assert all(bitwise), bitwise


def test_ranks_agree(world):
    ranks = world[0]
    for mesh in ("1x2", "2x1", "2x2"):
        for k, v in ranks[0][mesh]["params"].items():
            assert all(torch.equal(r[mesh]["params"][k], v) for r in ranks[1:]), (mesh, k)


def test_checkpoint_from_2x2_restores_on_1x1(world):
    ranks, ckpt = world
    model = build_model(get_smoke_config("vusa_edge"))
    like = model.init(0, device="cpu")
    got = restore(ckpt, STEPS, {"params": like, "opt": adamw_init(like)})
    want = ranks[0]["2x2"]
    for k, v in _flat(got["params"]):
        assert torch.equal(v, want["params"][k]), k
    for leaf in ("mu", "nu"):
        for k, v in _flat(getattr(got["opt"], leaf)):
            assert torch.equal(v, want[leaf][k]), (leaf, k)
    assert int(got["opt"].step) == STEPS


def test_rank_holds_its_shards(world):
    cfg = get_smoke_config("vusa_edge")
    whole = {k: tuple(v.shape) for k, v in _flat(build_model(cfg).init(0, device="cpu"))}
    shapes = world[0][0]["shapes"]
    assert shapes["embed"] == (whole["embed"][0] // 2, whole["embed"][1] // 2)
    assert shapes["layers/ffn/w_up"] == (cfg.n_layers, cfg.d_model // 2, cfg.d_ff // 2)
    assert shapes["final_norm"] == (cfg.d_model // 2,)


def test_launcher_trains_on_a_data_axis(capfd):
    out = launch_train.main(["--arch", "vusa_edge", "--smoke", "--device", "cpu", "--data",
                             "2", "--dist-backend", "gloo", "--steps", "2", "--batch", "4",
                             "--seq", "16"])
    assert np.isfinite(out["final_loss"])
    assert "final loss" in capfd.readouterr().out
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "vusa_edge", "--smoke", "--device", "cpu", "--data", "2"])
