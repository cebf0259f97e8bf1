"""Trainer: the train step in a loop, iterative magnitude pruning (the
paper's sparsity source) as a first-class schedule, checkpoint/restart with
exact data resume, preemption handling and a straggler watchdog.

Port of the JAX package's ``train/trainer.py``, on one device or, with
``mesh``, on the ranks of a (data, model) DeviceMesh that all run the same
code (``launch/mesh.py``): the parameters and both AdamW moments are
stored as each rank's shards under ``dist.sharding.params_shardings``,
the batch rows split over every pure data axis, ``("pod", "data")``
flattened pod-major as the reference's batch placement (when their
product divides them), and the step is ``train/step.py``'s sharded step
under the family's training plan on every mesh (``dist.tp.training_plan``:
no rank gathers the tree; each layer's ``data``-sharded leaves are
gathered at use and their gradients reduce-scattered; the moe family's
experts, the SSM's heads, the RG-LRU's channels and the encdec family's
encoder and decoder heads split over ``model`` where it is above 1), the
moe routing over the whole batch where the rows split.  Each rank draws its shards leaf by leaf, and the
pruning masks are refreshed one leaf at a time (each leaf gathered whole,
``magnitude_mask`` on it, this rank's shard kept: the single-device masks,
bitwise).  A checkpoint stays the logical tree with the reference's files
and leaf keys, and any mesh restores it: on a mesh it is written from the
shards one leaf at a time (the params and both moments, each leaf
gathered whole to the host of the mesh's first rank,
``dist.sharding.gather_to_first``, written and dropped before the next:
``checkpoint.ckpt.save_stream``), so no rank holds more than its shards
and one leaf whole, and the files are one device's save of the gathered
tree, byte for byte.  ``train()`` returns the same on one device as
before; on a mesh it builds no whole tree: it returns this rank's
``shards`` (which ``Engine(mesh=)`` takes as they are) and views of the
whole params and moments that gather a leaf when it is read (see
``train``).  Fault-tolerance model:
  * the data pipeline is a pure function of the step, so a restart resumes
    the exact stream (``SyntheticDataset.skip_to``);
  * SIGTERM/SIGINT set a flag that makes the loop checkpoint and stop after
    the current step (preemption); the handlers are installed on the main
    thread only and put back when ``train`` returns;
  * a watchdog flags steps slower than ``straggler_factor`` x the rolling
    median (it logs).
The step is deterministic on the card (``families._embed_tokens``), so a
resumed run is bitwise the uninterrupted one when it resumes at a step
where the pruning masks are refreshed (the masks are not checkpointed, as
in the reference).
"""

from __future__ import annotations

import dataclasses
import math
import signal
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..checkpoint.ckpt import Checkpointer, _flatten
from ..configs.base import ArchConfig
from ..dist.comm import axes_index, mesh_shape, sum_in_rank_order
from ..dist.sharding import _batch_axes, _names
from ..core.pruning import (
    _prunable, apply_masks, magnitude_mask, masks_tree, polynomial_sparsity, tree_sparsity,
)
from ..data.pipeline import SyntheticDataset
from ..models import build_model
from ..optim import AdamState, adamw_init
from ..optim.adamw import tree_items
from .step import TrainHParams, make_train_step

__all__ = ["TrainConfig", "Trainer"]


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    hp: TrainHParams = dataclasses.field(default_factory=TrainHParams)
    # pruning schedule (VUSA): ramp to cfg.sparsity between these steps
    prune_begin: int = 20
    prune_end: int = 80
    prune_every: int = 10
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    straggler_factor: float = 2.0
    seed: int = 0
    token_range: int = 0  # >0: narrow token distribution (learnable synthetic)


class Trainer:
    def __init__(self, cfg: ArchConfig, tc: TrainConfig, device="cuda", mesh=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer(device='cuda') needs a CUDA device; pass device='cpu' "
                               "to train on the CPU")
        self.cfg, self.tc = cfg, tc
        self.model = build_model(cfg)
        self.mesh = mesh if math.prod(mesh_shape(mesh).values()) > 1 else None
        self.rows = None  # this rank's rows of each batch, on a data axis that divides it
        self.p_shard = self.plan = None
        if self.mesh is not None:
            from ..dist.sharding import params_shardings
            from ..dist.tp import training_plan

            self.p_shard = params_shardings(self.model.specs(), self.mesh)
            self.plan = training_plan(cfg, self.mesh)
            # the batch rule's axes, ("pod", "data"), flattened pod-major
            axes = _batch_axes(self.mesh)
            shape = mesh_shape(self.mesh)
            dp = math.prod(shape[a] for a in axes)
            if dp > 1 and tc.global_batch % dp == 0:
                k = tc.global_batch // dp
                r = axes_index(self.mesh, axes)
                self.rows = slice(r * k, (r + 1) * k)
        self.step_fn = make_train_step(self.model.loss, tc.hp, self.mesh, self.p_shard,
                                       split=self.rows is not None, plan=self.plan)
        self.ckpt = Checkpointer(tc.ckpt_dir) if tc.ckpt_dir else None
        self._preempted = False
        self.metrics_log: List[Dict] = []

    # -- fault tolerance hooks ------------------------------------------------
    def _install_signal_handlers(self) -> dict:
        """Preemption handlers for SIGTERM/SIGINT on the main thread; returns
        the handlers they replaced (none off the main thread)."""
        if threading.current_thread() is not threading.main_thread():
            return {}

        def handler(signum, frame):
            self._preempted = True

        return {sig: signal.signal(sig, handler) for sig in (signal.SIGTERM, signal.SIGINT)}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- setup ----------------------------------------------------------------
    def init_state(self):
        """The initial parameters and AdamW state: on a mesh, this rank's
        shards of the whole init, each leaf drawn (the same on every rank)
        and cut on the host before it moves, so the whole tree never
        exists."""
        leaf = None
        if self.mesh is not None:
            from ..dist.sharding import local_shard

            spec = dict(tree_items(self.p_shard))

            def leaf(path, t):
                return local_shard(t, spec[path], self.mesh)

        params = self.model.init(self.tc.seed, device=self.device, leaf=leaf)
        return params, adamw_init(params)

    def refresh_masks(self, params: dict, sparsity: float) -> dict:
        """Keep-masks of ``params`` at ``sparsity`` (``masks_tree``); on a
        mesh this rank's shards of the whole tree's masks, one leaf at a
        time: each prunable leaf gathered whole (``dist.tp.WholeView``), its
        mask made and cut to this rank's shard, so the peak is one leaf
        whole and the masks are the single-device ones bitwise."""
        if self.mesh is None:
            return masks_tree(params, sparsity)
        from ..dist.sharding import local_shard
        from ..dist.tp import WholeView

        view = WholeView(params, self.p_shard, self.mesh)

        def walk(tree, whole, pls, path):
            return {k: walk(v, whole[k], pls[k], path + (k,)) if isinstance(v, dict)
                    else local_shard(magnitude_mask(whole[k], sparsity), pls[k], self.mesh)
                    if _prunable(path + (k,), v) else None for k, v in tree.items()}

        return walk(params, view, self.p_shard, ())

    def _save(self, step: int, params: dict, opt) -> None:
        """Checkpoint the logical tree.  On a mesh every rank walks the leaves
        in the files' order (the params and both moments), each leaf
        gathered whole to the host of the mesh's first rank
        (``gather_to_first``), which writes it and drops it before the
        next (``Checkpointer.save_stream``)."""
        if self.mesh is None:
            self.ckpt.save(step, {"params": params, "opt": opt})
            return
        from ..dist.sharding import gather_to_first, mesh_coords

        coords = mesh_coords(self.mesh)
        pls = _flatten({"params": self.p_shard,
                        "opt": AdamState(step=None, mu=self.p_shard, nu=self.p_shard)})
        state = sorted(_flatten({"params": params, "opt": opt}).items())
        leaves = ((key, gather_to_first(leaf, pls.get(key) or (), self.mesh, coords))
                  for key, leaf in state)
        if not any(self.mesh.get_coordinate()):
            self.ckpt.save_stream(step, leaves)
        else:
            for _ in leaves:  # the gathers, in the writer's order
                pass

    def _sparsity(self, params: dict) -> float:
        """``tree_sparsity`` of the whole tree from this rank's shards: each
        prunable leaf's zeros counted on the ranks holding its distinct
        shards (coordinate 0 on the axes its placement leaves whole), the
        counts summed over the mesh (exact integers); the same float as
        one device's on the gathered tree."""
        sizes = mesh_shape(self.mesh)
        coord = dict(zip(self.mesh.mesh_dim_names, self.mesh.get_coordinate()))
        pls = dict(tree_items(self.p_shard))
        zeros, total = 0, 0
        for path, leaf in tree_items(params):
            if _prunable(path, leaf):
                used = {a for e in pls[path] for a in _names(e)}
                if all(i == 0 for a, i in coord.items() if a not in used):
                    zeros += int((leaf == 0).sum())
                total += leaf.numel() * math.prod(sizes[a] for a in used)
        zeros = sum_in_rank_order(torch.tensor(zeros, dtype=torch.int64, device=self.device),
                                  self.mesh, tuple(sizes))
        return int(zeros) / max(total, 1)

    def train(self) -> Dict:
        """The run (``TrainConfig``), resumed from the latest checkpoint when
        one exists.  Returns ``{"params", "opt", "final_loss", "sparsity",
        "steps_run"}``: on one device the trained tree and AdamW state; on a
        mesh also ``"shards"``, this rank's shards of the params, and then
        ``"params"`` and ``"opt"``'s moments are ``dist.tp.WholeView`` s of
        the shards (``opt.step`` a tensor): a leaf read is gathered whole on
        every rank of the mesh (a collective), never cached, so every rank
        must read the same leaves in the same order (``tree_items`` reads
        every leaf in sorted key order) and no rank holds more than the
        leaves it keeps.  ``"sparsity"`` is one device's
        ``tree_sparsity`` of the gathered tree, bitwise, counted from the
        shards."""
        previous = self._install_signal_handlers()
        try:
            return self._train()
        finally:
            for sig, h in previous.items():
                signal.signal(sig, h)

    def _train(self) -> Dict:
        tc, cfg = self.tc, self.cfg
        params, opt = self.init_state()
        start_step = 0
        if self.ckpt:
            shardings = None
            if self.mesh is not None:
                shardings = {"params": self.p_shard,
                             "opt": AdamState(step=None, mu=self.p_shard, nu=self.p_shard)}
            got, restored = self.ckpt.restore_latest({"params": params, "opt": opt}, shardings,
                                                     self.mesh)
            if got is not None:
                params, opt = restored["params"], restored["opt"]
                start_step = got
        data = SyntheticDataset(
            cfg, tc.global_batch, tc.seq_len, seed=tc.seed, token_range=tc.token_range
        ).skip_to(start_step)

        times: List[float] = []
        it = iter(data)
        final_loss = float("nan")
        masks = None  # persistent keep-masks once pruning starts
        step = start_step - 1
        for step in range(start_step, tc.steps):
            batch = {k: torch.from_numpy(v if self.rows is None else v[self.rows]).to(self.device)
                     for k, v in next(it).items()}
            t0 = time.perf_counter()
            params, opt, metrics = self.step_fn(params, opt, batch)
            self._sync()
            dt = time.perf_counter() - t0

            # straggler watchdog
            times.append(dt)
            med = float(np.median(times[-20:]))
            if len(times) > 5 and dt > tc.straggler_factor * med:
                print(f"[straggler] step {step}: {dt:.2f}s vs median {med:.2f}s", flush=True)

            # iterative magnitude pruning toward cfg.sparsity: refresh the
            # keep-masks on the schedule, re-apply them every step so the
            # optimizer cannot resurrect pruned weights
            if cfg.sparsity > 0 and step >= tc.prune_begin and step % tc.prune_every == 0:
                target = polynomial_sparsity(step, tc.prune_begin, tc.prune_end, cfg.sparsity)
                masks = self.refresh_masks(params, target)
            if masks is not None:
                apply_masks(params, masks)

            final_loss = float(metrics["loss"])
            if step % tc.log_every == 0 or step == tc.steps - 1:
                rec = {"step": step, "loss": final_loss, "dt": dt,
                       "lr": float(metrics["lr"]), "gnorm": float(metrics["gnorm"])}
                self.metrics_log.append(rec)
                print(f"step {step:5d} loss {final_loss:.4f} dt {dt*1e3:.0f}ms", flush=True)

            if self.ckpt and ((step + 1) % tc.ckpt_every == 0 or self._preempted):
                self._save(step + 1, params, opt)
            if self._preempted:
                print(f"[preempt] checkpointed at step {step + 1}, exiting", flush=True)
                break

        if self.ckpt:
            self.ckpt.wait()
        out = {"params": params, "opt": opt, "final_loss": final_loss,
               "steps_run": step + 1 - start_step}
        if self.mesh is None:
            out["sparsity"] = tree_sparsity(params)
            return out
        from ..dist.tp import WholeView

        def view(tree):
            return WholeView(tree, self.p_shard, self.mesh)

        out.update(params=view(params), opt=AdamState(step=opt.step, mu=view(opt.mu),
                                                      nu=view(opt.nu)),
                   sparsity=self._sparsity(params), shards=params)
        return out
