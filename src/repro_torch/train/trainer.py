"""Trainer: the train step in a loop, iterative magnitude pruning (the
paper's sparsity source) as a first-class schedule, checkpoint/restart with
exact data resume, preemption handling and a straggler watchdog.

Port of the JAX package's ``train/trainer.py`` on one device (no mesh:
sharding comes with ROADMAP.md A12).  Fault-tolerance model:
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
import signal
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..checkpoint.ckpt import Checkpointer
from ..configs.base import ArchConfig
from ..core.pruning import apply_masks, masks_tree, polynomial_sparsity, tree_sparsity
from ..data.pipeline import SyntheticDataset
from ..models import build_model
from ..optim import adamw_init
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
    def __init__(self, cfg: ArchConfig, tc: TrainConfig, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer(device='cuda') needs a CUDA device; pass device='cpu' "
                               "to train on the CPU")
        self.cfg, self.tc = cfg, tc
        self.model = build_model(cfg)
        self.step_fn = make_train_step(self.model.loss, tc.hp)
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
        params = self.model.init(self.tc.seed, device=self.device)
        return params, adamw_init(params)

    def train(self) -> Dict:
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
            got, restored = self.ckpt.restore_latest({"params": params, "opt": opt})
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
            batch = {k: torch.from_numpy(v).to(self.device) for k, v in next(it).items()}
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
                masks = masks_tree(params, target)
            if masks is not None:
                apply_masks(params, masks)

            final_loss = float(metrics["loss"])
            if step % tc.log_every == 0 or step == tc.steps - 1:
                rec = {"step": step, "loss": final_loss, "dt": dt,
                       "lr": float(metrics["lr"]), "gnorm": float(metrics["gnorm"])}
                self.metrics_log.append(rec)
                print(f"step {step:5d} loss {final_loss:.4f} dt {dt*1e3:.0f}ms", flush=True)

            if self.ckpt and ((step + 1) % tc.ckpt_every == 0 or self._preempted):
                self.ckpt.save(step + 1, {"params": params, "opt": opt})
            if self._preempted:
                print(f"[preempt] checkpointed at step {step + 1}, exiting", flush=True)
                break

        if self.ckpt:
            self.ckpt.wait()
        return {
            "params": params,
            "opt": opt,
            "final_loss": final_loss,
            "sparsity": tree_sparsity(params),
            "steps_run": step + 1 - start_step,
        }
