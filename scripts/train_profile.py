#!/usr/bin/env python3
"""Where a training step of the port goes, and what the global clip does.

    python3 scripts/train_profile.py                      # on the card
    PYTHONPATH=src python3 scripts/train_profile.py --device cpu --width 384 --layers 6 \\
        --steps 100 --clip 1.0

Three measurements on ``vusa_edge`` (``--width`` / ``--layers`` cut it;
the heads stay 64 wide), from the port's numpy-seeded init, on
``chip_smoke.py`` phase 12's stream (tokens from [0, 256), batch 8 x 128)
and schedule (lr 1e-3, warmup a tenth, cosine, the pruning ramp scaled to
``--steps``):

1. each leaf's gradient norm at the init (one batch), and the global norm
   a clip at ``--clip`` divides by;
2. ``--steps`` steps through the ``Trainer`` with ``max_grad_norm =
   --clip`` (default: no clip, as phase 12): the mean loss of the first
   and of the last 10 steps;
3. on the card, ``torch.profiler`` over ``--profile`` further steps
   (``chip_smoke.profile_window``): the step between CUDA events, the
   device's busy time and share, its events a step, and the kernels that
   take the most device time.

Prints the card (or "cpu") beside every number and writes them to
``chiprun_out/train_profile.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticDataset  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.adamw import tree_items  # noqa: E402
from repro_torch.train import TrainConfig, Trainer, TrainHParams  # noqa: E402
from repro_torch.train.step import _value_and_grad  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=None, help="d_model (default: the config's)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--steps", type=int, default=cs.TRAIN_STEPS)
    ap.add_argument("--clip", type=float, default=cs.TRAIN_CLIP)
    ap.add_argument("--profile", type=int, default=3, help="profiled steps (card only)")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu")
    cs.strict_fp32()
    where = cs.card_line() if args.device == "cuda" else "cpu"
    cfg = get_config("vusa_edge")
    d = args.width or cfg.d_model
    cfg = dataclasses.replace(cfg, d_model=d, n_heads=d // 64, kv_heads=d // 64, d_ff=4 * d,
                              n_layers=args.layers or cfg.n_layers)
    out = {"device": where, "config": dataclasses.asdict(cfg), "clip": args.clip}

    # 1. the gradient norms at the init
    model = build_model(cfg)
    params = model.init(0, device=args.device)
    batch = next(iter(SyntheticDataset(cfg, cs.TRAIN_BATCH, cs.TRAIN_SEQ,
                                       token_range=cs.TRAIN_TOKENS)))
    _, grads = _value_and_grad(model.loss, params,
                               {"tokens": torch.from_numpy(batch["tokens"]).to(args.device)})
    norms = {"/".join(p): float(g.norm()) for (p, _), g in zip(tree_items(params), grads)}
    out["grad_norms_at_init"] = norms
    out["global_grad_norm_at_init"] = float(np.sqrt(sum(n * n for n in norms.values())))
    print(f"grad norms at init ({where}): " + ", ".join(f"{k} {v:.4g}" for k, v in norms.items())
          + f"; global {out['global_grad_norm_at_init']:.4g}", flush=True)
    del params, grads

    # 2. training with the given clip
    s = args.steps
    tc = TrainConfig(steps=s, global_batch=cs.TRAIN_BATCH, seq_len=cs.TRAIN_SEQ,
                     prune_begin=s // 5, prune_end=s * 7 // 10, prune_every=10, log_every=s,
                     token_range=cs.TRAIN_TOKENS,
                     hp=TrainHParams(lr=cs.TRAIN_LR, warmup=max(s // 10, 1), total_steps=s,
                                     max_grad_norm=args.clip))
    tr = Trainer(cfg, tc, device=args.device)
    inner, losses = tr.step_fn, []

    def step(p, o, b):
        res = inner(p, o, b)
        losses.append(res[2]["loss"])
        return res

    tr.step_fn = step
    t0 = time.monotonic()
    trained = tr.train()
    losses = [float(x) for x in losses]
    out["train"] = {"steps": s, "seconds": time.monotonic() - t0, "loss_first10":
                    float(np.mean(losses[:10])), "loss_last10": float(np.mean(losses[-10:])),
                    "sparsity": trained["sparsity"]}
    print(f"train {s} steps, clip {args.clip} ({where}): loss "
          f"{out['train']['loss_first10']:.4f} (first 10) -> {out['train']['loss_last10']:.4f} "
          f"(last 10), sparsity {trained['sparsity']:.4f}", flush=True)

    # 3. the profile of a few more steps, on the card
    if args.device == "cuda" and args.profile:
        from torch.profiler import ProfilerActivity, profile

        params, opt = trained["params"], trained["opt"]
        data = iter(SyntheticDataset(cfg, cs.TRAIN_BATCH, cs.TRAIN_SEQ,
                                     token_range=cs.TRAIN_TOKENS).skip_to(s))
        tr.step_fn = inner

        def one():
            b = {k: torch.from_numpy(v).to(args.device) for k, v in next(data).items()}
            inner(params, opt, b)
            torch.cuda.synchronize()

        n = args.profile
        tr_ = cs.per_step(cs.profile_window(lambda: [one() for _ in range(n)]), n)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                one()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
        out["profile"] = {"steps": n, **tr_, "top_kernels_ms_per_step": {
            e.key: e.self_device_time_total / 1e3 / n for e in top}}
        print(cs.trace_line(f"train step, {n} steps ({where})", tr_), flush=True)
        print("most device time a step: " + "; ".join(
            f"{k[:70]} {v:.3f} ms" for k, v in out["profile"]["top_kernels_ms_per_step"].items()),
            flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "train_profile.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
