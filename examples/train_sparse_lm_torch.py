"""End-to-end run on the PyTorch port: train a ~100M-parameter LM with
the VUSA pruning schedule for a few hundred steps, with checkpointing and
exact restart.

The default preset is the paper-scale vusa_edge config (~160M params);
``--preset smoke`` is CPU-sized.

Run:  PYTHONPATH=src python examples/train_sparse_lm_torch.py --steps 200 [--device cpu]
"""

import argparse
import json
import time
from pathlib import Path

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.train import TrainConfig, Trainer, TrainHParams


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="full", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default="experiments/train_run_torch/ckpt")
    ap.add_argument("--out", default="experiments/train_run_torch/metrics.json")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args()

    cfg = get_config("vusa_edge") if args.preset == "full" else get_smoke_config("vusa_edge")
    n_params = cfg.param_count()
    print(f"arch {cfg.name}: ~{n_params/1e6:.0f}M params, target sparsity {cfg.sparsity:.0%}")

    tc = TrainConfig(
        steps=args.steps,
        global_batch=args.batch,
        seq_len=args.seq,
        token_range=256,  # learnable synthetic stream
        prune_begin=args.steps // 4,
        prune_end=3 * args.steps // 4,
        prune_every=max(args.steps // 40, 1),
        ckpt_dir=args.ckpt,
        ckpt_every=max(args.steps // 4, 10),
        log_every=10,
        hp=TrainHParams(lr=3e-4, warmup=args.steps // 10, total_steps=args.steps),
    )
    t0 = time.time()
    trainer = Trainer(cfg, tc, device=args.device)
    out = trainer.train()
    wall = time.time() - t0

    result = {
        "arch": cfg.name,
        "device": args.device,
        "params_m": n_params / 1e6,
        "steps": out["steps_run"],
        "final_loss": out["final_loss"],
        "final_sparsity": out["sparsity"],
        "wall_s": wall,
        "tokens_per_s": out["steps_run"] * args.batch * args.seq / wall,
        "log": trainer.metrics_log,
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(
        f"done: {out['steps_run']} steps, loss {out['final_loss']:.3f}, "
        f"sparsity {out['sparsity']:.2%}, {result['tokens_per_s']:.0f} tok/s -> {args.out}"
    )


if __name__ == "__main__":
    main()
