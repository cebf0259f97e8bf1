"""Quickstart on the PyTorch port: the full VUSA loop.

1. train a tiny LM with iterative magnitude pruning to 85 % sparsity,
2. pack its whole decode step (MLP + qkv/o + LM head) into the paper's
   row-wise VUSA format,
3. serve it through the hand-written CUDA kernels (the fused packed MLP and
   the row-packed matmul; their plain PyTorch versions with --device cpu),
4. check: identical greedy outputs, about 2.5x fewer weight bytes.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.core.growth import p_grow
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.packed import packed_byte_ratios
from repro_torch.train import TrainConfig, Trainer, TrainHParams


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args()

    cfg = get_smoke_config("vusa_edge")
    print(f"== training {cfg.name} to {cfg.sparsity:.0%} unstructured sparsity ==")
    tc = TrainConfig(
        steps=20,
        global_batch=4,
        seq_len=32,
        prune_begin=6,
        prune_end=16,
        prune_every=2,
        token_range=32,
        hp=TrainHParams(lr=2e-3, warmup=2, total_steps=20),
        log_every=5,
    )
    out = Trainer(cfg, tc, device=args.device).train()
    print(f"final loss {out['final_loss']:.3f}, sparsity {out['sparsity']:.2%}")

    print("\n== serving: dense vs whole-model VUSA-packed ==")
    prompts = np.ones((2, 8), np.int32)
    dense = Engine(cfg, out["params"], ServeConfig(max_len=64),
                   device=args.device).generate(prompts, max_new=12)
    packed_eng = Engine(cfg, out["params"], ServeConfig(max_len=64, packed_weights="all"),
                        device=args.device)
    packed = packed_eng.generate(prompts, max_new=12)

    match = (dense["tokens"] == packed["tokens"]).all()
    print(f"greedy outputs identical: {match}")
    assert match

    ratios = packed_byte_ratios(packed_eng.packed)
    print(f"decode-step weight bytes: packed/dense = {ratios['total']:.3f} "
          f"(mlp {ratios['w_gate']:.2f}, attn {ratios['wq']:.2f}, head "
          f"{ratios.get('lm_head', float('nan')):.2f})")
    print(
        f"growth model check: P(row of 128 fits 16 slots @ 85% sparsity) = "
        f"{p_grow(1, 128, 16, 0.15):.3f} (1 job almost never suffices -> expect ~2-3 jobs)"
    )
    print("\nquickstart OK")


if __name__ == "__main__":
    main()
