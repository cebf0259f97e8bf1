"""How far one device's gradient moves when its batch is split in two.

A data-parallel step sums the gradients of each rank's rows; on one device
the same batch is one product over all rows.  This script takes
``vusa_edge`` (full width, ``--layers`` deep, the port's init) through
``--steps`` single-device AdamW steps of ``chip_smoke.py``'s training
stream (batch 8 x 128), and at each step's state compares the whole-batch
loss and gradients with the mean of the two half-batch ones, in one
process: no mesh, no collective.  It also takes the whole-batch gradients
twice, to show whether one device's own gradient is repeatable.  Printed
per step and dtype: the loss's relative gap, the global gradient norm's
relative gap, and the leaf whose gradient moved most (L2 of the
difference over L2 of the leaf).

    python3 scripts/grad_split.py [--device cuda] [--layers 2] [--steps 20]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticDataset  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import strict_fp32  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.optim.adamw import tree_items  # noqa: E402
from repro_torch.optim.schedule import cosine_schedule  # noqa: E402
from repro_torch.train.step import _value_and_grad  # noqa: E402

BATCH, SEQ, TOKENS, LR, WARMUP = 8, 128, 256, 1e-3, 20  # chip_smoke.py's training stream


def _norm(ts) -> float:
    return math.sqrt(sum(float(t.double().square().sum()) for t in ts))


def run(dtype: str, layers: int, steps: int, device: str) -> list:
    cfg = dataclasses.replace(get_config("vusa_edge"), n_layers=layers, dtype=dtype)
    model = build_model(cfg)
    params = model.init(0, device=device)
    opt = adamw_init(params)
    data = iter(SyntheticDataset(cfg, BATCH, SEQ, seed=0, token_range=TOKENS))
    names = [".".join(p) for p, _ in tree_items(params)]
    out = []
    for step in range(steps):
        host = next(data)
        batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        halves = [{k: v[i * BATCH // 2:(i + 1) * BATCH // 2] for k, v in batch.items()}
                  for i in range(2)]
        loss, grads = _value_and_grad(model.loss, params, batch)
        _, again = _value_and_grad(model.loss, params, batch)
        parts = [_value_and_grad(model.loss, params, h) for h in halves]
        split_loss = (parts[0][0] + parts[1][0]) / 2
        split = [(a + b) / 2 for a, b in zip(parts[0][1], parts[1][1])]
        moved = [_norm([s - g]) / max(_norm([g]), 1e-30) for s, g in zip(split, grads)]
        worst = max(range(len(moved)), key=moved.__getitem__)
        out.append({
            "step": step,
            "loss_rel": abs(float(split_loss) / float(loss) - 1),
            "gnorm_rel": abs(_norm(split) / _norm(grads) - 1),
            "repeat_equal": all(torch.equal(a, b) for a, b in zip(grads, again)),
            "worst_leaf": names[worst], "worst_leaf_rel": moved[worst],
        })
        lr = cosine_schedule(step, WARMUP, steps, LR)
        adamw_update(params, grads, opt, lr, max_grad_norm=float("inf"))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    if args.device.startswith("cuda"):
        strict_fp32()
    res = {dt: run(dt, args.layers, args.steps, args.device) for dt in ("float32", "bfloat16")}
    for dt, rows in res.items():
        for r in rows:
            print(dt, json.dumps(r), flush=True)
        print(dt, "max loss_rel", max(r["loss_rel"] for r in rows), "max gnorm_rel",
              max(r["gnorm_rel"] for r in rows), "repeatable",
              all(r["repeat_equal"] for r in rows), flush=True)


if __name__ == "__main__":
    main()
