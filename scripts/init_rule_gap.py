#!/usr/bin/env python3
"""How far a random deep model amplifies fp32 rounding, by init rule.

    PYTHONPATH=src python scripts/init_rule_gap.py [--arch qwen2_0_5b] \
        [--layers 2 8 16 24] [--device cpu]

For each depth: ``arch`` at full width cut to that many layers, fp32
activations, pruned to the config's sparsity and packed (scope "all",
fp32 values); one prefill of 4 prompts of 32 tokens, then the first decode
step through the pack and through the dense weights from the same cache.
Printed: the largest gap between the two steps' logits, under two inits
of the weights from one seed, each drawn with std ``scale / sqrt(fan_in)``:

- ``port``: fan_in = ``shape[-2]`` for every leaf, the port's and the
  reference's rule (``models/common.py _init_leaf``), which for the 3-D
  attention weights is the head count (wq/wk/wv) or the head width (wo);
- ``fan_in``: fan_in = the dims the weight contracts over (d_model for
  wq/wk/wv, heads x head width for wo), as ``chip_smoke.py``'s phase 13
  draws it.

Biases and norm scales (zero at init) are drawn from normal(0, 0.5) in
both.  The two steps compute the same function in a different order, so
the gap is fp32 rounding carried through the layers (ROADMAP C6).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.pruning import prune_tree  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import strict_fp32  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402
from repro_torch.serve.packed import lm_decode_step_packed  # noqa: E402


def fan_in(rule: str, name: str, shape) -> int:
    if rule == "fan_in" and name in ("wq", "wk", "wv"):
        return shape[-3]
    if rule == "fan_in" and name == "wo":
        return shape[-3] * shape[-2]
    return shape[-2] if len(shape) >= 2 else shape[-1]


def init(cfg, rule: str, device, seed: int = 0) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed)

    def build(tree):
        out = {}
        for name, spec in tree.items():
            if isinstance(spec, dict):
                out[name] = build(spec)
                continue
            std = 0.5 if spec.init == "zeros" else spec.scale / math.sqrt(
                fan_in(rule, name, spec.shape))
            out[name] = torch.randn(spec.shape, generator=gen, device=device) * std
        return out

    return build(build_model(cfg).specs())


def gap(cfg, params, device) -> tuple[float, float]:
    eng = Engine(cfg, params, ServeConfig(max_len=72, packed_weights="all", fused=False),
                 device=device)
    prompts = np.random.default_rng(1).integers(1, cfg.vocab, (4, 32)).astype(np.int32)
    with torch.no_grad():
        nxt, cache = eng.prime(prompts)
        copy = {k: v.clone() for k, v in cache.items()}
        packed = lm_decode_step_packed(eng.params, eng.packed, nxt, cache, cfg)[0]
        dense = eng.model.decode_step(eng.params, nxt, copy)[0]
    return float((packed - dense).abs().max()), float(dense.abs().max())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2_0_5b")
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 8, 16, 24])
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    strict_fp32()
    dev = torch.device(args.device)
    for n in args.layers:
        cfg = dataclasses.replace(get_config(args.arch), n_layers=n, dtype="float32")
        for rule in ("port", "fan_in"):
            params = prune_tree(init(cfg, rule, dev), cfg.sparsity)
            g, top = gap(cfg, params, dev)
            print(f"{args.arch} {n} layers, {rule} init: packed vs dense first-step logit gap "
                  f"{g:.4g} (largest |logit| {top:.4g}) on {args.device}", flush=True)


if __name__ == "__main__":
    main()
