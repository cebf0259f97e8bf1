#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 9 ("scheduler") alone, on one card.

    python3 scripts/scheduler_phase.py

Builds the kernels, makes the four engines phase 9 runs over (full-width
``vusa_edge``, numpy seed 0, 85 % magnitude pruning, bf16 activations:
dense, and packed with fp32, int8 and int4 values) and runs the phase with
all its gates (``chip_smoke.scheduler_phase``): a run that fails a gate
exits 1.  Prints the card and the phase's numbers and writes them to
``chiprun_out/scheduler_phase.json``.  For iterating on the scheduler
without the other phases; ``chip_smoke.py`` runs the same phase.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.pruning import prune_tree  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402


def engines(cfg, params) -> dict:
    """Phase 9's engines, built as ``chip_smoke.main`` builds them."""
    def mk(**kw):
        return Engine(cfg, params, ServeConfig(max_len=cs.PROMPT + cs.MAX_NEW + 8, fused=False,
                                               **kw), device=cs.DEVICE)

    return {"dense": mk(), "fp32": mk(packed_weights="all"),
            "int8": mk(packed_weights="all", packed_values="int8"),
            "int4": mk(packed_weights="all", packed_values="int4")}


def main() -> None:
    cs.strict_fp32()
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.monotonic()
    build.build(force=True)
    cfg = get_config("vusa_edge")
    params = prune_tree(build_model(cfg).init(0, device=cs.DEVICE), cfg.sparsity)
    engs = engines(cfg, params)
    print(f"build, init, prune and pack {time.monotonic() - t0:.1f}s", flush=True)
    res = cs.scheduler_phase(cfg, params, engs)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "scheduler_phase.json").write_text(json.dumps({"card": card, **res}, indent=1))
    for what, st in res["sequential"].items():
        print(f"sequential {what}: {json.dumps(st)}", flush=True)
    for key in ("row_stability", "prime_many_vs_prime", "ms_per_step", "traffic", "seconds"):
        print(f"{key}: {json.dumps(res[key])}", flush=True)


if __name__ == "__main__":
    main()
