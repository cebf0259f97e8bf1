#!/usr/bin/env python3
"""The packed route's decode step on a 1x2 mesh, for two trees, in turns.

    python3 scripts/ab_packed_mesh.py --parent DIR

``DIR`` holds another checkout of the repository (e.g. the parent commit
unpacked with ``git archive`` into a gitignored directory such as
``build/parent``).  For each tree, in the order parent, this tree, this
tree, parent, a fresh process builds that tree's kernels and spawns two
gloo ranks sharing the card on a 1x2 (data, model) mesh; each rank serves
full-width ``vusa_edge`` (12 layers, the seeded init pruned to its
sparsity, packed "all" with fp32 values, eager) and runs ``generate`` of
B = 4 prompts of 32 tokens, 8 new, three times after a warm-up.  One line
per run: each rank's ms a decode step of the three, the collectives of
each ``generate`` (prefill and decode), the first row's tokens and the
run's seconds.  Every line also goes to ``chiprun_out/ab_packed_mesh.json``.
With ``--tree DIR`` it runs one tree in this process (``--cpu``: the smoke
config on the CPU, a quick check of the script).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BATCH, PROMPT, NEW, REPEATS = 4, 32, 8, 3


def rank(mesh, device, prompts, cpu):
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.pruning import prune_tree
    from repro_torch.dist import comm
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_smoke_config("vusa_edge") if cpu else get_config("vusa_edge")
    params = prune_tree(build_model(cfg).init(0, device=device), cfg.sparsity)
    eng = Engine(cfg, params, ServeConfig(max_len=PROMPT + NEW + 24, packed_weights="all",
                                          fused=False), device=device, mesh=mesh)
    eng.generate(prompts, max_new=4)
    ms, coll = [], []
    for _ in range(REPEATS):
        comm.reset_stats()
        r = eng.generate(prompts, max_new=NEW)
        ms.append(1e3 * r["decode_s"] / (NEW - 1))
        coll.append(comm.STATS["collectives"])
    return {"ms": ms, "collectives_per_generate": coll, "tokens": r["tokens"].tolist()}


def run_tree(tree: Path, cpu: bool) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import numpy as np

    from repro_torch.launch.mesh import spawn

    t0 = time.monotonic()
    device = "cpu" if cpu else "cuda"
    if not cpu:
        from repro_torch.kernels import build

        build.build()
    prompts = np.random.default_rng(0).integers(1, 500, (BATCH, PROMPT))
    rdv = tree / "build" / "ab_packed_mesh"
    rdv.mkdir(parents=True, exist_ok=True)
    res = spawn(rank, 1, 2, "gloo", device, str(rdv / str(time.time_ns())),
                args=(prompts, cpu))
    return {"tree": str(tree), "ms_per_step": [r["ms"] for r in res],
            "collectives_per_generate": res[0]["collectives_per_generate"],
            "tokens_row0": res[0]["tokens"][0], "seconds": time.monotonic() - t0}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="the other tree: run both in turns")
    ap.add_argument("--tree", type=Path, help="run one tree in this process")
    ap.add_argument("--cpu", action="store_true", help="with --tree: smoke config on the CPU")
    args = ap.parse_args()
    if args.tree is not None:
        print("RESULT " + json.dumps(run_tree(args.tree.resolve(), args.cpu)), flush=True)
        return
    if args.parent is None:
        ap.error("give --parent DIR (or --tree DIR)")
    lines = []
    for tree in (args.parent.resolve(), ROOT, ROOT, args.parent.resolve()):
        out = subprocess.run([sys.executable, __file__, "--tree", str(tree)],
                             capture_output=True, text=True, check=True).stdout
        rec = json.loads(next(ln for ln in out.splitlines()
                              if ln.startswith("RESULT "))[len("RESULT "):])
        print(json.dumps(rec), flush=True)
        lines.append(rec)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "ab_packed_mesh.json").write_text(json.dumps(lines, indent=1))


if __name__ == "__main__":
    main()
