#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 7 ("graph decode") for two trees, in turns.

    python3 scripts/ab_graph_decode.py --parent DIR

``DIR`` holds another checkout of the repository (e.g. the parent commit
unpacked with ``git archive`` into a gitignored directory such as
``build/parent``).  Runs phase 7 (``chip_smoke.graph_phase``: the CUDA-graph
decode step of full-width ``vusa_edge`` at B = 4, dense and packed with
fp32, int8 and int4 values, with its gates) in a fresh process for each
tree in the order parent, this tree, this tree, parent, on the same card,
and prints one line per run: each route's better ms per replayed step of
two turns, and from the profiler trace of 8 replays the device's busy ms
per step, the step's ms between CUDA events and the device events per
step.  Each tree builds its own kernels once.  With ``--kernels N`` each
run also traces 8 replays of the fp32-value pack's step and prints its N
device kernels of most total time, per step.  Every line also goes to
``chiprun_out/ab_graph_decode.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def kernel_table(cs, cfg, e, top: int) -> list:
    """The ``top`` device kernels of most total time in 8 replayed steps of
    ``e`` (fused), per step: (name, calls, µs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        tok, cache = e.prime(cs.prompts_for(cfg))
        e.decode_segment(tok, cs.copy_cache(cache), 8)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            e.decode_segment(tok, cs.copy_cache(cache), 8)
            torch.cuda.synchronize()
    rows = [(ev.key[:160], ev.count / 8, ev.device_time_total / 8)
            for ev in prof.key_averages() if ev.device_time_total > 0]
    return sorted(rows, key=lambda r: -r[2])[:top]


def child(tree: Path, tag: str, top: int) -> None:
    """Phase 7 of ``tree``'s ``chip_smoke.py``, one JSON line."""
    sys.path.insert(0, str(tree))
    sys.path.insert(0, str(tree / "src"))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core.pruning import prune_tree
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig

    cs.strict_fp32()
    build.build()  # a tree's second run reuses its first run's build
    cfg = get_config("vusa_edge")
    params = prune_tree(build_model(cfg).init(0, device="cuda"), cfg.sparsity)

    def mk(**kw):
        return Engine(cfg, params, ServeConfig(max_len=cs.PROMPT + cs.MAX_NEW + 8, fused=False,
                                               **kw), device="cuda")

    engines = {"dense": mk(), "fp32": mk(packed_weights="all"),
               "int8": mk(packed_weights="all", packed_values="int8"),
               "int4": mk(packed_weights="all", packed_values="int4")}
    res = cs.graph_phase(cfg, engines)
    if top:
        table = kernel_table(cs, cfg, cs.use(engines["fp32"], fused=True), top)
        print("KERNELS " + json.dumps({"tree": tag, "fp32_step": table}), flush=True)
    print("AB " + json.dumps({"tree": tag, **{
        route: {"ms_per_step": min(g["ms_per_step"]["graph"]),
                "busy_ms": g["trace_graph"]["busy_ms"],
                "step_ms": g["trace_graph"]["unprofiled_ms"],
                "device_events": g["trace_graph"]["device_events"]}
        for route, g in res.items()}}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="the other checkout")
    ap.add_argument("--kernels", type=int, default=0,
                    help="also print the N device kernels of most time in a fp32 step")
    ap.add_argument("--child", nargs=2, metavar=("TREE", "TAG"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(Path(args.child[0]).resolve(), args.child[1], args.kernels)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    failed, lines = False, []
    for tag, tree in (("parent", args.parent), ("change", ROOT), ("change", ROOT),
                      ("parent", args.parent)):
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--parent",
                            args.parent, "--kernels", str(args.kernels), "--child", str(tree),
                            tag], capture_output=True, text=True)
        got = [ln for ln in r.stdout.splitlines() if ln.startswith(("AB ", "KERNELS "))]
        lines += [json.loads(ln.split(" ", 1)[1]) for ln in got]
        print("\n".join(ln[:2000] for ln in got), flush=True)
        if r.returncode:
            failed = True
            print(r.stderr[-3000:], file=sys.stderr, flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ab_graph_decode.json").write_text(json.dumps({"card": card, "runs": lines}, indent=1))
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
