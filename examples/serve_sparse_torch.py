"""Serve a pruned LM with batched requests on the PyTorch port: dense path
vs VUSA-packed path.

Shows the paper's headline on the inference side: same outputs, packed
weight bytes ~ (1 - sparsity) of dense, dense fallback still correct.
The packed path runs the hand-written CUDA kernels (their plain PyTorch
versions with --device cpu).

Run:  PYTHONPATH=src python examples/serve_sparse_torch.py --sparsity 0.85 [--device cpu]
      PYTHONPATH=src python examples/serve_sparse_torch.py --mesh 1,2 --dist-backend gloo \\
          --device cpu
"""

import argparse

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.core.pruning import prune_tree
from repro_torch.launch.mesh import rank0_prints, spawn
from repro_torch.models import build_model
from repro_torch.serve import Engine, Request, Scheduler, ServeConfig
from repro_torch.serve.packed import packed_byte_ratios


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="vusa_edge")
    ap.add_argument("--sparsity", type=float, default=0.85)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument(
        "--mesh", default=None, metavar="DP,TP",
        help="serve on a data x model mesh of ranks spawned on this machine, e.g. '1,2'; "
        "outputs stay identical to the single-device path",
    )
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="collective backend of --mesh: nccl needs one GPU per rank, gloo "
                    "serves ranks that share a GPU or run on the CPU")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args()
    if args.mesh:
        from repro_torch.launch.mesh import parse_mesh

        if args.dist_backend is None:
            ap.error("--mesh needs --dist-backend nccl (one GPU per rank) or gloo")
        dp, tp = parse_mesh(args.mesh)
        spawn(_mesh_rank, dp, tp, args.dist_backend, args.device, args=(args,))
        return
    run(args)


def _mesh_rank(mesh, device, args):
    """One rank of the mesh: the same run on this rank's device; rank 0 prints."""
    print_mesh = lambda: print(f"serving on mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")  # noqa: E731
    rank0_prints(print_mesh)
    rank0_prints(run, args, mesh, device)


def run(args, mesh=None, device=None):
    device = device or args.device
    cfg = get_smoke_config(args.arch)
    model = build_model(cfg)
    params = prune_tree(model.init(0, device=device), args.sparsity)
    prompts = np.tile(np.arange(8, dtype=np.int32), (args.batch, 1)) % cfg.vocab

    tokens = {}
    for packed in (False, "all"):
        eng = Engine(cfg, params, ServeConfig(max_len=128, packed_weights=packed),
                     device=device, mesh=mesh)
        out = eng.generate(prompts, max_new=args.new)
        tokens[packed] = out["tokens"]
        label = "VUSA-packed" if packed else "dense      "
        print(
            f"{label}: prefill {out['prefill_s']*1e3:6.1f}ms  "
            f"decode {out['decode_s']*1e3:6.1f}ms  {out['tok_per_s']:6.0f} tok/s"
        )
        if packed:
            ratios = packed_byte_ratios(eng.packed)
            print(f"             decode-step weight bytes packed/dense = "
                  f"{ratios['total']:.3f} @ {args.sparsity:.0%} sparsity "
                  f"(whole model: mlp + qkv/o + head)")
    assert (tokens[False] == tokens["all"]).all(), "packed serving diverged!"
    print("outputs identical: True")

    # continuous batching over ragged traffic: the same packed engine,
    # per-request budgets, seeds and arrivals; each round's arrivals are
    # bucket-padded and prefilled in one batched call, and slots are
    # backfilled as requests retire
    eng = Engine(cfg, params, ServeConfig(max_len=128, packed_weights="all"), device=device,
                 mesh=mesh)
    sched = Scheduler(eng, slots=args.batch, segment=8)
    rng = np.random.default_rng(0)
    budget_cap = 128 - 8 - 8  # max_len - longest prompt - segment
    reqs = [
        Request(prompt=rng.integers(0, cfg.vocab, 4 + 2 * (i % 3)).astype(np.int32),
                max_new=int(rng.integers(4, min(2 * args.new, budget_cap) + 1)), seed=i,
                arrival_s=float(rng.exponential(0.002)))
        for i in range(2 * args.batch)
    ]
    done = sched.run(reqs)
    s = sched.stats()
    print(f"scheduler  : {len(done)} requests  {s['sustained_tok_per_s']:6.0f} tok/s  "
          f"p95 {s['latency_p95_s']*1e3:.0f}ms  occupancy {s['slot_occupancy']:.2f}")


if __name__ == "__main__":
    main()
