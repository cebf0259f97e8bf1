"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch vusa_edge --steps 100 \
        [--smoke] [--batch 8] [--seq 128] [--lr 3e-4] [--ckpt DIR] [--microbatches N] \
        [--grad-compress] [--device cpu] [--pod 2 --data 2 --model 2 --dist-backend gloo]

Port of the JAX package's ``launch/train.py``: the ``Trainer`` on the
learnable synthetic stream (tokens drawn from [0, 256)), pruning to the
config's sparsity.  ``--data D --model M`` train on a (data, model) mesh of
D x M ranks (``--pod P``: a (pod, data, model) mesh of P x D x M, the
batch split over pod x data) that ``launch/mesh.spawn`` starts on this
machine, with the
collective backend ``--dist-backend`` (``nccl``: one GPU per rank;
``gloo``: ranks that share a GPU or run on the CPU); rank 0 prints and
writes the checkpoints, each leaf gathered to it from the shards one at a
time.  On ``--model`` above 1 every family trains tensor-parallel
(``dist.tp.training_plan``; the moe family's experts, the SSM's heads,
the RG-LRU's channels and whisper's encoder and decoder split over
``model``), and rank 0 prints the collectives of the last step beside the
plan's prediction (``TPPlan.train_collectives``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe_1b_7b --smoke \
        --device cpu --model 2 --dist-backend gloo
    PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma_9b --smoke \
        --device cpu --data 2 --model 2 --dist-backend gloo
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper_tiny --smoke \
        --device cpu --data 2 --model 2 --dist-backend gloo
"""

from __future__ import annotations

import argparse

from ..configs import get_config, get_smoke_config
from ..dist import comm
from ..train import TrainConfig, Trainer, TrainHParams
from .mesh import rank0_prints, spawn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--pod", type=int, default=1, help="pod mesh axis (pure data parallelism)")
    ap.add_argument("--data", type=int, default=1, help="data-parallel mesh axis")
    ap.add_argument("--model", type=int, default=1, help="model-parallel mesh axis")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="collective backend of a --data/--model mesh: nccl needs one GPU "
                    "per rank, gloo serves ranks that share a GPU or run on the CPU")
    args = ap.parse_args(argv)
    if min(args.pod, args.data, args.model) < 1:
        ap.error(f"mesh axes must be >= 1, got pod={args.pod}, data={args.data}, "
                 f"model={args.model}")
    if args.pod * args.data * args.model > 1:
        if args.dist_backend is None:
            ap.error("--pod/--data/--model need --dist-backend nccl (one GPU per rank) or gloo")
        return spawn(_mesh_rank, args.data, args.model, args.dist_backend, args.device,
                     args=(args,), pod=args.pod)[0]
    return _run(args)


def _mesh_rank(mesh, device, args):
    """One rank of the mesh: the run on this rank's device; rank 0 prints.
    The result leaves the world without the trainer's views of the whole
    tree (``Trainer.train``: each read is a collective of the mesh)."""
    out = rank0_prints(_run, args, mesh, device)
    return {k: v for k, v in out.items() if k not in ("params", "opt")}


def _run(args, mesh=None, device=None):
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tc = TrainConfig(
        steps=args.steps,
        global_batch=args.batch,
        seq_len=args.seq,
        ckpt_dir=args.ckpt,
        token_range=256,
        hp=TrainHParams(
            lr=args.lr,
            warmup=max(args.steps // 10, 1),
            total_steps=args.steps,
            microbatches=args.microbatches,
            grad_compress=args.grad_compress,
        ),
    )
    tr = Trainer(cfg, tc, device=device or args.device, mesh=mesh)
    counted = {}
    if tr.plan is not None:  # the collectives of each step, the last one kept
        step = tr.step_fn

        def step_fn(*a, **kw):
            comm.reset_stats()
            res = step(*a, **kw)
            counted["collectives"] = comm.STATS["collectives"]
            return res

        tr.step_fn = step_fn
    out = tr.train()
    line = f"final loss {out['final_loss']:.4f}  sparsity {out['sparsity']:.2%}"
    if counted:
        predicted = tr.plan.train_collectives(cfg, args.seq, args.microbatches,
                                              split=tr.rows is not None,
                                              compress=args.grad_compress)
        line += f"  collectives a step {counted['collectives']} (predicted {predicted})"
    print(line)
    return out


if __name__ == "__main__":
    main()
