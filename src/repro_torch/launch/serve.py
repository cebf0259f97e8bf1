"""Serving launcher of the port: random init from a seed, magnitude pruning,
optional VUSA packing, one batched ``generate``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch vusa_edge --packed all
    PYTHONPATH=src python -m repro_torch.launch.serve --arch vusa_edge --smoke --packed all --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch vusa_edge --smoke --packed all \
        --packed-values int8 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch vusa_edge --smoke --packed all \
        --speculative --device cpu

Port of the one-shot ``generate`` branch of the JAX package's
``launch/serve.py``, with its speculative options; the scheduler,
streaming, mesh and fault options come with later slices (ROADMAP.md
queue A).  ``--no-fused`` decodes in the eager host loop instead of the
CUDA graph.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..configs import get_config, get_smoke_config
from ..core.pruning import prune_tree
from ..models import build_model
from ..serve import Engine, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument(
        "--packed", nargs="?", const="mlp", default=False, choices=("mlp", "all"),
        help="VUSA-pack the decode step: bare flag or 'mlp' = MLP trio only, "
        "'all' = + qkv/o and the untied LM head",
    )
    ap.add_argument(
        "--packed-values", default="bf16", choices=("bf16", "int8", "int4"),
        help="packed value precision: bf16 = the params' own dtype, int8/int4 = "
        "quantized with per-(window, row) fp32 scales",
    )
    ap.add_argument(
        "--speculative", action="store_true",
        help="self-speculative decoding: a high-sparsity pack of the same weights drafts "
        "--draft-k tokens a round, the configured path verifies them in one step (B=1)",
    )
    ap.add_argument("--draft-k", type=int, default=4, help="drafted tokens per round")
    ap.add_argument(
        "--draft-sparsity", type=float, default=0.99,
        help="magnitude-pruning rate of the drafter pack",
    )
    ap.add_argument(
        "--no-fused", action="store_true",
        help="decode in the eager host loop, not the CUDA-graph step (the parity baseline)",
    )
    ap.add_argument("--sparsity", type=float, default=None)
    ap.add_argument("--batch", type=int, default=None,
                    help="batch size (default: 4, or 1 with --speculative)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = build_model(cfg).init(0, device=args.device)
    sp = cfg.sparsity if args.sparsity is None else args.sparsity
    if sp > 0:
        params = prune_tree(params, sp)
    batch = args.batch if args.batch is not None else (1 if args.speculative else 4)
    headroom = args.draft_k if args.speculative else 0
    max_len = args.prompt_len + args.max_new + headroom + 8
    sc = ServeConfig(max_len=max_len, packed_weights=args.packed,
                     packed_values=args.packed_values, fused=not args.no_fused,
                     speculative=args.speculative, draft_k=args.draft_k,
                     draft_sparsity=args.draft_sparsity)
    eng = Engine(cfg, params, sc, device=args.device)
    prompts = np.ones((batch, args.prompt_len), np.int32)
    out = eng.generate(prompts, max_new=args.max_new)
    line = (f"prefill {out['prefill_s']*1e3:.1f}ms  decode {out['decode_s']*1e3:.1f}ms  "
            f"{out['tok_per_s']:.0f} tok/s  finite={out['finite']}")
    if args.speculative:
        line += (f"  spec rounds {out['spec_rounds']}  accepted {out['spec_accepted']}/"
                 f"{out['spec_proposed']} ({out['acceptance_rate']:.2f})")
    print(line)
    return out


if __name__ == "__main__":
    main()
