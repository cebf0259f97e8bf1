"""Serving launcher of the port: random init from a seed, magnitude pruning,
optional VUSA packing, one batched ``generate``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch vusa_edge --packed all
    PYTHONPATH=src python -m repro_torch.launch.serve --arch vusa_edge --smoke --packed all --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch vusa_edge --smoke --packed all \
        --packed-values int8 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch vusa_edge --smoke --packed all \
        --speculative --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch vusa_edge --smoke --device cpu \
        --requests 8 --slots 4 --page-size 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch vusa_edge --smoke --device cpu \
        --requests 8 --slots 4 --packed all --speculative
    PYTHONPATH=src python -m repro_torch.launch.serve --arch vusa_edge --smoke --device cpu \
        --requests 8 --slots 4 --fault-rate 0.2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch vusa_edge --smoke --device cpu \
        --requests 8 --slots 4 --stream --journal /tmp/j --watchdog-s 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b --packed all
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe_1b_7b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma_3b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_2_7b --smoke --device cpu \
        --requests 8 --slots 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper_tiny --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper_tiny --smoke \
        --mesh 2,2 --dist-backend gloo --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch vusa_edge --smoke --packed all \
        --mesh 2,2 --dist-backend gloo --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe_1b_7b --smoke \
        --mesh 1,2 --dist-backend gloo --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_2_7b --smoke \
        --mesh 2,2 --dist-backend gloo --device cpu

Port of the JAX package's ``launch/serve.py``: one batched ``generate``,
with its speculative options, or with ``--requests N`` N synthetic
requests through the continuous-batching ``Scheduler`` (``--slots``,
``--deadline-s``, ``--queue-cap`` / ``--shed-policy``, the paged pool:
``--page-size``, ``--arena-blocks``, ``--prefix-cache``,
``--prefill-chunk``; ``--speculative`` serves the scheduler's speculative
rounds; ``--fault-rate`` NaN-poisons that seeded fraction of requests'
caches to exercise the guard and the dense retry).  ``--stream`` serves the
same requests through the asyncio ``AsyncEngine``; ``--journal PATH``
journals every request event (implies ``--stream``), ``--recover`` replays
a crashed journal first (proven completions come back as they are, the
rest re-execute with the same tokens) and ``--watchdog-s`` arms the stall
watchdog.  SIGINT / SIGTERM drain instead of dying mid-segment: admission
stops, in-flight requests finish (bounded by ``--drain-timeout-s``), the
stats print and the journal closes clean.  ``--mesh DP,TP`` serves on a
(data, model) mesh of DP x TP ranks that ``launch/mesh.spawn`` starts on
this machine, with the collective backend ``--dist-backend``: ``nccl``
for one GPU per rank, ``gloo`` for ranks that share a GPU or run on the
CPU (gloo collectives cannot be captured in a CUDA graph, so with TP > 1
the steps run eagerly); rank 0 prints.  Every model serves
tensor-parallel on sharded storage (``dist/tp.py``; the moe family's
experts, the SSM's heads, the RG-LRU's channels and whisper's encoder and
decoder split over ``model``):
each rank draws each leaf, prunes it whole and keeps its shard, so no
rank holds the whole model; one-shot ``generate`` on the dense route
prints the collectives a decode step made beside the plan's prediction
(``TPPlan.decode_collectives``).  ``--no-fused`` decodes in the eager host
loop instead of the CUDA graph.  ``--arch`` takes every id of
``configs.ARCH_IDS`` (the dense, moe, vlm, hybrid, ssm and encdec
families); a vlm model's one-shot ``generate`` gets seeded stand-in patch
embeddings and an encdec model's ``min(prompt, enc_frames)`` stand-in
frames (normal, std 0.02, as the training pipeline makes them), and the
scheduler refuses both (its requests carry neither).
"""

from __future__ import annotations

import argparse
import asyncio
import os
import signal

import numpy as np

from ..configs import get_config, get_smoke_config
from ..core.pruning import _prunable, prune, prune_tree
from ..dist import comm
from ..dist.sharding import local_shard
from ..dist.tp import serving_plan
from .mesh import parse_mesh, rank0_prints, spawn
from ..models import build_model
from ..serve import AsyncEngine, Engine, FaultConfig, Journal, Request, Scheduler, ServeConfig


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
        "--draft-k tokens a round, the configured path verifies them in one step (one-shot "
        "generate at B=1, or every slot of the scheduler with --requests)",
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
    ap.add_argument(
        "--requests", type=int, default=0,
        help="serve N synthetic requests through the continuous-batching "
        "Scheduler (0 = one-shot batched generate)",
    )
    ap.add_argument("--slots", type=int, default=4, help="scheduler slot pool size")
    ap.add_argument(
        "--deadline-s", type=float, default=None,
        help="per-request deadline (from arrival); blown deadlines finish TIMEOUT",
    )
    ap.add_argument(
        "--queue-cap", type=int, default=None,
        help="bound the scheduler queue; overflow handled per --shed-policy",
    )
    ap.add_argument(
        "--shed-policy", default="reject",
        choices=("reject", "shed-oldest", "shed-lowest-priority"),
        help="who pays when the queue is full",
    )
    ap.add_argument(
        "--page-size", type=int, default=0,
        help="KV block size in tokens; >0 switches the scheduler to the paged "
        "arena pool with prefix sharing, 0 = slot pool",
    )
    ap.add_argument(
        "--arena-blocks", type=int, default=0,
        help="total paged-arena blocks (0 = auto: enough for every slot at "
        "max_len); smaller arenas admit lazily and preempt under pressure",
    )
    ap.add_argument(
        "--prefix-cache", action=argparse.BooleanOptionalAction, default=True,
        help="share identical prompt-prefix pages between requests "
        "(--no-prefix-cache disables; only meaningful with --page-size)",
    )
    ap.add_argument(
        "--prefill-chunk", type=int, default=0,
        help="chunk long prompt prefills to this many tokens and co-schedule "
        "the chunks with decode segments (0 = whole-prompt prefill; "
        "requires --page-size)",
    )
    ap.add_argument(
        "--fault-rate", type=float, default=0.0,
        help="chaos mode: seeded fraction of requests whose cache gets NaN-poisoned at "
        "admission (exercises the guard and the dense retry)",
    )
    ap.add_argument(
        "--stream", action="store_true",
        help="serve through the asyncio AsyncEngine (token streaming, watchdog, clean "
        "drain on SIGINT/SIGTERM); requires --requests",
    )
    ap.add_argument(
        "--journal", default=None, metavar="PATH",
        help="write-ahead journal every request event to PATH (CRC32-framed, fsync'd at "
        "segment syncs); implies --stream",
    )
    ap.add_argument(
        "--recover", action="store_true",
        help="replay --journal before serving: journaled completions are honoured, "
        "in-flight requests re-execute under their original seeds",
    )
    ap.add_argument(
        "--watchdog-s", type=float, default=None,
        help="abort a segment that syncs nothing for this long as STALLED (default: off)",
    )
    ap.add_argument(
        "--drain-timeout-s", type=float, default=30.0,
        help="on SIGINT/SIGTERM, give in-flight requests this long to finish before "
        "aborting them (CANCELLED)",
    )
    ap.add_argument(
        "--mesh", default=None, metavar="DP,TP",
        help="serve on a data-parallel DP x tensor-parallel TP mesh of ranks spawned on "
        "this machine (1,1 = one device)",
    )
    ap.add_argument(
        "--dist-backend", default=None, choices=("nccl", "gloo"),
        help="collective backend of --mesh: nccl needs one GPU per rank, gloo serves "
        "ranks that share a GPU or run on the CPU",
    )
    args = ap.parse_args(argv)
    if args.recover and not args.journal:
        ap.error("--recover requires --journal")
    if args.journal:
        args.stream = True
    if args.stream and args.requests <= 0:
        ap.error("--stream/--journal require --requests N")
    if args.speculative and args.requests == 0 and args.batch not in (None, 1):
        ap.error("--speculative one-shot generate serves --batch 1 "
                 "(use --requests N for batched speculative serving)")
    dp, tp = parse_mesh(args.mesh) if args.mesh else (1, 1)
    if dp * tp > 1:
        if args.dist_backend is None:
            ap.error("--mesh needs --dist-backend nccl (one GPU per rank) or gloo")
        if args.stream:
            ap.error("--stream/--journal serve from one process, not on a --mesh")
        return spawn(_mesh_rank, dp, tp, args.dist_backend, args.device, args=(args,))[0]
    return _run(args)


def _mesh_rank(mesh, device, args):
    """One rank of the mesh: the run on this rank's device; rank 0 prints."""
    return rank0_prints(_run, args, mesh, device)


def _run(args, mesh=None, device=None):
    """Build, prune, pack and serve as the flags say, on ``device`` (default
    ``--device``) and ``mesh``."""
    device = device or args.device
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    sp = cfg.sparsity if args.sparsity is None else args.sparsity
    plan = serving_plan(cfg, mesh)
    if plan is None:
        params = build_model(cfg).init(0, device=device)
        if sp > 0:
            params = prune_tree(params, sp)
    else:  # each leaf drawn, pruned whole on the device and cut to this rank's shard
        def leaf(path, w):
            w = w.to(device)
            if sp > 0 and _prunable(path, w):
                w = prune(w, sp)
            pl = plan.placements
            for k in path:
                pl = pl[k]
            return local_shard(w, pl, mesh)

        params = build_model(cfg).init(0, device=device, leaf=leaf)
    batch = args.batch if args.batch is not None else (1 if args.speculative else 4)
    headroom = 0
    if args.speculative:
        # a round writes up to draft_k rows past the budget; the scheduler
        # budgets a whole segment of rounds, 8 * (draft_k + 1) rows
        headroom = 8 * args.draft_k if args.requests > 0 else args.draft_k
    prefix = cfg.patch_tokens if cfg.family == "vlm" else 0
    max_len = prefix + args.prompt_len + args.max_new + headroom + 8
    if args.page_size > 0:  # the page size must divide max_len
        max_len = -(-max_len // args.page_size) * args.page_size
    sc = ServeConfig(max_len=max_len, packed_weights=args.packed,
                     packed_values=args.packed_values, fused=not args.no_fused,
                     speculative=args.speculative, draft_k=args.draft_k,
                     draft_sparsity=args.draft_sparsity, page_size=args.page_size,
                     arena_blocks=args.arena_blocks, prefix_cache=args.prefix_cache,
                     prefill_chunk=args.prefill_chunk,
                     faults=FaultConfig(cache_nan_rate=args.fault_rate)
                     if args.fault_rate > 0 else None)
    eng = Engine(cfg, params, sc, device=device, mesh=mesh)
    if args.requests > 0:
        return _serve_requests(args, cfg, eng)
    prompts = np.ones((batch, args.prompt_len), np.int32)
    extras = None
    if cfg.family == "vlm":
        patches = np.random.default_rng(0).normal(0, 0.02, (batch, prefix, cfg.d_model))
        extras = {"patches": patches.astype(np.float32)}
    elif cfg.family == "encdec":
        frames = np.random.default_rng(0).normal(
            0, 0.02, (batch, min(args.prompt_len, cfg.enc_frames), cfg.d_model))
        extras = {"frames": frames.astype(np.float32)}
    counted = {}
    if eng.plan is not None and not args.packed and not args.speculative:
        segment = eng.decode_segment

        def decode_segment(token, cache, steps, *a, **kw):
            comm.reset_stats()
            res = segment(token, cache, steps, *a, **kw)
            counted.update(steps=steps, collectives=comm.STATS["collectives"])
            return res

        eng.decode_segment = decode_segment
    out = eng.generate(prompts, max_new=args.max_new, extras=extras)
    line = (f"prefill {out['prefill_s']*1e3:.1f}ms  decode {out['decode_s']*1e3:.1f}ms  "
            f"{out['tok_per_s']:.0f} tok/s  finite={out['finite']}")
    if counted.get("steps"):
        predicted = eng.plan.decode_collectives(cfg, eng._rows(batch) is not None)
        line += (f"  collectives a decode step {counted['collectives'] / counted['steps']:g} "
                 f"(predicted {predicted})")
    if args.speculative:
        line += (f"  spec rounds {out['spec_rounds']}  accepted {out['spec_accepted']}/"
                 f"{out['spec_proposed']} ({out['acceptance_rate']:.2f})")
    print(line)
    return out


def _requests(args, cfg) -> list:
    """The synthetic workload: ``--requests`` random prompts of
    ``--prompt-len`` tokens from numpy seed 0, request r with seed r (a pure
    function of the flags, so a recovered run rebuilds the same requests)."""
    rng = np.random.default_rng(0)
    return [Request(prompt=rng.integers(1, cfg.vocab, size=args.prompt_len).astype(np.int32),
                    max_new=args.max_new, seed=r, deadline_s=args.deadline_s)
            for r in range(args.requests)]


async def _serve_streaming(args, cfg, sched) -> dict:
    """Drive the workload through the AsyncEngine: streaming consumption,
    optional journaling and recovery, and a drain on SIGINT/SIGTERM.  A
    recovered run submits only the requests the journal does not already
    own.  Returns the engine's lifetime stats."""
    if args.recover and os.path.exists(args.journal):
        engine = AsyncEngine.recover(args.journal, sched, watchdog_s=args.watchdog_s)
        print(f"recovered journal {args.journal}: {len(engine._completed)} completions "
              f"proven, {len(engine.recovered_rids)} requests re-queued")
    else:
        journal = Journal(args.journal) if args.journal else None
        engine = AsyncEngine(sched, journal=journal, watchdog_s=args.watchdog_s)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    try:
        async with engine:
            known = set(engine.recovered_rids) | {
                rid for rid in range(args.requests) if engine.completion_for(rid) is not None}
            streams = [engine.stream_for(r) if r in known else engine.submit(req, rid=r)
                       for r, req in enumerate(_requests(args, cfg))]

            async def consume():
                total = 0
                for s in streams:
                    async for _ in s:
                        total += 1
                return total

            work = asyncio.ensure_future(consume())
            interrupt = asyncio.ensure_future(stop.wait())
            done, _ = await asyncio.wait({work, interrupt},
                                         return_when=asyncio.FIRST_COMPLETED)
            if interrupt in done:
                print("signal: draining...")
                clean = await engine.drain(args.drain_timeout_s)
                print("drained clean" if clean else
                      f"drain blew {args.drain_timeout_s}s; in-flight work aborted")
                work.cancel()
            else:
                interrupt.cancel()
                print(f"streamed {work.result()} tokens")
            st = engine.stats()
            print(f"{st['requests_completed']:.0f} completions  ttft p50/p99 "
                  f"{st['ttft_p50_s']*1e3:.0f}/{st['ttft_p99_s']*1e3:.0f}ms  itl p50/p99 "
                  f"{st['itl_p50_s']*1e3:.0f}/{st['itl_p99_s']*1e3:.0f}ms  journal "
                  f"records={st['journal_records']:.0f} syncs={st['journal_syncs']:.0f}")
    finally:
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.remove_signal_handler(sig)
    return st


def _serve_requests(args, cfg, eng):
    """``--requests N``: the workload through the scheduler (or, with
    ``--stream``, the AsyncEngine), then its stats."""
    sched = Scheduler(eng, slots=args.slots, queue_cap=args.queue_cap,
                      shed_policy=args.shed_policy)
    if args.stream:
        return asyncio.run(_serve_streaming(args, cfg, sched))
    for req in _requests(args, cfg):
        sched.submit(req)
    done = sched.run()
    st = sched.stats()
    print(f"{st['requests']} completions  {st['sustained_tok_per_s']:.0f} tok/s  "
          f"latency p50 {st['latency_p50_s']*1e3:.0f}ms  "
          f"ttft p50 {st['ttft_p50_s']*1e3:.0f}ms")
    if args.speculative:
        print(f"  speculative: acceptance {st['acceptance_rate']:.2f}  accepted tok/s "
              f"{st['tok_per_s']:.0f}  proposed={st['spec_proposed']} "
              f"accepted={st['spec_accepted']}")
    print("  " + "  ".join(f"{k}={st[k]}" for k in
                           ("rejected", "shed", "timed_out", "cancelled", "fallback", "failed",
                            "quarantined")))
    if args.page_size > 0:
        print(f"  arena {st['kv_pool_bytes']/2**20:.1f}MiB "
              f"blocks live={st['blocks_live']:.0f} free={st['blocks_free']:.0f} "
              f"cached={st['blocks_cached']:.0f}  "
              f"prefix hit rate {st['prefix_hit_rate']:.2f}  "
              f"cow={st['cow_copies']}  preempted={st['preempted']}  "
              f"hbm/req {st['hbm_bytes_per_active_request']/2**10:.1f}KiB")
    bad = sum(1 for c in done.values() if c.status.value not in ("OK", "FAILED_FALLBACK_OK"))
    if bad:
        print(f"  {bad} requests did not deliver tokens")
    return done


if __name__ == "__main__":
    main()
