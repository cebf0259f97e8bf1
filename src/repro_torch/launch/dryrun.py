"""Production-mesh dry run: trace every (architecture x input shape) cell
as rank 0 of the production mesh, with no device and no allocation, and
record memory, cost and collective statistics for the roofline analysis.

The port's counterpart of the JAX package's ``launch/dryrun.py``, which
lowers and compiles each cell on 512 host devices.  Here each cell starts
a ``fake`` process group of 256 (16x16) or 512 (2x16x16) ranks in this one
process (``torch.testing._internal.distributed.fake_pg``: collectives
return at once and move nothing), builds ``launch.mesh.make_production_mesh``
on it, and runs rank 0's program on ``meta`` tensors (shapes and dtypes,
no storage) under ``launch/op_cost.py``'s counter:

* ``train`` — the port's train step (``train/step.py make_train_step``
  with ``Trainer``'s mesh arguments): parameters and both AdamW moments as
  rank 0's shards under ``dist/sharding.py params_shardings``, the batch
  rows split over ``pod`` x ``data``; every family's step under its
  training plan (``dist.tp.training_plan``: each layer's ``data``-sharded
  leaves gathered at use and again in its recompute, their gradients
  reduce-scattered over ``pod`` x ``data`` in rank order, so the record's
  ``collectives`` hold ``fsdp-gather`` and ``reduce-scatter`` beside the
  others; the forward and backward on rank 0's ``model`` shards, the moe family's experts,
  the SSM's heads, the RG-LRU's channels and the encdec family's encoder
  and decoder heads split over ``model``, the sequence-sharded attention
  where the heads do not divide ``model``); the moe routing over the
  whole batch;
* ``prefill`` — ``Model.prefill`` (``Model.forward`` for the recurrent
  families, as the reference chooses) on rank 0's rows of the batch, under
  ``models.common.mesh_context`` so the sequence-sharded attention applies
  where the heads do not divide ``model`` (the encdec encoder's
  full-mask attention too); every family as the serving engine runs it,
  on rank 0's shards of the parameters with tensor-parallel products
  (``dist/tp.py``), the moe routing over the whole batch;
* ``decode`` — ``Model.decode_step`` of one token on rank 0's rows of the
  cache (``serve_shardings``; under a plan they hold rank 0's heads, SSM
  heads and RG-LRU channels), the parameters as for prefill.

So a record shows what the port's rank 0 would do on that mesh.  The
AdamW step counter is a CPU scalar (the step reads it on the host).
``long_500k`` is skipped for the full-attention architectures exactly as
the reference skips it.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --variant opt
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --variant opt_nodirect \\
        --flags decode_direct=0

Records go to ``experiments/dryrun_torch/<arch>__<shape>__<mesh>[_<variant>].json``
(the baseline without a suffix), one a cell, so a sweep resumes where it
stopped (``--force`` redoes cells).  A record's ``memory`` holds
``argument_size_in_bytes`` (params, optimizer state, cache and batch on
rank 0), ``output_size_in_bytes`` and ``temp_size_in_bytes`` (the peak of
the tensors made during the step, ``op_cost``); ``weighted`` the counts of
``op_cost``; ``collectives`` ``dist/comm.py``'s counts; ``trace_s`` the
seconds of the trace, in place of the reference's ``compile_s``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path

import torch

from ..configs import ARCH_IDS, SHAPES, get_config
from ..dist import comm
from ..dist.sharding import (
    _batch_axes, batch_sharding, local_shard, params_shardings, serve_shardings, shard_tree,
)
from ..dist.tp import local_config, serving_plan, training_plan
from ..models import build_model
from ..models import opt_flags
from ..models.common import mesh_context
from ..models.families import RECURRENT_FAMILIES
from ..optim import AdamState
from .op_cost import OpCounter

__all__ = ["OUT_DIR", "LONG_OK", "cells", "fake_world", "build_step", "trace_step", "tree_bytes",
           "lower_cell", "run_cell", "parse_flags", "main"]

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

# long_500k needs sub-quadratic attention; these archs run it, the pure
# full-attention ones are recorded as skips (the reference's set)
LONG_OK = {"recurrentgemma_9b", "mamba2_2_7b"}


@contextlib.contextmanager
def fake_world(world: int):
    """A ``fake`` process group of ``world`` ranks with this process as rank
    0, torn down on exit.  Refuses to replace a live process group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def tree_bytes(tree, exclude=()) -> int:
    """Bytes of the tensors of ``tree``, less those whose storage is one of
    ``exclude``'s (an output updated in place is an argument)."""
    skip = {t.untyped_storage()._cdata for t in _leaves(exclude)}
    return sum(t.numel() * t.element_size() for t in _leaves(tree)
               if t.untyped_storage()._cdata not in skip)


def _meta_like(tree: dict, dtype=None) -> dict:
    return {k: _meta_like(v, dtype) if isinstance(v, dict)
            else torch.empty(v.shape, dtype=dtype or v.dtype, device="meta")
            for k, v in tree.items()}


def _rows(n: int, mesh):
    """Rank 0's rows of ``n`` under the batch rule, or None (all rows)."""
    entry = None if mesh is None else batch_sharding(mesh, n, 1)[0]
    if entry is None:
        return None
    names = (entry,) if isinstance(entry, str) else entry
    return n // math.prod(comm.axis_size(mesh, a) for a in names)


def build_step(cfg, kind: str, batch: int, seq: int, mesh=None, device="meta",
               seed: int = 0):
    """Rank 0's step of one cell and its arguments: ``(run, args)``, ``run()``
    the step, ``args`` ``{"params", "opt", "cache", "batch"}`` as the step
    uses them.  ``kind`` is train, prefill or decode at ``batch`` rows
    (global) and ``seq`` tokens (the cache length for decode).  On
    ``meta`` (the default) the arguments are shapes only; on a real device
    they are the model's init from ``seed``, zero caches and random tokens,
    of the same shapes and dtypes (phase 16 of ``chip_smoke.py``
    runs the step for real beside its trace)."""
    from ..optim import adamw_init
    from ..train.step import TrainHParams, make_train_step

    if math.prod(comm.mesh_shape(mesh).values()) == 1:
        mesh = None  # a mesh of one rank is no mesh, as in the Trainer and the Engine
    model = build_model(cfg)
    meta = torch.device(device).type == "meta"
    whole = model.abstract_params() if meta else model.init(seed, device)
    gen = None if meta else torch.Generator(device=device).manual_seed(seed)

    def inputs_of(kind_):
        spec = model.input_specs(batch, seq, kind_)
        if meta:
            return spec
        return {k: (torch.randint(0, cfg.vocab, v.shape, generator=gen, device=device,
                                  dtype=v.dtype) if not v.is_floating_point()
                    else torch.randn(v.shape, generator=gen, device=device, dtype=v.dtype))
                for k, v in spec.items()}

    if kind == "train":
        p_shard = params_shardings(model.specs(), mesh) if mesh is not None else None
        params = whole if mesh is None else shard_tree(whole, p_shard, mesh)
        if meta:  # the step counter is read on the host: a CPU scalar
            opt = AdamState(step=torch.zeros((), dtype=torch.int32),
                            mu=_meta_like(params, torch.float32),
                            nu=_meta_like(params, torch.float32))
        else:
            opt = adamw_init(params)
        inputs = inputs_of("train")
        # the Trainer's split: rows over every pure data axis, pod x data
        dp = math.prod(comm.axis_size(mesh, a) for a in _batch_axes(mesh))
        rows = batch // dp if dp > 1 and batch % dp == 0 else None
        if rows is not None:
            inputs = {k: v[:rows] for k, v in inputs.items()}
        step = make_train_step(model.loss, TrainHParams(microbatches=1), mesh, p_shard,
                               split=rows is not None, plan=training_plan(cfg, mesh))

        def run():
            return step(params, opt, inputs)

        return run, {"params": params, "opt": opt, "batch": inputs}
    # the serving engine's storage and model: every family's shards, local
    # heads, SSM heads and RG-LRU channels under its tensor-parallel plan;
    # a rank's rows of a split batch route over the whole batch
    plan = serving_plan(cfg, mesh)
    split = (mesh, _batch_axes(mesh)) if _rows(batch, mesh) else None
    if plan is not None:
        model = build_model(local_config(cfg, plan), plan)
        whole = shard_tree(whole, plan.placements, mesh)
    if kind == "prefill":
        rows = _rows(batch, mesh) or batch
        inputs = {k: v[:rows] for k, v in inputs_of("prefill").items()}
        if cfg.family in RECURRENT_FAMILIES:  # prefill == the scoring pass
            def run():
                with torch.no_grad(), mesh_context(mesh, plan, split):
                    return model.forward(whole, inputs)
        else:
            def run():
                with torch.no_grad(), mesh_context(mesh, plan, split):
                    return model.prefill(whole, inputs, seq)
        return run, {"params": whole, "batch": inputs}
    if kind == "decode":
        specs_c = model.cache_specs(batch, seq)
        cache = {k: torch.empty(s, dtype=d, device="meta") for k, (s, d) in specs_c.items()}
        if mesh is not None:
            place = serve_shardings(cache, mesh, batch, batch_axes=model.cache_batch_axes(seq))
            cache = {k: local_shard(v, place[k], mesh) for k, v in cache.items()}
        if not meta:
            cache = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                     for k, v in cache.items()}
        rows = _rows(batch, mesh) or batch
        token = inputs_of("decode")["token"][:rows]

        def run():
            with torch.no_grad(), mesh_context(mesh, plan, split):
                return model.decode_step(whole, token, cache)

        return run, {"params": whole, "cache": cache, "batch": {"token": token}}
    raise ValueError(f"unknown cell kind {kind!r}")


def trace_step(cfg, kind: str, batch: int, seq: int, mesh=None) -> dict:
    """:func:`build_step` on ``meta``, traced under ``op_cost.OpCounter``.
    Returns ``{"memory", "weighted", "collectives", "trace_s"}``."""
    run, args = build_step(cfg, kind, batch, seq, mesh)
    t0 = time.time()
    with OpCounter() as oc:
        out = run()
    trace_s = time.time() - t0
    cost = oc.cost()
    return {
        "memory": {
            "argument_size_in_bytes": tree_bytes(args),
            "output_size_in_bytes": tree_bytes(out, exclude=args),
            "temp_size_in_bytes": cost["temp_size_in_bytes"],
        },
        "weighted": {k: cost[k] for k in ("dot_flops", "bytes", "transcendentals",
                                           "collectives")},
        "collectives": cost["collectives"],
        "trace_s": trace_s,
    }


def parse_flags(spec: str) -> dict:
    """``"name=0,name=1"`` -> {name: bool}; unknown names raise."""
    out = {}
    for kv in filter(None, (spec or "").split(",")):
        name, val = kv.split("=")
        name = name.strip()
        if name not in opt_flags.FLAGS:
            raise ValueError(f"unknown flag {name!r}; flags: {sorted(opt_flags.FLAGS)}")
        out[name] = bool(int(val))
    return out


def lower_cell(arch: str, shape_name: str, mesh, variant: str = "baseline",
               flags: dict | None = None) -> dict:
    """Trace one (arch, shape) cell on ``mesh`` (rank 0 of a live process
    group, or None) under the variant's flags ("baseline": every flag off,
    "opt": the defaults; then ``flags`` on top); return the record.  The
    flags are restored afterwards."""
    saved = dict(opt_flags.FLAGS)
    (opt_flags.set_baseline if variant == "baseline" else opt_flags.set_opt)()
    opt_flags.FLAGS.update(flags or {})
    used = dict(opt_flags.FLAGS)
    try:
        cfg = get_config(arch)
        shape = SHAPES[shape_name]
        rec = trace_step(cfg, shape.kind, shape.global_batch, shape.seq_len, mesh)
    finally:
        opt_flags.FLAGS.update(saved)
    dims = comm.mesh_shape(mesh) or {"data": 1, "model": 1}
    n = 1
    for v in dims.values():
        n *= v
    return {"arch": arch, "shape": shape_name, "mesh": dims, "kind": shape.kind,
            "trace_s": round(rec.pop("trace_s"), 2), **rec, "n_devices": n, "flags": used}


def cells(mesh_kind: str):
    for arch in ARCH_IDS:
        if arch == "vusa_edge":
            continue  # the paper's own config is measured on the card, not a pool cell
        for shape_name in SHAPES:
            yield arch, shape_name, mesh_kind


def _skip(arch: str, shape_name: str) -> bool:
    return shape_name == "long_500k" and arch not in LONG_OK


def run_cell(arch: str, shape_name: str, mesh_kind: str, force: bool = False,
             variant: str = "baseline", flags: dict | None = None,
             out_dir: Path = OUT_DIR) -> dict:
    from .mesh import make_production_mesh

    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = "" if variant == "baseline" else f"_{variant}"
    out = out_dir / f"{arch}__{shape_name}__{mesh_kind}{suffix}.json"
    if out.exists() and not force:
        return json.loads(out.read_text())
    if _skip(arch, shape_name):
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "status": "skip",
               "reason": "pure full-attention arch: 500k decode is quadratic-class"}
        out.write_text(json.dumps(rec, indent=1))
        return rec
    multi = mesh_kind == "multi"
    try:
        with fake_world(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi)
            rec = lower_cell(arch, shape_name, mesh, variant=variant, flags=flags)
        rec["status"] = "ok"
        rec["variant"] = variant
    except Exception as e:  # a failed cell is recorded: it is a bug to fix
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "status": "fail",
               "error": f"{type(e).__name__}: {e}", "trace": traceback.format_exc()[-2000:]}
    out.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline",
                    help="baseline | opt | opt<suffix> (a suffix names a flag A/B of --flags)")
    ap.add_argument("--flags", default="", help="overrides on top of the variant: name=0,name=1")
    args = ap.parse_args(argv)
    flags = parse_flags(args.flags)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        todo = [(a, s, m) for m in meshes for (a, s, _) in cells(m)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        todo = [(args.arch.replace("-", "_").replace(".", "_"), args.shape, m) for m in meshes]

    for arch, shape_name, mesh_kind in todo:
        t0 = time.time()
        rec = run_cell(arch, shape_name, mesh_kind, force=args.force, variant=args.variant,
                       flags=flags)
        status = rec.get("status")
        extra = ""
        if status == "ok":
            extra = f"trace={rec['trace_s']}s flops={rec['weighted']['dot_flops']:.3g}"
        elif status == "fail":
            extra = rec["error"][:120]
        print(f"[{time.strftime('%H:%M:%S')}] {arch:22s} {shape_name:12s} {mesh_kind:6s} "
              f"{status:5s} ({time.time() - t0:.0f}s) {extra}", flush=True)


if __name__ == "__main__":
    main()
