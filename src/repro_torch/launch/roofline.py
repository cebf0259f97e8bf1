"""Roofline analysis over the port's dry-run records.

The port's counterpart of the JAX package's ``launch/roofline.py``, over
``experiments/dryrun_torch/`` (``launch/dryrun.py``).  Three terms per
(arch x shape) cell, in seconds a step, from rank 0's counts of
``launch/op_cost.py``:

    compute    = dot_flops / PEAK_FLOPS
    memory     = bytes / HBM_BW
    collective = collective_bytes / LINK_BW

These are a trace of the port's per-rank program held against one card's
data-sheet peaks, not a measurement.  MODEL_FLOPS uses 6*N*D (train),
2*N*D (prefill) or 2*N*B (decode), with N_active for MoE, divided over the
mesh's devices; ``roofline_frac`` is the useful compute time over the
bound.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh single] [--md]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

# NVIDIA H100 SXM5 80GB data sheet: dense (no sparsity) bf16 tensor-core
# rate, HBM3 bandwidth, and NVLink 4 at 900 GB/s a card, 450 GB/s a direction
PEAK_FLOPS = 989.4e12  # bf16 FLOP/s
HBM_BW = 3.35e12  # B/s
LINK_BW = 450e9  # B/s a direction

DRYRUN = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def model_flops(cfg, shape, n_devices: int) -> float:
    """Per-device useful model FLOPs for one step of this cell."""
    n_active = cfg.active_param_count() if cfg.family == "moe" else cfg.param_count()
    seq = shape.seq_len
    if cfg.family == "encdec" and shape.kind == "prefill":
        seq = min(seq, cfg.enc_frames)  # prefill encodes frames only
    tokens = shape.global_batch * seq
    if shape.kind == "train":
        total = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        total = 2.0 * n_active * tokens
    else:  # decode: one new token per sequence
        total = 2.0 * n_active * shape.global_batch
    return total / n_devices


def analyze_record(rec: dict, shape=None) -> dict:
    """The roofline terms of one ``ok`` record.  ``shape`` (a
    ``ShapeConfig``) replaces the lookup of ``rec["shape"]`` in ``SHAPES``,
    for a record of a shape outside them."""
    from ..configs import SHAPES, get_config

    cfg = get_config(rec["arch"])
    shape = shape or SHAPES[rec["shape"]]
    w = rec["weighted"]
    coll_bytes = sum(e["bytes"] for e in w["collectives"].values())
    terms = {
        "compute_s": w["dot_flops"] / PEAK_FLOPS,
        "memory_s": w["bytes"] / HBM_BW,
        "collective_s": coll_bytes / LINK_BW,
    }
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape, rec["n_devices"])
    bound = max(terms.values())
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        **{k: round(v, 6) for k, v in terms.items()},
        "bound_s": bound,
        "dominant": dominant.replace("_s", ""),
        "model_flops_dev": mf,
        "hlo_flops_dev": w["dot_flops"],
        "useful_ratio": round(mf / w["dot_flops"], 3) if w["dot_flops"] else None,
        # roofline fraction: useful-compute time / bound time (MFU at the bound)
        "roofline_frac": round((mf / PEAK_FLOPS) / bound, 4) if bound else None,
        "collective_bytes_dev": coll_bytes,
        "temp_bytes_dev": rec["memory"].get("temp_size_in_bytes", 0),
        "trace_s": rec.get("trace_s"),
    }


_ADVICE = {
    "compute": "cut redundant flops: tensor-parallel dense compute, flash-backward recompute",
    "memory": "cut bytes: fuse elementwise chains, keep weights in bf16, fewer small kernels",
    "collective": "cut comm: reduce-scatter grads, shard the gathers, overlap with compute",
}


def build_table(mesh: str = "single", suffix: str = "", dryrun: Path = DRYRUN) -> list:
    rows = []
    for f in sorted(dryrun.glob(f"*__{mesh}{suffix}.json")):
        rec = json.loads(f.read_text())
        if rec.get("status") == "ok" and "weighted" in rec:
            rows.append(analyze_record(rec))
        elif rec.get("status") == "skip":
            rows.append({"arch": rec["arch"], "shape": rec["shape"], "dominant": "skip",
                         "note": rec.get("reason", "")[:60]})
    return rows


def to_markdown(rows: list) -> str:
    hdr = ("| arch | shape | compute (s) | memory (s) | collective (s) | dominant | "
           "MODEL/HLO flops | roofline frac | trace (s) | next lever |")
    sep = "|" + "---|" * 10
    lines = [hdr, sep]
    for r in rows:
        if r["dominant"] == "skip":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | skip | — | — | — | "
                         f"{r.get('note', '')} |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4f} | {r['memory_s']:.4f} | "
            f"{r['collective_s']:.4f} | **{r['dominant']}** | {r['useful_ratio']} | "
            f"{r['roofline_frac']:.3f} | {r['trace_s']} | {_ADVICE[r['dominant']]} |"
        )
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--suffix", default="", help="record suffix, e.g. _opt")
    ap.add_argument("--md", action="store_true")
    args = ap.parse_args(argv)
    rows = build_table(args.mesh, args.suffix)
    out = DRYRUN.parent / f"roofline_torch_{args.mesh}{args.suffix}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    if args.md:
        print(to_markdown(rows))
        return
    ok = [r for r in rows if r["dominant"] != "skip"]
    ok.sort(key=lambda r: r["roofline_frac"] or 0)
    print(f"{len(ok)} cells analyzed -> {out}")
    print("\nWorst roofline fraction:")
    for r in ok[:5]:
        print(f"  {r['arch']:22s} {r['shape']:12s} frac={r['roofline_frac']:.4f} "
              f"dom={r['dominant']}")
    coll = sorted(
        ok, key=lambda r: -(r["collective_s"] / max(max(r["compute_s"], r["memory_s"]), 1e-12)))
    print("\nMost collective-bound:")
    for r in coll[:5]:
        print(f"  {r['arch']:22s} {r['shape']:12s} coll={r['collective_s']:.4f}s vs "
              f"max(comp,mem)={max(r['compute_s'], r['memory_s']):.4f}s")


if __name__ == "__main__":
    main()
