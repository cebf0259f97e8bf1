"""The port's production-mesh dry run and roofline (``launch/dryrun.py``,
``launch/roofline.py``) against the reference's.

``model_flops`` equals the reference's for every cell on both production
meshes; the cells and the ``long_500k`` skips are the reference's; and one
smoke-config cell of each kind traces as rank 0 of the fake 16x16 mesh in
seconds, on ``meta`` tensors only, into a record with the reference's keys
(``trace_s`` for ``compile_s``, ``collectives`` for the unweighted HLO
collectives, and no XLA ``cost`` analysis).
"""

import dataclasses
import importlib
import json
import os
import time

import pytest

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from repro_torch.launch import dryrun, roofline


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module.  Importing it sets ``XLA_FLAGS`` for
    512 host devices (its first lines); put the variable back so no child
    process of a later test inherits it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        mod = importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


@pytest.mark.parametrize("n_devices", [256, 512])
def test_model_flops_equal_reference(n_devices):
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_config
    from repro.launch import roofline as ref_roofline

    for arch in ARCH_IDS:
        for name, shape in SHAPES.items():
            got = roofline.model_flops(get_config(arch), shape, n_devices)
            want = ref_roofline.model_flops(ref_config(arch), REF_SHAPES[name], n_devices)
            assert got == want, (arch, name)


def test_cells_and_skips_are_the_references(ref_dryrun):
    for mesh in ("single", "multi"):
        assert sorted(dryrun.cells(mesh)) == sorted(ref_dryrun.cells(mesh))
    assert dryrun.LONG_OK == ref_dryrun.LONG_OK
    skips = {(a, s) for a, s, _ in dryrun.cells("single") if dryrun._skip(a, s)}
    want = {(a, s) for a, s, _ in ref_dryrun.cells("single")
            if s == "long_500k" and a not in ref_dryrun.LONG_OK}
    assert skips == want and len(skips) == 8


_KEYS = {"arch", "shape", "mesh", "kind", "trace_s", "memory", "weighted", "collectives",
         "n_devices", "status", "variant", "flags"}


@pytest.mark.parametrize("arch,shape", [("llama3_2_1b", "train_4k"), ("qwen2_0_5b", "prefill_32k"),
                                        ("mamba2_2_7b", "long_500k")])
def test_smoke_cell_traces_on_fake_production_mesh(arch, shape, tmp_path, monkeypatch,
                                                   ref_dryrun):
    """Smoke widths, the cell's kind at a small size (32 rows, 64 tokens),
    as rank 0 of the fake 16x16 mesh: ok, the reference's record keys, and
    every argument a ``meta`` tensor."""
    small = {k: dataclasses.replace(v, seq_len=64, global_batch=32) for k, v in SHAPES.items()}
    monkeypatch.setattr(dryrun, "SHAPES", small)
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    t0 = time.time()
    rec = dryrun.run_cell(arch, shape, "single", variant="opt", out_dir=tmp_path)
    assert time.time() - t0 < 30
    assert rec["status"] == "ok", rec.get("trace")
    assert set(rec) == _KEYS
    ref_keys = {"arch", "shape", "mesh", "kind", "compile_s", "memory", "cost", "weighted",
                "collectives_unweighted", "n_devices", "status", "variant"}
    assert set(rec) - {"flags"} == ref_keys - {"compile_s", "cost", "collectives_unweighted"} | {
        "trace_s", "collectives"}
    assert rec["mesh"] == {"data": 16, "model": 16} and rec["n_devices"] == 256
    assert set(rec["weighted"]) == {"dot_flops", "bytes", "transcendentals", "collectives"}
    assert rec["weighted"]["dot_flops"] > 0 and rec["memory"]["temp_size_in_bytes"] > 0
    assert json.loads((tmp_path / f"{arch}__{shape}__single_opt.json").read_text()) == rec
    row = roofline.analyze_record(rec, shape=small[shape])
    assert row["dominant"] in ("compute", "memory", "collective")
    # the arguments of the traced step hold no storage
    with dryrun.fake_world(256):
        from repro_torch.launch.mesh import make_production_mesh

        _, args = dryrun.build_step(get_smoke_config(arch), small[shape].kind, 32, 64,
                                    make_production_mesh())
    leaves = dryrun._leaves(args)
    assert leaves and all(t.is_meta or t.numel() == 1 for t in leaves)


def test_skip_and_resume(tmp_path):
    rec = dryrun.run_cell("qwen3_8b", "long_500k", "multi", out_dir=tmp_path)
    assert rec["status"] == "skip"
    (tmp_path / "x__y__single.json").write_text(json.dumps({"status": "ok", "kept": 1}))
    assert dryrun.run_cell("x", "y", "single", out_dir=tmp_path)["kept"] == 1  # resumed
    with pytest.raises(ValueError):
        dryrun.parse_flags("no_such_flag=1")
    assert dryrun.parse_flags("decode_direct=0,xent_lse=1") == {"decode_direct": False,
                                                                 "xent_lse": True}


def test_roofline_table_over_records(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "SHAPES", {k: dataclasses.replace(v, seq_len=64, global_batch=32)
                                           for k, v in SHAPES.items()})
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    dryrun.run_cell("llama3_2_1b", "decode_32k", "single", out_dir=tmp_path)
    dryrun.run_cell("llama3_2_1b", "long_500k", "single", out_dir=tmp_path)
    rows = roofline.build_table("single", dryrun=tmp_path)
    assert [r["dominant"] == "skip" for r in rows] == [False, True]
    md = roofline.to_markdown(rows)
    assert md.count("\n") == 3 and "llama3_2_1b" in md
    assert roofline.PEAK_FLOPS == 989.4e12 and roofline.HBM_BW == 3.35e12
