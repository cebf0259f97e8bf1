"""Port vs reference: the small host helpers of the model facade.

``cache.slot_count`` / ``write_slot`` (and ``Model.write_slot``) round-trip
one slot without touching its neighbours, as ``tests/test_scheduler.py``
checks for the reference; ``Model.input_specs`` and
``Model.abstract_params`` give the reference's shapes and dtypes as
``meta`` tensors, which hold no storage.
"""

import os

import jax.numpy as jnp
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from repro_torch.models import build_model
from repro_torch.models.cache import slot_count, write_slot
from repro_torch.models.common import abstract_params

_DTYPES = {jnp.dtype("int32"): torch.int32, jnp.dtype("float32"): torch.float32}


@pytest.mark.parametrize("arch", ["llama3_2_1b", "mamba2_2_7b", "recurrentgemma_9b"])
def test_slot_cache_roundtrip(arch):
    model = build_model(get_smoke_config(arch))
    pool = model.init_slot_cache(3, 32, device="cpu")
    assert slot_count(pool) == 3
    before = [model.read_slot(pool, i, 32) for i in range(3)]
    sub = {k: torch.ones_like(v) for k, v in model.init_cache(1, 32, device="cpu").items()}
    model.write_slot(pool, 1, sub, 32)
    for k, v in model.read_slot(pool, 1, 32).items():
        assert torch.equal(v, sub[k]), k
    for other in (0, 2):  # neighbours untouched
        for k, v in model.read_slot(pool, other, 32).items():
            assert torch.equal(v, before[other][k]), (other, k)
    write_slot(pool, 2, sub, model.cache_batch_axes(32))  # the cache helper itself
    assert all(torch.equal(v, sub[k]) for k, v in model.read_slot(pool, 2, 32).items())
    model.reset_slot(pool, 1, 32)
    model.reset_slot(pool, 2, 32)
    fresh = model.init_slot_cache(3, 32, device="cpu")
    assert all(torch.equal(pool[k], fresh[k]) for k in pool)


def test_input_specs_cover_every_cell():
    assert set(SHAPES) == set(REF_SHAPES)
    for arch in ARCH_IDS:
        model, ref = build_model(get_config(arch)), ref_build(ref_config(arch))
        for shape in SHAPES.values():
            kind = shape.kind if shape.kind in ("train", "prefill") else "decode"
            got = model.input_specs(shape.global_batch, shape.seq_len, kind)
            want = ref.input_specs(shape.global_batch, shape.seq_len, kind)
            assert list(got) == list(want), (arch, shape.name)
            for k, v in want.items():
                assert got[k].is_meta and tuple(got[k].shape) == tuple(v.shape), (arch, k)
                assert got[k].dtype == _DTYPES[jnp.dtype(v.dtype)], (arch, k)
    with pytest.raises(ValueError):
        model.input_specs(1, 8, "sample")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_match_reference(arch):
    model = build_model(get_config(arch))
    got = model.abstract_params()
    want = ref_build(ref_config(arch)).abstract_params()

    def walk(g, w, path=()):
        assert set(g) == set(w), path
        for k in w:
            if isinstance(w[k], dict):
                walk(g[k], w[k], path + (k,))
            else:
                t = g[k]
                assert t.is_meta, path + (k,)
                assert tuple(t.shape) == tuple(w[k].shape), path + (k,)
                assert t.dtype == _DTYPES[jnp.dtype(w[k].dtype)], path + (k,)

    walk(got, want)
    assert abstract_params(model.specs()).keys() == got.keys()


def test_abstract_trees_allocate_nothing():
    """A full-size tree of ``meta`` tensors (qwen3_8b: about 8e9 fp32
    values, 32 GB if it were real) leaves the process's resident memory
    within 100 MB of where it was."""
    model = build_model(get_config("qwen3_8b"))
    leaves = []
    rss0 = _resident_bytes()

    def collect(tree):
        for v in tree.values():
            collect(v) if isinstance(v, dict) else leaves.append(v)

    collect(model.abstract_params())
    collect(model.input_specs(256, 4096, "train"))
    assert all(t.is_meta for t in leaves)
    assert sum(t.numel() for t in leaves) > 7e9
    assert _resident_bytes() - rss0 < 100e6


def _resident_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
