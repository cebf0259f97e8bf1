"""Tree checkpoints: the port against the reference's on-disk format.

A checkpoint of ``{"params", "opt": AdamState}`` written by either package
restores in the other bitwise (fp32 leaves, an int32 ``opt/step``), under
the reference's leaf keys (``params/layers/attn/wq``, ``opt/mu/...``).  The
port's own roundtrip, retention, async save, atomic writes and corruption
checks mirror ``tests/test_checkpoint.py``.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.optim import AdamState as RefAdamState
from repro_torch.checkpoint import Checkpointer, latest_step, restore, save
from repro_torch.checkpoint.ckpt import _flatten
from repro_torch.configs import get_smoke_config
from repro_torch.convert import adam_state_to_numpy, params_from_numpy, params_to_numpy
from repro_torch.models import build_model
from repro_torch.optim import AdamState, adamw_init


def _state(seed=0):
    """The port's ``{"params", "opt"}`` of smoke ``vusa_edge``, moments
    filled from a seed, step 7."""
    params = build_model(get_smoke_config("vusa_edge")).init(seed, device="cpu")
    opt = adamw_init(params)
    g = torch.Generator().manual_seed(seed)
    for tree in (opt.mu, opt.nu):
        for _, leaf in _flatten(tree).items():
            leaf.copy_(torch.rand(leaf.shape, generator=g))
    opt.step.fill_(7)
    return {"params": params, "opt": opt}


def _ref_tree(state):
    return {"params": jax.tree_util.tree_map(jnp.asarray, params_to_numpy(state["params"])),
            "opt": RefAdamState(**jax.tree_util.tree_map(jnp.asarray,
                                                          adam_state_to_numpy(state["opt"])))}


def _numpy_flat(tree):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in _flatten(tree).items()}


def _assert_bitwise(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def test_leaf_keys_are_the_references(tmp_path):
    state = _state()
    keys = set(_flatten(state))
    assert keys == set(ref_ckpt._flatten(_ref_tree(state)))
    assert {"params/embed", "params/layers/attn/wq", "opt/step", "opt/mu/layers/ffn/w_gate",
            "opt/nu/final_norm"} <= keys
    save(tmp_path, 5, state)
    manifest = json.loads((tmp_path / "step_00000005" / "manifest.json").read_text())
    assert manifest["step"] == 5 and set(manifest["leaves"]) == keys
    assert manifest["leaves"]["opt/step"]["dtype"] == "int32"
    assert manifest["leaves"]["opt/step"]["shape"] == []


def test_reference_checkpoint_restores_in_port_bitwise(tmp_path):
    state = _state(1)
    ref = _ref_tree(state)
    ref_ckpt.save(tmp_path, 3, ref)
    got = restore(tmp_path, 3, _state(2))
    assert isinstance(got["opt"], AdamState) and got["opt"].step.dtype == torch.int32
    _assert_bitwise(_numpy_flat(got), _numpy_flat(jax.tree_util.tree_map(np.asarray, ref)))


def test_port_checkpoint_restores_in_reference_bitwise(tmp_path):
    state = _state(3)
    save(tmp_path, 4, state)
    like = _ref_tree(_state(4))
    got = ref_ckpt.restore(tmp_path, 4, like)
    assert isinstance(got["opt"], RefAdamState)
    want = _numpy_flat(state)
    _assert_bitwise({k: np.asarray(v) for k, v in ref_ckpt._flatten(got).items()}, want)
    # the same files either way: the port's save and the reference's agree byte for byte
    ref_ckpt.save(tmp_path / "ref", 4, _ref_tree(state))
    for f in sorted((tmp_path / "step_00000004").iterdir()):
        assert f.read_bytes() == (tmp_path / "ref" / "step_00000004" / f.name).read_bytes(), f


def test_roundtrip_keeps_device_and_dtype(tmp_path):
    state = _state()
    save(tmp_path, 3, state)
    assert latest_step(tmp_path) == 3
    got = restore(tmp_path, 3, _state(5))
    _assert_bitwise(_numpy_flat(got), _numpy_flat(state))
    assert all(v.device.type == "cpu" for v in _flatten(got).values())


def test_retention_and_latest(tmp_path):
    ck = Checkpointer(tmp_path, keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        ck.save(s, {"a": torch.full((3,), float(s))})
    steps = sorted(int(p.name[5:]) for p in Path(tmp_path).glob("step_*"))
    assert steps == [3, 4]
    step, tree = ck.restore_latest({"a": torch.zeros(3)})
    assert step == 4 and torch.equal(tree["a"], torch.full((3,), 4.0))


def test_restore_latest_empty(tmp_path):
    like = {"x": torch.zeros(3)}
    step, tree = Checkpointer(tmp_path).restore_latest(like)
    assert step is None and tree is like


def test_async_save_snapshots_before_the_next_update(tmp_path):
    """The tensors are copied to the host before the writer thread starts:
    an in-place update right after ``save`` does not reach the files."""
    ck = Checkpointer(tmp_path, async_save=True)
    t = torch.arange(1 << 16, dtype=torch.float32)
    ck.save(7, {"w": t})
    t.zero_()
    ck.wait()
    assert latest_step(tmp_path) == 7
    got = restore(tmp_path, 7, {"w": torch.empty_like(t)})
    assert torch.equal(got["w"], torch.arange(1 << 16, dtype=torch.float32))


def test_partial_write_is_invisible(tmp_path):
    save(tmp_path, 1, {"a": torch.zeros(3)})
    bad = Path(tmp_path) / ".tmp_step_00000002"
    bad.mkdir()
    (bad / "leaf_00000.npy").write_bytes(b"junk")
    assert latest_step(tmp_path) == 1


def test_missing_leaf_raises(tmp_path):
    save(tmp_path, 1, {"a": torch.zeros(3)})
    with pytest.raises(KeyError, match="extra"):
        restore(tmp_path, 1, {"a": torch.zeros(3), "extra": torch.zeros(2)})


def _corrupt(tmp_path, how):
    state = {"a": torch.randn(4, 8), "nested": {"b": torch.arange(10, dtype=torch.int32)}}
    d = save(tmp_path, 1, state)
    f = d / "leaf_00000.npy"
    if how == "truncated":
        f.write_bytes(f.read_bytes()[:-8])
    elif how == "CRC":
        raw = bytearray(f.read_bytes())
        raw[-1] ^= 0x40  # one payload bit: same length, wrong bytes
        f.write_bytes(bytes(raw))
    else:
        f.unlink()
    return state


@pytest.mark.parametrize("how", ["truncated", "CRC", "missing"])
def test_corrupt_leaf_raises(tmp_path, how):
    state = _corrupt(tmp_path, how)
    with pytest.raises(ValueError, match=how):
        restore(tmp_path, 1, state)


def test_legacy_manifest_without_crc_restores(tmp_path):
    """Manifests written before the CRC field existed stay readable; shape
    and dtype are still checked."""
    state = {"a": torch.randn(4, 8), "nested": {"b": torch.arange(10, dtype=torch.int32)}}
    d = save(tmp_path, 1, state)
    mf = d / "manifest.json"
    manifest = json.loads(mf.read_text())
    for entry in manifest["leaves"].values():
        entry.pop("crc32")
        entry.pop("nbytes")
    mf.write_text(json.dumps(manifest))
    got = restore(tmp_path, 1, state)
    assert torch.equal(got["a"], state["a"]) and torch.equal(got["nested"]["b"],
                                                             state["nested"]["b"])
    manifest["leaves"]["a"]["shape"] = [8, 4]
    mf.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="manifest"):
        restore(tmp_path, 1, state)


def test_params_cross_through_convert(tmp_path):
    """A reference checkpoint's params restored as numpy feed
    ``params_from_numpy`` as they are."""
    state = _state(6)
    ref_ckpt.save(tmp_path, 2, _ref_tree(state))
    like = {"params": params_to_numpy(_state(7)["params"])}
    got = restore(tmp_path, 2, like)
    back = params_from_numpy(got["params"], "cpu")
    _assert_bitwise(_numpy_flat(back), _numpy_flat(state["params"]))
