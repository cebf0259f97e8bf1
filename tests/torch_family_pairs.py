"""Shared setup of the port-vs-reference family tests
(``test_torch_families.py``, ``test_torch_moe.py``, ``test_torch_vlm.py``).

A pair is one smoke config's parameters from ``repro``'s
``build_model(cfg).init(key(0))`` with every bias, qk-norm scale and norm
scale overwritten by seeded numpy values (the init leaves them at zero,
which would hide a missing or misplaced bias or norm), held as numpy and
crossed to the reference (``jnp``) and to the port (``params_from_numpy``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import build_model as ref_build
from repro.models.opt_flags import FLAGS as REF_FLAGS
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers

# leaves the init sets to zero: the norms' (1 + scale) gains, the QKV biases
PERTURBED = ("bq", "bk", "bv", "q_norm", "k_norm", "norm1", "norm2", "final_norm")


def perturb(tree: dict, seed: int = 0) -> dict:
    """A copy of the numpy tree with every ``PERTURBED`` leaf drawn from
    normal(0, 0.5), leaf by leaf in sorted key order."""
    rng = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for k in sorted(t):
            v = t[k]
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in PERTURBED:
                out[k] = rng.normal(0, 0.5, v.shape).astype(np.float32)
            else:
                out[k] = np.array(v, copy=True)
        return out

    return walk(tree)


class Pair:
    """One arch on both sides: ``ref_cfg``/``cfg``, the numpy tree ``tree``,
    the reference's ``params`` and the port's ``tparams``, and models."""

    def __init__(self, arch: str, seed: int = 0):
        self.arch = arch
        self.ref_cfg = ref_smoke(arch)
        self.cfg = get_smoke_config(arch)
        raw = jax.tree_util.tree_map(np.asarray, ref_build(self.ref_cfg).init(jax.random.key(seed)))
        self.tree = perturb(raw, seed)
        self.params = jax.tree_util.tree_map(lambda a: jnp.asarray(a.copy()), self.tree)
        self.tparams = params_from_numpy(self.tree, "cpu")
        self.ref_model = ref_build(self.ref_cfg)
        from repro_torch.models import build_model

        self.model = build_model(self.cfg)


def np_(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def close(got, want, what="", tol=1e-5):
    """max |got - want| <= tol * max(|want|, 1)."""
    got, want = np_(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max()) if got.size else 0.0
    assert err <= tol * max(float(np.abs(want).max()) if want.size else 0.0, 1.0), (what, err)


@pytest.fixture
def fp32_attention_probs():
    """Pin ``attn_bf16_probs`` off on both sides, as the reference's model
    tests do, so prefill (flash) and decode (direct) run one fp32 pipeline."""
    prev = REF_FLAGS["attn_bf16_probs"], layers.FLAGS["attn_bf16_probs"]
    REF_FLAGS["attn_bf16_probs"] = layers.FLAGS["attn_bf16_probs"] = False
    yield
    REF_FLAGS["attn_bf16_probs"], layers.FLAGS["attn_bf16_probs"] = prev
