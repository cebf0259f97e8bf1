"""Model facade: one object per architecture with a uniform API, backed by
the family implementations in :mod:`repro_torch.models.families`.

Port of the JAX package's ``models/registry.py`` for the dense family.  The
facade holds the config, not the weights: parameters stay a nested dict of
tensors with the reference's layout and are passed to every call, so a
tree exported from the reference and one made by :meth:`Model.init` are
used the same way.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ArchConfig
from . import families as F
from .common import init_params


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP.md A13); the port serves 'dense'"
            )
        self.cfg = cfg

    # ---- params ----
    def specs(self) -> dict:
        return F.lm_specs(self.cfg)

    def init(self, seed: int = 0, device="cuda") -> dict:
        """Random parameters drawn from ``numpy.random.default_rng(seed)``."""
        return init_params(self.specs(), seed, torch.device(device))

    # ---- train / eval ----
    def forward(self, params: dict, batch: dict):
        return F.lm_forward(params, batch, self.cfg)

    # ---- serve ----
    def init_cache(self, batch: int, max_len: int, device="cuda") -> dict:
        return F.lm_init_cache(self.cfg, batch, max_len, torch.device(device))

    def decode_step(self, params: dict, token, cache: dict):
        return F.lm_decode_step(params, token, cache, self.cfg)

    def prefill(self, params: dict, batch: dict, max_len: int, lengths=None):
        return F.lm_prefill(params, batch, self.cfg, max_len, lengths=lengths)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
