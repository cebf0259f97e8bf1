"""Model facade: one object per architecture with a uniform API, backed by
the family implementations in :mod:`repro_torch.models.families`.

Port of the JAX package's ``models/registry.py``: the decoder-only
families (dense, moe, vlm) on ``families.lm_*``, the hybrid on
``hybrid_*``, the ssm on ``ssm_*`` and the encdec on ``encdec_*``.  The
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
from .common import abstract_params, init_params

# family -> (specs, forward, loss, cache_specs, decode_step)
_FAMILY_FNS = {
    **{fam: (F.lm_specs, F.lm_forward, F.lm_loss, F.lm_cache_specs, F.lm_decode_step)
       for fam in F.LM_FAMILIES},
    "hybrid": (F.hybrid_specs, F.hybrid_forward, F.hybrid_loss, F.hybrid_cache_specs,
               F.hybrid_decode_step),
    "ssm": (F.ssm_specs, F.ssm_forward, F.ssm_loss, F.ssm_cache_specs, F.ssm_decode_step),
    "encdec": (F.encdec_specs, F.encdec_forward, F.encdec_loss, F.encdec_cache_specs,
               F.encdec_decode_step),
}


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, plan=None):
        """``plan``: a serving engine's tensor-parallel plan
        (``dist.tp.TPPlan``), from which the recurrent families' cache specs
        take this rank's SSM heads and RG-LRU channels; None: whole."""
        super().__init__()
        F.check_family(cfg)
        self.cfg = cfg
        self.plan = plan
        (self._specs, self._forward, self._loss, self._cache_specs,
         self._decode_step) = _FAMILY_FNS[cfg.family]

    # ---- params ----
    def specs(self) -> dict:
        return self._specs(self.cfg)

    def init(self, seed: int = 0, device="cuda", leaf=None) -> dict:
        """Random parameters drawn from ``numpy.random.default_rng(seed)``;
        ``leaf(path, tensor)`` maps each whole leaf on the host before it
        moves (a rank's pruned shard: the whole tree never exists)."""
        return init_params(self.specs(), seed, torch.device(device), leaf)

    def abstract_params(self) -> dict:
        """The parameter tree as ``meta`` tensors (no allocation)."""
        return abstract_params(self.specs())

    # ---- train / eval ----
    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """Scalar LM loss, plus 0.01 x the MoE aux loss for the moe family."""
        return self._loss(params, batch, self.cfg)

    def forward(self, params: dict, batch: dict):
        return self._forward(params, batch, self.cfg)

    # ---- serve ----
    def init_cache(self, batch: int, max_len: int, device="cuda", frames: int = 0) -> dict:
        """A zero decode cache; ``frames`` sizes the encdec family's cross
        K/V (0: ``enc_frames``)."""
        return F.init_cache(self.cache_specs(batch, max_len, frames), torch.device(device))

    def cache_specs(self, batch: int, max_len: int, frames: int = 0) -> dict:
        if self.cfg.family == "encdec":
            return F.encdec_cache_specs(self.cfg, batch, max_len, frames)
        if self.cfg.family in F.RECURRENT_FAMILIES:
            return self._cache_specs(self.cfg, batch, max_len, plan=self.plan)
        return self._cache_specs(self.cfg, batch, max_len)

    def decode_step(self, params: dict, token, cache: dict, rowwise: bool = False, x=None):
        """One decode step; ``x``, the LM families' embedding rows of
        ``token`` made by the caller (``families.lm_decode_step``)."""
        if x is not None:
            return self._decode_step(params, token, cache, self.cfg, rowwise=rowwise, x=x)
        return self._decode_step(params, token, cache, self.cfg, rowwise=rowwise)

    def prefill(self, params: dict, batch: dict, max_len: int, lengths=None):
        """Bulk prefill: the LM families (masked with ``lengths``), or the
        encdec family's encoder pass (``batch["frames"]``; no ``lengths``).
        The recurrent families have none: the engine primes them through
        decode steps, as the reference does."""
        fam = self.cfg.family
        if fam in F.RECURRENT_FAMILIES:
            raise NotImplementedError(
                f"family {fam!r} has no prefill: its prompt runs through decode steps "
                "(Engine.prime)")
        if fam == "encdec":
            if lengths is not None:
                raise NotImplementedError("masked prefill is for the LM families")
            return F.encdec_prefill(params, batch, self.cfg, max_len)
        return F.lm_prefill(params, batch, self.cfg, max_len, lengths=lengths)

    # ---- slot pool (continuous batching; see serve/scheduler.py) ----
    def init_slot_cache(self, slots: int, max_len: int, device="cuda") -> dict:
        """The slot pool: one decode cache whose batch axis is the slot
        axis, each row with its own ``pos``."""
        from .cache import init_slot_cache

        return init_slot_cache(self.cache_specs(slots, max_len), torch.device(device))

    def cache_batch_axes(self, max_len: int) -> dict:
        """Per-leaf batch axis (:func:`repro_torch.models.cache.batch_axes`)
        for scattering batched prefill caches into slots."""
        from .cache import batch_axes

        return batch_axes(self.cache_specs(1, max_len), self.cache_specs(2, max_len))

    def write_slots(self, slot_cache, idx, batched_cache, axes, pos) -> None:
        """Scatter a batched (B = N) cache into slots ``idx`` in place;
        ``pos`` (N,) sets each slot's true sequence position."""
        from .cache import write_slots

        write_slots(slot_cache, idx, batched_cache, axes, pos)

    def write_slot(self, slot_cache, i: int, sub_cache, max_len: int) -> None:
        """Replace slot ``i`` with the B = 1 cache ``sub_cache``, in place."""
        from .cache import write_slot

        write_slot(slot_cache, i, sub_cache, self.cache_batch_axes(max_len))

    def reset_slot(self, slot_cache, i: int, max_len: int) -> None:
        from .cache import reset_slot

        reset_slot(slot_cache, i, self.cache_batch_axes(max_len))

    def read_slot(self, slot_cache, i: int, max_len: int) -> dict:
        from .cache import read_slot

        return read_slot(slot_cache, i, self.cache_batch_axes(max_len))

    # ---- paged pool ----
    def paged_seq_len(self, max_len: int):
        """``max_len`` if this family's cache is KV-shaped and can be paged,
        else None: the vlm family (its patch-prefix rows would complicate
        block addressing), the recurrent families (their state is no
        sequence) and the encdec family, as in the reference."""
        from .cache import paged_seq_len

        if self.cfg.family not in ("dense", "moe"):
            return None
        return paged_seq_len(self.cache_specs(1, max_len))

    def init_paged_pool(self, layout, max_len: int, device="cuda") -> dict:
        from .cache import init_paged_pool

        return init_paged_pool(self.cache_specs(1, max_len), layout, torch.device(device))

    def prefill_chunk(self, params, tokens, arena, table_row, start: int, true_len: int,
                      write_from: int):
        """One chunk of a paged chunked prefill (``families.lm_prefill_chunk``;
        the dense and moe families, whose pools can be paged)."""
        if self.cfg.family not in ("dense", "moe"):
            raise NotImplementedError(f"chunked prefill for family {self.cfg.family}")
        return F.lm_prefill_chunk(params, tokens, self.cfg, arena, table_row, start, true_len,
                                  write_from)

    # ---- input stand-ins (for tracing a step; no allocation) ----
    def input_specs(self, batch: int, seq: int, kind: str = "train") -> dict:
        """``meta`` tensors of every model input, the reference's shapes and
        dtypes: int32 ``tokens`` (B, S) for train and prefill (the vlm
        family's S less its patch prefix, plus fp32 ``patches`` (B, P, d);
        the encdec family's fp32 ``frames`` (B, min(S, enc_frames), d)),
        and an int32 ``token`` (B, 1) for decode."""
        cfg = self.cfg

        def meta(shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device="meta")

        if kind in ("train", "prefill"):
            if cfg.family == "vlm":
                return {"tokens": meta((batch, seq - cfg.patch_tokens)),
                        "patches": meta((batch, cfg.patch_tokens, cfg.d_model), torch.float32)}
            spec = {"tokens": meta((batch, seq))}
            if cfg.family == "encdec":
                spec["frames"] = meta((batch, min(seq, cfg.enc_frames), cfg.d_model),
                                      torch.float32)
            return spec
        if kind == "decode":
            return {"token": meta((batch, 1))}
        raise ValueError(kind)


def build_model(cfg: ArchConfig, plan=None) -> Model:
    return Model(cfg, plan)
