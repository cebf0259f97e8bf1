"""Seeded, deterministic fault injection for the serving stack.

Port of the JAX package's ``serve/faults.py``.  Production serving sees
faults the benign-world scheduler never models: a flipped bit in packed
weight metadata in device memory, a NaN creeping into a slot's KV cache, an
admission path or a device that stalls.  Every injector is driven by a
:class:`FaultConfig`, and every decision is a pure function of ``(seed,
rid)`` (numpy ``default_rng((seed, salt, rid))``, as in the reference, so
the same plan selects the same requests in both packages), never of the
clock or global random state, so a faulted run replays exactly:

* ``corrupt_pack_positions`` flips packed *position* metadata out of range,
  before load validation: ``serve.packed.validate_packed`` must refuse the
  pack (the Engine never serves it).
* ``corrupt_pack_values`` sets packed *values* to NaN after validation
  (post-load corruption); the per-slot ``isfinite`` guard the pool step
  carries catches it at run time.  Quantized packs hold int8 value bytes,
  where NaN does not exist: the slot's fp32 dequant scale takes the NaN.
* cache poisoning: ``wants_cache_nan`` names the admitted requests whose
  cache gets one NaN (``models.cache.poison_slot`` /
  ``paged_poison_block``); it reaches the logits within one step.
* admission stalls (``wants_stall``) sleep the admission path; decode
  stalls and hangs (``wants_decode_stall`` / ``wants_decode_hang``) stall
  the run loop right before a segment's dispatch, in interruptible waits,
  which is what the streaming front end's watchdog trains against.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np

__all__ = ["FaultConfig", "corrupt_pack_positions", "corrupt_pack_values"]


@dataclasses.dataclass
class FaultConfig:
    """Reproducible fault plan, wired through ``ServeConfig.faults``.

    ``pack_position_flips`` corrupt packed metadata before load validation
    (the Engine must refuse the pack); ``pack_value_nans`` corrupt packed
    values after it (the runtime guard must catch them).  ``cache_nan_rate``
    poisons each admitted request's cache with a probability drawn from
    ``(seed, rid)``; ``cache_nan_rids`` names requests explicitly (the union
    applies).  ``cache_nan_once`` makes the fault transient (the retry of
    that request runs clean); ``False`` models a persistent fault that also
    kills the bounded retry.  ``stall_s`` sleeps the admission path for each
    request selected by ``stall_rate`` / ``stall_rids``.

    ``decode_stall_s`` stalls the run loop right before a segment's dispatch
    for each in-flight request selected by ``decode_stall_rate`` /
    ``decode_stall_rids``; ``decode_hang_rids`` hang it (unbounded: only a
    watchdog abort ends the wait).  ``decode_stall_once`` makes each rid's
    stall or hang one-shot, so the re-queue after a watchdog abort runs
    clean; ``False`` models a persistent wedge that ends ``STALLED``."""

    seed: int = 0
    pack_position_flips: int = 0
    pack_value_nans: int = 0
    cache_nan_rate: float = 0.0
    cache_nan_rids: Tuple[int, ...] = ()
    cache_nan_once: bool = True
    stall_s: float = 0.0
    stall_rate: float = 0.0
    stall_rids: Tuple[int, ...] = ()
    decode_stall_s: float = 0.0
    decode_stall_rate: float = 0.0
    decode_stall_rids: Tuple[int, ...] = ()
    decode_hang_rids: Tuple[int, ...] = ()
    decode_stall_once: bool = True

    def _draw(self, rid: int, salt: int) -> float:
        return float(np.random.default_rng((self.seed, salt, rid)).random())

    def wants_cache_nan(self, rid: int) -> bool:
        if rid in self.cache_nan_rids:
            return True
        return self.cache_nan_rate > 0 and self._draw(rid, 1) < self.cache_nan_rate

    def wants_stall(self, rid: int) -> bool:
        if self.stall_s <= 0:
            return False
        if rid in self.stall_rids:
            return True
        return self.stall_rate > 0 and self._draw(rid, 2) < self.stall_rate

    def stalls_decode(self) -> bool:
        """Does this plan inject any decode stall or hang at all?"""
        return bool(self.decode_hang_rids or (
            self.decode_stall_s > 0 and (self.decode_stall_rate > 0 or self.decode_stall_rids)))

    def wants_decode_stall(self, rid: int) -> bool:
        if self.decode_stall_s <= 0:
            return False
        if rid in self.decode_stall_rids:
            return True
        return self.decode_stall_rate > 0 and self._draw(rid, 3) < self.decode_stall_rate

    def wants_decode_hang(self, rid: int) -> bool:
        return rid in self.decode_hang_rids


# --------------------------------------------------------------------------
# packed-weight corruption
# --------------------------------------------------------------------------


def _pack_entries(packed: Dict):
    """(group, name, entry) for every entry of a ``pack_lm_weights`` dict, in
    the reference's order: the MLP entries, the attention entries, the
    head."""
    for name, e in packed["mlp"].items():
        yield packed["mlp"], name, e
    if packed.get("attn"):
        for name, e in packed["attn"].items():
            yield packed["attn"], name, e
    if packed.get("head") is not None:
        yield packed, "head", packed["head"]


def _corrupt(packed: Dict, n: int, seed: int, leaf: str, value, occupied_only=False) -> Dict:
    """A copy of ``packed`` with ``n`` seeded single-element flips of
    ``leaf`` ("values" or "positions").  With ``occupied_only`` the flip
    lands on a slot whose position is >= 0: an idle slot's value never
    reaches the output, so corrupting one would be a silent no-op.  Only
    the corrupted tensors are copied; the others are shared."""
    rng = np.random.default_rng(seed)
    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in packed.items()}
    for _ in range(n):
        targets = list(_pack_entries(out))
        group, name, e = targets[int(rng.integers(len(targets)))]
        e = dict(e)
        arr = e[leaf]
        if occupied_only:
            occ = np.argwhere(e["positions"].cpu().numpy() >= 0)
            if not len(occ):  # a wholly idle entry: no live slot to corrupt
                continue
            idx = tuple(int(x) for x in occ[int(rng.integers(len(occ)))])
        else:
            flat = int(rng.integers(arr.numel()))
            idx = tuple(int(x) for x in np.unravel_index(flat, tuple(arr.shape)))
        if leaf == "values" and e.get("value_dtype", "dense") != "dense":
            # quantized values are int8 bytes, where NaN does not exist (and
            # int4 values are half the positions' width): the occupied slot's
            # fp32 dequant scale takes the NaN, which reaches every value it
            # rescales and so the logits, as a NaN value would
            scales = e["scales"].clone()
            scales[idx[:-1]] = value
            e["scales"] = scales
        else:
            arr = arr.clone()
            arr[idx] = value
            e[leaf] = arr
        group[name] = e
    return out


def corrupt_pack_values(packed: Dict, cfg: FaultConfig) -> Dict:
    """NaN ``cfg.pack_value_nans`` occupied value slots (post-load
    corruption: the runtime ``isfinite`` guard's to catch)."""
    if cfg.pack_value_nans <= 0:
        return packed
    return _corrupt(packed, cfg.pack_value_nans, cfg.seed, "values", math.nan,
                    occupied_only=True)


def corrupt_pack_positions(packed: Dict, cfg: FaultConfig) -> Dict:
    """Flip ``cfg.pack_position_flips`` position bytes out of range
    (pre-validation corruption: ``validate_packed`` must refuse the pack).
    The corrupt value is -2: valid positions lie in [-1, m), so -2 is out of
    range at every window width and fits the int8 metadata."""
    if cfg.pack_position_flips <= 0:
        return packed
    return _corrupt(packed, cfg.pack_position_flips, cfg.seed + 1, "positions", -2)
