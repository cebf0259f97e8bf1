"""Serving engine: batched prefill + greedy / temperature decode, dense or
through VUSA-packed weights (``ServeConfig.packed_weights``).

Port of the one-shot part of the JAX package's ``serve/engine.py``.  The
reference fuses the decode loop into one ``lax.scan``; here the loop runs
on the host, but nothing in it waits for the device: each step's token is
chosen on the device (argmax, or a Gumbel-max draw from an explicit
``torch.Generator`` seeded by ``ServeConfig.seed``) and feeds the next step
directly, the integrity flags (``isfinite`` over the fp32 logits) stay on
the device too, and tokens and flags are fetched once at the end.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..models import build_model
from ..models.common import strict_fp32
from .metrics import tok_per_s

__all__ = ["ServeConfig", "Engine"]


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 256
    temperature: float = 0.0  # 0 => greedy
    seed: int = 0
    # VUSA-packed decode (dense family): False = dense, "mlp" packs the
    # per-layer MLP trio, "all" additionally packs wq/wk/wv/wo and the
    # untied LM head — the whole decode step
    packed_weights: bool | str = False
    fused_mlp: bool = True  # fused-MLP kernel (False = three packed matmuls)
    # packed value precision: "bf16" keeps the params' own float dtype in
    # the pack (no cast); "int8"/"int4" quantize value slots with
    # per-(window, row) fp32 scales, dequantized inside the kernels
    packed_values: str = "bf16"
    vusa_m: int = 128  # window lanes
    vusa_a: int = 16  # physical slots per row per job

    def __post_init__(self):
        if self.packed_weights not in (False, "mlp", "all"):
            raise ValueError(
                f"packed_weights must be False, 'mlp' or 'all', got {self.packed_weights!r}"
            )
        if self.packed_values not in ("bf16", "int8", "int4"):
            raise ValueError(
                f"packed_values must be 'bf16', 'int8' or 'int4', got {self.packed_values!r}"
            )


def _to(tree: dict, device: torch.device) -> dict:
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


class Engine:
    def __init__(
        self, cfg: ArchConfig, params: dict, sc: Optional[ServeConfig] = None,
        device="cuda",
    ):
        """``params``: the reference-layout parameter dict (moved to
        ``device``).  Switches TF32 off process-wide (``strict_fp32``): the
        dense path's fp32 products are true fp32, as in the reference."""
        strict_fp32()
        self.cfg = cfg
        self.sc = ServeConfig() if sc is None else sc
        self.device = torch.device(device)
        self.model = build_model(cfg)
        self.params = _to(params, self.device)
        self._packed = None
        if self.sc.packed_weights:
            from .packed import pack_lm_weights

            self._packed = pack_lm_weights(
                cfg, self.params, self.sc.vusa_m, self.sc.vusa_a,
                scope=self.sc.packed_weights, fused_mlp=self.sc.fused_mlp,
                value_dtype="dense" if self.sc.packed_values == "bf16" else self.sc.packed_values,
            )

    @property
    def packed(self) -> Optional[Dict]:
        return self._packed

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _validate_tokens(self, tokens) -> None:
        """Reject out-of-range token ids before the embedding gather, naming
        the first offending position."""
        toks = np.asarray(tokens)
        bad = (toks < 0) | (toks >= self.cfg.vocab)
        if bad.any():
            idx = tuple(int(x) for x in np.argwhere(bad)[0])
            raise ValueError(
                f"token id {int(toks[idx])} at position {idx} is outside "
                f"[0, vocab={self.cfg.vocab})"
            )

    # -- one step -------------------------------------------------------------
    def _decode_impl(self, token, cache, generator):
        """One decode step through the pack (or dense when none).  Returns
        ``(next_token (B, 1), cache, ok (B,))``; ``ok`` is the per-row
        integrity flag, ``isfinite`` over the fp32 logits, left on device."""
        if self._packed is not None:
            from .packed import lm_decode_step_packed

            logits, cache = lm_decode_step_packed(self.params, self._packed, token, cache, self.cfg)
        else:
            logits, cache = self.model.decode_step(self.params, token, cache)
        logits = logits[:, -1].float()
        ok = torch.isfinite(logits).all(dim=-1)
        if self.sc.temperature > 0:
            # Gumbel-max: argmax(logits / T + Gumbel noise) is a categorical
            # draw; the noise comes from the engine's seeded generator
            u = torch.rand(logits.shape, generator=generator, device=logits.device)
            nxt = torch.argmax(logits / self.sc.temperature - torch.log(-torch.log(u)), dim=-1)
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt[:, None], cache, ok

    # -- reusable entry points ------------------------------------------------
    @torch.no_grad()
    def prime(self, prompts):
        """Prefill ``prompts`` (B, S) and bulk-fill the KV cache.  Returns
        ``(first_token (B, 1), cache)``; the first token is the prefill
        logits' argmax, as in the reference."""
        prompts = np.asarray(prompts)
        if prompts.shape[1] > self.sc.max_len:
            raise ValueError(f"prompt length {prompts.shape[1]} exceeds max_len {self.sc.max_len}")
        self._validate_tokens(prompts)
        tokens = torch.as_tensor(prompts, dtype=torch.long, device=self.device)
        logits, cache = self.model.prefill(self.params, {"tokens": tokens}, self.sc.max_len)
        return torch.argmax(logits.float(), dim=-1)[:, None], cache

    @torch.no_grad()
    def decode_segment(self, token, cache, steps: int, generator=None):
        """``steps`` decode steps with no host sync.  Returns ``(tokens (B,
        steps), ok (B, steps), last_token, cache)``, all on the device."""
        toks, oks = [], []
        for _ in range(steps):
            token, cache, ok = self._decode_impl(token, cache, generator)
            toks.append(token[:, 0])
            oks.append(ok)
        b = token.shape[0]
        if not toks:
            empty = torch.empty((b, 0), dtype=torch.long, device=self.device)
            return empty, empty.bool(), token, cache
        return torch.stack(toks, dim=1), torch.stack(oks, dim=1), token, cache

    # -- public API -----------------------------------------------------------
    def generate(self, prompts, max_new: int = 32) -> Dict:
        """prompts: (B, S) int.  Returns ``{"tokens" (B, max_new) int32,
        "finite", "prefill_s", "decode_s", "tok_per_s"}``; ``tok_per_s`` is
        the decoded tokens beyond the first over decode wall time."""
        prompts = np.asarray(prompts)
        b = prompts.shape[0]
        if prompts.shape[1] + max_new > self.sc.max_len:
            # decode past max_len would index past the KV cache
            raise ValueError(
                f"prompt({prompts.shape[1]}) + max_new({max_new}) = "
                f"{prompts.shape[1] + max_new} exceeds max_len {self.sc.max_len}"
            )
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.sc.seed)
        t0 = time.monotonic()
        nxt, cache = self.prime(prompts)
        self._sync()
        t_prefill = time.monotonic() - t0

        t0 = time.monotonic()
        toks, okg, _, cache = self.decode_segment(nxt, cache, max_new - 1, gen)
        tokens = torch.cat([nxt, toks], dim=1).cpu().numpy().astype(np.int32)  # the one fetch
        finite = bool(okg.all())
        t_decode = time.monotonic() - t0
        return {
            "tokens": tokens,
            "finite": finite,
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "tok_per_s": tok_per_s(b * (max_new - 1), t_decode),
        }
