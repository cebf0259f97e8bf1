"""Decoder-only dense LM: specs, forward, prefill and decode (one token, or
s tokens for the speculative verify).

Port of the dense-LM part of the JAX package's ``models/families.py``.  The
parameter layout is the reference's: every layer parameter carries a
leading ``(L, ...)`` layer axis, so a parameter tree exported from the
reference loads as it is.  The reference scans the layer axis with
``lax.scan``; here a Python loop indexes it.
"""

from __future__ import annotations

import torch

from .common import ParamSpec, rms_norm
from .layers import MaskSpec, attention, attention_decode, attention_specs, mlp, mlp_specs

__all__ = [
    "lm_specs", "lm_forward", "lm_cache_specs", "lm_init_cache", "lm_decode_step",
    "lm_prefill", "act_dtype", "layer_params",
]


def act_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _stack_specs(tree: dict, n: int) -> dict:
    """Add a leading `layers` axis of size n to every ParamSpec leaf."""
    return {
        k: _stack_specs(v, n) if isinstance(v, dict)
        else ParamSpec((n,) + v.shape, v.init, v.scale)
        for k, v in tree.items()
    }


def layer_params(tree: dict, i: int) -> dict:
    """Layer ``i``'s slice of a layer-stacked parameter tree (views)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _head(params, cfg) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def lm_specs(cfg) -> dict:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md A13); the port serves 'dense'"
        )
    d, v = cfg.d_model, cfg.padded_vocab
    layer = {
        "norm1": ParamSpec((d,), init="zeros"),
        "attn": attention_specs(cfg),
        "norm2": ParamSpec((d,), init="zeros"),
        "ffn": mlp_specs(cfg),
    }
    specs = {
        "embed": ParamSpec((v, d), scale=1.0),
        "layers": _stack_specs(layer, cfg.n_layers),
        "final_norm": ParamSpec((d,), init="zeros"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, v))
    return specs


def _embed_tokens(params, tokens, cfg):
    return params["embed"][tokens].to(act_dtype(cfg))


def lm_forward(params, batch, cfg):
    """Teacher-forced logits (B, S, V) and the (zero) aux loss."""
    tokens = batch["tokens"]
    x = _embed_tokens(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    mask = MaskSpec("causal")
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        x = x + attention(lp["attn"], rms_norm(x, lp["norm1"]), cfg, mask, positions)
        x = x + mlp(lp["ffn"], rms_norm(x, lp["norm2"]))
    x = rms_norm(x, params["final_norm"])
    logits = torch.einsum("bsd,dv->bsv", x, _head(params, cfg).to(x.dtype))
    return logits, 0.0


# ---- decode ----------------------------------------------------------------


def lm_cache_specs(cfg, batch: int, max_len: int) -> dict:
    """Shapes and dtypes of the decode cache's K/V; ``pos`` is a 0-d
    ``torch.long`` tensor beside them (``lm_init_cache``)."""
    kv = ((cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.hd), act_dtype(cfg))
    return {"k": kv, "v": kv}


def lm_init_cache(cfg, batch: int, max_len: int, device) -> dict:
    cache = {
        name: torch.zeros(shape, dtype=dtype, device=device)
        for name, (shape, dtype) in lm_cache_specs(cfg, batch, max_len).items()
    }
    cache["pos"] = torch.zeros((), dtype=torch.long, device=device)
    return cache


def lm_decode_step(params, token, cache, cfg):
    """token: (B, s) int (s = 1 normal decode; s > 1 the speculative
    verify).  Returns (logits (B, s, V), cache with ``pos + s``).

    The cache is updated in place: K/V rows (see ``attention_decode``) and
    the device scalar ``pos``, which is advanced, never rebound, so a CUDA
    graph that replays the step keeps reading the same tensor.  With
    ``s > 1`` the step runs as a chain of ``s`` exact single-token steps: a
    ``torch.matmul`` over s rows is not bitwise the s one-row products
    (the GEMM's order of operations changes with the row count), while the
    chain is bitwise the sequential steps by construction, as in the
    reference."""
    if token.shape[1] > 1:
        logits = []
        for i in range(token.shape[1]):
            lg, cache = lm_decode_step(params, token[:, i : i + 1], cache, cfg)
            logits.append(lg)
        return torch.cat(logits, dim=1), cache
    x = _embed_tokens(params, token, cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        x = x + attention_decode(
            lp["attn"], rms_norm(x, lp["norm1"]), cfg,
            {"k": cache["k"][i], "v": cache["v"][i], "pos": cache["pos"]},
        )
        x = x + mlp(lp["ffn"], rms_norm(x, lp["norm2"]))
    x = rms_norm(x, params["final_norm"])
    logits = torch.einsum("bsd,dv->bsv", x, _head(params, cfg).to(x.dtype))
    cache["pos"].add_(1)
    return logits, cache


def lm_prefill(params, batch, cfg, max_len: int, lengths=None):
    """Run the prompt and bulk-write the KV cache.  Returns (logits (B, V) at
    each row's last real token, cache with ``pos`` = padded prompt length,
    a 0-d tensor on the tokens' device).

    ``lengths`` (B,) enables masked prefill of right-padded prompts: padded
    keys get exactly-zero probability and each row's logits are taken at its
    last real token, as in the reference."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len {max_len}")
    cache = lm_init_cache(cfg, b, max_len, tokens.device)
    x = _embed_tokens(params, tokens, cfg)
    positions = torch.arange(s, device=tokens.device)
    kv_valid = None
    if lengths is not None:
        kv_valid = positions[None, :] < lengths[:, None]
    mask = MaskSpec("causal")
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        y, k, v = attention(
            lp["attn"], rms_norm(x, lp["norm1"]), cfg, mask, positions, kv_valid, return_kv=True
        )
        cache["k"][i, :, :s] = k.to(cache["k"].dtype)
        cache["v"][i, :, :s] = v.to(cache["v"].dtype)
        x = x + y
        x = x + mlp(lp["ffn"], rms_norm(x, lp["norm2"]))
    xf = rms_norm(x, params["final_norm"])
    cache["pos"].fill_(s)
    if lengths is None:
        last = xf[:, -1]
    else:  # each row's last real token (bucket padding sits after it)
        last = xf[torch.arange(b, device=xf.device), lengths - 1]
    logits = torch.einsum("bd,dv->bv", last, _head(params, cfg).to(xf.dtype))
    return logits, cache
