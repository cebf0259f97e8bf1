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
import torch.nn.functional as Fn
from torch.utils.checkpoint import checkpoint

from .common import ParamSpec, per_row, rms_norm
from .layers import (
    MaskSpec, attention, attention_chunk, attention_decode, attention_specs, mlp, mlp_specs,
)

__all__ = [
    "lm_specs", "lm_forward", "lm_cache_specs", "lm_init_cache", "lm_decode_step",
    "lm_prefill", "lm_prefill_chunk", "lm_loss", "act_dtype", "layer_params", "layer_cache",
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
    """The token rows of the embedding.  A gather, as indexing is, but its
    backward sums each row's gradients in a fixed order on the card too
    (indexing's backward, ``index_put_`` with accumulation, may not), so a
    training step is deterministic and a resumed run bitwise the
    uninterrupted one."""
    return Fn.embedding(tokens, params["embed"]).to(act_dtype(cfg))


def _unstack(tree: dict, n: int) -> list:
    """The n per-layer trees of a layer-stacked tree, through ``unbind``:
    its backward stacks the layers' gradients in one op, where indexing
    each layer would add a full-size gradient per layer."""
    parts = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0) for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _lm_layer(lp, x, cfg, mask, positions):
    x = x + attention(lp["attn"], rms_norm(x, lp["norm1"]), cfg, mask, positions)
    return x + mlp(lp["ffn"], rms_norm(x, lp["norm2"]))


def lm_forward(params, batch, cfg):
    """Teacher-forced logits (B, S, V) and the (zero) aux loss.  Under grad
    with ``cfg.remat`` each layer is recomputed in the backward
    (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``."""
    tokens = batch["tokens"]
    x = _embed_tokens(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    mask = MaskSpec("causal")
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in _unstack(params["layers"], cfg.n_layers):
        if remat:
            x = checkpoint(_lm_layer, lp, x, cfg, mask, positions, use_reentrant=False)
        else:
            x = _lm_layer(lp, x, cfg, mask, positions)
    x = rms_norm(x, params["final_norm"])
    logits = torch.einsum("bsd,dv->bsv", x, _head(params, cfg).to(x.dtype))
    return logits, 0.0


def _xent(logits: torch.Tensor, labels: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mean next-token cross-entropy in the reference's logsumexp form
    (``xent_lse``): an fp32 logsumexp over the logits, minus the label's
    logit picked in model dtype and then widened; ids >= vocab (padding)
    are masked."""
    mask = (labels >= 0) & (labels < vocab)
    labels = labels.clamp(0, vocab - 1).long()
    lse = torch.logsumexp(logits.float(), dim=-1)
    picked = logits.gather(-1, labels[..., None])[..., 0]
    ll = picked.float() - lse
    return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1)


def lm_loss(params, batch, cfg):
    """Next-token loss over the shifted tokens plus 0.01 x the aux loss
    (0 for the dense family)."""
    logits, aux = lm_forward(params, batch, cfg)
    return _xent(logits[:, :-1], batch["tokens"][:, 1:], cfg.vocab) + 0.01 * aux


# ---- decode ----------------------------------------------------------------


def lm_cache_specs(cfg, batch: int, max_len: int) -> dict:
    """``{name: (shape, dtype)}`` of the decode cache: K/V of every layer,
    and ``pos``, a (batch,) ``torch.long`` tensor, one position per row."""
    kv = ((cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.hd), act_dtype(cfg))
    return {"k": kv, "v": kv, "pos": ((batch,), torch.long)}


def lm_init_cache(cfg, batch: int, max_len: int, device) -> dict:
    return {
        name: torch.zeros(shape, dtype=dtype, device=device)
        for name, (shape, dtype) in lm_cache_specs(cfg, batch, max_len).items()
    }


def layer_cache(cache: dict, i: int) -> dict:
    """Layer ``i``'s view of a decode cache: ``{"k", "v", "pos"}`` of a
    contiguous cache, plus ``"table"`` when the K/V are a paged arena
    (``models/cache.py paged_view``)."""
    out = {"k": cache["k"][i], "v": cache["v"][i], "pos": cache["pos"]}
    if "table" in cache:
        out["table"] = cache["table"]
    return out


def lm_decode_step(params, token, cache, cfg, rowwise: bool = False):
    """token: (B, s) int (s = 1 normal decode; s > 1 the speculative
    verify).  Returns (logits (B, s, V), cache with ``pos + s``).

    The cache is updated in place: K/V rows (see ``attention_decode``) and
    the (B,) device tensor ``pos``, which is advanced, never rebound, so a
    CUDA graph that replays the step keeps reading the same tensor.  With
    ``s > 1`` the step runs as a chain of ``s`` exact single-token steps: a
    ``torch.matmul`` over s rows is not bitwise the s one-row products
    (the GEMM's order of operations changes with the row count), while the
    chain is bitwise the sequential steps by construction, as in the
    reference.  ``rowwise`` computes every product, norm and attend one
    batch row at a time, so row b is bitwise a B = 1 step on its own cache
    row (the scheduler's pool step); the cache may then also be paged."""
    if token.shape[1] > 1:
        logits = []
        for i in range(token.shape[1]):
            lg, cache = lm_decode_step(params, token[:, i : i + 1], cache, cfg, rowwise)
            logits.append(lg)
        return torch.cat(logits, dim=1), cache
    x = _embed_tokens(params, token, cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        x = x + attention_decode(lp["attn"], rms_norm(x, lp["norm1"], rowwise=rowwise), cfg,
                                 layer_cache(cache, i), rowwise=rowwise)
        x = x + mlp(lp["ffn"], rms_norm(x, lp["norm2"], rowwise=rowwise), rowwise)
    x = rms_norm(x, params["final_norm"], rowwise=rowwise)
    head = _head(params, cfg).to(x.dtype)
    logits = per_row(lambda r: torch.einsum("bsd,dv->bsv", r, head), x, rowwise)
    cache["pos"].add_(1)
    return logits, cache


def lm_prefill(params, batch, cfg, max_len: int, lengths=None):
    """Run the prompt and bulk-write the KV cache.  Returns (logits (B, V) at
    each row's last real token, cache with every row's ``pos`` = the padded
    prompt length, on the tokens' device; the scheduler's ``write_slots``
    sets each row's true length).

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


def lm_prefill_chunk(params, tokens, cfg, arena, table_row, start: int, true_len: int,
                     write_from: int):
    """One chunk of a paged chunked prefill (Sarathi-style).

    ``tokens`` (1, C) is a chunk of a single prompt whose first token sits at
    absolute position ``start``; ``true_len`` counts its real tokens (the
    final chunk is right-padded to C).  Each layer attends the chunk
    causally over everything resident in ``table_row``'s blocks plus itself
    (``attention_chunk``), then the chunk's K/V rows are written into
    ``arena`` (``{"k", "v"}``, each (L, n_blocks, page, kvh, hd)) in place at
    their block-table addresses.  Rows below ``write_from`` are *not*
    written: prefix-shared pages are already resident and stay read-only
    (``write_from = start + true_len`` makes the call a pure re-peek, e.g.
    the first-token logits after a fully matched prefix).

    Returns ``(logits (1, V), arena)``: the logits at the chunk's last real
    token, meaningful on the final chunk only."""
    x = _embed_tokens(params, tokens, cfg)
    c = x.shape[1]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        y, k_c, v_c = attention_chunk(lp["attn"], rms_norm(x, lp["norm1"]), cfg,
                                      arena["k"][i], arena["v"][i], table_row, start, true_len)
        x = x + y
        x = x + mlp(lp["ffn"], rms_norm(x, lp["norm2"]))
        ks.append(k_c[0])
        vs.append(v_c[0])
    page, n_pages = arena["k"].shape[2], table_row.shape[0]
    keep = [j for j in range(min(c, true_len))
            if start + j >= write_from and start + j < n_pages * page]
    if keep:
        rows = torch.tensor(keep, device=x.device)
        dst = table_row[(start + rows) // page] * page + (start + rows) % page
        for name, new in (("k", ks), ("v", vs)):
            a = arena[name]
            a.flatten(1, 2).index_copy_(1, dst, torch.stack(new)[:, rows].to(a.dtype))
    xf = rms_norm(x, params["final_norm"])
    last = xf[:, min(max(true_len, 1), c) - 1]  # (1, d)
    logits = torch.einsum("bd,dv->bv", last, _head(params, cfg).to(xf.dtype))
    return logits, arena
