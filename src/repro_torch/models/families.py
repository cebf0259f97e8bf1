"""Decoder-only LM families (dense, moe, vlm): specs, forward, loss,
prefill and decode (one token, or s tokens for the speculative verify).

Port of the decoder-LM part of the JAX package's ``models/families.py``.
The moe family swaps each layer's MLP for the routed experts
(``layers.moe``) and adds their load-balance loss; the vlm family prefixes
the text with projected patch embeddings (``batch["patches"]``, a stub
vision frontend) under a prefix mask, scales the token embeddings by
sqrt(d_model) and returns logits of the text positions only.  The
parameter layout is the reference's: every layer parameter carries a
leading ``(L, ...)`` layer axis, so a parameter tree exported from the
reference loads as it is.  The reference scans the layer axis with
``lax.scan``; here a Python loop indexes it.  The hybrid, ssm and encdec
families are not ported yet (ROADMAP.md A13).
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn
from torch.utils.checkpoint import checkpoint

from .common import ParamSpec, per_row, rms_norm
from .layers import (
    MaskSpec, attention, attention_chunk, attention_decode, attention_specs, mlp, mlp_specs, moe,
    moe_specs,
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


LM_FAMILIES = ("dense", "moe", "vlm")


def check_family(cfg) -> None:
    """Refuse a family the port does not serve yet."""
    if cfg.family not in LM_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md A13); the port serves "
            f"{LM_FAMILIES}"
        )


def lm_specs(cfg) -> dict:
    check_family(cfg)
    d, v = cfg.d_model, cfg.padded_vocab
    layer = {
        "norm1": ParamSpec((d,), init="zeros"),
        "attn": attention_specs(cfg),
        "norm2": ParamSpec((d,), init="zeros"),
        "ffn": moe_specs(cfg) if cfg.family == "moe" else mlp_specs(cfg),
    }
    specs = {
        "embed": ParamSpec((v, d), scale=1.0),
        "layers": _stack_specs(layer, cfg.n_layers),
        "final_norm": ParamSpec((d,), init="zeros"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, v))
    if cfg.family == "vlm":
        specs["patch_proj"] = ParamSpec((d, d))
    return specs


def _embed_tokens(params, tokens, cfg):
    """The token rows of the embedding, times sqrt(d_model) for the vlm
    family (the constant rounded to the activation dtype first, as the
    reference's weakly typed scalar is).  A gather, as indexing is, but its
    backward sums each row's gradients in a fixed order on the card too
    (indexing's backward, ``index_put_`` with accumulation, may not), so a
    training step is deterministic and a resumed run bitwise the
    uninterrupted one."""
    x = Fn.embedding(tokens, params["embed"]).to(act_dtype(cfg))
    if cfg.family == "vlm":
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype).item()
    return x


def _lm_inputs(params, batch, cfg):
    """(x, mask, positions) of a batch: the token embeddings, for the vlm
    family after the projected patch prefix (``batch["patches"]`` (B, P,
    d)) under a prefix mask; else causal."""
    tokens = batch["tokens"]
    x = _embed_tokens(params, tokens, cfg)
    mask = MaskSpec("causal")
    if cfg.family == "vlm":
        patches = batch["patches"].to(x.dtype)
        x = torch.cat([patches @ params["patch_proj"].to(x.dtype), x], dim=1)
        mask = MaskSpec("prefix", prefix_len=cfg.patch_tokens)
    return x, mask, torch.arange(x.shape[1], device=x.device)


def _ffn(p, h, cfg, rowwise: bool = False):
    """A layer's feed-forward on ``h``: (y, aux).  The SwiGLU MLP (aux 0),
    or for the moe family the routed experts and their aux loss; with
    ``rowwise`` the experts route and dispatch each batch row alone (aux
    0), so row b is the B = 1 call, as the reference's pool step, a B = 1
    step mapped over the slots, computes it."""
    if cfg.family != "moe":
        return mlp(p, h, rowwise), 0.0
    if rowwise and h.shape[0] > 1:  # the experts cast once, not once per row
        pc = {k: v if k == "router" else v.to(h.dtype) for k, v in p.items()}
        return per_row(lambda r: moe(pc, r, cfg)[0], h, True), 0.0
    return moe(p, h, cfg)


def _unstack(tree: dict, n: int) -> list:
    """The n per-layer trees of a layer-stacked tree, through ``unbind``:
    its backward stacks the layers' gradients in one op, where indexing
    each layer would add a full-size gradient per layer."""
    parts = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0) for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _lm_layer(lp, x, cfg, mask, positions):
    x = x + attention(lp["attn"], rms_norm(x, lp["norm1"]), cfg, mask, positions)
    y, aux = _ffn(lp["ffn"], rms_norm(x, lp["norm2"]), cfg)
    return x + y, aux


def lm_forward(params, batch, cfg):
    """Teacher-forced logits (B, S, V) of the text positions and the aux
    loss summed over layers (0 but for the moe family).  Under grad with
    ``cfg.remat`` each layer is recomputed in the backward
    (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``."""
    x, mask, positions = _lm_inputs(params, batch, cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = 0.0
    for lp in _unstack(params["layers"], cfg.n_layers):
        if remat:
            x, a = checkpoint(_lm_layer, lp, x, cfg, mask, positions, use_reentrant=False)
        else:
            x, a = _lm_layer(lp, x, cfg, mask, positions)
        aux = aux + a
    x = rms_norm(x, params["final_norm"])
    logits = torch.einsum("bsd,dv->bsv", x, _head(params, cfg).to(x.dtype))
    if cfg.family == "vlm":  # only text positions produce logits
        logits = logits[:, cfg.patch_tokens :]
    return logits, aux


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
    (0 but for the moe family)."""
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
    row (the scheduler's pool step); the cache may then also be paged.  A
    moe layer then routes each row alone (``_ffn``): its expert capacity is
    the B = 1 step's, as in the reference's pool step."""
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
        x = x + _ffn(lp["ffn"], rms_norm(x, lp["norm2"], rowwise=rowwise), cfg, rowwise)[0]
    x = rms_norm(x, params["final_norm"], rowwise=rowwise)
    head = _head(params, cfg).to(x.dtype)
    logits = per_row(lambda r: torch.einsum("bsd,dv->bsv", r, head), x, rowwise)
    cache["pos"].add_(1)
    return logits, cache


def lm_prefill(params, batch, cfg, max_len: int, lengths=None):
    """Run the prompt and bulk-write the KV cache.  Returns (logits (B, V) at
    each row's last real token, cache with every row's ``pos`` = the padded
    prompt length, on the tokens' device; the scheduler's ``write_slots``
    sets each row's true length).  For the vlm family the patch prefix
    (``batch["patches"]``) comes first: its P rows are cached too and
    ``pos`` counts them.

    ``lengths`` (B,) enables masked prefill of right-padded prompts: padded
    keys get exactly-zero probability and each row's logits are taken at its
    last real token, as in the reference."""
    tokens = batch["tokens"]
    b = tokens.shape[0]
    x, mask, positions = _lm_inputs(params, batch, cfg)
    s = x.shape[1]
    if s > max_len:
        raise ValueError(f"prompt length {s} (patch prefix included) exceeds max_len {max_len}")
    cache = lm_init_cache(cfg, b, max_len, tokens.device)
    patch_off = cfg.patch_tokens if cfg.family == "vlm" else 0
    kv_valid = None
    if lengths is not None:
        kv_valid = positions[None, :] < (lengths[:, None] + patch_off)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        y, k, v = attention(
            lp["attn"], rms_norm(x, lp["norm1"]), cfg, mask, positions, kv_valid, return_kv=True
        )
        cache["k"][i, :, :s] = k.to(cache["k"].dtype)
        cache["v"][i, :, :s] = v.to(cache["v"].dtype)
        x = x + y
        x = x + _ffn(lp["ffn"], rms_norm(x, lp["norm2"]), cfg)[0]
    xf = rms_norm(x, params["final_norm"])
    cache["pos"].fill_(s)
    if lengths is None:
        last = xf[:, -1]
    else:  # each row's last real token (bucket padding sits after it)
        last = xf[torch.arange(b, device=xf.device), lengths - 1 + patch_off]
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
        x = x + _ffn(lp["ffn"], rms_norm(x, lp["norm2"]), cfg)[0]
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
