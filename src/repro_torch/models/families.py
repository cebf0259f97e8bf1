"""The model families: specs, forward, loss, prefill and decode.

Port of the JAX package's ``models/families.py``.  The decoder-only LM
families (dense, moe, vlm) share the ``lm_*`` functions: one token, or s
tokens for the speculative verify.  The moe family swaps each layer's MLP
for the routed experts (``layers.moe``) and adds their load-balance loss;
the vlm family prefixes the text with projected patch embeddings
(``batch["patches"]``, a stub vision frontend) under a prefix mask, scales
the token embeddings by sqrt(d_model) and returns logits of the text
positions only.  The hybrid family (recurrentgemma) interleaves RG-LRU
blocks and local attention on a ring cache (``hybrid_*``), the ssm family
is Mamba-2 (``ssm_*``), and the encdec family (whisper) runs an encoder
over precomputed frame embeddings whose cross-attention keys and values
are computed once a request (``encdec_*``).

The parameter layout is the reference's: every layer parameter carries a
leading ``(L, ...)`` layer axis (the hybrid's a ``groups`` axis, its
``tail`` layers none), so a parameter tree exported from the reference
loads as it is.  The reference scans the layer axis with ``lax.scan``;
here a Python loop indexes it.  Decode caches are flat ``{name: tensor}``
dicts (``models/cache.py``); the hybrid's nested cache is flattened under
``/``-joined path names (``groups/p0_rglru/conv``, ``tail/t0_rglru/h``),
one per reference leaf.  Every decode step updates its cache in place and
advances the (B,) ``pos`` with ``add_``, makes no host sync, and with
``rowwise`` computes row b as a B = 1 step on its own cache row.

The LM families' serving functions (``lm_decode_step``, ``lm_prefill``,
``lm_prefill_chunk``), the recurrent families' (``hybrid_decode_step``,
``ssm_decode_step``, their forwards without grad) and the encdec family's
(``encdec_prefill``, ``encdec_decode_step``) also run tensor-parallel
under the serving engine's plan (``dist/tp.py``, installed by
``common.mesh_context``): the parameters are this rank's shards, each
layer's leaves gathered over ``data`` at use (``_dense_layer``,
``_plan_layer``; the encoder's and the decoder's stacks apart), the
embedding and the head vocab-parallel (``_embed_tokens``,
``_head_logits``, ``_logits``), the Mamba-2 and RG-LRU mixers on the
rank's heads or channels (``models/ssm.py``), their caches holding those
(``ssm_cache_specs``, ``hybrid_cache_specs`` with the plan; the encdec
self and cross K/V the local kv heads).  With no plan they are the
single-device program.  ``lm_forward``, ``hybrid_forward``,
``ssm_forward``, ``encdec_forward`` and their losses run under the
trainer's plan (``dist.tp.training_plan``) forward and backward on this
rank's shards, the loss vocab-parallel (``TPPlan.xent``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as Fn
from torch.utils.checkpoint import checkpoint

from .cache import batch_axes, slot_view
from .common import ParamSpec, current_context, current_tp, mesh_context, per_row, rms_norm
from .layers import (
    MaskSpec, attention, attention_chunk, attention_decode, attention_specs, cross_attention,
    encode_cross_kv, mlp, mlp_specs, moe, moe_specs,
)
from .opt_flags import FLAGS
from .ssm import mamba2_block, mamba2_decode, mamba2_specs, rglru_block, rglru_decode, rglru_specs

__all__ = [
    "FAMILIES", "LM_FAMILIES", "RECURRENT_FAMILIES", "check_family",
    "lm_specs", "lm_forward", "lm_cache_specs", "init_cache", "lm_decode_step",
    "lm_prefill", "lm_prefill_chunk", "lm_loss", "act_dtype", "layer_params", "layer_cache",
    "hybrid_specs", "hybrid_forward", "hybrid_loss", "hybrid_cache_specs",
    "hybrid_decode_step", "ssm_specs", "ssm_forward", "ssm_loss", "ssm_cache_specs",
    "ssm_decode_step", "encdec_specs", "encdec_encode", "encdec_forward", "encdec_loss",
    "encdec_cache_specs", "encdec_decode_step", "encdec_prefill",
]


def act_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _stack_specs(tree: dict, n: int) -> dict:
    """Add a leading `layers` axis of size n to every ParamSpec leaf."""
    return {
        k: _stack_specs(v, n) if isinstance(v, dict)
        else ParamSpec((n,) + v.shape, v.init, v.scale, (None,) + v.axes)
        for k, v in tree.items()
    }


def layer_params(tree: dict, i: int) -> dict:
    """Layer ``i``'s slice of a layer-stacked parameter tree (views)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _head(params, cfg) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


LM_FAMILIES = ("dense", "moe", "vlm")
RECURRENT_FAMILIES = ("hybrid", "ssm")  # prompts primed through decode steps, no prefill
FAMILIES = LM_FAMILIES + RECURRENT_FAMILIES + ("encdec",)


def check_family(cfg) -> None:
    """Refuse a family that is none of the reference's."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is none of the port's families {FAMILIES} "
            "(ROADMAP.md A13 lists them)"
        )


def lm_specs(cfg) -> dict:
    d, v = cfg.d_model, cfg.padded_vocab
    layer = {
        "norm1": ParamSpec((d,), init="zeros", axes=("embed",)),
        "attn": attention_specs(cfg),
        "norm2": ParamSpec((d,), init="zeros", axes=("embed",)),
        "ffn": moe_specs(cfg) if cfg.family == "moe" else mlp_specs(cfg),
    }
    specs = {
        "embed": ParamSpec((v, d), scale=1.0, axes=("vocab", "embed")),
        "layers": _stack_specs(layer, cfg.n_layers),
        "final_norm": ParamSpec((d,), init="zeros", axes=("embed",)),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, v), axes=("embed", "vocab"))
    if cfg.family == "vlm":
        specs["patch_proj"] = ParamSpec((d, d), axes=("embed", "embed2"))
    return specs


def _embed_tokens(params, tokens, cfg):
    """The token rows of the embedding, times sqrt(d_model) for the vlm
    family (the constant rounded to the activation dtype first, as the
    reference's weakly typed scalar is).  A gather, as indexing is, but its
    backward sums each row's gradients in a fixed order on the card too
    (indexing's backward, ``index_put_`` with accumulation, may not), so a
    training step is deterministic and a resumed run bitwise the
    uninterrupted one.  Under a tensor-parallel plan the rows come from the
    vocab-parallel lookup (``dist.tp.TPPlan.embed``), then the same scale."""
    plan = current_tp()
    if plan is not None:  # the rows are exact: one nonzero addend each
        x = plan.embed(params, tokens).to(act_dtype(cfg))
    else:
        x = Fn.embedding(tokens, params["embed"]).to(act_dtype(cfg))
    if cfg.family == "vlm":
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype).item()
    return x


def _lm_inputs(params, batch, cfg):
    """(x, mask, positions) of a batch: the token embeddings, for the vlm
    family after the projected patch prefix (``batch["patches"]`` (B, P,
    d)) under a prefix mask; else causal.  Under a plan ``patch_proj``, (d,
    d) on ``embed``, is gathered whole over ``data`` where it is stored
    there (``TPPlan.whole_data``): it stays whole over ``model``."""
    tokens = batch["tokens"]
    x = _embed_tokens(params, tokens, cfg)
    mask = MaskSpec("causal")
    if cfg.family == "vlm":
        patches = batch["patches"].to(x.dtype)
        proj, plan = params["patch_proj"], current_tp()
        if plan is not None:
            proj = plan.whole_data(proj, "patch_proj")
        x = torch.cat([patches @ proj.to(x.dtype), x], dim=1)
        mask = MaskSpec("prefix", prefix_len=cfg.patch_tokens)
    return x, mask, torch.arange(x.shape[1], device=x.device)


def _ffn(p, h, cfg, rowwise: bool = False):
    """A layer's feed-forward on ``h``: (y, aux).  The SwiGLU MLP (aux 0),
    or for the moe family the routed experts and their aux loss; with
    ``rowwise`` the experts route and dispatch each batch row alone (aux
    0), so row b is the B = 1 call, as the reference's pool step, a B = 1
    step mapped over the slots, computes it (``layers.moe``)."""
    if cfg.family != "moe":
        return mlp(p, h, rowwise), 0.0
    return moe(p, h, cfg, rowwise=rowwise)


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
    (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``.

    Under the trainer's plan (``dist.tp.training_plan``) ``params`` are
    this rank's shards: the embedding (and the vlm family's
    ``patch_proj``) is gathered over ``data`` where the lookup reads it,
    each layer's leaves inside its call (``_gathered``: under
    ``cfg.remat`` they are dropped after its forward and gathered again in
    its recompute), the final norm and the untied head at the head
    (``TPPlan.top``; a tied head reads the lookup's gathered table), the
    layers run on the local heads and ff slab (``TPPlan.train_params``,
    ``dist.tp.local_config``) and the logits are this rank's vocab columns
    (B, S, V / tp) of the text positions (where the vocabulary splits the
    vlm family's patch rows are dropped before the head), which
    ``lm_loss`` takes to ``TPPlan.xent``."""
    plan = _train_plan()
    lcfg, tied = cfg, None
    remat = cfg.remat and torch.is_grad_enabled()
    layer = _lm_layer
    if plan is not None:
        from ..dist.tp import local_config

        params, lcfg = plan.train_params(params), local_config(cfg, plan)
        tops = plan.top(params, ("embed", "patch_proj"))
        x, mask, positions = _lm_inputs({**params, **tops}, batch, cfg)
        tied = tops["embed"] if cfg.tie_embeddings else None
        del tops
        layer = _gathered(_lm_layer, ("layers",), ("attn",))
    else:
        x, mask, positions = _lm_inputs(params, batch, cfg)
    again = _remat_fn(layer) if remat else layer
    aux = 0.0
    for lp in _unstack(params["layers"], cfg.n_layers):
        if remat:
            x, a = checkpoint(again, lp, x, lcfg, mask, positions, use_reentrant=False)
        else:
            x, a = layer(lp, x, lcfg, mask, positions)
        aux = aux + a
    if plan is not None:
        head = plan.top(params, ("final_norm",) if cfg.tie_embeddings else ("final_norm",
                                                                            "lm_head"))
        if tied is not None:
            head["embed"] = tied
        x = rms_norm(x, head["final_norm"])
        text = cfg.family == "vlm"
        if text and plan.vocab:  # only text positions produce logits
            x = x[:, cfg.patch_tokens :]
        logits = plan.train_logits(x, head, cfg.tie_embeddings)
        if text and not plan.vocab:  # as one device: the head on every position
            logits = logits[:, cfg.patch_tokens :]
        return logits, aux
    x = rms_norm(x, params["final_norm"])
    logits = torch.einsum("bsd,dv->bsv", x, _head(params, cfg).to(x.dtype))
    if cfg.family == "vlm":  # only text positions produce logits
        logits = logits[:, cfg.patch_tokens :]
    return logits, aux


def _xent(logits: torch.Tensor, labels: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mean next-token cross-entropy; ids >= vocab (padding) are masked.
    Under ``xent_lse`` (``opt_flags``) in the logsumexp form: an fp32
    logsumexp over the logits, minus the label's logit picked in model
    dtype and then widened; off, the label's entry of an fp32
    ``log_softmax`` over the vocabulary."""
    mask = (labels >= 0) & (labels < vocab)
    labels = labels.clamp(0, vocab - 1).long()
    if FLAGS["xent_lse"]:
        lse = torch.logsumexp(logits.float(), dim=-1)
        picked = logits.gather(-1, labels[..., None])[..., 0]
        ll = picked.float() - lse
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = logp.gather(-1, labels[..., None])[..., 0]
    return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1)


def lm_loss(params, batch, cfg):
    """Next-token loss over the shifted tokens plus 0.01 x the aux loss
    (0 but for the moe family); under the trainer's tensor-parallel plan
    the vocab-parallel cross-entropy of this rank's logit columns."""
    logits, aux = lm_forward(params, batch, cfg)
    plan = current_tp()
    xent = _xent if plan is None else plan.xent
    return xent(logits[:, :-1], batch["tokens"][:, 1:], cfg.vocab) + 0.01 * aux


# ---- decode ----------------------------------------------------------------


def lm_cache_specs(cfg, batch: int, max_len: int) -> dict:
    """``{name: (shape, dtype)}`` of the decode cache: K/V of every layer,
    and ``pos``, a (batch,) ``torch.long`` tensor, one position per row."""
    kv = ((cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.hd), act_dtype(cfg))
    return {"k": kv, "v": kv, "pos": ((batch,), torch.long)}


def init_cache(specs: dict, device) -> dict:
    """A zero decode cache from ``{name: (shape, dtype)}`` (any family's
    ``*_cache_specs``)."""
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in specs.items()}


def layer_cache(cache: dict, i: int) -> dict:
    """Layer ``i``'s view of a decode cache: ``{"k", "v", "pos"}`` of a
    contiguous cache, plus ``"table"`` when the K/V are a paged arena
    (``models/cache.py paged_view``)."""
    out = {"k": cache["k"][i], "v": cache["v"][i], "pos": cache["pos"]}
    if "table" in cache:
        out["table"] = cache["table"]
    return out


def lm_decode_step(params, token, cache, cfg, rowwise: bool = False, x=None):
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
    the B = 1 step's, as in the reference's pool step.  ``x``: the token's
    embedding rows (B, 1, d) made by the caller (a captured step whose
    embedding makes a collective runs it outside the graph)."""
    if token.shape[1] > 1:
        logits = []
        for i in range(token.shape[1]):
            lg, cache = lm_decode_step(params, token[:, i : i + 1], cache, cfg, rowwise)
            logits.append(lg)
        return torch.cat(logits, dim=1), cache
    if x is None:
        x = _embed_tokens(params, token, cfg)
    for i in range(cfg.n_layers):
        lp = _dense_layer(params, i)
        x = x + attention_decode(lp["attn"], rms_norm(x, lp["norm1"], rowwise=rowwise), cfg,
                                 layer_cache(cache, i), rowwise=rowwise)
        x = x + _ffn(lp["ffn"], rms_norm(x, lp["norm2"], rowwise=rowwise), cfg, rowwise)[0]
        del lp  # under a plan: its gathered leaves
    x = rms_norm(x, params["final_norm"], rowwise=rowwise)
    logits = _head_logits(params, x, cfg, rowwise)
    cache["pos"].add_(1)
    return logits, cache


DENSE_LEAVES = {"attn": ("wq", "wk", "wv", "wo", "bq", "bk", "bv"),
                "ffn": ("router", "w_gate", "w_up", "w_down")}


def _dense_layer(params, i: int, names=None) -> dict:
    """Layer ``i``'s parameters; under a tensor-parallel plan with the leaves
    ``names`` (default: every dense product's) gathered where the compute
    wants them whole (``dist.tp.TPPlan.layer``)."""
    plan = current_tp()
    if plan is None:
        return layer_params(params["layers"], i)
    return plan.layer(params["layers"], i, DENSE_LEAVES if names is None else names)


def _head_logits(params, x, cfg, rowwise: bool = False) -> torch.Tensor:
    """The logits ``x @ head`` (the untied LM head or the tied embedding):
    under a tensor-parallel plan on the local vocab columns, gathered whole
    over ``model`` (``dist.tp.TPPlan.logits``)."""
    plan = current_tp()
    if plan is None:
        head = _head(params, cfg).to(x.dtype)
        eq = "bsd,dv->bsv" if x.ndim == 3 else "bd,dv->bv"
        return per_row(lambda r: torch.einsum(eq, r, head), x, rowwise)
    return plan.logits(x, plan.head_matrix(params, cfg.tie_embeddings).to(x.dtype), rowwise)


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
    cache = init_cache(lm_cache_specs(cfg, b, max_len), tokens.device)
    patch_off = cfg.patch_tokens if cfg.family == "vlm" else 0
    kv_valid = None
    if lengths is not None:
        kv_valid = positions[None, :] < (lengths[:, None] + patch_off)
    for i in range(cfg.n_layers):
        lp = _dense_layer(params, i)
        y, k, v = attention(
            lp["attn"], rms_norm(x, lp["norm1"]), cfg, mask, positions, kv_valid, return_kv=True
        )
        cache["k"][i, :, :s] = k.to(cache["k"].dtype)
        cache["v"][i, :, :s] = v.to(cache["v"].dtype)
        x = x + y
        x = x + _ffn(lp["ffn"], rms_norm(x, lp["norm2"]), cfg)[0]
        del lp  # under a plan: its gathered leaves
    xf = rms_norm(x, params["final_norm"])
    cache["pos"].fill_(s)
    if lengths is None:
        last = xf[:, -1]
    else:  # each row's last real token (bucket padding sits after it)
        last = xf[torch.arange(b, device=xf.device), lengths - 1 + patch_off]
    return _head_logits(params, last, cfg), cache


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
        lp = _dense_layer(params, i)
        y, k_c, v_c = attention_chunk(lp["attn"], rms_norm(x, lp["norm1"]), cfg,
                                      arena["k"][i], arena["v"][i], table_row, start, true_len)
        x = x + y
        x = x + _ffn(lp["ffn"], rms_norm(x, lp["norm2"]), cfg)[0]
        ks.append(k_c[0])
        vs.append(v_c[0])
        del lp  # under a plan: its gathered leaves
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
    return _head_logits(params, last, cfg), arena


# ---- shared by the hybrid, ssm and encdec families -------------------------


# Leaves a decode step reads in fp32 (``.float()``, fp32 adds) or gathers
# before its cast: ``_rows`` leaves them as they are.
_FP32_LEAVES = ("A_log", "D", "dt_bias", "lam", "embed")


def _act_weights(tree: dict, dtype: torch.dtype) -> dict:
    """``tree`` with every leaf a step casts to the activation dtype cast
    once; the norms' scales and ``_FP32_LEAVES`` kept."""
    return {k: _act_weights(v, dtype) if isinstance(v, dict)
            else v if k in _FP32_LEAVES or "norm" in k else v.to(dtype)
            for k, v in tree.items()}


def _rows(step, cache_specs, params, token, cache, cfg):
    """``step`` run on each batch row alone against its own cache row, a
    ``slot_view`` at the batch axes of ``cache_specs``: row b is bitwise the
    B = 1 step (the scheduler's pool step).  The weights are cast to the
    activation dtype once for all rows; a step's own cast of them is then
    a no-op, and the cast is elementwise, so the bits are the B = 1 step's."""
    axes = batch_axes(cache_specs(cfg, 1, 1), cache_specs(cfg, 2, 1))
    params = _act_weights(params, act_dtype(cfg))
    logits = [step(params, token[b : b + 1], slot_view(cache, b, axes), cfg)[0]
              for b in range(token.shape[0])]
    return torch.cat(logits), cache


def _in_context(ctx, fn, *args):
    """``fn(*args)`` under ``mesh_context(*ctx)``."""
    with mesh_context(*ctx):
        return fn(*args)


def _remat_fn(fn):
    """``fn`` as a checkpointed layer calls it: under the caller's mesh
    context when one is installed.  A remat recompute runs where autograd
    runs the backward, on the card its device thread, which the caller's
    context (thread-local) does not reach: the layer would recompute
    without the plan, on other shapes, or route its experts over this
    rank's rows alone."""
    ctx = current_context()
    return fn if all(c is None for c in ctx) else functools.partial(_in_context, ctx, fn)


def _train_plan():
    """The trainer's plan of the innermost context, or None."""
    plan = current_tp()
    return plan if plan is not None and plan.train else None


def _gathered(fn, path: tuple, attn: tuple = (), lead: int = 1):
    """``fn(lp, x, *args)`` on a layer ``lp`` of the trainer's shards at
    ``path`` (one layer of the stack there, ``lead`` 1, or the hybrid's
    tail layer, 0) with its leaves gathered where the compute wants them
    whole (``TPPlan.layer``: over ``data``, and ``attn``'s heads over
    ``model`` where they do not split) inside the call, so a recompute
    gathers them again and nothing outside the call holds them."""
    def run(lp, x, *args):
        plan = current_tp()
        pls = plan.placements
        for k in path:
            pls = pls[k]
        return fn(plan.layer(lp, None, None, pls, attn, lead), x, *args)

    return run


def _layers(params: dict, tree_key: str, n: int, remat: bool, fn, x, *args, attn: tuple = ()):
    """``x`` through the ``n`` stacked layers ``params[tree_key]``, each
    ``fn(lp, x, *args)``, recomputed in the backward under ``remat``.  Under
    the trainer's plan each layer's leaves are gathered inside its call
    (``_gathered``; ``attn``: its attention groups), so under ``remat`` they
    are dropped after its forward and gathered again in its recompute."""
    if _train_plan() is not None:
        fn = _gathered(fn, (tree_key,), attn)
    again = _remat_fn(fn) if remat else fn
    for lp in _unstack(params[tree_key], n):
        x = checkpoint(again, lp, x, *args, use_reentrant=False) if remat else fn(lp, x, *args)
    return x


def _serving_plan():
    """The serving engine's plan of the innermost context, or None (no
    plan, or the trainer's, whose step holds its leaves gathered)."""
    plan = current_tp()
    return None if plan is None or plan.train else plan


def _plan_layer(params: dict, path: tuple, i, attn: tuple = (), names=None) -> dict:
    """Layer ``i`` of the stacked layer tree at ``path`` (``i`` None: the
    tree is one layer, the hybrid's tail): under a serving plan with its
    leaves ``names`` (None: every leaf) gathered where the compute wants
    them whole (``TPPlan.layer``; ``attn``: the groups that are attention),
    else the tree's views."""
    tree = params
    for k in path:
        tree = tree[k]
    plan = _serving_plan()
    if plan is None:
        return tree if i is None else layer_params(tree, i)
    pls = plan.placements
    for k in path:
        pls = pls[k]
    return plan.layer(tree, i, names, pls, attn=attn)


def _logits(params, x, head, tied: bool = False, embed=None):
    """The head's logits of the final-normed ``x``: under the trainer's plan
    this rank's vocab columns of the untied ``lm_head`` or, ``tied`` (the
    encdec family's), of ``embed``, the table the lookup gathered
    (``TPPlan.train_logits``; the final norm and the untied head gathered
    over ``data`` here, ``TPPlan.top``), under a serving plan gathered
    whole (``TPPlan.logits``)."""
    plan = current_tp()
    if plan is not None and plan.train:
        top = plan.top(params, ("final_norm",) if tied else ("final_norm", "lm_head"))
        if tied:
            top["embed"] = embed
        return plan.train_logits(rms_norm(x, top["final_norm"]), top, tied=tied)
    x = rms_norm(x, params["final_norm"])
    if plan is not None:
        return plan.logits(x, plan.head_matrix(params, tied=tied).to(x.dtype))
    return torch.einsum("bsd,dv->bsv", x, head.to(x.dtype))


def _mixer_attn(kind: str) -> tuple:
    """The attention groups of a hybrid layer of ``kind``: its ``mixer``
    where it is attention."""
    return ("mixer",) if kind == "attn" else ()


def _rec_xent():
    """The loss of ``_logits``' columns: vocab-parallel under the trainer's
    plan."""
    plan = current_tp()
    return plan.xent if plan is not None and plan.train else _xent


# ---- hybrid (Griffin / recurrentgemma) --------------------------------------


def _hybrid_layer_specs(cfg, kind: str) -> dict:
    d = cfg.d_model
    return {
        "norm1": ParamSpec((d,), init="zeros", axes=("embed",)),
        "mixer": rglru_specs(cfg) if kind == "rglru" else attention_specs(cfg),
        "norm2": ParamSpec((d,), init="zeros", axes=("embed",)),
        "ffn": mlp_specs(cfg),
    }


def _hybrid_layout(cfg):
    """(groups, tail kinds): ``n_layers // len(pattern)`` scanned groups of
    the pattern, then the unstacked tail of the pattern's first kinds."""
    pat = cfg.block_pattern
    n_groups = cfg.n_layers // len(pat)
    reps = -(-cfg.n_layers // len(pat))
    return n_groups, (pat * reps)[n_groups * len(pat) : cfg.n_layers]


def hybrid_specs(cfg) -> dict:
    d, v = cfg.d_model, cfg.padded_vocab
    n_groups, tail = _hybrid_layout(cfg)
    return {
        "embed": ParamSpec((v, d), scale=1.0, axes=("vocab", "embed")),
        "groups": {f"p{i}_{kind}": _stack_specs(_hybrid_layer_specs(cfg, kind), n_groups)
                   for i, kind in enumerate(cfg.block_pattern)},
        "tail": {f"t{i}_{kind}": _hybrid_layer_specs(cfg, kind) for i, kind in enumerate(tail)},
        "final_norm": ParamSpec((d,), init="zeros", axes=("embed",)),
        "lm_head": ParamSpec((d, v), axes=("embed", "vocab")),
    }


def _hybrid_layer(lp, x, kind: str, cfg, positions):
    h = rms_norm(x, lp["norm1"])
    if kind == "rglru":
        y = rglru_block(lp["mixer"], h, cfg)
    else:
        y = attention(lp["mixer"], h, cfg, MaskSpec("local", window=cfg.local_window), positions)
    x = x + y
    return x + mlp(lp["ffn"], rms_norm(x, lp["norm2"]))


def hybrid_forward(params, batch, cfg):
    """Teacher-forced logits (B, S, V) and aux 0.  Under grad with
    ``cfg.remat`` each group's layers are recomputed in the backward (the
    tail's are not, as in the reference).  An empty ``tail`` may be missing
    from the tree (a walk over leaves drops it).  Under the trainer's plan
    each layer's leaves are gathered inside its call (``_gathered``: over
    ``data``, and the attention leaves over ``model`` where the heads do not
    split), the heads local where they split
    (``dist.tp.local_config``), and the logits are this rank's vocab
    columns; under a serving plan (no grad) each layer's leaves are
    gathered at use."""
    plan, lcfg = _train_plan(), cfg
    tops = {}
    if plan is not None:  # a serving caller's cfg is local already
        from ..dist.tp import local_config

        params, lcfg = plan.train_params(params), local_config(cfg, plan)
        tops = plan.top(params, ("embed",))
    x = _embed_tokens({**params, **tops}, batch["tokens"], cfg)
    del tops
    positions = torch.arange(x.shape[1], device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    n_groups, _ = _hybrid_layout(cfg)
    serving = _serving_plan() is not None
    groups = {} if serving else {key: _unstack(tree, n_groups)
                                 for key, tree in params["groups"].items()}
    for g in range(n_groups):
        for i, kind in enumerate(cfg.block_pattern):
            key = f"p{i}_{kind}"
            if serving:
                lp = _plan_layer(params, ("groups", key), g, _mixer_attn(kind))
                x = _hybrid_layer(lp, x, kind, lcfg, positions)
                del lp
                continue
            fn = _hybrid_layer
            if plan is not None:
                fn = _gathered(_hybrid_layer, ("groups", key), _mixer_attn(kind))
            if remat:
                x = checkpoint(_remat_fn(fn), groups[key][g], x, kind, lcfg, positions,
                               use_reentrant=False)
            else:
                x = fn(groups[key][g], x, kind, lcfg, positions)
    for name in params.get("tail", {}):
        kind = name.split("_", 1)[1]
        if plan is None:
            x = _hybrid_layer(_plan_layer(params, ("tail", name), None, _mixer_attn(kind)), x,
                              kind, lcfg, positions)
            continue
        fn = _gathered(_hybrid_layer, ("tail", name), _mixer_attn(kind), lead=0)
        x = fn(params["tail"][name], x, kind, lcfg, positions)
    return _logits(params, x, params["lm_head"]), 0.0


def hybrid_loss(params, batch, cfg):
    logits, _ = hybrid_forward(params, batch, cfg)
    return _rec_xent()(logits[:, :-1], batch["tokens"][:, 1:], cfg.vocab)


def _mixer_cache(cfg, kind: str, lead: tuple, batch: int, ring: int, plan=None) -> dict:
    if kind == "rglru":  # the conv window of the RG-LRU is 3 rows (4 taps), as the reference
        r = cfg.rglru_dim if plan is None else plan.rglru_width(cfg)
        return {"conv": (lead + (batch, 3, r), act_dtype(cfg)),
                "h": (lead + (batch, r), torch.float32)}
    kv = (lead + (batch, ring, cfg.kv_heads, cfg.hd), act_dtype(cfg))
    return {"k": kv, "v": kv}


def hybrid_cache_specs(cfg, batch: int, max_len: int, plan=None) -> dict:
    """Per pattern position a cache stacked over the groups, then the tail's;
    the attention layers keep a ring of ``min(local_window, max_len)`` rows,
    so decode is O(window), not O(sequence).  Flat ``/``-joined names.
    ``plan``: a serving plan, whose RG-LRU caches hold this rank's
    channels (``cfg``, ``local_config``'s, holds its heads)."""
    ring = min(cfg.local_window, max_len)
    n_groups, tail = _hybrid_layout(cfg)
    out = {}
    for i, kind in enumerate(cfg.block_pattern):
        for leaf, spec in _mixer_cache(cfg, kind, (n_groups,), batch, ring, plan).items():
            out[f"groups/p{i}_{kind}/{leaf}"] = spec
    for i, kind in enumerate(tail):
        for leaf, spec in _mixer_cache(cfg, kind, (), batch, ring, plan).items():
            out[f"tail/t{i}_{kind}/{leaf}"] = spec
    out["pos"] = ((batch,), torch.long)
    return out


def _hybrid_decode_layer(lp, x, c: dict, kind: str, cfg, pos):
    h = rms_norm(x, lp["norm1"])
    if kind == "rglru":
        y = rglru_decode(lp["mixer"], h, cfg, c)
    else:
        y = attention_decode(lp["mixer"], h, cfg, {**c, "pos": pos}, window=cfg.local_window)
    x = x + y
    return x + mlp(lp["ffn"], rms_norm(x, lp["norm2"]))


def hybrid_decode_step(params, token, cache, cfg, rowwise: bool = False):
    """token (B, 1).  Returns (logits (B, 1, V), cache with ``pos + 1``).
    Under a serving plan each layer's leaves are gathered at use
    (``_plan_layer``) and the logits gathered whole."""
    if rowwise and token.shape[0] > 1:
        return _rows(hybrid_decode_step, hybrid_cache_specs, params, token, cache, cfg)
    x = _embed_tokens(params, token, cfg)
    pos = cache["pos"]
    n_groups, _ = _hybrid_layout(cfg)

    def leaves(prefix, g=None):
        return {name[len(prefix):]: t if g is None else t[g]
                for name, t in cache.items() if name.startswith(prefix)}

    for g in range(n_groups):
        for i, kind in enumerate(cfg.block_pattern):
            key = f"p{i}_{kind}"
            lp = _plan_layer(params, ("groups", key), g, _mixer_attn(kind))
            x = _hybrid_decode_layer(lp, x, leaves(f"groups/{key}/", g), kind, cfg, pos)
            del lp  # under a plan: its gathered leaves
    for name in params.get("tail", {}):
        kind = name.split("_", 1)[1]
        x = _hybrid_decode_layer(_plan_layer(params, ("tail", name), None, _mixer_attn(kind)),
                                 x, leaves(f"tail/{name}/"), kind, cfg, pos)
    logits = _logits(params, x, params["lm_head"])
    pos.add_(1)
    return logits, cache


# ---- ssm (Mamba-2) ----------------------------------------------------------


def ssm_specs(cfg) -> dict:
    d, v = cfg.d_model, cfg.padded_vocab
    layer = {"norm": ParamSpec((d,), init="zeros", axes=("embed",)), "mixer": mamba2_specs(cfg)}
    return {
        "embed": ParamSpec((v, d), scale=1.0, axes=("vocab", "embed")),
        "layers": _stack_specs(layer, cfg.n_layers),
        "final_norm": ParamSpec((d,), init="zeros", axes=("embed",)),
        "lm_head": ParamSpec((d, v), axes=("embed", "vocab")),
    }


def _ssm_layer(lp, x, cfg):
    return x + mamba2_block(lp["mixer"], rms_norm(x, lp["norm"]), cfg)


def ssm_forward(params, batch, cfg):
    """Teacher-forced logits (B, S, V) and aux 0; under the trainer's plan
    this rank's vocab columns (the embedding gathered over ``data`` for the
    lookup, each layer's leaves inside its call, ``_layers``), under a
    serving plan (no grad) each layer's leaves gathered at use."""
    plan = _train_plan()
    x = _embed_tokens({**params, **(plan.top(params, ("embed",)) if plan else {})},
                      batch["tokens"], cfg)
    if _serving_plan() is not None:
        for i in range(cfg.n_layers):
            x = _ssm_layer(_plan_layer(params, ("layers",), i), x, cfg)
    else:
        remat = cfg.remat and torch.is_grad_enabled()
        x = _layers(params, "layers", cfg.n_layers, remat, _ssm_layer, x, cfg)
    return _logits(params, x, params["lm_head"]), 0.0


def ssm_loss(params, batch, cfg):
    logits, _ = ssm_forward(params, batch, cfg)
    return _rec_xent()(logits[:, :-1], batch["tokens"][:, 1:], cfg.vocab)


def ssm_cache_specs(cfg, batch: int, max_len: int, plan=None) -> dict:
    """The conv window (the rank's ``x`` channels and the whole ``B`` and
    ``C``) and the fp32 SSD state (the rank's heads) of every layer, and
    ``pos``; ``plan``: a serving plan (``TPPlan.ssm_sizes``)."""
    din, h = ((cfg.expand * cfg.d_model, cfg.ssm_heads) if plan is None
              else plan.ssm_sizes(cfg))
    n = cfg.ssm_state
    return {
        "conv": ((cfg.n_layers, batch, cfg.d_conv - 1, din + 2 * n), act_dtype(cfg)),
        "state": ((cfg.n_layers, batch, h, din // h, n), torch.float32),
        "pos": ((batch,), torch.long),
    }


def ssm_decode_step(params, token, cache, cfg, rowwise: bool = False):
    """token (B, 1).  Returns (logits (B, 1, V), cache with ``pos + 1``)."""
    if rowwise and token.shape[0] > 1:
        return _rows(ssm_decode_step, ssm_cache_specs, params, token, cache, cfg)
    x = _embed_tokens(params, token, cfg)
    for i in range(cfg.n_layers):
        lp = _plan_layer(params, ("layers",), i)
        x = x + mamba2_decode(lp["mixer"], rms_norm(x, lp["norm"]), cfg,
                              {"conv": cache["conv"][i], "state": cache["state"][i]})
        del lp  # under a plan: its gathered leaves
    logits = _logits(params, x, params["lm_head"])
    cache["pos"].add_(1)
    return logits, cache


# ---- encdec (whisper) -------------------------------------------------------


def encdec_specs(cfg) -> dict:
    """The head is tied to ``embed`` (whisper's convention)."""
    d, v = cfg.d_model, cfg.padded_vocab
    enc_layer = {
        "norm1": ParamSpec((d,), init="zeros", axes=("embed",)),
        "attn": attention_specs(cfg),
        "norm2": ParamSpec((d,), init="zeros", axes=("embed",)),
        "ffn": mlp_specs(cfg),
    }
    dec_layer = {
        "norm1": ParamSpec((d,), init="zeros", axes=("embed",)),
        "self_attn": attention_specs(cfg),
        "norm_x": ParamSpec((d,), init="zeros", axes=("embed",)),
        "cross_attn": attention_specs(cfg),
        "norm2": ParamSpec((d,), init="zeros", axes=("embed",)),
        "ffn": mlp_specs(cfg),
    }
    return {
        "embed": ParamSpec((v, d), scale=1.0, axes=("vocab", "embed")),
        "enc_pos": ParamSpec((cfg.enc_frames, d), scale=0.02, axes=(None, "embed")),
        "enc_layers": _stack_specs(enc_layer, cfg.enc_layers),
        "enc_norm": ParamSpec((d,), init="zeros", axes=("embed",)),
        "dec_layers": _stack_specs(dec_layer, cfg.n_layers),
        "final_norm": ParamSpec((d,), init="zeros", axes=("embed",)),
    }


def _enc_layer(lp, x, cfg, positions):
    x = x + attention(lp["attn"], rms_norm(x, lp["norm1"]), cfg, MaskSpec("full"), positions)
    return x + mlp(lp["ffn"], rms_norm(x, lp["norm2"]))


_ENC_ATTN, _DEC_ATTN = ("attn",), ("self_attn", "cross_attn")
# the leaves a decode step reads of a decoder layer: not the cross
# attention's wk/wv, whose K/V the prefill cached
_DEC_STEP_LEAVES = {"self_attn": DENSE_LEAVES["attn"], "cross_attn": ("wq", "wo"),
                    "ffn": ("w_gate", "w_up", "w_down")}


def encdec_encode(params, frames, cfg):
    """frames (B, F, d), F <= enc_frames: stub frame embeddings -> the
    encoder's states under full self-attention.  Under a plan (``cfg`` the
    local config) the layers run on this rank's shards: on its heads where
    they split, else whole with the full-mask attention sequence-sharded
    over ``model`` where ``model`` divides F (as the reference's); under a
    serving plan each layer's leaves are gathered at use, and ``enc_pos``,
    ``(None, "embed")``, is gathered over ``data`` where it is stored
    there; under the trainer's plan ``enc_pos`` and ``enc_norm`` are
    gathered where they are read (``TPPlan.top``) and each layer's leaves
    inside its call (``_layers``)."""
    adt = act_dtype(cfg)
    pos, plan = params["enc_pos"], current_tp()
    if plan is not None and plan.train:
        pos = plan.top(params, ("enc_pos",))["enc_pos"]
    elif plan is not None:
        pos = plan.whole_data(pos, "enc_pos")
    x = frames.to(adt) + pos[None, : frames.shape[1]].to(adt)
    positions = torch.arange(x.shape[1], device=x.device)
    if _serving_plan() is not None:
        for i in range(cfg.enc_layers):
            x = _enc_layer(_plan_layer(params, ("enc_layers",), i, _ENC_ATTN), x, cfg, positions)
    else:
        remat = cfg.remat and torch.is_grad_enabled()
        x = _layers(params, "enc_layers", cfg.enc_layers, remat, _enc_layer, x, cfg, positions,
                    attn=_ENC_ATTN)
    norm = params["enc_norm"]
    if plan is not None and plan.train:
        norm = plan.top(params, ("enc_norm",))["enc_norm"]
    return rms_norm(x, norm)


def _dec_layer(lp, x, cfg, positions, enc):
    x = x + attention(lp["self_attn"], rms_norm(x, lp["norm1"]), cfg, MaskSpec("causal"),
                      positions)
    kv = encode_cross_kv(lp["cross_attn"], enc, cfg)
    x = x + cross_attention(lp["cross_attn"], rms_norm(x, lp["norm_x"]), kv, cfg)
    return x + mlp(lp["ffn"], rms_norm(x, lp["norm2"]))


def encdec_forward(params, batch, cfg):
    """batch {"frames": (B, F, d), "tokens": (B, S)} -> logits (B, S, V), 0.
    Under the trainer's plan the encoder and decoder run forward and
    backward on this rank's shards and the logits are its vocab columns of
    the tied head (``TPPlan.train_logits``); under a serving plan (no grad)
    each layer's leaves are gathered at use."""
    plan, lcfg, tops = _train_plan(), cfg, {}
    if plan is not None:  # a serving caller's cfg is local already
        from ..dist.tp import local_config

        params, lcfg = plan.train_params(params), local_config(cfg, plan)
    enc = encdec_encode(params, batch["frames"], lcfg)
    if plan is not None:  # the lookup's and the tied head's table, gathered once
        tops = plan.top(params, ("embed",))
    x = _embed_tokens({**params, **tops}, batch["tokens"], cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    if _serving_plan() is not None:
        for i in range(cfg.n_layers):
            x = _dec_layer(_plan_layer(params, ("dec_layers",), i, _DEC_ATTN), x, lcfg,
                           positions, enc)
    else:
        remat = cfg.remat and torch.is_grad_enabled()
        x = _layers(params, "dec_layers", cfg.n_layers, remat, _dec_layer, x, lcfg, positions,
                    enc, attn=_DEC_ATTN)
    return _logits(params, x, params["embed"].T, tied=True, embed=tops.get("embed")), 0.0


def encdec_loss(params, batch, cfg):
    """Next-token loss; under the trainer's plan the vocab-parallel
    cross-entropy of this rank's logit columns."""
    logits, _ = encdec_forward(params, batch, cfg)
    return _rec_xent()(logits[:, :-1], batch["tokens"][:, 1:], cfg.vocab)


def encdec_cache_specs(cfg, batch: int, max_len: int, frames: int = 0) -> dict:
    """Self-attention K/V, and the cross-attention K/V over the encoder's
    ``frames`` rows (0: ``enc_frames``; the prefill fills them).  Under a
    serving plan ``cfg`` is ``dist.tp.local_config``'s, so both hold this
    rank's kv heads, and ``batch`` is this rank's rows where ``data``
    splits them."""
    kv = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.hd)
    xkv = (cfg.n_layers, batch, frames or cfg.enc_frames, cfg.kv_heads, cfg.hd)
    adt = act_dtype(cfg)
    return {"k": (kv, adt), "v": (kv, adt), "xk": (xkv, adt), "xv": (xkv, adt),
            "pos": ((batch,), torch.long)}


def encdec_decode_step(params, token, cache, cfg, rowwise: bool = False):
    """Decode one token; the cross K/V come from ``encdec_prefill``.  Under
    a serving plan each decoder layer's leaves are gathered at use (not the
    cross attention's ``wk``/``wv``), the attention runs on the local heads
    where they split and the logits of the tied head are gathered whole."""
    if rowwise and token.shape[0] > 1:
        return _rows(encdec_decode_step, encdec_cache_specs, params, token, cache, cfg)
    x = _embed_tokens(params, token, cfg)
    for i in range(cfg.n_layers):
        lp = _plan_layer(params, ("dec_layers",), i, _DEC_ATTN, _DEC_STEP_LEAVES)
        x = x + attention_decode(lp["self_attn"], rms_norm(x, lp["norm1"]), cfg,
                                 layer_cache(cache, i))
        x = x + cross_attention(lp["cross_attn"], rms_norm(x, lp["norm_x"]),
                                (cache["xk"][i], cache["xv"][i]), cfg)
        x = x + mlp(lp["ffn"], rms_norm(x, lp["norm2"]))
        del lp  # under a plan: its gathered leaves
    logits = _logits(params, x, params["embed"].T, tied=True)
    cache["pos"].add_(1)
    return logits, cache


def encdec_prefill(params, batch, cfg, max_len: int):
    """Encode ``batch["frames"]`` (B, F, d) and fill the cross K/V (F rows);
    the prompt tokens are not run, as in the reference: the logits are
    zeros (so the first token is 0) and decode starts at ``pos`` 0
    (ROADMAP C12).  Under a serving plan the encoder runs on this rank's
    shards and each layer's cross K/V hold its kv heads (its ``wk``/``wv``
    gathered over ``data`` at use)."""
    enc = encdec_encode(params, batch["frames"], cfg)
    b, f = enc.shape[:2]
    cache = init_cache(encdec_cache_specs(cfg, b, max_len, f), enc.device)
    for i in range(cfg.n_layers):
        lp = _plan_layer(params, ("dec_layers",), i, _DEC_ATTN, {"cross_attn": ("wk", "wv")})
        xk, xv = encode_cross_kv(lp["cross_attn"], enc, cfg)
        cache["xk"][i] = xk.to(cache["xk"].dtype)
        cache["xv"][i] = xv.to(cache["xv"].dtype)
        del lp
    return torch.zeros((b, cfg.padded_vocab), dtype=act_dtype(cfg), device=enc.device), cache
