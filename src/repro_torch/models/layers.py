"""Transformer layer substrate of the model families: GQA attention
(chunked online softmax for train/prefill, direct attend for decode, a ring
cache under a sliding window) and cross-attention over encoder keys, under
a causal, local, prefix or full mask; the SwiGLU MLP and the top-k MoE.

Port of the JAX package's ``models/layers.py``.  None of these is a
Pallas kernel in the reference, so they are plain torch ops.  The routes
follow the performance flags of ``models/opt_flags.py`` (:data:`FLAGS`,
read at call time), each with the reference's baseline beside it:
decode attends directly in fp32 with ``p / max(l, 1e-30)``, or through
the flash chunks (``decode_direct``); training attention takes the
reference's hand-written backward as an ``autograd.Function`` with its
rounding points, or autograd through the chunked forward
(``flash_custom_vjp``); ``attn_bf16_probs`` (default on) carries the flash
attention's probabilities, and V, in bf16 into the AV product with fp32
accumulation, else fp32 (the reference's model tests pin it off to
compare prefill with decode); the MoE finds each assignment's place in
its expert by a stable sort or a one-hot count (``moe_sort_positions``),
with one dump slot or, under ``moe_shard_capacity``, the reference's
capacity rounded up to 256; prefill and training attention split their
queries over a mesh's ``model`` axis under ``attn_seq_shard``.  Masked
scores are ``-1e30``, not ``-inf``.

Under a tensor-parallel plan (``dist/tp.py``, the serving engine's or the
trainer's, read through ``common.current_tp``) attention runs on this
rank's heads where they split (the config's head counts are the local
ones; the encdec family's cross attention too, its K/V computed on the
local kv heads) with its ``wo`` partials summed over ``model``, and the MLP on
its ff slab with its ``w_down`` partials summed; the inputs of both enter
through ``comm.enter_model``, so a backward sums their gradients over
``model``.  Packed projections are then the rank's own
(``serve/packed.py``, ``split_heads``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from .cache import paged_gather, paged_scatter_rows
from .common import ParamSpec, apply_rope, current_rows, current_tp, per_row, rms_norm, rope
from .opt_flags import FLAGS

__all__ = [
    "attention_specs", "mlp_specs", "moe_specs", "MaskSpec", "attention", "attention_decode",
    "attention_chunk", "cross_attention", "encode_cross_kv", "mlp", "moe", "FLAGS",
]

_NEG_INF = -1e30

# --------------------------------------------------------------------------
# Specs
# --------------------------------------------------------------------------


def attention_specs(cfg) -> dict:
    d, nh, kvh, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd
    specs = {
        "wq": ParamSpec((d, nh, hd), axes=("embed", "heads", None)),
        "wk": ParamSpec((d, kvh, hd), axes=("embed", "kv_heads", None)),
        "wv": ParamSpec((d, kvh, hd), axes=("embed", "kv_heads", None)),
        "wo": ParamSpec((nh, hd, d), axes=("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((nh, hd), init="zeros", axes=("heads", None))
        specs["bk"] = ParamSpec((kvh, hd), init="zeros", axes=("kv_heads", None))
        specs["bv"] = ParamSpec((kvh, hd), init="zeros", axes=("kv_heads", None))
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), init="zeros")
        specs["k_norm"] = ParamSpec((hd,), init="zeros")
    return specs


def mlp_specs(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec((d, f), axes=("embed", "ff")),
        "w_up": ParamSpec((d, f), axes=("embed", "ff")),
        "w_down": ParamSpec((f, d), axes=("ff", "embed")),
    }


def moe_specs(cfg) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((d, e), axes=("embed", None)),
        "w_gate": ParamSpec((e, d, f), axes=("experts", "embed", "ff")),
        "w_up": ParamSpec((e, d, f), axes=("experts", "embed", "ff")),
        "w_down": ParamSpec((e, f, d), axes=("experts", "ff", "embed")),
    }


# --------------------------------------------------------------------------
# Masks
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Declarative attention mask, the reference's four kinds: ``causal``;
    ``local`` (causal, and only keys within ``window`` of the query:
    ``k > q - window``, the hybrid family's sliding window); ``prefix``
    (causal, and the first ``prefix_len`` positions visible to every query:
    the VLM's patch prefix); ``full`` (every key: the encoder and the
    cross-attention)."""

    kind: str = "causal"
    window: int = 0
    prefix_len: int = 0

    def __call__(self, q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
        """(..., Q) x (..., K) int positions -> (..., Q, K) bool allow-mask.
        ``k_pos`` may carry leading batch dims (the ring cache's per-row
        slot positions) that broadcast against ``q_pos``'s."""
        q = q_pos[..., :, None]
        k = k_pos[..., None, :]
        if self.kind == "full":
            return torch.ones(torch.broadcast_shapes(q.shape, k.shape), dtype=torch.bool,
                              device=q_pos.device)
        causal = k <= q
        if self.kind == "causal":
            return causal
        if self.kind == "local":
            return causal & (k > q - self.window)
        if self.kind == "prefix":
            return causal | (k < self.prefix_len)
        raise ValueError(f"unknown mask kind {self.kind!r}")


# --------------------------------------------------------------------------
# Attention cores
# --------------------------------------------------------------------------


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 and widened back: a product of two such tensors
    in fp32 is the reference's bf16 einsum with fp32 accumulation."""
    return x.to(torch.bfloat16).float()


def _probs_operand(x: torch.Tensor) -> torch.Tensor:
    """An operand of the flash attention's probability products: rounded to
    bf16 under ``attn_bf16_probs``, else fp32."""
    return _bf16(x) if FLAGS["attn_bf16_probs"] else x.float()


def _flash_chunks(
    q: torch.Tensor,  # (B, Sq, KVH, G, hd)
    k: torch.Tensor,  # (B, Sk, KVH, hd)
    v: torch.Tensor,  # (B, Sk, KVH, hd)
    mask: MaskSpec,
    q_pos: torch.Tensor,  # (Sq,), or (B, Sq) per row
    k_pos: torch.Tensor,  # (Sk,), or (B, Sk) per row
    kv_valid: Optional[torch.Tensor] = None,  # (Sk,) or (B, Sk) bool
    kv_chunk: int = 512,
):
    """Online-softmax attention over KV chunks.  Returns the fp32 output
    (B, KVH, G, Sq, hd) and the softmax statistics m, l (B, KVH, G, Sq).

    Query rows are independent, so only the KV chunking (512, as the
    reference) shapes the numerics.  P and V enter the AV product rounded to
    bf16 under ``attn_bf16_probs`` (accumulation stays fp32), else in fp32.
    Positions and validity may be per batch row (the decode attend's, under
    ``decode_direct`` off)."""
    b, sq, kvh, g, hd = q.shape
    sk = k.shape[1]
    kv_chunk = min(kv_chunk, sk)
    scale = hd**-0.5
    if kv_valid is None:
        kv_valid = torch.ones((sk,), dtype=torch.bool, device=q.device)
    qf = q.float()
    m = torch.full((b, kvh, g, sq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, g, sq, hd), dtype=torch.float32, device=q.device)
    for k0 in range(0, sk, kv_chunk):
        ki = k[:, k0 : k0 + kv_chunk].float()
        vi = v[:, k0 : k0 + kv_chunk]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, ki) * scale
        # (Q, K), or (B, Q, K) when anything is per row
        allow = mask(q_pos, k_pos[..., k0 : k0 + kv_chunk])
        allow = allow & kv_valid[..., None, k0 : k0 + kv_chunk]
        s = s.masked_fill(~(allow[:, None, None] if allow.ndim == 3 else allow), _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        av = torch.einsum("bhgqk,bkhd->bhgqd", _probs_operand(p), _probs_operand(vi))
        acc = acc * corr[..., None] + av
        m = m_new
    return acc / torch.clamp_min(l, 1e-30)[..., None], m, l


def _flash_attend(q, k, v, mask, q_pos, k_pos, kv_valid=None, kv_chunk: int = 512):
    """:func:`_flash_chunks`' output as (B, Sq, KVH, G, hd) in ``q.dtype``:
    the prefill attend (no backward)."""
    out = _flash_chunks(q, k, v, mask, q_pos, k_pos, kv_valid, kv_chunk)[0]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


class _FlashAttention(torch.autograd.Function):
    """Flash attention for training under ``mask`` (causal, or the VLM's
    prefix), with the reference's hand-written VJP (``models/layers.py``
    ``_make_flash_vjp(mask, ...)``).

    The forward saves only (q, k, v, out, m, l) and the positions and
    validity; the backward recomputes the scores chunk by chunk, the
    flash-attention-2 derivation.  P, dS, dO, Q and K enter the backward's
    products rounded to bf16 with fp32 accumulation under
    ``attn_bf16_probs`` (else fp32), at the reference's rounding points:
    torch autograd through :func:`_flash_chunks` rounds elsewhere, and its
    gradients then part from the reference's by 3e-3 of the largest or
    more.  q (B, Sq, KVH, G, hd), k and v (B, Sk, KVH, hd), ``q_pos``
    (Sq,), ``k_pos`` (Sk,) and ``valid`` (Sk,) bool, with Sq a multiple of
    ``q_chunk`` and Sk of ``k_chunk``.  Returns the fp32 output (B, Sq,
    KVH, G, hd).
    """

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, valid, q_chunk: int, k_chunk: int,
                mask: MaskSpec):
        out, m, l = _flash_chunks(q, k, v, mask, q_pos, k_pos, valid, k_chunk)
        out = out.permute(0, 3, 1, 2, 4)
        ctx.save_for_backward(q, k, v, out, m, l, q_pos, k_pos, valid)
        ctx.chunks, ctx.mask = (q_chunk, k_chunk), mask
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l, q_pos, k_pos, valid = ctx.saved_tensors
        (cq, ck), mask = ctx.chunks, ctx.mask
        sq, sk, hd = q.shape[1], k.shape[1], q.shape[-1]
        scale = hd**-0.5
        do = dout.float()
        d_stat = torch.einsum("bqhgd,bqhgd->bhgq", do, out)  # D_i = rowsum(dO * O)
        p_div = torch.clamp_min(l, 1e-30)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dks, dvs = [], []
        for k0 in range(0, sk, ck):
            kj, vj = k[:, k0 : k0 + ck].float(), v[:, k0 : k0 + ck].float()
            kb = _probs_operand(kj)
            allow_k = valid[None, k0 : k0 + ck]
            dkj = torch.zeros(kj.shape, dtype=torch.float32, device=q.device)
            dvj = torch.zeros(vj.shape, dtype=torch.float32, device=q.device)
            for q0 in range(0, sq, cq):
                qi, doi = q[:, q0 : q0 + cq].float(), do[:, q0 : q0 + cq]
                s = scale * torch.einsum("bqhgd,bkhd->bhgqk", qi, kj)
                allow = mask(q_pos[q0 : q0 + cq], k_pos[k0 : k0 + ck]) & allow_k
                s = s.masked_fill(~allow, _NEG_INF)
                p = torch.exp(s - m[..., q0 : q0 + cq, None]) / p_div[..., q0 : q0 + cq, None]
                dp = torch.einsum("bqhgd,bkhd->bhgqk", doi, vj)
                dsv = p * (dp - d_stat[..., q0 : q0 + cq, None]) * scale
                pc, dc = _probs_operand(p), _probs_operand(dsv)
                dvj = dvj + torch.einsum("bhgqk,bqhgd->bkhd", pc, _probs_operand(doi))
                dkj = dkj + torch.einsum("bhgqk,bqhgd->bkhd", dc, _probs_operand(qi))
                dq[:, q0 : q0 + cq] += torch.einsum("bhgqk,bkhd->bqhgd", dc, kb)
            dks.append(dkj)
            dvs.append(dvj)
        dk, dv = torch.cat(dks, dim=1), torch.cat(dvs, dim=1)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)) + (None,) * 6


def flash_attention_train(q, k, v, positions, mask: MaskSpec = MaskSpec("causal"),
                          k_positions=None):
    """Training attention through :class:`_FlashAttention`: query chunks of
    ``min(512, Sq)`` and KV chunks of ``min(512, Sk)``, each length padded
    to a multiple of its chunk (padded keys are invalid, padded rows are
    dropped), as the reference's custom-VJP path.  ``k_positions`` (default
    ``positions``): the keys' positions, where the queries are a slice of
    the sequence (the sequence-sharded attention).  Returns (B, Sq, KVH, G,
    hd) in ``q.dtype``."""
    k_positions = positions if k_positions is None else k_positions
    sq, sk = q.shape[1], k.shape[1]
    cq, ck = min(512, sq), min(512, sk)
    pq, pk = (-sq) % cq, (-sk) % ck
    valid = torch.ones((sk + pk,), dtype=torch.bool, device=q.device)
    if pq:
        q = F.pad(q, (0, 0) * (q.ndim - 2) + (0, pq))
        positions = F.pad(positions, (0, pq))
    if pk:
        k, v = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, pk)) for t in (k, v))
        k_positions = F.pad(k_positions, (0, pk))
        valid[sk:] = False
    return _FlashAttention.apply(q, k, v, positions, k_positions, valid, cq, ck,
                                 mask)[:, :sq].to(q.dtype)


def _direct_attend(
    q: torch.Tensor,  # (B, 1, KVH, G, hd) — single decode token
    k: torch.Tensor,  # (B, Sk, KVH, hd)
    v: torch.Tensor,
    mask: MaskSpec,
    q_pos: torch.Tensor,  # (B, 1): each row's own position
    k_pos: torch.Tensor,  # (Sk,)
    kv_valid: torch.Tensor,  # (B, Sk)
    rowwise: bool = False,
) -> torch.Tensor:
    """Unchunked fp32 decode attention, as the reference's ``decode_direct``.
    With ``rowwise`` the two products and the softmax sum run one batch row
    at a time (``per_row``); the max is exact in any order and the rest is
    elementwise, so row b is bitwise the B = 1 attend."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    rows = range(q.shape[0]) if rowwise and q.shape[0] > 1 else None
    if rows is None:
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf)
    else:
        s = torch.cat([torch.einsum("bqhgd,bkhd->bhgqk", qf[j : j + 1], kf[j : j + 1])
                       for j in rows])
    s = s * scale
    allow = mask(q_pos, k_pos) & kv_valid[:, None, :]  # (B, 1, Sk)
    s = s.masked_fill(~allow[:, None, None], _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = per_row(lambda r: r.sum(dim=-1, keepdim=True), p, rowwise)
    p = p / torch.clamp_min(l, 1e-30)
    if rows is None:
        out = torch.einsum("bhgqk,bkhd->bhgqd", p, vf)
    else:
        out = torch.cat([torch.einsum("bhgqk,bkhd->bhgqd", p[j : j + 1], vf[j : j + 1])
                         for j in rows])
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)  # (B, 1, KVH, G, hd)


def _decode_attend(q, k, v, mask, q_pos, k_pos, kv_valid, rowwise: bool = False):
    """The decode attend of one query row a batch row, (B, 1, KVH, G, hd):
    :func:`_direct_attend` under ``decode_direct``, else the reference's
    baseline, the flash chunks over KV chunks of ``min(512, Sk)``, with
    ``rowwise`` one batch row at a time (each row then makes exactly the
    B = 1 call)."""
    if FLAGS["decode_direct"]:
        return _direct_attend(q, k, v, mask, q_pos, k_pos, kv_valid, rowwise)

    def flash(j):
        rows = slice(None) if j is None else slice(j, j + 1)
        kp = k_pos[rows] if k_pos.ndim == 2 else k_pos
        out = _flash_chunks(q[rows], k[rows], v[rows], mask, q_pos[rows], kp, kv_valid[rows],
                            min(512, k.shape[1]))[0]
        return out.permute(0, 3, 1, 2, 4).to(q.dtype)

    if rowwise and q.shape[0] > 1:
        return torch.cat([flash(j) for j in range(q.shape[0])])
    return flash(None)


# --------------------------------------------------------------------------
# Attention apply (train/prefill + decode-with-cache)
# --------------------------------------------------------------------------


def _project_qkv(p, x, cfg, positions, wmm=None, rowwise=False):
    """QKV projection.  ``wmm(name, x) -> x @ W_name`` on the flattened head
    dim optionally overrides the weight matmuls — the hook the VUSA-packed
    decode path (serve/packed.py) uses to run the projections through the
    row-packed kernel while sharing the rope/bias/norm glue.  ``rowwise``
    runs the dense products one batch row at a time (``per_row``); each
    weight is cast to the activation dtype once, not once per row.
    ``positions`` is (S,) shared by every row, or (B, s) per row."""
    b, s, d = x.shape
    nh, kvh, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    if wmm is None:
        q, k, v = (per_row(lambda r, w=p[n].to(x.dtype): torch.einsum("bsd,dnh->bsnh", r, w),
                         x, rowwise) for n in ("wq", "wk", "wv"))
    else:
        q = wmm("wq", x).reshape(b, s, nh, hd).to(x.dtype)
        k = wmm("wk", x).reshape(b, s, kvh, hd).to(x.dtype)
        v = wmm("wv", x).reshape(b, s, kvh, hd).to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)[None, None]
        k = k + p["bk"].to(x.dtype)[None, None]
        v = v + p["bv"].to(x.dtype)[None, None]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], rowwise=rowwise)
        k = rms_norm(k, p["k_norm"], rowwise=rowwise)
    sin, cos = rope(positions, hd, cfg.rope_theta)
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def attention(
    p: dict,
    x: torch.Tensor,  # (B, S, d)
    cfg,
    mask: MaskSpec,
    positions: Optional[torch.Tensor] = None,  # (S,)
    kv_valid: Optional[torch.Tensor] = None,  # (B, S) bool: real keys under bucketed prefill
    return_kv: bool = False,
):
    """Full-sequence self-attention (train / prefill).  With ``return_kv``
    also returns the projected K/V rows, which prefill writes to the cache
    (the reference recomputes them; the values are the same).  When q, k or
    v require grad and there is no ``kv_valid``, it is the training path
    (:func:`_train_attend`).  On a mesh whose ``model`` axis the heads do
    not divide, either path may split the queries over ``model``
    (:func:`_maybe_seq_sharded_attention`); under a tensor-parallel plan
    whose heads split, ``x`` enters the local heads' products through
    ``comm.enter_model``."""
    b, s, _ = x.shape
    nh, kvh, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    if positions is None:
        positions = torch.arange(s, device=x.device)
    plan = current_tp()
    q, k, v = _project_qkv(p, x if plan is None else plan.heads_in(x), cfg, positions)
    q = q.reshape(b, s, kvh, nh // kvh, hd)
    out = None
    if kv_valid is None:
        out = _maybe_seq_sharded_attention(q, k, v, mask, positions)
        if out is None and not return_kv and any(t.requires_grad for t in (q, k, v)):
            out = _train_attend(q, k, v, mask, positions)
    if out is None:
        out = _flash_attend(q, k, v, mask, positions, positions, kv_valid=kv_valid)
    out = out.reshape(b, s, nh, hd)
    y = _heads_out(torch.einsum("bsnh,nhd->bsd", out, p["wo"].to(x.dtype)))
    return (y, k, v) if return_kv else y


def _heads_out(y: torch.Tensor) -> torch.Tensor:
    """The ``wo`` product of the local heads summed over ``model`` under a
    tensor-parallel plan; ``y`` itself on one device."""
    plan = current_tp()
    return y if plan is None else plan.heads_out(y)


def _train_attend(q, k, v, mask: MaskSpec, q_pos, k_pos=None):
    """The training attend of queries ``q`` at ``q_pos`` over keys at
    ``k_pos`` (default ``q_pos``): the reference's custom-VJP flash
    attention (:func:`flash_attention_train`), or with ``flash_custom_vjp``
    off autograd through :func:`_flash_attend` (every chunk's scores kept
    for the backward)."""
    k_pos = q_pos if k_pos is None else k_pos
    if FLAGS["flash_custom_vjp"]:
        return flash_attention_train(q, k, v, q_pos, mask, k_pos)
    return _flash_attend(q, k, v, mask, q_pos, k_pos)


def _maybe_seq_sharded_attention(q, k, v, mask: MaskSpec, positions):
    """Sequence-parallel attention, the reference's
    ``_maybe_seq_sharded_attention``.  When the q-heads and the
    kv-heads do not both divide the mesh's ``model`` axis, head tensor
    parallelism would split heads across ranks.  Instead each model rank
    attends its contiguous slice of the queries against the whole K/V,
    and the slices are all-gathered along the sequence.  Under grad (the
    tensor-parallel training step) q, k and v, whole on every rank, enter
    the split through ``comm.enter_model`` (their gradients, each rank's
    part from its query slice, summed over ``model``), the slice runs the
    training attend (the reference's flash custom VJP) and the slices
    leave through ``comm.gather_model``.  Returns None when it does not
    apply: no mesh, a size-1 ``model`` axis, heads that both divide, a
    sequence the axis does not divide, or the ``attn_seq_shard`` flag off,
    or heads already split over ``model`` by the tensor-parallel plan.
    The reference also needs the batch to divide the data ranks (its
    ``shard_map``'s batch spec); a port rank attends the rows it holds,
    whether the trainer split the batch or not."""
    from ..dist.comm import axis_index, axis_size, enter_model, gather_model
    from .common import current_mesh

    mesh = current_mesh()
    b, s, kvh, g, hd = q.shape
    tp = axis_size(mesh, "model")
    plan = current_tp()
    if (not FLAGS["attn_seq_shard"] or tp == 1 or (kvh * g % tp == 0 and kvh % tp == 0)
            or s % tp != 0 or (plan is not None and plan.heads)):
        return None
    s_loc = s // tp
    r = axis_index(mesh, "model")
    rows = slice(r * s_loc, (r + 1) * s_loc)
    if any(t.requires_grad for t in (q, k, v)):
        q, k, v = enter_model((q, k, v), mesh)
        out = _train_attend(q[:, rows], k, v, mask, positions[rows], positions)
    else:
        out = _flash_attend(q[:, rows], k, v, mask, positions[rows], positions)
    _maybe_seq_sharded_attention.calls += 1
    return gather_model(out, mesh, dim=1)


_maybe_seq_sharded_attention.calls = 0  # times it applied, for tests and the chip phase


def _write_rows(caches, positions: torch.Tensor, rows) -> None:
    """Write each of ``rows`` (B, s, ...) into the matching cache of
    ``caches`` (B, S_max, ...) at each batch row's consecutive slots
    ``positions`` (B, s), in place; rows past ``S_max`` are dropped (the
    reference's ``mode="drop"``), never clamped onto the last slot.  A row
    past the end is sent to its batch row's last slot carrying that slot's
    final value (the first row aimed there, or what the slot holds), so
    every write to one slot carries the same bits and the result does not
    depend on the order the writes land in.  The slot index is computed
    once for all the caches (K and V); each cache is read and written
    through its flat (B * S_max) view with ``index_select`` and
    ``index_copy_``.  All on the device: no host sync."""
    b, s = positions.shape
    s_max, dev = caches[0].shape[1], positions.device
    idx = positions.clamp(max=s_max - 1)
    flat = (torch.arange(0, b * s_max, s_max, device=dev)[:, None] + idx).reshape(-1)
    inside = (positions < s_max).reshape(-1)
    pick = None
    if s > 1:  # row i takes the data of the first row aimed at its slot
        first = torch.minimum(torch.arange(s, device=dev)[None],
                              (s_max - 1 - positions[:, :1]).clamp(min=0))
        pick = (torch.arange(0, b * s, s, device=dev)[:, None] + first).reshape(-1)
    for cache_t, new in zip(caches, rows):
        assert cache_t.is_contiguous(), "the cache is written through its flat view"
        view = cache_t.flatten(0, 1)
        new = new.flatten(0, 1).to(cache_t.dtype)
        src = torch.where(inside.view(-1, *[1] * (new.ndim - 1)), new,
                          view.index_select(0, flat))
        if pick is not None:
            src = src.index_select(0, pick)
        view.index_copy_(0, flat, src)


def attention_decode(
    p: dict,
    x: torch.Tensor,  # (B, s, d)
    cfg,
    cache: dict,  # {"k": (B, S_max, kvh, hd), "v": ..., "pos": (B,) long}, or paged
    wmm=None,  # optional weight-matmul override (see _project_qkv)
    rowwise: bool = False,
    window: int = 0,  # > 0: a ring cache under a local mask of this window
) -> torch.Tensor:
    """Decode ``s`` tokens against a KV cache; returns y (B, s, d).

    ``pos`` is a (B,) ``torch.long`` tensor on the cache's device — the
    number of tokens row b has cached — from which each row's rope
    positions, cache write and validity mask are derived, so rows may sit
    at ragged positions (the scheduler's slots), the step makes no host
    sync and a CUDA graph can replay it at any positions.  The new K/V rows
    are written into the cache tensors *in place* (the reference returns an
    updated copy; in place saves a full cache copy per layer and step);
    ``pos`` itself is the caller's to advance.  Rows past the cache end are
    dropped; the engine's length guard keeps decode short of it.

    The cache may also be *paged*: ``{"k": (n_blocks, page, kvh, hd), "v":
    ..., "table": (B, n_pages) long, "pos": (B,)}``.  All ``s`` new rows are
    written into the arena at the block table's addresses
    (``paged_scatter_rows``) before the table gathers exactly the contiguous
    (B, max_len, ...) view the slot pool holds, so from there on the attend
    is the same computation and the tokens the same bits, for the
    speculative verify's ``s`` rows too.

    With ``s > 1`` (the speculative verify) the ``s`` tokens take positions
    ``pos .. pos+s-1`` and all their K/V rows are written before attending.
    The attend then runs one query row at a time with exactly the
    single-token shapes: row ``i`` sees ``slots <= pos+i``, the sequential
    step's allow set, and the rows written past it get probability exactly
    0, so each row is bitwise the sequential step's.  Bit-parity of the
    surrounding matmuls is the caller's contract: ``wmm`` must be
    row-stable across row counts (the packed kernels are; a ``torch.matmul``
    in general is not, so the dense path chains single-token steps).
    ``rowwise`` runs the dense products and the attend's products and sum
    one batch row at a time, so row b is bitwise a B = 1 step on its cache
    row (the scheduler's pool step).

    With ``window`` > 0 (the hybrid family's local attention, s = 1, a
    contiguous cache) the cache is a ring of ``S_max`` rows, as in the
    reference: row b writes slot ``pos % S_max``, slot i holds absolute
    position ``pos - ((pos - i) % S_max)``, valid when >= 0, and the
    ``local`` mask hides keys ``window`` or more behind the query.  All of
    it is per row.  A ring shorter than the window (``max_len < window``)
    evicts keys the window would still allow: the reference's semantics."""
    b, s, d = x.shape
    nh, kvh, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    positions = cache["pos"][:, None] + torch.arange(s, device=x.device)  # (B, s)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, wmm=wmm, rowwise=rowwise)
    if window > 0:
        if s != 1 or "table" in cache:
            raise NotImplementedError("a ring cache decodes one token at a time, unpaged")
        k_cache, v_cache = cache["k"], cache["v"]
        ring = k_cache.shape[1]
        _write_rows((k_cache, v_cache), positions % ring, (k_new, v_new))
        slots = torch.arange(ring, device=x.device)
        k_pos = positions - (positions - slots) % ring  # (B, ring)
        out = _decode_attend(q.reshape(b, 1, kvh, nh // kvh, hd), k_cache, v_cache,
                             MaskSpec("local", window=window), positions, k_pos, k_pos >= 0,
                             rowwise)
        return _attn_out(p, out.reshape(b, 1, nh, hd), x, wmm, rowwise)
    if "table" in cache:
        table = cache["table"]
        paged_scatter_rows(cache["k"], table, cache["pos"], k_new)
        paged_scatter_rows(cache["v"], table, cache["pos"], v_new)
        k_cache, v_cache = paged_gather(cache["k"], table), paged_gather(cache["v"], table)
    else:
        k_cache, v_cache = cache["k"], cache["v"]
        _write_rows((k_cache, v_cache), positions, (k_new, v_new))
    slots = torch.arange(k_cache.shape[1], device=x.device)
    q = q.reshape(b, s, kvh, nh // kvh, hd)
    rows = [
        _decode_attend(q[:, i : i + 1].contiguous(), k_cache, v_cache, MaskSpec("causal"),
                       positions[:, i : i + 1], slots, slots[None, :] <= positions[:, i : i + 1],
                       rowwise)
        for i in range(s)  # s = draft_k + 1 at most: small
    ]
    out = rows[0] if s == 1 else torch.cat(rows, dim=1)
    return _attn_out(p, out.reshape(b, s, nh, hd), x, wmm, rowwise)


def _attn_out(p, out, x, wmm=None, rowwise=False):
    """The output projection of the attend's (B, s, nh, hd) heads (this
    rank's under a tensor-parallel plan: ``wo``, dense or packed from its
    heads' rows, row-parallel)."""
    if wmm is None:
        wo = p["wo"].to(x.dtype)
        return _heads_out(per_row(lambda r: torch.einsum("bsnh,nhd->bsd", r, wo), out,
                                  rowwise))
    b, s = out.shape[:2]
    return _heads_out(wmm("wo", out.reshape(b, s, -1))).to(x.dtype)


def attention_chunk(
    p: dict,
    x: torch.Tensor,  # (1, C, d) — one prefill chunk of a single request
    cfg,
    arena_k: torch.Tensor,  # (n_blocks, page, kvh, hd)
    arena_v: torch.Tensor,
    table: torch.Tensor,  # (n_pages,) long — the request's block table
    start: int,  # absolute position of the chunk's first token
    true_len: int,  # real (non-padding) tokens in the chunk
    mask: MaskSpec = MaskSpec("causal"),
):
    """Chunked-prefill attention (Sarathi-style): one chunk of a long prompt
    attends under ``mask`` (causal, as the paged pool serves it) over
    everything already resident in the request's block table plus itself.
    The chunk's K/V are written into the gathered table view by row index
    (rows past ``max_len`` dropped, as ``_write_rows`` does). Returns ``(y,
    k_chunk, v_chunk)``; the caller writes the chunk rows into the arena
    (masking padding and prefix-shared rows)."""
    b, c, d = x.shape
    nh, kvh, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    positions = start + torch.arange(c, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    k_all = paged_gather(arena_k, table[None])
    v_all = paged_gather(arena_v, table[None])
    _write_rows((k_all, v_all), positions[None], (k_new, v_new))
    rows = torch.arange(k_all.shape[1], device=x.device)
    q = q.reshape(b, c, kvh, nh // kvh, hd)
    out = _flash_attend(q, k_all, v_all, mask, positions, rows,
                        kv_valid=rows < start + true_len)
    out = out.reshape(b, c, nh, hd)
    return _heads_out(torch.einsum("bsnh,nhd->bsd", out, p["wo"].to(x.dtype))), k_new, v_new


def cross_attention(
    p: dict,
    x: torch.Tensor,  # (B, Sq, d) decoder states
    enc_kv,  # precomputed (k, v): (B, Sk, kvh, hd) each
    cfg,
) -> torch.Tensor:
    """Attention of decoder states over the encoder's precomputed keys and
    values under the ``full`` mask, through the flash path, as the
    reference computes it at every decode step too: no rope, no bias.
    Under a tensor-parallel plan whose heads split, ``wq`` and ``wo`` are
    this rank's heads and ``enc_kv`` holds its kv heads (``cfg`` is the
    local config): ``x`` enters the column-parallel ``wq`` product through
    ``comm.enter_model`` and ``wo``'s partials leave through the ordered
    sum.  Where the heads do not split it runs whole on every rank: the
    reference's cross attention is never sequence-sharded."""
    b, s, _ = x.shape
    nh, kvh, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    k, v = enc_kv
    plan = current_tp()
    if plan is not None:
        x = plan.heads_in(x)
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"].to(x.dtype)).reshape(b, s, kvh, nh // kvh, hd)
    out = _flash_attend(q, k, v, MaskSpec("full"), torch.arange(s, device=x.device),
                        torch.arange(k.shape[1], device=x.device))
    return _heads_out(torch.einsum("bsnh,nhd->bsd", out.reshape(b, s, nh, hd),
                                   p["wo"].to(x.dtype)))


def encode_cross_kv(p: dict, enc_out: torch.Tensor, cfg):
    """Cross-attention K/V of the encoder's output, computed once a request.
    Under a tensor-parallel plan whose heads split, ``wk`` and ``wv`` are
    this rank's kv heads, so the K/V hold them, and ``enc_out`` enters the
    two column-parallel products through ``comm.enter_model``: under grad
    each rank's part of its gradient is summed over ``model`` (without it
    the encoder's gradient would miss the other ranks' heads)."""
    plan = current_tp()
    if plan is not None:
        enc_out = plan.heads_in(enc_out)
    k = torch.einsum("bsd,dnh->bsnh", enc_out, p["wk"].to(enc_out.dtype))
    v = torch.einsum("bsd,dnh->bsnh", enc_out, p["wv"].to(enc_out.dtype))
    return k, v


# --------------------------------------------------------------------------
# MLP / MoE
# --------------------------------------------------------------------------


def mlp(p: dict, x: torch.Tensor, rowwise: bool = False) -> torch.Tensor:
    """SwiGLU MLP; ``rowwise`` as in ``_project_qkv`` (weights cast once).
    Under a tensor-parallel plan the weights are this rank's ff slab, the
    input enters through ``enter_model`` and the ``w_down`` partials are
    summed over ``model``."""
    wg, wu, wd = (p[n].to(x.dtype) for n in ("w_gate", "w_up", "w_down"))
    plan = current_tp()
    if plan is not None:
        x = plan.ff_in(x)
    y = per_row(lambda r: (F.silu(r @ wg) * (r @ wu)) @ wd, x, rowwise)
    return y if plan is None else plan.ff_out(y)


def _top_k(probs: torch.Tensor, k: int):
    """The k largest of each row and their indices, the lower index first
    among equal values, as ``jax.lax.top_k`` orders them (``torch.topk``
    does not promise an order for ties): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe(p: dict, x: torch.Tensor, cfg, capacity_factor: Optional[float] = None,
        rowwise: bool = False):
    """Top-k MoE with capacity-bounded dispatch (token-dropping), the
    reference's default route.  x (B, S, d); returns (y (B, S, d), the
    Switch load-balance aux loss).

    The router's softmax picks ``top_k`` experts per token (:func:`_top_k`)
    and renormalises their gates.  Over the call's ``t = B * S`` tokens each
    expert takes ``cap = int(cf * t * k / e) + 1`` assignments, in token
    order: an assignment's place in its expert comes from a stable sort of
    the expert ids and ``searchsorted`` of each run's start.  Kept places
    are unique, so the dispatch buffer (e, cap + 1, d) is written by an
    index copy, no float atomics (``moe_sort_positions`` off: the places
    from a one-hot running count, the same integers; ``moe_shard_capacity``
    on: ``cap`` rounded up to a multiple of 256, 256 dump slots, as the
    reference's sharded buffer).  A dropped assignment (place >= cap) gets
    gate 0; the reference piles its token into the dump slot (place cap),
    here the dump slot stays zero, so its expert output is exactly 0 and no
    dropped token's values can reach a kept output.  Capacity couples the
    rows of one call unless ``cf >= e / k`` (dropless).  ``rowwise``: each
    batch row routes and dispatches alone (its own capacity, aux 0), so row
    b is the B = 1 call (the pool step); the experts are cast once.

    Where the caller cut the batch rows over ``data`` (``current_rows``)
    the routing is the whole batch's, as the reference's program over the
    global batch computes it: ``t`` and ``cap`` count every rank's tokens,
    an assignment's place adds the count of its expert's assignments on
    earlier ranks (rows split rank-major), and the aux loss takes the
    whole batch's mean probabilities and counts (``comm.batch_totals``,
    one gather a call).  Each rank still dispatches only its own tokens,
    into a buffer of its own places (at most one slot a token of its own,
    the dump slot after): an expert's output for one slot does not depend
    on the other slots.

    Under a tensor-parallel plan (``dist/tp.py``) whose placements split
    the experts over ``model`` (``TPPlan.experts``) the weights are this
    rank's ``E / tp`` experts: every ``model`` rank holds the same tokens,
    so each computes the same router, top-k, places and drops (over the
    config's whole ``e``); each dispatches to, runs and weighs only its own
    experts, and the ranks' partial outputs are summed over ``model`` in
    rank order (``comm.sum_model``, one collective a call, rowwise too).
    Where the experts stay whole but their ff dim splits (``TPPlan.ff``:
    ``e`` does not divide ``model``) each rank runs every expert on its ff
    slab and the partials are summed alike.  The token rows and the gate
    weights enter the split through one ``comm.enter_model``: the router
    and the aux loss read neither, so their gradients stay complete on
    every rank and are not summed again."""
    plan = current_tp()
    split = plan is not None and (plan.experts or plan.ff)
    cf = cfg.moe_cf if capacity_factor is None else capacity_factor
    b = x.shape[0]
    if rowwise and b > 1:
        p = {k: v if k == "router" else v.to(x.dtype) for k, v in p.items()}  # cast once
        y = torch.cat([_moe_part(p, x[i : i + 1], cfg, cf, plan if split else None, None)[0]
                       for i in range(b)])
        aux = 0.0
    else:  # a row-wise call routes its row alone, whoever split the batch
        y, aux = _moe_part(p, x, cfg, cf, plan if split else None,
                           None if rowwise else current_rows())
    if split:
        from ..dist.comm import sum_model

        y = sum_model(y, plan.mesh)
    return y, aux


def _moe_part(p: dict, x: torch.Tensor, cfg, cf: float, plan, rows):
    """One routed call of :func:`moe` on ``x`` (B, S, d): (y, aux), y this
    rank's partial under a split ``plan`` (None: whole), the routing over
    the whole batch where ``rows`` (``current_rows``) splits it."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k  # the whole e, on every rank
    t = b * s
    xf = x.reshape(t, d)
    probs = torch.softmax(xf.float() @ p["router"].float(), dim=-1)  # (T, E)
    gate_w, eids = _top_k(probs, k)  # (T, k)
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)

    flat_e = eids.reshape(-1)  # (T * k,)
    counts = torch.zeros((e,), dtype=torch.long, device=x.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    before = None
    if rows is None:
        aux = e * torch.sum(probs.mean(0) * (counts.float() / (t * k)))
    else:
        from ..dist.comm import axes_index, batch_totals

        mesh, axes = rows
        total, every = batch_totals(probs.sum(0), counts, mesh, axes)  # (E,), (n, E)
        before = every[: axes_index(mesh, axes)].sum(0)
        t = t * every.shape[0]
        aux = e * torch.sum((total / t) * (every.sum(0).float() / (t * k)))

    cap = int(cf * t * k / e) + 1
    if FLAGS["moe_sort_positions"]:
        order = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        run_start = torch.searchsorted(sorted_e, sorted_e, side="left")
        pos = torch.empty_like(flat_e).index_copy_(
            0, order, torch.arange(flat_e.numel(), device=x.device) - run_start)
    else:  # the baseline: each expert's running count over a (T * k, E) one-hot
        counts_run = torch.cumsum(F.one_hot(flat_e, e), dim=0) - 1
        pos = counts_run.gather(1, flat_e[:, None])[:, 0]
    n_slots = cap + 1
    if FLAGS["moe_shard_capacity"]:  # the reference's capacity for a sharded buffer
        cap = -(-cap // 256) * 256
        n_slots = cap + 256
    dump = cap
    if before is None:
        dropped = pos >= cap
        place = pos
    else:  # the assignments of earlier ranks' rows come first
        place = pos + before[flat_e]
        dropped = place >= cap
        # this rank's kept assignments to an expert are the run of places
        # [before, before + its count) below cap: its buffer holds that run
        # alone, at most one slot a token of its own, and the dump slot after
        dump = min(cap, b * s)
        n_slots = dump + 1
    if moe.trace is not None:
        moe.trace.append({"eids": flat_e.clone(), "pos": place.clone(),
                          "dropped": dropped.clone()})
    pos = torch.where(dropped, dump, pos)  # every dropped assignment aims at the dump slot

    wg, wu, wd = (p[n].to(x.dtype) for n in ("w_gate", "w_up", "w_down"))
    keep, idx = ~dropped, flat_e
    if plan is not None:
        from ..dist.comm import enter_model

        xf, gate_w = enter_model((xf, gate_w), plan.mesh)
        if plan.experts:  # this rank's experts; the others' assignments aim at a dump slot
            lo = plan.rank * wg.shape[0]
            mine = (flat_e >= lo) & (flat_e < lo + wg.shape[0])
            keep = keep & mine
            idx = torch.where(mine, flat_e - lo, 0)
            pos = torch.where(mine, pos, dump)
    xk = torch.where(keep[:, None], xf.repeat_interleave(k, dim=0), 0)  # (T * k, d)
    buf = torch.zeros((wg.shape[0], n_slots, d), dtype=x.dtype, device=x.device).index_put(
        (idx, pos), xk)  # the dump slot's writes are all zeros
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, wg)) * torch.einsum("ecd,edf->ecf", buf, wu)
    out = torch.einsum("ecf,efd->ecd", h, wd)  # (experts here, n_slots, d)

    w = torch.where(keep, gate_w.reshape(-1), 0.0).to(x.dtype)
    y = (out[idx, pos] * w[:, None]).reshape(b * s, k, d).sum(dim=1)
    return y.reshape(b, s, d), aux


# set to a list, every routed call appends its integers: each assignment's
# expert ("eids", (T * k,), token-major), its place in the expert over the
# whole batch ("pos") and whether capacity dropped it ("dropped"); for the
# tests and the card's gates
moe.trace = None
