"""Attention-free temporal mixers: Mamba-2's SSD and Griffin's RG-LRU.

Port of the JAX package's ``models/ssm.py``; none of it is a Pallas
kernel there, so it runs as plain torch ops.

* Mamba-2 SSD (state-space duality): the chunked matrix form for the
  forward (intra-chunk blocks, chunk states, the recurrence over chunks,
  the last chunk zero-padded) and an O(1)-state decode step.  The scan
  runs in fp32 whatever the activation dtype, with the reference's casts.
* RG-LRU (Griffin / recurrentgemma): the gated linear recurrence
  ``h_t = a_t h_{t-1} + b_t`` through a log-depth doubling scan (the
  reference's ``jax.lax.associative_scan``; torch has none), about
  log2(S) elementwise passes, and its decode step, inside the recurrent
  block (causal conv1d and a GELU gate).

The reference's activations map as: ``jax.nn.gelu`` is the tanh
approximation (``approximate="tanh"`` here), ``jax.nn.softplus`` is
``logaddexp(x, 0)`` (torch's softplus switches to ``x`` above 20).

Decode steps update their cache leaves in place (``conv`` window, ``state``
or ``h``), so a CUDA graph that replays the step keeps reading the same
tensors, and make no host sync.  The conv window shifts through a
temporary: ``win[:, 1:]`` copied onto ``win[:, :-1]`` would overlap.

Under a tensor-parallel plan (``dist/tp.py``, read through
``common.current_tp``) the parameters are this rank's shards under the
reference's rules: ``in_proj``'s concatenated ``z | x | B | C | dt``
columns, the conv's ``x | B | C`` channels, the norm scale and
``out_proj``'s rows split evenly over ``model``, which does not line up
with the heads.  So Mamba-2 takes the column product on its ``in_proj``
slab, gathers the activation's columns and the conv weights whole (one
collective, ``_mamba2_open``), and where ``TPPlan.ssm`` runs the conv and
the SSD on its heads' ``x`` and ``dt`` with the whole ``B`` and ``C``
(its cache holds those), the gated norm over the whole width through an
ordered sum of squares, ``out_proj`` row-parallel (``_mamba2_close``);
where the heads do not divide ``model`` the SSD runs whole on every rank.
The RG-LRU runs on its ``r / tp`` channels: ``w_x`` and ``w_gate_branch``
column-parallel, the conv and the scan per channel, ``w_a`` and ``w_i``
(their rows split, their columns whole) as partial products summed over
``model`` in one ordered sum, then this rank's columns, ``w_out``
row-parallel.  Every whole tensor the ranks go on to use differently, and
every replicated leaf sliced to the rank's heads or channels (``A_log``,
``D``, ``dt_bias``, ``lam``), enters through ``comm.enter_model``, so its
gradient is summed over ``model`` (the gradient traps of
``tests/test_torch_tp_recurrent.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist.comm import enter_model, gather_model_leaves, sum_model
from .common import ParamSpec, current_tp, rms_norm
from .opt_flags import FLAGS

__all__ = ["mamba2_specs", "mamba2_block", "mamba2_decode", "rglru_specs", "rglru_block",
           "rglru_decode"]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along the sequence.  x (B, S, C), w (K, C)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i : i + s] * w[i]
    return out + b


def _conv_step(conv: torch.Tensor, x_new: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """One decode step of the causal conv: the window ``conv`` (B, K-1, C)
    plus the new input (B, C), weighted in the forward's order; shifts the
    window in place (through a temporary) and returns the (B, C) output."""
    k = w.shape[0]
    out = conv[:, 0] * w[0]
    for i in range(1, k - 1):
        out = out + conv[:, i] * w[i]
    out = out + x_new * w[k - 1] + b
    win = torch.cat([conv[:, 1:], x_new[:, None].to(conv.dtype)], dim=1)
    conv.copy_(win)
    return out


# --------------------------------------------------------------------------
# Mamba-2 (SSD)
# --------------------------------------------------------------------------


def mamba2_specs(cfg) -> dict:
    d = cfg.d_model
    din = cfg.expand * d
    n, h = cfg.ssm_state, cfg.ssm_heads
    conv_dim = din + 2 * n
    return {
        # order: z (din) | x (din) | B (n) | C (n) | dt (h)
        "in_proj": ParamSpec((d, 2 * din + 2 * n + h), axes=("embed", "ssm_inner")),
        "conv_w": ParamSpec((cfg.d_conv, conv_dim), scale=0.5, axes=(None, "ssm_inner")),
        "conv_b": ParamSpec((conv_dim,), init="zeros", axes=("ssm_inner",)),
        "A_log": ParamSpec((h,), init="ones"),
        "D": ParamSpec((h,), init="ones"),
        "dt_bias": ParamSpec((h,), init="zeros"),
        "norm": ParamSpec((din,), init="zeros", axes=("ssm_inner",)),
        "out_proj": ParamSpec((din, d), axes=("ssm_inner", "embed")),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise segment sums, ``-inf`` above the diagonal:
    out[..., i, j] = sum_{j < t <= i} x_t."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def _ssd_chunked(x, dt, a, b_mat, c_mat, chunk: int, init_state=None):
    """Chunked SSD scan, in fp32.

    x (B, S, H, P), dt (B, S, H), a (H,) negative, b_mat / c_mat (B, S, N).
    Returns (y (B, S, H, P), final_state (B, H, P, N))."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    xs = x.reshape(bsz, nc, chunk, h, p)
    dts = dt.reshape(bsz, nc, chunk, h)
    bs = b_mat.reshape(bsz, nc, chunk, n)
    cs = c_mat.reshape(bsz, nc, chunk, n)

    da = dts * a  # (B, NC, Q, H)
    da_cum = torch.cumsum(da, dim=2)
    da_total = da_cum[:, :, -1]  # (B, NC, H)

    # intra-chunk (diagonal blocks): Y[i] += sum_{j<=i} (C_i . B_j) L_ij dt_j x_j
    L = torch.exp(_segsum(da.transpose(2, 3)))  # (B, NC, H, Q, Q)
    cb = torch.einsum("bcin,bcjn->bcij", cs, bs)  # (B, NC, Q, Q)
    w = cb[:, :, None] * L
    y_diag = torch.einsum("bchij,bcjhp->bcihp", w, dts[..., None] * xs)

    # chunk states: S_c = sum_j exp(da_total - da_cum_j) dt_j B_j x_j^T
    decay = torch.exp(da_total[:, :, None] - da_cum)  # (B, NC, Q, H)
    states = torch.einsum("bcqn,bcqhp->bchpn", bs, (decay * dts)[..., None] * xs)

    # the recurrence over chunks: each chunk starts from the state before it
    s_prev = (init_state if init_state is not None
              else torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device))
    prev = []
    for c in range(nc):
        prev.append(s_prev)
        s_prev = s_prev * torch.exp(da_total[:, c])[..., None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B, NC, H, P, N)

    # inter-chunk output: Y[i] += C_i . (exp(da_cum_i) * S_prev)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", cs, prev_states) * torch.exp(da_cum)[..., None]
    y = (y_diag + y_off).reshape(bsz, s + pad, h, p)[:, :s]
    return y, s_prev


def _mamba2_split(cfg, zxbcdt):
    din = cfg.expand * cfg.d_model
    n = cfg.ssm_state
    return zxbcdt.split([din, din + 2 * n, zxbcdt.shape[-1] - 2 * din - 2 * n], dim=-1)


def _split_model():
    """The plan of the innermost context where its ``model`` axis splits
    work, else None."""
    plan = current_tp()
    return plan if plan is not None and plan.tp > 1 else None


def _mamba2_open(p: dict, x: torch.Tensor, cfg) -> tuple:
    """The in-projection of ``x`` (..., d) and the mixer's leaves on this
    rank: ``(z, xbc, dt, conv_w, conv_b, A_log, D, dt_bias)``, each of the
    rank's heads (``z`` and the conv's ``x`` channels, then the whole ``B``
    and ``C``) under a plan whose heads split, else whole.  A split
    ``in_proj`` (its input entered) and split conv weights are gathered
    whole over ``model`` in one collective; where the heads split every
    whole tensor and the replicated ``A_log``, ``D`` and ``dt_bias`` enter
    before this rank slices them."""
    w, cw, cb = (p[k].to(x.dtype) for k in ("in_proj", "conv_w", "conv_b"))
    plan = _split_model()
    if plan is None:
        z, xbc, dt = _mamba2_split(cfg, x @ w)
        return z, xbc, dt, cw, cb, p["A_log"], p["D"], p["dt_bias"]
    din, n, h = cfg.expand * cfg.d_model, cfg.ssm_state, cfg.ssm_heads
    split_in, split_conv = w.shape[-1] != 2 * din + 2 * n + h, cw.shape[-1] != din + 2 * n
    y = (enter_model(x, plan.mesh) if split_in else x) @ w
    parts = [t for t, split in ((y, split_in), (cw, split_conv), (cb, split_conv)) if split]
    whole = iter(gather_model_leaves(parts, [t.ndim - 1 for t in parts], plan.mesh))
    y = next(whole) if split_in else y
    cw, cb = (next(whole), next(whole)) if split_conv else (cw, cb)
    if not plan.ssm:
        z, xbc, dt = _mamba2_split(cfg, y)
        return z, xbc, dt, cw, cb, p["A_log"], p["D"], p["dt_bias"]
    y, cw, cb, a_log, d_skip, dt_bias = enter_model(
        (y, cw, cb, p["A_log"], p["D"], p["dt_bias"]), plan.mesh)
    (dl, hl), r = plan.ssm_sizes(cfg), plan.rank
    z = y[..., r * dl:(r + 1) * dl]
    xbc = torch.cat([y[..., din + r * dl:din + (r + 1) * dl], y[..., 2 * din:2 * din + 2 * n]],
                    dim=-1)
    dt = y[..., 2 * din + 2 * n + r * hl:2 * din + 2 * n + (r + 1) * hl]
    cw = torch.cat([cw[:, r * dl:(r + 1) * dl], cw[:, din:]], dim=1)
    cb = torch.cat([cb[r * dl:(r + 1) * dl], cb[din:]])
    heads = slice(r * hl, (r + 1) * hl)
    return z, xbc, dt, cw, cb, a_log[heads], d_skip[heads], dt_bias[heads]


def _local_cols(t: torch.Tensor, din: int, plan) -> torch.Tensor:
    """``t`` (..., din) as this rank's ``din / tp`` channels: a slice of the
    whole (the norm scale the engine stores whole, the whole norm's output)
    or, already that wide, as it is (the trainer's shard of the scale)."""
    k = din // plan.tp
    return t[..., plan.rank * k:(plan.rank + 1) * k] if t.shape[-1] == din else t


def _mamba2_close(p: dict, y: torch.Tensor, z: torch.Tensor, cfg) -> torch.Tensor:
    """The gated RMSNorm of the SSD's output ``y`` (..., din of the rank)
    over the whole width and ``out_proj``: under a plan whose heads split,
    the sum of squares an ordered sum over ``model`` (entered: each rank's
    norm reads it); where only ``out_proj``'s rows split, the whole norm's
    output entered and cut to the rank's rows; the row-parallel product
    summed over ``model``."""
    g = y * F.silu(z)
    wo = p["out_proj"].to(y.dtype)
    plan, din = _split_model(), cfg.expand * cfg.d_model
    if plan is None or wo.shape[0] == din:
        return rms_norm(g, p["norm"]) @ wo
    gf = g.float()
    if plan.ssm:
        ss = enter_model(sum_model(gf.square().sum(dim=-1, keepdim=True), plan.mesh), plan.mesh)
        normed = gf * torch.rsqrt(ss / din + 1e-6)
    else:
        normed = gf * torch.rsqrt(gf.square().mean(dim=-1, keepdim=True) + 1e-6)
        normed = _local_cols(enter_model(normed, plan.mesh), din, plan)
    scale = _local_cols(p["norm"], din, plan)
    return sum_model((normed * (1.0 + scale.float())).to(y.dtype) @ wo, plan.mesh)


def mamba2_block(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Full-sequence Mamba-2 mixer.  x (B, S, d) -> (B, S, d)."""
    bsz, s, _ = x.shape
    n = cfg.ssm_state
    z, xbc, dt, cw, cb, a_log, d_skip, dt_bias = _mamba2_open(p, x, cfg)
    din, h = z.shape[-1], dt.shape[-1]
    hp = din // h
    xbc = F.silu(_causal_conv(xbc, cw, cb))
    xin, b_mat, c_mat = xbc.split([din, n, n], dim=-1)
    dt = _softplus(dt.float() + dt_bias)
    a = -torch.exp(a_log.float())
    xr = xin.reshape(bsz, s, h, hp).float()
    chunk = min(64, cfg.ssm_chunk) if FLAGS["ssd_small_chunk"] else cfg.ssm_chunk
    y, _ = _ssd_chunked(xr, dt, a, b_mat.float(), c_mat.float(), chunk)
    y = y + d_skip.float()[:, None] * xr
    return _mamba2_close(p, y.reshape(bsz, s, din).to(x.dtype), z, cfg)


def mamba2_decode(p: dict, x: torch.Tensor, cfg, cache: dict) -> torch.Tensor:
    """One-token decode.  x (B, 1, d); ``cache`` {"conv": (B, K-1, C),
    "state": (B, H, P, N) fp32}, both updated in place (under a plan whose
    heads split, C is the rank's ``x`` channels and the whole ``B`` and
    ``C``, H its heads).  Returns (B, 1, d)."""
    bsz = x.shape[0]
    n = cfg.ssm_state
    z, xbc, dt, cw, cb, a_log, d_skip, dt_bias = _mamba2_open(p, x[:, 0], cfg)
    din, h = z.shape[-1], dt.shape[-1]
    hp = din // h
    xbc = F.silu(_conv_step(cache["conv"], xbc, cw, cb))
    xin, b_mat, c_mat = xbc.split([din, n, n], dim=-1)
    dt = _softplus(dt.float() + dt_bias)  # (B, H)
    a = -torch.exp(a_log.float())
    xh = xin.reshape(bsz, h, hp).float()
    state = cache["state"]
    upd = (dt[..., None] * xh)[..., None] * b_mat.float()[:, None, None, :]
    state.copy_(state * torch.exp(dt * a)[..., None, None] + upd)
    y = torch.einsum("bn,bhpn->bhp", c_mat.float(), state)
    y = y + d_skip.float()[:, None] * xh
    return _mamba2_close(p, y.reshape(bsz, din).to(x.dtype), z, cfg)[:, None]


# --------------------------------------------------------------------------
# RG-LRU (Griffin recurrent block)
# --------------------------------------------------------------------------

_RGLRU_C = 8.0


def rglru_specs(cfg) -> dict:
    d, r = cfg.d_model, cfg.rglru_dim
    return {
        "w_x": ParamSpec((d, r), axes=("embed", "rglru")),
        "w_gate_branch": ParamSpec((d, r), axes=("embed", "rglru")),
        "conv_w": ParamSpec((4, r), scale=0.5, axes=(None, "rglru")),
        "conv_b": ParamSpec((r,), init="zeros", axes=("rglru",)),
        "w_a": ParamSpec((r, r), scale=0.5, axes=("rglru", "rglru_out")),
        "b_a": ParamSpec((r,), init="zeros", axes=("rglru",)),
        "w_i": ParamSpec((r, r), scale=0.5, axes=("rglru", "rglru_out")),
        "b_i": ParamSpec((r,), init="zeros", axes=("rglru",)),
        "lam": ParamSpec((r,), init="ones"),
        "w_out": ParamSpec((r, d), axes=("rglru", "embed")),
    }


def _rglru_gates(p, xr):
    """The recurrence's (a, b) in fp32 from the conv output xr (..., r of
    the rank).  Under a plan whose channels split, the two gates' partial
    products (``w_a`` and ``w_i``'s rows of this rank) are summed over
    ``model`` in one ordered sum, entered with ``lam`` (each rank reads its
    own columns of them), and cut to this rank's columns."""
    w_a, w_i = p["w_a"].to(xr.dtype), p["w_i"].to(xr.dtype)
    plan, lam = _split_model(), p["lam"]
    if plan is None or not plan.rglru:
        pre_a, pre_i = xr @ w_a, xr @ w_i
    else:
        whole, lam = enter_model((sum_model(torch.stack([xr @ w_a, xr @ w_i]), plan.mesh), lam),
                                 plan.mesh)
        cols = slice(plan.rank * xr.shape[-1], (plan.rank + 1) * xr.shape[-1])
        pre_a, pre_i, lam = whole[0][..., cols], whole[1][..., cols], lam[cols]
    r_gate = torch.sigmoid(pre_a + p["b_a"].to(xr.dtype))
    i_gate = torch.sigmoid(pre_i + p["b_i"].to(xr.dtype))
    log_a = -_RGLRU_C * _softplus(lam.float()) * r_gate.float()
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (
        i_gate.float() * xr.float())
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 from h_{-1} = 0, by doubling:
    after the pass of stride d every (a_t, b_t) is the composition of the
    steps t-2d+1 .. t, so ceil(log2 S) elementwise passes give every h_t."""
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _rglru_in(p: dict, x: torch.Tensor) -> tuple:
    """The gate branch and the recurrence's input of ``x`` (..., d) on this
    rank's channels (the input entered where they split)."""
    plan = _split_model()
    if plan is not None and plan.rglru:
        x = enter_model(x, plan.mesh)
    return _gelu(x @ p["w_gate_branch"].to(x.dtype)), x @ p["w_x"].to(x.dtype)


def _rglru_out(p: dict, y: torch.Tensor) -> torch.Tensor:
    """``w_out`` of the gated recurrence ``y``: row-parallel where the
    channels split."""
    out = y @ p["w_out"].to(y.dtype)
    plan = _split_model()
    return sum_model(out, plan.mesh) if plan is not None and plan.rglru else out


def rglru_block(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Griffin recurrent block over a whole sequence.  x (B, S, d)."""
    gate, xr = _rglru_in(p, x)
    xr = _causal_conv(xr, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))
    a, b = _rglru_gates(p, xr)
    h = linear_scan(a, b)
    return _rglru_out(p, h.to(x.dtype) * gate)


def rglru_decode(p: dict, x: torch.Tensor, cfg, cache: dict) -> torch.Tensor:
    """One-token decode.  ``cache`` {"conv": (B, 3, r), "h": (B, r) fp32},
    both updated in place (r the rank's channels under a plan).  Returns
    (B, 1, d)."""
    gate, xr = _rglru_in(p, x[:, 0])
    xr = _conv_step(cache["conv"], xr, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))
    a, b = _rglru_gates(p, xr)
    h = cache["h"]
    h.copy_(a * h + b)
    return _rglru_out(p, h.to(x.dtype) * gate)[:, None]
