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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ParamSpec, rms_norm
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


def mamba2_block(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Full-sequence Mamba-2 mixer.  x (B, S, d) -> (B, S, d)."""
    bsz, s, d = x.shape
    din = cfg.expand * d
    n, h = cfg.ssm_state, cfg.ssm_heads
    hp = din // h
    z, xbc, dt = _mamba2_split(cfg, x @ p["in_proj"].to(x.dtype))
    xbc = F.silu(_causal_conv(xbc, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype)))
    xin, b_mat, c_mat = xbc.split([din, n, n], dim=-1)
    dt = _softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["A_log"].float())
    xr = xin.reshape(bsz, s, h, hp).float()
    chunk = min(64, cfg.ssm_chunk) if FLAGS["ssd_small_chunk"] else cfg.ssm_chunk
    y, _ = _ssd_chunked(xr, dt, a, b_mat.float(), c_mat.float(), chunk)
    y = y + p["D"].float()[:, None] * xr
    y = y.reshape(bsz, s, din).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    return y @ p["out_proj"].to(x.dtype)


def mamba2_decode(p: dict, x: torch.Tensor, cfg, cache: dict) -> torch.Tensor:
    """One-token decode.  x (B, 1, d); ``cache`` {"conv": (B, K-1, C),
    "state": (B, H, P, N) fp32}, both updated in place.  Returns (B, 1, d)."""
    bsz, _, d = x.shape
    din = cfg.expand * d
    n, h = cfg.ssm_state, cfg.ssm_heads
    hp = din // h
    z, xbc, dt = _mamba2_split(cfg, x[:, 0] @ p["in_proj"].to(x.dtype))
    xbc = F.silu(_conv_step(cache["conv"], xbc, p["conv_w"].to(x.dtype),
                            p["conv_b"].to(x.dtype)))
    xin, b_mat, c_mat = xbc.split([din, n, n], dim=-1)
    dt = _softplus(dt.float() + p["dt_bias"])  # (B, H)
    a = -torch.exp(p["A_log"].float())
    xh = xin.reshape(bsz, h, hp).float()
    state = cache["state"]
    upd = (dt[..., None] * xh)[..., None] * b_mat.float()[:, None, None, :]
    state.copy_(state * torch.exp(dt * a)[..., None, None] + upd)
    y = torch.einsum("bn,bhpn->bhp", c_mat.float(), state)
    y = y + p["D"].float()[:, None] * xh
    y = y.reshape(bsz, din).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    return (y @ p["out_proj"].to(x.dtype))[:, None]


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
    """The recurrence's (a, b) in fp32 from the conv output xr (..., r)."""
    r_gate = torch.sigmoid(xr @ p["w_a"].to(xr.dtype) + p["b_a"].to(xr.dtype))
    i_gate = torch.sigmoid(xr @ p["w_i"].to(xr.dtype) + p["b_i"].to(xr.dtype))
    log_a = -_RGLRU_C * _softplus(p["lam"].float()) * r_gate.float()
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


def rglru_block(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Griffin recurrent block over a whole sequence.  x (B, S, d)."""
    gate = _gelu(x @ p["w_gate_branch"].to(x.dtype))
    xr = x @ p["w_x"].to(x.dtype)
    xr = _causal_conv(xr, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))
    a, b = _rglru_gates(p, xr)
    h = linear_scan(a, b)
    return (h.to(x.dtype) * gate) @ p["w_out"].to(x.dtype)


def rglru_decode(p: dict, x: torch.Tensor, cfg, cache: dict) -> torch.Tensor:
    """One-token decode.  ``cache`` {"conv": (B, 3, r), "h": (B, r) fp32},
    both updated in place.  Returns (B, 1, d)."""
    x0 = x[:, 0]
    gate = _gelu(x0 @ p["w_gate_branch"].to(x.dtype))
    xr = _conv_step(cache["conv"], x0 @ p["w_x"].to(x.dtype), p["conv_w"].to(x.dtype),
                    p["conv_b"].to(x.dtype))
    a, b = _rglru_gates(p, xr)
    h = cache["h"]
    h.copy_(a * h + b)
    return ((h.to(x.dtype) * gate) @ p["w_out"].to(x.dtype))[:, None]
