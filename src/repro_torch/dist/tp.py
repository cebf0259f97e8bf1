"""Tensor-parallel compute on sharded storage: the serving paths and the
training steps of every family (dense, moe, vlm, hybrid, ssm and encdec)
on a (data, model) mesh (ROADMAP A12, items 1-4).

The reference's ``Engine`` places its parameters under
``params_shardings`` (heads, kv heads, ff, vocab, the SSM's inner dim and
the RG-LRU's channels over ``model``, the embed dim over ``data``) and
GSPMD runs the products tensor-parallel.  The port does it in PyTorch's
idiom: each rank stores its shard of every leaf under the same rules
(``dist/sharding.py``), and the layers compute on those shards with
explicit collectives (``dist/comm.py``), Megatron's layout:

* attention is column-parallel on the local heads and kv heads (wq, wk,
  wv and their biases), so the attend and the KV cache hold local heads
  only, and ``wo`` is row-parallel: each rank's partial output is summed
  over ``model`` in rank order (``comm.sum_in_rank_order``);
* the MLP is column-parallel on ff (``w_gate``, ``w_up``) and row-parallel
  in ``w_down``, with the same ordered sum;
* the embedding looks up the local vocab range (rows outside it zero) and
  sums over ``model``; the head is vocab-parallel, its logits all-gathered
  over ``model``, so every rank holds the whole logits, the same bits;
* Mamba-2's mixer (``models/ssm.py``) runs the SSD on the rank's
  ``h / tp`` heads: the stored ``in_proj`` and conv slabs do not line up
  with the heads, so the ``in_proj`` product's columns and the conv
  weights are gathered whole over ``model`` (one collective) and each rank
  slices its heads' ``z``, ``x`` and ``dt`` and the shared ``B`` and
  ``C``; the gated norm's sum of squares is an ordered sum over ``model``
  and ``out_proj`` is row-parallel;
* the RG-LRU runs on the rank's ``r / tp`` channels: ``w_x`` and
  ``w_gate_branch`` column-parallel, the conv and the scan per channel,
  the two gates' partial products (``w_a`` and ``w_i``'s rows) summed over
  ``model`` in one ordered sum, ``w_out`` row-parallel;
* a leaf whose embed dim sits on ``data`` (FSDP) is gathered over ``data``
  just before its layer runs, the layer's leaves in one collective, and
  dropped after it (the reference's GSPMD does the same); the embedding's
  rows come from every data rank's tokens looked up in that rank's
  columns, then gathered, never the whole table.  The norm scales are
  ``(d,)`` leaves on ``embed`` too: the engine holds them whole for its
  life (``storage_placements``), a few KB a layer.

Where the heads or the kv heads do not divide ``model`` (qwen2's 14 heads
and 2 kv heads on four ranks, paligemma's and recurrentgemma's one kv
head, whisper's 6 heads on four ranks) the rules replicate them, and
attention stays whole on every rank as on one device (the
sequence-sharded prefill attention applies there, the encoder's
full-mask attention too; the cross attention, as the reference's, is
never sequence-sharded); a
heads leaf the rules split while its kv leaf stays whole is gathered over
``model`` before use.  Where the SSM heads do not divide ``model`` the SSD
runs whole on every rank (the ``in_proj`` and conv slabs gathered if the
rules split them) and the norm's output enters the row-parallel
``out_proj`` where its rows split.  The ff and vocab splits hold either
way.  Column products are the single-device columns; an ordered sum adds
the ranks' partials in another order than one device's reduction, so
logits agree within rounding, and every rank ends a step with the same
bits.

``TPPlan`` is the engine's record of one mesh's splits; the layers read it
through ``models.common.mesh_context``.  ``WholeView`` gathers one leaf at
a time for the pack builders, so a rank never holds the whole tree.

The trainer runs the same splits forward and backward (``training_plan``:
the trainer's placements, ``params_shardings``, norm scales included; on
every mesh of more than one rank, a ``model`` axis of 1 too, where it
splits nothing over ``model``).  FSDP as the reference's GSPMD runs it:
each layer's ``data``-sharded leaves are gathered where the layer runs
(``TPPlan.layer`` through ``comm.gather_data``, inside the layer's
checkpointed call, so under remat they are dropped after its forward and
gathered again in its recompute), the top-level leaves where they are
read (``TPPlan.top``), and each gather's backward is a reduce-scatter in
rank order over the pure data axes (``comm.reduce_scatter_in_rank_order``):
a rank holds its shards, one layer's leaves whole at a time and that
layer's whole gradient.  The other collectives are ``comm``'s
differentiable ones: a column-parallel product's input enters
through ``enter_model`` (its gradient summed over ``model`` in the
backward), a row-parallel product leaves through ``sum_model``, the
sequence-sharded attention through ``gather_model``.  The head stays
vocab-parallel into the loss (``TPPlan.xent``): the whole (B, S, V) logits
never exist on a rank.  A replicated leaf read inside a split region (the
qk-norm scales under split heads; the SSM's ``A_log``, ``D`` and
``dt_bias`` and the RG-LRU's ``lam``, sliced to the local heads or
channels) enters it too, and so does every whole tensor the ranks go on to
use differently (the gathered ``in_proj`` columns and conv weights, the
norm's summed squares, the RG-LRU's summed gates): their gradients, each
rank's part, are summed over ``model`` before a gather's backward cuts
them.  A heads leaf gathered over ``model`` (its kv leaf whole) is
gathered with its layer through ``gather_model``, so every replicated
leaf's gradient is complete and the same bits on every ``model`` rank.
``train_collectives`` and ``fsdp_traffic`` predict a step's collectives
and its gathers' and reduce-scatters' bytes.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..models.common import current_rows, per_row
from ..optim.adamw import tree_items
from .comm import (
    all_gather, axis_index, axis_size, enter_model, gather_data, gather_leaves,
    gather_model_leaves, mesh_shape, sum_model,
)
from .sharding import _names, gather_whole, local_shard, params_shardings

__all__ = ["TPPlan", "PLAN_FAMILIES", "serving_plan", "training_plan", "local_config",
           "storage_placements", "shard_shape", "place_params", "placement_bytes", "tree_bytes",
           "WholeView"]


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """The splits of one mesh for a family's serving path, or for its
    training step (``train``).  ``placements`` is the storage placement
    tree (``storage_placements``; the trainer's, ``params_shardings``);
    ``heads``, ``ff`` and ``vocab`` say whether the compute runs on local
    heads, a local ff slab (the MLP's, or every expert's) and a local vocab
    range, ``experts`` whether it runs this rank's ``E / tp`` experts
    (``w_gate``'s experts dim on ``model``), ``ssm`` whether Mamba-2's SSD
    runs on this rank's ``h / tp`` heads, ``rglru`` whether the RG-LRU runs
    on its ``r / tp`` channels; ``attn`` the paths of the attention
    parameter groups in the tree (``layers/attn``, the hybrid's
    ``groups/p{i}_attn/mixer`` and ``tail/t{i}_attn/mixer``, the encdec
    family's ``enc_layers/attn``, ``dec_layers/self_attn`` and
    ``dec_layers/cross_attn``); ``rank`` is
    this rank's ``model`` coordinate; ``train``: the trainer's plan, whose
    forward gathers each layer's leaves over ``data`` at use (``layer``)
    and its top-level leaves where it reads them (``top``, ``held``)."""

    mesh: object
    placements: dict
    tp: int
    rank: int
    heads: bool
    ff: bool
    vocab: bool
    train: bool = False
    experts: bool = False
    ssm: bool = False
    rglru: bool = False
    attn: tuple = (("layers", "attn"),)

    def held(self, placement: tuple) -> tuple:
        """The placement a top-level leaf stored at ``placement`` is read at
        while the plan computes: as stored, or under the training plan with
        every ``data`` dim whole (the training forward gathers its top-level
        leaves where it uses them, ``top``; its layers' leaves ``layer``
        gathers)."""
        return tuple(None if a == "data" else a for a in placement) if self.train else placement

    # -- a rank's sizes ------------------------------------------------------
    def ssm_sizes(self, cfg) -> tuple:
        """(inner width, heads) of this rank's Mamba-2 SSD: ``(din / tp, h /
        tp)`` where the heads split, else the whole ``(din, h)``."""
        din, h = cfg.expand * cfg.d_model, cfg.ssm_heads
        return (din // self.tp, h // self.tp) if self.ssm else (din, h)

    def rglru_width(self, cfg) -> int:
        """This rank's RG-LRU channels: ``r / tp`` where they split."""
        return cfg.rglru_dim // self.tp if self.rglru else cfg.rglru_dim

    # -- parameters at their point of use ------------------------------------
    def _want(self, attn: bool, placement: tuple) -> tuple:
        """The placement the compute reads a layer leaf at: every ``data``
        dim whole, the heads dims of an attention group (``attn``) whole
        where attention is not split."""
        out = []
        for axis in placement:
            if axis == "data" or (axis == "model" and attn and not self.heads):
                out.append(None)
            else:
                out.append(axis)
        return tuple(out)

    def _gather(self, axis: str, tensors: list, dims: list) -> list:
        """``tensors`` (one dtype) gathered whole over ``axis`` in one
        collective: under the training plan through the differentiable
        gathers (``comm.gather_data``, whose backward reduce-scatters over
        the axes the caller split the batch rows over, ``current_rows``;
        ``comm.gather_model_leaves``), else ``comm.gather_leaves``."""
        if not self.train:
            return gather_leaves(tensors, dims, self.mesh, axis)
        if axis == "model":
            return gather_model_leaves(tensors, dims, self.mesh)
        rows = current_rows()
        return gather_data(tensors, dims, self.mesh, None if rows is None else rows[1])

    def layer(self, layers: dict, i: Optional[int], names: Optional[dict] = None,
              placements: Optional[dict] = None, attn: tuple = ("attn",),
              lead: Optional[int] = None) -> dict:
        """Layer ``i`` of the stacked tree ``layers`` (``i`` None: the tree is
        one layer, the hybrid's tail or a layer the caller unstacked), its
        leaves ``names`` (``{group: (leaf, ...)}``; None: every leaf, the
        layer's own leaves such as its norm scales too) gathered where they
        sit on an axis the compute wants whole: one collective an axis for
        all of them.  ``placements``: the layer tree's placements (default
        the plan's ``layers``); ``lead``: the dims of those placements the
        layer no longer has (default 1 where ``i`` indexes the stack, else
        0); ``attn``: the groups that are attention (their heads dims
        gathered where the heads do not split).  Under the training plan the
        gathers are differentiable (``_gather``).  The gathered leaves live
        as long as the returned dict."""
        pls = self.placements["layers"] if placements is None else placements
        if lead is None:
            lead = 0 if i is None else 1
        lp = dict(layers) if i is None else {
            k: ({n: t[i] for n, t in v.items()} if isinstance(v, dict) else v[i])
            for k, v in layers.items()}
        todo = {}  # (group, leaf) or (leaf,) -> (tensor, placement now, placement wanted)
        for group, sub in lp.items():
            if not isinstance(sub, dict):
                if names is None:
                    have = pls[group][lead:]
                    if have != self._want(False, have):
                        todo[(group,)] = (sub, have, self._want(False, have))
                continue
            for name in (sub if names is None else names.get(group, ())):
                if name not in sub:
                    continue
                have = pls[group][name][lead:]
                want = self._want(group in attn, have)
                if have != want:
                    todo[(group, name)] = (sub[name], have, want)
        for axis in ("data", "model"):
            keys = [k for k, (_, have, want) in todo.items()
                    if any(h == axis and w != axis for h, w in zip(have, want))]
            if not keys:
                continue
            dims = [todo[k][1].index(axis) for k in keys]
            for dtype in sorted({todo[k][0].dtype for k in keys}, key=str):
                ks = [(k, d) for k, d in zip(keys, dims) if todo[k][0].dtype == dtype]
                whole = self._gather(axis, [todo[k][0] for k, _ in ks], [d for _, d in ks])
                for (k, _), t in zip(ks, whole):
                    todo[k] = (t,) + todo[k][1:]
        for key, (t, _, _) in todo.items():
            if len(key) == 1:
                lp[key[0]] = t
            else:
                lp[key[0]] = dict(lp[key[0]], **{key[1]: t})
        return lp

    def top(self, params: dict, names) -> dict:
        """``{name: leaf}`` of the top-level leaves ``names`` that
        ``params`` holds, as the training forward reads them (``held``):
        gathered whole over ``data`` where they are stored there, in one
        collective a dtype (``_gather``: their gradients reduce-scattered),
        the others as they are.  The training forward calls it where it
        first uses them, and a leaf it reads twice (a tied embedding, the
        lookup and the head) is gathered once."""
        names = [n for n in names if n in params]
        out = {n: params[n] for n in names}
        on = [n for n in names if "data" in self.placements[n]]
        if axis_size(self.mesh, "data") == 1 or not on:
            return out
        for dtype in sorted({params[n].dtype for n in on}, key=str):
            ns = [n for n in on if params[n].dtype == dtype]
            whole = self._gather("data", [params[n] for n in ns],
                                 [self.placements[n].index("data") for n in ns])
            out.update(zip(ns, whole))
        return out

    def whole_data(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """The top-level leaf ``name`` (``t``, as held) gathered whole over
        ``data`` (the vlm family's ``patch_proj``, read once a prefill)."""
        pl = self.held(self.placements[name])
        return all_gather(t, self.mesh, "data", dim=pl.index("data")) if "data" in pl else t

    def head_matrix(self, params: dict, tied: bool) -> torch.Tensor:
        """The (d, V_loc) head: the untied ``lm_head``'s local vocab columns
        or the tied embedding's local rows transposed, gathered over
        ``data``."""
        name = "embed" if tied else "lm_head"
        w = params[name]
        if "data" in self.held(self.placements[name]):
            w = all_gather(w, self.mesh, "data", dim=self.placements[name].index("data"))
        return w.T if tied else w

    # -- collectives of the compute ------------------------------------------
    def embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """The fp32 embedding rows of ``tokens`` (B, s): the local vocab
        range looked up, rows outside it zero, summed over ``model`` (one
        addend a row is nonzero, so the sum is exact); on ``data`` every data
        rank's tokens are looked up in this rank's columns and the columns
        gathered, and this rank keeps its own rows."""
        e = params["embed"]
        on_data = self.held(self.placements["embed"])[1] == "data"
        toks = all_gather(tokens, self.mesh, "data", dim=0) if on_data else tokens
        if self.vocab:
            idx = toks - self.rank * e.shape[0]
            inside = (idx >= 0) & (idx < e.shape[0])
            rows = F.embedding(idx.clamp(0, e.shape[0] - 1), e)
            rows = sum_model(torch.where(inside[..., None], rows, 0.0), self.mesh)
        else:
            rows = F.embedding(toks, e)
        if on_data:
            rows = all_gather(rows, self.mesh, "data", dim=-1)
            b, r = tokens.shape[0], axis_index(self.mesh, "data")
            rows = rows[r * b:(r + 1) * b]
        return rows

    def logits(self, x: torch.Tensor, head: torch.Tensor, rowwise: bool = False) -> torch.Tensor:
        """``x @ head`` on the local vocab columns, gathered whole over
        ``model`` (``rowwise``: one batch row at a time)."""
        y = per_row(lambda r: r @ head, x, rowwise)
        return all_gather(y, self.mesh, "model", dim=-1) if self.vocab else y

    def heads_in(self, x: torch.Tensor) -> torch.Tensor:
        """The input of the column-parallel q/k/v products on the local
        heads (``enter_model``: its gradient summed over ``model``)."""
        return enter_model(x, self.mesh) if self.heads else x

    def heads_out(self, y: torch.Tensor) -> torch.Tensor:
        """The row-parallel ``wo`` partials summed over ``model``."""
        return sum_model(y, self.mesh) if self.heads else y

    def ff_in(self, x: torch.Tensor) -> torch.Tensor:
        """The input of the column-parallel ``w_gate``/``w_up`` products."""
        return enter_model(x, self.mesh) if self.ff else x

    def ff_out(self, y: torch.Tensor) -> torch.Tensor:
        """The row-parallel ``w_down`` partials summed over ``model``."""
        return sum_model(y, self.mesh) if self.ff else y

    # -- the training forward ------------------------------------------------
    def train_params(self, params: dict) -> dict:
        """``params`` (this rank's shards) as the training forward reads
        them before its layers: where attention splits by heads, the
        replicated qk-norm scales, read on the local heads, entered through
        ``enter_model`` (one call).  An attention leaf split over ``model``
        where the heads do not split is gathered whole with its layer
        (``layer``: one ``gather_model`` a layer, its gradient cut back to
        this rank's slice)."""
        if not self.heads:
            return params
        items = [(path, n) for path in self.attn for n in ("q_norm", "k_norm")
                 if n in _node(params, path)]
        new = enter_model(tuple(_node(params, path)[n] for path, n in items), self.mesh)
        return _replace(params, items, new)

    def train_logits(self, x: torch.Tensor, params: dict, tied: bool) -> torch.Tensor:
        """This rank's vocab columns of the logits, (B, S, V / tp): the head
        on the local vocab range, its input entered through
        ``enter_model``."""
        head = self.head_matrix(params, tied).to(x.dtype)
        if self.vocab:
            x = enter_model(x, self.mesh)
        return torch.einsum("bsd,dv->bsv", x, head)

    def xent(self, logits: torch.Tensor, labels: torch.Tensor, vocab: int) -> torch.Tensor:
        """Vocab-parallel mean next-token cross-entropy of this rank's logit
        columns (``train_logits``); ids >= ``vocab`` (padding) masked, as
        ``families._xent``.  The row maximum is the largest of every rank's
        (gathered, detached: exact); the sum of ``exp`` and the label's
        logit, taken from the one rank whose columns hold it (the other
        addends 0, so exact), are summed over ``model`` in one
        ``sum_model``.  The logsumexp form of ``_xent``'s ``xent_lse``
        route: the label's logit picked in model dtype and widened."""
        if not self.vocab:
            from ..models.families import _xent

            return _xent(logits, labels, vocab)
        mask = (labels >= 0) & (labels < vocab)
        labels = labels.clamp(0, vocab - 1).long()
        v = logits.shape[-1]
        l32 = logits.float()
        m = all_gather(l32.detach().amax(dim=-1, keepdim=True), self.mesh, "model",
                       dim=-1).amax(dim=-1)
        idx = labels - self.rank * v
        inside = (idx >= 0) & (idx < v)
        picked = logits.gather(-1, idx.clamp(0, v - 1)[..., None])[..., 0]
        picked = torch.where(inside, picked.float(), 0.0)
        sums = sum_model(torch.stack([torch.exp(l32 - m[..., None]).sum(dim=-1), picked]),
                         self.mesh)
        ll = sums[1] - (m + torch.log(sums[0]))
        return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1)

    # -- the collectives a step makes ---------------------------------------
    def _layers(self, cfg) -> list:
        """Each layer of ``cfg`` in order as ``(kind, placements, remat)``:
        ``kind`` lm (a dense, moe or vlm layer), ssm, rglru or attn (the
        hybrid's), enc or dec (the encdec family's encoder and decoder
        layers), its placement tree with the layer dim dropped, and
        whether ``cfg.remat`` recomputes it (the hybrid's tail is not)."""
        def drop(tree, lead):
            return {k: drop(v, lead) if isinstance(v, dict) else v[lead:]
                    for k, v in tree.items()}

        return [(kind, drop(_node(self.placements, path), lead), again)
                for kind, path, again, lead in self._layer_paths(cfg)]

    def _ssm_splits(self, mixer: dict) -> tuple:
        """(in_proj's columns, the conv's channels, out_proj's rows) split
        over ``model``, of a Mamba-2 mixer's placements."""
        return (mixer["in_proj"][-1] == "model", mixer["conv_w"][-1] == "model",
                mixer["out_proj"][0] == "model")

    def decode_collectives(self, cfg, rows_split: bool = False) -> int:
        """The collectives one decode step of the dense route makes on a rank
        under this (serving) plan.  A layer: on ``data`` one gather of its
        leaves stored there; on ``model`` one gather of its attention
        leaves where the heads do not split, then its compute's: an
        attention layer's ``wo`` sum where the heads split (an encdec
        decoder layer's two: its self and its cross attention's; its
        encoder ran in the prefill) and the MLP's
        ``w_down`` sum where ff splits (the moe family's experts' partials
        where they or ff split, and with ``rows_split`` on a data axis the
        routing's gather); a Mamba-2 layer's gather of the ``in_proj``
        columns and conv weights (where either splits), the norm's sum
        where the heads split and ``out_proj``'s sum where its rows split;
        an RG-LRU layer's gates' sum and ``w_out``'s sum where its channels
        split.  Then the embedding's sum (vocab split) and on ``data`` its
        two gathers, the head's gather (vocab split) and on ``data`` its
        leaf's, and with ``rows_split`` the logits' rows."""
        dp = axis_size(self.mesh, "data")
        n = 0
        for kind, lpl, _ in self._layers(cfg):
            if kind == "enc":
                continue
            groups = {g: v for g, v in lpl.items() if isinstance(v, dict)}
            n += int(dp > 1 and any("data" in p for g in groups.values() for p in g.values()))
            attn = {"lm": ("attn",), "attn": ("mixer",),
                    "dec": ("self_attn", "cross_attn")}.get(kind, ())
            n += int(bool(attn) and not self.heads
                     and any("model" in p for a in attn for p in groups[a].values()))
            if kind == "lm":
                n += int(self.heads) + int(self.ff or self.experts)
                n += int(cfg.family == "moe" and rows_split and dp > 1)
            elif kind == "dec":
                n += 2 * int(self.heads) + int(self.ff)
            elif kind == "attn":
                n += int(self.heads) + int(self.ff)
            elif kind == "rglru":
                n += 2 * int(self.rglru) + int(self.ff)
            else:
                i, c, o = self._ssm_splits(groups["mixer"])
                n += int(i or c) + int(self.ssm) + int(o)
        # the encdec family's head is the embedding too (its tree has no lm_head)
        head = "embed" if cfg.tie_embeddings or cfg.family == "encdec" else "lm_head"
        n += 2 * int(self.vocab)
        n += 2 * int(dp > 1 and self.placements["embed"][1] == "data")
        n += int(dp > 1 and "data" in self.placements[head])
        return n + int(rows_split)

    def _tops(self, cfg) -> list:
        """The groups of top-level leaves the training forward gathers over
        ``data`` (``top``), in order: the encdec family's encoder position
        table and norm, then its embedding (the tied head's too) and final
        norm; the others' embedding (the vlm family's ``patch_proj`` with it)
        and then the final norm with the untied head."""
        if cfg.family == "encdec":
            return [("enc_pos",), ("enc_norm",), ("embed",), ("final_norm",)]
        first = ("embed", "patch_proj") if cfg.family == "vlm" else ("embed",)
        tied = cfg.tie_embeddings and cfg.family in ("dense", "moe", "vlm")
        return [first, ("final_norm",) if tied else ("final_norm", "lm_head")]

    def grad_collectives(self, cfg, seq: int, split: bool = False,
                         frames: Optional[int] = None) -> int:
        """The collectives the loss and its gradients make on a rank under
        this (training) plan, one (micro)batch of ``seq`` positions (the
        vlm family's patch prefix included, as the data pipeline's
        ``seq_len`` counts it) and, for the encdec family, ``frames``
        encoder frames (default the pipeline's ``min(seq, enc_frames)``).
        A forward: each group of top-level leaves stored on ``data`` gathered
        where it is used (``_tops``), the embedding's sum, and a layer's
        gathers, one of its leaves stored on ``data`` (``data`` above 1) and
        one of its attention leaves split over ``model`` where the heads do
        not split, then its compute: an attention layer's ``wo`` sum (or,
        where the heads do not split, the sequence-sharded attention's
        gather, where ``model`` divides the layer's sequence: the encoder's
        frames, else ``seq``; an encdec decoder layer's cross attention adds
        its ``wo`` sum where the heads split) and ``w_down`` sum (the moe
        family's: its experts' partials, where ``experts`` or ``ff`` splits
        them; with ``split`` first the routing's gather over each data axis
        of size > 1, ``comm.batch_totals``); a Mamba-2 layer's gather of the
        ``in_proj`` columns and conv weights (where either splits), the
        norm's sum (heads split) and ``out_proj``'s sum (rows split); an
        RG-LRU layer's gates' and ``w_out``'s sums (channels split) and its
        MLP's; then the loss's maximum gather and its sum.  Its backward:
        with ``split`` each gather over ``data`` reduce-scatters (one
        collective an axis of ``pod`` and ``data`` of size > 1); the head's
        input entered, an attention layer's q/k/v input (or the sequence
        split's q, k and v) and MLP input (the moe family's token rows and
        gate weights) entered (an encdec decoder layer's cross attention,
        where the heads split, its decoder states and the encoder's output,
        each entered apart), and where the heads split the qk-norm scales
        entered; a Mamba-2 layer's input (``in_proj`` split), its summed
        squares and, where the heads split, its whole tensors and sliced
        replicated leaves (one sum a dtype: activations and fp32 leaves),
        or where they do not its norm's output (``out_proj`` split); an
        RG-LRU layer's input and its summed gates with ``lam`` (one sum a
        dtype).  ``cfg.remat`` makes each recomputed layer's (the hybrid's
        tail is not) forward collectives again in the backward, its gathers
        included, but the sum that ends the layer: the recompute stops at
        the last tensor the backward saved (``torch.utils.checkpoint``'s
        early stop), and ``sum_model`` saves none."""
        from ..models.opt_flags import FLAGS

        sizes = [axis_size(self.mesh, a) for a in ("pod", "data")]
        live = [k for k in sizes if k > 1]
        dp = sizes[1]
        scatter = (1 + int(sizes[0] > 1)) if split else 0  # a data gather's backward
        if frames is None:
            frames = min(seq, cfg.enc_frames)

        def seq_split(s: int) -> bool:
            return self.tp > 1 and not self.heads and FLAGS["attn_seq_shard"] and s % self.tp == 0

        dtypes = 1 if cfg.dtype != "bfloat16" else 2  # an entered tuple's sums
        forward = 3 * int(self.vocab)
        backward = int(self.vocab) + int(self.heads and cfg.qk_norm)
        for group in self._tops(cfg):
            g = int(dp > 1 and any("data" in self.placements[n] for n in group
                                   if n in self.placements))
            forward, backward = forward + g, backward + g * scatter
        attn_of = {"lm": ("attn",), "attn": ("mixer",), "enc": ("attn",),
                   "dec": ("self_attn", "cross_attn")}
        remat = 0
        for kind, lpl, again in self._layers(cfg):
            if kind in ("lm", "attn", "enc", "dec"):
                mlp = int(self.ff or self.experts)
                routing = len(live) if split and cfg.family == "moe" else 0
                per = int(self.heads or seq_split(frames if kind == "enc" else seq)) + mlp
                f, b, r = per + routing, per, per + routing - mlp
                if kind == "dec":  # the cross attention: wo's sum; its two inputs entered
                    f, b, r = f + int(self.heads), b + 2 * int(self.heads), r + int(self.heads)
            elif kind == "rglru":
                rg, mlp = int(self.rglru), int(self.ff)
                f, b, r = 2 * rg + mlp, rg * (1 + dtypes) + mlp, 2 * rg
            else:
                i, c, o = self._ssm_splits(lpl["mixer"])
                f = int(i or c) + int(self.ssm) + int(o)
                b = int(i) + int(self.ssm) * (1 + dtypes) + int(o and not self.ssm)
                r = f - int(o)
            on_data = dp > 1 and any("data" in p for _, p in tree_items(lpl))
            heads_gather = int(not self.heads and any(
                "model" in p for a in attn_of.get(kind, ()) for p in lpl[a].values()))
            gathers = int(on_data) + heads_gather
            forward, backward = forward + f + gathers, backward + b + int(on_data) * scatter
            remat += r + gathers if cfg.remat and again else 0
        return forward + backward + remat

    def fsdp_traffic(self, cfg, microbatches: int = 1, split: bool = False,
                     itemsize: int = 4) -> dict:
        """``{"fsdp-gather": {"count", "bytes"}, "reduce-scatter": {...}}``:
        the gathers over ``data`` one training step makes on a rank and
        their reduce-scatters (with ``split``), each count and the bytes this
        rank receives, as ``comm.STATS["by_type"]`` counts them, from the
        leaves' shapes (``itemsize`` bytes an entry).  A group of leaves
        of ``W`` bytes a rank, whole over ``data`` at its ``model`` shard:
        a gather receives ``(dp - 1) / dp`` of ``W`` (again in a layer's
        recompute under ``cfg.remat``), its reduce-scatter the same over
        ``data`` and ``(pods - 1) W`` more from the other pods."""
        from ..models import build_model

        sizes = mesh_shape(self.mesh)
        dp, pods = sizes.get("data", 1), sizes.get("pod", 1)
        out = {"fsdp-gather": {"count": 0, "bytes": 0},
               "reduce-scatter": {"count": 0, "bytes": 0}}
        if dp == 1:
            return out
        specs = build_model(cfg).specs()

        def shard_bytes(spec, pl, lead=0):
            return math.prod(shard_shape(spec.shape[lead:], pl[lead:], self.mesh)) * itemsize

        groups = []  # (bytes a rank holds of the group's leaves on data, times gathered)
        for names in self._tops(cfg):
            w = sum(shard_bytes(specs[n], self.placements[n]) for n in names
                    if n in specs and "data" in self.placements[n])
            groups.append((w, 1))
        for kind, path, again, lead in self._layer_paths(cfg):
            spec, pl = _node(specs, path), _node(self.placements, path)
            w = sum(shard_bytes(sp, p, lead) for (_, sp), (_, p)
                    in zip(tree_items(spec), tree_items(pl)) if "data" in p)
            groups.append((w, 2 if cfg.remat and again else 1))
        for w, times in groups:
            if w:
                g, r = out["fsdp-gather"], out["reduce-scatter"]
                g["count"] += microbatches * times
                g["bytes"] += microbatches * times * (dp - 1) * w
                if split:
                    r["count"] += microbatches * (1 + int(pods > 1))
                    r["bytes"] += microbatches * ((dp - 1) * w + (pods - 1) * dp * w)
        return out

    def _layer_paths(self, cfg) -> list:
        """``(kind, path, remat, lead)`` of each layer of ``cfg`` in
        ``_layers``' order: the path of its stack (or tail layer) in the
        tree and the leading layer dims its leaves drop."""
        if cfg.family == "encdec":
            return ([("enc", ("enc_layers",), True, 1)] * cfg.enc_layers
                    + [("dec", ("dec_layers",), True, 1)] * cfg.n_layers)
        if cfg.family == "hybrid":
            from ..models.families import _hybrid_layout

            n_groups, tail = _hybrid_layout(cfg)
            out = [(kind, ("groups", f"p{i}_{kind}"), True, 1)
                   for _ in range(n_groups) for i, kind in enumerate(cfg.block_pattern)]
            return out + [(kind, ("tail", f"t{i}_{kind}"), False, 0)
                          for i, kind in enumerate(tail)]
        return [("ssm" if cfg.family == "ssm" else "lm", ("layers",), True, 1)] * cfg.n_layers

    def train_collectives(self, cfg, seq: int, microbatches: int = 1, split: bool = False,
                          compress: bool = False, frames: Optional[int] = None) -> int:
        """The collectives one training step makes on a rank under this
        (training) plan: ``grad_collectives`` a microbatch (``frames``: the
        encdec family's, as there); then once a step, with ``split``, the
        sum over the data ranks of the loss and of every gradient leaf no
        ``data`` dim holds (one buffer: ``comm.sum_in_rank_order``, one
        all-reduce over one axis of two, else a gather an axis), the norm's
        ordered sum over every axis of size > 1 (``pod``, ``data`` and
        ``model``, counted alike) and with ``compress`` the scales' gather
        (one an axis)."""
        def ordered_sum(axes) -> int:
            live = [k for k in (axis_size(self.mesh, a) for a in axes) if k > 1]
            return 1 if live == [2] else len(live)

        n = microbatches * self.grad_collectives(cfg, seq, split, frames)
        if split:
            n += ordered_sum(("pod", "data"))
        every = ("pod", "data", "model")
        n += ordered_sum(every)
        if compress:
            n += sum(axis_size(self.mesh, a) > 1 for a in every)
        return n


def _node(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _replace(tree: dict, items: list, leaves) -> dict:
    """``tree`` with the leaf ``name`` of the group at ``path`` replaced by
    each of ``leaves`` for ``(path, name)`` in ``items``: the dicts along
    the paths copied, the rest shared."""
    out = dict(tree)
    for (path, name), leaf in zip(items, leaves):
        node = out
        for k in path:
            node[k] = dict(node[k])
            node = node[k]
        node[name] = leaf
    return out


def _paths_with(tree: dict, leaf: str, path: tuple = ()) -> list:
    """The paths of the groups of a placement tree that hold ``leaf``."""
    out = [path] if leaf in tree and not isinstance(tree[leaf], dict) else []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _paths_with(v, leaf, path + (k,))
    return out


PLAN_FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "encdec")


def serving_plan(cfg, mesh) -> Optional[TPPlan]:
    """The plan of a family's serving path on ``mesh`` (every family has
    one); None for no mesh, or a mesh of one rank."""
    if cfg.family not in PLAN_FAMILIES or math.prod(mesh_shape(mesh).values()) <= 1:
        return None
    from ..models import build_model

    return _plan(cfg, mesh, storage_placements(build_model(cfg).specs(), mesh), train=False)


def _plan(cfg, mesh, pl: dict, train: bool) -> TPPlan:
    """The splits of placements ``pl`` on ``mesh``: the first attention
    group's ``wq`` and ``wk`` tell the heads split; the first MLP's
    ``w_gate`` (d, ff), or the experts' (E, d, ff), the ff and experts
    splits; the RG-LRU's ``w_x`` its channels'; Mamba-2's heads split where
    ``model`` divides them.  The encdec family's three attention groups a
    layer (``enc_layers/attn``, ``dec_layers/self_attn``,
    ``dec_layers/cross_attn``) share one config, so the first tells the
    heads split of all; its FFN is ``ffn``, as the other families'."""
    tp = axis_size(mesh, "model")
    attn = tuple(_paths_with(pl, "wq"))
    gates = [_node(pl, p)["w_gate"] for p in _paths_with(pl, "w_gate")]
    rglru = [_node(pl, p)["w_x"] for p in _paths_with(pl, "w_x")]
    heads = bool(attn) and all(_node(pl, attn[0])[n][-2] == "model" for n in ("wq", "wk"))
    gate = gates[0] if gates else ()
    return TPPlan(
        mesh=mesh, placements=pl, tp=tp, rank=axis_index(mesh, "model"), heads=heads,
        ff=bool(gate) and gate[-1] == "model", vocab=pl["embed"][0] == "model", train=train,
        experts=len(gate) == 4 and gate[1] == "model",
        ssm=cfg.family == "ssm" and tp > 1 and cfg.ssm_heads % tp == 0,
        rglru=bool(rglru) and rglru[0][-1] == "model", attn=attn)


def training_plan(cfg, mesh) -> Optional[TPPlan]:
    """The plan of a family's training step on ``mesh``: the serving plan's
    splits on the trainer's placements (``params_shardings``, the norm
    scales on ``data`` and the SSM's on ``model`` too), each layer's leaves
    on ``data`` gathered at use (``TPPlan.layer``).  On a ``model`` axis of
    1 the plan splits nothing over ``model`` and the compute is the
    single-device program on gathered leaves.  None for no mesh or a mesh
    of one rank."""
    if cfg.family not in PLAN_FAMILIES or math.prod(mesh_shape(mesh).values()) <= 1:
        return None
    from ..models import build_model

    return _plan(cfg, mesh, params_shardings(build_model(cfg).specs(), mesh), train=True)


def local_config(cfg, plan: Optional[TPPlan]):
    """``cfg`` with this rank's head counts (the head width pinned), the
    config the attend and the KV cache are built from; ``cfg`` itself when
    the heads do not split.  The moe family's ``n_experts`` stays the
    whole count: the capacity ``int(cf t k / e) + 1`` and the aux loss read
    it, and a rank's ``E / tp`` there would raise the capacity ``tp``
    times and drop fewer tokens than one device (a rank knows its experts
    from its weights' shape).  The SSM's and the RG-LRU's widths stay too
    (``d_model`` cannot shrink): a rank's come from the plan
    (``TPPlan.ssm_sizes``, ``TPPlan.rglru_width``), which the model's
    cache specs read (``build_model(cfg, plan)``)."""
    if plan is None or not plan.heads:
        return cfg
    return dataclasses.replace(cfg, head_dim=cfg.hd, n_heads=cfg.n_heads // plan.tp,
                               kv_heads=cfg.kv_heads // plan.tp)


def storage_placements(specs: dict, mesh) -> dict:
    """``params_shardings`` of ``specs``, with every norm scale whole: the
    placement the serving engine stores (the trainer's, but for the
    ``(d,)`` scales it holds gathered)."""
    def walk(tree, pl):
        return {k: walk(v, pl[k]) if isinstance(v, dict)
                else (None,) * len(v.shape) if "norm" in k else pl[k]
                for k, v in tree.items()}

    return walk(specs, params_shardings(specs, mesh))


def shard_shape(shape: tuple, placement: tuple, mesh) -> tuple:
    """The shape of one rank's shard of a ``shape`` leaf under
    ``placement``."""
    sizes = mesh_shape(mesh)
    return tuple(d // math.prod(sizes[a] for a in _names(p)) for d, p in zip(shape, placement))


def place_params(params: dict, specs: dict, placements: dict, mesh, device) -> dict:
    """This rank's storage of ``params`` on ``device``: each leaf given
    whole (its spec's shape) is cut to its shard under ``placements``; a
    leaf given as this rank's shard under the trainer's placement
    (``params_shardings``, its shape ``shard_shape``) is kept, the norm
    scales gathered whole.  A leaf of any other shape raises: nothing
    silently stores whole weights or a wrong shard."""
    trainer = params_shardings(specs, mesh)

    def walk(tree, spec, want, have, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, spec[k], want[k], have[k], path + (k,))
                continue
            shape = tuple(v.shape)
            if shape == tuple(spec[k].shape):
                out[k] = local_shard(v, want[k], mesh).to(device)
            elif shape == shard_shape(spec[k].shape, have[k], mesh):
                v = v.to(device)
                out[k] = gather_whole(v, have[k], mesh) if want[k] != have[k] else v
            else:
                raise ValueError(
                    f"parameter {'/'.join(path + (k,))} has shape {shape}: neither whole "
                    f"{tuple(spec[k].shape)} nor this rank's shard "
                    f"{shard_shape(spec[k].shape, have[k], mesh)}")
        return out

    return walk(params, specs, placements, trainer, ())


def tree_bytes(tree: dict) -> int:
    """Bytes of every tensor leaf of a nested dict."""
    return sum(tree_bytes(v) if isinstance(v, dict) else v.numel() * v.element_size()
               for v in tree.values())


def placement_bytes(specs: dict, placements: dict, mesh, itemsize: int = 4) -> int:
    """The bytes one rank stores under ``placements``: each leaf's shard
    shape, ``itemsize`` bytes an entry (the engine's dense storage
    arithmetic)."""
    total = 0
    for k, v in specs.items():
        if isinstance(v, dict):
            total += placement_bytes(v, placements[k], mesh, itemsize)
        else:
            total += math.prod(shard_shape(v.shape, placements[k], mesh)) * itemsize
    return total


class WholeView(Mapping):
    """A read-only view of a rank's sharded parameter tree whose leaves are
    gathered whole on access (and ``transform(path, leaf)`` applied), one
    leaf at a time, never cached: the pack builders read a leaf, pack this
    rank's windows of it and drop it, so the peak is one leaf whole; the
    trainer returns its params and moments as views (``Trainer.train``).
    Every rank must read the same leaves in the same order (each read is a
    collective): ``optim.adamw.tree_items`` walks a view in sorted key
    order."""

    def __init__(self, tree: dict, placements: dict, mesh,
                 transform: Optional[Callable] = None, path: tuple = ()):
        self._tree, self._pl, self._mesh = tree, placements, mesh
        self._transform, self._path = transform, path

    def __getitem__(self, k):
        v = self._tree[k]
        if isinstance(v, dict):
            return WholeView(v, self._pl[k], self._mesh, self._transform, self._path + (k,))
        v = gather_whole(v, self._pl[k], self._mesh)
        return v if self._transform is None else self._transform(self._path + (k,), v)

    def __iter__(self):
        return iter(self._tree)

    def __len__(self):
        return len(self._tree)
