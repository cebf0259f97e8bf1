"""Serving engine: batched prefill + greedy / temperature decode, dense or
through VUSA-packed weights (``ServeConfig.packed_weights``), and
self-speculative decoding (``ServeConfig.speculative``).

Port of the JAX package's ``serve/engine.py``: one-shot ``generate``, and
the entry points the continuous-batching scheduler (``serve/scheduler.py``)
drives — ``prime`` and ``prime_many`` (bucketed masked prefill),
``prefill_chunk`` (paged chunked prefill), the pool step and the pool's
speculative round.  The reference fuses the decode loop into one
``lax.scan`` and the speculative decode into one ``lax.while_loop``.
Here, with ``ServeConfig.fused`` (the default) on a CUDA device, one
decode step is captured in a CUDA graph once per batch size and replayed
once per token, one speculative round (``draft_k`` drafter steps, the
verify, the accept scan) in another, replayed round after round, and a
scheduler's pool step (all its slots, each row at its own position) or,
on a speculative engine, its pool round in a third, replayed ``segment``
times a segment.  ``fused=False`` keeps the eager host loop as
the parity oracle, as the reference keeps its host loop.  On the CPU there
are no graphs: ``fused=True`` runs the same step eagerly.  A capture or
replay that fails raises; nothing falls back to the eager loop.

Nothing in a step waits for the device: the positions are a (B,) device
tensor in the cache, each token is chosen on the device and feeds the next step,
the integrity flags (``isfinite`` over the fp32 logits) stay there, and
tokens and flags are fetched once at the end.  The speculative loop reads
its emitted count once per batch of rounds (``_spec_decode``).

Integrity and degradation: a pack may carry a seeded fault plan
(``ServeConfig.faults``: position flips the pack validation refuses, value
NaNs only the run-time guard sees).  When a guard trips under packed
weights the scheduler quarantines the pack (``quarantine_packed``) and
every later step runs dense; the dense twin of each pool graph is captured
with the packed one at ``prepare_pool``, while every slot is free, so the
switch never captures on a live pool.  ``reload_packed`` rebuilds the pack
(a hot swap) and drops every captured graph, since they hold the old
pack's addresses; the next ``prepare_pool`` captures afresh.

Sampling is Gumbel-max over a noise table drawn once per ``generate`` from
a ``torch.Generator`` seeded by ``ServeConfig.seed``, one (B, V) draw per
emitted token, indexed on the device by the emitted-token count.  The noise
of token t depends on (seed, t) alone, so the graph and the eager loop,
and speculative and plain decode, draw the same tokens; the reference gets
the same property by splitting its key once per emitted token.  No random
state lives in a graph.

On a mesh (``Engine(..., mesh=)``, a (data, model) DeviceMesh of ranks
that all run the same code; ``launch/mesh.py``) the engine of every family
stores each dense leaf as this rank's shard under the
reference's placements (``dist/tp.py storage_placements``: heads, kv
heads, ff, vocab, the SSM's inner dim and the RG-LRU's channels over
``model``, the embed dim over ``data``; the norm scales held whole), given
whole or as shards (leaf shapes tell them apart), and its dense products
run tensor-parallel on those shards with ordered sums and gathers
(``dist/tp.py``): the attend and the KV cache hold the local heads, the
recurrent caches the local SSM heads and RG-LRU channels, and every rank
ends each step with the same logits bits, within rounding of one
device's.  Each rank packs only its windows of every pack
(``pack_lm_weights(shards=tp, rank=...)``, what
``serve/packed.shard_packed`` leaves of a whole pack), from one leaf
gathered whole at a time (``dist.tp.WholeView``), run through the
tensor-parallel appliers; where attention splits by heads, a rank packs
its attention from its own heads (``pack_lm_weights(split_heads=True)``),
so the KV cache the packed route and its dense twin share holds the
local heads.  The dense twin of a pack is the tensor-parallel dense
route.  The moe family stores its experts split over ``model``
(``E / tp`` a rank, expert parallelism) under the same rules and serves
dense; where ``generate`` splits its rows over ``data`` the routing counts
over the whole batch (``layers.moe``).  The vlm, hybrid, ssm and encdec
families serve dense on their shards (the recurrent ones prime through
eager decode steps, each making its collectives; the encdec prefill runs
the encoder on the rank's shards over its rows of ``frames`` and writes
the cross K/V of the rank's kv heads).  The batch rows (or the
scheduler's slots) are split over ``data`` when
its size divides them, and kept whole on every rank when it does not.
The logits of every step are gathered whole before a token is chosen, and
every rank draws from the same noise, so every rank chooses every row's
token.  Gloo collectives cannot be captured in a CUDA graph: a step that
makes one inside its layers runs eagerly (a ``model`` axis above 1, or on
a data axis a step that reads a dense leaf stored on ``data``); the fully
packed step on a data axis is captured from its embedding rows to its
logits, and the embedding (its collective), the gather of the logits and
the choice run around each replay.  A 1x1 mesh is no mesh: the same
program, graphs included.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..dist.comm import all_gather, axis_index, axis_size, mesh_shape
from ..dist.tp import WholeView, local_config, place_params, serving_plan, tree_bytes
from ..models import build_model
from ..models.common import mesh_context, strict_fp32
from ..models.families import RECURRENT_FAMILIES, _embed_tokens, act_dtype
from .faults import FaultConfig
from .metrics import acceptance_rate, tok_per_s

__all__ = ["ServeConfig", "Engine", "choose_tokens"]


def choose_tokens(logits: torch.Tensor, vocab: int, temperature: float = 0.0,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token ids from fp32 ``logits`` (..., V): the argmax, or with a
    ``temperature`` the Gumbel-max draw ``argmax(logits / T + noise)``
    (``noise`` the logits' shape), over the first ``vocab`` columns only, so
    a padding column of the padded vocabulary (an id >= ``vocab``) is never
    chosen (ROADMAP C17).  A slice of the logits and of the noise, not a
    mask: an argmax over columns that hold the maximum picks the same id,
    so every choice below ``vocab`` is the unsliced one, and the slice is
    captured in a CUDA graph as it is.  Under a vocab-parallel head the
    logits are gathered whole before any choice (``TPPlan.logits``), so
    the padding columns, the last ``model`` rank's, are cut here too."""
    x = logits[..., :vocab]
    if temperature > 0:
        x = x / temperature + noise[..., :vocab]
    return torch.argmax(x, dim=-1)


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
    fused: bool = True  # CUDA-graph decode loop on the card (False = eager host loop)
    # prompt-length buckets for batched masked prefill (``prime_many``); an
    # empty tuple = powers of two from 8 up to max_len, which always ends
    # the set
    prefill_buckets: tuple = ()
    # paged KV pool of the scheduler: 0 = the slot pool (one contiguous
    # cache row per slot); > 0 = blocks of this many rows in a shared arena
    # with per-slot block tables.  Must divide max_len (the gathered block
    # view must equal the slot pool's cache shape for bit-parity).
    page_size: int = 0
    # share identical prompt prefixes between requests: full pages by
    # refcounted block reuse, partial tail pages by copy-on-write.  Only
    # meaningful with page_size > 0.
    prefix_cache: bool = True
    # arena capacity in user blocks; 0 = worst case (slots * max_len / page,
    # no oversubscription).  Smaller values oversubscribe: admission checks
    # the worst case per request, mid-flight exhaustion preempts.
    arena_blocks: int = 0
    # chunked prefill: > 0 = prompts longer than this prefill in chunks of
    # this many tokens, one chunk per admitting slot between decode
    # segments.  Requires page_size > 0 and a page multiple.  0 = whole
    # prompts.
    prefill_chunk: int = 0
    # seeded fault plan (``serve/faults.py``); None = no faults.  Pack
    # corruption lands at pack build (position flips before validation,
    # value NaNs after); cache poisoning and stalls are the scheduler's.
    faults: Optional[FaultConfig] = None
    # self-speculative decoding: the same weights magnitude-pruned at
    # ``draft_sparsity`` and packed at scope "all" draft ``draft_k`` greedy
    # tokens a round; the configured path verifies them in one multi-token
    # step and the longest matching prefix is accepted.  Tokens are
    # bit-identical to plain decode, greedy and sampled.  ``generate``
    # serves B = 1; the scheduler serves it on its whole pool.
    speculative: bool = False
    draft_k: int = 4
    draft_sparsity: float = 0.99

    def __post_init__(self):
        if self.packed_weights not in (False, "mlp", "all"):
            raise ValueError(
                f"packed_weights must be False, 'mlp' or 'all', got {self.packed_weights!r}"
            )
        if self.packed_values not in ("bf16", "int8", "int4"):
            raise ValueError(
                f"packed_values must be 'bf16', 'int8' or 'int4', got {self.packed_values!r}"
            )
        if self.page_size < 0 or (self.page_size and self.max_len % self.page_size):
            raise ValueError(
                f"page_size {self.page_size} must be 0 (slot pool) or divide "
                f"max_len {self.max_len} (the paged view's bit-parity contract)"
            )
        if self.prefill_chunk:
            if not self.page_size:
                raise ValueError("prefill_chunk requires page_size > 0 "
                                 "(chunks write through block tables)")
            if self.prefill_chunk % self.page_size:
                raise ValueError(
                    f"prefill_chunk {self.prefill_chunk} must be a multiple of "
                    f"page_size {self.page_size}"
                )
        if self.speculative:
            if self.draft_k < 1:
                raise ValueError(f"draft_k must be >= 1, got {self.draft_k}")
            if not (0.0 <= self.draft_sparsity < 1.0):
                raise ValueError(
                    f"draft_sparsity must be in [0, 1), got {self.draft_sparsity}"
                )
            if not self.fused:
                raise ValueError("speculative decoding requires the fused decode path")


def _to(tree: dict, device: torch.device) -> dict:
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}



@dataclasses.dataclass
class _Loop:
    """Device state of a plain decode segment: the input token (B, 1), the
    cache (K/V and ``pos``), the emitted-token count, the (B, n) token and
    flag outputs written at the count, and the (n, B, V) Gumbel noise table
    (None when greedy)."""

    token: torch.Tensor
    cache: dict
    count: torch.Tensor
    toks: torch.Tensor
    oks: torch.Tensor
    noise: Optional[torch.Tensor]
    # on a data axis: this rank's rows of the whole batch (token, toks, oks
    # and noise are whole, the cache holds the rows), and the static (rows,
    # V) logits a captured step writes for the gather after its replay;
    # ``x`` the static (rows, 1, d) embedding rows made before each replay
    rows: Optional[slice] = None
    logits: Optional[torch.Tensor] = None
    x: Optional[torch.Tensor] = None


@dataclasses.dataclass
class _SpecLoop:
    """Device state of a speculative decode at B = 1: the pending token
    (1, 1), the cache, the emitted count and the round count, the emit and
    flag buffers (n + draft_k + 1,), written at the count a whole round
    wide, and the noise table (None when greedy)."""

    token: torch.Tensor
    cache: dict
    count: torch.Tensor
    rounds: torch.Tensor
    buf: torch.Tensor
    okb: torch.Tensor
    noise: Optional[torch.Tensor]


@dataclasses.dataclass
class _Pool:
    """Device state of a scheduler's slot pool, stepped by ``_pool_step``
    (all ``slots`` rows at once) and replayed ``segment`` steps per
    segment: the input token (slots, 1); the cache — the slot pool's (K/V
    and a (slots,) ``pos``) or, with ``paged``, the paged pool's
    ``{"arena", "table", "pos"}`` (``models/cache.py``); each slot's
    emitted-token count, which picks its noise row; the step's column in
    the (slots, segment) token and flag outputs; and the (slots, n, V)
    Gumbel noise table, each slot's rows copied in at admission (made at
    the first sampled segment).  With ``spec`` each replay is one
    speculative round of every slot (``_pool_spec_round``): the outputs
    are (slots, segment, draft_k + 1) tokens and flags, written a round
    wide at the round's column, and ``nems`` (slots, segment) holds each
    round's emitted count."""

    token: torch.Tensor
    cache: dict
    paged: bool
    count: torch.Tensor
    col: torch.Tensor
    toks: torch.Tensor
    oks: torch.Tensor
    noise: Optional[torch.Tensor] = None
    spec: bool = False
    nems: Optional[torch.Tensor] = None
    rows: Optional[slice] = None  # as ``_Loop.rows``: this rank's slots
    logits: Optional[torch.Tensor] = None
    x: Optional[torch.Tensor] = None


@dataclasses.dataclass
class _Graph:
    """A captured CUDA graph, the static state it replays against, the
    wrapper launches captured in one replay (by wrapper and route), the
    replays so far, and what runs eagerly around each replay (``pre``
    before: the embedding rows, whose lookup makes a collective on a mesh;
    ``emit`` after: the gather of the logits and the choice)."""

    graph: torch.cuda.CUDAGraph
    state: object
    launches: Dict[str, Dict[str, int]]
    replays: int = 0
    emit: Optional[Callable] = None
    pre: Optional[Callable] = None


def _wrapper_counts() -> Dict[str, Dict[str, int]]:
    from ..kernels.vusa_packed import vusa_fused_mlp_matmul, vusa_packed_matmul

    return {"vusa_packed_matmul": dict(vusa_packed_matmul.launches),
            "vusa_fused_mlp_matmul": dict(vusa_fused_mlp_matmul.launches)}


class Engine:
    def __init__(
        self, cfg: ArchConfig, params: dict, sc: Optional[ServeConfig] = None,
        device="cuda", clock=None, mesh=None,
    ):
        """``params``: the reference-layout parameter dict (moved to
        ``device``).  Switches TF32 off process-wide (``strict_fp32``): the
        dense path's fp32 products are true fp32, as in the reference.  The
        packs (the verifier's and, with ``speculative``, the drafter's) are
        built here; ``fused``, ``temperature``, ``seed`` and ``max_len`` are
        read at each call.  ``clock`` injects the timing source (default
        ``time.monotonic``); the scheduler inherits it, so engine and
        scheduler timings share one timeline.  ``mesh``: a (data, model)
        DeviceMesh this rank belongs to (see the module docstring); a
        mesh of one rank is no mesh.  On a mesh (every family has a plan,
        ``dist.tp.serving_plan``) ``params`` may
        hold any leaf whole or as this rank's shard under
        ``dist.sharding.params_shardings`` (what the trainer stores), so a
        caller that cannot hold the model whole hands over shards; a leaf
        of another shape raises."""
        strict_fp32()
        self.cfg = cfg
        self.sc = ServeConfig() if sc is None else sc
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # pin "cuda" to the current card, so a worker thread can set it
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._clock = clock or time.monotonic
        self._make_buckets(self.sc)  # refuses a bucket outside [1, max_len] now
        if self.sc.speculative and cfg.family != "dense":
            raise ValueError(
                "speculative decoding requires the dense family "
                "(the drafter is a VUSA pack of the same weights)"
            )
        self.mesh = mesh if math.prod(mesh_shape(mesh).values()) > 1 else None
        self.dp, self.tp = axis_size(self.mesh, "data"), axis_size(self.mesh, "model")
        # a rank packs only its own windows of each pack
        self._model_rank = axis_index(self.mesh, "model") if self.tp > 1 else None
        # the family's tensor-parallel plan; the model is built with this
        # rank's head counts and reads its SSM heads and RG-LRU channels from
        # the plan, so the attend and the caches hold them
        self.plan = serving_plan(cfg, self.mesh)
        self.model = build_model(local_config(cfg, self.plan), self.plan)
        # attention split by heads: each rank packs its heads' projections
        self._split_heads = self.plan is not None and self.plan.heads and self.tp > 1
        self.params = self._place(params)
        self._quarantined = False
        self._packed = (self._build_pack(self.sc.faults)
                        if self.sc.packed_weights else None)
        self._draft_packed = self._build_draft_pack() if self.sc.speculative else None
        self._graphs: Dict[tuple, _Graph] = {}
        # replays x captured launches of graphs dropped by a pack swap, so
        # ``graph_launches`` stays the engine's lifetime count
        self._dropped_launches: Dict[str, Dict[str, int]] = {}

    def _rows(self, n: int) -> Optional[slice]:
        """This rank's rows of a batch (or pool) of ``n`` rows where the
        batch rule (``dist.sharding.batch_sharding``, the reference's cache
        and batch placements) splits them over ``data``: its size divides
        ``n``; None when every rank holds all ``n``."""
        if self.mesh is None:
            return None
        from ..dist.sharding import batch_sharding

        if batch_sharding(self.mesh, n, 1)[0] is None:
            return None
        r, k = axis_index(self.mesh, "data"), n // self.dp
        return slice(r * k, (r + 1) * k)

    def _place(self, params: dict) -> dict:
        """``params`` stored on the engine's device: whole, or under a plan
        this rank's shards (``dist.tp.place_params``)."""
        if self.plan is None:
            return _to(params, self.device)
        return place_params(params, build_model(self.cfg).specs(), self.plan.placements,
                            self.mesh, self.device)

    def _whole_params(self, transform: Optional[Callable] = None):
        """The parameters as the pack builders read them under a plan: a
        view that gathers each leaf whole on access (``transform(path,
        leaf)`` applied), one leaf at a time; the tree itself without."""
        if self.plan is None:
            return self.params
        return WholeView(self.params, self.plan.placements, self.mesh, transform)

    @property
    def steps_span_data(self) -> bool:
        """Whether every step is a collective over ``data`` (a plan on a
        data axis gathers leaves there): every data rank must run each
        step, a prefill chunk too, even one whose slot it does not own."""
        return self.plan is not None and self.dp > 1

    @property
    def dense_param_bytes(self) -> int:
        """Bytes of the dense parameters this rank stores."""
        return tree_bytes(self.params)

    def _whole(self, t: torch.Tensor, rows: Optional[slice]) -> torch.Tensor:
        """A tensor of this rank's rows gathered whole over ``data``."""
        return t if rows is None else all_gather(t, self.mesh, "data", dim=0)

    def _build_pack(self, faults: Optional[FaultConfig] = None) -> Dict:
        """The verifier's pack of the engine's parameters per the
        ServeConfig, with the fault plan's corruption: position flips land
        *before* validation, so a corrupt metadata byte makes the Engine
        refuse the pack here; value NaNs land *after* it, the post-load
        corruption only the run-time guard can catch.  Used at init and by
        ``reload_packed``."""
        from .packed import pack_lm_weights, validate_packed

        packed = pack_lm_weights(
            self.cfg, self._whole_params(), self.sc.vusa_m, self.sc.vusa_a,
            scope=self.sc.packed_weights,
            fused_mlp=self.sc.fused_mlp,
            value_dtype="dense" if self.sc.packed_values == "bf16" else self.sc.packed_values,
            shards=self.tp, rank=self._model_rank, split_heads=self._split_heads,
        )
        f = faults
        if f is not None and (f.pack_position_flips or f.pack_value_nans):
            from .faults import corrupt_pack_positions, corrupt_pack_values

            packed = corrupt_pack_positions(packed, f)
            validate_packed(packed)
            packed = corrupt_pack_values(packed, f)
        return packed

    def _build_draft_pack(self) -> Dict:
        """The drafter: the same weights magnitude-pruned at
        ``draft_sparsity`` and packed whole (scope "all"), a fraction of the
        verifier's bytes.  Values stay unquantized: the drafter's precision
        moves only the acceptance rate, never a token, since every emitted
        token comes out of the verifier.  ``pack_lm_weights`` validates the
        pack; a drafter that cannot be built raises."""
        from ..core.pruning import _prunable, prune, prune_tree
        from .packed import pack_lm_weights

        s = self.sc.draft_sparsity
        if self.plan is None:
            pruned = prune_tree(self.params, s)
        else:  # each leaf pruned whole as it is gathered
            pruned = self._whole_params(lambda path, w: prune(w, s) if _prunable(path, w) else w)
        return pack_lm_weights(
            self.cfg, pruned, self.sc.vusa_m,
            self.sc.vusa_a, scope="all", fused_mlp=self.sc.fused_mlp, value_dtype="dense",
            shards=self.tp, rank=self._model_rank, split_heads=self._split_heads,
        )

    @property
    def packed(self) -> Optional[Dict]:
        return self._packed

    @property
    def draft_packed(self) -> Optional[Dict]:
        return self._draft_packed

    # -- integrity / degradation ----------------------------------------------
    @property
    def quarantined(self) -> bool:
        return self._quarantined

    @property
    def packed_active(self) -> bool:
        """True while decode runs through the packed path."""
        return self._packed is not None and not self._quarantined

    def quarantine_packed(self) -> bool:
        """Drop the packed path for good (the scheduler calls this when a
        slot trips the guard under packed weights: the corrupt bytes may be
        anywhere in the pack).  The dense weights are always resident, so
        the dense path needs no reload, and the pools' dense graphs were
        captured with the packed ones.  True if the engine switched."""
        if not self.packed_active:
            return False
        self._quarantined = True
        return True

    def reload_packed(self, params=None) -> bool:
        """Hot-swap the packed path: rebuild the pack from ``params``
        (default: the engine's own, e.g. to re-arm the packed path after a
        quarantine), validate it, clear any quarantine, and drop every
        captured graph (they hold the old pack's and params' addresses; the
        next ``prepare_pool`` or ``generate`` captures afresh).  No fault
        corruption is applied to a swapped-in pack; the run-time guard still
        covers it.  The drafter keeps its pack: its precision moves only the
        acceptance rate.  The caller makes sure nothing is in flight (the
        streaming front end drains first).  False when the engine serves no
        pack."""
        if not self.sc.packed_weights:
            return False
        from .packed import validate_packed

        if params is not None:
            self.params = self._place(params)
        packed = self._build_pack()
        validate_packed(packed)
        self._packed = packed
        self._quarantined = False
        self._drop_graphs()
        self._sync()
        return True

    def _route_pack(self, dense: Optional[bool] = None) -> Optional[Dict]:
        """The pack a step verifies through: None (the dense path) when
        ``dense``, or, with ``dense`` None, when the pack is quarantined or
        there is none."""
        if dense is None:
            dense = self._quarantined
        return None if dense else self._packed

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _layer_collectives(self, dense: bool) -> bool:
        """Whether a decode step on the dense route (``dense``) or the pack
        makes a collective between its embedding and its logits: on a
        ``model`` axis always; on a data axis under a plan when it reads a
        dense leaf stored on ``data`` (the dense route, a partial pack, or
        a dense head), never for a full pack."""
        if self.tp > 1:
            return True
        if self.plan is None:
            return False
        from .packed import _full_pack

        return dense or self._packed is None or not _full_pack(self._packed)

    def _graphed(self, dense: Optional[bool] = None) -> bool:
        """CUDA graphs: ``fused`` on a card, and no collective inside the
        step's layers on its route (``dense``; default the route the engine
        is on): gloo's cannot be captured."""
        if dense is None:
            dense = self._route_pack() is None
        return (self.sc.fused and self.device.type == "cuda"
                and not self._layer_collectives(dense))

    def _spec_graphed(self) -> bool:
        """A captured speculative round: as ``_graphed``, and no plan (under
        one each drafter step's embedding makes a collective)."""
        return self._graphed() and self.plan is None

    def _context(self, split: bool = False):
        """``mesh_context`` of the engine's mesh and plan; ``split``: the
        call's rows are this rank's of a batch cut over ``data``."""
        return mesh_context(self.mesh, self.plan, (self.mesh, ("data",)) if split else None)

    def _embed(self, token: torch.Tensor) -> torch.Tensor:
        """The embedding rows of ``token`` (a captured step's ``pre``)."""
        with self._context():
            return _embed_tokens(self.params, token, self.model.cfg)

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
    def _logits(self, token, cache, packed, rowwise: bool = False, x=None,
                split: bool = False) -> torch.Tensor:
        """(B, s, V) logits of ``token`` (B, s) through ``packed`` (dense
        when None); advances the cache in place.  ``rowwise``: row b bitwise
        a B = 1 step (``families.lm_decode_step``); ``x``: the embedding
        rows, made before a replay; ``split``: ``token`` holds this rank's
        rows of a batch cut over ``data``."""
        with self._context(split):
            if packed is not None:
                from .packed import lm_decode_step_packed

                return lm_decode_step_packed(self.params, packed, token, cache, self.model.cfg,
                                             rowwise=rowwise, mesh=self.mesh, x=x)[0]
            return self.model.decode_step(self.params, token, cache, rowwise=rowwise, x=x)[0]

    def _choose(self, logits, noise, at) -> torch.Tensor:
        """Token ids (R,) from fp32 ``logits`` (R, V): argmax, or with a
        temperature the Gumbel-max draw ``argmax(logits / T + noise)`` whose
        noise rows are the table's rows ``at``, reshaped to (R, V); never a
        padding id (``choose_tokens``)."""
        g = None
        if self.sc.temperature > 0:
            g = noise.index_select(0, at).reshape(logits.shape)
        return choose_tokens(logits, self.cfg.vocab, self.sc.temperature, g)

    @staticmethod
    def _feed(st) -> torch.Tensor:
        """The input tokens of this rank's rows."""
        return st.token if st.rows is None else st.token[st.rows]

    def _step(self, st: _Loop) -> None:
        """One decode step on ``st``: the token at ``st.count`` and its
        integrity flag (``isfinite`` over the fp32 logits) written to the
        outputs, the token fed back, the count and ``pos`` advanced."""
        self._emit(st, self._logits(self._feed(st), st.cache, self._route_pack(),
                                    split=st.rows is not None)[:, -1].float())

    def _step_logits(self, st: _Loop) -> None:
        """The captured part of a step on a mesh: this rank's logits, from
        the static embedding rows ``st.x`` when the engine has a plan, into
        the static ``st.logits``."""
        st.logits.copy_(self._logits(self._feed(st), st.cache, self._route_pack(), x=st.x,
                                     split=st.rows is not None)[:, -1].float())

    def _emit(self, st: _Loop, logits: torch.Tensor) -> None:
        """The rest of a step from this rank's (rows, V) fp32 logits: the
        logits gathered whole over ``data``, every row's token chosen,
        token and flag written at ``st.count``, the token fed back and the
        count advanced."""
        logits = self._whole(logits, st.rows)
        at = st.count.view(1)
        nxt = self._choose(logits, st.noise, at)[:, None]
        st.toks.index_copy_(1, at, nxt)
        st.oks.index_copy_(1, at, torch.isfinite(logits).all(dim=-1)[:, None])
        st.token.copy_(nxt)
        st.count.add_(1)

    def _spec_round(self, st: _SpecLoop) -> None:
        """One draft/verify round at B = 1: ``draft_k`` greedy drafter steps,
        ``pos`` rewound, one verify of the (1, k + 1) sequence on the
        configured path, and the accept scan, all on the device.  Position i
        is emitted iff drafts 1..i all match the verifier's choices; the
        round emits ``nem`` tokens (1 <= nem <= k + 1), the last being the
        verifier's own choice past the matched prefix, which becomes the
        pending token.

        Bit-parity with plain decode holds by construction: the verify
        rewrites every K/V row the drafter wrote before attending, its
        logits equal the sequential steps' bitwise (multi-token decode), a
        rejected tail needs no rollback (``pos0 + nem`` masks it), and
        emitted token t draws noise row t, as plain decode does."""
        k = self.sc.draft_k
        cache = st.cache
        pos0 = cache["pos"].clone()
        tok, drafts = st.token, []
        for _ in range(k):
            lg = self._logits(tok, cache, self._draft_packed)
            tok = choose_tokens(lg[:, -1].float(), self.cfg.vocab)[:, None]
            drafts.append(tok)
        seq = torch.cat([st.token, *drafts], dim=1)  # (1, k + 1)
        cache["pos"].copy_(pos0)  # the verify rewrites rows pos0 .. pos0 + k
        logits = self._logits(seq, cache, self._route_pack())[0].float()  # (k + 1, V)
        at = st.count + torch.arange(k + 1, device=logits.device)
        v = self._choose(logits, st.noise, at)
        matched = (v[:k] == seq[0, 1:]).int().cumprod(dim=0).bool()
        accept = torch.cat([torch.ones(1, dtype=torch.bool, device=v.device), matched])
        nem = accept.sum()
        st.buf.index_copy_(0, at, torch.where(accept, v, 0))
        st.okb.index_copy_(0, at, torch.isfinite(logits).all(dim=-1))
        cache["pos"].copy_(pos0 + nem)
        st.token.copy_(v.index_select(0, nem.view(1) - 1).view(1, 1))
        st.count.add_(nem)
        st.rounds.add_(1)

    def _pool_step(self, st: _Pool, dense: Optional[bool] = None) -> None:
        """One decode step of every slot of a scheduler's pool.  Row b is
        bitwise a B = 1 step on slot b's own cache row: the step runs
        ``rowwise`` (the norms' means, the attend's products and sum and the
        dense products one row at a time; the packed kernels on all rows,
        their row b independent of B), and slot
        b draws its noise row ``count[b]`` from its own table, as one-shot
        ``generate`` at B = 1 does.  Free slots decode along with the pool:
        their positions and counts drift, their writes land past the cache
        (dropped) or in their scratch blocks, and their count is clamped to
        the noise table, all without a host sync.  ``dense`` as in
        ``_route_pack``."""
        self._pool_emit(st, self._pool_logits(st, dense))

    def _pool_logits(self, st: _Pool, dense: Optional[bool], x=None) -> torch.Tensor:
        """The (rows, V) fp32 logits of a pool step on this rank's slots
        (``x``: the embedding rows made before a replay)."""
        from ..models.cache import paged_view

        cache = paged_view(st.cache) if st.paged else st.cache
        return self._logits(self._feed(st), cache, self._route_pack(dense), rowwise=True,
                            x=x)[:, -1].float()

    def _pool_emit(self, st: _Pool, logits: torch.Tensor) -> None:
        """The rest of a pool step from this rank's logits, as ``_emit``:
        gathered whole over ``data``, every slot's token chosen from its own
        noise row, written at ``st.col``, fed back, counts advanced."""
        logits = self._whole(logits, st.rows)
        g = None
        if self.sc.temperature > 0:
            rows = torch.arange(logits.shape[0], device=logits.device)
            g = st.noise[rows, st.count.clamp(max=st.noise.shape[1] - 1)]
        nxt = choose_tokens(logits, self.cfg.vocab, self.sc.temperature, g)
        at = st.col.view(1)
        st.toks.index_copy_(1, at, nxt[:, None])
        st.oks.index_copy_(1, at, torch.isfinite(logits).all(dim=-1)[:, None])
        st.token.copy_(nxt[:, None])
        st.count.add_(1)
        st.col.add_(1)

    def _pool_spec_round(self, st: _Pool, dense: Optional[bool] = None) -> None:
        """One speculative round of every slot of a scheduler's pool: the
        pool twin of ``_spec_round``.  ``draft_k`` drafter steps on all
        slots, each slot's ``pos`` rewound to its own round start, one
        verify of the (slots, draft_k + 1) tokens through the verifier
        (``dense`` as in ``_route_pack``), the accept scan per slot, and
        ``pos += nem`` per slot.  Everything runs ``rowwise`` as
        ``_pool_step`` does (the packed kernels on all slots x (draft_k +
        1) rows at once, their rows independent of the row count), and slot
        b draws its noise rows ``count[b] + arange(draft_k + 1)`` from its
        own table, so row b is bitwise a B = 1 ``_spec_round`` on slot b's
        cache row.  The round's tokens (rejected positions 0), flags and
        emitted count land at column ``col`` of the outputs.  Free slots
        draft and verify along with the pool: their writes drop past the
        cache (slot pool) or land in their scratch blocks (paged), their
        noise index is clamped, with no host sync."""
        from ..models.cache import paged_view

        k = self.sc.draft_k
        cache = paged_view(st.cache) if st.paged else st.cache
        pos = st.cache["pos"]
        pos0 = pos.clone()
        tok0 = self._feed(st)
        tok, drafts = tok0, []
        for _ in range(k):
            lg = self._logits(tok, cache, self._draft_packed, rowwise=True)
            tok = choose_tokens(lg[:, -1].float(), self.cfg.vocab)[:, None]
            drafts.append(tok)
        seq = torch.cat([tok0, *drafts], dim=1)  # (slots, k + 1)
        pos.copy_(pos0)  # the verify rewrites rows pos0 .. pos0 + k of every slot
        logits = self._logits(seq, cache, self._route_pack(dense), rowwise=True).float()
        logits, seq = self._whole(logits, st.rows), self._whole(seq, st.rows)
        at = st.count[:, None] + torch.arange(k + 1, device=logits.device)  # (slots, k + 1)
        g = None
        if self.sc.temperature > 0:
            rows = torch.arange(logits.shape[0], device=logits.device)[:, None]
            g = st.noise[rows, at.clamp(max=st.noise.shape[1] - 1)]
        v = choose_tokens(logits, self.cfg.vocab, self.sc.temperature, g)
        matched = (v[:, :k] == seq[:, 1:]).int().cumprod(dim=1).bool()
        accept = torch.cat([torch.ones_like(matched[:, :1]), matched], dim=1)
        nem = accept.sum(dim=1)  # (slots,), 1 .. k + 1
        col = st.col.view(1)
        st.toks.index_copy_(1, col, torch.where(accept, v, 0)[:, None])
        st.oks.index_copy_(1, col, torch.isfinite(logits).all(dim=-1)[:, None])
        st.nems.index_copy_(1, col, nem[:, None])
        pos.copy_(pos0 + (nem if st.rows is None else nem[st.rows]))
        st.token.copy_(v.gather(1, nem[:, None] - 1))
        st.count.add_(nem)
        st.col.add_(1)

    # -- CUDA graphs ----------------------------------------------------------
    def _capture(self, body, state, emit: Optional[Callable] = None,
                 pre: Optional[Callable] = None) -> _Graph:
        """Run ``body(state)`` once on a side stream (the warm-up: cuBLAS
        handles, the kernels' shared-memory opt-in, the allocator), then
        capture it in a CUDA graph, with ``pre(state)`` and ``emit(state)``
        to run eagerly before and after each replay (``_replay``).  A
        failure raises."""
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body(state)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = _wrapper_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body(state)
        after = _wrapper_counts()
        launches = {name: {r: n - before[name][r] for r, n in routes.items()}
                    for name, routes in after.items()}
        return _Graph(graph, state, launches, emit=emit, pre=pre)

    @staticmethod
    def _replay(g: _Graph, n: int = 1) -> None:
        """``n`` replays of ``g``, each between its ``pre`` and its
        ``emit``."""
        for _ in range(n):
            if g.pre is not None:
                g.pre(g.state)
            g.graph.replay()
            if g.emit is not None:
                g.emit(g.state)
        g.replays += n

    def _noise_rows(self, n: int, b: int) -> Optional[torch.Tensor]:
        """A graph's static (n, b, V) noise table; None when greedy."""
        if self.sc.temperature <= 0:
            return None
        return torch.zeros((n, b, self.cfg.padded_vocab), dtype=torch.float32,
                           device=self.device)

    def _step_graph(self, b: int, frames: int = 0, rows: Optional[slice] = None) -> _Graph:
        """The captured decode step at batch ``b`` (built at first use), its
        outputs ``max_len`` tokens long; ``frames`` sizes the encdec
        family's cross K/V, so each frame count has its own graph.  With
        ``rows`` (this rank's rows of ``b`` on a data axis) the graph holds
        the step up to the logits, and the gather and the choice run after
        each replay; with a plan (a data axis) the embedding rows are made
        before each replay, since their lookup makes a collective."""
        span = None if rows is None else (rows.start, rows.stop)
        key = ("step", b, self.sc.temperature > 0, self.sc.max_len, frames, self._quarantined,
               span)
        if key not in self._graphs:
            n, dev = self.sc.max_len, self.device
            local = b if rows is None else rows.stop - rows.start
            st = _Loop(
                token=torch.zeros((b, 1), dtype=torch.long, device=dev),
                cache=self.model.init_cache(local, self.sc.max_len, device=dev, frames=frames),
                count=torch.zeros((), dtype=torch.long, device=dev),
                toks=torch.zeros((b, n), dtype=torch.long, device=dev),
                oks=torch.ones((b, n), dtype=torch.bool, device=dev),
                noise=self._noise_rows(n, b),
                rows=rows,
            )
            if rows is None and self.plan is None:
                self._graphs[key] = self._capture(self._step, st)
            else:
                st.logits = torch.zeros((local, self.cfg.padded_vocab), dtype=torch.float32,
                                        device=dev)
                pre = self._embed_pre(st, local)
                self._graphs[key] = self._capture(self._step_logits, st,
                                                  lambda s: self._emit(s, s.logits), pre)
        return self._graphs[key]

    def _embed_pre(self, st, rows: int) -> Optional[Callable]:
        """With a plan: ``st.x``, the static (rows, 1, d) embedding rows, and
        the ``pre`` that fills it from the step's input tokens; else None."""
        if self.plan is None:
            return None
        if st.x is None:  # one buffer for every graph of the state (a pool's two routes)
            st.x = torch.zeros((rows, 1, self.cfg.d_model), dtype=act_dtype(self.cfg),
                               device=self.device)
        return lambda s: s.x.copy_(self._embed(self._feed(s)))

    def _prime_step(self, st: _Loop) -> None:
        """One priming step of a recurrent family: the prompt token in
        ``st.token`` through a dense decode step, its greedy choice written
        to the (B, 1) output."""
        logits = self.model.decode_step(self.params, st.token, st.cache)[0][:, -1].float()
        st.toks.copy_(choose_tokens(logits, self.cfg.vocab)[:, None])

    def _prime_graph(self, b: int) -> _Graph:
        """The captured priming step at batch ``b`` (built at first use)."""
        key = ("prime", b, self.sc.max_len)
        if key not in self._graphs:
            dev = self.device
            st = _Loop(
                token=torch.zeros((b, 1), dtype=torch.long, device=dev),
                cache=self.model.init_cache(b, self.sc.max_len, device=dev),
                count=torch.zeros((), dtype=torch.long, device=dev),
                toks=torch.zeros((b, 1), dtype=torch.long, device=dev),
                oks=torch.ones((b, 1), dtype=torch.bool, device=dev),
                noise=None,
            )
            self._graphs[key] = self._capture(self._prime_step, st)
        return self._graphs[key]

    def _spec_graph(self) -> _Graph:
        """The captured speculative round at B = 1 (built at first use)."""
        key = ("spec", 1, self.sc.temperature > 0, self.sc.max_len, self._quarantined)
        if key not in self._graphs:
            n, dev = self.sc.max_len + self.sc.draft_k + 1, self.device
            st = _SpecLoop(
                token=torch.zeros((1, 1), dtype=torch.long, device=dev),
                cache=self.model.init_cache(1, self.sc.max_len, device=dev),
                count=torch.zeros((), dtype=torch.long, device=dev),
                rounds=torch.zeros((), dtype=torch.long, device=dev),
                buf=torch.zeros((n,), dtype=torch.long, device=dev),
                okb=torch.ones((n,), dtype=torch.bool, device=dev),
                noise=self._noise_rows(n, 1),
            )
            self._graphs[key] = self._capture(self._spec_round, st)
        return self._graphs[key]

    def new_pool(self, slots: int, segment: int, layout=None, spec: bool = False) -> _Pool:
        """A scheduler's pool state: the slot pool, or with ``layout``
        (``models.cache.PagedLayout``) the paged pool, every slot free;
        ``spec`` sizes the outputs for speculative rounds.  On a data axis
        that divides ``slots`` the cache holds this rank's slots (the paged
        layout's ``shards`` must then be the axis size, and the arena holds
        this rank's blocks), and the tokens, counts and outputs stay whole."""
        dev, n = self.device, self.sc.max_len
        rows = self._rows(slots)
        local = slots if rows is None else rows.stop - rows.start
        if layout is None:
            cache = self.model.init_slot_cache(local, n, device=dev)
        else:
            if layout.shards != (1 if rows is None else self.dp):
                raise ValueError(f"paged layout split over {layout.shards} ranks, the pool's "
                                 f"slots over {1 if rows is None else self.dp}")
            cache = self.model.init_paged_pool(layout.local(), n, device=dev)
        grid = (slots, segment, self.sc.draft_k + 1) if spec else (slots, segment)
        logits = None
        if (rows is not None or self.plan is not None) and not spec:
            logits = torch.zeros((local, self.cfg.padded_vocab), dtype=torch.float32, device=dev)
        return _Pool(
            token=torch.zeros((slots, 1), dtype=torch.long, device=dev), cache=cache,
            paged=layout is not None,
            count=torch.zeros((slots,), dtype=torch.long, device=dev),
            col=torch.zeros((), dtype=torch.long, device=dev),
            toks=torch.zeros(grid, dtype=torch.long, device=dev),
            oks=torch.ones(grid, dtype=torch.bool, device=dev),
            spec=spec,
            nems=torch.zeros((slots, segment), dtype=torch.long, device=dev) if spec else None,
            rows=rows, logits=logits,
        )

    def _pool_body(self, st: _Pool, dense: bool):
        if st.spec:
            return lambda s: self._pool_spec_round(s, dense)
        return lambda s: self._pool_step(s, dense)

    def _pool_key(self, st: _Pool, dense: bool) -> tuple:
        return ("pool", id(st), self.sc.temperature, dense)

    def _pool_graphed(self, st: _Pool, dense: bool) -> bool:
        """Whether the pool replays a graph on the route ``dense``: as
        ``_graphed``, but a speculative pool on a data axis runs eagerly
        (its gather sits between the drafter and the accept scan, and under
        a plan each drafter step's embedding makes a collective)."""
        return self._graphed(dense) and not (
            st.spec and (st.rows is not None or self.plan is not None))

    def _capture_pool(self, st: _Pool, dense: bool) -> _Graph:
        if st.rows is None and self.plan is None:
            return self._capture(self._pool_body(st, dense), st)
        pre = self._embed_pre(st, st.logits.shape[0])
        return self._capture(lambda s: s.logits.copy_(self._pool_logits(s, dense, s.x)), st,
                             lambda s: self._pool_emit(s, s.logits), pre)

    def prepare_pool(self, st: _Pool) -> None:
        """Make the pool ready for this temperature: the noise table when
        sampling and, with ``fused`` on a CUDA device, the pool step (or
        speculative round) captured in a CUDA graph, one per pool,
        temperature and verifier route: the packed one and its dense twin,
        which a quarantine switches to mid-run.  A capture's warm-up runs
        one step, so call this while every slot is free (the scheduler does,
        at the start of each run)."""
        if self.sc.temperature > 0 and st.noise is None:
            st.noise = torch.zeros((st.token.shape[0], self.sc.max_len, self.cfg.padded_vocab),
                                   dtype=torch.float32, device=self.device)
        routes = (True,) if self._packed is None or self._quarantined else (False, True)
        routes = [dense for dense in routes if self._pool_graphed(st, dense)]
        if not routes:
            return
        # the warm-up writes the outputs at ``col``: after a run it stands at
        # ``segment``, one past the grid (a recapture after a pack swap)
        st.col.zero_()
        with torch.no_grad():
            for dense in routes:
                key = self._pool_key(st, dense)
                if key not in self._graphs:
                    self._graphs[key] = self._capture_pool(st, dense)

    def release_pool(self, st: _Pool) -> None:
        """Drop the pool's captured graphs (the next ``prepare_pool``
        captures afresh)."""
        self._drop_graphs([key for key in self._graphs if key[:2] == ("pool", id(st))])

    @torch.no_grad()
    def pool_segment(self, st: _Pool) -> torch.Tensor:
        """``segment`` steps (or speculative rounds) of the whole pool with
        no host sync, on the verifier route the engine is on: replays of the
        captured graph with ``fused`` on a CUDA device, else the step run
        eagerly.  Returns, for the one fetch of the segment sync, the (2,
        slots, segment) device tensor of the segment's tokens and integrity
        flags or, speculative, the (slots, segment, 2 (draft_k + 1) + 1)
        tensor of the round tokens, the round flags and the emitted
        counts."""
        st.col.zero_()
        segment = st.toks.shape[1]
        dense = self._packed is None or self._quarantined
        if self._pool_graphed(st, dense):
            g = self._graphs.get(self._pool_key(st, dense))
            if g is None:
                raise RuntimeError("the pool's graph was not captured: call prepare_pool while "
                                   "every slot is free")
            self._replay(g, segment)
        else:
            body = self._pool_body(st, dense)
            for _ in range(segment):
                body(st)
        if st.spec:
            return torch.cat([st.toks, st.oks.long(), st.nems[..., None]], dim=2)
        return torch.stack([st.toks, st.oks.long()])

    @staticmethod
    def _add_launches(out: Dict[str, Dict[str, int]], name: str, routes: Dict[str, int],
                      times: int = 1) -> None:
        acc = out.setdefault(name, dict.fromkeys(routes, 0))
        for route, n in routes.items():
            acc[route] = acc.get(route, 0) + n * times

    def _drop_graphs(self, keys=None) -> None:
        """Drop the captured graphs ``keys`` (default: all), keeping their
        launches in ``graph_launches``."""
        for key in list(self._graphs) if keys is None else keys:
            g = self._graphs.pop(key)
            for name, routes in g.launches.items():
                self._add_launches(self._dropped_launches, name, routes, g.replays)

    def graph_launches(self) -> Dict[str, Dict[str, int]]:
        """Kernel launches the graph replays made since the engine was built,
        by wrapper and route: replays times the launches captured in one
        replay.  The wrappers' own counts see the capture, not the
        replays."""
        out: Dict[str, Dict[str, int]] = {}
        for name, routes in self._dropped_launches.items():
            self._add_launches(out, name, routes)
        for g in self._graphs.values():
            for name, routes in g.launches.items():
                self._add_launches(out, name, routes, g.replays)
        return out

    @staticmethod
    def _load(st, token, cache, noise) -> None:
        """Copy a segment's inputs into a graph's static state."""
        st.token.copy_(token)
        for name, leaf in st.cache.items():
            if leaf is not cache[name]:
                leaf.copy_(cache[name])
        st.count.zero_()
        if noise is not None:
            st.noise[: noise.shape[0]].copy_(noise)

    # -- reusable entry points ------------------------------------------------
    def gumbel_noise(self, n: int, b: int, seed: Optional[int] = None) -> Optional[torch.Tensor]:
        """The (n, b, V) Gumbel noise of emitted tokens 0..n-1, one (b, V)
        draw each from a generator seeded by ``seed`` (default
        ``ServeConfig.seed``), so row t depends on the seed and t alone;
        None when greedy.  The scheduler draws a request's rows at b = 1
        with the request's seed: the rows one-shot ``generate`` draws."""
        if self.sc.temperature <= 0:
            return None
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.sc.seed if seed is None else seed)
        shape = (b, self.cfg.padded_vocab)
        u = torch.stack([torch.rand(shape, generator=gen, device=self.device)
                         for _ in range(n)]) if n else torch.empty((0, *shape), device=self.device)
        return -torch.log(-torch.log(u))

    @torch.no_grad()
    def prime(self, prompts, extras: Optional[Dict] = None, split: bool = False):
        """Prefill ``prompts`` (B, S) and bulk-fill the KV cache.  Returns
        ``(first_token (B, 1), cache)``; the first token is the prefill
        logits' argmax, as in the reference.  ``extras`` are further batch
        inputs (the vlm family's ``patches`` (B, P, d), the encdec family's
        ``frames`` (B, F, d)), moved to the engine's device.

        The encdec family's prefill encodes the frames and fills the cross
        K/V; it drops the prompt, as the reference does: zero logits, so
        the first token is 0, and decode starts at ``pos`` 0 (ROADMAP C12).
        The recurrent families (hybrid, ssm) have no prefill: the prompt
        runs through decode steps (:meth:`_prime_recurrent`).  ``split``:
        ``prompts`` are this rank's rows of a batch cut over ``data``
        (``generate``; the moe routing then counts over the whole batch)."""
        prompts = np.asarray(prompts)
        if self.cfg.family in RECURRENT_FAMILIES:
            return self._prime_recurrent(prompts, split)
        if prompts.shape[1] > self.sc.max_len:
            raise ValueError(f"prompt length {prompts.shape[1]} exceeds max_len {self.sc.max_len}")
        self._validate_tokens(prompts)
        batch = {"tokens": torch.as_tensor(prompts, dtype=torch.long, device=self.device)}
        for name, val in (extras or {}).items():
            batch[name] = torch.as_tensor(np.asarray(val), device=self.device)
        with self._context(split):
            logits, cache = self.model.prefill(self.params, batch, self.sc.max_len)
        return choose_tokens(logits.float(), self.cfg.vocab)[:, None], cache

    def _prime_recurrent(self, prompts: np.ndarray, split: bool = False):
        """Prime a recurrent family's state by running the prompt through
        dense decode steps from a zero cache, as the reference does; with
        ``fused`` on a CUDA device the step is a captured graph replayed
        once per prompt token.  The first token is the greedy choice of the
        last prompt step's logits, with a temperature too: the rule of the
        prefill families, whose first token is the prefill's argmax, so a
        request primed alone in the scheduler draws what one-shot
        ``generate`` at B = 1 draws.  (The reference samples that token
        with its key; sampled tokens cannot match across frameworks, C3.)
        A ring cache wraps, so the prompt may be longer than ``max_len``.
        Under a plan the steps run eagerly in the engine's context
        (``split``: this rank's rows of a batch cut over ``data``)."""
        if prompts.ndim != 2 or prompts.shape[1] < 1:
            raise ValueError(f"prompts must be (B, S) with S >= 1, got {prompts.shape}")
        self._validate_tokens(prompts)
        toks = torch.as_tensor(prompts, dtype=torch.long, device=self.device)
        b, s = toks.shape
        if self._graphed():
            g = self._prime_graph(b)
            st = g.state
            for leaf in st.cache.values():
                leaf.zero_()
            for t in range(s):
                st.token.copy_(toks[:, t : t + 1])
                g.graph.replay()
            g.replays += s
            return st.toks.clone(), {name: leaf.clone() for name, leaf in st.cache.items()}
        cache = self.model.init_cache(b, self.sc.max_len, device=self.device)
        with self._context(split):
            for t in range(s):
                logits = self.model.decode_step(self.params, toks[:, t : t + 1], cache)[0]
        return choose_tokens(logits[:, -1].float(), self.cfg.vocab)[:, None], cache

    @torch.no_grad()
    def prime_many(self, prompts, lengths):
        """Batched masked prefill of one length bucket: ``prompts`` (N, Sb)
        right-padded to a shared bucket length, ``lengths`` (N,) true prompt
        lengths.  Returns ``(first_tokens (N, 1), batched cache)``; the
        cache's ``pos`` holds the padded bucket length (``write_slots`` sets
        each slot's true one).  Each row is ``prime`` of its unpadded prompt
        to within rounding, not bitwise: a GEMM over N * Sb rows sums in
        another order than one over the prompt's own rows (ROADMAP C9).
        Families without batched prefill (``batched_prefill``) raise."""
        if not self.batched_prefill:
            raise NotImplementedError(
                f"batched masked prefill unsupported for family {self.cfg.family!r} "
                f"(moe: only when dropless, moe_cf >= n_experts / top_k)")
        prompts = np.asarray(prompts, np.int32)
        if prompts.shape[1] > self.sc.max_len:
            raise ValueError(
                f"bucket length {prompts.shape[1]} exceeds max_len {self.sc.max_len}"
            )
        self._validate_tokens(prompts)
        tokens = torch.as_tensor(prompts, dtype=torch.long, device=self.device)
        lens = torch.as_tensor(np.asarray(lengths, np.int64), device=self.device)
        with self._context():
            logits, cache = self.model.prefill(self.params, {"tokens": tokens}, self.sc.max_len,
                                               lengths=lens)
        return choose_tokens(logits.float(), self.cfg.vocab)[:, None], cache

    @torch.no_grad()
    def prefill_chunk(self, tokens, arena, table_row, start: int, true_len: int,
                      write_from: int):
        """One chunk of a paged chunked prefill at B = 1
        (``families.lm_prefill_chunk``): writes ``arena`` in place and
        returns ``(logits (1, V), arena)``."""
        self._validate_tokens(tokens)
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=self.device)
        table = torch.as_tensor(np.asarray(table_row, np.int64), device=self.device)
        with self._context():
            return self.model.prefill_chunk(self.params, toks, arena, table, int(start),
                                            int(true_len), int(write_from))

    # -- prompt-length buckets -------------------------------------------------
    @staticmethod
    def _make_buckets(sc: ServeConfig) -> list:
        if sc.prefill_buckets:
            bks = sorted(set(int(b) for b in sc.prefill_buckets))
            if bks[0] < 1 or bks[-1] > sc.max_len:
                raise ValueError(f"prefill_buckets {bks} outside [1, max_len={sc.max_len}]")
            if bks[-1] < sc.max_len:
                # always cover max_len: a longer prompt maps to a bucket
                bks.append(sc.max_len)
            return bks
        bks, b = [], 8
        while b < sc.max_len:
            bks.append(b)
            b *= 2
        bks.append(sc.max_len)
        return bks

    @property
    def prefill_buckets(self) -> tuple:
        return tuple(self._make_buckets(self.sc))

    @property
    def batched_prefill(self) -> bool:
        """True when the family supports one-dispatch bucketed admission:
        the dense family, and the moe family when dropless (``moe_cf >=
        n_experts / top_k``), since capacity-bounded dispatch couples
        co-batched rows, padding included, as in the reference.  Other
        families admit one request at a time."""
        cfg = self.cfg
        return cfg.family == "dense" or (
            cfg.family == "moe" and cfg.moe_cf >= cfg.n_experts / cfg.top_k)

    @property
    def paged_supported(self) -> bool:
        """True when the family can serve from a paged KV pool: a KV-shaped
        cache and batched prefill (never the vlm family)."""
        return self.batched_prefill and self.model.paged_seq_len(self.sc.max_len) is not None

    def bucket_len(self, n: int) -> int:
        """Smallest configured bucket >= n (the bucket set always covers
        max_len, and prime/prime_many reject prompts past it)."""
        for b in self._make_buckets(self.sc):
            if b >= n:
                return b
        return n

    @torch.no_grad()
    def decode_segment(self, token, cache, steps: int, noise=None, rows=None):
        """``steps`` decode steps with no host sync: replays of the captured
        step with ``fused`` on a CUDA device, else the eager loop.  ``noise``
        (steps, B, V) is the Gumbel noise of the segment's tokens (drawn
        from the seed when sampling and not given).  Returns ``(tokens (B,
        steps), ok (B, steps), last_token, cache)``, all on the device; on
        the graph path the cache is the graph's static cache, valid until
        the next call.  The graph's outputs hold ``max_len`` tokens; a
        recurrent family, which may decode past ``max_len``, replays the
        one graph in chunks of at most that many steps.  ``rows``: this
        rank's rows of the batch on a data axis; ``token``, ``noise`` and the
        outputs are then whole and ``cache`` holds the rows."""
        b = token.shape[0]
        if noise is None:
            noise = self.gumbel_noise(steps, b)
        if self._graphed():
            g = self._step_graph(b, self._frames(cache), rows)
            st = g.state
            n = st.toks.shape[1]
            self._load(st, token, cache, None if noise is None else noise[:n])
            toks, oks = [st.toks[:, :0]], [st.oks[:, :0]]
            for c0 in range(0, steps, n):
                c = min(n, steps - c0)
                if c0:  # the token and state carry over in the graph's own buffers
                    st.count.zero_()
                    if noise is not None:
                        st.noise[:c].copy_(noise[c0 : c0 + c])
                self._replay(g, c)
                toks.append(st.toks[:, :c].clone())
                oks.append(st.oks[:, :c].clone())
            return torch.cat(toks, dim=1), torch.cat(oks, dim=1), st.token.clone(), st.cache
        st = _Loop(token.clone(), cache, torch.zeros((), dtype=torch.long, device=token.device),
                   torch.zeros((b, steps), dtype=torch.long, device=token.device),
                   torch.ones((b, steps), dtype=torch.bool, device=token.device), noise, rows)
        for _ in range(steps):
            self._step(st)
        return st.toks, st.oks, st.token, st.cache

    @staticmethod
    def _frames(cache: dict) -> int:
        """The encdec family's cross K/V rows in ``cache`` (0 for the
        others)."""
        return cache["xk"].shape[2] if "xk" in cache else 0

    @torch.no_grad()
    def _spec_decode(self, token, cache, budget: int, noise):
        """Speculative rounds at B = 1 until ``budget`` tokens are emitted:
        replays of the captured round with ``fused`` on a CUDA device, else
        the round run eagerly.  The host reads the emitted count once per
        batch of rounds, a batch being ceil(remaining / (k + 1)) rounds:
        however many each emits, no round of a batch starts past the budget,
        so no round runs that plain decode would not need.  Returns (emitted
        tokens (budget,), flags (budget,), count, rounds)."""
        s = self.sc.draft_k + 1
        if self._spec_graphed():
            g = self._spec_graph()
            st = g.state
            self._load(st, token, cache, noise)
            st.rounds.zero_()
            run = g.graph.replay
        else:
            n, dev = budget + s, token.device
            st = _SpecLoop(token.clone(), cache, torch.zeros((), dtype=torch.long, device=dev),
                           torch.zeros((), dtype=torch.long, device=dev),
                           torch.zeros((n,), dtype=torch.long, device=dev),
                           torch.ones((n,), dtype=torch.bool, device=dev), noise)
            g = None

            def run():
                self._spec_round(st)

        remaining = budget
        while remaining > 0:
            rounds = -(-remaining // s)
            for _ in range(rounds):
                run()
            if g is not None:
                g.replays += rounds
            remaining = budget - int(st.count)  # the one host read per batch of rounds
        return st.buf[:budget], st.okb[:budget], int(st.count), int(st.rounds)

    # -- public API -----------------------------------------------------------
    def generate(self, prompts, max_new: int = 32, extras: Optional[Dict] = None) -> Dict:
        """prompts: (B, S) int; ``extras`` further batch inputs for the
        prefill (the vlm family's ``patches``, the encdec family's
        ``frames``).  Returns ``{"tokens" (B,
        max_new) int32, "finite", "prefill_s", "decode_s", "tok_per_s"}``;
        ``tok_per_s`` is the accepted tokens beyond the first over decode
        wall time.  On a data axis that divides B each rank prefills and
        decodes its rows, and every rank returns every row's tokens.  With
        ``ServeConfig.speculative`` (B = 1 only) the result also holds
        ``spec_rounds``, ``spec_proposed``, ``spec_accepted`` and
        ``acceptance_rate``.  The noise table and, at first use, the CUDA
        graph are made before the decode clock starts.  The recurrent
        families' priming counts in ``prefill_s``, and their ``max_new``
        is not bounded by ``max_len``."""
        prompts = np.asarray(prompts)
        b = prompts.shape[0]
        spec = self.sc.speculative
        headroom = self.sc.draft_k if spec else 0
        patches = self.cfg.patch_tokens if self.cfg.family == "vlm" else 0
        rows = patches + prompts.shape[1] + max_new + headroom
        recurrent = self.cfg.family in RECURRENT_FAMILIES
        if rows > self.sc.max_len and not recurrent:
            # decode past max_len would run past the KV cache; a speculative
            # round writes up to draft_k rows past the budget; a vlm prompt
            # also caches its patch prefix.  A recurrent family has no such
            # bound: its state is O(1) and the hybrid's ring wraps.
            raise ValueError(
                f"patch rows({patches}) + prompt({prompts.shape[1]}) + max_new({max_new}) + "
                f"spec headroom({headroom}) = {rows} exceeds max_len {self.sc.max_len}"
            )
        if spec and b != 1:
            raise ValueError(
                f"speculative generate serves B=1 (got batch {b}); the accept length is "
                "per request"
            )
        budget = max_new - 1
        noise = self.gumbel_noise(budget + (self.sc.draft_k + 1 if spec else 0), b)
        rows = self._rows(b)
        graphed = self._spec_graphed() if spec else self._graphed()
        if graphed:  # capture at first use, outside the clocks
            with torch.no_grad():
                if spec:
                    self._spec_graph()
                else:
                    frames = np.shape((extras or {}).get("frames", ()))
                    self._step_graph(b, frames[1] if len(frames) == 3 else 0, rows)
                if recurrent:
                    self._prime_graph(b if rows is None else rows.stop - rows.start)
        if rows is not None:
            prompts = prompts[rows]
            extras = {k: np.asarray(v)[rows] for k, v in (extras or {}).items()}
        t0 = self._clock()
        nxt, cache = self.prime(prompts, extras, split=rows is not None)
        nxt = self._whole(nxt, rows)
        self._sync()
        t_prefill = self._clock() - t0

        t0 = self._clock()
        if spec:
            buf, okb, count, rounds = self._spec_decode(nxt, cache, budget, noise)
            toks, okg = buf[None], okb
        else:
            toks, okg, _, _ = self.decode_segment(nxt, cache, budget, noise, rows)
        tokens = torch.cat([nxt, toks], dim=1).cpu().numpy().astype(np.int32)  # the one fetch
        finite = bool(okg.all())
        t_decode = self._clock() - t0
        out = {
            "tokens": tokens,
            "finite": finite,
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "tok_per_s": tok_per_s(b * budget, t_decode),
        }
        if spec:
            k = self.sc.draft_k
            out.update(
                spec_rounds=rounds,
                spec_proposed=rounds * k,
                # each round emits the verifier's token plus its accepted drafts
                spec_accepted=count - rounds,
                acceptance_rate=acceptance_rate(count - rounds, rounds * k),
            )
        return out
