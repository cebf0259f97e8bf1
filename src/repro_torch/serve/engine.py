"""Serving engine: batched prefill + greedy / temperature decode, dense or
through VUSA-packed weights (``ServeConfig.packed_weights``), and
self-speculative decoding (``ServeConfig.speculative``).

Port of the one-shot part of the JAX package's ``serve/engine.py``.  The
reference fuses the decode loop into one ``lax.scan`` and the speculative
decode into one ``lax.while_loop``.  Here, with ``ServeConfig.fused`` (the
default) on a CUDA device, one decode step is captured in a CUDA graph
once per batch size and replayed once per token, and one speculative
round (``draft_k`` drafter steps, the verify, the accept scan) in another,
replayed round after round.  ``fused=False`` keeps the eager host loop as
the parity oracle, as the reference keeps its host loop.  On the CPU there
are no graphs: ``fused=True`` runs the same step eagerly.  A capture or
replay that fails raises; nothing falls back to the eager loop.

Nothing in a step waits for the device: the position is a device scalar
in the cache, each token is chosen on the device and feeds the next step,
the integrity flags (``isfinite`` over the fp32 logits) stay there, and
tokens and flags are fetched once at the end.  The speculative loop reads
its emitted count once per batch of rounds (``_spec_decode``).

Sampling is Gumbel-max over a noise table drawn once per ``generate`` from
a ``torch.Generator`` seeded by ``ServeConfig.seed``, one (B, V) draw per
emitted token, indexed on the device by the emitted-token count.  The noise
of token t depends on (seed, t) alone, so the graph and the eager loop,
and speculative and plain decode, draw the same tokens; the reference gets
the same property by splitting its key once per emitted token.  No random
state lives in a graph.
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
from .metrics import acceptance_rate, tok_per_s

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
    fused: bool = True  # CUDA-graph decode loop on the card (False = eager host loop)
    # self-speculative decoding: the same weights magnitude-pruned at
    # ``draft_sparsity`` and packed at scope "all" draft ``draft_k`` greedy
    # tokens a round; the configured path verifies them in one multi-token
    # step and the longest matching prefix is accepted.  Tokens are
    # bit-identical to plain decode, greedy and sampled.  B = 1 only.
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
class _Graph:
    """A captured CUDA graph, the static state it replays against, the
    wrapper launches captured in one replay (by wrapper and route) and the
    replays so far."""

    graph: torch.cuda.CUDAGraph
    state: object
    launches: Dict[str, Dict[str, int]]
    replays: int = 0


def _wrapper_counts() -> Dict[str, Dict[str, int]]:
    from ..kernels.vusa_packed import vusa_fused_mlp_matmul, vusa_packed_matmul

    return {"vusa_packed_matmul": dict(vusa_packed_matmul.launches),
            "vusa_fused_mlp_matmul": dict(vusa_fused_mlp_matmul.launches)}


class Engine:
    def __init__(
        self, cfg: ArchConfig, params: dict, sc: Optional[ServeConfig] = None,
        device="cuda",
    ):
        """``params``: the reference-layout parameter dict (moved to
        ``device``).  Switches TF32 off process-wide (``strict_fp32``): the
        dense path's fp32 products are true fp32, as in the reference.  The
        packs (the verifier's and, with ``speculative``, the drafter's) are
        built here; ``fused``, ``temperature`` and ``seed`` are read at each
        call."""
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
        self._draft_packed = self._build_draft_pack() if self.sc.speculative else None
        self._graphs: Dict[tuple, _Graph] = {}

    def _build_draft_pack(self) -> Dict:
        """The drafter: the same weights magnitude-pruned at
        ``draft_sparsity`` and packed whole (scope "all"), a fraction of the
        verifier's bytes.  Values stay unquantized: the drafter's precision
        moves only the acceptance rate, never a token, since every emitted
        token comes out of the verifier.  ``pack_lm_weights`` validates the
        pack; a drafter that cannot be built raises."""
        from ..core.pruning import prune_tree
        from .packed import pack_lm_weights

        return pack_lm_weights(
            self.cfg, prune_tree(self.params, self.sc.draft_sparsity), self.sc.vusa_m,
            self.sc.vusa_a, scope="all", fused_mlp=self.sc.fused_mlp, value_dtype="dense",
        )

    @property
    def packed(self) -> Optional[Dict]:
        return self._packed

    @property
    def draft_packed(self) -> Optional[Dict]:
        return self._draft_packed

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _graphed(self) -> bool:
        return self.sc.fused and self.device.type == "cuda"

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
    def _logits(self, token, cache, packed) -> torch.Tensor:
        """(B, s, V) logits of ``token`` (B, s) through ``packed`` (dense
        when None); advances the cache in place."""
        if packed is not None:
            from .packed import lm_decode_step_packed

            return lm_decode_step_packed(self.params, packed, token, cache, self.cfg)[0]
        return self.model.decode_step(self.params, token, cache)[0]

    def _choose(self, logits, noise, at) -> torch.Tensor:
        """Token ids (R,) from fp32 ``logits`` (R, V): argmax, or with a
        temperature the Gumbel-max draw ``argmax(logits / T + noise)`` whose
        noise rows are the table's rows ``at``, reshaped to (R, V)."""
        if self.sc.temperature > 0:
            g = noise.index_select(0, at).reshape(logits.shape)
            return torch.argmax(logits / self.sc.temperature + g, dim=-1)
        return torch.argmax(logits, dim=-1)

    def _step(self, st: _Loop) -> None:
        """One decode step on ``st``: the token at ``st.count`` and its
        integrity flag (``isfinite`` over the fp32 logits) written to the
        outputs, the token fed back, the count and ``pos`` advanced."""
        logits = self._logits(st.token, st.cache, self._packed)[:, -1].float()
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
            tok = torch.argmax(lg[:, -1].float(), dim=-1)[:, None]
            drafts.append(tok)
        seq = torch.cat([st.token, *drafts], dim=1)  # (1, k + 1)
        cache["pos"].copy_(pos0)  # the verify rewrites rows pos0 .. pos0 + k
        logits = self._logits(seq, cache, self._packed)[0].float()  # (k + 1, V)
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

    # -- CUDA graphs ----------------------------------------------------------
    def _capture(self, body, state) -> _Graph:
        """Run ``body(state)`` once on a side stream (the warm-up: cuBLAS
        handles, the kernels' shared-memory opt-in, the allocator), then
        capture it in a CUDA graph.  A failure raises."""
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
        return _Graph(graph, state, launches)

    def _noise_rows(self, n: int, b: int) -> Optional[torch.Tensor]:
        """A graph's static (n, b, V) noise table; None when greedy."""
        if self.sc.temperature <= 0:
            return None
        return torch.zeros((n, b, self.cfg.padded_vocab), dtype=torch.float32,
                           device=self.device)

    def _step_graph(self, b: int) -> _Graph:
        """The captured decode step at batch ``b`` (built at first use)."""
        key = ("step", b, self.sc.temperature > 0)
        if key not in self._graphs:
            n, dev = self.sc.max_len, self.device
            st = _Loop(
                token=torch.zeros((b, 1), dtype=torch.long, device=dev),
                cache=self.model.init_cache(b, n, device=dev),
                count=torch.zeros((), dtype=torch.long, device=dev),
                toks=torch.zeros((b, n), dtype=torch.long, device=dev),
                oks=torch.ones((b, n), dtype=torch.bool, device=dev),
                noise=self._noise_rows(n, b),
            )
            self._graphs[key] = self._capture(self._step, st)
        return self._graphs[key]

    def _spec_graph(self) -> _Graph:
        """The captured speculative round at B = 1 (built at first use)."""
        key = ("spec", 1, self.sc.temperature > 0)
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

    def graph_launches(self) -> Dict[str, Dict[str, int]]:
        """Kernel launches the graph replays made since the engine was built,
        by wrapper and route: replays times the launches captured in one
        replay.  The wrappers' own counts see the capture, not the
        replays."""
        out: Dict[str, Dict[str, int]] = {}
        for g in self._graphs.values():
            for name, routes in g.launches.items():
                acc = out.setdefault(name, dict.fromkeys(routes, 0))
                for route, n in routes.items():
                    acc[route] += n * g.replays
        return out

    @staticmethod
    def _load(st, token, cache, noise) -> None:
        """Copy a segment's inputs into a graph's static state."""
        st.token.copy_(token)
        for name in ("k", "v", "pos"):
            if st.cache[name] is not cache[name]:
                st.cache[name].copy_(cache[name])
        st.count.zero_()
        if noise is not None:
            st.noise[: noise.shape[0]].copy_(noise)

    # -- reusable entry points ------------------------------------------------
    def gumbel_noise(self, n: int, b: int) -> Optional[torch.Tensor]:
        """The (n, b, V) Gumbel noise of emitted tokens 0..n-1, one (b, V)
        draw each from a generator seeded by ``ServeConfig.seed``, so row t
        depends on the seed and t alone; None when greedy."""
        if self.sc.temperature <= 0:
            return None
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.sc.seed)
        shape = (b, self.cfg.padded_vocab)
        u = torch.stack([torch.rand(shape, generator=gen, device=self.device)
                         for _ in range(n)]) if n else torch.empty((0, *shape), device=self.device)
        return -torch.log(-torch.log(u))

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
    def decode_segment(self, token, cache, steps: int, noise=None):
        """``steps`` decode steps with no host sync: replays of the captured
        step with ``fused`` on a CUDA device, else the eager loop.  ``noise``
        (steps, B, V) is the Gumbel noise of the segment's tokens (drawn
        from the seed when sampling and not given).  Returns ``(tokens (B,
        steps), ok (B, steps), last_token, cache)``, all on the device; on
        the graph path the cache is the graph's static cache, valid until
        the next call."""
        b = token.shape[0]
        if noise is None:
            noise = self.gumbel_noise(steps, b)
        if self._graphed():
            g = self._step_graph(b)
            st = g.state
            self._load(st, token, cache, noise)
            for _ in range(steps):
                g.graph.replay()
            g.replays += steps
            return (st.toks[:, :steps].clone(), st.oks[:, :steps].clone(), st.token.clone(),
                    st.cache)
        st = _Loop(token.clone(), cache, torch.zeros((), dtype=torch.long, device=token.device),
                   torch.zeros((b, steps), dtype=torch.long, device=token.device),
                   torch.ones((b, steps), dtype=torch.bool, device=token.device), noise)
        for _ in range(steps):
            self._step(st)
        return st.toks, st.oks, st.token, st.cache

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
        if self._graphed():
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
    def generate(self, prompts, max_new: int = 32) -> Dict:
        """prompts: (B, S) int.  Returns ``{"tokens" (B, max_new) int32,
        "finite", "prefill_s", "decode_s", "tok_per_s"}``; ``tok_per_s`` is
        the accepted tokens beyond the first over decode wall time.  With
        ``ServeConfig.speculative`` (B = 1 only) the result also holds
        ``spec_rounds``, ``spec_proposed``, ``spec_accepted`` and
        ``acceptance_rate``.  The noise table and, at first use, the CUDA
        graph are made before the decode clock starts."""
        prompts = np.asarray(prompts)
        b = prompts.shape[0]
        spec = self.sc.speculative
        headroom = self.sc.draft_k if spec else 0
        if prompts.shape[1] + max_new + headroom > self.sc.max_len:
            # decode past max_len would run past the KV cache; a speculative
            # round writes up to draft_k rows past the budget
            raise ValueError(
                f"prompt({prompts.shape[1]}) + max_new({max_new}) + spec headroom({headroom}) "
                f"= {prompts.shape[1] + max_new + headroom} exceeds max_len {self.sc.max_len}"
            )
        if spec and b != 1:
            raise ValueError(
                f"speculative generate serves B=1 (got batch {b}); the accept length is "
                "per request"
            )
        budget = max_new - 1
        noise = self.gumbel_noise(budget + (self.sc.draft_k + 1 if spec else 0), b)
        if self._graphed():  # capture at first use, outside the clocks
            with torch.no_grad():
                if spec:
                    self._spec_graph()
                else:
                    self._step_graph(b)
        t0 = time.monotonic()
        nxt, cache = self.prime(prompts)
        self._sync()
        t_prefill = time.monotonic() - t0

        t0 = time.monotonic()
        if spec:
            buf, okb, count, rounds = self._spec_decode(nxt, cache, budget, noise)
            toks, okg = buf[None], okb
        else:
            toks, okg, _, _ = self.decode_segment(nxt, cache, budget, noise)
        tokens = torch.cat([nxt, toks], dim=1).cpu().numpy().astype(np.int32)  # the one fetch
        finite = bool(okg.all())
        t_decode = time.monotonic() - t0
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
