"""Slot-pool and paged-pool cache helpers for continuous-batching serving.

Port of the JAX package's ``models/cache.py``.  The reference keeps one
independent B = 1 cache per slot on a leading slot axis and steps them with
``jax.vmap``.  The port's packed kernels cannot be vmapped, so its slot pool
is *one* decode cache whose batch axis is the slot axis, with a (slots,)
``pos``: every row carries its own position, so slots sit at ragged
sequence positions and a retired slot is re-primed without touching its
neighbours.  The helpers act in place on that batch axis (a CUDA graph that
replays the pool step keeps reading the same tensors) and take its
position per leaf from :func:`batch_axes`, as the reference's do.

A decode cache is a *flat* ``{name: tensor}`` dict for every family.  The
reference's hybrid cache is nested (``groups/<p_i_kind>/{k,v | conv,h}``,
``tail/<t_i_kind>/...``, ``pos``); the port flattens it under the
``/``-joined path of each reference leaf, one to one, so every helper here
walks one level, each leaf at the batch axis :func:`batch_axes` finds.
An admission writes every leaf of the slot, so a recurrent state (``h``,
``state``, ``conv``), which no ``pos`` mask hides, is replaced whole.

The second half is the **paged pool**: fixed ``page``-row KV blocks in a
shared arena, per-slot block tables, and the host-side
:class:`BlockAllocator` with prefix-hash sharing (refcounts, a cached-free
LRU, copy-on-write of partial tail pages).  The allocator and the blake2b
digest chain are plain Python and numpy, copied from the reference.

Device state of a paged pool (``pstate``) is a plain dict::

    {"arena": {"k": (L, n_blocks, page, kvh, hd), "v": ...},   # shared blocks
     "table": (slots, n_pages) long,                           # block tables
     "pos":   (slots,) long}                                   # per-slot pos

Block 0 is the *null* block (always zero, never written), blocks
``1..slots`` are per-slot *scratch* blocks that absorb the writes of free
slots decoding along with the pool, and blocks ``slots+1..n_blocks-1`` are
the user pool the allocator manages.  ``n_blocks`` itself is the
out-of-range sentinel: every host-built index list here drops entries equal
to it.  ``page`` must divide ``max_len``, so a slot's gathered view is
exactly the (slots, max_len, ...) cache the slot pool holds; rows past a
slot's ``pos`` are masked by the same ``slots <= pos`` validity and add
exactly zero probability as long as they are finite, which zeroing freed
blocks guarantees.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = [
    "init_slot_cache",
    "slot_count",
    "slot_view",
    "read_slot",
    "write_slot",
    "write_slots",
    "batch_axes",
    "reset_slot",
    "poison_slot",
    # paged pool
    "PagedLayout",
    "BlockAllocator",
    "paged_seq_len",
    "init_paged_pool",
    "paged_view",
    "paged_gather",
    "paged_scatter_rows",
    "write_prefill_pages",
    "bind_slot_pages",
    "zero_blocks",
    "copy_block",
    "paged_read_slot",
    "paged_reset_slot",
    "paged_pool_bytes",
    "paged_block_bytes",
    "paged_host_mirror",
    "paged_poison_block",
    "prefix_page_digests",
    "prefix_tail_digests",
]

Specs = Dict[str, Tuple[tuple, torch.dtype]]  # {name: (shape, dtype)}, families.lm_cache_specs


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _index(ids, bound: int, device) -> Tuple[np.ndarray, torch.Tensor]:
    """The entries of ``ids`` below ``bound`` (out-of-range ones are
    padding and are dropped), as a mask into ``ids`` and a long tensor."""
    ids = np.asarray(ids, np.int64).reshape(-1)
    keep = (ids >= 0) & (ids < bound)
    return keep, torch.as_tensor(ids[keep], device=device)


# ==========================================================================
# Slot pool
# ==========================================================================


def init_slot_cache(cache_specs: Specs, device) -> dict:
    """Zero slot-pool cache from ``cache_specs`` taken at ``batch = slots``
    (``families.lm_cache_specs``): every row a free slot at position 0."""
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in cache_specs.items()}


def slot_count(slot_cache: dict) -> int:
    """Number of slots in a slot-pool cache: the length of its (slots,)
    ``pos``."""
    return slot_cache["pos"].shape[0]


def batch_axes(specs_b1: Specs, specs_b2: Specs) -> Dict[str, int]:
    """Each cache leaf's batch axis, family-agnostically: diff the specs for
    two batch sizes and record, per leaf, the one axis whose extent changed.
    This is what lets :func:`write_slots` scatter a *batched* prefill cache
    whose batch axis sits at a different position per leaf (axis 1 under the
    leading ``layers`` axis of K/V, axis 0 of ``pos``)."""
    out = {}
    for name, (s1, _) in specs_b1.items():
        s2 = specs_b2[name][0]
        diffs = [i for i, (a, b) in enumerate(zip(s1, s2)) if a != b]
        if len(diffs) != 1:
            raise ValueError(f"ambiguous batch axis at cache leaf {name!r}: axes {diffs} "
                             f"change between {s1} and {s2}")
        out[name] = diffs[0]
    return out


def slot_view(slot_cache: dict, i: int, axes: Dict[str, int]) -> dict:
    """Slot ``i`` as a B = 1 cache of views: in-place writes through it
    reach the pool (the per-slot steps of ``families._rows``)."""
    return {name: leaf.narrow(axes[name], i, 1) for name, leaf in slot_cache.items()}


def read_slot(slot_cache: dict, i: int, axes: Dict[str, int]) -> dict:
    """Slot ``i`` as a standalone B = 1 cache (a copy)."""
    return {name: leaf.clone() for name, leaf in slot_view(slot_cache, i, axes).items()}


def write_slot(slot_cache: dict, i: int, sub_cache: dict, axes: Dict[str, int]) -> None:
    """Replace slot ``i`` with the B = 1 cache ``sub_cache`` (e.g. fresh out
    of prefill), in place, every leaf cast to the pool's dtype; the other
    slots are not touched."""
    for name, leaf in slot_cache.items():
        leaf.narrow(axes[name], i, 1).copy_(sub_cache[name])


def write_slots(slot_cache: dict, idx, batched_cache: dict, axes: Dict[str, int], pos) -> None:
    """Scatter a batched (B = N) cache into slots ``idx`` (N,), in place,
    one ``index_copy_`` per leaf — the multi-slot write of bucketed
    admission.  Rows whose index is out of range (padding rows) are
    dropped.  ``pos`` (N,) sets each slot's true position: under masked
    prefill the batched cache's own ``pos`` holds the padded bucket
    length."""
    slots = slot_cache["pos"].shape[axes["pos"]]
    keep, dst = _index(idx, slots, slot_cache["pos"].device)
    rows = torch.as_tensor(np.flatnonzero(keep), device=dst.device)
    src = dict(batched_cache)
    src["pos"] = torch.as_tensor(np.asarray(pos, np.int64).reshape(-1), device=dst.device)
    for name, leaf in slot_cache.items():
        ax = axes[name]
        leaf.index_copy_(ax, dst, src[name].index_select(ax, rows).to(leaf.dtype))


def reset_slot(slot_cache: dict, i: int, axes: Dict[str, int]) -> None:
    """Zero slot ``i`` in place: K/V rows and ``pos`` back to the init
    state."""
    for name, leaf in slot_cache.items():
        leaf.narrow(axes[name], i, 1).zero_()


def poison_slot(slot_cache: dict, i: int, axes: Dict[str, int], value=float("nan")) -> None:
    """Write ``value`` (NaN by default) into element ``(layer 0, slot i,
    row 0, 0, ...)`` of every floating leaf, in place: the cache-poisoning
    hook behind ``FaultConfig.cache_nan_rate`` (the reference's
    ``poison_slot`` writes the same element of its slot-stacked leaves).
    Row 0 is inside every prompt, so the NaN reaches the slot's logits
    within one step.  Integer leaves (``pos``) are left alone: NaN has no
    integer encoding, and a corrupt position would change control flow, not
    numerics."""
    for name, leaf in slot_cache.items():
        if leaf.is_floating_point():
            idx = [0] * leaf.ndim
            idx[axes[name]] = i
            leaf[tuple(idx)] = value


# ==========================================================================
# Paged pool
# ==========================================================================


@dataclass(frozen=True)
class PagedLayout:
    """Static geometry of a paged pool.

    With ``shards`` > 1 the pool is split over the ranks of a data mesh
    axis: rank r owns slots ``[r*S/shards, (r+1)*S/shards)`` and the
    contiguous block range ``[r*R, (r+1)*R)`` (R = ``rank_blocks``), laid
    out as a one-shard pool of its own (its null block, its slots' scratch
    blocks, then its user blocks).  Block ids stay global on the host; a
    rank's arena holds its range, indexed ``id - r*R`` (``to_local``)."""

    slots: int
    page: int
    n_pages: int  # block-table width = max_len // page
    n_blocks: int  # total arena blocks, incl. null + scratch
    shards: int = 1

    @classmethod
    def build(cls, slots: int, max_len: int, page: int, blocks: int = 0, shards: int = 1):
        """``blocks`` user blocks in all (default: worst case, every slot's
        max_len), cut evenly over ``shards`` ranks (rounded up)."""
        if page <= 0 or max_len % page:
            raise ValueError(
                f"page_size {page} must be positive and divide max_len {max_len} "
                "(the gathered block view must equal the slot-pool cache shape "
                "for bit-parity)"
            )
        if shards < 1 or slots % shards:
            raise ValueError(f"{slots} slots do not split over {shards} ranks")
        n_pages = max_len // page
        user = blocks if blocks > 0 else slots * n_pages
        per = 1 + slots // shards + -(-user // shards)
        return cls(slots=slots, page=page, n_pages=n_pages, n_blocks=shards * per,
                   shards=shards)

    @property
    def null_block(self) -> int:
        return 0

    @property
    def rank_slots(self) -> int:
        return self.slots // self.shards

    @property
    def rank_blocks(self) -> int:
        return self.n_blocks // self.shards

    def slot_rank(self, slot: int) -> int:
        return slot // self.rank_slots

    def block_rank(self, blk: int) -> int:
        return blk // self.rank_blocks

    def scratch_block(self, slot: int) -> int:
        r = self.slot_rank(slot)
        return r * self.rank_blocks + 1 + slot - r * self.rank_slots

    @property
    def reserved(self) -> int:
        """Blocks of one rank that are not user blocks (its null and its
        slots' scratch blocks)."""
        return 1 + self.rank_slots

    @property
    def user_blocks(self) -> int:
        return self.n_blocks - self.shards * self.reserved

    @property
    def rank_user_blocks(self) -> int:
        """User blocks of one rank: the most one request may hold."""
        return self.rank_blocks - self.reserved

    @property
    def oob(self) -> int:
        # out-of-range sentinel for dropped writes / unmapped table entries
        return self.n_blocks

    def local(self) -> "PagedLayout":
        """One rank's layout, as a pool of its own."""
        if self.shards == 1:
            return self
        return PagedLayout(slots=self.rank_slots, page=self.page, n_pages=self.n_pages,
                           n_blocks=self.rank_blocks)

    def to_local(self, ids, rank: int) -> np.ndarray:
        """Global block ids as rank ``rank``'s arena indices; ids of other
        ranks (and sentinels) become its out-of-range sentinel, which the
        arena writes drop."""
        ids = np.asarray(ids, np.int64)
        loc = ids - rank * self.rank_blocks
        return np.where((loc >= 0) & (loc < self.rank_blocks), loc, self.rank_blocks)


def paged_seq_len(cache_specs: Specs):
    """The common sequence length ``max_len`` if ``cache_specs`` (taken at
    batch 1) is KV-shaped — every leaf but ``pos`` ``(L, 1, S, ...)`` with
    one shared ``S``, and ``pos`` of shape (1,) — else None: the predicate
    gating paged serving."""
    if "pos" not in cache_specs or tuple(cache_specs["pos"][0]) != (1,):
        return None
    seq = None
    for name, (shape, _) in cache_specs.items():
        if name == "pos":
            continue
        if len(shape) < 3 or shape[1] != 1:
            return None
        if seq is None:
            seq = shape[2]
        elif shape[2] != seq:
            return None
    return seq


def init_paged_pool(cache_specs: Specs, layout: PagedLayout, device) -> dict:
    """Zero arena and scratch-pointing tables.  Every table entry starts at
    the slot's own scratch block, so free slots' decode writes land in
    private scratch, never in user blocks."""
    arena = {
        name: torch.zeros((shape[0], layout.n_blocks, layout.page) + tuple(shape[3:]),
                          dtype=dtype, device=device)
        for name, (shape, dtype) in cache_specs.items() if name != "pos"
    }
    scratch = 1 + torch.arange(layout.slots, dtype=torch.long, device=device)
    return {
        "arena": arena,
        "table": scratch[:, None].repeat(1, layout.n_pages),
        "pos": torch.zeros((layout.slots,), dtype=torch.long, device=device),
    }


def paged_view(pstate: dict) -> dict:
    """The decode step's cache dict for a paged pool: the arena leaves, the
    block tables and the positions.  Each layer's attention gathers its
    table rows into the contiguous (slots, max_len, ...) view
    (:func:`paged_gather`) and writes its new rows through the table
    (:func:`paged_scatter_rows`)."""
    return {**pstate["arena"], "table": pstate["table"], "pos": pstate["pos"]}


def paged_gather(arena_t: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The contiguous (B, n_pages * page, ...) view that block tables
    ``table`` (B, n_pages) gather from one layer's arena leaf ``arena_t``
    (n_blocks, page, ...): with ``page`` dividing ``max_len``, exactly the
    slot pool's cache shape, so the attend downstream is the same
    computation and gives the same bits."""
    return arena_t[table].reshape(table.shape[0], -1, *arena_t.shape[2:])


def paged_scatter_rows(arena_t: torch.Tensor, table: torch.Tensor, start: torch.Tensor,
                       rows: torch.Tensor) -> None:
    """Write ``S`` consecutive rows per slot into one layer's arena leaf
    ``arena_t`` (n_blocks, page, ...), in place: row j of slot i (``rows``
    (B, S, ...)) lands at position ``start[i] + j`` (``start`` (B,)), in
    block ``table[i, pos // page]`` at offset ``pos % page``.  S = 1 is a
    decode step's write; S = ``draft_k`` + 1 the speculative verify's, whose
    rejected tail is written too and stays masked past ``pos`` until
    overwritten, as in the slot pool (the reference's
    ``paged_scatter_rows``).  The page index is clamped to the table, so a
    row past a slot's pages lands in the block its table holds there: its
    scratch block for a free slot, whose position drifts past ``max_len``,
    with no host sync.  Distinct slots target distinct blocks (the
    allocator never maps one user block writable into two tables, and
    scratch blocks are per slot), so the writes do not collide."""
    page = arena_t.shape[1]
    positions = start[:, None] + torch.arange(rows.shape[1], device=start.device)
    blk = table.gather(1, (positions // page).clamp(max=table.shape[1] - 1))
    flat = (blk * page + positions % page).reshape(-1)
    arena_t.flatten(0, 1).index_copy_(0, flat, rows.flatten(0, 1).to(arena_t.dtype))


def write_prefill_pages(arena: dict, page_tables, primed: dict) -> None:
    """Scatter a primed contiguous cache (B = N, leaves ``(L, N, S, ...)``
    with ``page`` dividing ``S``) into arena blocks, in place: page ``p`` of
    batch row ``r`` lands in block ``page_tables[r, p]`` ((N, n_pages)).
    Out-of-range (sentinel) entries are dropped — padding rows, pages past a
    short prompt and prefix-shared pages (already resident, never
    rewritten) are all skipped that way."""
    a0 = next(iter(arena.values()))
    page, n_blocks = a0.shape[2], a0.shape[1]
    keep, dst = _index(page_tables, n_blocks, a0.device)
    src = torch.as_tensor(np.flatnonzero(keep), device=a0.device)
    for name, a in arena.items():
        sub = primed[name]
        pages = sub.reshape(sub.shape[0], sub.shape[1] * (sub.shape[2] // page), page,
                            *sub.shape[3:])  # (L, N * n_pages, page, ...)
        a.index_copy_(1, dst, pages.index_select(1, src).to(a.dtype))


def bind_slot_pages(table: torch.Tensor, pos: torch.Tensor, idx, rows, lengths) -> None:
    """Point slots ``idx`` (N,) at their blocks, in place: full table rows
    ``rows`` (N, n_pages) and positions ``lengths`` (N,); out-of-range
    indices (padding) are dropped."""
    keep, dst = _index(idx, table.shape[0], table.device)
    table.index_copy_(0, dst, torch.as_tensor(np.asarray(rows, np.int64)[keep],
                                              device=table.device))
    pos.index_copy_(0, dst, torch.as_tensor(np.asarray(lengths, np.int64).reshape(-1)[keep],
                                            device=pos.device))


def zero_blocks(arena: dict, ids) -> None:
    """Zero arena blocks ``ids`` in place (out-of-range entries are no-ops).
    A freed block re-entering circulation must read as zeros, so the rows
    a gathered view masks stay finite."""
    for a in arena.values():
        keep, dst = _index(ids, a.shape[1], a.device)
        if dst.numel():
            a.index_fill_(1, dst, 0)


def copy_block(arena: dict, src: int, dst: int) -> None:
    """Copy-on-write: duplicate block ``src`` into ``dst`` byte for byte, in
    place.  Used at the prefix divergence boundary: the sharer keeps reading
    the original, the new request writes its divergent rows into the
    copy."""
    for a in arena.values():
        a[:, dst].copy_(a[:, src])


def paged_read_slot(pstate: dict, i: int, max_len: int) -> dict:
    """Slot ``i`` as a contiguous B = 1 cache — the paged twin of
    :func:`read_slot`, for parity tests and debugging."""
    row = pstate["table"][i]
    out = {}
    for name, a in pstate["arena"].items():
        g = a[:, row]  # (L, n_pages, page, ...)
        out[name] = g.reshape(a.shape[0], 1, -1, *a.shape[3:])[:, :, :max_len].clone()
    out["pos"] = pstate["pos"][i : i + 1].clone()
    return out


def paged_reset_slot(pstate: dict, i: int, scratch_id: int) -> None:
    """Detach slot ``i`` in place: table row back to its scratch block, pos
    to 0.  Freeing and zeroing the blocks the row pointed at is the
    allocator's call (shared blocks may have other readers)."""
    pstate["table"][i].fill_(scratch_id)
    pstate["pos"][i].fill_(0)


def paged_poison_block(arena: dict, blk: int, value=float("nan")) -> None:
    """Write ``value`` (NaN by default) into element ``(layer 0, blk, 0,
    ...)`` of every floating arena leaf, in place: :func:`poison_slot` on
    the paged layout.  The caller passes a *private* block of the target
    slot (the scheduler privatizes one first), so the poison reaches one
    request even under prefix sharing."""
    for a in arena.values():
        if a.is_floating_point():
            a[(0, blk) + (0,) * (a.ndim - 2)] = value


def paged_pool_bytes(pstate: dict) -> int:
    """Total arena bytes (all blocks, live or not)."""
    return sum(_nbytes(a) for a in pstate["arena"].values())


def paged_block_bytes(pstate: dict) -> int:
    """Bytes one block occupies across all arena leaves (all layers)."""
    return sum(_nbytes(a) // a.shape[1] for a in pstate["arena"].values())


def paged_host_mirror(pstate: dict):
    """Host snapshot of the pool's control plane, ``(table (slots, n_pages),
    pos (slots,))`` as numpy, in one small transfer each — for checking that
    the scheduler's host mirrors never diverged.  The arena stays on the
    device."""
    return pstate["table"].cpu().numpy(), pstate["pos"].cpu().numpy()


# --------------------------------------------------------------------------
# Host-side prefix hashing + block allocator (copied from the reference)
# --------------------------------------------------------------------------


def _chain(digest: bytes, tokens: np.ndarray) -> bytes:
    return hashlib.blake2b(
        digest + np.asarray(tokens, np.int32).tobytes(), digest_size=16
    ).digest()


def prefix_page_digests(tokens, page: int) -> list:
    """Chained per-page digests of a prompt: ``h_p = H(h_{p-1} || page_p)``.
    Chaining makes each digest position- and prefix-dependent, so equal
    digests mean equal *full prefixes*, not just equal page contents.
    Returns one digest per fully-covered page (``len(tokens) // page``);
    the last digest (or ``b""``) seeds :func:`prefix_tail_digests`."""
    tokens = np.asarray(tokens, np.int32)
    out, h = [], b""
    for p in range(len(tokens) // page):
        h = _chain(h, tokens[p * page:(p + 1) * page])
        out.append(h)
    return out


class BlockAllocator:
    """Host-side bookkeeping for the user-block pool: free list, refcounts,
    prefix-hash registry with a cached-free LRU (refcount-0 blocks whose
    bytes are worth keeping for future prefix hits), and the COW registry
    for partial tail pages.

    On a layout split over ranks (``PagedLayout.shards``) each rank's user
    blocks have their own free list, and ``alloc``, ``match_pages`` and
    ``match_tail`` take the rank of the slot that asks: a slot only ever
    holds blocks of its own rank's arena.

    Invariants:
      * every block is in exactly one of {free, cached, live};
      * refcounts are >= 1 for live blocks and never go negative;
      * ``alloc`` never returns a live or reserved block;
      * blocks surfaced from the free list hold zeros (callers zero on free /
        scrub on cached-eviction, as instructed by the return values here).
    """

    def __init__(self, layout: PagedLayout):
        self.layout = layout
        # one free list per rank; pop() from the tail → ascending allocation order
        rb = layout.rank_blocks
        self._free = [list(range((r + 1) * rb - 1, r * rb + layout.reserved - 1, -1))
                      for r in range(layout.shards)]
        self._ref: dict = {}
        self._key_of: dict = {}  # blk -> registry key
        self._blk_of: dict = {}  # registry key -> blk
        self._tail_rows: dict = {}  # partial-tail key -> row count
        self._cached: OrderedDict = OrderedDict()  # key -> blk, refcount-0, LRU
        self.hits = 0
        self.lookups = 0
        self.cow_copies = 0
        self.evictions = 0

    # -- accounting ---------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return sum(map(len, self._free))

    @property
    def cached_blocks(self) -> int:
        return len(self._cached)

    @property
    def live_blocks(self) -> int:
        return len(self._ref)

    @property
    def available(self) -> int:
        return self.free_blocks + len(self._cached)

    def available_in(self, rank: int) -> int:
        """Blocks rank ``rank`` can still hand out (free or cached)."""
        if self.layout.shards == 1:
            return self.available
        return len(self._free[rank]) + sum(
            self.layout.block_rank(b) == rank for b in self._cached.values())

    def _evictable(self, rank: int):
        """The least recently used cached entry of rank ``rank``."""
        for key, b in self._cached.items():
            if self.layout.block_rank(b) == rank:
                return key, b
        raise RuntimeError("no cached block to evict")

    def refcount(self, blk: int) -> int:
        return self._ref.get(blk, 0)

    # -- alloc / free -------------------------------------------------------
    def alloc(self, n: int, rank: int = 0):
        """Take ``n`` fresh blocks (refcount 1) of rank ``rank``.  Prefers
        the zeroed free list, then evicts cached prefix blocks LRU-first.
        Returns ``(ids, scrub)`` where ``scrub`` lists evicted blocks the
        caller must zero before use, or ``None`` if the pool cannot cover
        ``n``."""
        if n > self.available_in(rank):
            return None
        ids, scrub = [], []
        free = self._free[rank]
        for _ in range(n):
            if free:
                b = free.pop()
            else:
                key, b = self._evictable(rank)
                del self._cached[key]
                self._unregister(b, key)
                self.evictions += 1
                scrub.append(b)
            self._ref[b] = 1
            ids.append(b)
        return ids, scrub

    def free(self, ids):
        """Drop one reference per id.  Returns the blocks that fully died
        *unhashed* — the caller must zero exactly those (hashed blocks keep
        their bytes in the cached pool for future prefix hits)."""
        dead = []
        for b in ids:
            r = self._ref.get(b, 0) - 1
            if r < 0:
                raise ValueError(f"refcount underflow freeing block {b}")
            if r == 0:
                del self._ref[b]
                key = self._key_of.get(b)
                if key is not None:
                    self._cached[key] = b
                else:
                    self._free[self.layout.block_rank(b)].append(b)
                    dead.append(b)
            else:
                self._ref[b] = r
        return dead

    # -- prefix registry ----------------------------------------------------
    def _unregister(self, blk, key=None):
        key = self._key_of.pop(blk, None) or key
        if key is not None:
            self._blk_of.pop(key, None)
            self._tail_rows.pop(key, None)
            self._cached.pop(key, None)

    def register_page(self, digest: bytes, blk: int) -> bool:
        """Hash a fully-written prompt page.  First writer wins; a block can
        carry at most one registration."""
        key = ("F", digest)
        if key in self._blk_of or blk in self._key_of:
            return False
        self._blk_of[key] = blk
        self._key_of[blk] = key
        return True

    def register_tail(self, digest: bytes, blk: int, rows: int) -> bool:
        """Hash a *partial* final prompt page (``rows`` valid rows) — the COW
        seed: later prompts sharing those rows copy this block and write
        their divergent rows into the copy."""
        key = ("P", digest)
        if key in self._blk_of or blk in self._key_of or rows <= 0:
            return False
        self._blk_of[key] = blk
        self._key_of[blk] = key
        self._tail_rows[key] = rows
        return True

    def match_pages(self, digests, rank: int = 0) -> list:
        """Longest run of registered full-page digests in rank ``rank``'s
        blocks; matched blocks gain a reference (resurrecting cached blocks
        as needed)."""
        ids = []
        for d in digests:
            self.lookups += 1
            b = self._blk_of.get(("F", d))
            if b is None or self.layout.block_rank(b) != rank:
                break
            self.hits += 1
            self._retain(b, ("F", d))
            ids.append(b)
        return ids

    def match_tail(self, digests, rank: int = 0):
        """Longest registered partial-tail match among token-chain ``digests``
        (index i = digest over the first i+1 tail tokens) in rank
        ``rank``'s blocks.  Returns
        ``(blk, rows)`` for the COW source or None.  The source block is NOT
        ref-bumped: the caller copies its bytes into a fresh block and the
        two diverge immediately."""
        best = None
        for i, d in enumerate(digests):
            key = ("P", d)
            b = self._blk_of.get(key)
            if (b is not None and self._tail_rows.get(key) == i + 1
                    and self.layout.block_rank(b) == rank):
                best = (b, i + 1)
        self.lookups += 1
        if best is not None:
            self.hits += 1
            self.cow_copies += 1
        return best

    def _retain(self, blk, key):
        if blk in self._ref:
            self._ref[blk] += 1
        else:
            self._ref[blk] = 1
            self._cached.pop(key, None)

    def forget(self, blk: int):
        """Drop a block's hash registration (without touching refcounts), so
        no future prompt can match into it.  Returns blocks the caller must
        zero (a cached block demoted to the plain free list)."""
        key = self._key_of.get(blk)
        if key is None:
            return []
        self._unregister(blk, key)
        if blk not in self._ref:
            # was parked in the cached pool: demote to plain free
            self._free[self.layout.block_rank(blk)].append(blk)
            return [blk]
        return []

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else float("nan")


def prefix_tail_digests(seed: bytes, tail_tokens) -> list:
    """Token-wise chain digests of a prompt's partial final page, seeded by
    the full-page chain digest: element ``i`` hashes the first ``i+1`` tail
    tokens.  Probing every prefix of the tail against the allocator's
    partial registry finds the longest COW match in O(page) hashes."""
    out, h = [], seed
    for t in np.asarray(tail_tokens, np.int32).ravel():
        h = _chain(h, np.asarray([t], np.int32))
        out.append(h)
    return out


# ==========================================================================
# Placements on a mesh
# ==========================================================================


def slot_shardings(slot_cache: dict, mesh, axes: Dict[str, int]) -> dict:
    """The placements of a slot pool's leaves on ``mesh``: each leaf's slot
    axis (``axes``, from :func:`batch_axes`) over the data-parallel mesh
    axes, the rest whole, replicated when the DP degree does not divide the
    slot count (the reference's ``slot_shardings``)."""
    from ..dist.sharding import batch_sharding

    n = slot_cache["pos"].shape[axes["pos"]]
    out = {}
    for name, leaf in slot_cache.items():
        spec = batch_sharding(mesh, n, 1)[0]
        parts = [None] * leaf.ndim
        parts[axes[name]] = spec
        out[name] = tuple(parts)
    return out


def paged_shardings(pstate: dict, mesh) -> dict:
    """The placements of a paged pool on ``mesh``: the arena's block axis
    (axis 1) over the data-parallel mesh axes, block tables and positions
    over slots (the reference's ``paged_shardings``)."""
    from ..dist.sharding import batch_sharding, block_sharding

    slots = pstate["pos"].shape[0]
    return {
        "arena": {name: block_sharding(mesh, a.shape[1], a.ndim, axis=1)
                  for name, a in pstate["arena"].items()},
        "table": batch_sharding(mesh, slots, pstate["table"].ndim),
        "pos": batch_sharding(mesh, slots, 1),
    }
