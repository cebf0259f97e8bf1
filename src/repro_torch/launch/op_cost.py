"""Per-op cost of one call of the port, counted as it runs.

The port's counterpart of the JAX package's ``launch/hlo_cost.py``.  The
reference parses XLA's optimised HLO and weights every op inside a loop by
the loop's trip count; here the call runs eagerly under a
``TorchDispatchMode``, so every iteration of every Python loop dispatches
its ops and no weighting is needed.  Run it on ``meta`` tensors (shapes
only, no storage: ``launch/dryrun.py``) or on real ones.  It counts, per
call, on this rank:

* ``dot_flops`` — the FLOPs of every product, through
  ``torch.utils.flop_counter``'s own registry and decompositions (2*M*N*K
  for a product), so the count equals ``FlopCounterMode``'s;
* ``bytes`` — each aten op's operands plus its result.  Views and
  metadata ops move nothing and are skipped, as ``hlo_cost`` skips
  bitcasts and tuples; a slice (``slice``, ``select``, ``unfold``) counts
  twice its result, and an in-place write (``copy_``, ``index_copy_``,
  ``index_put_``) twice the update, as ``hlo_cost`` counts
  ``dynamic-slice`` and ``dynamic-update-slice``;
* ``transcendentals`` — the elements through exp, tanh, log, rsqrt, sqrt,
  pow, sigmoid or erf (``silu`` and ``gelu`` count one each, as their
  logistic or tanh; the softmaxes one exp an input element);
* ``collectives`` — per type (``all-gather``, ``all-reduce``,
  ``broadcast``) the count and the bytes this rank received, read from
  ``dist/comm.py``'s counters, through which every collective of the port
  goes;
* ``temp_size_in_bytes`` — the peak of the bytes of tensors made during
  the call and still alive (a storage counts from the op that makes it to
  its release), the counterpart of XLA's temporary buffer size;

and, with ``sites=True``, the same counts keyed by the innermost function
of the program that dispatched each op (``module.qualname``), the counterpart
of ``hlo_cost(top_k=...)``'s op sites.  Ops that the autograd engine runs
for a backward count under ``backward:<node>`` unless a hand-written
backward (an ``autograd.Function``'s) dispatched them.

Usage::

    with OpCounter() as oc:
        out = fn(*args)
    oc.cost()          # {"dot_flops", "bytes", "transcendentals", "collectives", ...}
    oc.top_sites(10)   # with OpCounter(sites=True)
"""

from __future__ import annotations

import copy
import sys
import weakref
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..dist import comm

__all__ = ["OpCounter", "op_cost"]

aten = torch.ops.aten

# ops that move no data: allocation without a write, and metadata
_SKIP = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "lift_fresh",
    "_unsafe_view", "detach", "alias", "_local_scalar_dense", "is_same_size", "set_",
    "resize_", "record_stream",
}
# views that take a sub-range: counted as the slice read and written once
_SLICES = {"slice", "select", "unfold", "narrow", "diagonal"}
# in-place writes of a slice: counted as twice the update (argument index)
_SLICE_WRITES = {"copy_": 1, "index_copy_": 3, "index_put_": 2}
# elementwise transcendentals: count per element of the result
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh", "rsqrt", "sqrt",
    "pow", "sigmoid", "erf", "erfc", "sin", "cos", "silu", "gelu", "logaddexp",
    "silu_backward", "gelu_backward", "sigmoid_backward",
}
# reductions through exp: count per element of the input
_EXP_REDUCTIONS = {"_softmax", "_log_softmax", "logsumexp"}
# metadata queries a dispatch mode must pass through untouched (as FlopCounterMode)
_PASS = {
    aten.sym_is_contiguous.default, aten.is_contiguous.default,
    aten.is_contiguous.memory_format, aten.is_strides_like_format.default,
    aten.is_non_overlapping_and_dense.default, aten.size.default, aten.sym_size.default,
    aten.stride.default, aten.sym_stride.default, aten.storage_offset.default,
    aten.sym_storage_offset.default, aten.numel.default, aten.sym_numel.default,
    aten.dim.default, torch.ops.prim.layout.default,
}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _is_view(func) -> bool:
    returns = func._schema.returns
    return bool(returns) and all(r.alias_info is not None and not r.alias_info.is_write
                                 for r in returns)


_OWN = (__name__, "torch", "contextlib", "functools", "weakref")


def _site() -> str:
    """The innermost function of the program that dispatched the current op:
    the first frame outside torch and this module."""
    f = sys._getframe(1)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if not any(mod == o or mod.startswith(o + ".") for o in _OWN):
            site = f"{mod}.{f.f_code.co_qualname}"
            node = torch._C._current_autograd_node()
            if node is not None and not f.f_code.co_qualname.endswith(".backward"):
                return f"backward:{node.name()}"
            return site
        f = f.f_back
    return "?"


def _zero() -> dict:
    return {"dot_flops": 0, "bytes": 0, "transcendentals": 0}


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is active (see the module
    docstring).  One counter per call; ``cost()`` after the ``with``."""

    def __init__(self, sites: bool = False):
        super().__init__()
        self.totals = _zero()
        self.sites: Dict[str, dict] = {} if sites else None
        self._live: Dict[int, tuple] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._comm0: dict = {}
        self.collectives: dict = {}
        self._depth = 0  # the mode re-enters itself to run a decomposition

    def __enter__(self):
        if self._depth == 0:
            self._comm0 = copy.deepcopy(comm.STATS["by_type"])
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._depth -= 1
        if self._depth:
            return out
        self.collectives = {}
        for kind, e in comm.STATS["by_type"].items():
            e0 = self._comm0.get(kind, {"count": 0, "bytes": 0})
            if e["count"] > e0["count"]:
                self.collectives[kind] = {"count": e["count"] - e0["count"],
                                          "bytes": e["bytes"] - e0["bytes"]}
        return out

    # ---- live storage bytes ----------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        nbytes = st.nbytes()

        def release(_, key=key, nbytes=nbytes):
            if self._live.pop(key, None) is not None:
                self.live_bytes -= nbytes

        self._live[key] = weakref.ref(st, release)
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    # ---- counting -----------------------------------------------------------
    def _add(self, key: str, n) -> None:
        self.totals[key] += n
        if self.sites is not None:
            self.sites.setdefault(_site(), _zero())[key] += n

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        if packet in flop_registry:
            self._add("dot_flops", int(flop_registry[packet](*args, **kwargs, out_val=out)))
        name = packet.__name__
        if func.namespace != "aten" or name in _SKIP:
            return
        outs = _tensors(out)
        if name in _TRANSCENDENTAL:
            self._add("transcendentals", sum(t.numel() for t in outs))
        elif name in _EXP_REDUCTIONS:
            self._add("transcendentals", args[0].numel())
        if name in _SLICES:
            self._add("bytes", 2 * sum(_nbytes(t) for t in outs))
        elif name in _SLICE_WRITES:
            self._add("bytes", 2 * _nbytes(args[_SLICE_WRITES[name]]))
        elif not _is_view(func):
            self._add("bytes", sum(_nbytes(t) for t in _tensors((args, kwargs)))
                      + sum(_nbytes(t) for t in outs))
        if not _is_view(func) and not name.endswith("_"):
            for t in outs:
                self._track(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PASS:
            return NotImplemented
        # as FlopCounterMode: an op it has no formula for runs decomposed
        # where it can be, so products inside composites are counted
        if func not in flop_registry and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    # ---- results ------------------------------------------------------------
    def cost(self) -> dict:
        return {**self.totals, "collectives": self.collectives,
                "temp_size_in_bytes": self.peak_bytes}

    def top_sites(self, k: int) -> list:
        """The ``k`` sites with the most bytes: (site, counts), largest
        first (needs ``sites=True``)."""
        if self.sites is None:
            raise ValueError("count with OpCounter(sites=True) to keep sites")
        return sorted(self.sites.items(), key=lambda kv: -kv[1]["bytes"])[:k]


def op_cost(fn, *args, sites: bool = False, **kwargs):
    """``(fn(*args, **kwargs), cost)`` with ``cost`` of :class:`OpCounter`
    (plus ``"sites"`` when asked)."""
    with OpCounter(sites=sites) as oc:
        out = fn(*args, **kwargs)
    cost = oc.cost()
    if sites:
        cost["sites"] = oc.sites
    return out, cost
