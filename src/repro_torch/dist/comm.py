"""Collectives over the axes of a (pod, data, model) mesh, with counters.

Every collective of the port's sharded paths goes through here, on the
process group of one mesh axis (``DeviceMesh.get_group``) or, for a sum
over several axes or a broadcast over the whole mesh, on each axis in
turn, so a run can report how many it made and how many bytes each rank
received.  The backend is the process group's: gloo takes CUDA tensors
for all-gather and broadcast (the ranks that share one card use it), nccl
needs one GPU per rank.  A collective that fails raises; nothing here retries or falls
back to a local result.

Three autograd Functions carry the ``model`` axis's collectives through a
backward, Megatron's f/g pair (a tensor-parallel training step,
``dist/tp.py``): ``enter_model`` (identity forward, ordered sum backward)
enters a region in which the ranks split the work, ``sum_model`` (ordered
sum forward, identity backward) and ``gather_model`` (all-gather forward,
this rank's slice backward) leave it.  Every region entered through one and
left through another leaves each replicated tensor's gradient complete and
the same bits on every ``model`` rank.  Their collectives count in ``STATS``
as the primitives' do, the backward's too.  A fourth, ``batch_totals``,
serves the ranks that split one batch's rows (the moe routing,
``models/layers.py moe``): every rank's integer counts and the ordered sum
of a float vector, in one gather.

The FSDP pair serves the leaves stored on ``data`` (``dist/sharding.py``:
every weight's d_model dim): ``reduce_scatter_in_rank_order`` adds each
rank's chunk of a tensor over the pure data axes in their flattened rank
order and leaves each rank only its own chunk (the bits of
``local_shard(sum_in_rank_order(t))``, about 1/n of its bytes received),
and ``gather_data`` gathers leaves whole over ``data`` with that
reduce-scatter as its backward, so a training step holds one layer's
leaves whole at a time (``dist/tp.py TPPlan.layer``).  ``GATHERED`` counts
the bytes of the leaves ``gather_data`` holds gathered.
"""

from __future__ import annotations

import math
import threading
import weakref

import torch
import torch.distributed as dist

__all__ = ["STATS", "reset_stats", "axis_size", "axis_index", "axes_index", "mesh_shape",
           "all_gather", "gather_axes", "sum_in_rank_order", "broadcast", "broadcast_mesh",
           "gather_leaves", "enter_model", "sum_model", "gather_model", "gather_model_leaves",
           "batch_totals", "reduce_scatter_in_rank_order", "reduce_scatter_leaves",
           "gather_data", "GATHERED", "reset_gathered"]

# collectives made and bytes this rank received, since the last reset, in
# all and per type ("by_type": {"all-gather" | "all-reduce" | "broadcast" |
# "fsdp-gather" | "reduce-scatter": {"count", "bytes"}}, what
# ``launch/op_cost.py`` reports; "fsdp-gather" is ``gather_data``'s)
STATS = {"collectives": 0, "bytes": 0, "by_type": {}}

# bytes of the leaves ``gather_data`` made that are still alive, and their
# peak since the last reset (each output's storage watched by a weakref; a
# backward's recompute gathers on autograd's thread, hence the lock)
GATHERED = {"live": 0, "peak": 0}
_GATHERED_LOCK = threading.Lock()


def reset_stats() -> None:
    STATS.update(collectives=0, bytes=0, by_type={})


def reset_gathered() -> None:
    """Restart ``GATHERED``'s peak from the bytes alive now."""
    with _GATHERED_LOCK:
        GATHERED["peak"] = GATHERED["live"]


def _count(kind: str, nbytes: int) -> None:
    STATS["collectives"] += 1
    STATS["bytes"] += nbytes
    e = STATS["by_type"].setdefault(kind, {"count": 0, "bytes": 0})
    e["count"] += 1
    e["bytes"] += nbytes


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh, of a plain {name: size} mapping
    (the rules accept one, for meshes no process group backs), or {} for
    no mesh."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, name: str) -> int:
    """Size of a mesh axis; 1 for no mesh or an absent axis."""
    return mesh_shape(mesh).get(name, 1)


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate on a mesh axis; 0 for no mesh or an absent
    axis."""
    if axis_size(mesh, name) == 1:
        return 0
    return mesh.get_local_rank(name)


def axes_index(mesh, names) -> int:
    """This rank's coordinate over the axes ``names`` flattened row-major
    (the outer axis's coordinate first): its place in a batch whose rows
    those axes split, as ``dist.sharding.local_shard`` cuts it."""
    shape, r = mesh_shape(mesh), 0
    for a in ((names,) if isinstance(names, str) else names):
        r = r * shape.get(a, 1) + axis_index(mesh, a)
    return r


def all_gather(t: torch.Tensor, mesh, name: str, dim: int = 0,
               kind: str = "all-gather") -> torch.Tensor:
    """The shards of ``t`` of every rank of axis ``name`` concatenated along
    ``dim`` in axis order (every shard the same shape); counted in
    ``STATS`` as ``kind``."""
    n = axis_size(mesh, name)
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=mesh.get_group(name))
    _count(kind, (n - 1) * t.numel() * t.element_size())
    return torch.cat(parts, dim=dim)


def _live_axes(mesh, names) -> tuple:
    """The axes of ``names`` (one name or a tuple) of size > 1, outermost
    first."""
    names = (names,) if isinstance(names, str) else tuple(names)
    return tuple(a for a in names if axis_size(mesh, a) > 1)


def gather_axes(t: torch.Tensor, mesh, names) -> torch.Tensor:
    """Every rank's ``t`` over the axes ``names`` (one name or a tuple),
    stacked on a new dim 0 in their flattened row-major order
    (``axes_index``): (n, *t.shape), one gather an axis of size > 1, the
    innermost first."""
    parts = t[None]
    for a in reversed(_live_axes(mesh, names)):
        parts = all_gather(parts, mesh, a, dim=0)
    return parts


def sum_in_rank_order(t: torch.Tensor, mesh, name) -> torch.Tensor:
    """The sum of ``t`` over the ranks of axis ``name`` (or of a tuple of
    axes, flattened row-major: the outer axis's coordinate first, the rank
    order of ``dist.sharding.local_shard``), added in rank order (rank 0
    first) on every rank: the same bits everywhere, and the same order
    whatever the backend's reduction would choose.  Two ranks all-reduce
    (a sum of two addends is the same bits in either order, and it moves
    half the bytes of a gather); more gather every rank's ``t`` (over
    several axes, the innermost first) and add them in order."""
    axes = _live_axes(mesh, name)
    if not axes:
        return t
    if len(axes) == 1 and axis_size(mesh, axes[0]) == 2:
        out = t.clone()
        dist.all_reduce(out, group=mesh.get_group(axes[0]))
        _count("all-reduce", t.numel() * t.element_size())
        return out
    parts = gather_axes(t, mesh, axes)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def gather_leaves(tensors: list, dims: list, mesh, name: str, kind: str = "all-gather") -> list:
    """``all_gather`` of each of ``tensors`` along its ``dims`` entry over
    axis ``name``, in one collective (counted as ``kind``): the shards are
    flattened into one buffer, gathered, and cut apart again (the same bits
    as a gather a tensor).  Every tensor shares one dtype."""
    n = axis_size(mesh, name)
    if n == 1 or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    whole = all_gather(flat[None], mesh, name, dim=0, kind=kind)  # (n, total), rank order
    out, off = [], 0
    for t, dim in zip(tensors, dims):
        part = whole[:, off:off + t.numel()].reshape(n, *t.shape)
        out.append(torch.cat(part.unbind(0), dim=dim))
        off += t.numel()
    return out


def _all_to_all(t: torch.Tensor, mesh, name: str) -> torch.Tensor:
    """Row j of ``t`` (n, m) sent to rank j of axis ``name``; row j of the
    result is what rank j sent this rank.  Gloo's all-to-all is run on host
    copies of a CUDA tensor (gloo stages its CUDA collectives through host
    memory anyway)."""
    group = mesh.get_group(name)
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = t.cpu()
        out = torch.empty_like(host)
        dist.all_to_all_single(out, host, group=group)
        return out.to(t.device)
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def reduce_scatter_leaves(tensors: list, dims: list, mesh, axes, over: str = "data") -> list:
    """``reduce_scatter_in_rank_order`` of each of ``tensors`` along its
    ``dims`` entry, in one collective an axis: the chunks are flattened
    into one buffer a rank, exchanged, added and cut apart (an elementwise
    sum, so the same bits as one call a tensor).  Every tensor shares one
    dtype."""
    axes = _live_axes(mesh, axes)
    if not tensors or not axes:
        return list(tensors)
    if over in axes and axes[-1] != over:
        raise ValueError(f"the scattered axis {over!r} must be the innermost of {axes}")
    ns = axis_size(mesh, over)
    shards = [tuple(n // ns if i == d else n for i, n in enumerate(t.shape))
              for t, d in zip(tensors, dims)]
    buf = torch.cat([torch.stack(t.chunk(ns, dim=d)).reshape(ns, -1)
                     for t, d in zip(tensors, dims)], dim=1)  # (ns, total): rank j's chunks
    if ns > 1:
        buf = _all_to_all(buf.contiguous(), mesh, over)
        _count("reduce-scatter", (ns - 1) * buf[0].numel() * buf.element_size())
    parts = buf[None]  # (1, ns, total)
    for a in reversed([a for a in axes if a != over]):  # the outer axes, innermost first
        parts = all_gather(parts, mesh, a, dim=0, kind="reduce-scatter")
    parts = parts.reshape(-1, buf.shape[1])  # flattened rank order, the outer axis first
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    res, off = [], 0
    for shape in shards:
        k = math.prod(shape)
        res.append(out[off:off + k].reshape(shape))
        off += k
    return res


def reduce_scatter_in_rank_order(t: torch.Tensor, mesh, axes, dim: int,
                                 over: str = "data") -> torch.Tensor:
    """This rank's chunk of the sum of ``t`` over the ranks of ``axes`` (a
    name or a tuple, flattened row-major as ``sum_in_rank_order`` orders
    them), ``t`` cut along ``dim`` into one chunk a rank of axis ``over``
    (the innermost of ``axes``; the chunk this rank's ``over`` coordinate
    names, whatever its coordinate on the outer axes): the bits of
    ``local_shard(sum_in_rank_order(t, mesh, axes))`` under a placement with
    ``over`` on ``dim``.  Each rank receives its chunk from every rank of
    its ``over`` axis (one all-to-all), then those of every rank of the
    outer axes (one gather an axis), and adds the n chunks in rank order:
    (n - 1) chunks received, (n - 1) / n of ``t``'s bytes on one axis, where
    the ordered sum receives (n - 1) times them.  Counted in ``STATS`` as
    ``"reduce-scatter"``, one collective an axis of size > 1."""
    return reduce_scatter_leaves([t], [dim], mesh, axes, over)[0]


def broadcast(t: torch.Tensor, mesh, name: str, src: int = 0) -> torch.Tensor:
    """``t`` of the rank at coordinate ``src`` on axis ``name``, in place on
    every rank of that axis."""
    n = axis_size(mesh, name)
    if n == 1:
        return t
    group = mesh.get_group(name)
    dist.broadcast(t, group=group, group_src=src)
    _count("broadcast", t.numel() * t.element_size() if axis_index(mesh, name) != src else 0)
    return t


def broadcast_mesh(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` of the mesh's first rank (every coordinate 0), in place on every
    rank of the mesh: one broadcast when the mesh spans the process group,
    else one an axis in turn (after the broadcast over an axis, every rank
    at coordinate 0 of the later axes holds the first rank's ``t``)."""
    if math.prod(mesh_shape(mesh).values()) <= 1:
        return t
    if math.prod(mesh_shape(mesh).values()) == dist.get_world_size():
        src = int(mesh.mesh.flatten()[0])
        dist.broadcast(t, src=src)
        _count("broadcast", t.numel() * t.element_size() if dist.get_rank() != src else 0)
        return t
    for a in mesh.mesh_dim_names:
        broadcast(t, mesh, a, src=0)
    return t


# -- differentiable collectives over ``model`` -----------------------------------


def _sum_flat(grads: list, mesh) -> list:
    """``sum_in_rank_order`` over ``model`` of every tensor of ``grads``, one
    collective a dtype: the tensors are flattened into one buffer, summed,
    and cut apart (an elementwise sum, so the same bits as a sum a
    tensor)."""
    out = list(grads)
    for dtype in sorted({g.dtype for g in grads}, key=str):
        idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        total, off = sum_in_rank_order(flat, mesh, "model"), 0
        for i in idx:
            out[i] = total[off:off + grads[i].numel()].view_as(grads[i])
            off += grads[i].numel()
    return out


class _EnterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_sum_flat([g.contiguous() for g in gs], ctx.mesh))


class _SumModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, y):
        return sum_in_rank_order(y, mesh, "model")

    @staticmethod
    def backward(ctx, g):
        return None, g


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, dims, *ys):
        ctx.dims, ctx.sizes = dims, [y.shape[d] for y, d in zip(ys, dims)]
        ctx.rank = axis_index(mesh, "model")
        return tuple(gather_leaves(list(ys), list(dims), mesh, "model"))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *(g.narrow(d, ctx.rank * n, n)
                              for g, d, n in zip(gs, ctx.dims, ctx.sizes)))


def enter_model(xs, mesh):
    """Enter a region whose work the ``model`` ranks split: ``xs`` (a tensor
    or a tuple of tensors, each whole and the same bits on every rank) as
    they are; in the backward each gradient, this rank's part of the
    whole, is summed over ``model`` in rank order (one collective for all
    of ``xs``).  Identity on a size-1 axis or outside autograd."""
    single = isinstance(xs, torch.Tensor)
    ts = (xs,) if single else tuple(xs)
    if axis_size(mesh, "model") > 1 and torch.is_grad_enabled() and any(
            t.requires_grad for t in ts):
        ts = _EnterModel.apply(mesh, *ts)
    return ts[0] if single else ts


def sum_model(y: torch.Tensor, mesh) -> torch.Tensor:
    """Leave a split region through a sum: ``sum_in_rank_order`` over
    ``model``; the gradient passes through unchanged (each rank's partial
    contributed to every rank's sum)."""
    if axis_size(mesh, "model") == 1:
        return y
    if torch.is_grad_enabled() and y.requires_grad:
        return _SumModel.apply(mesh, y)
    return sum_in_rank_order(y, mesh, "model")


def gather_model(y: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """Leave a split region through a gather: ``all_gather`` over ``model``
    along ``dim``; the gradient of the whole is cut to this rank's slice."""
    return gather_model_leaves([y], [dim], mesh)[0]


def gather_model_leaves(ys: list, dims: list, mesh) -> list:
    """``gather_model`` of each of ``ys`` along its ``dims`` entry in one
    collective (``gather_leaves``; every tensor one dtype)."""
    if axis_size(mesh, "model") == 1 or not ys:
        return list(ys)
    if torch.is_grad_enabled() and any(y.requires_grad for y in ys):
        return list(_GatherModel.apply(mesh, tuple(dims), *ys))
    return gather_leaves(list(ys), list(dims), mesh, "model")


# -- FSDP: leaves gathered whole over ``data`` at use ---------------------------------


def _watch(ts) -> None:
    """Add the bytes of ``ts`` (fresh tensors, one storage each) to
    ``GATHERED`` until each storage is freed."""
    for t in ts:
        st = t.untyped_storage()
        nbytes = st.nbytes()
        with _GATHERED_LOCK:
            GATHERED["live"] += nbytes
            GATHERED["peak"] = max(GATHERED["peak"], GATHERED["live"])
        weakref.finalize(st, _unwatch, nbytes)


def _unwatch(nbytes: int) -> None:
    with _GATHERED_LOCK:
        GATHERED["live"] -= nbytes


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, dims, axes, *ys):
        ctx.mesh, ctx.dims, ctx.axes = mesh, dims, axes
        ctx.sizes = [y.shape[d] for y, d in zip(ys, dims)]
        ctx.rank = axis_index(mesh, "data")
        out = gather_leaves(list(ys), list(dims), mesh, "data", kind="fsdp-gather")
        _watch(out)
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        if ctx.axes is None:  # every rank ran the whole batch: its own slice
            return (None, None, None, *(g.narrow(d, ctx.rank * n, n)
                                        for g, d, n in zip(gs, ctx.dims, ctx.sizes)))
        n = math.prod(axis_size(ctx.mesh, a) for a in ctx.axes)
        parts = reduce_scatter_leaves([g.contiguous() for g in gs], list(ctx.dims), ctx.mesh,
                                      ctx.axes)
        return (None, None, None, *(p / n for p in parts))


def gather_data(ys: list, dims: list, mesh, axes=None) -> list:
    """Each of ``ys`` (shards on ``data`` along its ``dims`` entry, one
    dtype) gathered whole over ``data`` in one collective
    (``gather_leaves``), under autograd differentiable: with ``axes`` (the
    pure data axes the caller split the batch rows over, ``("pod",
    "data")``) each gradient leaves through ``reduce_scatter_leaves`` over
    them, divided by their rank count (the mean of the ranks' gradients,
    as the trainer takes it), so it arrives summed and cut to this rank's
    shard; with none (every rank ran the whole batch) it is cut to this
    rank's slice.  The gather counts in ``STATS`` as ``"fsdp-gather"``, and
    the outputs count in ``GATHERED`` while they live."""
    if axis_size(mesh, "data") == 1 or not ys:
        return list(ys)
    if torch.is_grad_enabled() and any(y.requires_grad for y in ys):
        return list(_GatherData.apply(mesh, tuple(dims), axes, *ys))
    out = gather_leaves(list(ys), list(dims), mesh, "data", kind="fsdp-gather")
    _watch(out)
    return out


# -- the totals of a batch whose rows the ranks split --------------------------------


def _totals(mesh, axes, s, counts) -> tuple:
    e = s.numel()
    # fp64 carries the fp32 values and the counts exactly
    parts = gather_axes(torch.cat([s.double(), counts.double()]), mesh, axes)
    total = parts[0, :e].to(s.dtype)
    for p in parts[1:, :e]:
        total = total + p.to(s.dtype)
    return total, parts[:, e:].to(counts.dtype)


class _BatchTotals(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, s, counts):
        ctx.n = math.prod(axis_size(mesh, a) for a in axes)
        return _totals(mesh, axes, s, counts)

    @staticmethod
    def backward(ctx, g, _):
        return None, None, g * ctx.n, None


def batch_totals(s: torch.Tensor, counts: torch.Tensor, mesh, axes) -> tuple:
    """Over the ranks of the axes ``axes`` that split one batch's rows
    (flattened row-major, ``axes_index``), in one all-gather: the sum of the
    float vector ``s`` added in rank order (the same bits on every rank),
    and every rank's integer ``counts``, (n, *counts.shape) in rank order.
    Under autograd the sum passes its gradient back times n: every rank's
    loss reads the sum alike, and the trainer averages the ranks'
    gradients (``train/step.py``), so the n equal gradients of the sum are
    this rank's share n times over."""
    axes = _live_axes(mesh, axes)
    if not axes:
        return s, counts[None]
    if torch.is_grad_enabled() and s.requires_grad:
        return _BatchTotals.apply(mesh, axes, s, counts)
    return _totals(mesh, axes, s, counts)
