"""Logical-axis sharding rules: ParamSpec trees -> placements.

Port of the JAX package's ``dist/sharding.py``.  One table maps each
*logical* axis name (the ``axes`` of every :class:`ParamSpec`) to a *mesh*
axis, the standard 2D TP x FSDP layout:

* ``model`` carries tensor/expert parallelism (vocab, ff, attention heads,
  experts, SSM inner dims);
* ``data`` carries data parallelism and, for parameters, FSDP: the
  ``embed`` (d_model) axis of weights is sharded over ``data``, so
  parameters and optimizer state scale out with the DP degree;
* an optional ``pod`` axis is pure data parallelism.

A placement is a tuple with one entry per tensor dim: ``None`` (whole on
every rank), a mesh axis name, or a tuple of names (the batch over
("pod", "data")): the counterpart of a ``PartitionSpec``.  Every rule
degrades to replication, never to an error: a dim is sharded only when
the mesh axis exists, has size > 1, is not already used by an earlier dim
of the same tensor, and divides the dim.  The rules take a DeviceMesh or a
plain {axis: size} mapping; ``local_shard`` and ``gather_whole`` move a
tensor between its whole form and a rank's shard, and ``gather_to_first``
brings a leaf whole to the host of the mesh's first rank alone (a
checkpoint's writer).
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.common import ParamSpec
from .comm import _count, all_gather, axis_index, mesh_shape

__all__ = [
    "PARAM_RULES", "act_rules", "param_sharding", "params_shardings", "batch_sharding",
    "batch_shardings", "serve_shardings", "window_sharding", "block_sharding",
    "shard_ranges", "local_shard", "gather_whole", "mesh_coords", "gather_to_first",
    "shard_tree", "gather_tree",
]


# logical parameter axis -> mesh axis (None = always replicate)
PARAM_RULES: Dict[str, Optional[str]] = {
    # tensor parallel (wide matmul dims)
    "vocab": "model",
    "ff": "model",
    "heads": "model",
    "kv_heads": "model",
    "experts": "model",
    "ssm_inner": "model",
    "rglru": "model",
    # FSDP: shard the shared d_model axis over the data axis
    "embed": "data",
    # deliberately replicated
    "rglru_out": None,
    "embed2": None,
}


def act_rules(mesh) -> Dict[str, object]:
    """Activation rules (``models.common.mesh_context``): activations stay
    whole on the embed axis; the batch axis spans every pure-DP mesh
    axis."""
    batch_axes = _batch_axes(mesh)
    return {
        "batch": batch_axes if len(batch_axes) > 1 else (batch_axes[0] if batch_axes else None),
        "ff": "model",
        "heads": "model",
        "kv_heads": "model",
        "vocab": "model",
        "ssm_inner": "model",
        "rglru": "model",
        "embed": None,
    }


def _divisible(dim: int, shape: dict, axes) -> bool:
    size = math.prod(shape[a] for a in axes)
    return size > 1 and dim % size == 0


def param_sharding(spec: ParamSpec, mesh) -> tuple:
    """The placement of one ParamSpec under PARAM_RULES (with fallback)."""
    shape = mesh_shape(mesh)
    used = set()
    parts = []
    for dim, name in zip(spec.shape, spec.axes):
        axis = PARAM_RULES.get(name) if name else None
        if axis is not None and axis in shape and axis not in used and _divisible(
                dim, shape, (axis,)):
            parts.append(axis)
            used.add(axis)
        else:
            parts.append(None)
    return tuple(parts)


def params_shardings(spec_tree: dict, mesh) -> dict:
    """A ParamSpec tree mapped to a placement tree."""
    return {k: params_shardings(v, mesh) if isinstance(v, dict) else param_sharding(v, mesh)
            for k, v in spec_tree.items()}


def _batch_axes(mesh) -> tuple:
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def _batch_entry(axes: tuple):
    return axes if len(axes) > 1 else axes[0]


def batch_sharding(mesh, batch_size: int, ndim: int) -> tuple:
    """Dim 0 (the batch) over the DP mesh axes, the rest whole."""
    axes = _batch_axes(mesh)
    if ndim == 0 or not axes or not _divisible(batch_size, mesh_shape(mesh), axes):
        return (None,) * ndim
    return (_batch_entry(axes),) + (None,) * (ndim - 1)


def batch_shardings(mesh, batch: dict) -> dict:
    """Per-entry batch placements of a dict of tensors (or anything with a
    ``shape``)."""
    return {k: batch_sharding(mesh, v.shape[0] if len(v.shape) else 1, len(v.shape))
            for k, v in batch.items()}


def serve_shardings(cache_tree: dict, mesh, batch_size: int, batch_axes=None) -> dict:
    """Placements of a decode cache: the batch dim over DP.  ``batch_axes``
    (a tree of per-leaf batch-axis ints, -1 for per-sequence scalars) pins
    each leaf's batch dim; without it the batch dim is whichever of the
    first two dims equals ``batch_size``.  Scalars stay whole."""
    axes = _batch_axes(mesh)
    first = _batch_entry(axes) if axes else None
    shardable = first is not None and _divisible(batch_size, mesh_shape(mesh), axes)

    def guess(s):
        parts = [None] * len(s.shape)
        if shardable:
            for i, d in enumerate(s.shape[:2]):
                if d == batch_size:
                    parts[i] = first
                    break
        return tuple(parts)

    def structural(s, ax):
        parts = [None] * len(s.shape)
        if shardable and ax >= 0:
            parts[ax] = first
        return tuple(parts)

    def walk(tree, ax_tree):
        out = {}
        for k, v in tree.items():
            ax = None if ax_tree is None else ax_tree[k]
            if isinstance(v, dict):
                out[k] = walk(v, ax)
            else:
                out[k] = guess(v) if ax is None else structural(v, ax)
        return out

    return walk(cache_tree, batch_axes)


def window_sharding(mesh, n_windows: int, ndim: int, axis: int = 0) -> tuple:
    """The placement of a packed-weight array along its window axis: over
    ``model`` when that axis exists, has size > 1 and divides the window
    count (packs are padded to divide at pack time, ``shard_windows``),
    else whole.  Positions and scales take the values' placement."""
    parts = [None] * ndim
    if "model" in mesh_shape(mesh) and _divisible(n_windows, mesh_shape(mesh), ("model",)):
        parts[axis] = "model"
    return tuple(parts)


def block_sharding(mesh, n_blocks: int, ndim: int, axis: int = 1) -> tuple:
    """The placement of a paged-arena leaf ``(L, n_blocks, page, ...)``: its
    block axis over the DP mesh axes, as the slot pool's slot axis; whole
    when the DP degree is 1 or does not divide the block count."""
    axes = _batch_axes(mesh)
    parts = [None] * ndim
    if axes and _divisible(n_blocks, mesh_shape(mesh), axes):
        parts[axis] = _batch_entry(axes)
    return tuple(parts)


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_ranges(shape, placement, mesh) -> list:
    """(start, size) of this rank's shard on each dim of a ``shape`` tensor
    under ``placement``: for each sharded dim, the chunk at the rank's
    coordinate (row-major over a tuple of axes); the whole dim where
    nothing shards it (and with no mesh)."""
    return _ranges_at(shape, placement, mesh_shape(mesh),
                      lambda a: axis_index(mesh, a))


def _ranges_at(shape, placement, sizes: dict, coord) -> list:
    """``shard_ranges`` of the rank whose coordinate on axis ``a`` is
    ``coord(a)``."""
    out = []
    for dim, d in enumerate(shape):
        index, n = 0, 1
        for a in _names(placement[dim] if dim < len(placement) else None):
            index, n = index * sizes[a] + coord(a), n * sizes[a]
        out.append((index * (d // n), d // n))
    return out


def local_shard(t: torch.Tensor, placement: tuple, mesh) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` under ``placement``
    (``shard_ranges``), copied to fresh memory."""
    for dim, (start, size) in enumerate(shard_ranges(t.shape, placement, mesh)):
        t = t.narrow(dim, start, size)
    return t.clone(memory_format=torch.contiguous_format)  # never a view of ``t``


def gather_whole(t: torch.Tensor, placement: tuple, mesh) -> torch.Tensor:
    """The whole tensor from every rank's shard under ``placement``: each
    sharded dim all-gathered over its axes, the innermost axis first."""
    for dim, entry in enumerate(placement):
        for a in reversed(_names(entry)):
            t = all_gather(t, mesh, a, dim=dim)
    return t


def mesh_coords(mesh) -> dict:
    """{global rank: {axis: coordinate}} of every rank of ``mesh``."""
    grid, names = mesh.mesh, mesh.mesh_dim_names
    return {int(grid[idx]): dict(zip(names, idx))
            for idx in itertools.product(*(range(n) for n in grid.shape))}


def gather_to_first(t: torch.Tensor, placement: tuple, mesh,
                    coords: Optional[dict] = None) -> Optional[np.ndarray]:
    """The whole leaf of every rank's shard ``t`` under ``placement``, as a
    numpy array on the host of the mesh's first rank (every coordinate 0);
    None on every other rank.  One rank of each distinct shard (coordinate
    0 on the axes ``placement`` leaves whole) sends it, from host memory
    (from the card where the backend is nccl), and the first rank copies
    each into its slice of the whole as it arrives: it holds the leaf whole
    and one shard beside it, the others their shard's host copy.  Every
    rank of the mesh must call it for the same leaf at once; it counts as
    one gather in ``comm.STATS``.  ``coords``: ``mesh_coords(mesh)``, made
    once by a caller that gathers many leaves."""
    sizes = mesh_shape(mesh)
    coords = mesh_coords(mesh) if coords is None else coords
    used = {a for e in placement for a in _names(e)}
    senders = sorted(r for r, c in coords.items()
                     if all(i == 0 for a, i in c.items() if a not in used))
    me = dist.get_rank()
    first = next(r for r, c in coords.items() if not any(c.values()))
    via = t.device if dist.get_backend() == "nccl" else torch.device("cpu")
    mine = t.detach().to(via).contiguous()
    if me != first:
        if me in senders:
            dist.send(mine, dst=first)
        _count("gather", 0)
        return None
    whole = np.empty([d * math.prod(sizes[a] for a in _names(e))
                      for d, e in zip(t.shape, placement)],
                     dtype=torch.empty((), dtype=t.dtype).numpy().dtype)
    buf = torch.empty_like(mine)
    for r in senders:
        if r != me:
            dist.recv(buf, src=r)
        part = (mine if r == me else buf).cpu().numpy()
        cut = tuple(slice(s, s + n) for s, n in
                    _ranges_at(whole.shape, placement, sizes, coords[r].__getitem__))
        whole[cut] = part
    _count("gather", (len(senders) - 1) * mine.numel() * mine.element_size())
    return whole


def _map_tree(fn, tree: dict, placements: dict, mesh) -> dict:
    return {k: _map_tree(fn, v, placements[k], mesh) if isinstance(v, dict)
            else None if v is None else fn(v, placements[k], mesh) for k, v in tree.items()}


def shard_tree(tree: dict, placements: dict, mesh) -> dict:
    """``local_shard`` of every leaf of a nested dict of whole tensors (None
    leaves stay None)."""
    return _map_tree(local_shard, tree, placements, mesh)


def gather_tree(tree: dict, placements: dict, mesh) -> dict:
    """``gather_whole`` of every leaf of a nested dict of shards, in the
    dict's order on every rank (None leaves stay None)."""
    return _map_tree(gather_whole, tree, placements, mesh)
