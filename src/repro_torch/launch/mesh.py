"""Mesh construction over ``torch.distributed``.

Port of the JAX package's ``launch/mesh.py``.  JAX places one program over
a mesh of devices; here, in PyTorch's idiom, each mesh position is a
process (a rank) running the same code, and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the dims ``("data",
"model")``, or ``("pod", "data", "model")`` with a pod axis above 1, over
the ranks of the default process group.  ``spawn`` starts those ranks on
one machine.

The collective backend is always the caller's choice: ``nccl`` for one GPU
per rank, ``gloo`` for ranks that share a GPU or run on the CPU (gloo
takes CUDA tensors for the collectives the port uses).  Nothing here
switches backend or device by itself; a mesh that cannot run as asked
raises.  Functions, not module constants: importing this module touches no
process group.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import math
import os
import pickle
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

__all__ = ["AXES", "make_production_mesh", "make_local_mesh", "make_serve_mesh",
           "parse_mesh", "check_backend", "rank_device", "spawn", "rank0_prints"]

AXES = ("data", "model")
BACKENDS = ("nccl", "gloo")


def _device_type() -> str:
    """The device type of this rank's mesh: ``cuda`` when the process group
    was started with a CUDA rank device (``spawn`` records it), else
    ``cpu``."""
    return os.environ.get("REPRO_MESH_DEVICE_TYPE", "cpu")


def _mesh(shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    name, need = "x".join(map(str, shape)), math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {name} mesh needs {need} ranks in a process group: start them with "
            "repro_torch.launch.mesh.spawn (or torch.distributed.init_process_group) first"
        )
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"mesh {name} needs {need} ranks but the process group has {world}")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """Production mesh: 16x16 ("data", "model") over 256 ranks, or 2x16x16
    ("pod", "data", "model") over 512.  The ``pod`` axis is pure data
    parallelism, ``data`` carries DP and FSDP, ``model`` tensor parallelism
    (``dist/sharding.py``).  Any other world size raises."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod",) + AXES if multi_pod else AXES
    return _mesh(shape, names)


def make_local_mesh(data: int = 1, model: int = 1, pod: int = 1):
    """A (data, model) mesh over the ranks of the process group, or with
    ``pod`` above 1 a (pod, data, model) one (``pod`` pure data
    parallelism, the reference's names)."""
    if pod > 1:
        return _mesh((pod, data, model), ("pod",) + AXES)
    return _mesh((data, model), AXES)


def parse_mesh(spec: str) -> tuple:
    """``"dp,tp"`` -> (dp, tp), with the reference's messages."""
    try:
        data, model = (int(p) for p in spec.split(","))
    except ValueError as e:
        raise ValueError(f"--mesh expects 'dp,tp' (e.g. '2,4'), got {spec!r}") from e
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data}, model={model}")
    return data, model


def make_serve_mesh(spec: str):
    """A serving mesh from a ``"dp,tp"`` spec (``launch/serve.py --mesh``):
    data-parallel dp x tensor-parallel tp.  ``"1,1"`` is the degenerate
    single-device mesh, which the serve stack treats exactly like no mesh.
    Raises with an actionable message when the process group does not hold
    dp * tp ranks."""
    data, model = parse_mesh(spec)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if data * model != have:
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} ranks but {have} exist; start them "
            f"with repro_torch.launch.mesh.spawn(fn, {data}, {model}, backend, device)"
        )
    return make_local_mesh(data, model)


def check_backend(backend: str, device: str, world: int) -> None:
    """Refuse a backend and device that cannot run ``world`` ranks: an
    unknown backend, ``nccl`` off the card, or ``nccl`` with fewer GPUs than
    ranks (NCCL refuses two ranks on one device; ranks that share a card
    take ``gloo``)."""
    if backend not in BACKENDS:
        raise ValueError(f"dist backend must be one of {BACKENDS}, got {backend!r}")
    kind = torch.device(device).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"mesh ranks run on 'cpu' or 'cuda', got {device!r}")
    if backend == "nccl":
        if kind != "cuda":
            raise ValueError("the nccl backend needs CUDA ranks; on the CPU use gloo")
        have = torch.cuda.device_count()
        if have < world:
            raise ValueError(
                f"nccl needs one GPU per rank: {world} ranks but {have} GPU(s) visible; for "
                "ranks that share a GPU use --dist-backend gloo"
            )
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA ranks asked for, but no CUDA device is available")


def rank_device(backend: str, device: str, rank: int) -> torch.device:
    """The device of ``rank``: the CPU, GPU ``rank`` under nccl, or under
    gloo GPU ``rank % count`` (ranks share the cards in turn)."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    return torch.device("cuda", rank if backend == "nccl" else rank % n)


def rank0_prints(fn, *args):
    """``fn(*args)`` on this rank, its standard output dropped unless this
    is rank 0 of the process group (a launcher's ranks print once)."""
    if dist.get_rank() == 0:
        return fn(*args)
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def _rank_main(rank: int, fn, data: int, model: int, backend: str, device: str,
               init_dir: str, threads: int, args: tuple, pod: int = 1,
               timeout_s: float | None = None) -> None:
    world = pod * data * model
    dev = rank_device(backend, device, rank)
    os.environ["REPRO_MESH_DEVICE_TYPE"] = dev.type
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # the ranks share the machine's cores
        torch.set_num_threads(max(1, threads // world))
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=f"file://{init_dir}/rendezvous",
                            world_size=world, rank=rank, **kw)
    try:
        mesh = make_local_mesh(data, model, pod)
        out = fn(mesh, dev, *args)
        with open(Path(init_dir) / f"result-{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, data: int, model: int, backend: str, device: str = "cpu",
          init_dir: str | None = None, args: tuple = (), pod: int = 1,
          timeout_s: float | None = None) -> list:
    """Run ``fn(mesh, device, *args)`` on ``pod * data * model`` ranks of a
    (data, model) mesh (``make_local_mesh``; a (pod, data, model) one with
    ``pod`` above 1), one process each, and return each rank's result
    (they must pickle).  ``timeout_s`` bounds every collective (the process
    group's timeout): a rank left waiting for a partner raises instead of
    hanging.  The ranks meet through a file under ``init_dir``
    (a fresh temporary directory by default), never a fixed TCP port, so
    concurrent runs never collide.  ``backend`` and ``device`` are checked
    first (``check_backend``); a rank that fails fails the call.  Build the
    CUDA kernels before spawning: the ranks only load them."""
    import torch.multiprocessing as mp

    world = pod * data * model
    check_backend(backend, device, world)
    own = init_dir is None
    root = tempfile.mkdtemp(prefix="mesh-") if own else init_dir
    Path(root).mkdir(parents=True, exist_ok=True)
    for stale in Path(root).glob("result-*.pkl"):
        stale.unlink()
    rdzv = Path(root) / "rendezvous"
    if rdzv.exists():
        rdzv.unlink()
    mp.spawn(_rank_main,
             args=(fn, data, model, backend, device, str(root), torch.get_num_threads(), args,
                   pod, timeout_s),
             nprocs=world, join=True)
    out = []
    for rank in range(world):
        with open(Path(root) / f"result-{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    if own:
        for p in Path(root).iterdir():
            p.unlink()
        Path(root).rmdir()
    return out
