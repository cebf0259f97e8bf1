"""Tree checkpoints and the CRC32-framed append-only record log.

Port of the JAX package's ``checkpoint/ckpt.py``.

Tree checkpoints: each leaf is saved as its own ``.npy`` file, keyed by its
path in the tree, beside a JSON manifest.  The format is the reference's,
keys included (``params/embed``, ``params/layers/attn/wq``, ``opt/step``,
``opt/mu/...``, ``opt/nu/...``), so a checkpoint of the same leaves
crosses between the two packages in both directions.  Writes are atomic
(tmp dir + rename) and optionally asynchronous; a retention policy keeps
the newest K steps.  The manifest records each leaf's CRC32 and byte count
at save, and restore verifies them, so a truncated or bit-flipped leaf file
raises a ``ValueError`` naming the leaf instead of restoring garbage.
Manifests written before those fields existed still restore.  A tree
held as shards over a mesh is written one leaf at a time
(``save_stream``, ``train/trainer.py``): each leaf gathered whole to the
writer, written and dropped before the next, into the same files.

The record log: the frame is byte-identical to the reference's, ``<u32
length><u32 crc32>payload``, little-endian, so a log written by either
package reads under the other.  A crash can only leave a torn record at
the tail: the reader stops at the first truncated or CRC-corrupt frame and
reports how many bytes were good, so a writer reopening after a crash
truncates back to the clean prefix and appends from there.
``serve/journal.py`` builds the request journal on top of this.
"""

from __future__ import annotations

import json
import shutil
import struct
import threading
import zlib
from pathlib import Path
from typing import Any, BinaryIO, Iterable, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "save", "save_stream", "restore", "latest_step", "Checkpointer", "append_record",
    "read_records",
]

_REC_HDR = struct.Struct("<II")  # payload byte length, crc32(payload)


def append_record(fh: BinaryIO, payload: bytes) -> None:
    """Append one CRC32-framed record to ``fh``'s buffer.  Durability is the
    caller's: flush and fsync where the consistency contract demands it (the
    journal does so at segment syncs)."""
    fh.write(_REC_HDR.pack(len(payload), zlib.crc32(payload)))
    fh.write(payload)


def read_records(path: str | Path) -> Tuple[List[bytes], int, bool]:
    """Read a log written by :func:`append_record`.  Returns ``(payloads,
    clean_bytes, clean)``: every record up to (not including) the first
    truncated or CRC-corrupt frame, the byte offset of the end of the last
    good record, and whether the whole file was good.  A torn tail is the
    expected crash artifact, not an error: the caller truncates to
    ``clean_bytes`` before appending again."""
    raw = Path(path).read_bytes()
    out: List[bytes] = []
    off = 0
    while off < len(raw):
        if off + _REC_HDR.size > len(raw):
            return out, off, False  # torn header
        n, crc = _REC_HDR.unpack_from(raw, off)
        payload = raw[off + _REC_HDR.size : off + _REC_HDR.size + n]
        if len(payload) < n:
            return out, off, False  # torn payload
        if zlib.crc32(payload) != crc:
            # a flipped bit mid-file ends the read there too: every record
            # after it is untrustworthy (the framing itself may be corrupt)
            return out, off, False
        out.append(payload)
        off += _REC_HDR.size + n
    return out, off, True


# --------------------------------------------------------------------------
# tree checkpoints
# --------------------------------------------------------------------------


def _flatten(tree, prefix: str = "") -> dict:
    """``{"a/b/c": leaf}`` in the tree's own order, keyed as the reference's
    ``_flatten`` keys a pytree: dict keys sorted, a NamedTuple (``AdamState``)
    by field name in field order."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        return {prefix: tree}
    flat = {}
    for key, val in items:
        flat.update(_flatten(val, f"{prefix}/{key}" if prefix else key))
    return flat


def _unflatten(like, flat: dict, prefix: str = ""):
    """``like``'s structure with each leaf taken from ``flat`` by its key."""
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(like, dict):
        return {k: _unflatten(v, flat, key(k)) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, flat, key(f)) for f, v in zip(like._fields, like)))
    return flat[prefix]


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of one leaf: the tensor may be updated in place after."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


CRC_CHUNK = 1 << 20  # bytes a leaf file is read back in for its CRC


def _file_crc(f: Path) -> tuple:
    """(byte count, CRC32) of a file, read into one buffer of at most
    ``CRC_CHUNK`` bytes."""
    n, crc = 0, 0
    buf = memoryview(bytearray(max(min(CRC_CHUNK, f.stat().st_size), 1)))
    with open(f, "rb") as fh:
        while got := fh.readinto(buf):
            n, crc = n + got, zlib.crc32(buf[:got], crc)
    return n, crc


def save(path: str | Path, step: int, tree: Any) -> Path:
    """Atomically save a tree of tensors / arrays under ``path/step_<N>/``."""
    return save_stream(path, step, sorted(_flatten(tree).items()))


def save_stream(path: str | Path, step: int, leaves: Iterable[Tuple[str, Any]]) -> Path:
    """``save`` of a tree given as ``(key, leaf)`` pairs in sorted key order
    (``_flatten``'s keys), drawn one at a time: each leaf is written before
    the next is drawn, so a caller that makes them on demand (a leaf
    gathered whole from a mesh's shards) holds one at a time.  The files
    and the manifest are ``save``'s of the same tree, byte for byte."""
    path = Path(path)
    final = path / f"step_{step:08d}"
    tmp = path / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {}
    # a plain loop: ``enumerate`` would keep the previous pair alive while
    # the next leaf is drawn
    for key, leaf in leaves:
        arr = leaf if isinstance(leaf, np.ndarray) else _to_numpy(leaf)
        del leaf
        fname = f"leaf_{len(manifest):05d}.npy"
        np.save(tmp / fname, arr)
        shape, dtype = list(arr.shape), str(arr.dtype)
        del arr  # freed before the file is read back and the next leaf drawn
        nbytes, crc = _file_crc(tmp / fname)
        manifest[key] = {"file": fname, "shape": shape, "dtype": dtype, "nbytes": nbytes,
                         "crc32": crc}
    (tmp / "manifest.json").write_text(json.dumps({"step": step, "leaves": manifest}))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def latest_step(path: str | Path) -> Optional[int]:
    path = Path(path)
    if not path.exists():
        return None
    steps = [int(p.name[5:]) for p in path.glob("step_*") if (p / "manifest.json").exists()]
    return max(steps) if steps else None


def _load_leaf(d: Path, key: str, entry: dict) -> np.ndarray:
    """Load one leaf file, verifying it against its manifest entry.  Every
    corruption mode has its own error: a missing or truncated file, a CRC
    mismatch (bit flip), or a decoded array whose shape/dtype disagree with
    what was saved.  Pre-CRC manifests (no ``crc32``/``nbytes`` keys) skip
    the byte checks but still verify shape and dtype."""
    f = d / entry["file"]
    if not f.exists():
        raise ValueError(f"checkpoint leaf {key!r}: file {entry['file']} is missing")
    raw = f.read_bytes()
    if "nbytes" in entry and len(raw) != entry["nbytes"]:
        raise ValueError(
            f"checkpoint leaf {key!r}: file {entry['file']} is truncated or padded "
            f"({len(raw)} bytes, manifest says {entry['nbytes']})"
        )
    if "crc32" in entry and zlib.crc32(raw) != entry["crc32"]:
        raise ValueError(
            f"checkpoint leaf {key!r}: CRC mismatch in {entry['file']} "
            f"(on-disk corruption; re-fetch or fall back to an older step)"
        )
    try:
        arr = np.load(f)
    except Exception as e:
        raise ValueError(f"checkpoint leaf {key!r}: undecodable npy {entry['file']}: {e}") from e
    if list(arr.shape) != list(entry["shape"]) or str(arr.dtype) != entry["dtype"]:
        raise ValueError(
            f"checkpoint leaf {key!r}: decoded {arr.shape}/{arr.dtype}, manifest "
            f"says {tuple(entry['shape'])}/{entry['dtype']}"
        )
    return arr


def restore(path: str | Path, step: int, like: Any, shardings: Any = None,
            mesh=None) -> Any:
    """Restore step ``step`` into the structure of ``like``.  Each leaf
    lands on the device of ``like``'s leaf (a tensor), or stays a numpy
    array where ``like``'s leaf is not a tensor.  A checkpoint holds the
    logical (whole) tree, so any mesh restores it: with ``shardings`` (a
    tree of ``dist.sharding`` placements in ``like``'s structure, None
    where a leaf is whole) and ``mesh``, each placed leaf lands as this
    rank's shard."""
    from ..dist.sharding import local_shard

    d = Path(path) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())["leaves"]
    flat_shard = _flatten(shardings) if shardings is not None else {}
    out = {}
    for key, ref in _flatten(like).items():
        if key not in manifest:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = _load_leaf(d, key, manifest[key])
        if not isinstance(ref, torch.Tensor):
            out[key] = arr
            continue
        leaf = torch.from_numpy(arr).to(ref.device)
        if flat_shard.get(key) is not None:
            leaf = local_shard(leaf, flat_shard[key], mesh)
        out[key] = leaf
    return _unflatten(like, out)


class Checkpointer:
    """Async checkpoint manager with retention."""

    def __init__(self, path: str | Path, keep: int = 3, async_save: bool = True):
        self.path = Path(path)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    def _gc(self):
        steps = sorted(
            int(p.name[5:]) for p in self.path.glob("step_*") if (p / "manifest.json").exists()
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(self.path / f"step_{s:08d}", ignore_errors=True)

    def save(self, step: int, tree: Any):
        """Save ``tree`` as step ``step``.  Every leaf is copied to host
        numpy before the writer thread starts: the optimizer updates the
        tensors in place at the next step."""
        self.wait()
        flat = {k: _to_numpy(v) for k, v in _flatten(tree).items()}

        def work():
            save(self.path, step, flat)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def save_stream(self, step: int, leaves: Iterable[Tuple[str, Any]]) -> None:
        """``save_stream`` of ``leaves`` as step ``step``, on this thread
        (each leaf drawn when the previous is written), then retention."""
        self.wait()
        save_stream(self.path, step, leaves)
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, like: Any, shardings: Any = None,
                       mesh=None) -> Tuple[Optional[int], Any]:
        step = latest_step(self.path)
        if step is None:
            return None, like
        return step, restore(self.path, step, like, shardings, mesh)
