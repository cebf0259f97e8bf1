"""CRC32-framed append-only record log.

Port of the record-log half of the JAX package's ``checkpoint/ckpt.py``
(``append_record`` / ``read_records``); the tree checkpoints (save,
restore, ``Checkpointer``) come with a later slice (ROADMAP.md A11).  The
frame is byte-identical to the reference's, ``<u32 length><u32
crc32>payload``, little-endian, so a log written by either package reads
under the other.  A crash can only leave a torn record at the tail: the
reader stops at the first truncated or CRC-corrupt frame and reports how
many bytes were good, so a writer reopening after a crash truncates back to
the clean prefix and appends from there.  ``serve/journal.py`` builds the
request journal on top of this.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import BinaryIO, List, Tuple

__all__ = ["append_record", "read_records"]

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
