"""Checksummed write-ahead log for ``DumpyIndex.insert_many`` batches (port
of ``repro.robustness.wal``; the same frame, so a log written by either
package replays in the other).

One WAL file per index *generation* (``wal-<gen>.log`` next to the
generation directories — see ``core/index.py``).  ``insert_many`` appends
the batch here *before* mutating in-memory state; ``DumpyIndex.load``
replays every intact record on top of the loaded generation, recovering
inserts that never made it into a ``save()``.

Record framing (little-endian)::

    magic "DWAL" | payload_len u64 | sha256(payload) 32B | payload

where the payload is the ``.npy`` serialization of the ``[m, n] float32``
batch.  Replay walks records front-to-back and stops at the first frame
that fails any check (short header, bad magic, short payload, digest
mismatch) — a crash mid-append leaves a torn *tail*, never a torn prefix,
because records are appended with a single buffered write + fsync and a
recoverable mid-append failure truncates back to the pre-append offset
before the retry.  ``replay(repair=True)`` (the default) also truncates
the file back to the last intact record so the next append continues from
a clean tail.
"""
from __future__ import annotations

import hashlib
import io
import os
import struct

import numpy as np

from .failpoints import failpoint, is_armed, with_retries

MAGIC = b"DWAL"
_HEADER = struct.Struct("<4sQ32s")


class WriteAheadLog:
    def __init__(self, path: str):
        self.path = str(path)

    def exists(self) -> bool:
        return os.path.exists(self.path)

    # -- append --------------------------------------------------------------
    def append(self, batch: np.ndarray) -> None:
        """Durably append one insert batch (failpoint site ``wal.append``,
        retried with backoff; ``wal.append.tear`` simulates a torn write by
        crashing after half the frame is on disk)."""
        batch = np.ascontiguousarray(np.atleast_2d(batch), np.float32)
        buf = io.BytesIO()
        np.save(buf, batch, allow_pickle=False)
        payload = buf.getvalue()
        frame = _HEADER.pack(MAGIC, len(payload),
                             hashlib.sha256(payload).digest()) + payload

        def _write():
            failpoint("wal.append")
            with open(self.path, "ab") as fh:
                start = fh.tell()
                try:
                    if is_armed("wal.append.tear"):
                        fh.write(frame[: max(len(frame) // 2, 1)])
                        fh.flush()
                        os.fsync(fh.fileno())
                        failpoint("wal.append.tear")   # expected: crash/exit
                        # the armed action declined to fire: undo the tear
                        fh.truncate(start)
                        fh.seek(start)
                    fh.write(frame)
                    fh.flush()
                    os.fsync(fh.fileno())
                except Exception:
                    # recoverable mid-append failure: roll back to the
                    # pre-append offset so a retry starts from a clean tail
                    # (InjectedCrash is a BaseException and skips this —
                    # crashes are supposed to leave the torn bytes behind)
                    try:
                        fh.truncate(start)
                    except OSError:
                        pass
                    raise

        with_retries(_write, site="wal.append")

    # -- replay --------------------------------------------------------------
    def replay(self, repair: bool = True) -> list[np.ndarray]:
        """Every intact batch, in append order.  Stops at the first torn or
        corrupt frame; with ``repair`` the file is truncated back to the
        last intact record."""
        if not os.path.exists(self.path):
            return []
        with open(self.path, "rb") as fh:
            data = fh.read()
        batches: list[np.ndarray] = []
        off = good_end = 0
        while off + _HEADER.size <= len(data):
            magic, ln, digest = _HEADER.unpack_from(data, off)
            payload = data[off + _HEADER.size: off + _HEADER.size + ln]
            if magic != MAGIC or len(payload) < ln \
                    or hashlib.sha256(payload).digest() != digest:
                break
            batches.append(np.load(io.BytesIO(payload), allow_pickle=False))
            off += _HEADER.size + ln
            good_end = off
        if repair and good_end < len(data):
            with open(self.path, "r+b") as fh:
                fh.truncate(good_end)
        return batches

    def reset(self) -> None:
        """Start a fresh (empty) log."""
        if os.path.exists(self.path):
            os.remove(self.path)
