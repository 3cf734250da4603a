"""Write-ahead event log for the persistent-query service — the
counterpart of ``repro.streaming.wal``, byte for byte the same format, so
either package replays what the other logged.

Every ingested micro-batch (inserts, deletions, churn ops) is appended —
with its stream clock — BEFORE it is dispatched to the engine, fsync'd in
segment files. Combined with the service's periodic checkpoints this turns
crash recovery from "lose the window" into ``O(events since snapshot)``:
restore the latest committed checkpoint, then replay the WAL suffix
(records with ``lsn`` greater than the checkpoint's recorded ``wal_lsn``)
through the normal ingest path. Replay is exact — the service's result
stream is a deterministic function of the event sequence, so a restored
run reproduces the uninterrupted run's per-event results bit-identically
(tests/test_torch_supervisor.py pins this across injected fault points).

Format (crash-oriented, stdlib-only):

* one directory per log; segment files ``seg_<first_lsn:012d>.wal``;
* one record per line: ``<crc32-hex8> <json payload>\\n`` where the CRC
  covers the exact payload bytes — a torn tail write (the crash landed
  mid-``write``/pre-``fsync``) fails the CRC and replay stops THERE, never
  surfacing a half-record as events;
* payloads carry a monotonically increasing ``lsn`` (one per appended
  batch), the batch's stream clock, and the events as type-tagged tuples
  (the checkpoint interner's vertex encoding, so ``"42"`` vs ``42`` vs
  tuple vertex ids all survive the round trip);
* ``append`` writes, flushes, and (by default) fsyncs before returning —
  the record is durable before the engine ever sees the batch;
* segments rotate at ``segment_records`` appends; ``truncate_upto(lsn)``
  unlinks segments whose records are ALL covered by a committed
  checkpoint, keeping recovery cost proportional to the suffix.

Churn records (``kind="register"``/``"deregister"``) ride the same
sequence so replay can reproduce mid-stream query lifecycle too.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Iterator, List, Optional, Sequence, Tuple

from ..core.engine import _decode_vertex, _encode_vertex
from .stream import SGT

_SEG_PREFIX = "seg_"
_SEG_SUFFIX = ".wal"


@dataclasses.dataclass(frozen=True)
class WALRecord:
    """One durable log entry: a micro-batch of sgts or a churn op."""

    lsn: int
    kind: str                  # "batch" | "register" | "deregister"
    events: Tuple[SGT, ...] = ()
    clock: float = float("-inf")   # max event ts at append time
    meta: Optional[dict] = None    # churn payload (name, expr, kwargs)


def _encode_sgt(s: SGT) -> list:
    return [s.ts, _encode_vertex(s.src), _encode_vertex(s.dst), s.label, s.op]


def _decode_sgt(row: Sequence) -> SGT:
    ts, src, dst, label, op = row
    return SGT(float(ts), _decode_vertex(src), _decode_vertex(dst),
               str(label), str(op))


def _seg_name(first_lsn: int) -> str:
    return f"{_SEG_PREFIX}{first_lsn:012d}{_SEG_SUFFIX}"


def _seg_first_lsn(name: str) -> int:
    return int(name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)])


class WriteAheadLog:
    """Append-ordered, CRC-framed, segment-rotated event log.

    A fresh instance over an existing directory resumes after the last
    VALID record (a torn tail is ignored for sequencing and skipped by
    replay), so the supervisor can reopen the same log after a crash
    without any repair step.
    """

    def __init__(self, directory: str, segment_records: int = 256,
                 fsync: bool = True):
        if segment_records < 1:
            raise ValueError(
                f"segment_records must be >= 1, got {segment_records}")
        self.directory = directory
        self.segment_records = int(segment_records)
        self.fsync = bool(fsync)
        os.makedirs(directory, exist_ok=True)
        self._fh = None                 # open handle on the active segment
        self._seg_count = 0             # records in the active segment
        self._last_lsn = 0
        #: records whose CRC/JSON failed on reopen (torn tail) — counted,
        #: never surfaced as events
        self.torn_records = 0
        self._scan_existing()

    # -- append path ----------------------------------------------------------

    @property
    def last_lsn(self) -> int:
        return self._last_lsn

    def append(self, events: Sequence[SGT]) -> int:
        """Durably log one micro-batch; returns its lsn. The record is on
        disk (flushed + fsync'd) before this returns — append BEFORE
        dispatching the batch and the batch can always be replayed."""
        events = tuple(events)
        if not events:
            raise ValueError("refusing to log an empty batch")
        clock = max(s.ts for s in events)
        return self._write({
            "kind": "batch",
            "clock": clock,
            "events": [_encode_sgt(s) for s in events],
        })

    def append_churn(self, kind: str, name: str,
                     meta: Optional[dict] = None) -> int:
        """Log a query-lifecycle op (kind = "register" | "deregister") so
        replay reproduces mid-stream churn in sequence with the batches."""
        if kind not in ("register", "deregister"):
            raise ValueError(f"unknown churn kind {kind!r}")
        return self._write({"kind": kind, "name": name, "meta": meta or {}})

    def _write(self, payload: dict) -> int:
        self._last_lsn += 1
        payload["lsn"] = self._last_lsn
        blob = json.dumps(payload, sort_keys=True).encode("utf-8")
        line = f"{zlib.crc32(blob) & 0xFFFFFFFF:08x} ".encode("ascii") \
            + blob + b"\n"
        if self._fh is None or self._seg_count >= self.segment_records:
            self._rotate(self._last_lsn)
        self._fh.write(line)
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
        self._seg_count += 1
        return self._last_lsn

    def _rotate(self, first_lsn: int) -> None:
        if self._fh is not None:
            self._fh.close()
        path = os.path.join(self.directory, _seg_name(first_lsn))
        self._fh = open(path, "ab")
        self._seg_count = 0

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -- replay / recovery ----------------------------------------------------

    def _segments(self) -> List[str]:
        names = [n for n in os.listdir(self.directory)
                 if n.startswith(_SEG_PREFIX) and n.endswith(_SEG_SUFFIX)]
        return sorted(names, key=_seg_first_lsn)

    def _scan_existing(self) -> None:
        """Resume sequencing after the last valid record on disk."""
        segs = self._segments()
        if not segs:
            return
        for rec in self._iter_records(segs[:-1]):
            self._last_lsn = max(self._last_lsn, rec.lsn)
        # the newest segment seeds the rotation counter and is reopened for
        # append — TRUNCATED back to the end of its last valid record
        # first, else a torn tail would sit between old records and new
        # appends and replay (which stops at the tear) could never reach
        # anything written after recovery
        self._seg_count = 0
        path = os.path.join(self.directory, segs[-1])
        valid_end = 0
        with open(path, "rb") as f:
            for raw in f:
                rec = self._parse(raw)
                if rec is None:
                    self.torn_records += 1
                    break
                self._last_lsn = max(self._last_lsn, rec.lsn)
                self._seg_count += 1
                valid_end += len(raw)
        if valid_end < os.path.getsize(path):
            with open(path, "r+b") as f:
                f.truncate(valid_end)
        self._fh = open(path, "ab")

    def _iter_records(self, seg_names: Sequence[str]) -> Iterator[WALRecord]:
        for i, name in enumerate(seg_names):
            path = os.path.join(self.directory, name)
            with open(path, "rb") as f:
                for raw in f:
                    rec = self._parse(raw)
                    if rec is None:
                        # CRC/JSON failure: a torn tail is expected on the
                        # LAST segment (the crash interrupted the write);
                        # anywhere else it still only truncates replay —
                        # events after a torn record cannot be trusted to
                        # be in sequence
                        self.torn_records += 1
                        return
                    yield rec

    def _parse(self, raw: bytes) -> Optional[WALRecord]:
        line = raw.rstrip(b"\n")
        if len(line) < 10 or line[8:9] != b" ":
            return None
        blob = line[9:]
        try:
            if int(line[:8], 16) != (zlib.crc32(blob) & 0xFFFFFFFF):
                return None
            payload = json.loads(blob.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return None
        kind = payload.get("kind", "batch")
        if kind == "batch":
            return WALRecord(
                lsn=int(payload["lsn"]), kind=kind,
                events=tuple(_decode_sgt(r) for r in payload["events"]),
                clock=float(payload.get("clock", float("-inf"))))
        return WALRecord(lsn=int(payload["lsn"]), kind=kind,
                         meta={"name": payload.get("name"),
                               **payload.get("meta", {})})

    def replay(self, after_lsn: int = 0) -> Iterator[WALRecord]:
        """Records with ``lsn > after_lsn`` in append order — feed the
        checkpoint's ``wal_lsn`` here and the suffix reconstructs the
        crashed run exactly. Stops silently at a torn tail record."""
        for rec in self._iter_records(self._segments()):
            if rec.lsn > after_lsn:
                yield rec

    # -- compaction -----------------------------------------------------------

    def truncate_upto(self, lsn: int) -> int:
        """Unlink segments whose EVERY record has ``lsn <= lsn`` (i.e. is
        covered by a committed checkpoint). Returns the number of segments
        dropped. The active segment is never unlinked — the open handle
        keeps appending to it."""
        segs = self._segments()
        dropped = 0
        # a segment's records are all below the NEXT segment's first lsn,
        # so seg[i] is fully covered iff first_lsn(seg[i+1]) <= lsn + 1
        for i in range(len(segs) - 1):    # never the active (last) segment
            if _seg_first_lsn(segs[i + 1]) <= lsn + 1:
                os.unlink(os.path.join(self.directory, segs[i]))
                dropped += 1
            else:
                break
        return dropped

    def __len__(self) -> int:
        return sum(1 for _ in self._iter_records(self._segments()))
