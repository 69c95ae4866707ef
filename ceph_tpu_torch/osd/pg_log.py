"""PGLog: the per-PG ordered op log driving delta recovery.

ref: src/osd/PGLog.{h,cc} + osd_types.h eversion_t/pg_log_entry_t —
every committed write appends (version, oid, op); after an acting-set
change the primary merges the authoritative log with each peer's and
derives the peer's *missing set* (objects whose newest log version the
peer hasn't applied), which recovery then pushes
(ref: PGLog::merge_log + pg_missing_t).

The port's copy of ``ceph_tpu/osd/pg_log.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ceph_tpu_torch.encoding.denc import Decoder, Encoder

OP_MODIFY = 1
OP_DELETE = 2


class eversion(tuple):  # noqa: N801  (reference spelling: eversion_t)
    """(epoch, version) — total order across primaries
    (ref: osd_types.h eversion_t)."""

    __slots__ = ()

    def __new__(cls, epoch: int = 0, v: int = 0):
        return super().__new__(cls, (epoch, v))

    @property
    def epoch(self) -> int:
        return self[0]

    @property
    def v(self) -> int:
        return self[1]

    def __str__(self) -> str:
        return f"{self.epoch}'{self.v}"


@dataclass
class LogEntry:
    version: eversion
    oid: str
    op: int          # OP_MODIFY / OP_DELETE

    def encode(self) -> bytes:
        e = Encoder()
        e.u32(self.version.epoch).u64(self.version.v)
        e.string(self.oid).u8(self.op)
        return e.tobytes()

    @classmethod
    def decode(cls, data: bytes) -> "LogEntry":
        d = Decoder(data)
        return cls(eversion(d.u32(), d.u64()), d.string(), d.u8())


class PGLog:
    def __init__(self) -> None:
        self.entries: list[LogEntry] = []
        self.head = eversion()          # newest
        self.tail = eversion()          # oldest retained

    def append(self, entry: LogEntry) -> None:
        self.entries.append(entry)
        self.head = entry.version

    def add(self, version: eversion, oid: str, op: int) -> LogEntry:
        entry = LogEntry(version, oid, op)
        self.append(entry)
        return entry

    def trim(self, keep: int = 1000) -> None:
        """Bound the log (ref: PGLog::trim, osd_min_pg_log_entries)."""
        if len(self.entries) > keep:
            self.entries = self.entries[-keep:]
            self.tail = self.entries[0].version

    def continuous_with(self, peer_head: eversion) -> bool:
        """Can a peer whose log head is ``peer_head`` be recovered by
        log delta against this (authoritative) log?

        ref: PGLog::proc_replica_log / PeeringState choose_acting's
        backfill decision — log-delta recovery is only sound when the
        peer's last_update falls inside this log's retained window
        (peer_head >= tail): everything the peer might be missing is
        then still in ``entries``. A peer whose head predates the tail
        (including a fresh empty-log join, head == 0'0, once this log
        has been trimmed) has divergence older than anything retained —
        its missing set CANNOT be computed from the log and the peer
        must be backfilled instead. An untrimmed log (tail == 0'0)
        retains full history, so every peer is log-recoverable."""
        return self.tail == eversion() or peer_head >= self.tail

    def newest_per_object(self) -> dict[str, LogEntry]:
        out: dict[str, LogEntry] = {}
        for entry in self.entries:
            out[entry.oid] = entry
        return out

    def missing_vs(self, authoritative: "PGLog") -> dict[str, LogEntry]:
        """Objects where `authoritative` has newer state than this log
        (ref: PGLog::merge_log populating pg_missing_t). Returns
        oid -> the authoritative entry to recover to."""
        mine = self.newest_per_object()
        missing: dict[str, LogEntry] = {}
        for oid, entry in authoritative.newest_per_object().items():
            have = mine.get(oid)
            if have is None or have.version < entry.version:
                missing[oid] = entry
        return missing

    def merge(self, authoritative: "PGLog") -> dict[str, LogEntry]:
        """Adopt the authoritative log, returning this peer's missing
        set. Divergent local entries (newer than the authoritative
        head from a dead primary) are discarded, matching the
        reference's divergent-entry rollback semantics."""
        missing = self.missing_vs(authoritative)
        self.entries = list(authoritative.entries)
        self.head = authoritative.head
        self.tail = authoritative.tail
        return missing

    def encode(self) -> bytes:
        e = Encoder()
        e.u32(self.head.epoch).u64(self.head.v)
        e.u32(self.tail.epoch).u64(self.tail.v)
        e.list(self.entries, lambda e, en: e.blob(en.encode()))
        return e.tobytes()

    @classmethod
    def decode(cls, data: bytes) -> "PGLog":
        d = Decoder(data)
        log = cls()
        log.head = eversion(d.u32(), d.u64())
        log.tail = eversion(d.u32(), d.u64())
        log.entries = [LogEntry.decode(b)
                       for b in d.list(lambda d: d.blob())]
        return log
