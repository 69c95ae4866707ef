"""MonitorDBStore: the mon's paxos-committed kv store.

ref: src/mon/MonitorDBStore.h — every service keeps its state under a
prefix; paxos values ARE encoded store transactions, so committing a
paxos version == applying its transaction. Backed by MemDB (tests) or
WALDB (durable).

The port's copy of ``ceph_tpu/mon/store.py``.
"""

from __future__ import annotations

from ceph_tpu_torch.os_.kv import KeyValueDB, KVTransaction, MemDB, WALDB


class MonitorDBStore:
    def __init__(self, db: KeyValueDB | None = None,
                 path: str | None = None):
        if db is None:
            db = WALDB(path) if path else MemDB()
        self.db = db

    def transaction(self) -> KVTransaction:
        return KVTransaction()

    def apply(self, t: KVTransaction) -> None:
        self.db.submit_transaction(t)

    def apply_encoded(self, blob: bytes) -> None:
        self.db.submit_transaction(KVTransaction.decode(blob))

    def get(self, prefix: str, key: str) -> bytes | None:
        return self.db.get(prefix, key)

    def get_u64(self, prefix: str, key: str, default: int = 0) -> int:
        v = self.db.get(prefix, key)
        return int.from_bytes(v, "little") if v is not None else default

    def put_u64(self, t: KVTransaction, prefix: str, key: str,
                value: int) -> None:
        t.set(prefix, key, value.to_bytes(8, "little"))

    def iterate(self, prefix: str):
        return self.db.get_iterator(prefix)

    def close(self) -> None:
        self.db.close()
