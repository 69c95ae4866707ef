"""Object stores: the key-value layer, MemStore, WALStore and BlueStore
(the port's copy of ``ceph_tpu/os_/``; host-only, no device code)."""

from ceph_tpu_torch.os_.kv import WALDB, KeyValueDB, KVTransaction, MemDB
from ceph_tpu_torch.os_.objectstore import (
    ChecksumError, MemStore, ObjectStore, StoreError, Transaction,
    WALStore,
)

__all__ = [
    "KeyValueDB", "KVTransaction", "MemDB", "WALDB",
    "ObjectStore", "Transaction", "MemStore", "WALStore",
    "StoreError", "ChecksumError",
]
