"""Refcounted per-key asyncio locks.

Several single-process daemons serialize mutations per resource path —
the MDS's per-path open lock (Locker's file-lock role) and the RGW
gateway's per-(bucket,key) bucket-index lock (the bucket-index OSD
class ops' role). Both need the same idiom: an ``asyncio.Lock`` per
live key, dropped when the last holder leaves so the table does not
grow with every key ever touched. One implementation, shared, so a
future fix (e.g. cancellation-safety of the refcount) cannot miss a
copy.

The port's copy of ``ceph_tpu/utils/locks.py``.
"""

from __future__ import annotations

import asyncio
import contextlib


class KeyedLocks:
    """``async with locks.hold(key):`` — serialize per hashable key."""

    def __init__(self) -> None:
        self._locks: dict = {}
        self._users: dict = {}

    @contextlib.asynccontextmanager
    async def hold(self, key):
        lock = self._locks.setdefault(key, asyncio.Lock())
        # refcount BEFORE awaiting the lock: the count covers waiters,
        # so the dict entry cannot be dropped (and a second Lock object
        # created) while someone is still queued on the first one
        self._users[key] = self._users.get(key, 0) + 1
        try:
            async with lock:
                yield
        finally:
            self._users[key] -= 1
            if self._users[key] <= 0:
                self._users.pop(key, None)
                self._locks.pop(key, None)
