"""Async message throttle: bounded in-flight ops + bytes.

ref: src/common/Throttle.{h,cc} — the OSD front-door throttles
(osd_client_message_cap / osd_client_message_size_cap) that keep a
flood of client ops from swamping dispatch: excess ops queue at
admission instead of dispatching, and drain FIFO as completions free
slots. Unlike the reference's blocking get(), acquisition is an
awaitable so the admission loop — not the connection reader — bears
the backpressure.

The port's copy of ``ceph_tpu/utils/throttle.py``.
"""

from __future__ import annotations

import asyncio
from collections import deque


class MessageThrottle:
    """Dual-budget throttle: concurrent ops and aggregate bytes.
    ``max_ops``/``max_bytes`` of 0 disable that budget. A single op
    larger than max_bytes still admits alone (never wedges)."""

    def __init__(self, max_ops: int = 0, max_bytes: int = 0):
        self.max_ops = max_ops
        self.max_bytes = max_bytes
        self.ops = 0
        self.bytes = 0
        self.peak_ops = 0
        self.waited = 0          # acquisitions that had to queue
        self._waiters: deque[asyncio.Future] = deque()

    def _would_block(self, nbytes: int) -> bool:
        if self.max_ops and self.ops >= self.max_ops:
            return True
        if self.max_bytes and self.bytes and \
                self.bytes + nbytes > self.max_bytes:
            return True
        return False

    async def acquire(self, nbytes: int = 0) -> None:
        while self._would_block(nbytes):
            fut = asyncio.get_event_loop().create_future()
            self._waiters.append(fut)
            self.waited += 1
            try:
                await fut
            finally:
                if not fut.done():
                    fut.cancel()
        self.ops += 1
        self.bytes += nbytes
        self.peak_ops = max(self.peak_ops, self.ops)

    def release(self, nbytes: int = 0) -> None:
        self.ops = max(0, self.ops - 1)
        self.bytes = max(0, self.bytes - nbytes)
        while self._waiters:
            fut = self._waiters.popleft()
            if not fut.done():
                fut.set_result(None)
                break

    @property
    def saturated(self) -> bool:
        return self._would_block(0)

    def dump(self) -> dict:
        return {"ops": self.ops, "bytes": self.bytes,
                "max_ops": self.max_ops, "max_bytes": self.max_bytes,
                "peak_ops": self.peak_ops, "waited": self.waited,
                "queued_waiters": len(self._waiters)}
