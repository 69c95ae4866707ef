"""Block allocator for the BlueStore-style store.

ref: src/os/bluestore/BitmapAllocator (via Allocator.h) — tracks free
space in ALLOCATION UNITS over a flat block device. This one is a
numpy bitmap with a rolling first-fit cursor: allocation takes the
first free AUs at-or-after the cursor (wrapping once), grouped into
contiguous extents — fragmented results are fine, the caller's extent
map absorbs them, exactly like BlueStore's PExtentVector.

The port's copy of ``ceph_tpu/os_/allocator.py``.
"""

from __future__ import annotations

import numpy as np


class AllocatorError(Exception):
    pass


class BitmapAllocator:
    """Free-space bitmap in allocation units."""

    def __init__(self, total_aus: int):
        self.total = int(total_aus)
        self.used = np.zeros(self.total, dtype=bool)
        self._cursor = 0

    @property
    def free_aus(self) -> int:
        return self.total - int(self.used.sum())

    def allocate(self, n: int) -> list[tuple[int, int]]:
        """n AUs as [(start_au, n_aus), ...] extents, or raise ENOSPC.

        First-fit from the rolling cursor (wraps once) — the cursor
        keeps sequential workloads laying data forward instead of
        re-scanning the device head every call."""
        if n <= 0:
            return []
        free_idx = np.flatnonzero(~self.used)
        if free_idx.size < n:
            raise AllocatorError(
                f"ENOSPC: want {n} AUs, have {free_idx.size}")
        at = np.searchsorted(free_idx, self._cursor)
        picked = np.concatenate([free_idx[at:], free_idx[:at]])[:n]
        picked.sort()
        self.used[picked] = True
        self._cursor = int(picked[-1]) + 1
        if self._cursor >= self.total:
            self._cursor = 0
        # group consecutive AUs into extents
        cuts = np.flatnonzero(np.diff(picked) != 1) + 1
        out = []
        for run in np.split(picked, cuts):
            out.append((int(run[0]), int(run.size)))
        return out

    def release(self, extents: list[tuple[int, int]]) -> None:
        for start, cnt in extents:
            if start < 0 or start + cnt > self.total:
                raise AllocatorError(f"free out of range: {start}+{cnt}")
            self.used[start:start + cnt] = False

    def mark_used(self, extents: list[tuple[int, int]]) -> None:
        """Mount-time claim (rebuilding state from the onode extents)."""
        for start, cnt in extents:
            if start < 0 or start + cnt > self.total:
                raise AllocatorError(
                    f"claim out of range: {start}+{cnt}")
            if self.used[start:start + cnt].any():
                raise AllocatorError(
                    f"double allocation at {start}+{cnt}")
            self.used[start:start + cnt] = True
