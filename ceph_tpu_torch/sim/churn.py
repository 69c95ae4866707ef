"""Map-churn rebalance simulator.

Replays a sequence of cluster events (osd down/out/up/in/reweight/add)
against an OSDMap and measures the placement delta each epoch causes:
how many PGs remapped, how many shard-slots moved (the proxy for data
migration volume), and whether placement converges back to full sets.

ref: the thrash suites (qa/tasks/ceph_manager.py Thrasher) exercise this
live against daemons; src/tools/osdmaptool.cc --test-map-pgs measures the
static distribution. Here the whole cluster's placement is recomputed per
epoch as one batched CRUSH program, so a 100M-PG churn sweep is a handful
of device steps. The port's copy of ``ceph_tpu/sim/churn.py``; the
placement runs where the OSDMap's CRUSH step runs (CUDA unless the map
was made with ``device="cpu"``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ceph_tpu_torch.crush.types import ITEM_NONE, WEIGHT_ONE
from ceph_tpu_torch.osd.osdmap import OSDMap


@dataclass(frozen=True)
class ChurnEvent:
    """One cluster mutation. kind: down|up|out|in|reweight|add."""

    kind: str
    osd: int
    weight: int = WEIGHT_ONE
    bucket: int | None = None  # for `add`: CRUSH bucket to link under


@dataclass
class StepReport:
    """Placement delta produced by one event."""

    epoch: int
    event: ChurnEvent
    pgs_total: int
    pgs_remapped: int
    shards_moved: int
    shards_total: int
    degraded_pgs: int  # rows with at least one NONE slot
    primaries_changed: int

    @property
    def moved_fraction(self) -> float:
        return self.shards_moved / max(self.shards_total, 1)

    def to_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "event": f"{self.event.kind} osd.{self.event.osd}",
            "pgs_remapped": self.pgs_remapped,
            "shards_moved": self.shards_moved,
            "moved_fraction": round(self.moved_fraction, 6),
            "degraded_pgs": self.degraded_pgs,
            "primaries_changed": self.primaries_changed,
        }


def _delta(prev_up, prev_p, up, p, positional: bool) -> dict:
    if positional:
        moved = (prev_up != up) & ~((prev_up == ITEM_NONE) &
                                    (up == ITEM_NONE))
        shards_moved = int(moved.sum())
    else:
        # replicated sets are order-insensitive for data placement:
        # count shards now on osds that didn't hold the PG before
        fresh = ~(up[:, :, None] == prev_up[:, None, :]).any(axis=2)
        shards_moved = int((fresh & (up != ITEM_NONE)).sum())
    remapped = int(((prev_up != up).any(axis=1)).sum())
    return {
        "pgs_remapped": remapped,
        "shards_moved": shards_moved,
        "primaries_changed": int((prev_p != p).sum()),
    }


class ChurnSim:
    """Drive an OSDMap through events, recording per-epoch deltas."""

    def __init__(self, osdmap: OSDMap, pool_id: int):
        self.map = osdmap
        self.pool_id = pool_id
        self.pool = osdmap.pools[pool_id]
        self.history: list[StepReport] = []
        self._up, self._primary, _, _ = osdmap.map_pool(pool_id)

    def apply(self, ev: ChurnEvent) -> StepReport:
        m = self.map
        if ev.kind == "down":
            m.mark_down(ev.osd)
        elif ev.kind == "up":
            m.mark_up(ev.osd)
        elif ev.kind == "out":
            m.mark_out(ev.osd)
        elif ev.kind == "in":
            m.mark_in(ev.osd)
        elif ev.kind == "reweight":
            m.set_weight(ev.osd, ev.weight)
        elif ev.kind == "add":
            bucket = ev.bucket
            if bucket is None:
                # least-loaded host-type bucket (type of the leaf parents)
                hosts = [b for b in m.crush.buckets.values()
                         if b.items and all(i >= 0 for i in b.items)]
                bucket = min(hosts, key=lambda b: b.size).id
            m.insert_crush_item(ev.osd, ev.weight, bucket)
        elif ev.kind == "rm":
            m.remove_crush_item(ev.osd)
        else:
            raise ValueError(f"unknown event kind {ev.kind!r}")
        up, primary, _, _ = m.map_pool(self.pool_id)
        d = _delta(self._up, self._primary, up, primary,
                   positional=not self.pool.can_shift_osds())
        rep = StepReport(
            epoch=m.epoch, event=ev,
            pgs_total=up.shape[0],
            shards_total=up.size,
            degraded_pgs=int((up == ITEM_NONE).any(axis=1).sum()),
            **d)
        self._up, self._primary = up, primary
        self.history.append(rep)
        return rep

    def run(self, events: list[ChurnEvent]) -> list[StepReport]:
        return [self.apply(ev) for ev in events]

    def random_thrash(self, rng: np.random.Generator, steps: int,
                      revive: bool = True) -> list[StepReport]:
        """Thrasher-style chaos: random down/out with matching revives
        (ref: qa/tasks/ceph_manager.py Thrasher.thrash_while_going)."""
        reports = []
        downed: list[int] = []
        for _ in range(steps):
            if downed and (revive and rng.random() < 0.5):
                osd = downed.pop(rng.integers(len(downed)))
                reports.append(self.apply(ChurnEvent("up", osd)))
                reports.append(self.apply(ChurnEvent("in", osd)))
            else:
                alive = [o for o in range(self.map.max_osd)
                         if self.map.is_up(o) and o not in downed]
                if len(alive) <= self.pool.size:
                    continue
                osd = int(rng.choice(alive))
                downed.append(osd)
                reports.append(self.apply(ChurnEvent("down", osd)))
                reports.append(self.apply(ChurnEvent("out", osd)))
        return reports

    def summary(self) -> dict:
        tot_moved = sum(r.shards_moved for r in self.history)
        return {
            "events": len(self.history),
            "final_epoch": self.map.epoch,
            "total_shards_moved": tot_moved,
            "final_degraded_pgs": (self.history[-1].degraded_pgs
                                   if self.history else 0),
        }
