"""Live-cluster Thrasher: a seeded random fault schedule under
continuing client writes.

ref: qa/tasks/ceph_manager.py Thrasher — the qa machinery that makes
Ceph's "handles whatever happens" claim testable: while a client keeps
writing, daemons are killed/revived, the network is partitioned and
degraded, and afterwards the cluster must (a) return to clean, (b)
still serve every acknowledged write, (c) pass a full store fsck.
This module drives a ``ceph_tpu_torch.cluster.vstart.Cluster`` through the
same storm using the fault layer in ``ceph_tpu_torch.sim.faults``.

Determinism: the whole action schedule is a **pure function of the
seed** (``Thrasher.plan``) — the run log records which scheduled
actions were applied or skipped (an action can be infeasible at
execution time, e.g. a revive with nothing down). Re-running with the
same seed replays the same schedule.

Actions (weights roughly follow the qa thrasher):

- ``kill_osd`` / ``revive_osd`` — hard-stop a random live OSD; revive
  a random downed one. When a ``store_factory`` is provided the
  revive REMOUNTS the victim's store from disk (fresh BlueStore
  instance: deferred replay + allocator rebuild — the real restart
  path, the discipline ``tests/test_bluestore.py`` established).
- ``partition`` / ``heal`` — install a bidirectional partition
  between two live OSDs (cuts both the cluster and heartbeat
  messengers); heal clears a random installed set.
- ``degrade`` — install a lossy-link set (delay + duplication +
  reorder) between the client and the OSDs for a while.
- ``kill_mon`` — kill the lead monitor (only while a majority
  survives).
- ``pause`` — let the storm breathe (recovery/elections make
  progress).

Invariants checked by ``settle_and_verify`` (the same ones the
one-off thrash tests assert):

1. the cluster converges to every-PG-clean after all faults heal;
2. every acknowledged write is readable and bit-identical;
3. every store whose backend supports ``fsck`` fscks clean;
4. the mon cluster still answers commands (quorum survived).

The port's copy of ``ceph_tpu/sim/thrasher.py``. The cluster's device
is every client's it opens. Departures, all where a reference storm
meets what the port does differently:

- ``mds_storm`` also runs on the proc backend: the cluster's MDS verbs
  go over the wire there (``ProcCluster.mds_active_name`` is a
  coroutine), and the zombie whose late journal write must bounce is a
  client under the killed incarnation's RADOS identity
  (``ProcCluster.kill_mds``).
- ``device_storm``'s probe Mapper is a port ``Mapper`` on the cluster's
  device, whose kernel path on the CPU is ``kernel-plain`` and whose
  quarantine serves ``vm`` (the reference's ``pallas-interpret`` and
  ``xla``). Every Mapper of a cluster on the CPU runs ``kernel-plain``,
  so the kernel faults are keyed to the probe's own devmon token. Its degrade legs hold only on the CPU: on the card a kernel
  failure is counted and raised, and no host path serves in its place,
  so on a cluster on the card the storm raises before it starts.
"""

from __future__ import annotations

import asyncio
import json
import random

from ceph_tpu_torch.sim import faults as F
from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("thrasher")

_WEIGHTED_ACTIONS = (
    ("kill_osd", 3), ("revive_osd", 3), ("partition", 2), ("heal", 2),
    ("degrade", 1), ("kill_mon", 1), ("pause", 3),
)


class Thrasher:
    def __init__(self, cluster, seed: int = 0,
                 store_factory=None, min_live_osds: int = 3,
                 pause_s: tuple[float, float] = (0.2, 0.8),
                 max_active_sets: int = 2,
                 write_timeout: float = 5.0):
        """``store_factory(osd_id) -> ObjectStore`` remounts a downed
        OSD's store from disk for revive-with-remount; None revives
        with the in-process store object. ``max_active_sets`` bounds
        concurrently-installed fault sets: a fully partitioned pair is
        never marked down (each end is the other's only accuser), so
        unbounded partitions would wedge every PG spanning one and
        starve the writer. ``write_timeout`` keeps storm writes short
        so the writer keeps attempting through wedged PGs."""
        self.c = cluster
        self.seed = seed
        self.store_factory = store_factory
        self.min_live_osds = min_live_osds
        self.pause_s = pause_s
        self.max_active_sets = max_active_sets
        self.write_timeout = write_timeout
        self.injector = F.FaultInjector(seed=seed)
        # the proc backend has no in-process daemons to hook: its
        # fault injection is wire-delivered per child (`ceph daemon
        # <asok> fault install`), and kill/revive are SIGNALS
        self.proc = getattr(cluster, "backend", "inproc") == "proc"
        if not self.proc:
            cluster.install_faults(self.injector)
        self.downed: list[int] = []
        self.active_sets: list[str] = []
        self.killed_mons = 0
        self.actions_log: list[str] = []   # what actually happened
        self.acked: dict[str, bytes] = {}
        self._writer_task: asyncio.Task | None = None
        self._write_seq = 0
        self._write_errors = 0

    # -- schedule (pure) ---------------------------------------------------
    @staticmethod
    def plan(seed: int, steps: int) -> list[dict]:
        """The seeded schedule: a pure function of (seed, steps) — no
        cluster state consulted, so two runs with one seed thrash
        identically. Each entry carries a raw ``pick`` the executor
        maps onto the live/downed sets at apply time."""
        rng = random.Random(seed)
        kinds = [k for k, w in _WEIGHTED_ACTIONS for _ in range(w)]
        out = []
        for _ in range(steps):
            kind = rng.choice(kinds)
            out.append({
                "op": kind,
                "pick": rng.randrange(1 << 30),
                "pick2": rng.randrange(1 << 30),
                "t": round(rng.uniform(0.0, 1.0), 4),
            })
        return out

    # -- background writer -------------------------------------------------
    async def _writer(self, io, parallel: int = 4) -> None:
        """Continuous unique-oid writes with bounded concurrency; only
        acknowledged writes are recorded (a timed-out/canceled write
        on a unique oid can't invalidate earlier acked data).
        Failures are EXPECTED mid-storm — the objecter's bounded retry
        turns them into clean errors — and parallelism keeps healthy
        PGs acking while a wedged PG waits out its timeout."""
        rng = random.Random(self.seed ^ 0x5EED)
        pending: set[asyncio.Task] = set()
        try:
            while True:
                oid = f"thrash-{self._write_seq}"
                data = bytes([self._write_seq % 256]) * \
                    rng.randint(1, 4096)
                self._write_seq += 1
                t = asyncio.ensure_future(
                    self._one_write(io, oid, data))
                pending.add(t)
                t.add_done_callback(pending.discard)
                if len(pending) >= parallel:
                    await asyncio.wait(
                        pending, return_when=asyncio.FIRST_COMPLETED)
                await asyncio.sleep(0.02)
        finally:
            for t in pending:
                t.cancel()
            await asyncio.gather(*pending, return_exceptions=True)

    async def _one_write(self, io, oid: str, data: bytes) -> None:
        try:
            await io.write_full(oid, data,
                                timeout=self.write_timeout)
            self.acked[oid] = data
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self._write_errors += 1
            log.dout(5, f"storm write {oid} failed: {e!r}")

    # -- execution ---------------------------------------------------------
    def _live_osds(self) -> list[int]:
        return [o.whoami for o in self.c.osds
                if not o._stopped and o.whoami not in self.downed]

    def _log(self, line: str) -> None:
        self.actions_log.append(line)
        log.dout(1, f"thrash: {line}")

    async def _apply(self, a: dict) -> None:
        op, pick, pick2 = a["op"], a["pick"], a["pick2"]
        if op == "pause":
            lo, hi = self.pause_s
            self._log(f"pause {lo + (hi - lo) * a['t']:.2f}s")
            await asyncio.sleep(lo + (hi - lo) * a["t"])
            return
        if op == "kill_osd":
            live = self._live_osds()
            if len(live) <= self.min_live_osds:
                self._log("kill_osd skipped (at min live)")
                return
            victim = live[pick % len(live)]
            await self.c.kill_osd(victim)
            store = self.c.osds[victim].store
            if self.store_factory is not None and \
                    hasattr(store, "umount"):
                store.umount()
            self.downed.append(victim)
            self._log(f"kill osd.{victim}")
            try:
                await self.c.wait_for_osd_down(victim, timeout=60)
            except TimeoutError:
                self._log(f"osd.{victim} not marked down in time")
            return
        if op == "revive_osd":
            if not self.downed:
                self._log("revive_osd skipped (none down)")
                return
            victim = self.downed.pop(pick % len(self.downed))
            store = None
            if self.store_factory is not None:
                store = self.store_factory(victim)
            await self.c.revive_osd(victim, store=store)
            self._log(f"revive osd.{victim}"
                      f"{' (remounted)' if store is not None else ''}")
            return
        if op == "partition":
            live = self._live_osds()
            if len(live) < 2:
                self._log("partition skipped (<2 live)")
                return
            if len(self.active_sets) >= self.max_active_sets:
                self._log("partition skipped (at max active sets)")
                return
            x = live[pick % len(live)]
            y = live[pick2 % (len(live) - 1)]
            y = y if y != x else live[-1]
            if x == y:
                self._log("partition skipped (one live)")
                return
            name = f"part-{x}-{y}-{len(self.actions_log)}"
            self.injector.install(
                name, [F.partition(f"osd.{x}", f"osd.{y}")])
            self.active_sets.append(name)
            self._log(f"partition osd.{x} <-> osd.{y} [{name}]")
            return
        if op == "heal":
            if not self.active_sets:
                self._log("heal skipped (no active sets)")
                return
            name = self.active_sets.pop(pick % len(self.active_sets))
            self.injector.clear(name)
            self._log(f"heal [{name}]")
            return
        if op == "degrade":
            if len(self.active_sets) >= self.max_active_sets:
                self._log("degrade skipped (at max active sets)")
                return
            name = f"lossy-{len(self.actions_log)}"
            self.injector.install(name, [
                F.delay("client.*", "osd.*", 0.005, 0.03),
                F.duplicate("client.*", "osd.*", prob=0.2),
                F.reorder("osd.*", "client.*", prob=0.2),
            ])
            self.active_sets.append(name)
            self._log(f"degrade client<->osd links [{name}]")
            return
        if op == "kill_mon":
            killed = await self.c.kill_mon_leader()
            if killed is None:
                self._log("kill_mon skipped (no leader / quorum)")
            else:
                self.killed_mons += 1
                self.c.mons.remove(killed)
                self._log(f"kill mon.{killed.name} (leader)")
            return
        raise ValueError(f"unknown thrash op {op!r}")     # pragma: no cover

    async def thrash(self, io, steps: int) -> list[str]:
        """Run the seeded schedule while writing through ``io``.
        Returns the action log. Call ``settle_and_verify`` after."""
        schedule = self.plan(self.seed, steps)
        self._writer_task = asyncio.ensure_future(self._writer(io))
        try:
            for a in schedule:
                await self._apply(a)
        finally:
            self._writer_task.cancel()
            try:
                await self._writer_task
            except asyncio.CancelledError:
                pass
            # anything else is a WRITER crash, not a storm casualty
            # (per-write failures are caught in _one_write): swallow
            # it and every invariant below verifies vacuously against
            # an empty acked set
        return self.actions_log

    async def backfill_storm(self, io, writes: int = 60,
                             partitions: int = 0,
                             fresh_store: bool = False) -> dict:
        """The horizon-crossing storm (the backfill acceptance shape):
        kill one OSD, write PAST the pg-log trim horizon (the cluster
        must run with a small ``osd_min_pg_log_entries`` for ``writes``
        to cross it), then revive the victim — with its old store
        (stale rejoin) or a fresh one (``fresh_store=True``, the
        replace-an-OSD case) — optionally under concurrent partitions.
        The revived OSD's logs are beyond log-delta reach, so only
        backfill can converge it. Finish with ``settle_and_verify``:
        every acked write must survive on a CLEAN cluster, which
        (given the trimmed logs) proves the backfill path moved the
        history. Returns {victim, acked_writes, horizon_writes}."""
        rng = random.Random(self.seed ^ 0xBACF111)
        live = self._live_osds()
        if len(live) <= self.min_live_osds:
            raise RuntimeError("not enough live osds for a backfill "
                               "storm")
        victim = live[rng.randrange(len(live))]
        await self.c.kill_osd(victim)
        store = self.c.osds[victim].store
        if self.store_factory is not None and hasattr(store, "umount"):
            store.umount()
        self.downed.append(victim)
        self._log(f"backfill storm: kill osd.{victim}")
        try:
            await self.c.wait_for_osd_down(victim, timeout=60)
        except TimeoutError:
            self._log(f"osd.{victim} not marked down in time")
        for i in range(partitions):
            live = self._live_osds()
            if len(live) < 2 or \
                    len(self.active_sets) >= self.max_active_sets:
                break
            x, y = rng.sample(live, 2)
            name = f"bf-part-{x}-{y}-{i}"
            self.injector.install(
                name, [F.partition(f"osd.{x}", f"osd.{y}")])
            self.active_sets.append(name)
            self._log(f"backfill storm: partition osd.{x}<->osd.{y}")
        written = 0
        for i in range(writes):
            oid = f"bf-{self.seed}-{i:05d}"
            data = bytes([i % 256]) * rng.randint(1, 2048)
            try:
                await io.write_full(oid, data,
                                    timeout=self.write_timeout)
                self.acked[oid] = data
                written += 1
            except Exception as e:
                self._write_errors += 1
                log.dout(5, f"backfill-storm write {oid} failed: "
                            f"{e!r}")
        self._log(f"backfill storm: {written}/{writes} writes past "
                  f"the horizon")
        for name in list(self.active_sets):
            self.injector.clear(name)
            self.active_sets.remove(name)
            self._log(f"backfill storm: heal [{name}]")
        self.downed.remove(victim)
        new_store = None
        if fresh_store:
            from ceph_tpu_torch.os_.objectstore import MemStore
            new_store = MemStore()        # a REPLACED osd: empty disk
        elif self.store_factory is not None:
            new_store = self.store_factory(victim)
        await self.c.revive_osd(victim, store=new_store)
        self._log(f"backfill storm: revive osd.{victim}"
                  f"{' (fresh store)' if fresh_store else ''}")
        return {"victim": victim, "acked_writes": written,
                "horizon_writes": writes}

    async def snap_storm(self, io, writes: int = 24, snaps: int = 3,
                         image_kb: int = 32,
                         settle_timeout: float = 240.0) -> dict:
        """The point-in-time honesty storm (the snapshot acceptance
        shape): an RBD image takes a continuous overwrite storm while
        snapshots are cut mid-stream and a background writer keeps
        racing the head; after the first snapshot one OSD is killed
        and the storm keeps writing, then the victim revives. Each
        snapshot's full readback is captured right after creation —
        the deterministic main region must already equal the tracked
        head — and at the end every capture must re-read
        byte-identical: the OSD's shared-blob COW clones have to
        freeze the past while the head moves across an acting-set
        change and recovery replays history onto the revived OSD.
        Writers are quiesced around each snap cut (the librbd
        flush-before-snap discipline): an in-flight write stamped
        with the pre-snap snapc would legitimately land inside the
        new snapshot. Call ``settle_and_verify`` after for the
        fsck/shared-blob-refcount cross-check. Returns {victim,
        snaps_verified, acked_writes, image}."""
        from ceph_tpu_torch.rbd import RBD
        rng = random.Random(self.seed ^ 0x54A905)
        name = f"snapstorm-{self.seed}"
        size = image_kb * 1024
        rbd = RBD(io)
        await rbd.create(name, size, order=12)
        img = await rbd.open(name)
        # main region: deterministic, tracked in ``expected``; tail
        # quarter: the background writer's racetrack (frozen-from-
        # capture only, never compared against a model)
        main_len = size * 3 // 4
        base = bytes(rng.randrange(256) for _ in range(size))
        await img.write(0, base)
        expected = bytearray(base)
        captures: dict[str, bytes] = {}
        snap_lock = asyncio.Lock()
        bg_stop = asyncio.Event()

        async def bg_writer():
            i = 0
            lanes = max(1, (size - main_len) // 512 - 1)
            while not bg_stop.is_set():
                off = main_len + (i % lanes) * 512
                try:
                    async with snap_lock:
                        await img.write(off, bytes([i % 256]) * 512)
                except Exception as e:
                    self._write_errors += 1
                    log.dout(5, f"snap-storm bg write failed: {e!r}")
                i += 1
                await asyncio.sleep(0.01)

        bg = asyncio.ensure_future(bg_writer())
        victim = None
        written = 0
        snap_every = max(1, writes // snaps)
        try:
            for i in range(writes):
                off = rng.randrange(0, main_len - 1)
                n = rng.randint(1, min(2048, main_len - off))
                data = bytes([rng.randrange(256)]) * n
                try:
                    async with snap_lock:
                        await img.write(off, data)
                    expected[off:off + n] = data
                    written += 1
                except Exception as e:
                    self._write_errors += 1
                    log.dout(5, f"snap-storm write failed: {e!r}")
                if (i + 1) % snap_every == 0 and len(captures) < snaps:
                    sname = f"storm-{len(captures)}"
                    async with snap_lock:
                        await img.snap_create(sname)
                        view = await rbd.open(name, snapshot=sname)
                        cap = await view.read(0, size)
                    assert cap[:main_len] == bytes(expected[:main_len]), \
                        f"snapshot {sname} differs from the head it froze"
                    captures[sname] = cap
                    self._log(f"snap storm: cut+captured {sname}")
                    if victim is None:
                        live = self._live_osds()
                        if len(live) > self.min_live_osds:
                            victim = live[rng.randrange(len(live))]
                            await self.c.kill_osd(victim)
                            st = self.c.osds[victim].store
                            if self.store_factory is not None and \
                                    hasattr(st, "umount"):
                                st.umount()
                            self.downed.append(victim)
                            self._log(f"snap storm: kill osd.{victim}")
                            try:
                                await self.c.wait_for_osd_down(
                                    victim, timeout=60)
                            except TimeoutError:
                                self._log(f"osd.{victim} not marked "
                                          f"down in time")
        finally:
            bg_stop.set()
            bg.cancel()
            try:
                await bg
            except asyncio.CancelledError:
                pass
        if victim is not None:
            self.downed.remove(victim)
            new_store = self.store_factory(victim) \
                if self.store_factory is not None else None
            await self.c.revive_osd(victim, store=new_store)
            self._log(f"snap storm: revive osd.{victim}")
        await self.c.wait_for_clean(timeout=settle_timeout)
        verified = 0
        for sname, cap in captures.items():
            view = await rbd.open(name, snapshot=sname)
            got = await view.read(0, size)
            assert got == cap, \
                f"snapshot {sname} drifted after the storm"
            verified += 1
        head = await (await rbd.open(name)).read(0, size)
        assert head[:main_len] == bytes(expected[:main_len]), \
            "head lost acked writes after the storm"
        self._log(f"snap storm: {verified} snapshots byte-identical, "
                  f"head intact")
        return {"victim": victim, "snaps_verified": verified,
                "acked_writes": written, "image": name}

    async def overload_storm(self, io, writers: int = 4,
                             write_bytes: int = 1024,
                             prefill: int = 24,
                             fill_margin: float = 0.5,
                             full_timeout: float = 30.0,
                             hold_s: float = 1.0,
                             drain_timeout: float = 60.0) -> dict:
        """The resource-exhaustion storm (the overload acceptance
        shape): prefill, then shrink ``osd_capacity_bytes`` so the
        cluster sits at ~``fill_margin`` of capacity, and keep
        writing until the mon's fullness sweep trips the cluster FULL
        flag. The invariant under test: concurrent writers PARK on
        the objecter's flag wait-queue — no unhandled ENOSPC from the
        store, no write acked and later lost. After ``hold_s`` the
        capacity is restored; every parked write must then drain to
        success and the cluster converge clean with all acked data
        readable (finish with ``settle_and_verify``).

        Capacity rides the SHARED cluster config dict, so every OSD
        (statfs report) and the mon (ratios) see the change at once —
        the runtime-shrinkable capacity knob the storm needs.
        Returns {capacity, acked_writes, parked_at_full, errors}."""
        cfg = self.c.cfg
        old_cap = cfg.get("osd_capacity_bytes", 0)
        rng = random.Random(self.seed ^ 0x0F111)
        for i in range(prefill):
            oid = f"ov-pre-{self.seed}-{i:04d}"
            data = bytes([i % 256]) * write_bytes
            # prefill rides the generous drain deadline: a slow host
            # must not fail the storm before it even starts
            await io.write_full(oid, data, timeout=drain_timeout)
            self.acked[oid] = data
        # per-OSD usage ~= total * size / n_osds; capacity chosen so
        # each OSD starts near fill_margin of it
        live = [o for o in self.c.osds if not o._stopped]
        per_osd = max(o.store_used_bytes() for o in live)
        capacity = max(int(per_osd / fill_margin), 4096)
        cfg["osd_capacity_bytes"] = capacity
        self._log(f"overload storm: capacity -> {capacity}B "
                  f"(~{per_osd}B used per osd)")
        errors: list = []
        stop = asyncio.Event()
        seqs = [0]

        async def writer(w):
            while not stop.is_set():
                oid = f"ov-{self.seed}-{w}-{seqs[0]:05d}"
                seqs[0] += 1
                data = bytes([seqs[0] % 256]) * \
                    rng.randint(1, write_bytes)
                try:
                    # generous deadline: a FULL-parked write must
                    # outlive the storm's hold window, not time out
                    await io.write_full(oid, data,
                                        timeout=drain_timeout)
                    self.acked[oid] = data
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    errors.append((oid, repr(e)))
                await asyncio.sleep(0.01)
        tasks = [asyncio.ensure_future(writer(w))
                 for w in range(writers)]
        try:
            deadline = asyncio.get_event_loop().time() + full_timeout
            while True:
                status = await self.c.client.status()
                flags = status["osdmap"].get("flags", "")
                if "full" in flags.split(","):
                    break
                if asyncio.get_event_loop().time() > deadline:
                    raise AssertionError(
                        f"FULL flag never tripped (flags={flags!r}, "
                        f"util={status['osdmap'].get('osd_utilization')})")
                await asyncio.sleep(0.1)
            self._log("overload storm: cluster FULL tripped")
            acked_at_full = len(self.acked)
            await asyncio.sleep(hold_s)
            # parked, not erroring: while FULL, writers must neither
            # fail nor leak ENOSPC from BlueStoreLite — and no NEW
            # writes complete (only ops already in flight when the
            # flag tripped may still land)
            assert not errors, f"writers errored under FULL: {errors}"
            parked = sum(1 for t in tasks if not t.done())
            assert parked == writers, \
                f"only {parked}/{writers} writers still running"
            grew = len(self.acked) - acked_at_full
            assert grew <= writers, \
                f"{grew} writes completed against a FULL cluster"
            cfg["osd_capacity_bytes"] = old_cap
            self._log("overload storm: capacity restored")
            deadline = asyncio.get_event_loop().time() + drain_timeout
            while True:
                status = await self.c.client.status()
                flags = status["osdmap"].get("flags", "")
                if "full" not in flags.split(","):
                    break
                if asyncio.get_event_loop().time() > deadline:
                    raise AssertionError("FULL flag never cleared")
                await asyncio.sleep(0.1)
            # drain: every write issued before/through FULL completes
            stop.set()
            done, pending = await asyncio.wait(
                tasks, timeout=drain_timeout)
            assert not pending, "writers failed to drain after unfull"
            assert not errors, \
                f"writes lost in the drain: {errors}"
        finally:
            stop.set()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            if cfg.get("osd_capacity_bytes") == capacity:
                cfg["osd_capacity_bytes"] = old_cap
        self._log(f"overload storm: drained; {len(self.acked)} acked, "
                  f"{len(errors)} errors")
        return {"capacity": capacity, "acked_writes": len(self.acked),
                "parked_at_full": parked, "errors": len(errors)}

    async def elastic_storm(self, io, writes: int = 30,
                            pool: str | None = None,
                            mon_cycle: bool = True,
                            auth_cycle: bool = True,
                            split_merge: bool = True,
                            phase_timeout: float = 60.0) -> dict:
        """The elastic-control-plane storm (the round-6 acceptance
        shape): while a background writer keeps acking unique-oid
        writes, the cluster is grown and shrunk at RUNTIME —

        1. mon membership: add a mon (quorum re-forms over 3), kill
           the leader (re-election among the 3-member map), then
           `mon rm` the corpse back to a 2-mon map — commands and
           writes keep flowing throughout;
        2. auth lifecycle: `auth get-or-create` provisions a fresh
           client that serves I/O, `auth rotate` re-keys the admin
           entity under live traffic, and `auth rm` fences the fresh
           client — its open session drops and new handshakes are
           refused while the rotated admin keeps writing;
        3. pg topology: the loaded pool splits (pg_num up + pgp ramp)
           and then MERGES back through the pg_num_pending readiness
           barrier, with the writer racing the quiesce window.

        ``writes`` caps the background writer's target (smoke budgets
        per tests/test_meta.py). Finish with ``settle_and_verify`` —
        every acked write must be readable bit-identical on a clean
        cluster afterwards.
        """
        c = self.c
        pool = pool or io.pool_name
        results: dict = {"phases": []}
        self._writer_task = asyncio.ensure_future(self._writer(io))
        try:
            if mon_cycle:
                n0 = len(c.monmap.mons)
                mon = await c.add_mon()
                await c.wait_for_quorum(n0 + 1,
                                        timeout=phase_timeout)
                self._log(f"elastic: mon.{mon.name} added; quorum "
                          f"{n0 + 1}")
                killed = await c.kill_mon_leader()
                assert killed is not None, \
                    "no killable leader with 3 mons"
                c.mons.remove(killed)
                self.killed_mons += 1
                await c.wait_for_quorum(n0, timeout=phase_timeout)
                self._log(f"elastic: leader mon.{killed.name} killed; "
                          f"re-elected among survivors")
                await c.rm_mon(killed.name, timeout=phase_timeout)
                self._log(f"elastic: mon.{killed.name} removed; "
                          f"monmap back to {len(c.monmap.mons)}")
                results["phases"].append("mon_cycle")
            if auth_cycle:
                import json as _json

                from ceph_tpu_torch.msg import Keyring as _Keyring
                from ceph_tpu_torch.rados import Rados as _Rados
                ret, rs, out = await c.client.mon_command(
                    {"prefix": "auth get-or-create",
                     "entity": "client.elastic"})
                assert ret == 0, rs
                key = bytes.fromhex(_json.loads(out)["key"])
                fresh = _Rados(c.monmap, name="client.elastic",
                               keyring=_Keyring(
                                   {"client.elastic": key}),
                               device=c.device)
                await fresh.connect()
                fio = await fresh.open_ioctx(pool)
                await fio.write_full("elastic-fresh", b"provisioned",
                                     timeout=self.write_timeout)
                self.acked["elastic-fresh"] = b"provisioned"
                ret, rs, _ = await c.client.mon_command(
                    {"prefix": "auth rotate",
                     "entity": "client.admin"})
                assert ret == 0, rs
                # the admin's LIVE session must keep serving after its
                # key rotated (re-keyed in-band, not re-authed)
                await io.write_full("elastic-after-rotate", b"live",
                                    timeout=self.write_timeout)
                self.acked["elastic-after-rotate"] = b"live"
                ret, rs, _ = await c.client.mon_command(
                    {"prefix": "auth rm",
                     "entity": "client.elastic"})
                assert ret == 0, rs
                fenced = False
                try:
                    await fio.write_full("elastic-after-revoke",
                                         b"nope", timeout=4.0)
                except Exception:
                    fenced = True
                assert fenced, ("revoked client.elastic still "
                                "serves I/O")
                await fresh.shutdown()
                self._log("elastic: key provisioned, rotated (live "
                          "session survived), revoked (fenced)")
                results["phases"].append("auth_cycle")
            if split_merge:
                ret, _, out = await c.client.mon_command(
                    {"prefix": "osd dump"})
                import json as _json
                pinfo = next(p for p in _json.loads(out)["pools"]
                             if p["name"] == pool)
                pg0 = pinfo["pg_num"]
                await self._pool_set(pool, "pg_num", pg0 * 2)
                await c.wait_for_clean(timeout=phase_timeout * 2)
                await self._pool_set(pool, "pgp_num", pg0 * 2)
                await c.wait_for_clean(timeout=phase_timeout * 2)
                self._log(f"elastic: pool {pool} split "
                          f"{pg0} -> {pg0 * 2} + migrated")
                await self._pool_set(pool, "pg_num", pg0)
                deadline = asyncio.get_event_loop().time() + \
                    phase_timeout * 2
                while True:
                    ret, _, out = await c.client.mon_command(
                        {"prefix": "osd dump"})
                    pinfo = next(p for p in _json.loads(out)["pools"]
                                 if p["name"] == pool)
                    if pinfo["pg_num"] == pg0 and \
                            not pinfo["pg_num_pending"]:
                        break
                    assert asyncio.get_event_loop().time() < \
                        deadline, f"merge never committed: {pinfo}"
                    await asyncio.sleep(0.2)
                self._log(f"elastic: pool {pool} merged back to "
                          f"{pg0} under load")
                results["phases"].append("split_merge")
            # let the writer reach its budget so the storm proves
            # sustained I/O across every transition
            deadline = asyncio.get_event_loop().time() + phase_timeout
            while len(self.acked) < writes and \
                    asyncio.get_event_loop().time() < deadline:
                await asyncio.sleep(0.1)
        finally:
            self._writer_task.cancel()
            try:
                await self._writer_task
            except asyncio.CancelledError:
                pass
        results["acked_writes"] = len(self.acked)
        results["failed_writes"] = self._write_errors
        self._log(f"elastic: {len(self.acked)} acked, "
                  f"{self._write_errors} transient failures")
        return results

    async def qos_storm(self, io_cold, io_hot, writes: int = 24,
                        hot_parallel: int = 4, hot_burst: int = 16,
                        cold_think_s: float = 0.02,
                        write_bytes: int = 1024,
                        op_timeout: float = 30.0) -> dict:
        """The two-tenant QoS storm (the round-11 acceptance shape):
        a HOT tenant floods the cluster with ``hot_parallel`` writer
        tasks, each keeping ``hot_burst`` writes in flight at once
        (OPEN-loop inside the burst — a closed-loop writer would
        self-limit and never actually offer 10x), while a COLD tenant
        issues ``writes`` paced ops through its own client — the
        scheduler must keep the cold tenant's latency near its solo
        baseline while FIFO lets the hot queue bury it. This entry
        measures ONE configuration; the caller compares runs across
        the ``osd_op_queue`` knob (it rides the shared cluster cfg,
        so it flips at runtime).

        ``io_cold``/``io_hot`` must be IoCtxs of DIFFERENT client
        entities (the scheduler queues by entity). Returns
        {cold_p99_s, cold_p50_s, cold_ops_per_s, hot_ops, mode}."""
        import time as _time
        from ceph_tpu_torch.sim.loadgen import percentile
        stop = asyncio.Event()
        hot_ops = [0]
        rng = random.Random(self.seed ^ 0x0A05)

        async def one_hot(w: int, i: int) -> None:
            oid = f"qos-hot-{self.seed}-{w}-{i % 64:03d}"
            data = bytes([i % 256]) * write_bytes
            try:
                await io_hot.write_full(oid, data,
                                        timeout=op_timeout)
                hot_ops[0] += 1
            except asyncio.CancelledError:
                raise
            except Exception as e:
                log.dout(5, f"qos storm hot write failed: {e!r}")

        async def hot_writer(w: int) -> None:
            i = 0
            while not stop.is_set():
                await asyncio.gather(*[
                    one_hot(w, i + k) for k in range(hot_burst)])
                i += hot_burst
        tasks = [asyncio.ensure_future(hot_writer(w))
                 for w in range(hot_parallel)]
        lat: list[float] = []
        errors = 0
        try:
            await asyncio.sleep(0.2)      # let the hot flood build up
            t0 = _time.perf_counter()
            for i in range(writes):
                oid = f"qos-cold-{self.seed}-{i:04d}"
                data = bytes([i % 256]) * rng.randint(1, write_bytes)
                s0 = _time.perf_counter()
                try:
                    await io_cold.write_full(oid, data,
                                             timeout=op_timeout)
                    lat.append(_time.perf_counter() - s0)
                    self.acked[oid] = data
                except asyncio.CancelledError:
                    raise
                except Exception:
                    errors += 1
                await asyncio.sleep(cold_think_s)
            wall = _time.perf_counter() - t0
        finally:
            stop.set()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
        lat.sort()
        self._log(f"qos storm: cold {len(lat)}/{writes} acked "
                  f"(p99 {percentile(lat, 0.99) * 1e3:.1f} ms), "
                  f"hot {hot_ops[0]} ops, {errors} errors")
        return {"mode": str(self.c.cfg.get("osd_op_queue", "mclock")),
                "cold_ops": len(lat),
                "cold_errors": errors,
                "cold_p50_s": percentile(lat, 0.50),
                # p95 alongside p99: with smoke-sized sample counts
                # p99 IS the max, which one GC/event-loop blip owns —
                # assertions compare p95 (structural delay), records
                # keep p99
                "cold_p95_s": percentile(lat, 0.95),
                "cold_p99_s": percentile(lat, 0.99),
                "cold_ops_per_s": round(len(lat) / wall, 1)
                if wall > 0 else 0.0,
                "hot_ops": hot_ops[0]}

    async def tuner_storm(self, io_cold, io_hot, writes: int = 24,
                          hot_parallel: int = 4, hot_burst: int = 16,
                          cold_think_s: float = 0.02,
                          write_bytes: int = 1024,
                          op_timeout: float = 30.0,
                          ramp_s: float = 0.5) -> dict:
        """The self-driving-tuner acceptance storm (round 17): the
        qos_storm's two-tenant shape split across TWO POOLS — the hot
        tenant floods its own pool open-loop while the cold tenant
        paces on another — so the mgr tuner's hot-pool protector has
        a per-pool op-rate signal to trip on (the hot pool starving
        the cold one), not just per-entity queues. ``ramp_s`` holds
        the hot flood before the cold measurement starts, giving the
        tuner's hysteresis window time to see the breach.

        ``io_cold``/``io_hot`` must be IoCtxs of DIFFERENT client
        entities over DIFFERENT pools. Returns the qos_storm report
        shape plus the mon's tuner ledger (committed/reverted/
        observed + mode) sampled after the storm — the caller diffs
        ledgers across runs to count actions this storm caused."""
        import time as _time
        from ceph_tpu_torch.sim.loadgen import percentile
        stop = asyncio.Event()
        hot_ops = [0]
        rng = random.Random(self.seed ^ 0x70E5)

        async def one_hot(w: int, i: int) -> None:
            oid = f"tuner-hot-{self.seed}-{w}-{i % 64:03d}"
            data = bytes([i % 256]) * write_bytes
            try:
                await io_hot.write_full(oid, data,
                                        timeout=op_timeout)
                hot_ops[0] += 1
            except asyncio.CancelledError:
                raise
            except Exception as e:
                log.dout(5, f"tuner storm hot write failed: {e!r}")

        async def hot_writer(w: int) -> None:
            i = 0
            while not stop.is_set():
                await asyncio.gather(*[
                    one_hot(w, i + k) for k in range(hot_burst)])
                i += hot_burst
        tasks = [asyncio.ensure_future(hot_writer(w))
                 for w in range(hot_parallel)]
        lat: list[float] = []
        errors = 0
        t_start = _time.perf_counter()
        try:
            if hot_parallel:
                await asyncio.sleep(ramp_s)    # let the breach register
            t0 = _time.perf_counter()
            for i in range(writes):
                oid = f"tuner-cold-{self.seed}-{i:04d}"
                data = bytes([i % 256]) * rng.randint(1, write_bytes)
                s0 = _time.perf_counter()
                try:
                    await io_cold.write_full(oid, data,
                                             timeout=op_timeout)
                    lat.append(_time.perf_counter() - s0)
                    self.acked[oid] = data
                except asyncio.CancelledError:
                    raise
                except Exception:
                    errors += 1
                await asyncio.sleep(cold_think_s)
            wall = _time.perf_counter() - t0
        finally:
            stop.set()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
        wall_total = _time.perf_counter() - t_start
        lat.sort()
        tuner = {}
        ret, _, out = await self.c.client.mon_command(
            {"prefix": "tune status"})
        if ret == 0:
            st = json.loads(out)
            tuner = {k: st.get(k) for k in
                     ("mode", "committed", "reverted", "observed")}
        self._log(f"tuner storm: cold {len(lat)}/{writes} acked "
                  f"(p99 {percentile(lat, 0.99) * 1e3:.1f} ms), "
                  f"hot {hot_ops[0]} ops, tuner {tuner}")
        return {"mode": str(self.c.cfg.get("mgr_tuner_mode",
                                           "observe")),
                "cold_ops": len(lat),
                "cold_errors": errors,
                "cold_p50_s": percentile(lat, 0.50),
                "cold_p95_s": percentile(lat, 0.95),
                "cold_p99_s": percentile(lat, 0.99),
                "cold_ops_per_s": round(len(lat) / wall, 1)
                if wall > 0 else 0.0,
                "hot_ops": hot_ops[0],
                "wall_s": round(wall_total, 3),
                # both tenants over the storm's full window (incl the
                # ramp the hot flood runs alone) — the throughput side
                # of the protect-the-cold-tenant trade
                "agg_ops_per_s": round(
                    (len(lat) + hot_ops[0]) / wall_total, 1)
                if wall_total > 0 else 0.0,
                "tuner": tuner}

    async def _pool_set(self, pool: str, var: str, val: int) -> None:
        ret, rs, _ = await self.c.client.mon_command(
            {"prefix": "osd pool set", "pool": pool, "var": var,
             "val": str(val)})
        assert ret == 0, f"pool set {var}={val}: {rs}"

    async def mds_storm(self, fs_clients, writes: int = 24,
                        files_before_kill: int = 4,
                        kills: int = 1,
                        takeover_timeout: float = 30.0,
                        fence_timeout: float = 15.0,
                        kill_rank: int = 0,
                        writer_dirs: list | None = None,
                        survivor_writers: list | None = None) -> dict:
        """The metadata-plane failover storm (the MDS acceptance
        shape): while ``fs_clients`` hammer metadata I/O (unique-file
        writes through the MDS), ``kill -9`` the ACTIVE MDS and assert
        the mon-coordinated ladder delivers:

        1. a standby reaches ``active`` within ``takeover_timeout``;
        2. NO writer errors — every op issued across the failover
           completes (clients park, reconnect with cap replay, and
           op-replay unacked mutations; the successor's completed-
           request table dedups the ones that landed pre-crash);
        3. every acked write is readable and bit-identical afterwards;
        4. the fenced old incarnation's late JOURNAL write is refused
           by the OSDs (blocklist) — the no-split-brain invariant.

        Multi-active variant (round 7): ``kill_rank`` selects which
        rank's active dies; ``writer_dirs`` gives each writer its own
        base directory (pin them to ranks first via
        ``cluster.subtree_pin``) so writers exercise DISJOINT
        subtrees; ``survivor_writers`` lists writer indexes whose
        subtree lives on a surviving rank — the storm then also
        asserts those writers kept acking DURING the takeover window
        (the surviving-ranks-keep-serving half of the acceptance).

        Requires ``cluster.start_fs`` with at least ``kills`` + 1
        daemons. Returns {kills, acked_writes, errors, takeover_s}.
        On the proc backend the active's name comes over the wire.
        """
        c = self.c
        assert c.mdss, "mds_storm needs cluster.start_fs() first"
        rng = random.Random(self.seed ^ 0x3D5)
        acked: dict[str, bytes] = {}
        errors: list = []
        prog = [0] * len(fs_clients)     # per-writer acked count

        async def writer(w: int, cl) -> None:
            base = writer_dirs[w] if writer_dirs else ""
            for i in range(writes):
                path = f"{base}/mds-storm-{self.seed}-{w}-{i:04d}"
                data = bytes([(w + i) % 256]) * rng.randint(1, 512)
                try:
                    await asyncio.wait_for(cl.write_file(path, data),
                                           timeout=45.0)
                    acked[path] = data
                    prog[w] += 1
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    errors.append((path, repr(e)))
                await asyncio.sleep(0.01)
        tasks = [asyncio.ensure_future(writer(w, cl))
                 for w, cl in enumerate(fs_clients)]
        takeover_s = []
        zombies = []
        survivor_stalls = []
        try:
            for k in range(kills):
                deadline = asyncio.get_event_loop().time() + 30.0
                while len(acked) < files_before_kill * (k + 1):
                    if asyncio.get_event_loop().time() > deadline:
                        raise AssertionError(
                            "writers made no progress before kill")
                    await asyncio.sleep(0.05)
                victim = c.mds_active_name(kill_rank)
                if self.proc:
                    victim = await victim
                assert victim is not None, \
                    f"no active mds on rank {kill_rank} to kill"
                prog_at_kill = list(prog)
                zombies.append(await c.kill_mds(victim))
                self._log(f"mds storm: kill -9 active mds.{victim} "
                          f"(rank {kill_rank})")
                t0 = asyncio.get_event_loop().time()
                newa = await c.wait_for_mds_active(
                    not_name=victim, timeout=takeover_timeout,
                    rank=kill_rank)
                takeover_s.append(
                    round(asyncio.get_event_loop().time() - t0, 2))
                self._log(f"mds storm: mds.{newa} took over rank "
                          f"{kill_rank} ({takeover_s[-1]}s)")
                for w in (survivor_writers or []):
                    # a surviving rank's writer must have kept acking
                    # through the takeover window (unless it already
                    # finished its budget before the kill)
                    if prog_at_kill[w] >= writes:
                        continue
                    if prog[w] <= prog_at_kill[w]:
                        survivor_stalls.append(
                            (k, w, prog_at_kill[w], prog[w]))
            done, pending = await asyncio.wait(tasks, timeout=120.0)
            assert not pending, "writers wedged after mds failover"
        finally:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
        assert not errors, \
            f"writer ops lost across failover: {errors[:4]}"
        assert not survivor_stalls, \
            (f"surviving-rank writers stalled during takeover "
             f"(kill, writer, before, after): {survivor_stalls}")
        # every acked write readable and intact through a survivor
        reader = fs_clients[0]
        for path, data in acked.items():
            got = await reader.read_file(path)
            assert got == data, f"acked {path} corrupted by failover"
        # the fenced incarnations' late journal writes must bounce:
        # probe until the blocklist map reaches the serving OSD (the
        # promote already barriered, so this resolves fast)
        from ceph_tpu_torch.rados import ObjectOperationError
        for z in zombies:
            deadline = asyncio.get_event_loop().time() + fence_timeout
            while True:
                try:
                    # underscore-prefixed key: journal readers iterate
                    # digit keys only, so a probe landing BEFORE the
                    # blocklist propagates can never poison a later
                    # replay/tail (z.journal_oid: the zombie's RANK's
                    # journal — the object its split-brain write would
                    # actually target)
                    await z.ioctx.set_omap(
                        z.journal_oid, "_zombie_probe", b"stale")
                except ObjectOperationError as e:
                    assert e.errno == -108, e    # -EBLOCKLISTED
                    break
                assert asyncio.get_event_loop().time() < deadline, \
                    (f"zombie mds.{z.name} ({z.ident}) journal write "
                     f"was never fenced")
                await asyncio.sleep(0.2)
            self._log(f"mds storm: zombie {z.ident} fenced")
        self._log(f"mds storm: {len(acked)} acked, 0 lost")
        return {"kills": kills, "acked_writes": len(acked),
                "errors": len(errors), "takeover_s": takeover_s}

    async def device_storm(self, io, io_ec=None, ec_writes: int = 8,
                           ec_fails: int = 3, stall_s: float = 0.02,
                           probe_hosts: int = 4,
                           probe_timeout: float = 120.0) -> dict:
        """The device-fault resilience storm (the round-16 acceptance
        shape): jit_fail / jit_stall / bad_result bursts at the devmon
        chokepoint while replicated AND erasure-coded client writes
        keep flowing — the acceptance is ZERO client-visible errors
        and the kernel path RE-PROMOTED (not merely degraded) once the
        faults clear.

        Three legs run concurrently:

        1. **EC degrade ladder** — ``jit_fail`` on ``ec_encode*``
           poisons ``ec_fails`` device encodes; the OSD aggregator
           must serve every one of ``ec_writes`` client writes
           through per-op retry / the host reference encoder.
        2. **Cluster latency** — ``jit_stall`` on every CRUSH device
           call adds ``stall_s`` of injected device latency under the
           background replicated writer (latency, never errors).
        3. **Kernel quarantine cycle** — a dedicated probe Mapper on
           the CPU (its kernel path is ``kernel-plain``) rides the full
           state machine: ``jit_fail`` keyed to its kernel-plain blocks
           quarantines it, a ``bad_result`` keyed the same way makes the
           first re-probe REFUSE promotion (corrupt kernel output never
           serves), and once the faults clear a clean probe promotes
           it back — bit-exact against the healthy output.

        Legs 1 and 3 are the host's degrade paths, which serve only a
        plugin and a Mapper on the CPU; on the card a failed launch is
        counted and raised to the client. So the storm runs only on a
        cluster on the CPU, and raises on one on the card.

        The caller runs ``settle_and_verify`` afterwards as usual.
        Returns the counter evidence (quarantine entries/exits,
        probes, EC fallbacks, write errors)."""
        import time as _time

        import numpy as np

        from ceph_tpu_torch.crush import builder as crush_builder
        from ceph_tpu_torch.crush.mapper import Mapper
        from ceph_tpu_torch.utils import devmon as devmon_mod

        if self.c.device.type != "cpu":
            raise RuntimeError(
                "device_storm needs a cluster on the CPU: on the card a "
                "failed launch is counted and raised, and no host path "
                "serves in its place")
        knobs = {"crush_kernel_reprobe_base": 0.05,
                 "crush_kernel_reprobe_max": 0.2,
                 "crush_kernel_reprobe_disable_after": 8}
        cm, root = crush_builder.build_hierarchy(probe_hosts, 2)
        rid = crush_builder.add_simple_rule(
            cm, root, crush_builder.TYPE_HOST)
        probe = Mapper(cm, config=knobs, device=self.c.device)
        assert probe.mapping_path(rid, 2) == "kernel-plain", \
            "probe mapper has no kernel path to quarantine"
        xs = np.arange(64, dtype=np.uint32)
        out0, path0 = probe.map_pgs_path(rid, xs, 2)
        out0 = np.asarray(out0)
        assert path0 == "kernel-plain", path0
        # the probe's own blocks: every Mapper of a cluster on the CPU
        # runs kernel-plain, where the reference's daemons had no kernel
        kern = f"('kernel-plain', {probe._devmon_token}, *"

        dm = devmon_mod.devmon()
        q0 = dm.perf.dump()
        errs0 = self._write_errors
        wt = asyncio.ensure_future(self._writer(io))
        ec_acked = 0
        try:
            # one storm burst: fails bounded by count, stalls by prob
            self.injector.install("device_storm", [
                F.jit_fail("ec_encode*", count=ec_fails),
                F.jit_stall("crush_*", stall_s, prob=0.5, count=16),
                F.jit_fail("crush_map_pgs", key=kern, count=1),
            ])
            # leg 3a: the injected kernel failure quarantines the
            # probe mapper — the SAME call still answers (the VM serves)
            out_q, path_q = probe.map_pgs_path(rid, xs, 2)
            info = probe.kernel_quarantine_info()
            assert info is not None and path_q == "vm", (info, path_q)
            assert np.array_equal(np.asarray(out_q), out0), \
                "degraded serving path diverged from healthy output"
            # leg 1: EC writes through the poisoned encode path
            # (tracked separately from self.acked: settle_and_verify
            # reads acked oids through the REPLICATED ioctx)
            ec_data: dict[str, bytes] = {}
            if io_ec is not None:
                for i in range(ec_writes):
                    oid = f"devstorm-ec-{self.seed}-{i:03d}"
                    data = bytes([i % 256]) * (1024 + i)
                    await io_ec.write_full(
                        oid, data, timeout=self.write_timeout * 6)
                    ec_data[oid] = data
                    ec_acked += 1
            # let the stalled replicated writer breathe a little more
            await asyncio.sleep(0.3)
            # stop the writer BEFORE the probe legs, as the reference
            # does (its interpret-mode probe compile held the loop)
            wt.cancel()
            await asyncio.gather(wt, return_exceptions=True)
            # leg 3b: a corrupt probe must REFUSE promotion
            self.injector.install("device_storm_probe", [
                F.bad_result("crush_map_pgs", key=kern, count=1)])
            fails_before = int(info["failures"])
            deadline = _time.monotonic() + probe_timeout
            while _time.monotonic() < deadline:
                probe.map_pgs_path(rid, xs, 2)   # probe when due
                info = probe.kernel_quarantine_info()
                if info is None or \
                        info["failures"] > fails_before:
                    break
                await asyncio.sleep(0.02)
            assert info is not None and \
                info["failures"] > fails_before, \
                "corrupt re-probe should have failed, not promoted"
            # heal the device plane; a clean probe must re-promote
            self.injector.clear("device_storm")
            self.injector.clear("device_storm_probe")
            out_h = None
            path_h = None
            deadline = _time.monotonic() + probe_timeout
            while _time.monotonic() < deadline:
                out_h, path_h = probe.map_pgs_path(rid, xs, 2)
                if probe.kernel_quarantine_info() is None:
                    break
                await asyncio.sleep(0.05)
            assert probe.kernel_quarantine_info() is None, \
                "kernel path never re-promoted after faults cleared"
            assert path_h == "kernel-plain", path_h
            assert np.array_equal(np.asarray(out_h), out0), \
                "re-promoted kernel output diverged"
            # every EC write served through the degrade ladder reads
            # back bit-identical now that the device plane healed
            for oid, data in ec_data.items():
                got = await io_ec.read(oid)
                assert got == data, \
                    f"degraded-path EC write {oid} corrupted"
        finally:
            wt.cancel()
            await asyncio.gather(wt, return_exceptions=True)
            self.injector.clear("device_storm")
            self.injector.clear("device_storm_probe")
        q1 = dm.perf.dump()

        def _delta(key):
            return int(q1.get(key, 0)) - int(q0.get(key, 0))
        agg_fb = sum(
            int(o.ec_agg.perf.dump().get("fallback_ops", 0)) +
            int(o.ec_agg.perf.dump().get("per_op_retries", 0))
            for o in self.c.osds)
        storm_errors = self._write_errors - errs0
        assert storm_errors == 0, \
            f"{storm_errors} client-visible errors under device storm"
        self._log(f"device storm: {ec_acked} EC writes served "
                  f"degraded, quarantine "
                  f"{_delta('quarantine_entries')} in / "
                  f"{_delta('quarantine_exits')} out, "
                  f"{_delta('quarantine_probes')} probes "
                  f"({_delta('quarantine_probe_failures')} refused)")
        return {"write_errors": storm_errors,
                "ec_writes_acked": ec_acked,
                "quarantine_entries": _delta("quarantine_entries"),
                "quarantine_exits": _delta("quarantine_exits"),
                "probes": _delta("quarantine_probes"),
                "probe_failures": _delta("quarantine_probe_failures"),
                "faults_injected": _delta("faults_injected"),
                "ec_degraded_ops": agg_fb,
                "repromoted_path": path_h}

    # -- proc-backend crash storm (round 18) -------------------------------
    async def proc_storm(self, io, settle_timeout: float = 180.0,
                         gray: bool = True) -> dict:
        """SIGKILL honesty under load (proc backend only): with a
        continuous unique-oid writer running, crash — in sequence —
        one OSD, the lead mon (when a majority survives it), and the
        active mgr, each with a REAL SIGKILL (no goodbye on the wire);
        let the supervisor restart each; optionally run one
        SIGSTOP/SIGCONT gray-failure pass (the frozen OSD must trip
        OSD_SLOW and heal on resume); then settle and verify.

        Invariants enforced: ZERO writer errors (the closed loop plus
        objecter retry must ride out every crash window), every acked
        write reads back bit-identical, every victim observed
        restarting, the mgr telemetry plane re-populates after the
        active mgr dies. Returns the summary dict."""
        c = self.c
        assert self.proc, "proc_storm needs backend='proc'"
        self._writer_task = asyncio.ensure_future(self._writer(io))
        restarts: dict[str, int] = {}
        mgr_failover = None
        try:
            await asyncio.sleep(0.5)        # writer gets a head start
            # 1: crash an OSD; the supervisor must bring it back
            victim = f"osd.{c.n_osds - 1}"
            before = c.children[victim].restarts
            c.kill_osd(c.n_osds - 1)
            self._log(f"SIGKILL {victim}")
            await c.wait_for_restart(victim, before, timeout=60.0)
            # the fresh incarnation must actually BOOT (asok answers,
            # reports up): wait_for_osds_up alone passes trivially
            # when the grace outlives the respawn and the dead osd
            # was never marked down
            await c.wait_for_daemon_ready(victim, timeout=60.0)
            await c.wait_for_osds_up(c.n_osds, timeout=90.0)
            restarts[victim] = c.children[victim].restarts - before
            # 2: crash the lead mon (only when quorum survives it)
            before_mons = {n: ch.restarts
                           for n, ch in c.children.items()
                           if n.startswith("mon.")}
            name = await c.kill_mon_leader()
            if name is not None:
                self.killed_mons += 1
                self._log(f"SIGKILL {name} (lead mon)")
                await c.wait_for_restart(name, before_mons[name],
                                         timeout=60.0)
                await c.wait_for_daemon_ready(name, timeout=60.0)
                restarts[name] = \
                    c.children[name].restarts - before_mons[name]
                # the reborn mon must rejoin a WORKING quorum
                ret, _, _ = await c.client.mon_command(
                    {"prefix": "status"}, timeout=30.0)
                assert ret == 0
            # 3: crash the active mgr; a standby must take over and
            # the telemetry plane must re-populate from fresh reports
            old = await c.kill_active_mgr()
            if old is not None:
                before_m = c.children[old].restarts
                self._log(f"SIGKILL {old} (active mgr)")
                new = await c.wait_for_mgr_active(
                    not_name=old.split(".", 1)[1], timeout=60.0)
                mgr_failover = (old, f"mgr.{new}")
                self._log(f"mgr failover -> mgr.{new}")
                deadline = asyncio.get_event_loop().time() + 60.0
                while True:
                    try:
                        out = await c.daemon_command(
                            f"mgr.{new}", "metrics")
                        # ceph_daemon rows exist only once daemons
                        # have REPORTED to this (fresh) mgr — the
                        # re-population proof, not a map-derived row
                        if "ceph_daemon" in out.get("body", ""):
                            break
                    except Exception:
                        pass
                    assert asyncio.get_event_loop().time() < \
                        deadline, "mgr metrics never re-populated"
                    await asyncio.sleep(0.3)
                await c.wait_for_restart(old, before_m, timeout=60.0)
                restarts[old] = c.children[old].restarts - before_m
            # 4: gray failure — frozen, not dead
            if gray:
                gray_id = 0
                c.pause_osd(gray_id)
                self._log(f"SIGSTOP osd.{gray_id}")
                await c.wait_for_health("OSD_SLOW", present=True,
                                        timeout=60.0)
                c.resume_osd(gray_id)
                self._log(f"SIGCONT osd.{gray_id}")
                await c.wait_for_health("OSD_SLOW", present=False,
                                        timeout=90.0)
                await c.wait_for_osds_up(c.n_osds, timeout=90.0)
        finally:
            self._writer_task.cancel()
            await asyncio.gather(self._writer_task,
                                 return_exceptions=True)
        await c.wait_for_clean(timeout=settle_timeout)
        assert self._write_errors == 0, \
            f"{self._write_errors} writer errors during proc storm"
        for oid, data in self.acked.items():
            got = await io.read(oid)
            assert got == data, \
                f"acked write {oid} corrupted by proc storm"
        assert sum(restarts.values()) >= 2, \
            f"expected supervisor restarts, saw {restarts}"
        summary = {
            "seed": self.seed,
            "acked_writes": len(self.acked),
            "failed_writes": self._write_errors,
            "restarts": restarts,
            "killed_mons": self.killed_mons,
            "mgr_failover": mgr_failover,
        }
        self._log(f"proc storm done: {summary}")
        return summary

    async def settle_and_verify(self, io, timeout: float = 240.0,
                                fsck_stores=None) -> dict:
        """Heal everything, revive everything, converge, verify.
        Raises AssertionError on any invariant violation; returns a
        summary dict."""
        self.injector.clear_all()
        self.active_sets.clear()
        for victim in list(self.downed):
            store = self.store_factory(victim) \
                if self.store_factory is not None else None
            await self.c.revive_osd(victim, store=store)
            self._log(f"final revive osd.{victim}")
        self.downed.clear()
        await self.c.wait_for_clean(timeout=timeout)
        # 2: every acked write readable and intact
        for oid, data in self.acked.items():
            got = await io.read(oid)
            assert got == data, \
                f"acked write {oid} corrupted after thrash"
        # 3: stores fsck clean
        checked = 0
        for st in (fsck_stores if fsck_stores is not None
                   else [o.store for o in self.c.osds]):
            if hasattr(st, "fsck"):
                errs = st.fsck()
                assert errs == [], f"store fsck after thrash: {errs}"
                checked += 1
        # 4: the mon cluster answers
        status = await self.c.client.status()
        assert status["osdmap"]["num_up_osds"] == len(self.c.osds)
        return {
            "seed": self.seed,
            "actions": len(self.actions_log),
            "acked_writes": len(self.acked),
            "failed_writes": self._write_errors,
            "fscked_stores": checked,
            "killed_mons": self.killed_mons,
        }
