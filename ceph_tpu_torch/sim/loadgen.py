"""Closed-loop client-session load harness (the 10k-session front end).

ref: the role qa's `rados bench`/cosbench rigs play upstream — drive a
vstart cluster with MANY concurrent client sessions and measure what
the front end actually delivers: aggregate ops/s, per-op latency
percentiles (p50/p99/max), and the error count (which must be ZERO on
a healthy cluster — the harness is closed-loop, so backpressure shows
up as latency, never as lost ops).

Session model: every **session** is a closed loop — issue one op,
await the reply, think, repeat (`ops_per_session` times). Sessions are
LOGICAL: they multiplex over a bounded pool of real `Rados` handles
(``clients``), exactly how production client libraries run thousands
of application streams over a few messenger sessions. That keeps one
process honest at 10k+ sessions (10k raw TCP pairs would exhaust fd
limits long before the cluster is the bottleneck) while still pushing
every shared layer — messenger frames, Objecter tid tables, mon
subscription fan-out, OSD admission — to session-scale traffic.

Scaling cliffs this harness exposed (fixed in round 11):

- the mon's map-publish loop was one SERIAL await per subscriber per
  commit (``Monitor._publish_maps``) — now a bounded-concurrency
  fan-out;
- messenger key events scanned the whole connection table per auth
  change (``_conns_of``) — now a per-peer index;
- OSD admission was a FIFO whose saturation check was global — the
  scheduler's per-tenant queues made both O(1) per op.

Usage::

    report = await LoadGen(cluster, "pool",
                           sessions=10000, clients=16,
                           ops_per_session=5).run()
    assert report["errors"] == 0

The tier-1 smoke runs <= 200 sessions (tests/test_meta.py budget
guard); the full 10k run is ``@pytest.mark.slow``.

Scenario schedules (round 17): ``SCENARIOS`` holds named multi-phase
workload shapes — each phase runs one LoadGen fleet per pool to
completion (optionally firing a cluster event first) — and
``run_scenario`` drives them. They exist to exercise the mgr
TunerModule's policies with realistic load TRANSITIONS: the diurnal
ramp (does a quiet trough commit anything? it must not), the hot-pool
burst (the hot-pool protector's trip/heal cycle), and an OSD outage
landing mid-rush (the recovery governor's backfill-vs-QoS trade).

The port's copy of ``ceph_tpu/sim/loadgen.py``. Every ``Rados`` it opens
runs on the cluster's device: ``cluster.device`` in process, and in a
worker process the conf's ``"device"`` (written by the proc backend,
and by ``run_sharded`` itself when the cluster has no conf). On the
card each op's PG lookup is a ``crush_straw2`` launch and each write to
an erasure-coded pool a ``gf_encode`` launch in the OSD that takes it.
"""

from __future__ import annotations

import asyncio
import random
import time

from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("loadgen")


def percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    k = min(len(sorted_vals) - 1,
            max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[k]


class LoadGen:
    """Closed-loop session fleet against one pool.

    ``sessions`` logical sessions multiplex over ``clients`` real
    Rados handles (round-robin). Each session performs
    ``ops_per_session`` ops — a ``read_fraction`` of them reads over a
    small shared object set, the rest writes of ``write_bytes`` to the
    session's own object — with ``think_s`` between ops.
    ``concurrency`` bounds how many sessions are in flight at once
    (0 = all of them; the closed loop per session still applies)."""

    def __init__(self, cluster, pool: str, sessions: int = 100,
                 clients: int = 8, ops_per_session: int = 5,
                 write_bytes: int = 512, read_fraction: float = 0.25,
                 think_s: float = 0.0, op_timeout: float = 30.0,
                 concurrency: int = 0, seed: int = 0):
        self.cluster = cluster
        self.pool = pool
        self.sessions = int(sessions)
        self.clients = max(1, int(clients))
        self.ops_per_session = int(ops_per_session)
        self.write_bytes = int(write_bytes)
        self.read_fraction = float(read_fraction)
        self.think_s = float(think_s)
        self.op_timeout = float(op_timeout)
        self.concurrency = int(concurrency)
        self.seed = seed
        self.latencies: list[float] = []
        self.errors: list[tuple[str, str]] = []
        self._own: list = []

    async def _open_clients(self) -> list:
        """A bounded pool of real client handles. The cluster's admin
        client is reused as handle 0 (it already holds the maps); the
        rest are fresh Rados sessions under the admin entity. Appends
        to ``self._own`` as it connects, so a mid-loop failure leaves
        the already-open handles where run()'s cleanup finds them."""
        from ceph_tpu_torch.rados import Rados
        ios = [await self.cluster.client.open_ioctx(self.pool)]
        for _ in range(self.clients - 1):
            r = Rados(self.cluster.client.monc.monmap,
                      keyring=self.cluster.keyring,
                      config=self.cluster.cfg,
                      device=self.cluster.device)
            await r.connect()
            self._own.append(r)
            ios.append(await r.open_ioctx(self.pool))
        return ios

    async def _session(self, sid: int, io, rng: random.Random,
                       sem: asyncio.Semaphore | None) -> None:
        if sem is not None:
            await sem.acquire()
        try:
            oid = f"lg-{self.seed}-{sid}"
            payload = bytes([sid % 256]) * self.write_bytes
            wrote = False
            for i in range(self.ops_per_session):
                do_read = wrote and rng.random() < self.read_fraction
                t0 = time.perf_counter()
                try:
                    if do_read:
                        await io.read(oid, timeout=self.op_timeout)
                    else:
                        await io.write_full(oid, payload,
                                            timeout=self.op_timeout)
                        wrote = True
                    self.latencies.append(time.perf_counter() - t0)
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    self.errors.append((f"{oid}#{i}", repr(e)))
                if self.think_s:
                    await asyncio.sleep(self.think_s)
        finally:
            if sem is not None:
                sem.release()

    async def run(self) -> dict:
        """Run the whole fleet; returns the load report."""
        rng = random.Random(self.seed)
        sem = asyncio.Semaphore(self.concurrency) \
            if self.concurrency > 0 else None
        t0 = time.perf_counter()
        try:
            # inside the cleanup scope: a mid-loop connect failure
            # must still shut down the handles opened before it
            ios = await self._open_clients()
            await asyncio.gather(*[
                self._session(sid, ios[sid % len(ios)],
                              random.Random(rng.random()), sem)
                for sid in range(self.sessions)])
        finally:
            for r in self._own:
                await r.shutdown()
            self._own = []
        wall = time.perf_counter() - t0
        lats = sorted(self.latencies)
        ops = len(lats)
        report = {
            "sessions": self.sessions,
            "clients": len(ios),
            "ops": ops,
            "errors": len(self.errors),
            "error_samples": self.errors[:4],
            "wall_s": round(wall, 3),
            "ops_per_s": round(ops / wall, 1) if wall > 0 else 0.0,
            "p50_ms": round(percentile(lats, 0.50) * 1e3, 2),
            "p99_ms": round(percentile(lats, 0.99) * 1e3, 2),
            "max_ms": round(percentile(lats, 1.0) * 1e3, 2),
        }
        log.dout(1, f"loadgen: {report['sessions']} sessions, "
                    f"{report['ops']} ops, {report['errors']} errors, "
                    f"{report['ops_per_s']} ops/s, "
                    f"p99 {report['p99_ms']} ms")
        return report


# -- scenario schedules (round 17) ----------------------------------------
# Each scenario is an ordered list of phases; a phase optionally fires
# one cluster event ("osd_out:<id>" / "osd_in:<id>") and then runs one
# closed-loop LoadGen fleet PER POOL concurrently to completion. The
# pool names are roles — run_scenario maps them to real pools. Session
# counts are smoke-sized; ``scale`` multiplies them for bigger rigs.
SCENARIOS: dict[str, list[dict]] = {
    # a compressed day: quiet -> peak -> quiet. The steady shape the
    # tuner must NOT act on (zero-commit acceptance).
    "diurnal_ramp": [
        {"name": "trough", "load": {"a": dict(
            sessions=6, ops_per_session=4, think_s=0.03)}},
        {"name": "peak", "load": {"a": dict(
            sessions=20, ops_per_session=6)}},
        {"name": "evening", "load": {"a": dict(
            sessions=6, ops_per_session=4, think_s=0.03)}},
    ],
    # one tenant pool goes hot while a cold tenant keeps its paced
    # trickle — the hot-pool protector's trip (burst) and heal (after)
    "hot_pool_burst": [
        {"name": "steady", "load": {"cold": dict(
            sessions=6, ops_per_session=4, think_s=0.02)}},
        {"name": "burst", "load": {
            "cold": dict(sessions=6, ops_per_session=4,
                         think_s=0.02),
            "hot": dict(sessions=24, ops_per_session=10)}},
        {"name": "after", "load": {"cold": dict(
            sessions=6, ops_per_session=4, think_s=0.02)}},
    ],
    # an OSD drops out in the middle of the rush: backfill pressure
    # lands ON TOP of peak client load — the recovery governor's
    # QoS-floor-vs-backfill trade, then the drain after the OSD
    # returns
    "backfill_storm_mid_rush": [
        {"name": "rush", "load": {"a": dict(
            sessions=16, ops_per_session=6)}},
        {"name": "outage", "event": "osd_out:1", "load": {"a": dict(
            sessions=16, ops_per_session=6)}},
        {"name": "return", "event": "osd_in:1", "load": {"a": dict(
            sessions=8, ops_per_session=4, think_s=0.02)}},
    ],
}


# -- worker-process sharding (round 18) -----------------------------------
class _WorkerCluster:
    """The minimal cluster facade a LoadGen needs (client, keyring,
    cfg, device), rebuilt inside a forked worker from the conf document —
    the same document a proc-backend daemon child reads."""

    def __init__(self, client, keyring, cfg, device):
        self.client = client
        self.keyring = keyring
        self.cfg = cfg
        self.device = device


async def run_sharded(cluster, pool: str, sessions: int = 1000,
                      workers: int = 1, clients: int = 8,
                      ops_per_session: int = 5, write_bytes: int = 512,
                      read_fraction: float = 0.25, think_s: float = 0.0,
                      op_timeout: float = 30.0, concurrency: int = 0,
                      seed: int = 0) -> dict:
    """Shard ``sessions`` across ``workers`` FORKED worker processes,
    each running its own LoadGen fleet over its own real client
    handles against the same cluster (in-process or proc backend —
    the wire doesn't care), and merge the reports: summed ops/errors,
    percentiles over the CONCATENATED latency population (a
    per-worker p99 average would hide a slow shard), wall = the
    slowest worker. One worker still exercises the whole path (conf
    hand-off, fork, merge) at tier-1 cost."""
    import json as _json
    import os
    import sys
    import tempfile

    from ceph_tpu_torch.cluster.conf import write_conf
    workers = max(1, int(workers))
    sessions = int(sessions)
    conf_path = getattr(cluster, "conf_path", None)
    tmp = None
    if conf_path is None or not os.path.exists(conf_path):
        fd, tmp = tempfile.mkstemp(prefix="lg_conf_", suffix=".json")
        os.close(fd)
        # the workers' Rados handles run where the cluster's do
        write_conf(tmp, cluster.client.monc.monmap, cluster.keyring,
                   config=cluster.cfg,
                   extra={"device": str(cluster.device)})
        conf_path = tmp
    shard = [sessions // workers +
             (1 if w < sessions % workers else 0)
             for w in range(workers)]

    async def _one(w: int) -> dict:
        params = dict(conf=conf_path, pool=pool, sessions=shard[w],
                      clients=clients, ops_per_session=ops_per_session,
                      write_bytes=write_bytes,
                      read_fraction=read_fraction, think_s=think_s,
                      op_timeout=op_timeout, concurrency=concurrency,
                      seed=seed * 1000 + w + 1)
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "ceph_tpu_torch.sim.loadgen", "--worker",
            stdin=asyncio.subprocess.PIPE, stdout=asyncio.subprocess.PIPE)
        out, _ = await proc.communicate(_json.dumps(params).encode())
        if proc.returncode != 0:
            raise RuntimeError(
                f"loadgen worker {w} exited {proc.returncode}")
        # the report is the LAST stdout line; anything above is noise
        return _json.loads(out.decode().strip().splitlines()[-1])

    t0 = time.perf_counter()
    try:
        reports = await asyncio.gather(
            *[_one(w) for w in range(workers) if shard[w] > 0])
    finally:
        if tmp is not None:
            os.unlink(tmp)
    wall = time.perf_counter() - t0
    lats = sorted(x for r in reports for x in r.pop("lats"))
    ops = len(lats)
    merged = {
        "sessions": sessions,
        "workers": len(reports),
        "ops": ops,
        "errors": sum(r["errors"] for r in reports),
        "error_samples": [s for r in reports
                          for s in r["error_samples"]][:4],
        "wall_s": round(wall, 3),
        "ops_per_s": round(ops / wall, 1) if wall > 0 else 0.0,
        "p50_ms": round(percentile(lats, 0.50) * 1e3, 2),
        "p99_ms": round(percentile(lats, 0.99) * 1e3, 2),
        "max_ms": round(percentile(lats, 1.0) * 1e3, 2),
        "per_worker": reports,
    }
    log.dout(1, f"loadgen sharded: {sessions} sessions / "
                f"{len(reports)} workers, {ops} ops, "
                f"{merged['errors']} errors, "
                f"{merged['ops_per_s']} ops/s, "
                f"p99 {merged['p99_ms']} ms")
    return merged


async def _worker_main() -> None:
    """``python -m ceph_tpu_torch.sim.loadgen --worker``: params JSON on
    stdin, merged-ready report JSON as the last stdout line."""
    import json as _json
    import sys

    from ceph_tpu_torch.cluster.conf import (
        conf_keyring,
        conf_monmap,
        read_conf_doc,
    )
    from ceph_tpu_torch.rados import Rados
    params = _json.loads(sys.stdin.read())
    doc = read_conf_doc(params["conf"])
    cfg = dict(doc.get("config") or {})
    client = Rados(conf_monmap(doc), keyring=conf_keyring(doc),
                   config=cfg, device=doc.get("device"))
    ret, rs, _ = await client.mon_command({"prefix": "status"},
                                          timeout=30.0)
    assert ret == 0, rs
    await client.connect()
    shim = _WorkerCluster(client, client.monc.msgr.keyring, cfg,
                          client.monc.device)
    lg = LoadGen(shim, params["pool"], sessions=params["sessions"],
                 clients=params["clients"],
                 ops_per_session=params["ops_per_session"],
                 write_bytes=params["write_bytes"],
                 read_fraction=params["read_fraction"],
                 think_s=params["think_s"],
                 op_timeout=params["op_timeout"],
                 concurrency=params["concurrency"],
                 seed=params["seed"])
    report = await lg.run()
    report["lats"] = [round(x, 6) for x in lg.latencies]
    await client.shutdown()
    sys.stdout.write("\n" + _json.dumps(report) + "\n")
    sys.stdout.flush()


async def run_scenario(cluster, name: str,
                       pools: dict[str, str] | None = None,
                       scale: float = 1.0, seed: int = 0,
                       clients: int = 4) -> dict:
    """Drive one named scenario: per phase, fire its event (if any)
    through the admin client, then run every pool's LoadGen fleet
    concurrently to completion. ``pools`` maps the scenario's role
    names to real pool names (identity when omitted — the pools must
    already exist). Returns per-phase reports keyed by role."""
    sched = SCENARIOS[name]
    pools = pools or {}
    phases = []
    for pi, phase in enumerate(sched):
        event = phase.get("event")
        if event:
            verb, _, arg = event.partition(":")
            prefix = {"osd_out": "osd out",
                      "osd_in": "osd in"}[verb]
            ret, rs, _ = await cluster.client.mon_command(
                {"prefix": prefix, "id": int(arg)})
            if ret != 0:
                raise RuntimeError(f"scenario event {event}: {rs}")
        gens = {
            role: LoadGen(cluster, pools.get(role, role),
                          clients=clients,
                          seed=seed * 1000 + pi,
                          **{**kw, "sessions": max(
                              1, int(kw["sessions"] * scale))})
            for role, kw in phase["load"].items()}
        reports = dict(zip(gens, await asyncio.gather(
            *[g.run() for g in gens.values()])))
        phases.append({"name": phase["name"], "event": event,
                       "reports": reports})
        log.dout(1, f"scenario {name}/{phase['name']}: " + ", ".join(
            f"{r}={reports[r]['ops_per_s']} ops/s "
            f"(p99 {reports[r]['p99_ms']} ms)" for r in reports))
    return {"scenario": name, "phases": phases}


if __name__ == "__main__":
    import sys as _sys

    if "--worker" in _sys.argv:
        asyncio.run(_worker_main())
    else:
        raise SystemExit("usage: python -m ceph_tpu_torch.sim.loadgen "
                         "--worker  (params JSON on stdin)")
