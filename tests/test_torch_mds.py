"""The port's MDS daemon and CephFS client (``ceph_tpu_torch/cephfs``)
side by side with ``ceph_tpu``'s.

Each case is one script run through a reference ``Cluster`` (JAX on the
CPU) and a port ``Cluster(device="cpu")``. The script holds the port to
the reference test's own assertions, and records what a user and the
pools show (listings, file bytes, errnos, cap tables, FSMap ranks and
states, health checks, and where the script is sequential, every object
of the pool with its bytes and omap); the two records must be equal.
The client counter and the MDS gid counter (process-local in both
packages) start again at 1 for each script, so the names agree.

- tests/test_mds.py: namespace and session, journal replay, cap revoke
  between clients, cross opens, the create-on-open race, lease eviction
  with the blocklist;
- tests/test_mds_failover.py without its Thrasher storms (those are in
  ``test_torch_storm_mds.py``): ``kill -9``
  of the active under two writing clients with a cap held open (the
  storm's assertions, through ``vstart``'s ``kill_mds`` and
  ``wait_for_mds_active``), the single-daemon outage and the
  session-survival pair, the fs CLI verbs;
- tests/test_multimds.py: FSMap v2, two actives on disjoint subtrees with
  one killed, a stale client redirected (-ESTALE, -EXDEV), the
  rebalancer's exactly-once migration, the fs commands' validation;
- tests/test_epoch_barrier.py: eviction under a stale-map OSD with and
  without the barrier, ``osd blocklist add``'s epoch;
- tests/test_tracing.py:313: a client's metadata op reassembled as
  ``mds_req`` -> ``mds_op`` spans;
- a reference client and a port MDS, and the other way round, on one
  wire: every ``MClientRequest`` answered with the same ``MClientReply``.

Tolerance: exact bytes everywhere.
"""

import asyncio
import hashlib
import itertools
import json
import types

import pytest

FAST_CFG = {
    "mds_beacon_interval": 0.2,
    "mds_beacon_grace": 2.0,
    "mds_reconnect_timeout": 1.0,
    "mds_replay_interval": 0.1,
}
MULTI_CFG = dict(FAST_CFG, mds_bal_interval=0.0)


RUN_LIMIT = 300.0      # s; a stuck script fails instead of holding its worker


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, RUN_LIMIT))


def _pkg(which: str):
    """One package's names; its client and MDS gid counters reset."""
    if which == "ref":
        import ceph_tpu.bench.ceph_cli as cli
        import ceph_tpu.cephfs as fs
        import ceph_tpu.cephfs.client as client
        import ceph_tpu.cephfs.fsmap as fsmap
        import ceph_tpu.cephfs.mds as mds
        import ceph_tpu.mgr as mgr
        import ceph_tpu.rados as rados
        import ceph_tpu.sim.faults as faults
        from ceph_tpu.cluster.vstart import Cluster
        kw = {}
    else:
        import ceph_tpu_torch.bench.ceph_cli as cli
        import ceph_tpu_torch.cephfs as fs
        import ceph_tpu_torch.cephfs.client as client
        import ceph_tpu_torch.cephfs.fsmap as fsmap
        import ceph_tpu_torch.cephfs.mds as mds
        import ceph_tpu_torch.mgr as mgr
        import ceph_tpu_torch.rados as rados
        import ceph_tpu_torch.sim.faults as faults
        from ceph_tpu_torch.cluster.vstart import Cluster
        kw = {"device": "cpu"}
    client.CephFSClient._next_id = 0
    mds._GID = itertools.count(1)
    return types.SimpleNamespace(
        Cluster=Cluster, kw=kw, fs=fs, mds=mds, fsmap=fsmap, cli=cli,
        mgr=mgr, F=faults, MDSDaemon=mds.MDSDaemon,
        CephFSLite=fs.CephFSLite, CephFSClient=client.CephFSClient,
        FSError=fs.FSError, Error=rados.ObjectOperationError)


def both(script):
    """The script's record through the reference, then the port."""
    ref = run(script(_pkg("ref")))
    port = run(script(_pkg("port")))
    assert len(ref) == len(port)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, (i, a, b)
    return port


async def _pool(c, P, name="fs", pg_num=8, size=3, min_size=None):
    kw = {"min_size": min_size} if min_size else {}
    await c.client.pool_create(name, pg_num=pg_num, size=size, **kw)
    await c.wait_for_clean(timeout=120)
    io = await c.client.open_ioctx(name)
    for _ in range(30):
        try:
            await io.write_full("_warm", b"x")
            break
        except P.Error:
            await asyncio.sleep(1)
    return io


async def _errno(P, coro):
    try:
        await coro
    except P.FSError as e:
        return e.errno
    return 0


async def _dump(io, P) -> list:
    """Every object of the pool with its bytes and omap, sorted."""
    out = []
    for oid in sorted(await io.list_objects()):
        try:
            data = await io.read(oid)
        except P.Error:
            data = None
        try:
            omap = await io.get_omap_vals(oid)
        except P.Error:
            omap = None
        out.append((oid, data, omap))
    return out


def _caps(mds, *paths):
    return {p: {c: list(v) for c, v in sorted(mds.caps.get(p, {}).items())}
            for p in paths}


async def _poll(pred, timeout=5.0, every=0.1):
    for _ in range(int(timeout / every)):
        if pred():
            return True
        await asyncio.sleep(every)
    return pred()


# -- tests/test_mds.py -----------------------------------------------------------

def test_namespace_and_session():
    async def script(P):
        out = []
        c = await P.Cluster(n_mons=1, n_osds=3, **P.kw).start()
        try:
            io = await _pool(c, P)
            mds = P.MDSDaemon(io)
            await mds.fs.mount()
            addr = await mds.start()
            cl_io = await c.client.open_ioctx("fs")
            cl = await P.CephFSClient(cl_io, addr).mount()
            await cl.mkdir("/a")
            await cl.mkdir("/a/b")
            await cl.write_file("/a/b/f.txt", b"via mds")
            out.append(await cl.ls("/a"))
            out.append(await cl.read_file("/a/b/f.txt"))
            st = await cl.stat("/a/b/f.txt")
            assert st["type"] == "file" and st["size"] == 7
            out.append(st)
            await cl.rename("/a/b/f.txt", "/top.txt")
            out.append(await cl.read_file("/top.txt"))
            out.append(await _errno(P, cl.mkdir("/a")))        # EEXIST
            out.append(await _errno(P, cl.rmdir("/a")))        # ENOTEMPTY
            out.append(await _errno(P, cl.rmdir("/")))
            out.append(await _errno(P, cl.read_file("/nope")))
            out.append(await _errno(P, cl.unlink("/a")))
            assert out[-5:-3] == [-17, -39]
            await cl.write_file("/a/b/g", b"g" * 5000)
            h = await cl.open_file("/a/b/g", "w")
            await h.write(b"tail", offset=5000)
            await h.close()
            out.append(await cl.stat("/a/b/g"))
            out.append(await cl.ls("/"))
            cl2 = P.CephFSClient(cl_io, addr)      # never mounted
            out.append(await _errno(P, cl2._request("mkdir", "/nope")))
            assert out[-1] < 0
            await cl2.msgr.shutdown()
            await cl.unmount()
            await mds.stop()
            out.append(await _dump(io, P))
        finally:
            await c.stop()
        return out
    both(script)


def test_journal_replay():
    async def script(P):
        out = []
        c = await P.Cluster(n_mons=1, n_osds=3, **P.kw).start()
        try:
            io = await _pool(c, P)
            mds = P.MDSDaemon(io)
            await mds.fs.mount()
            addr = await mds.start()
            cl = await P.CephFSClient(
                await c.client.open_ioctx("fs"), addr).mount()
            await cl.mkdir("/kept")
            await cl.write_file("/target", b"old")
            await cl.write_file("/tmp.x", b"precious")
            await cl.rename("/tmp.x", "/target")
            assert await cl.read_file("/target") == b"precious"
            await cl.unmount()
            out.append(await io.get_omap_vals(P.mds.JOURNAL_OID))
            await io.set_omap(P.mds.JOURNAL_OID, f"{99:016d}", json.dumps(
                {"op": "mkdir", "path": "/lost"}).encode())
            await mds.stop()
            mds2 = P.MDSDaemon(io)
            addr2 = await mds2.start()
            cl2 = await P.CephFSClient(
                await c.client.open_ioctx("fs"), addr2).mount()
            names = await cl2.ls("/")
            assert "lost" in names and "kept" in names
            assert await cl2.read_file("/target") == b"precious"
            assert "tmp.x" not in names
            out.append(names)
            assert not await io.get_omap_vals(P.mds.JOURNAL_OID)
            await cl2.unmount()
            await io.set_omap(P.mds.JOURNAL_OID, f"{100:016d}", json.dumps(
                {"op": "mkdir", "path": "/lost"}).encode())
            await mds2.stop()
            mds3 = P.MDSDaemon(io)
            addr3 = await mds3.start()
            cl3 = await P.CephFSClient(
                await c.client.open_ioctx("fs"), addr3).mount()
            out.append(await cl3.ls("/"))
            await cl3.unmount()
            await mds3.stop()
            out.append(await _dump(io, P))
        finally:
            await c.stop()
        return out
    both(script)


def test_cap_revoke_between_clients():
    async def script(P):
        out = []
        FR, FW = P.mds.CAP_FR, P.mds.CAP_FW
        c = await P.Cluster(n_mons=1, n_osds=3, **P.kw).start()
        try:
            io = await _pool(c, P)
            mds = P.MDSDaemon(io)
            await mds.fs.mount()
            addr = await mds.start()
            a = await P.CephFSClient(await c.client.open_ioctx("fs"),
                                     addr).mount()
            b = await P.CephFSClient(await c.client.open_ioctx("fs"),
                                     addr).mount()
            ha = await a.open_file("/shared.txt", "w")
            await ha.write(b"from a")
            assert mds.caps["/shared.txt"][a.msgr.name][0] == FW
            out.append(_caps(mds, "/shared.txt"))
            hb = await b.open_file("/shared.txt", "r")
            assert await hb.read() == b"from a"
            assert not ha.valid
            assert mds.caps["/shared.txt"][b.msgr.name][0] == FR
            out.append(_caps(mds, "/shared.txt"))
            ha2 = await a.open_file("/shared.txt", "r")
            assert hb.valid and ha2.valid
            out.append(_caps(mds, "/shared.txt"))
            hw = await b.open_file("/shared.txt", "w")
            await hw.write(b"from b")
            assert not ha2.valid
            out.append(_caps(mds, "/shared.txt"))
            assert await ha2.read() == b"from b"
            haw = await a.open_file("/dual.txt", "w")
            await haw.write(b"x")
            har = await a.open_file("/dual.txt", "r")
            await har.close()
            await _poll(lambda: mds.caps.get("/dual.txt", {}).get(
                a.msgr.name, [0, 0])[1] == 1)
            assert mds.caps["/dual.txt"][a.msgr.name][0] == FW
            out.append(_caps(mds, "/dual.txt"))
            hbw = await b.open_file("/dual.txt", "w")
            assert not haw.valid
            out.append(_caps(mds, "/dual.txt"))
            for h in (hbw, haw, hw, ha2, hb):
                await h.close()
            assert await _poll(lambda: "/shared.txt" not in mds.caps)
            out.append(_caps(mds, "/shared.txt", "/dual.txt"))
            await a.unmount()
            await b.unmount()
            await mds.stop()
        finally:
            await c.stop()
        return out
    both(script)


def test_cross_open_and_the_create_race():
    """test_mds_cross_open_no_deadlock and
    test_mds_create_on_open_race_preserves_write, on one cluster."""
    async def script(P):
        out = []
        FW = P.mds.CAP_FW
        c = await P.Cluster(n_mons=1, n_osds=3, **P.kw).start()
        try:
            io = await _pool(c, P)
            mds = P.MDSDaemon(io)
            await mds.fs.mount()
            addr = await mds.start()
            a = await P.CephFSClient(await c.client.open_ioctx("fs"),
                                     addr).mount()
            b = await P.CephFSClient(await c.client.open_ioctx("fs"),
                                     addr).mount()
            ha = await a.open_file("/f1", "w")
            await ha.write(b"1")
            hb = await b.open_file("/f2", "w")
            await hb.write(b"2")
            h2, h1 = await asyncio.wait_for(asyncio.gather(
                a.open_file("/f2", "w"), b.open_file("/f1", "w")),
                timeout=20)
            assert h2.valid and h1.valid
            assert mds.caps["/f2"][a.msgr.name][0] == FW
            assert mds.caps["/f1"][b.msgr.name][0] == FW
            out.append(_caps(mds, "/f1", "/f2"))
            for h in (h1, h2):
                await h.close()
            # the create-on-open race, forced by a gate in the create
            orig = mds.fs.write_file
            gates = [asyncio.Event(), asyncio.Event()]
            seen = [0]

            async def gated(path, data):
                if path == "/race.txt" and data == b"":
                    i = min(seen[0], 1)
                    seen[0] += 1
                    await gates[i].wait()
                return await orig(path, data)
            mds.fs.write_file = gated
            ta = asyncio.create_task(a.open_file("/race.txt", "w"))
            await asyncio.sleep(0.3)
            tb = asyncio.create_task(b.open_file("/race.txt", "w"))
            await asyncio.sleep(0.3)
            gates[0].set()
            hra = await asyncio.wait_for(ta, 20)
            await hra.write(b"precious")
            gates[1].set()
            hrb = await asyncio.wait_for(tb, 20)
            assert hrb.valid
            out.append(await b.read_file("/race.txt"))
            assert out[-1] == b"precious"
            out.append(seen[0])
            await hrb.close()
            await hra.close()
            await a.unmount()
            await b.unmount()
            await mds.stop()
        finally:
            await c.stop()
        return out
    both(script)


def test_lease_eviction_blocklists():
    async def script(P):
        out = []
        c = await P.Cluster(n_mons=1, n_osds=3, **P.kw).start()
        try:
            await _pool(c, P)
            mds = P.MDSDaemon(await c.client.open_ioctx("fs"),
                              lease_timeout=1.0, revoke_timeout=12.0)
            await mds.fs.mount()
            addr = await mds.start()
            monmap = c.client.monc.monmap
            a = await P.CephFSClient.create(monmap, addr, "fs",
                                            keyring=c.keyring, **P.kw)
            b = await P.CephFSClient.create(monmap, addr, "fs",
                                            keyring=c.keyring, **P.kw)
            ha = await a.open_file("/hostage.txt", "w")
            await ha.write(b"held")
            a._renew_task.cancel()

            async def never_acks(msg):
                pass
            a._handle_revoke = never_acks
            t0 = asyncio.get_event_loop().time()
            hb = await asyncio.wait_for(b.open_file("/hostage.txt", "w"),
                                        timeout=10)
            assert asyncio.get_event_loop().time() - t0 < 8
            assert hb.valid
            out.append([a.msgr.name in mds.sessions,
                        _caps(mds, "/hostage.txt")])
            fenced = None
            for _ in range(50):
                try:
                    await a.ioctx.write_full(P.fs._fileobj("/hostage.txt"),
                                             b"zombie")
                except P.Error as e:
                    fenced = e.errno
                    break
                await asyncio.sleep(0.2)
            assert fenced == -108
            out.append(fenced)
            await hb.write(b"taken")
            out.append(await b.read_file("/hostage.txt"))
            ret, _, ls = await c.client.mon_command(
                {"prefix": "osd blocklist", "blocklistop": "ls"})
            assert ret == 0 and a.msgr.name in ls.decode()
            ret, _, _ = await c.client.mon_command(
                {"prefix": "osd blocklist", "blocklistop": "rm",
                 "addr": a.msgr.name})
            out.append(ret)
            await hb.close()
            await b.unmount()
            await a.msgr.shutdown()
            await a._own_rados.shutdown()
            await mds.stop()
        finally:
            await c.stop()
        return out
    both(script)


# -- tests/test_mds_failover.py (the storm's assertions, without the Thrasher)

async def _storm(P, c, clients, writes, files_before_kill, kill_rank=0,
                 writer_dirs=None, survivor_writers=()):
    """Thrasher.mds_storm's contract through vstart: each client writes
    ``writes`` files, the active of ``kill_rank`` is killed once
    ``files_before_kill`` are acked, a standby takes over; no writer
    errs, survivors keep acking through the takeover, every acked file
    reads back, the zombie's late journal write bounces (-108). Returns
    the acked files."""
    acked, errors, prog = {}, [], [0] * len(clients)

    async def writer(w, cl):
        base = writer_dirs[w] if writer_dirs else ""
        for i in range(writes):
            path = f"{base}/storm-{w}-{i:04d}"
            data = bytes([(w + i) % 256]) * (1 + (w * 131 + i * 17) % 512)
            try:
                await asyncio.wait_for(cl.write_file(path, data), 45.0)
                acked[path] = data
                prog[w] += 1
            except asyncio.CancelledError:
                raise
            except Exception as e:
                errors.append((path, repr(e)))
            await asyncio.sleep(0.01)
    tasks = [asyncio.ensure_future(writer(w, cl))
             for w, cl in enumerate(clients)]
    try:
        deadline = asyncio.get_event_loop().time() + 120.0
        while len(acked) < files_before_kill:
            # a writer that errs or ends short would leave this waiting
            assert not errors and not all(t.done() for t in tasks) and \
                asyncio.get_event_loop().time() < deadline, \
                (len(acked), files_before_kill, errors[:4])
            await asyncio.sleep(0.05)
        victim = c.mds_active_name(kill_rank)
        at_kill = list(prog)
        zombie = await c.kill_mds(victim)
        newa = await c.wait_for_mds_active(not_name=victim, timeout=45.0,
                                           rank=kill_rank)
        assert newa != victim
        for w in survivor_writers:
            assert at_kill[w] >= writes or prog[w] > at_kill[w], \
                "a surviving rank's writer stalled through the takeover"
        done, pending = await asyncio.wait(tasks, timeout=120.0)
        assert not pending
    finally:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
    assert not errors, errors[:4]
    for path, data in acked.items():
        assert await clients[0].read_file(path) == data, path
    for _ in range(75):
        try:
            await zombie.ioctx.set_omap(zombie.journal_oid, "_zombie_probe",
                                        b"stale")
        except P.Error as e:
            assert e.errno == -108, e
            break
        await asyncio.sleep(0.2)
    else:
        raise AssertionError("the zombie's journal write was never fenced")
    return acked


async def _status(c):
    ret, _, out = await c.client.mon_command({"prefix": "status"})
    assert ret == 0
    return json.loads(out)


async def _wait_health(c, check, timeout=15.0):
    deadline = asyncio.get_event_loop().time() + timeout
    while True:
        st = await _status(c)
        if check in st["health"]["checks"]:
            return st
        assert asyncio.get_event_loop().time() < deadline, \
            (check, st["health"])
        await asyncio.sleep(0.2)


def _ranks(dump: dict) -> list:
    """``fs dump``/``fs status`` ranks without gids and addresses."""
    return [{k: r.get(k) for k in ("rank", "state")}
            for r in dump["ranks"]]


def test_failover_under_writers_keeps_a_held_cap():
    async def script(P):
        out = []
        c = await P.Cluster(n_mons=1, n_osds=3, config=FAST_CFG,
                            **P.kw).start()
        try:
            await c.start_fs(n_mds=2)
            monmap = c.client.monc.monmap
            cl1 = await P.CephFSClient.create(monmap, None, "cephfs",
                                              keyring=c.keyring, **P.kw)
            cl2 = await P.CephFSClient.create(monmap, None, "cephfs",
                                              keyring=c.keyring, **P.kw)
            held = await cl1.open_file("/held.txt", "w")
            await held.write(b"pre-failover")
            t0 = P.mds.MDS_PERF.dump().get("takeovers", 0)
            acked = await _storm(P, c, [cl1, cl2], writes=10,
                                 files_before_kill=2)
            assert len(acked) == 20
            assert P.mds.MDS_PERF.dump().get("takeovers", 0) > t0
            assert held.valid
            await held.write(b"post-failover")
            out.append(await cl2.read_file("/held.txt"))
            out.append(sorted((p, hashlib.md5(d).hexdigest())
                              for p, d in acked.items()))
            out.append(await cl2.ls("/"))
            st = await _wait_health(c, "MDS_INSUFFICIENT_STANDBY")
            assert st["fsmap"]["active"] is not None
            out.append([st["fsmap"]["standby_count"],
                        sorted(st["fsmap"]["states"].values())])
            ret, _, raw = await c.client.mon_command({"prefix": "fs status"})
            dump = json.loads(raw)
            assert dump["last_failure_osd_epoch"] > 0
            assert dump["stopped_gids"]
            out.append(_ranks(dump))
            await cl1.unmount()
            await cl2.unmount()
        finally:
            await c.stop()
        return out
    both(script)


async def _http_get(port: int, path: str) -> str:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.0\r\n\r\n".encode())
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), timeout=5.0)
    writer.close()
    return raw.partition(b"\r\n\r\n")[2].decode()


def test_single_daemon_outage_and_session_survival_pair():
    async def script(P):
        out = []
        c = await P.Cluster(n_mons=1, n_osds=3, config=FAST_CFG,
                            mgr_modules=[P.mgr.RestModule,
                                         P.mgr.PrometheusModule],
                            **P.kw).start()
        try:
            await c.start_fs(n_mds=1)
            monmap = c.client.monc.monmap
            ha = await P.CephFSClient.create(monmap, None, "cephfs",
                                             keyring=c.keyring, **P.kw)
            active = next(m for m in c.mdss if not m._stopping)
            pinned = await P.CephFSClient.create(
                monmap, active.addr, "cephfs", keyring=c.keyring, **P.kw)
            await ha.write_file("/ha.txt", b"ha")
            await pinned.write_file("/pinned.txt", b"pinned")
            await c.kill_mds(active.name)
            st = await _wait_health(c, "MDS_ALL_DOWN")
            out.append(st["fsmap"]["failed"])
            await c.revive_mds(active.name)
            await c.wait_for_mds_active(timeout=30)
            await ha.write_file("/ha2.txt", b"recovered")
            out.append(await ha.read_file("/ha2.txt"))
            out.append(sorted(await ha.ls("/")))
            with pytest.raises(Exception):
                await pinned._request("stat", "/", timeout=2.0)
            rest, prom = c.mgr.modules[0], c.mgr.modules[1]
            assert await _poll(lambda: rest.port and prom.port, 10.0)
            out.append(json.loads(await _http_get(rest.port, "/health"))
                       ["status"] in ("HEALTH_OK", "HEALTH_WARN"))
            out.append("fsmap" in json.loads(await _http_get(rest.port,
                                                             "/status")))
            deadline = asyncio.get_event_loop().time() + 15.0
            while True:
                metrics = await _http_get(prom.port, "/metrics")
                if "ceph_mds_state{" in metrics and \
                        'state="active"' in metrics:
                    break
                assert asyncio.get_event_loop().time() < deadline
                await asyncio.sleep(0.5)
            out.append(sorted(line.split(" ")[0] for line in
                              metrics.splitlines()
                              if line.startswith("ceph_mds_state{")))
            await ha.unmount()
            await pinned.msgr.shutdown()
            await pinned._own_rados.shutdown()
        finally:
            await c.stop()
        return out
    both(script)


FS_VERBS = [["fs", "status"], ["fs", "dump"], ["mds", "fail", "a"],
            ["fs", "set", "max_mds", "2"], ["fs", "subtree", "pin", "/a", "1"],
            ["fs", "subtree", "ls"]]


@pytest.mark.parametrize("words", FS_VERBS, ids=" ".join)
def test_fs_cli_parses_as_the_reference(words):
    ref, port = _pkg("ref").cli, _pkg("port").cli
    assert port.parse_command(words) == ref.parse_command(words)


# -- tests/test_multimds.py -----------------------------------------------------

def test_fsmap_v2_encodes_as_the_reference():
    out = []
    for P in (_pkg("ref"), _pkg("port")):
        m = P.fsmap.FSMap()
        m.epoch, m.max_mds = 7, 3
        m.infos[11] = P.fsmap.MDSInfo(gid=11, name="a", ident="mds.a.11",
                                      host="h", port=9, state="active",
                                      rank=0)
        m.infos[12] = P.fsmap.MDSInfo(gid=12, name="b", ident="mds.b.12",
                                      host="h", port=10, state="active",
                                      rank=2)
        m.subtrees = {"/": 0, "/a": 1, "/a/b": 2}
        m.migrations = [{"path": "/c", "from": 0, "to": 1}]
        m.failed, m.last_failure_osd_epoch = [1], 5
        m.snaps = {1: {"name": "s1", "path": "/a", "pool": "fs"}}
        d = P.fsmap.FSMap.decode(m.encode())
        assert d.subtree_owner("/a/b/c.txt") == (2, "/a/b")
        assert d.subtree_owner("/a/bb") == (1, "/a")
        assert d.subtree_owner("/x/y") == (0, "/")
        out.append([m.encode(), P.fsmap.FSMap().encode(),
                    d.subtree_owner("/a"), sorted(d.actives())])
    assert out[0] == out[1]


def test_two_actives_keep_serving_when_one_is_killed():
    async def script(P):
        out = []
        c = await P.Cluster(n_mons=1, n_osds=3, config=MULTI_CFG,
                            **P.kw).start()
        try:
            await c.start_fs(n_mds=3, max_mds=2)
            monmap = c.client.monc.monmap
            cl0 = await P.CephFSClient.create(monmap, None, "cephfs",
                                              keyring=c.keyring, **P.kw)
            cl1 = await P.CephFSClient.create(monmap, None, "cephfs",
                                              keyring=c.keyring, **P.kw)
            await cl0.mkdir("/w0")
            await cl0.mkdir("/w1")
            await c.subtree_pin("/w1", 1)
            ret, _, raw = await c.client.mon_command(
                {"prefix": "fs subtree ls"})
            out.append(json.loads(raw))
            acked = await _storm(P, c, [cl0, cl1], writes=12,
                                 files_before_kill=4, kill_rank=1,
                                 writer_dirs=["/w0", "/w1"],
                                 survivor_writers=[0])
            assert len(acked) == 24
            ret, _, raw = await c.client.mon_command({"prefix": "fs dump"})
            dump = json.loads(raw)
            assert dump["last_failure_osd_epoch"] > 0
            out.append([_ranks(dump), dump["subtrees"]])
            extra_probe = await P.CephFSClient.create(
                monmap, None, "cephfs", keyring=c.keyring, **P.kw)
            out.append([await extra_probe.ls("/w0"),
                        await extra_probe.ls("/w1")])
            out.append(sorted((p, hashlib.md5(d).hexdigest())
                              for p, d in acked.items()))
            for cl in (cl0, cl1, extra_probe):
                await cl.unmount()
        finally:
            await c.stop()
        return out
    both(script)


def test_a_stale_client_is_redirected_to_the_owner():
    async def script(P):
        out = []
        c = await P.Cluster(n_mons=1, n_osds=3, config=MULTI_CFG,
                            **P.kw).start()
        try:
            await c.start_fs(n_mds=2, max_mds=2)
            cl = await P.CephFSClient.create(c.client.monc.monmap, None,
                                             "cephfs", keyring=c.keyring,
                                             **P.kw)
            await cl.mkdir("/a")
            await cl.write_file("/a/before.txt", b"pre-pin")
            cl._on_fsmap = lambda fm: None
            await c.subtree_pin("/a", 1)
            r0 = P.mds.MDS_PERF.dump().get("redirects_sent", 0)
            await cl.write_file("/a/after.txt", b"redirected")
            assert P.mds.MDS_PERF.dump().get("redirects_sent", 0) > r0
            out.append(await cl.read_file("/a/after.txt"))
            out.append(await cl.read_file("/a/before.txt"))
            rank1 = next(m for m in c.mdss
                         if m.rank == 1 and not m._stopping)
            assert rank1._subtree_op_counts.get("/a", 0) > 0
            out.append(await _errno(P, cl.rename("/a/after.txt",
                                                 "/elsewhere.txt")))
            assert out[-1] == -18
            await cl.rename("/a/after.txt", "/a/renamed.txt")
            out.append(await cl.ls("/a"))
            out.append(cl._hints)
            await cl.unmount()
        finally:
            await c.stop()
        return out
    both(script)


def test_the_rebalancer_migrates_a_hot_subtree_exactly_once():
    async def script(P):
        cfg = dict(MULTI_CFG, mds_bal_interval=0.4, mds_bal_min_ops=5.0,
                   mds_bal_ratio=1.2)
        c = await P.Cluster(n_mons=1, n_osds=3, config=cfg, **P.kw).start()
        try:
            await c.start_fs(n_mds=2, max_mds=2)
            clients = [await P.CephFSClient.create(
                c.client.monc.monmap, None, "cephfs", keyring=c.keyring,
                **P.kw) for _ in range(2)]
            await clients[0].mkdir("/hot")
            errors, acked, stop = [], {}, asyncio.Event()

            async def writer(w, cl):
                i = 0
                while not stop.is_set() and i < 200:
                    src, dst = f"/hot/w{w}-{i:04d}.tmp", f"/hot/w{w}-{i:04d}"
                    data = bytes([(w * 7 + i) % 256]) * 128
                    try:
                        await asyncio.wait_for(cl.write_file(src, data), 45)
                        await asyncio.wait_for(cl.rename(src, dst), 45)
                        acked[dst] = data
                    except asyncio.CancelledError:
                        raise
                    except Exception as e:
                        errors.append((src, repr(e)))
                    i += 1
                    await asyncio.sleep(0)
            tasks = [asyncio.ensure_future(writer(w, cl))
                     for w, cl in enumerate(clients)]
            deadline = asyncio.get_event_loop().time() + 60.0
            while True:
                ret, _, raw = await c.client.mon_command(
                    {"prefix": "fs subtree ls"})
                sub = json.loads(raw)
                if sub["subtrees"].get("/hot") == 1 and \
                        not sub["migrations"]:
                    break
                assert asyncio.get_event_loop().time() < deadline, sub
                await asyncio.sleep(0.2)
            await asyncio.sleep(1.0)
            stop.set()
            await asyncio.wait(tasks, timeout=90.0)
            assert not errors, errors[:4]
            listing = set(await clients[0].ls("/hot"))
            for dst, data in acked.items():
                name = dst.rsplit("/", 1)[1]
                assert name in listing and f"{name}.tmp" not in listing
                assert await clients[0].read_file(dst) == data
            assert acked and listing == {d.rsplit("/", 1)[1] for d in acked}
            rank1 = next(m for m in c.mdss
                         if m.rank == 1 and not m._stopping)
            assert rank1._subtree_op_counts.get("/hot", 0) > 0
            for cl in clients:
                await cl.unmount()
            # how many renames landed is a matter of timing; the record
            # is what must hold
            return [sub, not errors, bool(acked)]
        finally:
            await c.stop()
    both(script)


def test_fs_commands_validate_and_max_mds_lowers():
    async def script(P):
        out = []
        c = await P.Cluster(n_mons=1, n_osds=3, config=MULTI_CFG,
                            **P.kw).start()
        try:
            await c.start_fs(n_mds=3, max_mds=2)
            for cmd in ({"prefix": "fs set", "var": "max_mds", "val": "0"},
                        {"prefix": "fs set", "var": "max_mds", "val": "17"},
                        {"prefix": "fs set", "var": "max_mds", "val": "x"},
                        {"prefix": "fs set", "var": "nope", "val": "1"},
                        {"prefix": "fs subtree pin", "path": "/p",
                         "rank": 9}):
                out.append(list(await c.client.mon_command(cmd))[:2])
            assert [r[0] for r in out] == [-22] * 5
            ret, _, raw = await c.client.mon_command({"prefix": "fs dump"})
            dump = json.loads(raw)
            assert dump["max_mds"] == 2 and len(dump["ranks"]) == 2
            out.append([dump["subtrees"], dump["migrations"], _ranks(dump)])
            st = await c.client.status()
            out.append([st["fsmap"]["max_mds"],
                        sorted(map(str, st["fsmap"]["actives"]))])
            await c.subtree_pin("/p2", 1)
            ret, rs, _ = await c.client.mon_command(
                {"prefix": "fs set", "var": "max_mds", "val": "1"})
            assert ret == 0, rs
            deadline = asyncio.get_event_loop().time() + 20.0
            while True:
                fm = c.leader().mdsmon.fsmap
                if set(fm.rank_holders()) == {0} and not fm.failed and \
                        fm.standbys():
                    break
                assert asyncio.get_event_loop().time() < deadline
                await asyncio.sleep(0.1)
            assert all(i.rank != 1 for i in fm.infos.values())
            out.append([fm.subtrees, fm.max_mds, len(fm.standbys())])
        finally:
            await c.stop()
        return out
    both(script)


# -- tests/test_epoch_barrier.py -------------------------------------------------

async def _barrier_script(P, barrier: bool):
    out = []
    c = await P.Cluster(n_mons=1, n_osds=1, **P.kw).start()
    inj = P.F.FaultInjector(seed=4)
    c.install_faults(inj)
    await _pool(c, P, pg_num=4, size=1, min_size=1)
    mds = P.MDSDaemon(await c.client.open_ioctx("fs"), lease_timeout=1.0,
                      revoke_timeout=25.0)
    if not barrier:
        async def no_barrier(holder, outbl):
            return True
        mds._blocklist_barrier = no_barrier
    await mds.fs.mount()
    addr = await mds.start()
    monmap = c.client.monc.monmap
    a = await P.CephFSClient.create(monmap, addr, "fs", keyring=c.keyring,
                                    **P.kw)
    b = await P.CephFSClient.create(monmap, addr, "fs", keyring=c.keyring,
                                    **P.kw)
    try:
        ha = await a.open_file("/fence.txt", "w")
        await ha.write(b"held")
        a._renew_task.cancel()

        async def never_acks(msg):
            pass
        a._handle_revoke = never_acks
        inj.install("stale-map", [P.F.drop("mon.*", "osd.*")])
        if barrier:
            topen = asyncio.ensure_future(b.open_file("/fence.txt", "w"))
            await asyncio.sleep(3.0)
            assert not topen.done()
            inj.clear("stale-map")
            hb = await asyncio.wait_for(topen, timeout=30)
            await hb.write(b"taken")
            with pytest.raises(P.Error) as ei:
                await a.ioctx.write_full(P.fs._fileobj("/fence.txt"),
                                         b"zombie")
            out.append(ei.value.errno)
        else:
            hb = await asyncio.wait_for(b.open_file("/fence.txt", "w"),
                                        timeout=20)
            await hb.write(b"taken!")
            await a.ioctx.write_full(P.fs._fileobj("/fence.txt"), b"zombie")
        out.append(await b.read_file("/fence.txt"))
        await hb.close()
        await b.unmount()
    finally:
        inj.clear_all()
        for cl in (a, b):
            try:
                await cl.msgr.shutdown()
                await cl._own_rados.shutdown()
            except Exception:
                pass
        await mds.stop()
        await c.stop()
    return out


def test_eviction_waits_for_the_osd_to_observe_the_blocklist():
    assert both(lambda P: _barrier_script(P, True)) == [-108, b"taken"]


def test_eviction_without_the_barrier_lets_the_zombie_write():
    """The reference's regression proof, both packages alike: without
    the barrier the zombie's write lands on the stale OSD."""
    assert both(lambda P: _barrier_script(P, False)) == [b"zombie"]


def test_blocklist_add_reports_its_commit_epoch():
    async def script(P):
        c = await P.Cluster(n_mons=1, n_osds=1, **P.kw).start()
        try:
            before = c.client.monc.osdmap.epoch
            ret, _, raw = await c.client.mon_command(
                {"prefix": "osd blocklist", "blocklistop": "add",
                 "addr": "client.zombie", "expire": 60.0})
            epoch = json.loads(raw)["epoch"]
            assert ret == 0 and epoch > before
            await c.client.objecter.wait_for_map_on_osds(epoch,
                                                         timeout=15.0)
            return [ret, epoch - before]
        finally:
            await c.stop()
    both(script)


# -- tests/test_tracing.py:313 ---------------------------------------------------

def test_a_metadata_op_reassembles_as_client_and_mds_spans():
    async def script(P):
        c = await P.Cluster(n_mons=1, n_osds=3,
                            config={"trace_sampling_rate": 1.0},
                            **P.kw).start()
        try:
            await c.start_fs(pool="cephfs", n_mds=1, timeout=120)
            cl = await P.CephFSClient.create(
                c.client.monc.monmap, None, "cephfs", keyring=c.keyring,
                config=c.cfg, **P.kw)
            await cl.mkdir("/traced")
            await cl.unmount()
            lead = c.leader()
            deadline = asyncio.get_event_loop().time() + 15
            found = None
            while found is None:
                for row in lead.trace_index.ls(limit=20):
                    if row["root"] == "mds_req" and any(
                            s.startswith("mds.") for s in row["services"]):
                        found = lead.trace_index.show(row["trace_id"])
                        break
                if found is None:
                    assert asyncio.get_event_loop().time() < deadline
                    await asyncio.sleep(0.1)
            root = found["tree"][0]
            (op,) = [n for n in root["children"] if n["name"] == "mds_op"]
            assert op["duration"] <= root["duration"] + 0.010
            return [root["name"], root["service"], op["service"],
                    op["tags"]["op"], op["tags"].get("path")]
        finally:
            await c.stop()
    both(script)


# -- a client and an MDS of either package on one wire --------------------------

OPS = [("mkdir", "/d", "", 0), ("mkdir", "/d", "", 0),
       ("open", "/d/f", "", 2), ("setattr", "/d/f", "", 5),
       ("stat", "/d/f", "", 0), ("readdir", "/d", "", 0),
       ("rename", "/d/f", "/d/g", 0), ("stat", "/d/f", "", 0),
       ("mkdir", "/d/.snap/s1", "", 0), ("readdir", "/d/.snap", "", 0),
       ("unlink", "/d/g", "", 0), ("rmdir", "/d", "", 0),
       ("readdir", "/", "", 0), ("rmdir", "/nope", "", 0)]


async def _exchange(mds_pkg: str, client_pkg: str) -> list:
    """On a reference cluster, an MDS of ``mds_pkg`` and a client of
    ``client_pkg`` (the port's over a port ``Rados``): each request of
    ``OPS`` and the reply it gets."""
    from ceph_tpu.cluster.vstart import Cluster as RefCluster
    from ceph_tpu_torch.mon.monitor import MonMap as PortMonMap
    from ceph_tpu_torch.msg import Keyring as PortKeyring
    from ceph_tpu_torch.rados import Rados as PortRados
    M, C = _pkg(mds_pkg), _pkg(client_pkg)
    c = await RefCluster(n_mons=1, n_osds=3).start()
    rados = []
    try:
        await _pool(c, _pkg("ref"))

        async def ioctx(P):
            if not P.kw:
                return await c.client.open_ioctx("fs")
            monmap = PortMonMap(fsid=c.monmap.fsid)
            for name, (rank, host, p) in c.monmap.mons.items():
                monmap.add(name, rank, host, p)
            r = PortRados(monmap, keyring=PortKeyring(dict(c.keyring.keys)),
                          config=c.cfg, device="cpu")
            await r.connect()
            rados.append(r)
            return await r.open_ioctx("fs")
        mds = M.MDSDaemon(await ioctx(M))
        await mds.fs.mount()
        addr = await mds.start()
        cl = await C.CephFSClient(await ioctx(C), addr).mount()
        replies = []
        for op, path, path2, flags in OPS:
            try:
                r = await cl._request(op, path, path2=path2, flags=flags)
                replies.append([op, int(r.result), bytes(r.payload),
                                int(r.cap_mode), int(r.cap_seq)])
            except C.FSError as e:
                replies.append([op, e.errno, str(e)])
        await cl.unmount()
        await mds.stop()
        return replies
    finally:
        for r in rados:
            await r.shutdown()
        await c.stop()


@pytest.mark.parametrize("mds_pkg,client_pkg", [("ref", "port"),
                                                ("port", "ref")])
def test_requests_and_replies_across_packages(mds_pkg, client_pkg):
    """An MDS of one package and a client of the other: ``MClientSession``,
    each ``MClientRequest`` of ``OPS`` and the ``MClientReply`` it gets
    are the reference pair's, field for field."""
    got = run(_exchange(mds_pkg, client_pkg))
    assert got == run(_exchange("ref", "ref"))
    assert [r[1] for r in got][:2] == [0, -17]
