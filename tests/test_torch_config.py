"""The port's utilities of the mon tier, held against ceph_tpu's.

The config registry (``utils/config.py``): the port's ``OPTIONS`` equal
the reference's option by option (name, type, default, help, bounds,
``enum_allowed``, runtime flag), and a seeded script of ``Config.set`` /
``get`` / ``rm`` calls and of ``apply_mon_config`` gives equal results,
errors included. The admin socket answers alike, the crash hook posts
equal reports through each package's ``MCrashReport``, ``KeyedLocks``
serializes alike, ``MgrReporter`` sends only to an active mgr, and
``OpTracker`` / ``Tracer`` take their defaults from the registry as the
reference's do.

Tolerance: exact. Values, errors, wire bytes and orders are equal.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json

import numpy as np
import pytest

import ceph_tpu.mgr.client as ref_mgrc
import ceph_tpu.mon.messages as ref_monmsg
import ceph_tpu.utils.admin_socket as ref_asok
import ceph_tpu.utils.config as ref_config
import ceph_tpu.utils.crash as ref_crash
import ceph_tpu.utils.locks as ref_locks
import ceph_tpu.utils.op_tracker as ref_op_tracker
import ceph_tpu.utils.perf_counters as ref_perf
import ceph_tpu.utils.tracing as ref_tracing
import ceph_tpu_torch.mgr.client as port_mgrc
import ceph_tpu_torch.mon.messages as port_monmsg
import ceph_tpu_torch.utils.admin_socket as port_asok
import ceph_tpu_torch.utils.config as port_config
import ceph_tpu_torch.utils.crash as port_crash
import ceph_tpu_torch.utils.locks as port_locks
import ceph_tpu_torch.utils.op_tracker as port_op_tracker
import ceph_tpu_torch.utils.perf_counters as port_perf
import ceph_tpu_torch.utils.tracing as port_tracing
from ceph_tpu.mon.mgr_monitor import MgrMap as RefMgrMap
from ceph_tpu_torch.mon.mgr_monitor import MgrMap as PortMgrMap

PKGS = {"ref": (ref_config, ref_asok, ref_crash, ref_locks, ref_monmsg,
                ref_perf, ref_mgrc, RefMgrMap),
        "port": (port_config, port_asok, port_crash, port_locks,
                 port_monmsg, port_perf, port_mgrc, PortMgrMap)}


def run(coro):
    return asyncio.run(coro)


# -- the registry -------------------------------------------------------------

# the one help text the port words apart: the reference's names the
# change that folded the RecoveryThrottle in
RETOLD = {"osd_qos_recovery_reservation"}


def test_options_equal_the_reference_option_by_option():
    assert list(port_config.OPTIONS) == list(ref_config.OPTIONS)
    for name, ref in ref_config.OPTIONS.items():
        port, want = (dataclasses.asdict(port_config.OPTIONS[name]),
                      dataclasses.asdict(ref))
        if name in RETOLD:
            assert port.pop("doc") != want.pop("doc"), name
        assert port == want, name
    assert port_config.LAYERS == ref_config.LAYERS
    # the names the ported modules read stay registered
    for name in ("osd_crush_mesh", "devmon_expected_engine",
                 "mon_election_timeout", "mon_lease", "mon_config_strict",
                 "osd_op_history_size", "osd_op_complaint_time"):
        assert name in port_config.OPTIONS


def _draw_value(rng, opt):
    """A raw value for ``opt``: valid, out of bounds, off its enum, or
    not of its type at all."""
    pick = int(rng.integers(0, 5))
    if pick == 0:
        return "not-a-value"
    if opt.enum_allowed:
        return opt.enum_allowed[int(rng.integers(0, len(
            opt.enum_allowed)))] if pick < 4 else "nope"
    if opt.type is bool:
        return ["true", "false", "1", "0", True][pick]
    if opt.type in (int, float):
        base = opt.default if opt.default is not None else 0
        return [base, str(base), (opt.min - 1) if opt.min is not None
                else -7, (opt.max + 1) if opt.max is not None else 1e9,
                "3"][pick]
    return f"v{pick}"


def _script(seed: int, n: int):
    rng = np.random.default_rng(seed)
    names = sorted(ref_config.OPTIONS)
    steps = []
    for _ in range(n):
        name = names[int(rng.integers(0, len(names)))]
        if rng.random() < 0.05:
            name = "no_such_option"
        op = ("set", "get", "rm")[int(rng.integers(0, 3))]
        layer = ref_config.LAYERS[int(rng.integers(0, len(
            ref_config.LAYERS)))]
        if rng.random() < 0.03:
            layer = "bogus"
        opt = ref_config.OPTIONS.get(name)
        value = _draw_value(rng, opt) if opt is not None else "x"
        steps.append((op, name, layer, value))
    return steps


def _play(cfg_mod, steps):
    cfg = cfg_mod.Config()
    seen = []
    cfg.add_observer(lambda n, v: seen.append((n, v)))
    out = []
    for op, name, layer, value in steps:
        try:
            if op == "set":
                cfg.set(name, value, layer=layer)
                got = cfg.get(name)
            elif op == "get":
                got = cfg.get(name)
            else:
                cfg.rm(name, layer)
                got = cfg.get(name)
            out.append(("ok", got))
        except Exception as e:           # noqa: BLE001 - compared below
            out.append((type(e).__name__, str(e)))
    return out, seen, cfg.show()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_seeded_set_get_rm_script_gives_equal_results(seed):
    steps = _script(seed, 400)
    assert _play(port_config, steps) == _play(ref_config, steps)


def _cfgmaps(seed: int, n: int):
    rng = np.random.default_rng(seed)
    names = ["osd_op_history_size", "osd_op_complaint_time",
             "mon_lease", "debug_default_level", "osd_crush_mesh",
             "devmon_expected_engine", "not_registered", "mgr_stats_period"]
    names = [n for n in names if n in ref_config.OPTIONS or
             n == "not_registered"]
    maps = []
    for _ in range(n):
        cfgmap = {}
        for who in ("global", "osd", "osd.3", "mon", "mon.a"):
            if rng.random() < 0.5:
                continue
            ent = {}
            for name in rng.choice(names, 3, replace=False):
                opt = ref_config.OPTIONS.get(str(name))
                ent[str(name)] = str(_draw_value(rng, opt)) \
                    if opt is not None else "raw"
            cfgmap[who] = ent
        maps.append(cfgmap)
    return maps


@pytest.mark.parametrize("entity", ["osd.3", "mon.a", "client.x"])
@pytest.mark.parametrize("mirror_global", [False, True])
def test_apply_mon_config_gives_equal_results(entity, mirror_global,
                                              monkeypatch):
    maps = _cfgmaps(7, 40)
    got = {}
    for key, (cfg_mod, *_rest) in PKGS.items():
        # a process config of each package's own for this test
        monkeypatch.setattr(cfg_mod, "_global", None)
        live = {"osd_op_history_size": 5, "mon_lease": 1.0}
        state: dict = {}
        trace = []
        for cfgmap in maps:
            changed = cfg_mod.apply_mon_config(entity, cfgmap, live, state,
                                               mirror_global=mirror_global)
            trace.append((sorted(changed), dict(live)))
        shown = cfg_mod.global_config().show() if mirror_global else None
        got[key] = (trace, shown)
    assert got["port"] == got["ref"]


# -- the admin socket ---------------------------------------------------------

@pytest.mark.parametrize("command", ["help", "perf dump",
                                     "perf histogram dump", "config show",
                                     "no such command"])
def test_admin_socket_answers_alike(command, tmp_path):
    async def ask(key):
        cfg_mod, asok_mod, _c, _l, _m, perf_mod, *_ = PKGS[key]
        name = f"asok_cmp_{key}"
        pc = (perf_mod.PerfCountersBuilder(name)
              .add_u64_counter("ops", "ops served")
              .add_time_avg("lat", "op latency")
              .add_histogram("size", "op sizes")
              .create_perf_counters())
        pc.inc("ops", 3)
        pc.avg_add("lat", 0.25)
        for v in (1, 3, 900, 70000):
            pc.hist_add("size", v)
        sock = asok_mod.AdminSocket(str(tmp_path / f"{key}.asok"))
        sock.register("config show", lambda: cfg_mod.Config().show(),
                      "the registry's values")
        await sock.start()
        try:
            out = await asok_mod.daemon_command(sock.path, command)
        finally:
            await sock.stop()
            perf_mod.PerfCountersCollection.instance().remove(pc)
        if command == "perf dump":
            return out[name]
        if command == "perf histogram dump":
            return out[name]
        if command == "no such command":
            return out["error"]
        return out
    assert run(ask("port")) == run(ask("ref"))


# -- crash --------------------------------------------------------------------

class _MonC:
    def __init__(self):
        self.sent = []

    async def send_report(self, msg) -> bool:
        self.sent.append(msg)
        return True


def test_crash_hook_posts_equal_reports():
    async def crash(key):
        crash_mod, msgs = PKGS[key][2], PKGS[key][4]
        monc = _MonC()

        async def boom():
            raise ValueError("disk on fire")

        async def calm():
            await asyncio.sleep(0)

        crash_mod.watch(asyncio.ensure_future(boom()), "osd.7", monc,
                        where="hb_loop")
        crash_mod.watch(asyncio.ensure_future(calm()), "osd.7", monc)
        cancelled = crash_mod.watch(
            asyncio.ensure_future(asyncio.sleep(10)), "osd.7", monc)
        await asyncio.sleep(0.01)
        cancelled.cancel()
        await asyncio.sleep(0.01)
        assert len(monc.sent) == 1
        m = monc.sent[0]
        assert isinstance(m, msgs.MCrashReport)
        rep = crash_mod.recent_crashes()[-1]
        assert m.crash_id == rep["crash_id"] and rep["where"] == "hb_loop"
        # the id and the stamp are a clock's; the rest of the bytes equal
        m.crash_id, m.stamp = "fixed", 1.5
        return m.encode(), rep["exception"], \
            rep["traceback"].splitlines()[-1]
    assert run(crash("port")) == run(crash("ref"))


def test_crash_report_bounds_match():
    assert (port_crash.MAX_TRACEBACK, port_crash.MAX_EXCEPTION) == \
        (ref_crash.MAX_TRACEBACK, ref_crash.MAX_EXCEPTION)
    exc = RuntimeError("x" * 1000)
    for key in PKGS:
        rep = PKGS[key][2].build_report("mon.a", exc, where="w" * 300)
        assert len(rep["exception"]) == 400 and len(rep["where"]) == 120


# -- locks --------------------------------------------------------------------

def test_keyed_locks_serialize_alike():
    async def trace(key):
        locks = PKGS[key][3].KeyedLocks()
        order = []

        async def worker(i, k):
            async with locks.hold(k):
                order.append(("in", i, k))
                for _ in range(i % 3):       # yields, not timers: the
                    await asyncio.sleep(0)   # order is the scheduler's
                order.append(("out", i, k))
        await asyncio.gather(*[worker(i, i % 2) for i in range(8)])
        return order, dict(locks._locks), dict(locks._users)
    port, ref = run(trace("port")), run(trace("ref"))
    assert port == ref
    order = port[0]
    for k in (0, 1):
        ev = [e for e in order if e[2] == k]
        assert all(ev[j][0] == "in" and ev[j + 1][0] == "out" and
                   ev[j][1] == ev[j + 1][1] for j in range(0, len(ev), 2))


# -- the mgr report session ---------------------------------------------------

class _Msgr:
    def __init__(self):
        self.sent = []

    async def send_message(self, msg, addr, peer):
        self.sent.append((type(msg).__name__, addr.host, addr.port, peer,
                          msg.daemon, msg))


def test_mgr_reporter_sends_only_to_an_active_mgr():
    async def session(key):
        perf_mod, mgrc, MgrMap = PKGS[key][5], PKGS[key][6], PKGS[key][7]
        pc = (perf_mod.PerfCountersBuilder(f"mgrc_cmp_{key}")
              .add_u64_counter("commits", "commits")
              .create_perf_counters(register=False))
        msgr = _Msgr()
        mm = {"map": None}
        rep = mgrc.MgrReporter("mon.a", msgr, lambda: mm["map"],
                               lambda: [pc], {})
        shipped = [await rep.report_once()]
        mm["map"] = MgrMap()                      # no active mgr yet
        shipped.append(await rep.report_once())
        active = MgrMap()
        active.epoch, active.active_gid = 2, 41
        active.active_name, active.active_addr = "x", ("127.0.0.1", 7000)
        mm["map"] = active
        shipped.append(await rep.report_once())
        pc.inc("commits", 2)
        shipped.append(await rep.report_once())
        shipped.append(await rep.report_once())
        out = []
        for name, host, port, peer, daemon, m in msgr.sent:
            body = None
            if name == "MMgrReport":
                v = json.loads(m.values)
                body = (json.loads(m.schema) if m.schema else None,
                        v["counters"])
            out.append((name, host, port, peer, daemon, body))
        return shipped, out, rep.dump()["sessions_opened"]
    port, ref = run(session("port")), run(session("ref"))
    # the counters' logger names differ by package; the rest is equal
    assert json.dumps(port).replace("_port", "") == \
        json.dumps(ref).replace("_ref", "")
    assert port[0] == [False, False, True, True, True]
    assert [o[0] for o in port[1]] == ["MMgrOpen", "MMgrReport",
                                       "MMgrReport", "MMgrReport"]


# -- defaults read from the registry -----------------------------------------

def test_op_tracker_and_tracer_defaults_equal_the_reference():
    port_t, ref_t = port_op_tracker.OpTracker(), ref_op_tracker.OpTracker()
    assert port_t.history.maxlen == ref_t.history.maxlen == \
        port_config.OPTIONS["osd_op_history_size"].default
    assert port_t.slow_op_warn_s == ref_t.slow_op_warn_s == \
        port_config.OPTIONS["osd_op_complaint_time"].default
    port_tr, ref_tr = port_tracing.Tracer("osd.0"), ref_tracing.Tracer("osd.0")
    names = [n for n in ref_config.OPTIONS if n.startswith(
        ("trace_", "osd_trace", "tracing"))]
    assert names
    for name in names:
        assert port_tr._get(name, "fallback") == \
            ref_tr._get(name, "fallback") == \
            port_config.OPTIONS[name].default, name


def test_op_tracker_follows_a_registry_override(monkeypatch):
    for cfg_mod, tracker_mod in ((port_config, port_op_tracker),
                                 (ref_config, ref_op_tracker)):
        monkeypatch.setattr(cfg_mod, "_global", None)
        cfg_mod.global_config().set("osd_op_history_size", 7)
        assert tracker_mod.OpTracker().history.maxlen == 7
