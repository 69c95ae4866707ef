"""The port's mgr (``ceph_tpu_torch/mgr``) and its balancer's
``OSDMap.calc_pg_upmaps(inc=)`` on the CPU, and side by side with
``ceph_tpu``'s.

- tests/test_balancer.py's cases (less the three marked slow) on the
  port's ``OSDMap`` (``device="cpu"``);
- ``calc_pg_upmaps(inc=)`` on seeded maps, one map given to both
  packages (the reference's bytes decoded by the port): the recorded
  ``new_pg_upmap_items`` pair for pair and in order, the
  ``old_pg_upmap_items`` in order, the change count and the map's final
  upmap table equal the reference's; with the mgr's tracked table
  attached too, and no lookup afterwards serves a row from before the
  mutation;
- the balancer's cycle, a reference fault the port repairs (ROADMAP
  Queue C): on a seeded map with upmaps piled onto one OSD the port
  makes no revert that raises the spread and records each PG once, and
  on ``chip_smoke.py``'s ``rbd_path`` map the port's passes go quiet
  where the reference's change upmaps at every pass;
- crush-compat: the encoded crush map the balancer pushes equals the
  reference's, byte for byte;
- the ``DaemonStateIndex`` units and the CLI/schema cases of
  tests/test_telemetry.py;
- tests/test_tuner.py's cases but the storm, which drives the Thrasher
  and is in ``test_torch_storm_tuner.py``;
- tests/test_mgr_scrub_tools.py's balancer, prometheus and autoscaler
  cases on a port ``Cluster(device="cpu")``;
- prometheus's ``render()`` text equal to the reference's for one
  status and one set of reported daemons;
- a three-mon in-process cluster with two mgrs: ``mgr fail``, the
  standby's takeover, and its first balancer pass commits nothing;
- a port mgr under a reference mon and the reverse: active, the OSDs'
  report sessions open with it, its balancer and prometheus run.

Tolerance: exact pairs, bytes and text.
"""

import asyncio
import json

import numpy as np
import pytest

from ceph_tpu_torch.bench import osdmaptool
from ceph_tpu_torch.cluster.vstart import Cluster as _PortCluster
from ceph_tpu_torch.crush.types import ITEM_NONE
from ceph_tpu_torch.mgr import BalancerModule, PGAutoscalerModule, \
    PrometheusModule
from ceph_tpu_torch.mgr.client import schema_entries
from ceph_tpu_torch.mgr.daemon_state import ALLOWED_TYPES, DaemonStateIndex
from ceph_tpu_torch.mgr.tuner import Guardrails, Proposal, TunerModule
from ceph_tpu_torch.mon.tune import TuneState, tuner_lease_filter
from ceph_tpu_torch.utils.perf_counters import PerfCountersBuilder


def run(coro):
    asyncio.run(coro)


def Cluster(*args, **kwargs):
    """The port's in-process cluster on the CPU."""
    return _PortCluster(*args, device="cpu", **kwargs)


def deviation_stats(m, pool_id=1):
    util = m.pool_utilization(pool_id).astype(np.float64)
    inmask = np.asarray(m.osd_weight) > 0
    tgt = util[inmask].sum() / max(inmask.sum(), 1)
    return util, np.abs(util[inmask] - tgt).max()


def fd_of(m, osd, fd_type):
    parents = m._crush_parents()
    return m._failure_domain_of(parents, osd, fd_type)


# -- tests/test_balancer.py on the port --------------------------------------

def test_upmaps_respect_failure_domain_and_validity():
    m = osdmaptool.create_simple(48, 512, 3, erasure=False, device="cpu")
    m.calc_pg_upmaps(max_deviation=3, max_iterations=300)
    assert len(m.pg_upmap_items) > 0
    up, _, _, _ = m.map_pool(1)
    # no duplicate osds, full sets, distinct hosts per PG
    for row in up:
        vals = row[row != ITEM_NONE]
        assert len(vals) == 3
        assert len(set(vals.tolist())) == 3
        hosts = {fd_of(m, int(o), osdmaptool.builder.TYPE_HOST)
                 for o in vals}
        assert len(hosts) == 3


def test_heterogeneous_weights_respected():
    """2x-weight OSDs legitimately hold ~2x PGs; the balancer's
    target must account for that instead of stripping them."""
    from ceph_tpu_torch.crush import builder
    from ceph_tpu_torch.crush.types import WEIGHT_ONE, CrushMap
    from ceph_tpu_torch.osd.osdmap import OSDMap
    from ceph_tpu_torch.osd.types import PGPool

    crush = CrushMap(type_names=dict(builder.DEFAULT_TYPE_NAMES))
    n = 24
    crush.max_devices = n
    hosts = []
    for hi, lo in enumerate(range(0, n, 4)):
        osds = list(range(lo, lo + 4))
        w = [2 * WEIGHT_ONE if hi < 3 else WEIGHT_ONE] * 4
        hosts.append(builder.make_bucket(
            crush, builder.TYPE_HOST, osds, w, name=f"host{hi}"))
    root = builder.make_bucket(crush, builder.TYPE_ROOT, hosts,
                               name="root")
    rule = builder.add_simple_rule(crush, root, builder.TYPE_HOST)
    m = OSDMap(crush, device="cpu")
    m.add_pool(PGPool(id=1, pg_num=1024, size=3, type=1,
                      crush_rule=rule))
    changes = m.calc_pg_upmaps(max_deviation=5, max_iterations=300)
    util = m.pool_utilization(1).astype(np.float64)
    heavy = util[:12].mean()
    light = util[12:].mean()
    # 2x-weight OSDs must retain roughly 2x load after balancing
    assert heavy / light > 1.5, (heavy, light, changes)


def test_incremental_records_changes():
    from ceph_tpu_torch.osd.osdmap import Incremental
    m = osdmaptool.create_simple(32, 512, 3, erasure=False, device="cpu")
    inc = Incremental(epoch=m.epoch + 1)
    changes = m.calc_pg_upmaps(max_deviation=3, max_iterations=100,
                               inc=inc)
    assert changes > 0
    # a PG touched twice collapses into one entry; the recorded state
    # must equal the map's final upmap state for every touched PG
    assert changes >= len(inc.new_pg_upmap_items) + \
        len(inc.old_pg_upmap_items)
    for pg, pairs in m.pg_upmap_items.items():
        assert inc.new_pg_upmap_items.get(pg) == pairs
    for pg in inc.old_pg_upmap_items:
        assert pg not in m.pg_upmap_items


def test_osdmaptool_upmap_flag(capsys):
    osdmaptool.main(["--device", "cpu", "--createsimple", "32",
                     "--pg-num", "256", "--upmap", "--format", "json"])
    import json
    out = json.loads(capsys.readouterr().out)
    assert "upmap" in out
    assert out["upmap"]["after"]["max_deviation"] <= \
        out["upmap"]["before"]["max_deviation"]


def _continuous_map(n=16):
    from ceph_tpu_torch.crush import builder
    from ceph_tpu_torch.crush.types import WEIGHT_ONE, ChooseArg
    # 8 osds per host: a continuous set gives 8 distinct weights
    # per bucket vector, well past the kernel's 4-class budget
    m = osdmaptool.create_simple(n, 64, 3, erasure=False,
                                 osds_per_host=8, device="cpu")
    crush = m.crush
    args = {}
    for bid, b in crush.buckets.items():
        if not any(0 <= it < n for it in b.items):
            continue
        # every item its own weight: the continuous shape an
        # unconstrained balancer emits
        args[bid] = ChooseArg(weight_set=[[
            WEIGHT_ONE + 137 * i for i in range(len(b.items))]])
    crush.choose_args[-1] = args
    return m


def test_quantize_reduces_classes_and_preserves_zero():
    from ceph_tpu_torch.crush import builder
    from ceph_tpu_torch.crush.types import ChooseArg, CrushMap
    m = CrushMap()
    ws = [100, 200, 300, 400, 500, 600, 700, 800, 0, -1]
    m.choose_args[-1] = {-2: ChooseArg(weight_set=[list(ws)])}
    assert builder.choose_args_weight_classes(m) == 8
    worst = builder.quantize_choose_args(m, max_classes=4)
    assert worst <= 4
    got = m.choose_args[-1][-2].weight_set[0]
    assert got[8] == 0 and got[9] == -1   # drained items stay out
    assert len({w for w in got if w > 0}) <= 4
    # quantization is weight-preserving in aggregate (means)
    assert abs(sum(got[:8]) - sum(ws[:8])) < 8 * 50


def test_quantize_noop_when_already_quantized():
    from ceph_tpu_torch.crush import builder
    from ceph_tpu_torch.crush.types import ChooseArg, CrushMap
    m = CrushMap()
    ws = [100, 100, 200, 200]
    m.choose_args[0] = {-2: ChooseArg(weight_set=[list(ws)])}
    assert builder.quantize_choose_args(m) == 2
    assert m.choose_args[0][-2].weight_set[0] == ws


def test_health_warns_on_continuous_choose_args():
    from types import SimpleNamespace
    from ceph_tpu_torch.crush import builder
    from ceph_tpu_torch.mon.service import HealthMonitor
    m = _continuous_map()
    fake_osdmon = SimpleNamespace(
        osdmap=m, pg_summary=lambda: {}, osd_slow_ops={})
    fake_mon = SimpleNamespace(
        quorum=[0], monmap=SimpleNamespace(ranks=lambda: [0]),
        osdmon=fake_osdmon, store=None)
    checks = HealthMonitor(fake_mon).checks()
    assert "CRUSH_CHOOSE_ARGS_CONTINUOUS" in checks["checks"]
    # quantized: the warning clears
    builder.quantize_choose_args(m.crush)
    checks = HealthMonitor(fake_mon).checks()
    assert "CRUSH_CHOOSE_ARGS_CONTINUOUS" not in checks["checks"]


def test_balancer_crush_compat_emits_quantized():
    """The mgr balancer's crush-compat mode must emit weight-sets
    already inside the kernel's class budget — the quantization
    discipline enforced at the source."""
    import asyncio
    from types import SimpleNamespace
    from ceph_tpu_torch.crush import builder
    from ceph_tpu_torch.encoding import decode_crush_map
    from ceph_tpu_torch.mgr.modules import BalancerModule

    m = osdmaptool.create_simple(24, 512, 3, erasure=False, device="cpu")
    pushed = {}

    class FakeBalancer(BalancerModule):
        def __init__(self):
            self.mgr = None
            self.mode = "crush-compat"

        async def get(self, what):
            assert what == "osd_map"
            return m

        async def mon_command(self, cmd, inbl=b""):
            pushed["cmd"] = cmd
            pushed["crush"] = decode_crush_map(inbl)
            return 0, "", b""

    changes = asyncio.run(FakeBalancer().optimize_weight_set())
    assert changes > 0
    assert pushed["cmd"]["prefix"] == "osd setcrushmap"
    crush = pushed["crush"]
    assert -1 in crush.choose_args       # the compat weight-set
    assert builder.choose_args_weight_classes(crush) <= \
        builder.KERNEL_WEIGHT_CLASSES


# -- tests/test_telemetry.py units on the port ----------------------------

def _schema(*entries):
    return [{"logger": lg, "counter": ct, "type": ty,
             "monotonic": mono, "doc": ""}
            for lg, ct, ty, mono in entries]


def test_rate_query_exact_derivative():
    """The acceptance-pinned contract: a monotonic counter reported at
    known (t, v) pairs yields exactly (v1-v0)/(t1-t0) over the ring,
    and the windowed variant uses the oldest sample INSIDE the
    window."""
    idx = DaemonStateIndex(retention=8)
    sch = _schema(("osd.0", "ops", "u64", True))
    idx.report("osd.0", 1, sch, 10.0, {"osd.0": {"ops": 100}})
    idx.report("osd.0", 1, None, 12.0, {"osd.0": {"ops": 150}})
    idx.report("osd.0", 1, None, 14.0, {"osd.0": {"ops": 260}})
    # whole ring: (260 - 100) / (14 - 10)
    assert idx.rate("osd.0", "osd.0", "ops") == pytest.approx(40.0)
    # window covering only the last span: (260 - 150) / (14 - 12)
    assert idx.rate("osd.0", "osd.0", "ops",
                    window_s=2.0) == pytest.approx(55.0)
    # unchanged counter still samples: rate decays toward 0
    idx.report("osd.0", 1, None, 18.0, {})
    assert idx.rate("osd.0", "osd.0", "ops",
                    window_s=4.0) == pytest.approx(0.0)
    # ring is bounded by retention
    st = idx.daemons["osd.0"]
    for i in range(20):
        idx.report("osd.0", 1, None, 20.0 + i,
                   {"osd.0": {"ops": 300 + i}})
    assert len(st.series[("osd.0", "ops")]) == 8
    # non-monotonic / unknown counters have no series
    assert idx.rate("osd.0", "osd.0", "nope") is None


def test_session_seq_discipline_and_schema_first():
    """A newer session_seq RESETS state (failover re-open / fresh
    incarnation); an older one is a zombie and is dropped; a
    schema-less report for an unknown daemon is dropped (the sender
    re-opens with schema next period); a schema-carrying report is
    self-sufficient."""
    idx = DaemonStateIndex()
    sch = _schema(("osd.1", "ops", "u64", True))
    # schema-less report for an unknown daemon: dropped
    assert not idx.report("osd.1", 1, None, 1.0,
                          {"osd.1": {"ops": 5}})
    assert "osd.1" not in idx.daemons
    # schema-carrying report is self-sufficient (lost/raced open)
    assert idx.report("osd.1", 1, sch, 1.0, {"osd.1": {"ops": 5}})
    assert idx.daemons["osd.1"].latest[("osd.1", "ops")] == 5
    # zombie incarnation (older seq): dropped, state intact
    assert not idx.report("osd.1", 0, sch, 2.0,
                          {"osd.1": {"ops": 999}})
    assert idx.daemons["osd.1"].latest[("osd.1", "ops")] == 5
    # newer seq resets: old counters must not survive the reset
    idx.daemons["osd.1"].latest[("osd.1", "retired")] = 42
    assert idx.report("osd.1", 2, sch, 3.0, {"osd.1": {"ops": 7}})
    st = idx.daemons["osd.1"]
    assert ("osd.1", "retired") not in st.latest
    assert st.latest[("osd.1", "ops")] == 7
    # values without a schema entry are dropped (typeless guessing
    # is exactly what the schema-first discipline forbids)
    idx.report("osd.1", 2, None, 4.0, {"osd.1": {"mystery": 1}})
    assert ("osd.1", "mystery") not in st.latest
    # schema entries naming unregistered types are dropped
    n = st.apply_schema(_schema(("osd.1", "bad", "florp", True)))
    assert n == 0 and ("osd.1", "bad") not in st.schema


def test_histogram_percentile_and_avg_reads():
    idx = DaemonStateIndex()
    sch = _schema(("osd.2", "lat_hist", "hist", False),
                  ("osd.2", "commit_latency", "avg", False))
    buckets = [0] * 64
    # 90 values in bucket 3 (<=8), 10 in bucket 10 (<=1024)
    buckets[3], buckets[10] = 90, 10
    idx.report("osd.2", 1, sch, 1.0, {"osd.2": {
        "lat_hist": {"count": 100, "sum": 5000.0,
                     "log2_buckets": buckets},
        "commit_latency": {"avgcount": 4, "sum": 2.0}}})
    st = idx.daemons["osd.2"]
    assert st.percentile("osd.2", "lat_hist", 0.5) == 8.0
    assert st.percentile("osd.2", "lat_hist", 0.99) == 1024.0
    assert st.avg_value("osd.2", "commit_latency") == \
        pytest.approx(0.5)
    assert st.percentile("osd.2", "commit_latency", 0.5) is None


def test_cull_ttl_drops_silent_daemons():
    idx = DaemonStateIndex()
    sch = _schema(("osd.3", "ops", "u64", True))
    idx.report("osd.3", 1, sch, 1.0, {})
    idx.daemons["osd.3"].last_report -= 100.0      # long silent
    idx.report("osd.4", 1, _schema(("osd.4", "ops", "u64", True)),
               1.0, {})
    assert idx.cull(stale_s=10.0) == ["osd.3"]
    assert sorted(idx.daemons) == ["osd.4"]


def test_ceph_cli_telemetry_verbs_parse():
    """`ceph osd perf` / `progress ls|json` / `mgr dump|stat|fail`
    parse to their mon command prefixes (read-only cap class pinned
    in mon/auth_monitor.py's READONLY_COMMANDS)."""
    from ceph_tpu_torch.bench.ceph_cli import _parse_command
    from ceph_tpu_torch.mon.auth_monitor import READONLY_COMMANDS
    for words, prefix in [
            (["osd", "perf"], "osd perf"),
            (["progress", "ls"], "progress ls"),
            (["progress", "json"], "progress json"),
            (["mgr", "dump"], "mgr dump"),
            (["mgr", "stat"], "mgr stat")]:
        cmd, _ = _parse_command(words)
        assert cmd["prefix"] == prefix
        assert prefix in READONLY_COMMANDS, (
            f"{prefix} must be readable with read-only caps")
    cmd, _ = _parse_command(["mgr", "fail"])
    assert cmd["prefix"] == "mgr fail"
    assert "mgr fail" not in READONLY_COMMANDS   # it mutates the map


def test_schema_entries_match_perf_counters_types():
    """Every schema entry shipped for a full-typed PerfCounters names
    a type the DaemonStateIndex accepts (the live half of the
    test_meta AST guard)."""
    pc = (PerfCountersBuilder("guard.0")
          .add_u64_counter("mono", "guard")
          .add_u64("gauge", "guard")
          .add_time("elapsed", "guard")
          .add_time_avg("avg", "guard")
          .add_histogram("hist", "guard")
          .create_perf_counters(register=False))
    entries = schema_entries([pc])
    assert len(entries) == 5
    assert all(e["type"] in ALLOWED_TYPES for e in entries)
    st = DaemonStateIndex().open("guard.0", 1)
    assert st.apply_schema(entries) == 5


# -- tests/test_tuner.py on the port ----------------------------------------

def _p(policy="pol", key="affinity:1", kind="act"):
    return Proposal(policy, key, kind,
                    {"prefix": "osd primary-affinity", "id": 1,
                     "weight": 0.0},
                    {"osd": 1}, f"{kind} {key}")


# -- guardrail algebra (virtual ticks) -------------------------------------

def test_guardrails_hysteresis_and_flap():
    """act needs N CONSECUTIVE breaching ticks; a flapping sensor
    (breach every other tick) never accumulates a streak and commits
    nothing."""
    g = Guardrails({"mgr_tuner_act_ticks": 3})
    assert g.filter([_p()]) == ([], [])            # tick 1
    assert g.filter([_p()]) == ([], [])            # tick 2
    granted, deferred = g.filter([_p()])           # tick 3
    assert len(granted) == 1 and not deferred
    # flap: present on odd ticks only -> streak resets each gap
    g2 = Guardrails({"mgr_tuner_act_ticks": 2})
    for _ in range(6):
        assert g2.filter([_p()]) == ([], [])
        assert g2.filter([]) == ([], [])           # clean tick resets
    assert g2.streaks == {}


def test_guardrails_revert_threshold_is_separate():
    """reverts wait out their own (longer) clean-streak threshold."""
    g = Guardrails({"mgr_tuner_act_ticks": 1, "mgr_tuner_revert_ticks": 3})
    r = _p(kind="revert")
    assert g.filter([r]) == ([], [])
    assert g.filter([r]) == ([], [])
    granted, _ = g.filter([r])
    assert [p.kind for p in granted] == ["revert"]


def test_guardrails_budget_defers_not_drops():
    """Three eligible changes against a budget of 2: two granted, one
    DEFERRED — and the deferred one keeps its streak, so it is granted
    on the very next tick (not dropped, not restarted)."""
    g = Guardrails({"mgr_tuner_act_ticks": 1,
                    "mgr_tuner_max_changes_per_tick": 2})
    props = [_p(key=f"affinity:{i}") for i in range(3)]
    granted, deferred = g.filter(props)
    assert [p.key for p in granted] == ["affinity:0", "affinity:1"]
    assert [p.key for p in deferred] == ["affinity:2"]
    assert g.deferred_total == 1
    granted2, deferred2 = g.filter([props[2]])
    assert [p.key for p in granted2] == ["affinity:2"] and not deferred2


def test_guardrails_settle_restarts_streak():
    """settle() after an apply restarts the ident's streak — in
    observe mode this is the audit-ring anti-spam (one record per
    hysteresis window, not one per tick)."""
    g = Guardrails({"mgr_tuner_act_ticks": 2})
    g.filter([_p()])
    granted, _ = g.filter([_p()])
    assert granted
    g.settle(granted[0])
    assert g.filter([_p()]) == ([], [])            # streak restarted


# -- the single-writer lease filter ----------------------------------------

def test_lease_filter_defers_both_directions():
    """An OSD under an active tuner affinity lease is the TUNER's to
    dampen AND to heal — the mon sweep's candidates are filtered in
    both directions; expired leases and profile keys don't count."""
    owned = {"affinity:2": {"since": 100.0},
             "affinity:5": {"since": 0.0},          # expired
             "profile:client.x": {"since": 100.0}}
    damp, heal, deferred = tuner_lease_filter(
        [1, 2], [2, 5], owned, now=110.0, lease_s=60.0)
    assert damp == [1]
    assert heal == [5]                              # lease expired
    assert deferred == [2]
    # no leases -> pass-through
    assert tuner_lease_filter([1], [2], {}, 0.0, 60.0) == \
        ([1], [2], [])


# -- TuneState: ownership + bounded audit ----------------------------------

def test_tune_state_ownership_lifecycle():
    ts = TuneState({})
    prov = {"policy": "gray_osd_responder", "mode": "drive",
            "action": "act", "sensors": {"osd": 2}}
    ts.record_commit({"prefix": "osd primary-affinity", "id": 2,
                      "weight": 0.0}, prov)
    assert "affinity:2" in ts.owned
    assert ts.committed == 1
    # the revert half releases
    ts.record_commit({"prefix": "osd primary-affinity", "id": 2,
                      "weight": 1.0},
                     {**prov, "action": "revert"})
    assert "affinity:2" not in ts.owned and ts.reverted == 1
    # profile set acquires, operator rm releases (the operator wins)
    ts.record_commit({"prefix": "osd client-profile", "op": "set",
                      "entity": "client.h", "reservation": 0.0,
                      "weight": 0.5, "limit": 40.0},
                     {"policy": "hot_pool_protector",
                      "action": "act"})
    assert "profile:client.h" in ts.owned
    ts.record_operator({"prefix": "osd client-profile", "op": "rm",
                        "entity": "client.h"})
    assert ts.owned == {}
    # config set carries no per-target ownership
    assert TuneState.target_key({"prefix": "config set",
                                 "name": "osd_recovery_max_active"}) \
        is None
    # observations never touch ownership
    ts.record_observation({"policy": "p", "action": "act",
                           "sensors": {}, "cmd": {}})
    assert ts.owned == {} and ts.observed == 1
    assert ts.log()[-1]["committed"] is False


def test_tune_state_audit_bounded_and_status_shape():
    ts = TuneState({"mon_tune_audit_max": 8})
    for i in range(30):
        ts.record_observation({"policy": "p", "action": "act",
                               "sensors": {"i": i}, "cmd": {}})
    assert len(ts.audit) == 8
    assert ts.log(3)[-1]["sensors"] == {"i": 29}    # newest last
    assert len(ts.log(3)) == 3
    st = ts.status("observe")
    assert st["mode"] == "observe" and st["audit_max"] == 8
    assert st["audit_entries"] == 8 and st["observed"] == 30
    ts.record_commit({"prefix": "osd primary-affinity", "id": 1,
                      "weight": 0.0}, {"policy": "x", "action": "act"})
    st = ts.status("drive")
    assert "affinity:1" in st["owned"]
    assert "cmd" not in st["owned"]["affinity:1"]   # status stays small
    assert json.loads(json.dumps(st)) == st          # JSON-clean


# -- read-only cap class + CLI spellings -----------------------------------

def test_tune_command_cap_class_and_cli_parse():
    """`tune status`/`tune log` are mon-r reads; `tune record` mutates
    the audit ring and must stay behind mon w. The CLI spells all
    three views."""
    from ceph_tpu_torch.bench.ceph_cli import parse_command
    from ceph_tpu_torch.mon.auth_monitor import READONLY_COMMANDS
    assert "tune status" in READONLY_COMMANDS
    assert "tune log" in READONLY_COMMANDS
    assert "tune record" not in READONLY_COMMANDS
    assert parse_command(["tune", "status"])[0] == \
        {"prefix": "tune status"}
    assert parse_command(["tune", "log"])[0] == {"prefix": "tune log"}
    assert parse_command(["tune", "log", "5"])[0] == \
        {"prefix": "tune log", "num": 5}


# -- policy convergence against a scripted world ---------------------------

class _World:
    """The tuner-relevant slice of a mon: canned status/pg_dump/
    osd_dump, and a command endpoint that applies actuator commands
    to that state the way the real routing does — backed by a REAL
    TuneState, so ownership/audit semantics are the shipped ones."""

    def __init__(self, **cfg):
        self.config = {
            "mgr_tuner_mode": "drive",
            "mgr_tuner_act_ticks": 2,
            "mgr_tuner_revert_ticks": 2,
            "mgr_tuner_hot_pool_min_ops": 1.0,
            "mgr_tuner_hot_pool_ratio": 2.0,
            **cfg}
        self.tune = TuneState(self.config)
        self.commands: list[dict] = []
        self.status = {"osdmap": {"slow_osds": {}},
                       "pgmap": {"backfilling_pgs": 0,
                                 "degraded_pgs": 0}}
        self.pg_dump = {"pg_stats": {}}
        self.osd_dump = {
            "osds": [{"osd": i, "primary_affinity": 1.0}
                     for i in range(3)],
            "client_profiles": {}}
        self.degraded: dict = {}

    async def command(self, cmd: dict, inbl: bytes = b""):
        self.commands.append(dict(cmd))
        prefix = cmd.get("prefix")
        if prefix == "tune status":
            mode = str(self.config.get("mgr_tuner_mode", "observe"))
            return 0, "", json.dumps(
                self.tune.status(mode)).encode()
        if prefix == "tune record":
            self.tune.record_observation(cmd["entry"])
            return 0, "", b""
        if prefix == "device-runtime status":
            return 0, "", json.dumps(
                {"daemons": {}, "degraded": self.degraded}).encode()
        if prefix == "osd primary-affinity":
            for o in self.osd_dump["osds"]:
                if o["osd"] == int(cmd["id"]):
                    o["primary_affinity"] = float(cmd["weight"])
        elif prefix == "osd client-profile":
            profs = self.osd_dump["client_profiles"]
            if cmd["op"] == "set":
                profs[cmd["entity"]] = [cmd["reservation"],
                                        cmd["weight"], cmd["limit"]]
            elif cmd["op"] == "rm":
                profs.pop(cmd["entity"], None)
        elif prefix == "config set":
            self.config[cmd["name"]] = cmd["value"]
        else:
            return -22, f"unknown {prefix}", b""
        prov = cmd.get("provenance")
        if prov is not None:
            self.tune.record_commit(cmd, prov)
        else:
            self.tune.record_operator(cmd)
        return 0, "", b""

    def actuations(self, prefix: str) -> list[dict]:
        return [c for c in self.commands
                if c.get("prefix") == prefix]


class _StubMgr:
    def __init__(self, world):
        self.config = world.config
        self.monc = world                    # .command()
        self.modules: list = []
        self.daemon_state = None
        self._world = world

    async def get(self, what: str):
        return {"status": self._world.status,
                "pg_dump": self._world.pg_dump,
                "osd_dump": self._world.osd_dump}[what]


def _tuner(world) -> TunerModule:
    mgr = _StubMgr(world)
    t = TunerModule(mgr)
    mgr.modules = [t]
    return t


async def _ticks(t: TunerModule, n: int) -> None:
    for _ in range(n):
        await t.tick()
        await asyncio.sleep(0.002)     # real dt for the rate sensor


def test_observe_mode_commits_nothing():
    """A sustained breach in observe mode issues ONLY reads and
    `tune record` — no actuator command, no map change — and the
    settle discipline keeps it to one record per hysteresis window,
    not one per tick."""
    async def go():
        w = _World(mgr_tuner_mode="observe")
        w.status["osdmap"]["slow_osds"] = {"2": 4.0}
        await _ticks(_tuner(w), 5)
        assert not w.actuations("osd primary-affinity")
        assert not w.actuations("config set")
        assert w.osd_dump["osds"][2]["primary_affinity"] == 1.0
        assert w.tune.owned == {}
        # act_ticks=2 over 5 ticks -> records at ticks 2 and 4 only
        assert w.tune.observed == 2
        entry = w.tune.log()[-1]
        assert entry["committed"] is False
        assert entry["policy"] == "gray_osd_responder"
        assert entry["sensors"]["osd"] == 2
    run(go())


def test_gray_osd_drive_act_then_level_holds_then_revert():
    """Drive mode: a confirmed-slow OSD is dampened after act_ticks,
    further ticks propose NOTHING (desired == actual — the level-based
    no-double-commit property), and the heal reverts after
    revert_ticks with both halves in the audit."""
    async def go():
        w = _World()
        w.status["osdmap"]["slow_osds"] = {"2": 4.0}
        t = _tuner(w)
        await _ticks(t, 2)
        assert w.osd_dump["osds"][2]["primary_affinity"] == 0.0
        assert w.tune.committed == 1 and t.actions_committed == 1
        assert "affinity:2" in w.tune.owned
        assert w.tune.owned["affinity:2"]["policy"] == \
            "gray_osd_responder"
        await _ticks(t, 3)                 # held: no re-commit
        assert len(w.actuations("osd primary-affinity")) == 1
        w.status["osdmap"]["slow_osds"] = {}
        await _ticks(t, 2)
        assert w.osd_dump["osds"][2]["primary_affinity"] == 1.0
        assert w.tune.reverted == 1 and t.actions_reverted == 1
        assert w.tune.owned == {}
        acts = [(e["action"], e["committed"]) for e in w.tune.log()]
        assert acts == [("act", True), ("revert", True)]
    run(go())


def test_promoted_standby_resumes_without_double_commit():
    """The failover shape without a cluster: a FRESH TunerModule (the
    promoted standby — empty streaks, no rate baseline) against the
    same mon state sees desired == actual for the in-flight action and
    commits nothing; when the OSD heals, the new instance owns the
    revert because ownership lives mon-side."""
    async def go():
        w = _World()
        w.status["osdmap"]["slow_osds"] = {"1": 5.0}
        await _ticks(_tuner(w), 2)         # incarnation A commits
        assert w.tune.committed == 1
        t_b = _tuner(w)                    # incarnation B, clean RAM
        await _ticks(t_b, 4)
        assert w.tune.committed == 1       # no double-commit
        assert len(w.actuations("osd primary-affinity")) == 1
        w.status["osdmap"]["slow_osds"] = {}
        await _ticks(t_b, 2)
        assert w.tune.reverted == 1 and w.tune.owned == {}
        assert w.osd_dump["osds"][1]["primary_affinity"] == 1.0
    run(go())


def test_operator_wins_and_tuner_stands_down():
    """An operator (provenance-less) command on a tuner-held target
    releases the lease; the tuner then has nothing to revert and
    issues no further actuator commands."""
    async def go():
        w = _World()
        w.status["osdmap"]["slow_osds"] = {"2": 4.0}
        t = _tuner(w)
        await _ticks(t, 2)
        assert "affinity:2" in w.tune.owned
        # the operator undoes it by hand (no provenance)
        await w.command({"prefix": "osd primary-affinity", "id": 2,
                         "weight": 1.0})
        assert w.tune.owned == {}
        w.status["osdmap"]["slow_osds"] = {}
        n_before = len(w.actuations("osd primary-affinity"))
        await _ticks(t, 4)
        assert len(w.actuations("osd primary-affinity")) == n_before
    run(go())


def test_hot_pool_protector_trip_and_heal():
    """Per-pool op rates from pg-stats client_ops deltas: a pool
    starving another gets its aggressor entity a tightened profile
    (reservation 0, bounded limit); when the burst ends the owned
    profile is removed."""
    async def go():
        w = _World()
        hot, cold = [100], [10]
        w.pg_dump["pg_stats"] = {
            "1.0": {"client_ops": {"client.hot": hot[0]}},
            "2.0": {"client_ops": {"client.cold": cold[0]}}}

        def bump():
            hot[0] += 200
            cold[0] += 2
            w.pg_dump["pg_stats"]["1.0"]["client_ops"] = \
                {"client.hot": hot[0]}
            w.pg_dump["pg_stats"]["2.0"]["client_ops"] = \
                {"client.cold": cold[0]}
        t = _tuner(w)
        await _ticks(t, 1)                 # baseline tick: no rates
        assert not w.actuations("osd client-profile")
        for _ in range(3):
            bump()
            await _ticks(t, 1)
        profs = w.osd_dump["client_profiles"]
        assert "client.hot" in profs
        res, weight, limit = profs["client.hot"]
        assert res == 0.0 and limit > 0.0
        assert "profile:client.hot" in w.tune.owned
        entry = next(e for e in w.tune.log()
                     if e["policy"] == "hot_pool_protector")
        assert entry["sensors"]["entity"] == "client.hot"
        assert entry["sensors"]["hot_pool"] == 1
        assert entry["sensors"]["hot_pool_rate"] > 0
        # heal: counters stop moving -> rates decay to zero
        await _ticks(t, 3)
        assert w.osd_dump["client_profiles"] == {}
        assert w.tune.owned == {} and w.tune.reverted == 1
    run(go())


def test_kernel_watchdog_acts_on_permanent_only():
    """Only a PERMANENTLY degraded kernel path (quarantine gave up)
    loses primary eligibility; transient backoff phases never
    actuate. The heal reverts through the same affinity path."""
    async def go():
        w = _World()
        w.degraded = {"1": {"ratio": 0.8, "engine": "pallas",
                            "phase": "backoff", "since": 0.0}}
        t = _tuner(w)
        await _ticks(t, 3)
        assert not w.actuations("osd primary-affinity")
        w.degraded["1"]["phase"] = "permanent"
        await _ticks(t, 2)
        assert w.osd_dump["osds"][1]["primary_affinity"] == 0.0
        assert w.tune.owned["affinity:1"]["policy"] == \
            "kernel_path_watchdog"
        entry = w.tune.log()[-1]
        assert entry["sensors"]["mismatch_ratio"] == 0.8
        assert entry["sensors"]["engine"] == "pallas"
        w.degraded = {}
        await _ticks(t, 2)
        assert w.osd_dump["osds"][1]["primary_affinity"] == 1.0
        assert w.tune.owned == {}
    run(go())


def test_shared_affinity_key_single_writer_per_tick():
    """An OSD both confirmed-slow AND permanently degraded: the two
    policies share the affinity actuator, and the per-tick dedupe
    keeps ONE writer (the responder) — one commit, one owner."""
    async def go():
        w = _World()
        w.status["osdmap"]["slow_osds"] = {"1": 6.0}
        w.degraded = {"1": {"ratio": 0.9, "engine": "pallas",
                            "phase": "permanent", "since": 0.0}}
        t = _tuner(w)
        await _ticks(t, 3)
        cmds = w.actuations("osd primary-affinity")
        assert len(cmds) == 1
        assert w.tune.owned["affinity:1"]["policy"] == \
            "gray_osd_responder"
        # heal BOTH sensors -> a single revert
        w.status["osdmap"]["slow_osds"] = {}
        w.degraded = {}
        await _ticks(t, 2)
        assert len(w.actuations("osd primary-affinity")) == 2
        assert w.tune.owned == {}
    run(go())


def test_change_budget_spreads_commits_across_ticks():
    """Three OSDs go slow at once against a budget of 2: the third
    commit lands one tick later (deferred, not dropped)."""
    async def go():
        w = _World(mgr_tuner_max_changes_per_tick=2)
        w.status["osdmap"]["slow_osds"] = {"0": 4.0, "1": 4.0,
                                           "2": 4.0}
        t = _tuner(w)
        await _ticks(t, 2)
        assert w.tune.committed == 2
        assert t.guardrails.deferred_total >= 1
        await _ticks(t, 1)
        assert w.tune.committed == 3
        affinity = {o["osd"]: o["primary_affinity"]
                    for o in w.osd_dump["osds"]}
        assert affinity == {0: 0.0, 1: 0.0, 2: 0.0}
    run(go())


def test_recovery_governor_levels():
    """The governor's level table, policy-direct (no tick loop):
    QoS-floor breach halves, backfill-with-headroom doubles toward
    the cap, drained backfill reverts to the registered default, and
    the steady state proposes nothing."""
    from ceph_tpu_torch.utils.config import OPTIONS
    base = OPTIONS["osd_recovery_max_active"].default
    w = _World()
    t = _tuner(w)

    def gov(p99, bf, cur):
        w.config["osd_recovery_max_active"] = cur
        return t._recovery_governor(
            {"p99_ms": p99, "backfilling_pgs": bf})
    # breach: shed NOW, even below base
    props = gov(5000.0, 3, base)
    assert props[0].kind == "act"
    assert props[0].cmd["value"] == str(base // 2)
    # headroom + pending backfill: double
    props = gov(10.0, 2, base)
    assert props[0].cmd["value"] == str(base * 2)
    # capped
    w.config["mgr_tuner_recovery_max_active_cap"] = base * 2
    assert gov(10.0, 2, base * 2) == []
    # drained: revert to the registered default
    props = gov(None, 0, base * 4)
    assert props[0].kind == "revert"
    assert props[0].cmd["value"] == str(base)
    # steady: nothing
    assert gov(None, 0, base) == []
    # floor breach at 1 can't go lower
    assert gov(5000.0, 1, 1) == []


def test_tuner_progress_events_pair():
    """A drive-mode act renders a held ``tuner:<key>`` event in the
    ProgressModule's table; the revert completes it into the
    `progress json` ring."""
    async def go():
        from ceph_tpu_torch.mgr.modules import ProgressModule
        w = _World()
        w.status["osdmap"]["slow_osds"] = {"2": 4.0}
        t = _tuner(w)
        prog = ProgressModule(t.mgr)
        t.mgr.modules.append(prog)
        await _ticks(t, 2)
        ev = prog.events.get("tuner:affinity:2")
        assert ev is not None and ev["fraction"] == 0.5
        assert "[gray_osd_responder]" in ev["message"]
        # the progress module's own derivation must not sweep the
        # foreign tuner event
        prog._derive(w.status, w.pg_dump, 1.0)
        assert "tuner:affinity:2" in prog.events
        w.status["osdmap"]["slow_osds"] = {}
        await _ticks(t, 2)
        assert "tuner:affinity:2" not in prog.events
        assert any(e["id"] == "tuner:affinity:2"
                   for e in prog.completed)
    run(go())


# -- tests/test_mgr_scrub_tools.py mgr cases on the port --------------------

def test_mgr_balancer_and_prometheus():
    async def go():
        c = await Cluster(
            n_mons=1, n_osds=4,
            mgr_modules=[BalancerModule, PrometheusModule],
            config={"upmap_max_deviation": 1,
                    "mgr_balancer_interval": 0.5,
                    "mgr_prometheus_interval": 0.3}).start()
        try:
            await c.client.pool_create("b", pg_num=32, size=3)
            await c.wait_for_clean(timeout=120)
            io = await c.client.open_ioctx("b")
            await io.write_full("x", b"1")
            # balancer: run one explicit optimize round; any upmaps it
            # generated must be accepted by the mon and visible in the
            # map
            bal = next(m for m in c.mgr.modules
                       if isinstance(m, BalancerModule))
            applied = await bal.optimize()
            ret, _, out = await c.client.mon_command(
                {"prefix": "osd dump"})
            dump = json.loads(out)
            assert len(dump["pg_upmap_items"]) >= applied * 0 + \
                (1 if applied else 0)
            # prometheus: scrape the real HTTP endpoint
            prom = next(m for m in c.mgr.modules
                        if isinstance(m, PrometheusModule))
            deadline = asyncio.get_event_loop().time() + 15
            while prom.port is None:
                assert asyncio.get_event_loop().time() < deadline
                await asyncio.sleep(0.1)
            await asyncio.sleep(0.5)      # one render tick
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", prom.port)
            writer.write(b"GET /metrics HTTP/1.1\r\n"
                         b"Host: localhost\r\n\r\n")
            await writer.drain()
            body = await asyncio.wait_for(reader.read(65536),
                                          timeout=5.0)
            writer.close()
            text = body.decode()
            assert "ceph_osd_up 4" in text
            assert "ceph_health_status" in text
            assert "ceph_pg_total" in text
        finally:
            await c.stop()
    run(go())


def test_mgr_pg_autoscaler_grows_empty_pool():
    async def go():
        c = await Cluster(
            n_mons=1, n_osds=3,
            mgr_modules=[PGAutoscalerModule],
            config={"mgr_pg_autoscaler_interval": 0.3,
                    "mon_target_pg_per_osd": 32,
                    "autoscaler_max_pg_num": 16}).start()
        try:
            await c.client.pool_create("tiny", pg_num=1, size=3)
            deadline = asyncio.get_event_loop().time() + 30
            while True:
                ret, _, out = await c.client.mon_command(
                    {"prefix": "osd pool ls"})
                pool = next(p for p in json.loads(out)
                            if p["name"] == "tiny")
                if pool["pg_num"] > 1:
                    break
                assert asyncio.get_event_loop().time() < deadline, \
                    "autoscaler never grew the pool"
                await asyncio.sleep(0.2)
            assert pool["pg_num"] in (8, 16)     # pow2 target
        finally:
            await c.stop()
    run(go())


# -- calc_pg_upmaps(inc=) against the reference ------------------------------

def _seeded_maps(case: str, seed: int):
    """One map in both packages: the reference builds and encodes it,
    the port decodes the bytes. ``case`` picks the pool and what the
    seed perturbs (reweights, upmaps feeding one OSD: 24 in ``revert``,
    16 in ``upmapped``)."""
    from ceph_tpu.bench import osdmaptool as ref_tool
    from ceph_tpu.encoding import encode_osdmap as ref_encode
    from ceph_tpu.osd.types import pg_t as ref_pg_t
    from ceph_tpu_torch.encoding import decode_osdmap
    rng = np.random.default_rng(seed)
    if case == "erasure":
        ref = ref_tool.create_simple(24, 128, 5, erasure=True)
    else:
        ref = ref_tool.create_simple(32, 256, 3, erasure=False)
    if case == "reweighted":
        for o in rng.choice(32, 6, replace=False):
            ref.osd_weight[int(o)] = int(rng.integers(0x4000, 0xC000))
        ref._dirty()
    if case in ("revert", "upmapped"):
        up, _, _, _ = ref.map_pool(1)
        parents = ref._crush_parents()
        host0 = ref._failure_domain_of(parents, 0, ref_tool.builder.TYPE_HOST)
        for s in rng.permutation(256):
            row = [int(o) for o in up[int(s)]]
            if 0 in row:
                continue
            if host0 in {ref._failure_domain_of(parents, o,
                                                ref_tool.builder.TYPE_HOST)
                         for o in row[1:]}:
                continue
            ref.pg_upmap_items[ref_pg_t(1, int(s))] = [(row[0], 0)]
            if len(ref.pg_upmap_items) == (24 if case == "revert" else 16):
                break
        ref._dirty()
    return ref, decode_osdmap(ref_encode(ref), device="cpu")


def _recorded(m, inc, changes):
    def pairs(p):
        return [(int(a), int(b)) for a, b in p]
    return {"changes": changes,
            "new": [(pg.pool, pg.seed, pairs(p))
                    for pg, p in inc.new_pg_upmap_items.items()],
            "old": [(pg.pool, pg.seed) for pg in inc.old_pg_upmap_items],
            "map": sorted((pg.pool, pg.seed, pairs(p))
                          for pg, p in m.pg_upmap_items.items())}


@pytest.mark.parametrize("case,seed", [("replicated", 1), ("reweighted", 2),
                                       ("erasure", 4), ("upmapped", 4)])
@pytest.mark.parametrize("tracked", [False, True])
def test_calc_pg_upmaps_records_the_references_incremental(case, seed,
                                                           tracked):
    from ceph_tpu.osd.osdmap import Incremental as RefIncremental
    from ceph_tpu_torch.osd.osdmap import Incremental
    from ceph_tpu_torch.osd.osdmap_mapping import OSDMapMapping
    ref, port = _seeded_maps(case, seed)
    if tracked:
        # as Mgr.get("osd_map") leaves it: the table built and attached
        table = OSDMapMapping()
        table.update(port)
        port.attach_mapping(table)
    ref_inc = RefIncremental(epoch=ref.epoch + 1)
    inc = Incremental(epoch=port.epoch + 1)
    want = _recorded(ref, ref_inc, ref.calc_pg_upmaps(
        max_deviation=1, max_iterations=40, inc=ref_inc))
    got = _recorded(port, inc, port.calc_pg_upmaps(
        max_deviation=1, max_iterations=40, inc=inc))
    assert want["changes"] > 0
    if case == "upmapped":
        # the pass reverts upmaps it found, each lowering the spread:
        # the revert branch, where both packages agree
        assert want["old"]
    assert got == want
    # every placement mutation bumped the epoch: no lookup serves a row
    # from before it, bulk or scalar
    seeds = np.arange(port.pools[1].pg_num, dtype=np.uint32)
    fresh = [np.asarray(t) for t in ref.pg_to_up_acting_osds(1, seeds)]
    after = [np.asarray(t) for t in port.pg_to_up_acting_osds(1, seeds)]
    for a, b in zip(after, fresh):
        assert np.array_equal(a, b)
    for s in (0, 17, 101):
        up, _, _, _ = port.pg_to_up_acting_osds(1, np.asarray([s]))
        assert np.array_equal(np.asarray(up)[0], fresh[0][s])


def _spread(m) -> float:
    """The sum of squared deviations of every OSD's PG shards from its
    weighted share (what a balancer pass must lower)."""
    counts = np.zeros(m.max_osd, dtype=np.float64)
    for pid in m.pools:
        up, _, _, _ = m.map_pool(pid)
        up = np.asarray(up)
        np.add.at(counts, up[(up != ITEM_NONE) & (up >= 0)], 1)
    w = np.asarray(m.osd_weight, dtype=np.float64)
    target = w / w.sum() * counts.sum()
    return float(((counts - target)[w > 0] ** 2).sum())


def _items(m) -> dict:
    return {(pg.pool, pg.seed): [(int(a), int(b)) for a, b in p]
            for pg, p in m.pg_upmap_items.items()}


def _as_balancer_applies(items: dict, inc) -> dict:
    """The upmap table the balancer leaves from ``items``: each recorded
    entry set (`osd pg-upmap-items`), then each removal (`osd
    rm-pg-upmap-items`)."""
    items = dict(items)
    for pg, pairs in inc.new_pg_upmap_items.items():
        items[(pg.pool, pg.seed)] = [(int(a), int(b)) for a, b in pairs]
    for pg in inc.old_pg_upmap_items:
        items.pop((pg.pool, pg.seed), None)
    return items


@pytest.mark.parametrize("tracked", [False, True])
def test_a_revert_that_raises_the_spread_is_not_made(tracked):
    """Reference fault, repaired in the port (ROADMAP Queue C): the
    reference reverts an upmap feeding the most-full OSD even when that
    raises the spread, and records a PG it both removed and set again in
    both lists of the Incremental, which the balancer applies set, then
    removed. On the seeded map with 24 upmaps piled onto osd.0, the
    port's pass lowers the spread at least as far as the reference's,
    and its Incremental, applied as the balancer applies it, gives the
    table the pass computed; the reference's does not."""
    from ceph_tpu.osd.osdmap import Incremental as RefIncremental
    from ceph_tpu_torch.osd.osdmap import Incremental
    from ceph_tpu_torch.osd.osdmap_mapping import OSDMapMapping
    ref, port = _seeded_maps("revert", 3)
    if tracked:
        table = OSDMapMapping()
        table.update(port)
        port.attach_mapping(table)
    ref_before, before = _items(ref), _items(port)
    ref_inc = RefIncremental(epoch=ref.epoch + 1)
    inc = Incremental(epoch=port.epoch + 1)
    ref.calc_pg_upmaps(max_deviation=1, max_iterations=40, inc=ref_inc)
    assert port.calc_pg_upmaps(max_deviation=1, max_iterations=40,
                               inc=inc) > 0
    assert _spread(port) <= _spread(ref)
    assert not set(inc.new_pg_upmap_items) & set(inc.old_pg_upmap_items)
    assert _as_balancer_applies(before, inc) == _items(port)
    assert set(ref_inc.new_pg_upmap_items) & \
        set(ref_inc.old_pg_upmap_items)
    assert _as_balancer_applies(ref_before, ref_inc) != _items(ref)


async def _cell_map() -> bytes:
    """The osdmap of chip_smoke.py's ``rbd_path`` deployment as the
    port's mon commits it: twelve hosts of one OSD, a k=8 m=3 pool of 32
    PGs under the mon's ``indep`` host rule, a replicated pool of 128."""
    from ceph_tpu_torch.encoding import encode_osdmap
    c = await Cluster(n_mons=1, n_osds=0).start()
    try:
        cl = c.client
        for i in range(12):
            for cmd in ({"prefix": "osd new"},
                        {"prefix": "osd crush add", "id": i, "weight": 1.0,
                         "host": f"host{i}"}):
                ret, rs, _ = await cl.mon_command(cmd)
                assert ret == 0, rs
        for cmd in ({"prefix": "osd erasure-code-profile set",
                     "name": "rbd_ec",
                     "profile": ["k=8", "m=3", "technique=reed_sol_van",
                                 "crush-failure-domain=host",
                                 "stripe_unit=4096"]},
                    {"prefix": "osd pool create", "pool": "rbd_ec",
                     "pg_num": 32, "pool_type": "erasure",
                     "erasure_code_profile": "rbd_ec"}):
            ret, rs, _ = await cl.mon_command(cmd)
            assert ret == 0, rs
        await cl.pool_create("rbd", pg_num=128, size=3)
        return encode_osdmap(c.leader().osdmon.osdmap)
    finally:
        await c.stop()


def _balancer_passes(blob: bytes, pkg: str, n: int) -> list:
    """``n`` balancer passes over the map ``blob`` with every OSD up and
    in, as the mgr makes them (max deviation 1, 20 changes a pass), each
    committed as the balancer commits it: (changes, spread) a pass."""
    if pkg == "ref":
        from ceph_tpu.encoding import decode_osdmap, encode_osdmap
        from ceph_tpu.osd.osdmap import STATE_UP, Incremental
        from ceph_tpu.osd.types import pg_t
        decode = decode_osdmap
    else:
        from ceph_tpu_torch.encoding import decode_osdmap, encode_osdmap
        from ceph_tpu_torch.osd.osdmap import STATE_UP, Incremental
        from ceph_tpu_torch.osd.types import pg_t

        def decode(b):
            return decode_osdmap(b, device="cpu")
    m = decode(blob)
    # booted and in, as the OSD daemons leave them
    m.osd_state = np.asarray(m.osd_state) | STATE_UP
    m.osd_weight = np.full_like(np.asarray(m.osd_weight), 0x10000)
    m._dirty()
    out = []
    for _ in range(n):
        work = decode(encode_osdmap(m))
        inc = Incremental(epoch=m.epoch + 1)
        changes = work.calc_pg_upmaps(max_deviation=1, max_iterations=20,
                                      inc=inc)
        after = _as_balancer_applies(_items(m), inc)
        m.pg_upmap_items = {pg_t(pool, seed): pairs
                            for (pool, seed), pairs in after.items()}
        m._dirty()
        out.append((changes, _spread(m)))
    return out


def test_the_balancer_settles_where_the_reference_cycles():
    """Reference fault, repaired in the port (ROADMAP Queue C): on the
    ``rbd_path`` deployment's map the reference's balancer changes
    upmaps at every pass and the spread never falls; the port's goes
    quiet within four passes, with a lower spread."""
    blob = asyncio.run(_cell_map())
    ref = _balancer_passes(blob, "ref", 6)
    port = _balancer_passes(blob, "port", 6)
    assert all(c > 0 for c, _ in ref) and ref[-1][1] == ref[2][1]
    quiet = [i for i, (c, _) in enumerate(port) if c == 0]
    assert quiet and quiet[0] <= 3, port
    assert all(c == 0 for c, _ in port[quiet[0]:])
    assert port[-1][1] < ref[-1][1]


def _fake_balancer(cls, m, pushed):
    class FakeBalancer(cls):
        def __init__(self):
            self.mgr = None
            self.mode = "crush-compat"

        async def get(self, what):
            assert what == "osd_map"
            return m

        async def mon_command(self, cmd, inbl=b""):
            pushed.append((cmd, inbl))
            return 0, "", b""
    return FakeBalancer()


def test_crush_compat_pushes_the_references_crush_map():
    from ceph_tpu.bench import osdmaptool as ref_tool
    from ceph_tpu.encoding import encode_osdmap as ref_encode
    from ceph_tpu.mgr.modules import BalancerModule as RefBalancer
    from ceph_tpu_torch.encoding import decode_osdmap
    from ceph_tpu_torch.osd.osdmap_mapping import OSDMapMapping
    ref = ref_tool.create_simple(24, 512, 3, erasure=False)
    port = decode_osdmap(ref_encode(ref), device="cpu")
    table = OSDMapMapping()
    table.update(port)
    port.attach_mapping(table)
    before = port.epoch
    ref_pushed, port_pushed = [], []
    n_ref = asyncio.run(_fake_balancer(RefBalancer, ref,
                                       ref_pushed).optimize_weight_set())
    n_port = asyncio.run(_fake_balancer(BalancerModule, port,
                                        port_pushed).optimize_weight_set())
    assert n_ref > 0 and n_port == n_ref
    assert [c for c, _ in port_pushed] == [c for c, _ in ref_pushed]
    assert [b for _, b in port_pushed] == [b for _, b in ref_pushed]
    # the weight-set went into the map in place: the epoch moved and the
    # table no longer serves; lookups follow the new weights
    assert port.epoch > before and not table.serves(port, 1)
    seeds = np.arange(512, dtype=np.uint32)
    want = ref.pg_to_up_acting_osds(1, seeds)
    got = port.pg_to_up_acting_osds(1, seeds)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))


# -- prometheus render() against the reference --------------------------------

STATUS = {
    "health": {"status": "HEALTH_WARN"},
    "osdmap": {"num_up_osds": 11, "num_in_osds": 12, "num_osds": 12,
               "epoch": 77, "pools": 2, "removed_snaps": 3,
               "pending_merges": {"rbd": {"ready": 2, "sources": 4,
                                          "from": 64, "to": 32}},
               "osd_utilization": {"0": {"used": 10, "capacity": 40},
                                   "1": {"used": 0, "capacity": 0}},
               "pool_quotas": [{"name": "rbd", "quota_bytes": 1 << 30,
                                "quota_objects": 0, "full": 0}],
               "num_nearfull_osds": 1, "num_full_osds": 0,
               "flags": "noout,noscrub", "slow_osds": {"3": 2.5},
               "degraded_kernel_paths": {"4": 0.25}},
    "pgmap": {"num_pgs": 160, "degraded_pgs": 3, "backfilling_pgs": 1,
              "backfill_progress": {"pushed": 9}, "num_objects": 300,
              "num_bytes": 1 << 28,
              "states": {"clean": 156, "active+undersized+degraded": 3,
                         "backfilling": 1}},
    "fsmap": {"states": {"a": "up:active"}, "standby_count": 1,
              "epoch": 4, "max_mds": 1, "actives": {"0": "a"}},
    "monmap": {"num_mons": 3, "epoch": 1},
    "quorum": [0, 1, 2],
    "auth": {"num_keys": 17},
    "mgrmap": {"available": True, "standbys": ["y"], "epoch": 9},
    "progress": {"events": [{"id": "recovery", "fraction": 0.25}]},
}


def _reports(idx_cls, with_devmon: bool):
    idx = idx_cls(retention=8)
    sch = _schema(("osd.0", "op_w", "u64", True),
                  ("osd.0", "op_w_latency_hist", "hist", False),
                  ("osd.0", "commit_latency", "avg", False),
                  ("osd.0", "apply_latency", "avg", False),
                  ("osd_ec_agg", "batches", "u64", True),
                  ("osd_ec_agg", "occupancy", "avg", False))
    if with_devmon:
        sch += _schema(("devmon", "launches_kernel", "u64", True),
                       ("devmon", "path_checks", "u64", True),
                       ("device_runtime", "h2d_bytes", "u64", True))
    buckets = [0] * 16
    buckets[3], buckets[9] = 40, 2
    vals = {"osd.0": {"op_w": 42,
                      "op_w_latency_hist": {"count": 42, "sum": 900.0,
                                            "log2_buckets": buckets},
                      "commit_latency": {"avgcount": 4, "sum": 0.01},
                      "apply_latency": {"avgcount": 4, "sum": 0.002}},
            "osd_ec_agg": {"batches": 5,
                           "occupancy": {"avgcount": 5, "sum": 12.0}},
            "devmon": {"launches_kernel": 7, "path_checks": 3},
            "device_runtime": {"h2d_bytes": 4096}}
    idx.report("osd.0", 1, sch, 1.0, vals)
    return idx


def _render(mod_pkg, idx, monkeypatch):
    class NoSingletons:
        @staticmethod
        def instance():
            return {}
    monkeypatch.setattr(mod_pkg, "PerfCountersCollection", NoSingletons)

    class StubMgr:
        config = {"mgr_stats_singleton_fallback": False,
                  "mgr_stats_stale_s": 1e9}
        daemon_state = idx
        modules = []

        async def get(self, what):
            assert what == "status"
            return json.loads(json.dumps(STATUS))

        def osd_perf_digest(self):
            return {"0": {"commit_latency_ms": 2.5,
                          "apply_latency_ms": 0.5}}
    mgr = StubMgr()
    prom = mod_pkg.PrometheusModule(mgr)
    mgr.modules = [prom]
    return asyncio.run(prom.render())


def test_prometheus_render_equals_the_reference(monkeypatch):
    from ceph_tpu.mgr import daemon_state as ref_ds
    from ceph_tpu.mgr import modules as ref_modules
    from ceph_tpu_torch.mgr import modules as port_modules
    want = _render(ref_modules, _reports(ref_ds.DaemonStateIndex, False),
                   monkeypatch)
    got = _render(port_modules, _reports(DaemonStateIndex, False),
                  monkeypatch)
    assert "ceph_osd_ec_agg_batches" in got and \
        "ceph_osd_commit_latency_ms" in got
    assert got == want
    # the device rows read the port's own launch paths
    dev = _render(port_modules, _reports(DaemonStateIndex, True),
                  monkeypatch)
    assert 'ceph_device_launches_total{ceph_daemon="osd.0",' \
           'path="kernel"} 7' in dev
    assert 'path="vm"} 0' in dev and 'path="pallas"' not in dev
    assert 'ceph_device_h2d_bytes_total{ceph_daemon="osd.0"} 4096' in dev


# -- two mgrs under a three-mon quorum: mgr fail and the takeover ------------

def test_mgr_fail_and_standby_takeover():
    async def go():
        c = await Cluster(
            n_mons=3, n_osds=3, n_mgrs=2,
            mgr_modules=[BalancerModule, PGAutoscalerModule,
                         PrometheusModule],
            config={"mgr_balancer_interval": 0.3,
                    "mgr_prometheus_interval": 0.3,
                    "mon_target_pg_per_osd": 8}).start()
        try:
            first = await c.wait_for_mgr_active(timeout=30)
            assert [m.device.type for m in c.mgrs] == ["cpu", "cpu"]
            await c.client.pool_create("rbd", pg_num=8, size=3)
            await c.wait_for_clean(timeout=120)
            bal = next(m for m in first.modules
                       if isinstance(m, BalancerModule))
            # quiet: the balancer's pass finds nothing more to move
            deadline = asyncio.get_event_loop().time() + 60
            while await bal.optimize() != 0:
                assert asyncio.get_event_loop().time() < deadline
                await asyncio.sleep(0.3)
            ret, rs, _ = await c.client.mon_command({"prefix": "mgr fail"})
            assert ret == 0, rs
            new = await c.wait_for_mgr_active(not_gid=first.gid,
                                              timeout=30)
            assert new.gid != first.gid and new.name != first.name
            nbal = next(m for m in new.modules
                        if isinstance(m, BalancerModule))
            # same map, same answer: the new active commits nothing
            assert await nbal.optimize() == 0
            st = await c.client.status()
            assert st["mgrmap"]["active_name"] == new.name
            prom = next(m for m in new.modules
                        if isinstance(m, PrometheusModule))
            text = await prom.render()
            assert "ceph_osd_up 3" in text
        finally:
            await c.stop()
    run(go())


# -- a mgr of either package against the other's mons ---------------------

def test_mgrs_run_against_the_other_packages_mons():
    """A port ``Mgr`` goes active under a reference mon and a reference
    ``Mgr`` under a port mon: the MgrMap names it, the cluster's OSDs
    open their report sessions with it, its balancer pass and its
    prometheus render run over the other package's maps and status."""
    from ceph_tpu.cluster.vstart import Cluster as RefCluster
    from ceph_tpu.mgr import Mgr as RefMgr
    from ceph_tpu.mgr.modules import BalancerModule as RefBalancer
    from ceph_tpu.mgr.modules import PrometheusModule as RefPrometheus
    from ceph_tpu.mon.monitor import MonMap as RefMonMap
    from ceph_tpu.msg import Keyring as RefKeyring
    from ceph_tpu_torch.mgr import Mgr
    from ceph_tpu_torch.mon.monitor import MonMap
    from ceph_tpu_torch.msg import Keyring

    def copy_monmap(cls, src):
        m = cls(fsid=src.fsid)
        for name, (rank, host, port) in src.mons.items():
            m.add(name, rank, host, port)
        return m

    async def one(cluster, mgr_of, balancer, prometheus):
        c = await cluster.start()
        mgr = None
        try:
            await c.client.pool_create("rbd", pg_num=8, size=3)
            await c.wait_for_clean(timeout=120)
            mgr = mgr_of(c)
            await mgr.start(active=True)
            deadline = asyncio.get_event_loop().time() + 30
            while True:
                st = await c.client.status()
                if st["mgrmap"].get("active_name") == "x" and \
                        any(n.startswith("osd.")
                            for n in mgr.daemon_state.daemons):
                    break
                assert asyncio.get_event_loop().time() < deadline, \
                    (st["mgrmap"], sorted(mgr.daemon_state.daemons))
                await asyncio.sleep(0.2)
            bal = next(m for m in mgr.modules if isinstance(m, balancer))
            await bal.optimize()
            prom = next(m for m in mgr.modules
                        if isinstance(m, prometheus))
            assert "ceph_osd_up 3" in await prom.render()
        finally:
            if mgr is not None:
                await mgr.stop()
            await c.stop()

    run(one(RefCluster(n_mons=1, n_osds=3),
            lambda c: Mgr("x", copy_monmap(MonMap, c.monmap),
                          keyring=Keyring(dict(c.keyring.keys)),
                          modules=[BalancerModule, PrometheusModule],
                          config=c.cfg, device="cpu"),
            BalancerModule, PrometheusModule))
    run(one(Cluster(n_mons=1, n_osds=3),
            lambda c: RefMgr("x", copy_monmap(RefMonMap, c.monmap),
                             keyring=RefKeyring(dict(c.keyring.keys)),
                             modules=[RefBalancer, RefPrometheus],
                             config=c.cfg),
            RefBalancer, RefPrometheus))
