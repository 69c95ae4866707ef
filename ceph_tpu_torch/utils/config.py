"""Layered typed configuration.

Analog of Ceph's option system (ref: src/common/options/*.yaml.in
-> Option structs; src/common/config.h md_config_t/ConfigProxy). Ceph resolves
each option through layered precedence:

    compiled default < conf file < mon config db < env < cli < runtime override

We keep the same precedence semantics with explicit named layers, a typed
``Option`` declaration table, and change-notification observers
(ref: src/common/config_obs.h md_config_obs_t). Option names keep their Ceph
spellings where an analog exists (``erasure_code_dir``,
``osd_pool_default_*``) for operator familiarity.

The port's copy of ``ceph_tpu/utils/config.py``. It registers every
option of the reference with the same name, type, default, help and
bounds, so ``config set`` validates alike in both packages.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

# Layer precedence, low to high (ref: src/common/config.h CONF_DEFAULT..CONF_OVERRIDE).
LAYERS = ("default", "file", "mon", "env", "cmdline", "override")


@dataclass(frozen=True)
class Option:
    """One declared option (ref: src/common/options.h Option)."""

    name: str
    type: type  # int, float, str, bool
    default: Any
    doc: str = ""
    min: Any = None
    max: Any = None
    enum_allowed: tuple = ()
    runtime: bool = True  # may be changed after startup (flags: [runtime])

    def validate(self, value: Any) -> Any:
        if self.type is bool and isinstance(value, str):
            value = value.lower() in ("1", "true", "yes", "on")
        try:
            value = self.type(value)
        except (TypeError, ValueError) as e:
            raise ValueError(f"option {self.name}: cannot coerce {value!r} to "
                             f"{self.type.__name__}") from e
        if self.enum_allowed and value not in self.enum_allowed:
            raise ValueError(f"option {self.name}: {value!r} not in "
                             f"{self.enum_allowed}")
        if self.min is not None and value < self.min:
            raise ValueError(f"option {self.name}: {value!r} < min {self.min}")
        if self.max is not None and value > self.max:
            raise ValueError(f"option {self.name}: {value!r} > max {self.max}")
        return value


# The option schema. Names mirror Ceph's where analogous
# (ref: src/common/options/global.yaml.in, osd.yaml.in).
OPTIONS: dict[str, Option] = {o.name: o for o in [
    Option("erasure_code_dir", str, "",
           "directory for out-of-tree EC plugin shims (dlopen analog)"),
    Option("osd_pool_default_size", int, 3, "replica count", min=1),
    Option("osd_pool_default_min_size", int, 0, "min replicas to serve IO"),
    Option("osd_pool_default_pg_num", int, 32, "default pg_num", min=1),
    Option("osd_pool_default_crush_rule", int, -1, "default crush rule id"),
    Option("osd_pool_default_erasure_code_profile", str,
           "plugin=jax technique=reed_sol_van k=2 m=2",
           "default EC profile"),
    Option("mon_max_pg_per_osd", int, 250, "pg-per-osd health limit"),
    # pg-log / recovery / backfill (ref: osd.yaml.in osd_min_pg_log_entries,
    # osd_max_backfills, osd_recovery_max_active, osd_backfill_scan_*).
    Option("osd_min_pg_log_entries", int, 1000,
           "pg-log entries retained by trim; the log tail this leaves is "
           "the log-delta recovery horizon — peers older than it backfill",
           min=1),
    Option("osd_backfill", bool, True,
           "enable the backfill recovery mode (off reproduces the "
           "silent past-horizon under-replication the seed had)"),
    Option("osd_max_backfills", int, 1,
           "max concurrent backfills one OSD participates in, as "
           "primary (local reservations) or target (remote)", min=1),
    Option("osd_backfill_scan_max", int, 64,
           "objects per backfill scan batch", min=1),
    Option("osd_backfill_retry_interval", float, 0.5,
           "seconds between reservation retries (backfill_wait)"),
    Option("osd_recovery_max_active", int, 8,
           "max in-flight recovery/backfill pushes per OSD", min=1),
    Option("osd_recovery_max_bytes", int, 0,
           "recovery push budget in bytes/s (token bucket; 0 = "
           "unlimited) — deprioritizes recovery vs client I/O", min=0),
    Option("osd_backfill_full_ratio", float, 0.85,
           "refuse incoming backfills above this fraction of "
           "osd_capacity_bytes (backfill_toofull)"),
    Option("osd_capacity_bytes", int, 0,
           "advertised store capacity for fullness checks (0 = "
           "unlimited; the in-memory stores have no intrinsic size)",
           min=0),
    # overload protection (ref: global.yaml.in mon_osd_nearfull_ratio /
    # mon_osd_full_ratio, osd.yaml.in osd_failsafe_full_ratio,
    # osd_client_message_cap / osd_client_message_size_cap): the three
    # fullness lines of defense plus the client-op admission throttle.
    Option("mon_osd_nearfull_ratio", float, 0.85,
           "per-OSD used/capacity ratio raising OSD_NEARFULL health",
           min=0.0, max=1.0),
    Option("mon_osd_full_ratio", float, 0.95,
           "per-OSD ratio setting the cluster FULL flag: client "
           "writes park (or fail -ENOSPC with FULL_TRY)",
           min=0.0, max=1.0),
    Option("osd_failsafe_full_ratio", float, 0.97,
           "local statfs ratio above which the OSD rejects writes "
           "-ENOSPC at admission — the stale-map-proof last line of "
           "defense", min=0.0, max=1.0),
    Option("mon_osd_reporter_lifetime", float, 600.0,
           "seconds a failure reporter's accusation stays live; "
           "older reports expire on mon tick so stale accusations "
           "cannot sum to a markdown", min=0.0),
    Option("osd_pool_default_quota_max_bytes", int, 0,
           "default pool byte quota (0 = unlimited)", min=0),
    Option("osd_pool_default_quota_max_objects", int, 0,
           "default pool object quota (0 = unlimited)", min=0),
    Option("osd_client_message_cap", int, 256,
           "max in-flight client ops dispatched per OSD; excess ops "
           "queue at admission", min=0),
    Option("osd_client_message_size_cap", int, 500 << 20,
           "max aggregate in-flight client-op bytes per OSD", min=0),
    Option("osd_pg_op_queue_cap", int, 512,
           "per-PG op-queue depth past which the primary sends "
           "MOSDBackoff instead of queueing", min=1),
    # op QoS scheduler (round 11; ref: osd.yaml.in osd_op_queue +
    # osd_mclock_scheduler_client/background_* options): the
    # dmClock-analog admission scheduler and its per-class defaults.
    # Read LIVE by every OpScheduler, so a runtime flip applies to the
    # next dequeue decision.
    Option("osd_op_queue", str, "mclock",
           "op admission queue: mclock (dmClock-analog QoS tags) | "
           "fifo (the pre-scheduler baseline)",
           enum_allowed=("mclock", "fifo")),
    Option("osd_qos_default_reservation", float, 0.0,
           "default per-client reservation IOPS (0 = none) for "
           "queues without a client-profile or pool qos_* override",
           min=0.0),
    Option("osd_qos_default_weight", float, 1.0,
           "default per-client proportional weight", min=0.0),
    Option("osd_qos_default_limit", float, 0.0,
           "default per-client limit IOPS (0 = unlimited)", min=0.0),
    Option("osd_qos_recovery_reservation", float, 10.0,
           "recovery-class reservation IOPS — the floor that keeps "
           "recovery from starving under client load (the "
           "RecoveryThrottle folded into the scheduler)", min=0.0),
    Option("osd_qos_recovery_weight", float, 1.0,
           "recovery-class proportional weight", min=0.0),
    Option("osd_qos_recovery_limit", float, 0.0,
           "recovery-class limit IOPS (0 = unlimited)", min=0.0),
    Option("osd_qos_scrub_weight", float, 0.5,
           "scrub-class proportional weight (background best-effort)",
           min=0.0),
    Option("osd_qos_scrub_limit", float, 10.0,
           "scrub-class limit in scrub rounds/s (0 = unlimited)",
           min=0.0),
    Option("osd_qos_cost_per_io_bytes", int, 65536,
           "dmClock cost divisor: an op is charged "
           "max(1, bytes / this) tag units, so a 4 MiB writer pays "
           "its size honestly against 4 KiB writers instead of the "
           "flat per-op cost (doubly important once the EC "
           "aggregator makes many-small-writes cheap to encode)",
           min=1),
    # EC encode aggregator (round 13; the cross-op stripe-batch
    # coalescing layer in osd/ec_aggregator.py). Read LIVE per encode,
    # so osd_ec_agg=false flips a running OSD to the measured per-op
    # baseline path.
    Option("osd_ec_agg", bool, True,
           "coalesce concurrent EC stripe encodes from all PGs on "
           "this OSD into one padded batched kernel launch per flush "
           "window; false = the per-op-launch baseline path"),
    Option("osd_ec_agg_window_us", float, 500.0,
           "EC aggregator flush window in microseconds — the hard "
           "bound on how long a lone op's encode may wait for "
           "company", min=0.0),
    Option("osd_ec_agg_max_stripes", int, 4096,
           "stripes that force an immediate aggregator flush (the "
           "batch-size ceiling; also bounds the padded launch's "
           "memory)", min=1),
    # EC read/repair aggregator (round 19; the decode twin of the
    # round-13 encode aggregator, osd/ec_read_aggregator.py). Read
    # LIVE per decode, so osd_ec_read_agg=false flips a running OSD
    # to the measured per-op decode baseline.
    Option("osd_ec_read_agg", bool, True,
           "coalesce concurrent EC degraded-read / repair decodes "
           "from all PGs on this OSD into one padded batched decode "
           "launch per flush window; false = the per-op-launch "
           "baseline path"),
    Option("osd_ec_read_agg_window_us", float, 500.0,
           "EC read aggregator flush window in microseconds — the "
           "hard bound on how long a lone degraded read's decode may "
           "wait for company", min=0.0),
    Option("osd_ec_read_agg_max_stripes", int, 4096,
           "stripes that force an immediate read-aggregator flush "
           "(the decode batch-size ceiling; also bounds the padded "
           "launch's memory)", min=1),
    # hot-shard residency (round 19): bounded device-side cache of
    # gathered stripe batches so RMW and repeated degraded reads skip
    # the host gather + H2D leg; entries are version-keyed, so any
    # write to the object range makes the cached generation
    # unreachable (plus an explicit invalidate on apply).
    Option("osd_ec_resident_bytes", int, 64 << 20,
           "per-OSD byte budget for the device-resident hot-shard "
           "cache (LRU by PG/object range, version-keyed "
           "invalidation); 0 disables residency", min=0),
    Option("osd_qos_backlog_cap", int, 4096,
           "OSD-wide admission backlog bound across ALL tenants "
           "(per-tenant queues are capped by osd_pg_op_queue_cap; "
           "this bounds their sum so a many-tenant flood backs off "
           "instead of exhausting memory)", min=1),
    # gray-failure (slow-OSD) detection (round 11; ref: the
    # osd_network ping-time warnings mon_warn_on_slow_ping_time
    # gates): the mon's slow-score sweep over heartbeat-RTT reports.
    Option("mon_osd_slow_ratio", float, 3.0,
           "an OSD whose median reported heartbeat RTT exceeds the "
           "fleet median by this factor is slow-suspect", min=1.0),
    Option("mon_osd_slow_min_ms", float, 50.0,
           "absolute latency floor (ms) below which no OSD is ever "
           "marked slow — fast-cluster jitter must not trip OSD_SLOW",
           min=0.0),
    Option("mon_osd_slow_confirm", int, 2,
           "consecutive slow-score sweeps above threshold before "
           "OSD_SLOW trips (debounce)", min=1),
    Option("mon_osd_slow_primary_dampening", bool, False,
           "when an OSD trips OSD_SLOW, auto-dampen its primary "
           "affinity (the primary-avoidance hint); restored on heal. "
           "OFF by default"),
    Option("mon_osd_slow_primary_affinity", float, 0.0,
           "the affinity fraction a dampened slow OSD gets (0 = "
           "never primary while slow)", min=0.0, max=1.0),
    # MDS failover / metadata HA (ref: mds.yaml.in mds_beacon_interval,
    # mds_beacon_grace, mds_reconnect_timeout, mds_standby_replay,
    # mon_mds options in global.yaml.in): the MDSMonitor's beacon-grace
    # failover machinery and the daemon's ladder pacing.
    Option("mds_beacon_interval", float, 1.0,
           "seconds between MDSBeacons to the mon", min=0.01),
    Option("mds_beacon_grace", float, 5.0,
           "silent-daemon window before the MDSMonitor fails it "
           "(an active is blocklisted and a standby promoted)",
           min=0.1),
    Option("mds_reconnect_timeout", float, 2.0,
           "reconnect-window length: how long a promoted MDS waits "
           "for journaled sessions to re-claim their caps before "
           "dropping the stragglers", min=0.0),
    Option("mds_replay_interval", float, 0.25,
           "standby-replay journal/session-table tail poll period",
           min=0.01),
    Option("mds_standby_replay", bool, False,
           "keep one warm standby tailing the active's journal for "
           "faster takeover (costs a continuous poll)"),
    Option("mds_standby_count_wanted", int, 1,
           "standbys below which MDS_INSUFFICIENT_STANDBY warns",
           min=0),
    Option("mds_journal_max_entries", int, 64,
           "applied journal events kept resident before a batch trim "
           "(the segment-trim analog; gives standby-replay a real "
           "tail)", min=1),
    Option("mds_session_timeout", float, 10.0,
           "client cap-lease length advertised at session open",
           min=0.1),
    # snapshots (ref: osd.yaml.in osd_snap_trim_sleep / osd_pg_max_
    # concurrent_snap_trims, bluestore shared-blob machinery, mds
    # snapshot enablement): the snap subsystem's three layers.
    Option("bluestore_sharedblob_enabled", bool, True,
           "OP_CLONE shares the source's blobs (refcounted, zero data "
           "bytes move); false restores the seed's O(size) byte-copy "
           "clone"),
    Option("osd_snap_trim_batch", int, 16,
           "head objects trimmed per burst by the removed_snaps "
           "background trimmer before sleeping", min=1),
    Option("osd_snap_trim_sleep", float, 0.0,
           "seconds the background snap trimmer sleeps between "
           "bursts (0 = no pacing)", min=0.0),
    Option("mds_snap_enabled", bool, True,
           "serve .snap/<name> snapshot verbs (mksnap/rmsnap/readdir "
           "through a realm); false returns -EPERM like upstream's "
           "allow_new_snaps=false"),
    Option("mds_snap_max_per_realm", int, 100,
           "snapshots one directory may hold before mksnap -EMLINK",
           min=1),
    # multi-active metadata plane (round 7; ref: mds_bal_* options +
    # the Migrator's export sizing): the mon-side load rebalancer and
    # the two-phase subtree migration.
    Option("mds_bal_interval", float, 10.0,
           "seconds between rebalancer decisions on the mon tick "
           "(0 disables the load-based subtree rebalancer)", min=0.0),
    Option("mds_bal_ratio", float, 4.0,
           "hottest/coldest rank op-rate ratio past which a subtree "
           "migrates off the hot rank", min=1.0),
    Option("mds_bal_min_ops", float, 20.0,
           "op/s below which a rank is never considered overloaded "
           "(don't shuffle an idle filesystem)", min=0.0),
    Option("mds_migration_timeout", float, 10.0,
           "exporter-side pacing bound for one subtree handoff "
           "attempt", min=0.1),
    # elastic control plane (round 6; ref: mon.yaml.in mon options +
    # the pg_autoscaler module's threshold): runtime monmap
    # membership, AuthMonitor key lifecycle, LogMonitor retention and
    # the PG merge barrier.
    Option("mon_allow_pg_merge", bool, True,
           "accept pg_num decreases (two-phase merge through "
           "pg_num_pending); false reproduces the seed's "
           "grow-only autoscaler"),
    Option("autoscaler_shrink_threshold", int, 4,
           "pg_autoscaler proposes a merge when pg_num exceeds the "
           "recommendation by this factor (the over-split bar)",
           min=2),
    Option("mon_merge_ready_window", float, 2.0,
           "seconds a source PG's ready-to-merge report stays live; "
           "sources re-report every stats tick while ready, so a "
           "degraded source ages out of the barrier", min=0.5),
    Option("mon_log_max", int, 500,
           "cluster-log entries the LogMonitor retains (older are "
           "trimmed with each append)", min=10),
    Option("mon_auth_revoke_warn_s", float, 300.0,
           "seconds a revoked key stays in the AUTH_KEY_REVOKED "
           "health warning (the log keeps the permanent record)",
           min=0.0),
    Option("mon_election_timeout", float, 0.3,
           "election round length before victory/retry"),
    Option("mon_lease", float, 2.0,
           "peon lease length; expiry calls an election"),
    # CRUSH tunables defaults (jewel profile; ref: src/crush/CrushWrapper.h
    # set_tunables_jewel).
    Option("crush_choose_total_tries", int, 50, "descent retry budget"),
    Option("crush_choose_local_tries", int, 0, "local retries (legacy)"),
    Option("crush_choose_local_fallback_tries", int, 0,
           "local fallback retries (legacy)"),
    Option("crush_chooseleaf_descend_once", int, 1, "retry descent not leaf"),
    Option("crush_chooseleaf_vary_r", int, 1, "vary r on leaf recursion"),
    Option("crush_chooseleaf_stable", int, 1, "stable leaf mapping"),
    # op tracking + distributed tracing (ref: osd.yaml.in
    # osd_op_history_size / osd_op_complaint_time; the jaeger_tracing
    # options the reference gates src/common/tracer.cc behind). The
    # trace_* knobs are read live by every Tracer, so a runtime
    # override applies from the next op on.
    Option("osd_op_history_size", int, 20,
           "completed ops retained per OpTracker for "
           "dump_historic_ops", min=0),
    Option("osd_op_complaint_time", float, 30.0,
           "op age (monotonic seconds) past which an in-flight op "
           "counts as slow (SLOW_OPS)", min=0.0),
    Option("trace_sampling_rate", float, 0.0,
           "head-based sampling probability for distributed op "
           "traces: a sampled root's context propagates across every "
           "message hop of the op", min=0.0, max=1.0),
    Option("trace_slow_keep_s", float, 30.0,
           "tail-based retention: an UNSAMPLED op slower than this is "
           "kept anyway (local root span only), so SLOW_OPS stays "
           "drill-downable at sampling 0; <= 0 disables even the "
           "local timing (the fully-off path)"),
    Option("trace_buffer_size", int, 256,
           "completed spans retained per daemon for dump_tracing",
           min=8),
    # cluster telemetry plane (round 12; ref: mgr.yaml.in
    # mgr_stats_period + mon_mgr_beacon_grace): the daemon->mgr
    # perf-counter report sessions, the mgr's time-series retention,
    # and the MgrMap beacon/failover machinery. mgr_stats_period is
    # read LIVE by every reporter, so a runtime override applies from
    # the next period on.
    Option("mgr_stats_period", float, 0.5,
           "seconds between a daemon's MMgrReport value deltas to the "
           "active mgr (0 disables reporting entirely — the bench "
           "section's off leg)", min=0.0),
    Option("mgr_stats_retention", int, 120,
           "report samples retained per monotonic counter in the "
           "mgr's DaemonStateIndex ring (the rate-query window)",
           min=2),
    Option("mgr_stats_schema_refresh", int, 20,
           "reports between periodic schema re-sends — re-seeds a "
           "session the mgr's TTL cull dropped while the daemon's "
           "reports were merely delayed (the one-way-channel analog "
           "of reconnect-resends-schema)", min=1),
    Option("mgr_stats_stale_s", float, 10.0,
           "seconds without a report before a daemon is culled from "
           "the DaemonStateIndex (dead daemons unpin by TTL, not "
           "conn reset — a transparent TCP reconnect must not wipe "
           "live state)", min=0.5),
    Option("mgr_stats_singleton_fallback", bool, True,
           "render /metrics from the process-local "
           "PerfCountersCollection when NO daemon has a report "
           "session (the standalone/no-mgr fallback); false = "
           "reported state only"),
    Option("mgr_beacon_interval", float, 0.5,
           "seconds between MMgrBeacons to the mon", min=0.01),
    Option("mgr_beacon_grace", float, 4.0,
           "silent-mgr window before the MgrMonitor fails it (a "
           "silent active is dropped and a standby promoted in the "
           "same commit)", min=0.1),
    Option("mgr_progress_interval", float, 1.0,
           "ProgressModule tick period (event derivation + the "
           "monward digest)", min=0.05),
    Option("mgr_progress_max_events", int, 64,
           "recently-completed progress events retained for "
           "`ceph progress json`", min=1),
    # self-driving tuner (round 17; mgr/tuner.py TunerModule + the
    # mon's tune audit/ownership pool in mon/tune.py). The mgr_tuner_*
    # knobs are read LIVE every tick, so mode/threshold flips apply
    # to the next evaluation without a mgr restart.
    Option("mgr_tuner_interval", float, 1.0,
           "TunerModule tick period (sensor evaluation + guardrailed "
           "actuation)", min=0.05),
    Option("mgr_tuner_mode", str, "observe",
           "the tuner's mode ladder: 'off' evaluates nothing, "
           "'observe' (the safe default) logs would-be actions to "
           "`ceph tune log` without committing, 'drive' (opt-in) "
           "commits them through the mon command paths",
           enum_allowed=("off", "observe", "drive")),
    Option("mgr_tuner_act_ticks", int, 3,
           "hysteresis: consecutive breaching ticks before a policy's "
           "action becomes eligible (a flapping sensor commits "
           "nothing)", min=1),
    Option("mgr_tuner_revert_ticks", int, 5,
           "hysteresis: consecutive clean ticks before a policy's "
           "revert becomes eligible", min=1),
    Option("mgr_tuner_max_changes_per_tick", int, 2,
           "cluster-wide change budget per tick; eligible proposals "
           "past it DEFER to the next tick (streaks retained) rather "
           "than drop", min=1),
    Option("mgr_tuner_qos_floor_ms", float, 250.0,
           "the client p99 QoS floor (ms) the recovery governor "
           "protects: p99 above it scales recovery down, p99 under "
           "the headroom fraction of it lets pending backfill scale "
           "recovery up", min=1.0),
    Option("mgr_tuner_headroom_frac", float, 0.5,
           "fraction of the QoS floor p99 must stay UNDER to count "
           "as headroom for scaling recovery up", min=0.01, max=1.0),
    Option("mgr_tuner_recovery_max_active_cap", int, 32,
           "ceiling the recovery governor may scale "
           "osd_recovery_max_active up to", min=1),
    Option("mgr_tuner_hot_pool_ratio", float, 4.0,
           "hot-pool protector trip: a pool whose op rate exceeds "
           "this multiple of the busiest OTHER pool's is the "
           "aggressor", min=1.0),
    Option("mgr_tuner_hot_pool_min_ops", float, 50.0,
           "absolute op-rate floor (ops/s) below which no pool can "
           "trip the hot-pool protector (idle-cluster noise "
           "immunity)", min=0.0),
    Option("mgr_tuner_hot_limit_frac", float, 0.5,
           "the tightened client-profile qos_limit as a fraction of "
           "the aggressor's observed op rate", min=0.01, max=1.0),
    Option("mgr_tuner_hot_weight", float, 0.5,
           "the tightened client-profile dmClock weight committed on "
           "an aggressor entity", min=0.01),
    Option("mgr_tuner_affinity", float, 0.0,
           "the dampened primary affinity the gray-OSD responder and "
           "kernel-path watchdog commit (0 = never primary)",
           min=0.0, max=1.0),
    Option("mon_tune_audit_max", int, 256,
           "bounded length of the mon's tuner audit ring "
           "(`ceph tune log`)", min=8),
    Option("mon_tune_affinity_lease_s", float, 600.0,
           "how long a tuner-committed primary-affinity lease defers "
           "the mon's own slow-OSD dampening sweep; expired leases "
           "return the OSD to the sweep", min=1.0),
    # device-runtime observability plane (round 14; the devmon layer
    # in utils/devmon.py + the mon's KERNEL_PATH_DEGRADED sweep).
    # devmon_expected_engine is read LIVE per sweep check, the
    # mon_kernel_path_* knobs live per report.
    Option("devmon_expected_engine", str, "auto",
           "the kernel engine this daemon is EXPECTED to serve CRUSH "
           "sweeps with: 'auto' trusts the built plan (a mismatch "
           "then means a plan silently degraded mid-run); pinning "
           "'pallas' makes every non-kernel sweep a counted — and "
           "health-checked — mismatch (the deployment contract for "
           "production TPU daemons)",
           enum_allowed=("auto", "pallas", "xla", "scalar")),
    Option("mon_kernel_path_degraded_ratio", float, 0.1,
           "per-report mismatch/checks ratio at or above which a "
           "daemon's kernel path counts as degraded for the "
           "KERNEL_PATH_DEGRADED debounce",
           min=0.0, max=1.0),
    Option("mon_kernel_path_confirm", int, 2,
           "consecutive degraded device-health reports before "
           "KERNEL_PATH_DEGRADED trips for a daemon (and clean "
           "reports before it clears) — the OSD_SLOW debounce "
           "discipline", min=1),
    # device-fault resilience plane (round 16): the CRUSH kernel
    # quarantine/re-probe state machine (crush/mapper.py) and the EC
    # aggregator's degrade ladder (osd/ec_aggregator.py). All read
    # LIVE from cluster config — a running cluster can be retuned.
    Option("crush_kernel_reprobe_base", float, 0.5,
           "seconds before the FIRST re-probe after a kernel-path "
           "execution failure quarantines it; doubles per "
           "consecutive failure (capped by crush_kernel_reprobe_max)",
           min=0.0),
    Option("crush_kernel_reprobe_max", float, 30.0,
           "backoff ceiling for kernel quarantine re-probes",
           min=0.0),
    Option("crush_kernel_reprobe_disable_after", int, 5,
           "consecutive kernel failures (initial + failed probes) "
           "after which the quarantine goes PERMANENT — the kernel "
           "path stays retired until the daemon restarts", min=1),
    Option("osd_ec_fallback_retries", int, 1,
           "per-op device encode retries after a failed aggregator "
           "batch before the op is served from the host-only "
           "reference encoder", min=0),
    Option("osd_ec_fallback_quarantine_base", float, 1.0,
           "seconds the fused encode+CRC jit path rests after a "
           "failure before being retried; doubles per consecutive "
           "failure", min=0.0),
    Option("osd_ec_fallback_quarantine_max", float, 30.0,
           "backoff ceiling for the fused encode+CRC rest window",
           min=0.0),
    # mesh provenance (round 15, ROADMAP #1d first slice): where a
    # production daemon's device mesh comes from. Read once at OSD
    # boot — the tracked mapping table re-attaches the mesh on every
    # update, so the knob governs provenance, not per-sweep routing.
    Option("osd_crush_mesh", str, "off",
           "attach a device mesh to this OSD's tracked mapping table "
           "at boot so full-pool CRUSH sweeps run mesh-sharded "
           "without hand-wiring: 'auto' builds the local default "
           "mesh over all visible devices when more than one is "
           "visible (a single device keeps the plain path); 'off' "
           "never attaches one",
           enum_allowed=("off", "auto")),
    # multi-process cluster backend (round 18; cluster/proc.py
    # supervisor + the mon central config db in mon/service.py). The
    # proc_* knobs govern the parent-side supervisor and are read at
    # spawn/stop time; mon_config_strict is read LIVE per `config set`.
    Option("proc_restart_backoff_base", float, 0.3,
           "seconds before the FIRST respawn after a proc-backend "
           "daemon crashes (exits without being asked to stop); "
           "doubles per consecutive crash", min=0.0),
    Option("proc_restart_backoff_max", float, 5.0,
           "backoff ceiling for crash respawns", min=0.0),
    Option("proc_stop_timeout", float, 10.0,
           "seconds a graceful stop (SIGTERM -> stop(mark_down=True)) "
           "may take before the supervisor escalates to SIGKILL",
           min=0.1),
    Option("mon_config_strict", bool, False,
           "when true, `ceph config set` rejects names that are not "
           "registered Options instead of storing them as raw "
           "strings"),
    # TPU execution knobs (no Ceph analog).
    Option("tpu_ec_backend", str, "auto",
           "GF kernel: bitmatmul (MXU) | lut (VPU) | auto",
           enum_allowed=("bitmatmul", "lut", "auto")),
    Option("tpu_block_bytes", int, 1 << 20,
           "per-step chunk-bytes tile for streaming encodes", min=4096),
    Option("tpu_mesh_axes", str, "batch", "mesh axis names, comma-separated"),
    Option("debug_default_level", int, 0, "default log gate level"),
]}


class Config:
    """Layered option store with observer notification."""

    def __init__(self, options: dict[str, Option] | None = None):
        self._options = dict(options or OPTIONS)
        self._layers: dict[str, dict[str, Any]] = {name: {} for name in LAYERS}
        self._observers: list[Callable[[str, Any], None]] = []

    # -- declaration ------------------------------------------------------
    def declare(self, option: Option) -> None:
        self._options[option.name] = option

    # -- resolution -------------------------------------------------------
    def get(self, name: str) -> Any:
        opt = self._options[name]
        for layer in reversed(LAYERS):
            if name in self._layers[layer]:
                return self._layers[layer][name]
        return opt.default

    def __getitem__(self, name: str) -> Any:
        return self.get(name)

    def set(self, name: str, value: Any, layer: str = "override") -> None:
        if layer not in self._layers:
            raise KeyError(f"unknown config layer {layer!r}")
        opt = self._options.get(name)
        if opt is None:
            raise KeyError(f"unknown option {name!r}")
        if layer == "override" and not opt.runtime:
            raise ValueError(f"option {name} is not runtime-changeable "
                             f"(flags: [runtime] absent)")
        value = opt.validate(value)
        old = self.get(name)
        self._layers[layer][name] = value
        if self.get(name) != old:
            for obs in self._observers:
                obs(name, self.get(name))

    def rm(self, name: str, layer: str) -> None:
        old = self.get(name)
        self._layers[layer].pop(name, None)
        new = self.get(name)
        if new != old:
            for obs in self._observers:
                obs(name, new)

    # -- bulk ingestion ---------------------------------------------------
    def load_file(self, path: str) -> None:
        """Load a JSON conf file into the 'file' layer."""
        with open(path) as f:
            for k, v in json.load(f).items():
                self.set(k, v, layer="file")

    def load_env(self, prefix: str = "CEPH_TPU_") -> None:
        for k, v in os.environ.items():
            if k.startswith(prefix):
                name = k[len(prefix):].lower()
                if name in self._options:
                    self.set(name, v, layer="env")

    def apply_cmdline(self, pairs: Iterable[str]) -> None:
        """Apply ``name=value`` strings (the benchmark CLI --parameter style)."""
        for pair in pairs:
            name, _, value = pair.partition("=")
            self.set(name.strip(), value.strip(), layer="cmdline")

    # -- observation ------------------------------------------------------
    def add_observer(self, fn: Callable[[str, Any], None]) -> None:
        self._observers.append(fn)

    def show(self) -> dict[str, Any]:
        return {name: self.get(name) for name in sorted(self._options)}


@dataclass
class ConfigProxy:
    """Process-wide config handle (ref: src/common/config_proxy.h)."""

    config: Config = field(default_factory=Config)

    def __getattr__(self, name):
        return getattr(self.config, name)


_global: Config | None = None


def global_config() -> Config:
    """The per-process config (ref: src/common/ceph_context.h CephContext)."""
    global _global
    if _global is None:
        cfg = Config()
        cfg.load_env()  # raises on malformed CEPH_TPU_* before caching
        _global = cfg
    return _global


_ABSENT = object()       # live.get sentinel: absent != stored None


def apply_mon_config(entity: str, cfgmap: dict, live: dict,
                     state: dict, mirror_global: bool = False) -> list[str]:
    """Apply a mon-published config map into a daemon's live config.

    ``cfgmap`` is ``{who: {name: raw-str}}`` with who = global |
    <type> | <type>.<id>; resolution is most-specific wins, the same
    mask walk as ConfigMonitor.resolve. ``live`` is the daemon's
    runtime config dict (shared cluster-wide on the in-process
    backend, private per child on the proc backend). ``state`` is a
    per-daemon dict remembering each applied key's pre-map baseline so
    a key that later leaves the map (`config rm`) restores what the
    daemon booted with instead of leaving the override stuck.

    Registered Options are validated/coerced to their declared type;
    unknown names apply as raw strings (same leniency as the mon-side
    live push). Invalid values are skipped, never raised — a bad
    central value must not kill a daemon. With ``mirror_global`` the
    registered names are also mirrored into the per-process
    :func:`global_config` "mon" layer (the proc-backend children's
    Config runtime layer). Returns the names whose live value changed.
    """
    dtype = entity.split(".", 1)[0]
    resolved: dict[str, str] = {}
    for scope in ("global", dtype, entity):
        for name, raw in (cfgmap.get(scope) or {}).items():
            resolved[name] = raw
    baselines: dict[str, tuple[bool, Any]] = state.setdefault(
        "baseline", {})
    changed: list[str] = []
    gcfg = global_config() if mirror_global else None
    for name in [n for n in baselines if n not in resolved]:
        had, old = baselines.pop(name)
        if had:
            if live.get(name) != old or name not in live:
                changed.append(name)
            live[name] = old
        else:
            if name in live:
                changed.append(name)
            live.pop(name, None)
        if gcfg is not None and name in gcfg._options:
            gcfg.rm(name, layer="mon")
    for name, raw in resolved.items():
        opt = OPTIONS.get(name)
        try:
            value = opt.validate(raw) if opt is not None else raw
        except (ValueError, TypeError):
            continue
        # record the pre-map baseline once — and only when this apply
        # actually changes the value. On the in-process backend every
        # daemon shares ONE live dict, so a later applier would
        # otherwise snapshot the already-mutated value as "previous"
        # and a config rm would restore the override instead of the
        # boot value.
        if name not in baselines and live.get(name, _ABSENT) != value:
            baselines[name] = (name in live, live.get(name))
        if name not in live or live.get(name) != value:
            live[name] = value
            changed.append(name)
        if gcfg is not None and name in gcfg._options:
            try:
                gcfg.set(name, value, layer="mon")
            except (ValueError, KeyError):
                pass
    return changed
