"""Device-runtime observability: the monitor every device entry point
reports through.

The counterpart of ``ceph_tpu/utils/devmon.py``, with the same counter
names where the engines match, so the mgr and Prometheus rows match when
the cluster is ported. Three blind spots it covers:

- **first launches**: on JAX a new (function, shape) pair recompiles.
  PyTorch runs eagerly and a CUDA kernel has no per-shape compile, so
  what :meth:`DeviceRuntimeMonitor.jit_call` counts as a "compile" is the
  first launch of each (function, shape key): it pays the nvcc build of
  the kernel's source (at the first launch in the process), the loading
  of its library, lazy CUDA initialisation and the caching allocator's
  first allocations of that size. The counter keeps its JAX name
  (``jit_compiles``);
- **unaccounted transfers**: host->device staging and device->host
  readbacks are counted in bytes;
- **silent kernel-path degradation**: every CRUSH ``Mapper`` call and
  every ``OSDMapMapping`` sweep records which engine ran
  (:meth:`record_launch`) and whether it was the one expected
  (:meth:`record_path_check`); the ``devmon_expected_engine`` knob of
  ``config`` pins the deployed expectation, ``auto`` trusts the plan.
  The Mapper's kernel quarantine reports its entries, exits and probes
  here (gauges ``quarantined_now``, ``reprobing_now``,
  ``quarantine_permanent_now``).

Engines take the port's names: ``kernel`` (the CUDA kernel, with its
plain version ``kernel-plain`` folded in, as ``pallas-interpret`` folds
into ``pallas``), ``vm`` (the rule VM; ceph_tpu's ``xla``) and
``scalar``. The launch counters are ``launches_kernel``, ``launches_vm``
and ``launches_scalar`` (ceph_tpu: ``launches_pallas``, ``launches_xla``,
``launches_scalar``); ``launches_sharded`` counts the launches of the
mesh-sharded path (a ``+sharded`` path suffix) beside their engine's.

The process singleton (``devmon()``, counter family ``device_runtime``,
registered in the process collection) is what ``ec.torch_plugin``,
``ec.crc`` and ``crush.mapper`` report through.

:meth:`DeviceRuntimeMonitor.attach_tracer` takes the owning
daemon's tracer: every first launch then emits one ``jit_compile`` span.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ceph_tpu_torch.utils.perf_counters import PerfCountersBuilder

# engines a path string can resolve to
ENGINES = ("kernel", "vm", "scalar")

# warm-set bound: (fn, key) pairs tracked for first-launch detection.
# Shape churn past this evicts the OLDEST entry only, so a long-running
# daemon's hot paths stay warm (a full clear would re-count every hot
# path's next call as a fresh first launch).
_WARM_MAX = 4096

# device fault injection: jit_call is the one chokepoint every device
# call passes through, so it is also where the device fault kinds
# (jit_fail / jit_stall / bad_result) fire. None in production.
_fault_injector = None


def set_fault_injector(inj) -> None:
    """Attach (or detach, with None) the process's fault injector to the
    jit_call chokepoint. The injector is duck-typed: it answers
    ``has_device_rules()`` and ``device_verdicts(fn_name, key)`` ->
    (stall seconds, fail, corrupt). It is consulted only when it has
    device rules installed: the no-faults path costs one attribute
    read."""
    global _fault_injector
    _fault_injector = inj


def _corrupt_result(out):
    """The ``bad_result`` fault: flip one element of the returned array
    (first element of a tuple result, the payload; EC's crc sidecar rides
    along untouched so checksum verification still sees the corrupt
    payload). Returns a copy (a torch tensor stays on its device);
    shapes and dtypes are preserved so only bit-exact checks can tell."""
    if isinstance(out, tuple):
        if not out:
            return out
        return (_corrupt_result(out[0]),) + tuple(out[1:])
    if isinstance(out, torch.Tensor):
        if out.numel() == 0:
            return out
        arr = out.clone()
        flat = arr.view(-1)
        if arr.is_floating_point():
            flat[0] += 1.0
        elif arr.dtype != torch.bool:
            flat[0] ^= 1
        else:
            return out
        return arr
    try:
        arr = np.array(out)
    except Exception:
        return out
    if arr.size == 0:
        return out
    flat = arr.reshape(-1)
    if arr.dtype.kind in "iu":
        flat[0] ^= 1
    elif arr.dtype.kind == "f":
        flat[0] = flat[0] + 1.0
    else:
        return out
    return arr


def normalize_engine(path: str | None) -> str:
    """Collapse a mapping path to its base engine: 'kernel-plain' ->
    'kernel', a '+...' suffix dropped; '?' for anything else."""
    if not path:
        return "?"
    base = path.split("+", 1)[0]
    if base.startswith("kernel"):
        return "kernel"
    return base if base in ENGINES else "?"


class DeviceRuntimeMonitor:
    """First-launch accounting + kernel-path health + transfer gauges.

    ``register=True`` puts the counter family in the process-wide
    collection (the ``devmon()`` singleton); per-daemon instances pass
    ``register=False``. ``config`` is the owner's live config dict:
    ``devmon_expected_engine`` is read per check, and the Mapper reads its
    ``crush_kernel_reprobe_*`` knobs from the singleton's."""

    def __init__(self, name: str = "device_runtime",
                 register: bool = True, config: dict | None = None):
        self.config = config if config is not None else {}
        self.perf = (
            PerfCountersBuilder(name)
            .add_u64_counter("jit_compiles",
                             "first launches observed (per distinct "
                             "function + shape key)")
            .add_time("jit_compile_seconds",
                      "wall seconds spent in first launches")
            .add_u64_counter("launches_kernel",
                             "map/sweep launches served by the CRUSH "
                             "kernel (its plain version included)")
            .add_u64_counter("launches_vm",
                             "map/sweep launches served by the rule VM")
            .add_u64_counter("launches_scalar",
                             "map/sweep launches served by the scalar "
                             "spec walk (legacy tunables)")
            .add_u64_counter("launches_sharded",
                             "launches that rode the mesh-sharded "
                             "path (counted in addition to the engine)")
            .add_u64_counter("path_checks",
                             "expected-vs-actual engine checks at "
                             "Mapper/OSDMapMapping sweep sites")
            .add_u64_counter("path_mismatch",
                             "sweeps whose actual engine differed "
                             "from the expected one (the silent-"
                             "degradation signal)")
            .add_u64_counter("h2d_bytes",
                             "host->device bytes staged (mapper "
                             "packing, EC pipeline ingest)")
            .add_u64_counter("d2h_bytes",
                             "device->host bytes read back")
            .add_u64("device_bytes_staged",
                     "bytes of the most recent staging op (gauge)")
            .add_u64("device_bytes_watermark",
                     "largest single staging op seen (gauge, "
                     "monotone max)")
            .add_u64_counter("quarantine_entries",
                             "kernel-path quarantine entries (a kernel "
                             "failure; on the card also counted when "
                             "the error is raised to the caller)")
            .add_u64_counter("quarantine_exits",
                             "kernel-path re-promotions (a bit-exact "
                             "probe passed and the kernel serves again)")
            .add_u64_counter("quarantine_probes",
                             "backoff re-probe attempts against a "
                             "quarantined kernel")
            .add_u64_counter("quarantine_probe_failures",
                             "re-probes that raised or mismatched the "
                             "serving path bit-exactly")
            .add_u64("quarantined_now",
                     "kernels currently quarantined (serving the "
                     "fallback engine, re-probe pending; gauge)")
            .add_u64("reprobing_now",
                     "quarantined kernels past their first failed "
                     "re-probe (gauge)")
            .add_u64("quarantine_permanent_now",
                     "kernels permanently disabled after "
                     "crush_kernel_reprobe_disable_after consecutive "
                     "failures (gauge)")
            .add_u64_counter("faults_injected",
                             "device faults fired at the jit_call "
                             "chokepoint")
            .add_u64_counter("stream_fallbacks",
                             "streaming-encode pipelines that fell "
                             "back to the unpipelined path")
            .create_perf_counters(register=register))
        self.tracer = None           # utils.tracing.Tracer | None
        self._lock = threading.Lock()
        # insertion-ordered: eviction at _WARM_MAX pops oldest only
        self._warm: dict[tuple, None] = {}
        # fn name -> {count, seconds, last_key, last_seconds}
        self.functions: dict[str, dict] = {}
        self._watermark = 0
        self.last_mismatch: dict | None = None
        # quarantine token -> "quarantined"|"reprobing"|"permanent"
        self._quarantine: dict = {}

    # -- wiring ------------------------------------------------------------
    def attach_tracer(self, tracer) -> None:
        """Attach the owning daemon's Tracer: every first launch emits
        one ``jit_compile`` span through it (in a process of many
        daemons the last attach wins: one span per first launch either
        way, never zero, never two)."""
        self.tracer = tracer

    # -- first-launch accounting -------------------------------------------
    def jit_call(self, fn_name: str, key, fn, *args):
        """Run ``fn(*args)``, recording the call as a first launch when
        this (fn_name, key) pair has never run before. Callers pass
        (identity of the kernel owner, shape) as ``key``. Warm calls cost
        one dict lookup; a failed first call un-warms so the retry's
        first launch still counts.

        This is also the device-fault injection chokepoint: when an
        injector with device rules is attached (:func:`set_fault_injector`),
        its verdict runs first: ``jit_stall`` sleeps here, ``jit_fail``
        raises before any warm-set bookkeeping, ``bad_result`` corrupts
        the completed result."""
        corrupt = False
        inj = _fault_injector
        if inj is not None and inj.has_device_rules():
            stall, fail, corrupt = inj.device_verdicts(fn_name, str(key))
            if stall > 0:
                time.sleep(stall)
            if fail:
                self.perf.inc("faults_injected")
                raise RuntimeError(
                    f"injected device fault: jit_fail on {fn_name}")
        k = (fn_name, key)
        with self._lock:
            warm = k in self._warm
            if not warm:
                if len(self._warm) >= _WARM_MAX:
                    self._warm.pop(next(iter(self._warm)))
                self._warm[k] = None
        if warm:
            out = fn(*args)
        else:
            t0 = time.perf_counter()
            try:
                out = fn(*args)
            except BaseException:
                with self._lock:
                    self._warm.pop(k, None)
                raise
            self.record_compile(fn_name, key, time.perf_counter() - t0)
        if corrupt:
            self.perf.inc("faults_injected")
            out = _corrupt_result(out)
        return out

    def record_compile(self, fn_name: str, key, seconds: float) -> None:
        """One observed first launch: counter + time sum + per-function
        table. The time is host wall time of the call: a CUDA launch
        returns before the kernel ends, so it covers the build, load and
        set-up, not the kernel's run."""
        seconds = max(float(seconds), 0.0)
        self.perf.inc("jit_compiles")
        self.perf.tinc("jit_compile_seconds", seconds)
        with self._lock:
            ent = self.functions.setdefault(
                fn_name, {"count": 0, "seconds": 0.0})
            ent["count"] += 1
            ent["seconds"] = round(ent["seconds"] + seconds, 6)
            ent["last_key"] = str(key)[:120]
            ent["last_seconds"] = round(seconds, 6)
        tracer = self.tracer
        if tracer is not None:
            # a real Span assembled after the fact: the trace id is
            # minted directly (head sampling must not drop it) and the
            # start is back-dated so the span's wall is the first call's
            from ceph_tpu_torch.utils.tracing import Span, new_trace_id
            s = Span(tracer, "jit_compile", new_trace_id(),
                     tags={"fn": fn_name, "key": str(key)[:120]})
            s.start -= seconds
            s.duration = seconds
            s.finished = True
            tracer.record(s)

    # -- kernel-path health ------------------------------------------------
    def expected_engine(self, plan_path: str | None) -> str:
        """The engine this monitor's owner EXPECTS sweeps to run on: the
        ``devmon_expected_engine`` knob when pinned, else the plan's own
        prediction (``plan_path``), under which the only possible
        mismatch is a plan that degraded mid-run."""
        want = str(self.config.get("devmon_expected_engine", "auto"))
        if want in ("", "auto"):
            return normalize_engine(plan_path)
        return want

    def record_launch(self, path: str | None, n: int = 1) -> None:
        """Count a map/sweep launch by the engine that actually ran."""
        eng = normalize_engine(path)
        if eng in ENGINES:
            self.perf.inc(f"launches_{eng}", n)
        if path and "+sharded" in path:
            self.perf.inc("launches_sharded", n)

    def record_path_check(self, expected: str | None,
                          actual: str | None) -> bool:
        """One expected-vs-actual engine check; returns True on mismatch.
        Both sides normalize, so 'kernel-plain' == 'kernel' and the
        '+sharded' suffix never trips a false mismatch."""
        e, a = normalize_engine(expected), normalize_engine(actual)
        self.perf.inc("path_checks")
        if e == a or e == "?":
            return False
        self.perf.inc("path_mismatch")
        self.last_mismatch = {"expected": e, "actual": a,
                              "stamp": time.time()}
        return True

    def record_sweep(self, plan_path: str | None, actual: str | None,
                     n_launches: int = 1) -> bool:
        """The per-sweep-site combo: launch counter + expectation check
        (knob-pinned or plan-trusted)."""
        self.record_launch(actual, n_launches)
        return self.record_path_check(
            self.expected_engine(plan_path), actual)

    # -- kernel quarantine ---------------------------------------------------
    def set_quarantine_state(self, token, state: str | None) -> None:
        """Track one kernel owner's quarantine state (keyed by an opaque
        token: Mappers use their per-incarnation token). ``None`` clears.
        The three gauges always reflect the live table."""
        with self._lock:
            if state is None:
                self._quarantine.pop(token, None)
            else:
                self._quarantine[token] = state
            states = list(self._quarantine.values())
        self.perf.set("quarantined_now",
                      sum(1 for s in states
                          if s in ("quarantined", "reprobing")))
        self.perf.set("reprobing_now",
                      sum(1 for s in states if s == "reprobing"))
        self.perf.set("quarantine_permanent_now",
                      sum(1 for s in states if s == "permanent"))

    def record_quarantine_enter(self, token,
                                state: str = "quarantined") -> None:
        self.perf.inc("quarantine_entries")
        self.set_quarantine_state(token, state)

    def record_quarantine_exit(self, token) -> None:
        self.perf.inc("quarantine_exits")
        self.set_quarantine_state(token, None)

    def record_probe(self, ok: bool) -> None:
        self.perf.inc("quarantine_probes")
        if not ok:
            self.perf.inc("quarantine_probe_failures")

    # -- transfers / memory ------------------------------------------------
    def record_h2d(self, nbytes: int) -> None:
        if nbytes > 0:
            self.perf.inc("h2d_bytes", int(nbytes))

    def record_d2h(self, nbytes: int) -> None:
        if nbytes > 0:
            self.perf.inc("d2h_bytes", int(nbytes))

    def note_staging(self, nbytes: int) -> None:
        """One staging op's footprint: the gauge holds the most recent
        op, the watermark the largest ever (per-op max, NOT a running
        sum: frees are not tracked, and a cumulative gauge would be a
        lie)."""
        nbytes = int(nbytes)
        if nbytes <= 0:
            return
        self.perf.set("device_bytes_staged", nbytes)
        with self._lock:
            if nbytes > self._watermark:
                self._watermark = nbytes
        self.perf.set("device_bytes_watermark", self._watermark)

    # -- views -------------------------------------------------------------
    def mismatch_ratio(self) -> float:
        d = self.perf.dump()
        checks = int(d.get("path_checks", 0))
        return (int(d.get("path_mismatch", 0)) / checks) if checks \
            else 0.0

    def health_report(self) -> dict[str, int]:
        """The daemon's ``device_health`` payload: this monitor's
        cumulative path health merged with the process singleton's
        first-launch/transfer side and the quarantine gauges (Mappers are
        process-level). All ints."""
        d = self.perf.dump()
        proc = self if self is _singleton else devmon()
        p = proc.perf.dump() if proc is not self else d
        return {
            "checks": int(d.get("path_checks", 0)),
            "mismatches": int(d.get("path_mismatch", 0)),
            "launches_kernel": int(d.get("launches_kernel", 0)),
            "launches_vm": int(d.get("launches_vm", 0)),
            "launches_scalar": int(d.get("launches_scalar", 0)),
            "launches_sharded": int(d.get("launches_sharded", 0)),
            "compiles": int(p.get("jit_compiles", 0)),
            "compile_ms": int(
                float(p.get("jit_compile_seconds", 0.0)) * 1e3),
            "h2d_bytes": int(p.get("h2d_bytes", 0)),
            "d2h_bytes": int(p.get("d2h_bytes", 0)),
            "quarantined": int(p.get("quarantined_now", 0)),
            "reprobing": int(p.get("reprobing_now", 0)),
            "quarantine_permanent": int(
                p.get("quarantine_permanent_now", 0)),
            "quarantine_entries": int(p.get("quarantine_entries", 0)),
            "quarantine_exits": int(p.get("quarantine_exits", 0)),
        }

    def dump(self) -> dict:
        """The ``device`` block / ``device-runtime status`` payload for
        this monitor."""
        out = {
            "engine": engine_name(),
            "expected_engine": str(
                self.config.get("devmon_expected_engine", "auto")),
            "counters": self.perf.dump(),
            "mismatch_ratio": round(self.mismatch_ratio(), 4),
        }
        if self.last_mismatch:
            out["last_mismatch"] = dict(self.last_mismatch)
        with self._lock:
            if self.functions:
                out["compiles_by_fn"] = {
                    k: dict(v) for k, v in sorted(self.functions.items())}
        return out


_singleton: DeviceRuntimeMonitor | None = None


def engine_name() -> str:
    """The process's default device ('cuda' when a card is present, else
    'cpu'): the `device_engine` field daemons stamp on their reports."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def devmon() -> DeviceRuntimeMonitor:
    """The process singleton (counter family ``device_runtime``) every
    process-level device entry point reports through."""
    global _singleton
    if _singleton is None:
        _singleton = DeviceRuntimeMonitor()
    return _singleton
