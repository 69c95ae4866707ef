"""Device-runtime observability: the monitor every device entry point
reports through.

The counterpart of ``ceph_tpu/utils/devmon.py``, with the same counter
names, so the mgr and Prometheus rows match when the cluster is ported.
Two blind spots it covers:

- **first launches**: on JAX a new (function, shape) pair recompiles.
  PyTorch runs eagerly and a CUDA kernel has no per-shape compile, so
  what :meth:`DeviceRuntimeMonitor.jit_call` counts as a "compile" is the
  first launch of each (function, shape key): it pays the nvcc build of
  the kernel's source (at the first launch in the process), the loading
  of its library, lazy CUDA initialisation and the caching allocator's
  first allocations of that size. The counter keeps its JAX name
  (``jit_compiles``);
- **unaccounted transfers**: host->device staging and device->host
  readbacks are counted in bytes.

The process singleton (``devmon()``, counter family ``device_runtime``,
registered in the process collection) is what ``ec.torch_plugin`` and
``ec.crc`` report through.

Left out for now: the reference's kernel-path health side (which engine
served a CRUSH sweep, the expected-vs-actual check, the kernel
quarantine gauges), which lands with the Mapper's quarantine, and its
``attach_tracer`` (a ``jit_compile`` span per first call), which needs
the tracing module.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ceph_tpu_torch.utils.perf_counters import PerfCountersBuilder

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


class DeviceRuntimeMonitor:
    """First-launch accounting + transfer gauges.

    ``register=True`` puts the counter family in the process-wide
    collection (the ``devmon()`` singleton); other instances pass
    ``register=False``."""

    def __init__(self, name: str = "device_runtime",
                 register: bool = True):
        self.perf = (
            PerfCountersBuilder(name)
            .add_u64_counter("jit_compiles",
                             "first launches observed (per distinct "
                             "function + shape key)")
            .add_time("jit_compile_seconds",
                      "wall seconds spent in first launches")
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
            .add_u64_counter("faults_injected",
                             "device faults fired at the jit_call "
                             "chokepoint")
            .add_u64_counter("stream_fallbacks",
                             "streaming-encode pipelines that fell "
                             "back to the unpipelined path")
            .create_perf_counters(register=register))
        self._lock = threading.Lock()
        # insertion-ordered: eviction at _WARM_MAX pops oldest only
        self._warm: dict[tuple, None] = {}
        # fn name -> {count, seconds, last_key, last_seconds}
        self.functions: dict[str, dict] = {}
        self._watermark = 0

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

    def dump(self) -> dict:
        """The ``device`` block / ``device-runtime status`` payload for
        this monitor."""
        out = {
            "engine": engine_name(),
            "counters": self.perf.dump(),
        }
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
