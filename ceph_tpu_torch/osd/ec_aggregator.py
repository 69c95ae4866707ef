"""OSD-side EC encode aggregator: cross-op stripe-batch coalescing.

The counterpart of ``ceph_tpu/osd/ec_aggregator.py``. The encode kernel
hits its resident rate only on deep batches, but every client op would
launch its own ``encode_batch``: at production traffic (thousands of
concurrent small-to-medium writes) the data path is launch-bound, not
compute-bound. This aggregator coalesces concurrent stripe encodes from
ALL the PGs on one OSD into a single padded batched kernel launch per
flush window.

Contract:

- **bit-exact**: every encode kernel is stripe-row-independent, so the
  concatenated batch's rows equal the per-op results lane for lane
  (pinned in tests/test_torch_ec_agg.py); the per-op path survives as the
  measured baseline behind ``osd_ec_agg=off`` (read LIVE);
- **latency-bounded**: a batch flushes when ``osd_ec_agg_window_us``
  expires, when ``osd_ec_agg_max_stripes`` accumulate, or when the
  queue goes IDLE (one event-loop yield plus a window slice with no
  new arrivals) — a lone op is never held past the window;
- **fused checksum**: when any waiter wants write-time ``_hcrc``
  stamps, the flush runs the plugin's fused checksum+encode program
  (ec/torch_plugin.encode_batch_with_crc) so checksum+encode stays one
  device pass for the whole coalesced batch;
- **padded launches**: the aggregate batch is zero-padded to the next
  power of two before dispatch, so the device sees O(log max_batch)
  distinct shapes instead of one per concurrency level;
- **degrade ladder**: a failed batch disaggregates per op, and each op
  gets ``osd_ec_fallback_retries`` more device attempts. For a plugin
  on the CPU the bit-exact host reference encoder then serves it, and
  a failed fused checksum pass drops to plain encode + host crc on a
  backoff quarantine. A plugin on the card never hands its work to the
  host: once its retries are spent the op fails with the device's
  error, and a failed fused pass fails its flush like any other device
  error. Every rung is counted (``flush_failures``,
  ``per_op_retries``, ``fallback_ops``, ``crc_fallbacks``): a rung
  that engages on a healthy card is a fault to report, not a slower
  path.

Results are read back to the host (``torch_plugin.to_host``): for a
CUDA result that readback is where the event loop waits for the kernel,
as it waited for ``np.asarray`` in the reference.

Groups are keyed by (profile, k, C): two PGs of the same pool coalesce
even though each holds its own plugin instance (the kernel is a pure
function of the profile).
"""

from __future__ import annotations

import asyncio
import time

import numpy as np

from ceph_tpu_torch.ec.torch_plugin import on_card, to_host
from ceph_tpu_torch.utils.logging import get_logger
from ceph_tpu_torch.utils.perf_counters import PerfCountersBuilder

log = get_logger("osd")


def _agg_perf():
    """Per-OSD counter family (register=False: several in-process OSDs
    each own one; they reach prometheus through the daemon->mgr
    report path as ``ceph_osd_ec_agg_*`` rows, not the process-local
    singleton collection)."""
    return (
        PerfCountersBuilder("osd_ec_agg")
        .add_u64_counter("batches", "coalesced kernel launches")
        .add_u64_counter("stripes", "stripes encoded through batches")
        .add_u64_counter("ops", "encode requests served")
        .add_u64_counter("bypass",
                         "encodes served per-op (osd_ec_agg=off)")
        .add_u64_counter("flush_window",
                         "flushes triggered by the window expiring")
        .add_u64_counter("flush_full",
                         "flushes triggered by osd_ec_agg_max_stripes")
        .add_u64_counter("flush_idle",
                         "flushes triggered by queue idleness")
        .add_time_avg("batch_occupancy",
                      "stripes per flushed batch (long-run avg)")
        .add_time_avg("batch_wait",
                      "seconds an op waited for its flush (long-run "
                      "avg)")
        .add_u64_counter("flush_failures",
                         "batched flushes whose device encode raised "
                         "(the batch disaggregated per-op)")
        .add_u64_counter("per_op_retries",
                         "bounded per-op device retries after a "
                         "failed batch (osd_ec_fallback_retries)")
        .add_u64_counter("fallback_ops",
                         "ops served by the bit-exact reference "
                         "(numpy) encoder after device retries "
                         "exhausted")
        .add_u64_counter("crc_fallbacks",
                         "fused checksum+encode failures that dropped "
                         "to plain encode + host crc (the fused "
                         "path quarantines on backoff)")
        .create_perf_counters(register=False))


class _Entry:
    __slots__ = ("data", "with_crc", "fut", "t0")

    def __init__(self, data, with_crc, fut, t0):
        self.data = data
        self.with_crc = with_crc
        self.fut = fut
        self.t0 = t0


class _Group:
    """One in-flight coalescing batch; staleness is decided by
    identity (``self._groups.get(key) is g``), never by counters."""

    __slots__ = ("ec", "entries", "stripes", "task")

    def __init__(self, ec):
        self.ec = ec
        self.entries: list[_Entry] = []
        self.stripes = 0
        self.task: asyncio.Task | None = None


class ECAggregator:
    """One per OSD daemon; every ECPG encode routes through it."""

    def __init__(self, config: dict | None = None):
        self.config = config if config is not None else {}
        self.perf = _agg_perf()
        self._groups: dict[tuple, _Group] = {}
        self.stopped = False
        # fused checksum+encode quarantine: after the fused pass
        # raises, flushes serve plain encode + host crc until the
        # backoff deadline passes, then the fused path is retried
        self._crc_q_until = 0.0
        self._crc_failures = 0

    # -- knobs (read LIVE) -------------------------------------------------
    def enabled(self) -> bool:
        return bool(self.config.get("osd_ec_agg", True))

    def window_s(self) -> float:
        return float(self.config.get("osd_ec_agg_window_us", 500)) / 1e6

    def max_stripes(self) -> int:
        return int(self.config.get("osd_ec_agg_max_stripes", 4096))

    def _retries(self) -> int:
        return int(self.config.get("osd_ec_fallback_retries", 1))

    # -- submit ------------------------------------------------------------
    async def encode(self, ec, data, with_crc: bool = False):
        """Encode a (B, k, C) uint8 stripe batch; returns
        ``(parity np(B, m, C), row_crcs np(B, k+m) uint32 | None)``.
        ``row_crcs`` is None when ``with_crc`` is False or the plugin
        has no fused path (callers fall back to zlib via
        ec.crc.hcrc_attr)."""
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if not self.enabled() or self.stopped:
            # the measured per-op baseline: one UNPADDED launch per
            # op, exactly the pre-aggregator path — padding here
            # would make the baseline systematically slower than what
            # production previously ran and flatter the aggregator's
            # speedup (fused checksum still applies — the fusion is
            # orthogonal to coalescing)
            self.perf.inc("bypass")
            try:
                return self._run(ec, data, with_crc, pad=False)
            except Exception as e:
                return self._degrade_one(ec, data, with_crc, e)
        key = (str(ec.profile), int(data.shape[1]), int(data.shape[2]))
        g = self._groups.get(key)
        if g is None:
            g = self._groups[key] = _Group(ec)
        loop = asyncio.get_event_loop()
        fut = loop.create_future()
        g.entries.append(_Entry(data, with_crc, fut, loop.time()))
        g.stripes += data.shape[0]
        if g.stripes >= self.max_stripes():
            self._flush(key, g, "full")
        elif g.task is None:
            g.task = asyncio.ensure_future(self._flush_later(key, g))
        return await fut

    async def _flush_later(self, key: tuple, g: _Group) -> None:
        """Window/idle flusher for one group generation. Yields to the
        loop once so a concurrent burst of submitters lands, then
        soaks window slices; two consecutive looks with no new arrival
        mean the queue is idle — flush early instead of pinning a lone
        op to the full window."""
        loop = asyncio.get_event_loop()
        window = self.window_s()
        deadline = loop.time() + window
        seen = -1
        try:
            while True:
                await asyncio.sleep(0)
                if self._groups.get(key) is not g:
                    return                   # full-trigger beat us
                now = loop.time()
                if now >= deadline:
                    self._flush(key, g, "window")
                    return
                if len(g.entries) == seen:
                    self._flush(key, g, "idle")
                    return
                seen = len(g.entries)
                await asyncio.sleep(
                    min(deadline - now, max(window / 8, 1e-4)))
        except asyncio.CancelledError:
            if self._groups.get(key) is g:
                self._flush(key, g, "window")
            raise

    # -- flush -------------------------------------------------------------
    def _flush(self, key: tuple, g: _Group, trigger: str) -> None:
        if self._groups.get(key) is g:
            del self._groups[key]
        if g.task is not None and g.task is not asyncio.current_task():
            g.task.cancel()
            g.task = None
        entries = g.entries
        if not entries:
            return
        datas = [e.data for e in entries]
        big = datas[0] if len(datas) == 1 else \
            np.concatenate(datas, axis=0)
        want_crc = any(e.with_crc for e in entries)
        loop = asyncio.get_event_loop()
        try:
            parity, crcs = self._run(g.ec, big, want_crc)
        except Exception as e:
            self._degrade(g.ec, entries, e)
            return
        off = 0
        now = loop.time()
        for ent in entries:
            b = ent.data.shape[0]
            res = (parity[off:off + b],
                   crcs[off:off + b]
                   if crcs is not None and ent.with_crc else None)
            if not ent.fut.done():
                ent.fut.set_result(res)
            self.perf.avg_add("batch_wait", now - ent.t0)
            off += b
        self.perf.inc("batches")
        self.perf.inc("stripes", int(big.shape[0]))
        self.perf.inc("ops", len(entries))
        self.perf.inc(f"flush_{trigger}")
        self.perf.avg_add("batch_occupancy", float(big.shape[0]))
        log.dout(10, f"ec_agg flush {trigger}: {len(entries)} ops, "
                     f"{big.shape[0]} stripes")

    # -- degrade ladder ----------------------------------------------------
    def _degrade(self, ec, entries, err: Exception) -> None:
        """Failed batch flush: DISAGGREGATE — retry each member stripe
        as its own device encode, then (plugin on the CPU) the bit-exact
        reference (numpy) encoder; only the op whose stripe still fails
        sees the exception. One poisoned stripe must not fail its
        batchmates."""
        self.perf.inc("flush_failures")
        log.dout(0, f"ec_agg batch flush failed "
                    f"({type(err).__name__}: {str(err)[:200]}) — "
                    f"disaggregating {len(entries)} ops")
        loop = asyncio.get_event_loop()
        for ent in entries:
            try:
                res = self._run(ec, ent.data, ent.with_crc, pad=False)
            except Exception as e:
                try:
                    res = self._degrade_one(ec, ent.data,
                                            ent.with_crc, e)
                except Exception as e2:
                    if not ent.fut.done():
                        ent.fut.set_exception(e2)
                    self.perf.avg_add("batch_wait",
                                      loop.time() - ent.t0)
                    continue
            if not ent.fut.done():
                ent.fut.set_result(res)
            self.perf.avg_add("batch_wait", loop.time() - ent.t0)

    def _degrade_one(self, ec, data, with_crc: bool, err: Exception):
        """Per-op tail of the ladder: osd_ec_fallback_retries more
        device attempts. Then a plugin on the card raises the last
        device error; a plugin on the CPU is served by the reference
        encoder (host numpy, bit-exact by construction; crcs fall back
        to the caller's zlib path), and raises only when the reference
        itself fails."""
        exc = err
        for _ in range(max(0, self._retries())):
            self.perf.inc("per_op_retries")
            try:
                return self._run(ec, data, with_crc, pad=False)
            except Exception as e:
                exc = e
        if on_card(ec):
            raise exc
        try:
            parity = to_host(ec.encode_batch_reference(data)).astype(
                np.uint8, copy=False)
        except Exception:
            raise exc
        self.perf.inc("fallback_ops")
        log.dout(1, f"ec_agg op served by the reference encoder "
                    f"({data.shape[0]} stripes) after device retries "
                    f"exhausted")
        return parity, None

    @staticmethod
    def _pad(b: int) -> int:
        """Next power of two: bounds the launch shapes to O(log)."""
        return 1 << (int(b) - 1).bit_length() if b > 1 else 1

    def _run(self, ec, data, want_crc: bool, pad: bool = True):
        """One device launch over a (possibly padded) batch, read back.
        For a plugin on the CPU the fused checksum+encode carries its
        own quarantine: after it raises, flushes drop to plain encode +
        host crc (callers' zlib path) until an exponential-backoff
        deadline (osd_ec_fallback_quarantine_base/_max) passes, then the
        fused path is probed again by simply serving the next crc
        flush. On the card a failed fused pass raises."""
        card = on_card(ec)
        b = data.shape[0]
        padded = self._pad(b) if pad else b
        if padded != b:
            pad = np.zeros((padded - b,) + data.shape[1:],
                           dtype=np.uint8)
            data = np.concatenate([data, pad], axis=0)
        if want_crc and (card or time.monotonic() >= self._crc_q_until):
            try:
                parity, crcs = ec.encode_batch_with_crc(data)
                parity = to_host(parity)[:b]
                crcs = None if crcs is None else \
                    to_host(crcs)[:b].astype(np.uint32)
            except Exception as e:
                if card:
                    raise
                self._crc_fail(e)
            else:
                self._crc_failures = 0
                return parity, crcs
        return to_host(ec.encode_batch(data))[:b], None

    def _crc_fail(self, e: Exception) -> None:
        self.perf.inc("crc_fallbacks")
        self._crc_failures += 1
        base = float(self.config.get(
            "osd_ec_fallback_quarantine_base", 1.0))
        cap = float(self.config.get(
            "osd_ec_fallback_quarantine_max", 30.0))
        backoff = min(base * (2 ** (self._crc_failures - 1)), cap)
        self._crc_q_until = time.monotonic() + backoff
        log.dout(0, f"fused checksum+encode failed "
                    f"({type(e).__name__}: {str(e)[:200]}) — plain "
                    f"encode + host crc for {backoff:.2f}s")

    # -- lifecycle / observability ----------------------------------------
    def drain(self) -> int:
        """Daemon stop: flush nothing more — cancel every waiter (their
        PG op workers are being cancelled too) and kill flush timers.
        Returns the number of ops dropped."""
        self.stopped = True
        n = 0
        for key, g in list(self._groups.items()):
            if g.task is not None:
                g.task.cancel()
                g.task = None
            for ent in g.entries:
                n += 1
                if not ent.fut.done():
                    ent.fut.cancel()
            self._groups.pop(key, None)
        return n

    def dump(self) -> dict:
        d = self.perf.dump()
        occ = d.get("batch_occupancy", {})
        wait = d.get("batch_wait", {})
        return {
            "enabled": self.enabled(),
            "window_us": float(
                self.config.get("osd_ec_agg_window_us", 500)),
            "max_stripes": self.max_stripes(),
            "pending_groups": len(self._groups),
            "pending_ops": sum(len(g.entries)
                               for g in self._groups.values()),
            "batches": d.get("batches", 0),
            "stripes": d.get("stripes", 0),
            "ops": d.get("ops", 0),
            "bypass": d.get("bypass", 0),
            "flushes": {t: d.get(f"flush_{t}", 0)
                        for t in ("window", "full", "idle")},
            "avg_occupancy": (occ.get("sum", 0.0) /
                              occ.get("avgcount", 1)
                              if occ.get("avgcount") else 0.0),
            "avg_batch_wait_s": (wait.get("sum", 0.0) /
                                 wait.get("avgcount", 1)
                                 if wait.get("avgcount") else 0.0),
        }
