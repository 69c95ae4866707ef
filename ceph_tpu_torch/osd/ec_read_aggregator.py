"""OSD-side EC decode aggregator: cross-op degraded-read/repair
coalescing, the read-side twin of osd/ec_aggregator.py.

The counterpart of ``ceph_tpu/osd/ec_read_aggregator.py``. A degraded
read, a recovery shard rebuild and a backfill push all end in the same
place: ``decode_batch`` over a gathered stripe range. During repair
churn (an OSD dies, every PG it touched starts rebuilding while clients
keep reading) one launch per op makes the decode path launch-bound.
This aggregator coalesces concurrent decodes from ALL the PGs on one
OSD into a single padded batched launch per flush window.

Contract (mirrors the encode aggregator, pinned in
tests/test_torch_ec_read_agg.py):

- **bit-exact**: decode kernels are stripe-row-independent, so the
  concatenated batch's rows equal the per-op results lane for lane;
  the per-op path survives as the measured baseline behind
  ``osd_ec_read_agg=off`` (read LIVE);
- **latency-bounded**: a batch flushes when
  ``osd_ec_read_agg_window_us`` expires, when
  ``osd_ec_read_agg_max_stripes`` accumulate, or when the queue goes
  IDLE — a lone degraded read is never held past the window;
- **padded launches**: pow2 zero-padding bounds the launch shapes to
  O(log max_batch) per (erasure pattern, chunk size);
- **QoS-honest**: repair decodes (rebuild/backfill — not client
  degraded reads, which were already cost-tagged at admission) charge
  a recovery-class grant at the same bytes/osd_qos_cost_per_io_bytes
  divisor client writes pay, so repair churn can't starve cold
  tenants;
- **degrade ladder**: a failed batch flush disaggregates per-op, and
  each op gets ``osd_ec_fallback_retries`` device attempts. For a
  plugin on the CPU the bit-exact host reference decoder then serves
  it, and repeated failures quarantine the device decode on
  exponential backoff (``osd_ec_fallback_quarantine_base/_max``),
  during which ops are served by the reference directly, probing the
  device again after the deadline. A plugin on the card never hands
  its work to the host and is never quarantined: once its retries are
  spent the op fails with the device's error. Every rung is counted
  (``flush_failures``, ``per_op_retries``, ``fallback_ops``,
  ``quarantined_ops``).

Groups are keyed by (profile, avail, want, C): the decode kernel is a
pure function of the erasure pattern, so only ops reconstructing the
same missing set from the same available set share a launch — exactly
the granularity of ``ErasureCodeJax._decode_kernel``'s cache.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np

from ceph_tpu_torch.ec.torch_plugin import on_card, to_host
from ceph_tpu_torch.osd.scheduler import size_scaled_cost
from ceph_tpu_torch.utils.logging import get_logger
from ceph_tpu_torch.utils.perf_counters import PerfCountersBuilder

log = get_logger("osd")


def _read_agg_perf():
    """Per-OSD counter family (register=False: several in-process OSDs
    each own one; they reach prometheus through the daemon->mgr report
    path as ``ceph_osd_ec_read_agg_*`` rows)."""
    return (
        PerfCountersBuilder("osd_ec_read_agg")
        .add_u64_counter("batches", "coalesced decode launches")
        .add_u64_counter("stripes", "stripes decoded through batches")
        .add_u64_counter("ops", "decode requests served")
        .add_u64_counter("bypass",
                         "decodes served per-op (osd_ec_read_agg=off)")
        .add_u64_counter("flush_window",
                         "flushes triggered by the window expiring")
        .add_u64_counter("flush_full",
                         "flushes triggered by "
                         "osd_ec_read_agg_max_stripes")
        .add_u64_counter("flush_idle",
                         "flushes triggered by queue idleness")
        .add_time_avg("batch_occupancy",
                      "stripes per flushed batch (long-run avg)")
        .add_time_avg("batch_wait",
                      "seconds an op waited for its flush (long-run "
                      "avg)")
        .add_u64_counter("flush_failures",
                         "batched flushes whose device decode raised "
                         "(the batch disaggregated per-op)")
        .add_u64_counter("per_op_retries",
                         "bounded per-op device retries after a "
                         "failed batch (osd_ec_fallback_retries)")
        .add_u64_counter("fallback_ops",
                         "ops served by the bit-exact reference "
                         "(numpy) decoder after device retries "
                         "exhausted")
        .add_u64_counter("quarantined_ops",
                         "ops served by the reference decoder while "
                         "the device decode sat in failure-backoff "
                         "quarantine")
        .add_u64_counter("qos_grants",
                         "repair decodes that paid a recovery-class "
                         "size-scaled QoS grant before queueing")
        .create_perf_counters(register=False))


class _Entry:
    __slots__ = ("chunks", "fut", "t0")

    def __init__(self, chunks, fut, t0):
        self.chunks = chunks
        self.fut = fut
        self.t0 = t0


class _Group:
    """One in-flight coalescing batch; staleness is decided by
    identity (``self._groups.get(key) is g``), never by counters."""

    __slots__ = ("ec", "want", "avail", "entries", "stripes", "task")

    def __init__(self, ec, want, avail):
        self.ec = ec
        self.want = want
        self.avail = avail
        self.entries: list[_Entry] = []
        self.stripes = 0
        self.task: asyncio.Task | None = None


class ECReadAggregator:
    """One per OSD daemon; every ECPG decode routes through it."""

    def __init__(self, config: dict | None = None, scheduler=None):
        self.config = config if config is not None else {}
        self.scheduler = scheduler
        self.perf = _read_agg_perf()
        self._groups: dict[tuple, _Group] = {}
        self.stopped = False
        # device-decode quarantine: after per-op
        # device retries exhaust, decodes serve the host reference
        # until the backoff deadline passes, then the device is probed
        # again by simply running the next flush on it
        self._dev_q_until = 0.0
        self._dev_failures = 0

    # -- knobs (read LIVE) -------------------------------------------------
    def enabled(self) -> bool:
        return bool(self.config.get("osd_ec_read_agg", True))

    def window_s(self) -> float:
        return float(
            self.config.get("osd_ec_read_agg_window_us", 500)) / 1e6

    def max_stripes(self) -> int:
        return int(self.config.get("osd_ec_read_agg_max_stripes", 4096))

    def _retries(self) -> int:
        return int(self.config.get("osd_ec_fallback_retries", 1))

    # -- submit ------------------------------------------------------------
    async def decode(self, ec, want, avail, chunks,
                     charge_bytes: int = 0):
        """Decode a (B, len(avail), C) uint8 batch into the ``want``
        chunk rows; returns np (B, len(want), C).

        ``charge_bytes`` > 0 marks a REPAIR decode (rebuild/backfill):
        a recovery-class QoS grant scaled by
        bytes/osd_qos_cost_per_io_bytes is paid before the op queues,
        the same divisor client writes pay at admission. Client
        degraded reads pass 0 — their cost tag was already charged by
        the daemon's admission path."""
        chunks = np.ascontiguousarray(chunks, dtype=np.uint8)
        want = tuple(want)
        avail = tuple(avail)
        if charge_bytes > 0 and self.scheduler is not None \
                and not self.stopped:
            await self.scheduler.grant(
                "recovery",
                cost=size_scaled_cost(self.config, charge_bytes))
            self.perf.inc("qos_grants")
        if not self.enabled() or self.stopped:
            # the measured per-op baseline: one UNPADDED launch per
            # op, exactly the pre-aggregator path — padding here would
            # flatter the aggregator's speedup
            self.perf.inc("bypass")
            try:
                return self._run(ec, want, avail, chunks, pad=False)
            except Exception as e:
                return self._degrade_one(ec, want, avail, chunks, e)
        key = (str(ec.profile), avail, want, int(chunks.shape[2]))
        g = self._groups.get(key)
        if g is None:
            g = self._groups[key] = _Group(ec, want, avail)
        loop = asyncio.get_event_loop()
        fut = loop.create_future()
        g.entries.append(_Entry(chunks, fut, loop.time()))
        g.stripes += chunks.shape[0]
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
        datas = [e.chunks for e in entries]
        big = datas[0] if len(datas) == 1 else \
            np.concatenate(datas, axis=0)
        loop = asyncio.get_event_loop()
        try:
            out = self._run(g.ec, g.want, g.avail, big)
        except Exception as e:
            self._degrade(g, entries, e)
            return
        off = 0
        now = loop.time()
        for ent in entries:
            b = ent.chunks.shape[0]
            if not ent.fut.done():
                ent.fut.set_result(out[off:off + b])
            self.perf.avg_add("batch_wait", now - ent.t0)
            off += b
        self.perf.inc("batches")
        self.perf.inc("stripes", int(big.shape[0]))
        self.perf.inc("ops", len(entries))
        self.perf.inc(f"flush_{trigger}")
        self.perf.avg_add("batch_occupancy", float(big.shape[0]))
        log.dout(10, f"ec_read_agg flush {trigger}: {len(entries)} "
                     f"ops, {big.shape[0]} stripes")

    # -- degrade ladder ----------------------------------------------------
    def _degrade(self, g: _Group, entries, err: Exception) -> None:
        """Failed batch flush: DISAGGREGATE — retry each member as its
        own device decode, then (plugin on the CPU) the bit-exact
        reference decoder; only the op whose chunks still fail sees the
        exception. One poisoned stripe must not fail its batchmates."""
        self.perf.inc("flush_failures")
        log.dout(0, f"ec_read_agg batch flush failed "
                    f"({type(err).__name__}: {str(err)[:200]}) — "
                    f"disaggregating {len(entries)} ops")
        loop = asyncio.get_event_loop()
        for ent in entries:
            try:
                res = self._run(g.ec, g.want, g.avail, ent.chunks,
                                pad=False)
            except Exception as e:
                try:
                    res = self._degrade_one(g.ec, g.want, g.avail,
                                            ent.chunks, e)
                except Exception as e2:
                    if not ent.fut.done():
                        ent.fut.set_exception(e2)
                    self.perf.avg_add("batch_wait",
                                      loop.time() - ent.t0)
                    continue
            if not ent.fut.done():
                ent.fut.set_result(res)
            self.perf.avg_add("batch_wait", loop.time() - ent.t0)

    def _degrade_one(self, ec, want, avail, chunks, err: Exception):
        """Per-op tail of the ladder: osd_ec_fallback_retries more
        device attempts. Then a plugin on the card raises the last
        device error; a plugin on the CPU quarantines the device decode
        and is served by the reference decoder (host numpy, bit-exact
        by construction), raising only when the reference itself fails.
        Retries are skipped while the device decode is quarantined."""
        exc = err
        card = on_card(ec)
        if card or time.monotonic() >= self._dev_q_until:
            for _ in range(max(0, self._retries())):
                self.perf.inc("per_op_retries")
                try:
                    out = self._run(ec, want, avail, chunks, pad=False)
                except Exception as e:
                    exc = e
                else:
                    self._dev_failures = 0
                    return out
            if card:
                raise exc
            self._dev_fail(exc)
        try:
            out = to_host(ec.decode_batch_reference(
                want, avail, chunks)).astype(np.uint8, copy=False)
        except Exception:
            raise exc
        self.perf.inc("fallback_ops")
        log.dout(1, f"ec_read_agg op served by the reference decoder "
                    f"({chunks.shape[0]} stripes) after device "
                    f"retries exhausted")
        return out

    def _dev_fail(self, e: Exception) -> None:
        self._dev_failures += 1
        base = float(self.config.get(
            "osd_ec_fallback_quarantine_base", 1.0))
        cap = float(self.config.get(
            "osd_ec_fallback_quarantine_max", 30.0))
        backoff = min(base * (2 ** (self._dev_failures - 1)), cap)
        self._dev_q_until = time.monotonic() + backoff
        log.dout(0, f"device decode failed "
                    f"({type(e).__name__}: {str(e)[:200]}) — serving "
                    f"the reference decoder for {backoff:.2f}s")

    @staticmethod
    def _pad(b: int) -> int:
        """Next power of two: bounds the launch shapes to O(log)."""
        return 1 << (int(b) - 1).bit_length() if b > 1 else 1

    def _run(self, ec, want, avail, chunks, pad: bool = True):
        """One device launch over a (possibly padded) batch, read back;
        for a plugin on the CPU, while the device decode is quarantined,
        serves the reference decoder instead (bit-exact, so callers
        can't tell beyond latency)."""
        if not on_card(ec) and time.monotonic() < self._dev_q_until:
            self.perf.inc("quarantined_ops")
            return to_host(ec.decode_batch_reference(
                want, avail, chunks)).astype(np.uint8, copy=False)
        b = chunks.shape[0]
        padded = self._pad(b) if pad else b
        if padded != b:
            z = np.zeros((padded - b,) + chunks.shape[1:],
                         dtype=np.uint8)
            chunks = np.concatenate([chunks, z], axis=0)
        out = to_host(ec.decode_batch(want, avail, chunks))[:b]
        self._dev_failures = 0
        return out

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
                self.config.get("osd_ec_read_agg_window_us", 500)),
            "max_stripes": self.max_stripes(),
            "pending_groups": len(self._groups),
            "pending_ops": sum(len(g.entries)
                               for g in self._groups.values()),
            "batches": d.get("batches", 0),
            "stripes": d.get("stripes", 0),
            "ops": d.get("ops", 0),
            "bypass": d.get("bypass", 0),
            "fallback_ops": d.get("fallback_ops", 0),
            "quarantined_ops": d.get("quarantined_ops", 0),
            "qos_grants": d.get("qos_grants", 0),
            "flushes": {t: d.get(f"flush_{t}", 0)
                        for t in ("window", "full", "idle")},
            "avg_occupancy": (occ.get("sum", 0.0) /
                              occ.get("avgcount", 1)
                              if occ.get("avgcount") else 0.0),
            "avg_batch_wait_s": (wait.get("sum", 0.0) /
                                 wait.get("avgcount", 1)
                                 if wait.get("avgcount") else 0.0),
        }
