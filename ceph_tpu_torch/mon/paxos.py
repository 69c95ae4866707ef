"""Paxos: the mon quorum's replicated commit log.

ref: src/mon/Paxos.{h,cc} — same protocol shape as the reference's
multi-Paxos with a stable leader:

- after an election the leader runs a COLLECT/LAST round (phase 1) with
  a proposal number unique to (counter, rank); peons surrender any
  uncommitted value and report last_committed so the leader can share
  missing commits (ref: Paxos::collect / handle_last + share_state);
- each value is committed with BEGIN/ACCEPT/COMMIT (phase 2); like the
  reference, a value commits only when EVERY quorum member accepts —
  mons outside the quorum rejoin through the next election's collect;
- values are encoded MonitorDBStore transactions; committing version v
  applies the transaction, so every mon's kv is a replica of the log
  prefix (ref: Paxos::commit_finish applying to MonitorDBStore);
- the leader extends its authority with LEASE messages; a peon whose
  lease expires calls a new election (ref: Paxos::lease_timeout).

Fail-stop model (matching the reference's deployment assumptions):
monitors crash and restart with their store intact; no byzantine peers.

The port's copy of ``ceph_tpu/mon/paxos.py``.
"""

from __future__ import annotations

import asyncio

from ceph_tpu_torch.mon.messages import (
    MMonPaxos, PAXOS_ACCEPT, PAXOS_BEGIN, PAXOS_CATCHUP, PAXOS_COLLECT,
    PAXOS_COMMIT, PAXOS_LAST, PAXOS_LEASE,
)
from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("paxos")

P = "paxos"      # store prefix


class Paxos:
    def __init__(self, mon) -> None:
        self.mon = mon                    # Monitor (send/quorum provider)
        self.store = mon.store
        self.last_committed = self.store.get_u64(P, "last_committed")
        self.accepted_pn = self.store.get_u64(P, "accepted_pn")
        # uncommitted value carried across leader changes
        self.uncommitted: tuple[int, int, bytes] | None = None
        uc_v = self.store.get_u64(P, "uc_version")
        if uc_v:
            self.uncommitted = (uc_v, self.store.get_u64(P, "uc_pn"),
                                self.store.get(P, "uc_value") or b"")
        self.active = False               # phase 1 done (leader or peon)
        self.pn = 0                       # leader's proposal number
        self._collect_waiter: asyncio.Future | None = None
        self._collected: set[int] = set()
        self._accept_waiter: asyncio.Future | None = None
        self._accepted_by: set[int] = set()
        self._pending_version = 0
        self._propose_lock = asyncio.Lock()
        self.lease_deadline = 0.0

    # -- helpers -----------------------------------------------------------
    def _vkey(self, v: int) -> str:
        return f"v:{v:016x}"

    def _store_committed(self, version: int, value: bytes) -> None:
        t = self.store.transaction()
        t.set(P, self._vkey(version), value)
        self.store.put_u64(t, P, "last_committed", version)
        # clear uncommitted if this commit supersedes it
        self.store.put_u64(t, P, "uc_version", 0)
        self.store.apply(t)
        self.last_committed = version
        self.uncommitted = None
        self.mon.apply_paxos_value(version, value)

    def _store_uncommitted(self, version: int, pn: int,
                           value: bytes) -> None:
        t = self.store.transaction()
        self.store.put_u64(t, P, "uc_version", version)
        self.store.put_u64(t, P, "uc_pn", pn)
        t.set(P, "uc_value", value)
        self.store.apply(t)
        self.uncommitted = (version, pn, value)

    def _store_pn(self, pn: int) -> None:
        t = self.store.transaction()
        self.store.put_u64(t, P, "accepted_pn", pn)
        self.store.apply(t)
        self.accepted_pn = pn

    def get_version(self, v: int) -> bytes | None:
        return self.store.get(P, self._vkey(v))

    # -- leader: phase 1 ---------------------------------------------------
    async def leader_collect(self) -> bool:
        """Run COLLECT; returns True when the quorum is synchronized and
        this paxos is active (ref: Paxos::collect)."""
        self.active = False
        # pn unique to this (attempt, rank)
        self.pn = ((max(self.accepted_pn, self.pn) // 100 + 1) * 100
                   + self.mon.rank)
        self._store_pn(self.pn)
        self._collected = {self.mon.rank}
        peons = [r for r in self.mon.quorum if r != self.mon.rank]
        if not peons:
            await self._finish_collect()
            return True
        fut = asyncio.get_event_loop().create_future()
        self._collect_waiter = fut
        for r in peons:
            await self.mon.send_mon(r, MMonPaxos(
                op=PAXOS_COLLECT, pn=self.pn,
                last_committed=self.last_committed, version=0, value=b"",
                uncommitted_pn=0, extra={}))
        try:
            await asyncio.wait_for(fut, timeout=self.mon.paxos_timeout)
        except asyncio.TimeoutError:
            log.dout(1, f"mon.{self.mon.rank} collect timed out")
            return False
        finally:
            self._collect_waiter = None
        await self._finish_collect()
        return True

    async def _finish_collect(self) -> None:
        # re-propose any surrendered uncommitted value (ref: collect
        # finishing with uncommitted -> begin); under the propose lock
        # so a concurrent propose() cannot reuse the same version
        async with self._propose_lock:
            self.active = True
            if self.uncommitted is not None and \
                    self.uncommitted[0] == self.last_committed + 1:
                version, _pn, value = self.uncommitted
                await self._begin(version, value)

    async def handle_collect(self, m: MMonPaxos) -> None:
        """Peon side (ref: Paxos::handle_collect)."""
        if m.pn < self.accepted_pn:
            return  # stale proposer; ignore (it will time out)
        self._store_pn(m.pn)
        self.active = True                # synchronized under this pn
        uc_v, uc_pn, uc_val = 0, 0, b""
        if self.uncommitted is not None and \
                self.uncommitted[0] > m.last_committed:
            uc_v, uc_pn, uc_val = self.uncommitted
        # share commits the proposer may be missing — and learn ours
        extra: dict[int, bytes] = {}
        for v in range(m.last_committed + 1, self.last_committed + 1):
            blob = self.get_version(v)
            if blob is not None:
                extra[v] = blob
        reply = MMonPaxos(op=PAXOS_LAST, pn=m.pn,
                          last_committed=self.last_committed,
                          version=uc_v, value=uc_val,
                          uncommitted_pn=uc_pn, extra=extra)
        await self.mon.send_mon(m.src_rank, reply)

    async def handle_last(self, m: MMonPaxos) -> None:
        """Leader side (ref: Paxos::handle_last)."""
        if m.pn != self.pn:
            return
        # adopt any commits a peon has that we lack
        for v in sorted(m.extra):
            if v == self.last_committed + 1:
                self._store_committed(v, m.extra[v])
        # adopt the highest-pn uncommitted value
        if m.version == self.last_committed + 1 and \
                (self.uncommitted is None or
                 m.uncommitted_pn >= self.uncommitted[1]):
            self._store_uncommitted(m.version, m.uncommitted_pn, m.value)
        # bring lagging peons up to date (share_state)
        if m.last_committed < self.last_committed:
            for v in range(m.last_committed + 1, self.last_committed + 1):
                blob = self.get_version(v)
                if blob is not None:
                    await self.mon.send_mon(m.src_rank, MMonPaxos(
                        op=PAXOS_COMMIT, pn=self.pn,
                        last_committed=self.last_committed, version=v,
                        value=blob, uncommitted_pn=0, extra={}))
        self._collected.add(m.src_rank)
        if self._collect_waiter and not self._collect_waiter.done() and \
                self._collected >= set(self.mon.quorum):
            self._collect_waiter.set_result(True)

    # -- leader: phase 2 ---------------------------------------------------
    async def propose(self, value: bytes) -> bool:
        """Commit one value through the quorum; returns True on commit
        (ref: Paxos::propose_pending + begin/commit cycle).

        Emits its own span family (round 11; without it mon commit
        latency was opaque): a ``paxos_propose`` root with
        ``paxos_accept_wait`` (BEGIN -> all ACCEPTs) and
        ``paxos_commit`` (store apply + COMMIT fan-out) children, so
        `trace show` decomposes a slow commit into quorum round-trip
        vs store time. The decomposition needs head sampling
        (``trace_sampling_rate`` > 0): an UNSAMPLED root is
        local-only, and per the tracing layer's design children of a
        local-only root are never created — tail retention still
        keeps the lone root of a slow commit, so SLOW commits stay
        visible at sampling 0, just not decomposed."""
        async with self._propose_lock:
            if not (self.mon.is_leader() and self.active):
                return False
            tracer = getattr(self.mon, "tracer", None)
            span = tracer.start_root(
                "paxos_propose",
                tags={"version": self.last_committed + 1,
                      "bytes": len(value),
                      "quorum": list(self.mon.quorum)}) \
                if tracer is not None else None
            try:
                return await self._begin(self.last_committed + 1,
                                         value, span)
            finally:
                if span is not None:
                    span.finish()

    async def _begin(self, version: int, value: bytes,
                     span=None) -> bool:
        self._store_uncommitted(version, self.pn, value)
        self._accepted_by = {self.mon.rank}
        self._pending_version = version
        peons = [r for r in self.mon.quorum if r != self.mon.rank]
        # children only for SAMPLED roots: a local-only (trace_id 0)
        # root's children would be dropped — or worse, tail-promoted
        # under a DIFFERENT fresh trace id than the root's, producing
        # orphan spans that never reassemble (tracing.py's design
        # note: children of local-only roots are not created)
        traced = span is not None and span.trace_id
        if peons:
            fut = asyncio.get_event_loop().create_future()
            self._accept_waiter = fut
            accept_span = span.child(
                "paxos_accept_wait", tags={"peons": peons}) \
                if traced else None
            for r in peons:
                await self.mon.send_mon(r, MMonPaxos(
                    op=PAXOS_BEGIN, pn=self.pn,
                    last_committed=self.last_committed, version=version,
                    value=value, uncommitted_pn=0, extra={}))
            try:
                await asyncio.wait_for(fut,
                                       timeout=self.mon.paxos_timeout)
            except asyncio.TimeoutError:
                log.dout(1, f"mon.{self.mon.rank} begin v{version} "
                            f"timed out; calling election")
                self._accept_waiter = None
                self.active = False
                if accept_span is not None:
                    accept_span.tag("timed_out", True).finish()
                self.mon.request_election()
                return False
            finally:
                self._accept_waiter = None
            if accept_span is not None and not accept_span.finished:
                accept_span.finish()
        # all quorum members accepted: commit
        commit_span = span.child("paxos_commit") if traced else None
        self._store_committed(version, value)
        for r in peons:
            await self.mon.send_mon(r, MMonPaxos(
                op=PAXOS_COMMIT, pn=self.pn,
                last_committed=self.last_committed, version=version,
                value=value, uncommitted_pn=0, extra={}))
        if commit_span is not None:
            commit_span.finish()
        return True

    async def handle_begin(self, m: MMonPaxos) -> None:
        """Peon (ref: Paxos::handle_begin)."""
        if m.pn < self.accepted_pn:
            return
        self._store_uncommitted(m.version, m.pn, m.value)
        await self.mon.send_mon(m.src_rank, MMonPaxos(
            op=PAXOS_ACCEPT, pn=m.pn,
            last_committed=self.last_committed, version=m.version,
            value=b"", uncommitted_pn=0, extra={}))

    async def handle_accept(self, m: MMonPaxos) -> None:
        """Leader (ref: Paxos::handle_accept)."""
        if m.pn != self.pn or m.version != self._pending_version:
            return
        self._accepted_by.add(m.src_rank)
        if self._accept_waiter and not self._accept_waiter.done() and \
                self._accepted_by >= set(self.mon.quorum):
            self._accept_waiter.set_result(True)

    async def handle_commit(self, m: MMonPaxos) -> None:
        """Peon applies a committed value (ref: Paxos::handle_commit).
        Out-of-order commits (possible during share_state) are applied
        only when contiguous."""
        if m.version == self.last_committed + 1:
            self._store_committed(m.version, m.value)
        elif m.version > self.last_committed + 1:
            # gap: stash and let collect/share fill it next election; ask
            # nothing here (leader share_state already streams in order)
            log.dout(5, f"mon.{self.mon.rank} commit gap at v{m.version} "
                        f"(have {self.last_committed})")

    async def handle_lease(self, m: MMonPaxos) -> None:
        self.lease_deadline = asyncio.get_event_loop().time() + \
            self.mon.lease_timeout
        # a lost COMMIT shows up as the leader's last_committed running
        # ahead: ask it to re-stream the missing versions
        # (ref: Paxos::handle_lease -> store_state catch-up)
        if m.last_committed > self.last_committed:
            await self.mon.send_mon(m.src_rank, MMonPaxos(
                op=PAXOS_CATCHUP, pn=m.pn,
                last_committed=self.last_committed, version=0, value=b"",
                uncommitted_pn=0, extra={}))

    async def handle_catchup(self, m: MMonPaxos) -> None:
        """Leader re-streams commits a lagging peon is missing."""
        if not self.mon.is_leader():
            return
        for v in range(m.last_committed + 1, self.last_committed + 1):
            blob = self.get_version(v)
            if blob is not None:
                await self.mon.send_mon(m.src_rank, MMonPaxos(
                    op=PAXOS_COMMIT, pn=self.pn,
                    last_committed=self.last_committed, version=v,
                    value=blob, uncommitted_pn=0, extra={}))

    async def send_lease(self) -> None:
        for r in self.mon.quorum:
            if r != self.mon.rank:
                await self.mon.send_mon(r, MMonPaxos(
                    op=PAXOS_LEASE, pn=self.pn,
                    last_committed=self.last_committed, version=0,
                    value=b"", uncommitted_pn=0, extra={}))

    async def dispatch(self, m: MMonPaxos) -> None:
        handler = {
            PAXOS_COLLECT: self.handle_collect,
            PAXOS_LAST: self.handle_last,
            PAXOS_BEGIN: self.handle_begin,
            PAXOS_ACCEPT: self.handle_accept,
            PAXOS_COMMIT: self.handle_commit,
            PAXOS_LEASE: self.handle_lease,
            PAXOS_CATCHUP: self.handle_catchup,
        }[m.op]
        await handler(m)
