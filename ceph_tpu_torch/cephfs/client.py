"""CephFS client: metadata through the MDS, data direct to RADOS.

ref: src/client/Client.{h,cc} (the libcephfs backend) — every
namespace operation is an MClientRequest round-trip to the MDS; file
reads/writes go straight to the data objects, gated by the file
capabilities the MDS granted at open. A revoke arriving from the MDS
invalidates the handle (writers have nothing to flush — writes here
are write-through) and is acked immediately; the next I/O through
that handle re-opens to reacquire a cap, which blocks until the
conflicting holder is done — giving one-writer-or-many-readers
semantics across clients.

HA: a client mounted without a pinned MDS address
(``create(monmap, None, pool)``) subscribes to the **mdsmap** and
targets whatever daemons the FSMap says hold ranks. On failover it
sends MClientReconnect to the successor — replaying its session and
every live cap claim (ref: Client::send_reconnect) — and resends any
request that never got a reply (op replay; the MDS's completed-request
table dedups mutations that DID land before the crash). Requests
issued while no active exists park until the ladder finishes.

Multi-active routing (ref: Client::choose_target_mds + the
request-forwarding dance): every request is routed to the rank the
FSMap's subtree map says owns its path (longest-prefix match), with
sessions opened lazily per rank. A rank that does NOT own the path
answers -ESTALE naming the owner; the client records the redirect as
a routing hint (it may be ahead of its fsmap) and resends — hints are
retired once an fsmap that agrees arrives. Failover, reconnect, and
op-replay all run PER RANK, so one rank's takeover never stalls I/O
the other ranks are serving.

The port's copy of ``ceph_tpu/cephfs/client.py``. ``CephFSClient.create``
takes ``device=`` for the ``Rados`` it owns (CUDA unless ``"cpu"``; it
raises without a card): its data path maps PGs by ``crush_straw2`` on
the card. A client built on a given ``IoCtx`` runs where that ioctx's
``Rados`` does. One departure: the lease loop also renews the owned
``MonClient``'s subscriptions, so a client whose mon died and came back
empty still sees the next MDS failover (the reference's never does).
"""

from __future__ import annotations

import asyncio
import json

from ceph_tpu_torch.cephfs import FSError, _norm
from ceph_tpu_torch.cephfs.fsmap import (
    FSMap, STATE_ACTIVE, STATE_RECONNECT, STATE_REJOIN,
)
from ceph_tpu_torch.cephfs.mds import (
    CAP_FR, CAP_FW, CAP_OP_ACK, CAP_OP_RELEASE, CAP_OP_REVOKE, ESTALE,
    MClientCaps, MClientReconnect, MClientReply, MClientRequest,
    MClientSession, RECONNECT_ACK, RECONNECT_REQ,
    SESSION_CLOSE, SESSION_OPEN, SESSION_RENEW,
)
from ceph_tpu_torch.mon.messages import MMDSMap
from ceph_tpu_torch.msg import Dispatcher, Messenger
from ceph_tpu_torch.msg.messenger import ConnectionError_
from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("cephfs.client")

# fsmap states in which a rank holder accepts MClientReconnect
_RECONNECTABLE = (STATE_RECONNECT, STATE_REJOIN, STATE_ACTIVE)

# redirect chains longer than this mean the map is flapping under us;
# surface it instead of spinning
_MAX_REDIRECTS = 16


class FileHandle:
    """An open file + the cap that licenses its I/O."""

    def __init__(self, client: "CephFSClient", path: str, oid: str,
                 mode: int, cap_seq: int, size: int,
                 snap_id: int | None = None,
                 snapc: tuple[int, list[int]] | None = None):
        self.client = client
        self.path = path
        self.oid = oid
        self.mode = mode
        self.cap_seq = cap_seq
        self.size = size
        # snap_id: set for a handle opened THROUGH .snap — reads hit
        # the point-in-time clone, writes are refused. snapc: the snap
        # context the MDS granted with the open when the file sits
        # under one or more live snaprealms; stamped on every write so
        # the OSD COWs before the first post-snapshot mutation.
        self.snap_id = snap_id
        self.snapc = snapc
        self.valid = True

    async def _ensure(self) -> None:
        if not self.valid:
            fresh = await self.client.open_file(
                self.path, "w" if self.mode == CAP_FW else "r")
            self.__dict__.update(fresh.__dict__)
            # this handle now IS the reacquired cap; drop the twin so
            # _handles doesn't accumulate orphans (its registration
            # transfers to self)
            hs = self.client._handles.get(self.path, [])
            if fresh in hs:
                hs.remove(fresh)
            if self not in hs:
                hs.append(self)

    async def read(self, length: int = 0, offset: int = 0) -> bytes:
        await self._ensure()
        want = length or max(self.size - offset, 0)
        if want <= 0:
            return b""
        return await self.client.ioctx.read(self.oid, length=want,
                                            offset=offset,
                                            snap_id=self.snap_id)

    async def write(self, data: bytes, offset: int = 0) -> int:
        await self._ensure()
        if self.snap_id is not None:
            raise FSError(-30, "EROFS: snapshots are read-only")
        if self.mode != CAP_FW:
            raise FSError(-9, "handle not open for write")  # -EBADF
        # in-flight accounting: a revoke arriving mid-write must not be
        # acked until the data write AND its setattr have landed (the
        # "writers flush before acking" half of the cap contract)
        self.client._inflight[self.path] = \
            self.client._inflight.get(self.path, 0) + 1
        try:
            if offset:
                await self.client.ioctx.write(self.oid, data,
                                              offset=offset,
                                              snapc=self.snapc)
                self.size = max(self.size, offset + len(data))
            else:
                await self.client.ioctx.write_full(self.oid, data,
                                                   snapc=self.snapc)
                self.size = len(data)
            # dentry size rides a setattr through the MDS (metadata is
            # always MDS-authoritative)
            await self.client._request("setattr", self.path,
                                       flags=self.size)
        finally:
            self.client._inflight[self.path] -= 1
            if self.client._inflight[self.path] <= 0:
                self.client._inflight.pop(self.path, None)
        return len(data)

    async def close(self) -> None:
        hs = self.client._handles.get(self.path, [])
        if self in hs:
            hs.remove(self)
        if not hs:
            self.client._handles.pop(self.path, None)
        if self.valid:
            self.valid = False
            if self.snap_id is None:    # snap handles hold no cap
                await self.client._send_caps(CAP_OP_RELEASE, self.path,
                                             self.mode, self.cap_seq)


class CephFSClient(Dispatcher):
    """ref: libcephfs.h surface, MDS-backed."""

    _next_id = 0

    def __init__(self, ioctx, mds_addr=None,
                 messenger: Messenger | None = None):
        CephFSClient._next_id += 1
        self.ioctx = ioctx
        self.mds_addr = mds_addr       # pinned addr, or rank 0's (HA)
        self.msgr = messenger or Messenger(
            f"client.fs{CephFSClient._next_id}")
        self.msgr.add_dispatcher(self)
        self._tid = 0
        self._waiters: dict[int, asyncio.Future] = {}
        self._session_fut: asyncio.Future | None = None
        self._handles: dict[str, list[FileHandle]] = {}
        self._inflight: dict[str, int] = {}     # path -> writes in flight
        self._renew_task: asyncio.Task | None = None
        self._own_rados = None          # set by create(): owned identity
        self.lease_interval = 3.0       # renew beat; the OPEN ack's
                                        # advertised lease overrides it
        # HA state: fsmap-following mode (addresses resolved at runtime)
        self._ha = mds_addr is None
        self.fsmap: FSMap | None = None
        # -- per-rank session state --------------------------
        # rank -> current target address (the rank holder's)
        self._rank_addrs: dict[int, "object"] = {}
        # rank -> Event set while the rank is targetable; requests for
        # a rank mid-failover park on it (rank 0's doubles as the
        # mount gate)
        self._active_event = asyncio.Event()
        self._rank_events: dict[int, asyncio.Event] = {
            0: self._active_event}
        # ranks with an OPEN session; sessions open lazily per rank
        self._open_ranks: set[int] = set()
        # per-rank incarnation: bumped on every (re)established
        # session; _request resends exactly once per (rank,
        # incarnation) — op replay without duplicate sends to a
        # live-but-slow MDS
        self._rank_inc: dict[int, int] = {}
        # redirect-learned routing hints (subtree root -> rank):
        # a -ESTALE reply can be AHEAD of our fsmap; retired once an
        # fsmap that agrees arrives
        self._hints: dict[str, int] = {}
        self._session_lock = asyncio.Lock()     # one OPEN in flight
        self._reconnect_lock = asyncio.Lock()   # one rank reconnects
        self._reconnecting: set[int] = set()
        self._reconnect_fut: asyncio.Future | None = None
        # metadata-path tracing: share the data-path objecter's tracer
        # (one client identity, one span stream + one MTraceReport
        # flush path)
        self._objecter = ioctx.rados.objecter
        self.tracer = self._objecter.tracer
        if not self._ha:
            self._active_event.set()
            self._rank_addrs[0] = mds_addr

    @classmethod
    async def create(cls, monmap, mds_addr, pool: str,
                     keyring=None,
                     config: dict | None = None,
                     name: str | None = None,
                     device=None) -> "CephFSClient":
        """Mount with an OWN RADOS identity — the libcephfs model: ONE
        entity name carries both the MDS sessions and the data-path
        ops, so an MDS eviction's osd blocklist actually fences this
        client's data writes (data I/O through a shared admin ioctx
        would dodge the fence).

        ``mds_addr=None`` mounts in **HA mode**: the client subscribes
        to the mdsmap through its own MonClient and follows every
        rank's holder across failovers and subtree migrations instead
        of pinning one address.

        ``name`` pins the entity identity (a provisioned entity whose
        committed caps should bind at the MDS/OSD gates); default is a
        fresh ``client.fsN``.

        ``device`` is the owned ``Rados``'s: the maps the client follows
        decode there and its data path's placement lookups map there, by
        ``crush_straw2`` on the card. CUDA unless ``"cpu"``; it raises
        without a card."""
        from ceph_tpu_torch.rados import Rados
        from ceph_tpu_torch.utils.device import resolve
        device = resolve(device)
        CephFSClient._next_id += 1
        pinned = name is not None
        if name is None:
            name = f"client.fs{CephFSClient._next_id}"
        if keyring is not None:
            if pinned:
                # a pinned name is a PROVISIONED identity: its key
                # must already be in this keyring (auth get-or-create
                # committed and the MAuthUpdate push landed). Minting
                # a fresh key here would diverge from the mon's record
                # and fail far from the cause — fail loudly instead.
                if name not in keyring.keys:
                    from ceph_tpu_torch.msg.auth import AuthError
                    raise AuthError(
                        f"pinned entity {name} has no key in this "
                        "keyring — did its auth get-or-create commit "
                        "and propagate here yet?")
            else:
                keyring.add(name)
        # config reaches the owned objecter's tracer: without it a
        # cluster running trace_sampling_rate>0 would never see this
        # client's metadata/data roots (the cluster knobs only live in
        # daemon config dicts)
        r = Rados(monmap, name=name, keyring=keyring, config=config,
                  device=device)
        await r.connect()
        io = await r.open_ioctx(pool)
        # warm this identity's data path up front: its first op maps
        # its first PG, which on the card creates the CUDA context and
        # loads the crush_straw2 kernel, and would otherwise stall the
        # shared event loop mid-session (blowing MDS beacon graces
        # cluster-wide on an in-process cluster)
        from ceph_tpu_torch.rados import ObjectOperationError
        try:
            await io.stat(".fs_warmup")
        except ObjectOperationError:
            pass
        # the MDS-facing messenger matches the MDS's auth mode (the
        # MDS messenger carries no keyring); the DATA path — where the
        # blocklist fence bites — authenticates through the owned
        # Rados above. The shared identity is the entity NAME.
        cl = cls(io, mds_addr, messenger=Messenger(name))
        cl._own_rados = r
        if cl._ha:
            # MMDSMap publishes ride the MonClient's messenger
            r.monc.msgr.add_dispatcher(cl)
            await r.monc.subscribe("mdsmap", 0)
        return await cl.mount()

    # -- session -----------------------------------------------------------
    async def mount(self) -> "CephFSClient":
        if self._ha:
            await self._wait_active(timeout=30.0)
            await self._ensure_session(0, timeout=30.0)
        else:
            await self._open_session(0, self.mds_addr)
        # cap-lease heartbeat (ref: Client::renew_caps): without it the
        # MDS evicts us the moment a revoke finds our lease stale.
        self._renew_task = asyncio.ensure_future(self._renew_loop())
        return self

    async def _wait_active(self, timeout: float,
                           rank: int = 0) -> None:
        ev = self._rank_events.setdefault(rank, asyncio.Event())
        try:
            await asyncio.wait_for(ev.wait(), timeout=timeout)
        except asyncio.TimeoutError:
            raise FSError(-110, f"no active mds for rank {rank}") \
                from None

    async def _open_session(self, rank: int, addr) -> None:
        """One OPEN round-trip to ``addr``; on ack the rank is usable
        (serialized — replies carry no tid, so one OPEN at a time)."""
        async with self._session_lock:
            if rank in self._open_ranks and \
                    self._rank_addrs.get(rank) is addr:
                return
            self._session_fut = \
                asyncio.get_event_loop().create_future()
            await self.msgr.send_message(
                MClientSession(op=SESSION_OPEN, cseq=0), addr, "mds")
            ack = await asyncio.wait_for(self._session_fut, timeout=10)
            # the OPEN ack advertises the MDS lease (ms); renew at a
            # third of it so a short-leased MDS never sees a live
            # client go stale
            if getattr(ack, "cseq", 0):
                self.lease_interval = max(0.05, ack.cseq / 3000.0)
            self._rank_addrs[rank] = addr
            self._open_ranks.add(rank)
            self._rank_inc[rank] = self._rank_inc.get(rank, 0) + 1
            if rank == 0:
                self.mds_addr = addr
            self._rank_events.setdefault(rank, asyncio.Event()).set()

    async def _ensure_session(self, rank: int,
                              timeout: float = 10.0) -> None:
        """Open a session with ``rank`` if we don't have one (sessions
        are lazy: only ranks the subtree map actually routes us to get
        one — ref: Client opening sessions per chosen MDS)."""
        if rank in self._open_ranks:
            return
        await self._wait_active(timeout, rank)
        addr = self._rank_addrs.get(rank)
        if addr is None:
            raise FSError(-110, f"rank {rank} has no address")
        await self._open_session(rank, addr)

    async def _renew_loop(self) -> None:
        try:
            while True:
                await asyncio.sleep(self.lease_interval)
                if self._own_rados is not None:
                    # the mon holding our mdsmap/osdmap subscriptions may
                    # die and come back empty: renew them, as a daemon's
                    # idle loop does (ref: MonClient::tick -> renew_subs).
                    # Without it a failover after a mon's death is never
                    # seen and the sessions are never reconnected; the
                    # reference's client has no renewal (ROADMAP Queue C)
                    self._own_rados.monc.renew_subs()
                for rank in sorted(self._open_ranks):
                    addr = self._rank_addrs.get(rank)
                    if addr is None:
                        continue
                    try:
                        await self.msgr.send_message(
                            MClientSession(op=SESSION_RENEW, cseq=0),
                            addr, "mds")
                    except (ConnectionError, OSError,
                            ConnectionError_):
                        # transient (injected fault or mid-failover):
                        # a missed beat must NOT end the heartbeat — a
                        # silently dead renew loop gets a perfectly
                        # live client evicted at the next revoke
                        continue
        except asyncio.CancelledError:
            pass

    async def unmount(self) -> None:
        if self._renew_task is not None:
            self._renew_task.cancel()
            self._renew_task = None
        for hs in list(self._handles.values()):   # close() mutates the
            for h in list(hs):                    # dict and the lists
                await h.close()
        for rank in sorted(self._open_ranks):
            addr = self._rank_addrs.get(rank)
            if addr is None:
                continue
            try:
                async with self._session_lock:
                    self._session_fut = \
                        asyncio.get_event_loop().create_future()
                    await self.msgr.send_message(
                        MClientSession(op=SESSION_CLOSE, cseq=0),
                        addr, "mds")
                    await asyncio.wait_for(self._session_fut,
                                           timeout=10)
            except (ConnectionError, OSError, ConnectionError_,
                    asyncio.TimeoutError) as e:
                # best effort: the MDS may be mid-failover/dead; its
                # session-table grace machinery reaps us server-side
                log.dout(1, f"session close (rank {rank}) skipped: "
                            f"{e!r}")
        await self.msgr.shutdown()
        if self._own_rados is not None:
            await self._own_rados.shutdown()
            self._own_rados = None

    # -- dispatch ----------------------------------------------------------
    async def ms_dispatch(self, msg) -> bool:
        if isinstance(msg, MClientReply):
            fut = self._waiters.pop(msg.tid, None)
            if fut and not fut.done():
                fut.set_result(msg)
            return True
        if isinstance(msg, MClientSession):
            if msg.op != SESSION_RENEW and self._session_fut \
                    and not self._session_fut.done():
                self._session_fut.set_result(msg)
            return True
        if isinstance(msg, MClientReconnect):
            if self._reconnect_fut and not self._reconnect_fut.done():
                self._reconnect_fut.set_result(msg)
            return True
        if isinstance(msg, MMDSMap):
            self._on_fsmap(FSMap.decode(msg.fsmap))
            return True
        if isinstance(msg, MClientCaps):
            if msg.op == CAP_OP_REVOKE:
                # handled in a task: the ack must wait for in-flight
                # writes, whose setattr REPLIES arrive on this very
                # connection — blocking the reader here would deadlock
                asyncio.ensure_future(self._handle_revoke(msg))
            return True
        return False

    # -- routing (ref: Client::choose_target_mds) --------------------------
    def _route(self, path: str) -> int:
        """Owning rank for a normalized path: redirect hints overlay
        the fsmap's subtree map (a hint can be AHEAD of the map; equal
        or longer roots win)."""
        if not self._ha:
            return 0
        fm = self.fsmap
        best_rank, best_root = fm.subtree_owner(path) if fm is not None \
            else (0, "/")
        for root, rank in self._hints.items():
            if (path == root or path.startswith(root + "/")) and \
                    len(root) >= len(best_root):
                best_root, best_rank = root, rank
        return best_rank

    # -- failover (ref: Client::handle_mds_map + send_reconnect) ----------
    def _on_fsmap(self, fm: FSMap) -> None:
        if self.fsmap is not None and fm.epoch <= self.fsmap.epoch:
            return
        self.fsmap = fm
        # retire hints the authoritative map has caught up with
        for root in [r for r, rk in self._hints.items()
                     if fm.subtree_owner(r) == (rk, r)]:
            self._hints.pop(root, None)
        holders = fm.rank_holders()
        for rank in sorted(set(holders) | set(self._rank_addrs)
                           | self._open_ranks):
            if not self._ha:
                break
            info = holders.get(rank)
            ev = self._rank_events.setdefault(rank, asyncio.Event())
            if info is None or info.state not in _RECONNECTABLE:
                # rank failed / mid-ladder with no reconnectable
                # successor: park its requests until one appears
                if rank in self._open_ranks:
                    ev.clear()
                continue
            addr = info.addr()
            cur = self._rank_addrs.get(rank)
            if cur is not None and (addr.host, addr.port) == \
                    (cur.host, cur.port):
                ev.set()
                continue
            if rank not in self._open_ranks:
                # no session yet: just aim (a session opens lazily the
                # first time a request routes here)
                if info.state == STATE_ACTIVE:
                    self._rank_addrs[rank] = addr
                    if rank == 0:
                        self.mds_addr = addr
                    ev.set()
                continue
            # holder changed for a rank we hold a session with:
            # reconnect (cap replay) against the successor
            ev.clear()
            asyncio.ensure_future(self._reconnect_rank(rank))

    async def _reconnect_rank(self, rank: int) -> None:
        """Re-establish this rank's session against whatever daemon
        now holds it: replay cap claims for the paths the rank serves
        (MClientReconnect), or on reject (session missed the window)
        open a fresh session with every affected handle invalidated.
        One loop per rank at a time; each attempt re-reads the fsmap
        so back-to-back failovers re-aim it."""
        if rank in self._reconnecting:
            return
        self._reconnecting.add(rank)
        try:
            for attempt in range(120):
                holder = self.fsmap.rank_holder(rank) if self.fsmap \
                    else None
                if holder is None or \
                        holder.state not in _RECONNECTABLE:
                    await asyncio.sleep(0.1)
                    continue
                addr = holder.addr()
                caps = {}
                for path, hs in self._handles.items():
                    if self._route(path) != rank:
                        continue
                    live = [h for h in hs if h.valid]
                    if not live:
                        continue
                    caps[path] = json.dumps({
                        "mode": max(h.mode for h in live),
                        "count": len(live),
                        "cseq": max(h.cap_seq for h in live),
                    }).encode()
                async with self._reconnect_lock:
                    self._reconnect_fut = \
                        asyncio.get_event_loop().create_future()
                    try:
                        await self.msgr.send_message(MClientReconnect(
                            op=RECONNECT_REQ, caps=caps), addr, "mds")
                        rep = await asyncio.wait_for(
                            self._reconnect_fut, timeout=5.0)
                    except (ConnectionError, OSError,
                            ConnectionError_, asyncio.TimeoutError):
                        await asyncio.sleep(0.1)
                        continue
                self._rank_addrs[rank] = addr
                if rank == 0:
                    self.mds_addr = addr
                if rep.op == RECONNECT_ACK:
                    log.dout(1, f"reconnected to rank {rank} at "
                                f"{addr} ({len(caps)} caps replayed)")
                else:
                    # session unknown (missed the reconnect window):
                    # this rank's caps are dead — invalidate every
                    # affected handle (next I/O reacquires) and open a
                    # fresh session
                    log.dout(1, f"reconnect to rank {rank} rejected "
                                f"by {addr}; re-opening session")
                    for path, hs in self._handles.items():
                        if self._route(path) != rank:
                            continue
                        for h in hs:
                            h.valid = False
                    self._open_ranks.discard(rank)
                    try:
                        await self._open_session(rank, addr)
                    except (ConnectionError, OSError,
                            ConnectionError_,
                            asyncio.TimeoutError):
                        await asyncio.sleep(0.1)
                        continue
                # wake request loops: they resend once per incarnation
                self._open_ranks.add(rank)
                self._rank_inc[rank] = self._rank_inc.get(rank, 0) + 1
                self._rank_events.setdefault(
                    rank, asyncio.Event()).set()
                return
            log.dout(0, f"rank {rank} reconnect gave up after retries")
        finally:
            self._reconnecting.discard(rank)

    async def _handle_revoke(self, msg) -> None:
        for h in self._handles.get(msg.path, []):
            h.valid = False         # future I/O must reacquire first
        while self._inflight.get(msg.path, 0) > 0:
            await asyncio.sleep(0.01)   # writers flush before the ack
        await msg.conn.send_message(MClientCaps(
            op=CAP_OP_ACK, path=msg.path, mode=msg.mode,
            cseq=msg.cseq))

    async def _send_caps(self, op: int, path: str, mode: int,
                         seq: int) -> None:
        rank = self._route(_norm(path))
        addr = self._rank_addrs.get(rank) or self.mds_addr
        if addr is None:
            # rank mid-failover with no successor yet: a RELEASE is
            # advisory (the MDS reaps dead holders via the cap lease)
            log.dout(5, f"cap send skipped: no addr for rank {rank}")
            return
        await self.msgr.send_message(
            MClientCaps(op=op, path=path, mode=mode, cseq=seq),
            addr, "mds")

    # -- requests ----------------------------------------------------------
    async def _request(self, op: str, path: str, path2: str = "",
                       flags: int = 0,
                       timeout: float = 40.0) -> MClientReply:
        self._tid += 1
        tid = self._tid
        npath = _norm(path)
        loop = asyncio.get_event_loop()
        fut = loop.create_future()
        self._waiters[tid] = fut
        msg = MClientRequest(tid=tid, op=op, path=path, path2=path2,
                             flags=flags)
        # metadata-path root span (op_class "metadata"): propagates to
        # the serving rank; -ESTALE redirect hops are tagged so a
        # cross-rank bounce is visible in the reassembled trace
        span = self.tracer.start_root(
            "mds_req", tags={"op": op, "path": npath,
                             "op_class": "metadata"})
        msg.set_trace(span)
        deadline = loop.time() + timeout
        sent_key = None
        redirects = 0
        try:
            while True:
                if fut.done():
                    reply = fut.result()
                    if self._ha and reply.result == ESTALE:
                        # redirect: the serving rank named the owner —
                        # record the hint, re-arm the waiter, resend
                        # to the right rank (same tid: the redirecting
                        # rank executed nothing)
                        redirects += 1
                        if redirects > _MAX_REDIRECTS:
                            raise FSError(
                                ESTALE, f"{op} {path}: redirect loop "
                                        f"(map flapping?)")
                        try:
                            hint = json.loads(reply.payload)
                            self._hints[str(hint["path"])] = \
                                int(hint["rank"])
                        except (json.JSONDecodeError, KeyError,
                                ValueError, TypeError):
                            pass
                        fut = loop.create_future()
                        self._waiters[tid] = fut
                        sent_key = None
                        continue
                    break
                remaining = deadline - loop.time()
                if remaining <= 0:
                    raise asyncio.TimeoutError
                rank = self._route(npath)
                if self._ha:
                    ev = self._rank_events.setdefault(
                        rank, asyncio.Event())
                    if not ev.is_set():
                        # failover in progress: park until a successor
                        # is reachable, then fall through to resend
                        try:
                            await asyncio.wait_for(
                                ev.wait(),
                                timeout=min(remaining, 1.0))
                        except asyncio.TimeoutError:
                            continue      # re-route: hint/map may have
                        continue          # moved the path meanwhile
                    if rank not in self._open_ranks:
                        try:
                            await self._ensure_session(
                                rank, timeout=min(remaining, 10.0))
                        except (FSError, ConnectionError, OSError,
                                ConnectionError_,
                                asyncio.TimeoutError):
                            await asyncio.sleep(0.2)
                        continue
                    addr = self._rank_addrs.get(rank)
                    key = (rank, self._rank_inc.get(rank, 0))
                else:
                    addr = self.mds_addr
                    key = (0, 0)
                if sent_key != key and addr is not None:
                    # op replay: exactly one send per (rank, MDS
                    # incarnation) — the successor's completed-request
                    # table dedups mutations that landed before the
                    # crash, and a live-but-slow MDS is never spammed
                    # with duplicates (a duplicate open would leak a
                    # cap refcount)
                    try:
                        await self.msgr.send_message(msg, addr, "mds")
                        sent_key = key
                    except (ConnectionError, OSError,
                            ConnectionError_):
                        if not self._ha:
                            raise
                        await asyncio.sleep(0.2)
                        continue
                try:
                    reply = await asyncio.wait_for(
                        asyncio.shield(fut),
                        timeout=min(1.0, max(remaining, 0.05)))
                    if not (self._ha and reply.result == ESTALE):
                        break
                    # loop top handles the redirect bookkeeping
                except asyncio.TimeoutError:
                    continue
        finally:
            self._waiters.pop(tid, None)
            if span is not None:
                if redirects:
                    span.tag("redirects", redirects)
                span.finish()
            self._objecter.flush_traces()
        if reply.result < 0:
            raise FSError(int(reply.result),
                          reply.payload.decode(errors="replace"))
        return reply

    # -- namespace (ref: libcephfs.h) --------------------------------------
    async def mkdir(self, path: str) -> None:
        await self._request("mkdir", path)

    async def rmdir(self, path: str) -> None:
        await self._request("rmdir", path)

    async def ls(self, path: str = "/") -> list[str]:
        r = await self._request("readdir", path)
        return json.loads(r.payload)

    async def stat(self, path: str) -> dict:
        r = await self._request("stat", path)
        return json.loads(r.payload)

    async def unlink(self, path: str) -> None:
        await self._request("unlink", path)

    async def rename(self, src: str, dst: str) -> None:
        await self._request("rename", src, path2=dst)

    # -- files (cap-gated) -------------------------------------------------
    async def open_file(self, path: str, mode: str = "r") -> FileHandle:
        """'r' wants shared-read; 'w' wants exclusive-write (creating
        the file if absent). Blocks while conflicting caps are being
        revoked from other clients."""
        path = _norm(path)        # cap/revoke bookkeeping is keyed on
        want = CAP_FW if mode == "w" else CAP_FR   # the normalized path
        r = await self._request("open", path, flags=want)
        info = json.loads(r.payload)
        # the handle keeps the REQUESTED mode, not the granted one: a
        # reader whose client happens to hold FW must neither pass the
        # write check nor reacquire exclusivity after a revoke
        snapc = info.get("snapc")
        h = FileHandle(self, path, info["oid"], want,
                       int(r.cap_seq), int(info["size"]),
                       snap_id=info.get("snapid"),
                       snapc=(int(snapc[0]), [int(s) for s in snapc[1]])
                       if snapc else None)
        self._handles.setdefault(h.path, []).append(h)
        return h

    async def read_file(self, path: str) -> bytes:
        h = await self.open_file(path, "r")
        try:
            return await h.read()
        finally:
            await h.close()

    async def write_file(self, path: str, data: bytes) -> int:
        h = await self.open_file(path, "w")
        try:
            return await h.write(data)
        finally:
            await h.close()
