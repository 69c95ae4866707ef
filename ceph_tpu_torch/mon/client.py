"""MonClient: the daemons'/clients' window into the monitor cluster.

ref: src/mon/MonClient.{h,cc} — connects to a monitor, authenticates
(messenger handshake), sends commands with leader-redirect retry,
subscribes to maps, and maintains the local OSDMap by applying
published incrementals (ref: MonClient::_send_command hunting +
sub_want/renew_subs; Objecter applies the maps).

The port's copy of ``ceph_tpu/mon/client.py``. A ``MonClient`` decodes
the maps it follows onto ``device`` (CUDA unless ``device="cpu"``; it
raises without a card), so with ``track_mapping`` its table's sweeps and
delta remaps run the CRUSH kernel there; with ``mapping_mesh`` set, the
table's full sweeps run sharded over that device mesh.
"""

from __future__ import annotations

import asyncio
import json

from ceph_tpu_torch.encoding import decode_incremental, decode_osdmap
from ceph_tpu_torch.mon.messages import (
    MAuthUpdate, MConfigMap, MLog, MMDSMap, MMgrMap, MMonCommand,
    MMonCommandAck, MMonMap, MMonSubscribe, MOSDMap,
)
from ceph_tpu_torch.mon.monitor import MonMap
from ceph_tpu_torch.msg import (AuthError, Dispatcher, Keyring,
                                Messenger)
from ceph_tpu_torch.msg.messenger import ConnectionError_
from ceph_tpu_torch.utils.device import resolve
from ceph_tpu_torch.utils.logging import get_logger

log = get_logger("monc")


class MonClient(Dispatcher):
    def __init__(self, name: str, monmap: MonMap,
                 keyring: Keyring | None = None,
                 messenger: Messenger | None = None,
                 device=None):
        self.name = name
        # where every map this client decodes runs its CRUSH step
        self.device = resolve(device)
        self.monmap = monmap
        self.msgr = messenger or Messenger(name, keyring=keyring)
        self.msgr.add_dispatcher(self)
        self._tid = 0
        self._command_waiters: dict[int, asyncio.Future] = {}
        self._cur_rank = self.monmap.ranks()[0]
        # subscriptions live on the mon session that registered them:
        # after hunting to another mon they must be re-wanted there or
        # map publishes stop forever (ref: MonClient::_reopen_session
        # + renew_subs — the round-4 deep-thrash leader-kill stall)
        self._subs: dict[str, int] = {}
        self._sub_rank: int | None = None
        self._last_renew = 0.0
        self.osdmap = None
        self._osdmap_waiters: list[asyncio.Future] = []
        self.map_callbacks: list = []          # async fn(osdmap)
        # the committed MgrMap (round 12): daemons follow it to find
        # the ACTIVE mgr for their perf-counter report session — an
        # epoch naming a new active is the re-open signal
        self.mgrmap = None
        # the central config db (round 18): the decoded MConfigMap
        # mask map + version; callbacks (sync fns) fire per map so a
        # daemon applies live knob flips into its own process
        self.config_map: dict | None = None
        self.config_version = 0
        self.config_callbacks: list = []       # fn(cfgmap: dict)
        # opt-in full-cluster mapping table (OSD daemons set this):
        # delta-maintained per epoch and attached to the map so the
        # holder's bulk advance-map placement reads come from the
        # table instead of re-running the mapper every epoch
        self.track_mapping = False
        self._mapping = None
        # optional extras for the tracked table: a device mesh (full
        # sweeps go mesh-sharded) and a Tracer (crush_sweep spans); the
        # owning daemon sets these before the first tracked map
        self.mapping_mesh = None
        self.mapping_tracer = None
        # the owning daemon's DeviceRuntimeMonitor (round 14):
        # tracked-table sweeps record per-daemon kernel-path health
        self.mapping_devmon = None

    @property
    def mapping_table(self):
        """The maintained OSDMapMapping (None until the first tracked
        map arrives) — the public read for status/introspection."""
        return self._mapping

    # -- dispatch ----------------------------------------------------------
    async def ms_dispatch(self, msg) -> bool:
        if isinstance(msg, MMonCommandAck):
            fut = self._command_waiters.pop(msg.tid, None)
            if fut and not fut.done():
                fut.set_result((msg.retcode, msg.rs, msg.outbl))
            return True
        if isinstance(msg, MOSDMap):
            await self._handle_osdmap(msg)
            return True
        if isinstance(msg, MMonMap):
            self._handle_monmap(MonMap.decode(msg.monmap))
            return True
        if isinstance(msg, MAuthUpdate):
            self._handle_auth_update(msg)
            return True
        if isinstance(msg, MMgrMap):
            from ceph_tpu_torch.mon.mgr_monitor import MgrMap
            if "mgrmap" in self._subs:
                self._subs["mgrmap"] = max(self._subs["mgrmap"],
                                           msg.epoch + 1)
            mm = MgrMap.decode(msg.mgrmap)
            # never regress: a lagging peon can answer with an old map
            if self.mgrmap is None or mm.epoch >= self.mgrmap.epoch:
                self.mgrmap = mm
            return True
        if isinstance(msg, MMDSMap):
            # cursor only — the cephfs dispatchers consume the map;
            # tracking it here keeps periodic sub renewal from
            # re-requesting epochs already delivered
            if "mdsmap" in self._subs:
                self._subs["mdsmap"] = max(self._subs["mdsmap"],
                                           msg.epoch + 1)
        if isinstance(msg, MConfigMap):
            self._handle_config_map(msg)
            return True
        return False

    def _handle_monmap(self, mm: MonMap) -> None:
        """Follow committed monmap epochs (ref: MonClient::
        handle_monmap). Never regress to an older epoch — a lagging
        peon can answer a subscription with a stale map. This is the
        round-6 bugfix for the pinned-address-list bug: hunting and
        reconnects below consume THIS map, so a fully rotated mon set
        (every boot-time mon replaced at runtime) no longer strands
        the client dialing dead addresses."""
        if self.monmap.epoch and mm.epoch <= self.monmap.epoch:
            # includes epoch-0 maps: a freshly added joiner publishes
            # its PROVISIONAL (uncommitted, epoch 0) map until its
            # paxos sync lands — once we follow a committed lineage,
            # only strictly newer epochs may replace it
            return
        self.monmap = mm
        ranks = self.monmap.ranks()
        if ranks and self._cur_rank not in ranks:
            # our session mon was removed: hunt to a live member
            self._cur_rank = ranks[0]
            self._sub_rank = None        # its subs died with it
        if self._sub_rank is not None and self._sub_rank not in ranks:
            self._sub_rank = None

    def _next_rank(self, rank: int) -> int:
        """The hunt successor of ``rank`` in the CURRENT monmap —
        tolerant of the rank having been removed mid-hunt."""
        ranks = self.monmap.ranks()
        if not ranks:
            return rank
        if rank not in ranks:
            return ranks[0]
        return ranks[(ranks.index(rank) + 1) % len(ranks)]

    def _handle_config_map(self, m: MConfigMap) -> None:
        """Apply a published config-db version: cursor forward, decode
        the mask map, fan out to the owning daemon's callbacks (which
        do the per-entity resolution)."""
        if "config" in self._subs:
            self._subs["config"] = max(self._subs["config"],
                                       m.version + 1)
        if m.version < self.config_version and \
                self.config_map is not None:
            return              # a lagging peon answered with old state
        self.config_version = m.version
        try:
            cfgmap = json.loads(m.cfgmap.decode()) if m.cfgmap else {}
        except (json.JSONDecodeError, UnicodeDecodeError):
            return
        self.config_map = cfgmap
        for cb in self.config_callbacks:
            try:
                cb(cfgmap)
            except Exception:
                log.dout(1, "config callback failed")

    def _handle_auth_update(self, m: MAuthUpdate) -> None:
        """Apply a published key table to the live keyring: install/
        rotate secrets, fence revoked entities (empty secret). The
        keyring's observers do the session-level work."""
        if "keyring" in self._subs:
            self._subs["keyring"] = max(self._subs["keyring"],
                                        m.version + 1)
        kr = self.msgr.keyring
        if kr is None:
            return
        for name, secret in m.keys.items():
            if secret:
                kr.set_key(name, secret)
            else:
                kr.revoke(name)
        for name, blob in getattr(m, "caps", {}).items():
            try:
                kr.set_caps(name, json.loads(blob) if blob else {})
            except (json.JSONDecodeError, TypeError):
                pass

    async def _handle_osdmap(self, m: MOSDMap) -> None:
        if m.full:
            epoch = max(m.full)
            # never regress: a lagging peon may answer with an old full
            if self.osdmap is None or epoch > self.osdmap.epoch:
                self.osdmap = decode_osdmap(m.full[epoch],
                                            device=self.device)
        gap = False
        for e in sorted(m.incrementals):
            if self.osdmap is not None and \
                    e == self.osdmap.epoch + 1:
                self.osdmap.apply_incremental(
                    decode_incremental(m.incrementals[e]))
            elif self.osdmap is not None and e > self.osdmap.epoch + 1:
                gap = True
        if gap and self.osdmap is not None:
            # publishes we never received (dropped frames / a flaky
            # link): the mon's cursor moved past us, so without a
            # re-want we would ignore every future inc and stay stale
            # forever (ref: MonClient::sub_want + renew_subs — subs
            # are re-requested, not assumed delivered)
            log.dout(1, f"osdmap inc gap at {self.osdmap.epoch}; "
                        f"re-subscribing")
            asyncio.ensure_future(
                self.subscribe("osdmap", self.osdmap.epoch + 1))
        if self.track_mapping and self.osdmap is not None:
            # table BEFORE waiters/callbacks: the consumers' bulk
            # placement reads in the same wakeup should hit it
            if self._mapping is None:
                from ceph_tpu_torch.osd.osdmap_mapping import OSDMapMapping
                self._mapping = OSDMapMapping(
                    mesh=self.mapping_mesh,
                    tracer=self.mapping_tracer,
                    devmon=self.mapping_devmon)
            self._mapping.update(self.osdmap)
            self.osdmap.attach_mapping(self._mapping)
        for fut in self._osdmap_waiters:
            if not fut.done():
                fut.set_result(self.osdmap)
        self._osdmap_waiters.clear()
        for cb in self.map_callbacks:
            await cb(self.osdmap)

    # -- commands ----------------------------------------------------------
    async def command(self, cmd: dict | str, inbl: bytes = b"",
                      timeout: float = 30.0) -> tuple[int, str, bytes]:
        """Send a command, following leader redirects
        (ref: MonClient::start_mon_command + forwarding)."""
        payload = json.dumps(cmd) if isinstance(cmd, dict) else \
            json.dumps({"prefix": cmd})
        deadline = asyncio.get_event_loop().time() + timeout
        last_err = "timed out"
        tried_hunt = 0
        while asyncio.get_event_loop().time() < deadline:
            self._tid += 1
            tid = self._tid
            fut = asyncio.get_event_loop().create_future()
            self._command_waiters[tid] = fut
            try:
                if self._cur_rank not in self.monmap.ranks():
                    # the session mon left the monmap mid-flight
                    self._cur_rank = self._next_rank(self._cur_rank)
                await self.msgr.send_message(
                    MMonCommand(tid=tid, cmd=payload, inbl=inbl),
                    self.monmap.addr_of_rank(self._cur_rank),
                    f"mon.{self.monmap.name_of_rank(self._cur_rank)}")
                # generous per-attempt wait: a first CRUSH-mapper jit
                # compile on a small host can block the mon for >10 s
                ret, rs, outbl = await asyncio.wait_for(
                    fut, timeout=min(15.0, deadline -
                                     asyncio.get_event_loop().time()))
            except (asyncio.TimeoutError, ConnectionError, OSError,
                    AuthError, ConnectionError_, KeyError) as e:
                self._command_waiters.pop(tid, None)
                last_err = str(e) or type(e).__name__
                # hunt: try the next monitor (ref: MonClient::_reopen)
                # against the LATEST monmap — the boot-time rank list
                # may have been fully rotated away by `mon add/rm`
                tried_hunt += 1
                self._cur_rank = self._next_rank(self._cur_rank)
                await asyncio.sleep(0.05)
                continue
            if ret == -11:               # EAGAIN: redirect or retry
                if rs.startswith("leader="):
                    leader = int(rs.split("=", 1)[1])
                    if leader >= 0 and leader in self.monmap.ranks():
                        self._cur_rank = leader
                await asyncio.sleep(0.05)
                continue
            await self._renew_subs_if_moved()
            # clients have no stats loop: the periodic (background,
            # 2s-throttled) renewal rides command traffic, so a
            # mon-side conn reset can't leave a command-active client
            # silently unsubscribed
            self.renew_subs()
            return ret, rs, outbl
        return -110, f"command timed out ({last_err})", b""   # -ETIMEDOUT

    async def send_report(self, msg) -> bool:
        """Fire-and-forget daemon report (boot/failure/pgstats) with mon
        hunting: a dead current mon rotates to the next rank instead of
        silently dropping reports (ref: MonClient::_reopen_session)."""
        for _ in range(max(len(self.monmap.ranks()), 1)):
            rank = self._cur_rank
            if rank not in self.monmap.ranks():
                self._cur_rank = self._next_rank(rank)
                continue
            try:
                await asyncio.wait_for(self.msgr.send_message(
                    msg, self.monmap.addr_of_rank(rank),
                    f"mon.{self.monmap.name_of_rank(rank)}"),
                    timeout=2.0)
                await self._renew_subs_if_moved()
                return True
            except (asyncio.TimeoutError, ConnectionError, OSError,
                    AuthError, ConnectionError_, KeyError):
                self._cur_rank = self._next_rank(rank)
        return False

    async def clog(self, level: str, msg: str) -> bool:
        """One cluster-log line to the LogMonitor (ref: LogClient) —
        fire-and-forget like every other daemon report."""
        import time
        return await self.send_report(MLog(
            name=self.name, level=level, msg=msg, stamp=time.time()))

    # -- maps --------------------------------------------------------------
    async def subscribe(self, what: str = "osdmap",
                        start: int = 0) -> None:
        """ref: MonClient::sub_want + renew_subs. Hunts like
        send_report: a dead current mon must rotate, not raise — every
        caller (incl. the objecter's map-refresh retry loop) treats
        subscription as fire-and-forget."""
        self._subs[what] = start
        for _ in range(max(len(self.monmap.ranks()), 1)):
            rank = self._cur_rank
            if rank not in self.monmap.ranks():
                self._cur_rank = self._next_rank(rank)
                continue
            try:
                await asyncio.wait_for(self.msgr.send_message(
                    MMonSubscribe(what={what: str(start)}),
                    self.monmap.addr_of_rank(rank),
                    f"mon.{self.monmap.name_of_rank(rank)}"),
                    timeout=2.0)
                self._sub_rank = rank
                return
            except (asyncio.TimeoutError, ConnectionError, OSError,
                    AuthError, ConnectionError_, KeyError):
                self._cur_rank = self._next_rank(rank)
        self._sub_rank = None

    def renew_subs(self) -> None:
        """Periodic-renewal hook (ref: MonClient renew_subs on the
        sub renew interval): daemons call this from their idle loops —
        a daemon with nothing to report (the stats loop's
        early-continue) must still keep its subscriptions alive. The
        mon drops a conn's subscriptions on ms_handle_reset, and a
        TCP reset the client transparently reconnected across
        (election churn, handshake timeout) would otherwise leave it
        silently unsubscribed and permanently stale — the round-6
        storm wedge: an OSD pinned to a removed mon at a frozen
        epoch, waiting forever for an up_thru grant's map that was
        published into a dead subscription.

        Runs as a BACKGROUND task (2s-throttled): the re-subscribes
        hunt with per-attempt timeouts, and blocking a stats/beacon
        loop on them during a partition would slow every fault test
        for a renewal that is pure insurance."""
        now = asyncio.get_event_loop().time()
        if not self._subs or now - self._last_renew < 2.0:
            return
        self._last_renew = now
        asyncio.ensure_future(self._renew_all_subs())

    async def _renew_all_subs(self) -> None:
        for what in list(self._subs):
            start = self._subs[what]
            if what == "osdmap" and self.osdmap is not None:
                start = self.osdmap.epoch + 1
            elif what == "monmap":
                start = self.monmap.epoch + 1
            await self.subscribe(what, start)   # hunts internally

    async def _renew_subs_if_moved(self) -> None:
        """Re-register subscriptions after mon hunting moved the
        session away from the rank that holds them. _sub_rank is None
        when a previous registration failed everywhere — that means
        RENEW (nobody holds our subs), not skip."""
        if not self._subs or self._sub_rank == self._cur_rank:
            return
        await self._renew_all_subs()

    async def wait_for_osdmap(self, min_epoch: int = 1,
                              timeout: float = 10.0):
        deadline = asyncio.get_event_loop().time() + timeout
        while self.osdmap is None or self.osdmap.epoch < min_epoch:
            if asyncio.get_event_loop().time() > deadline:
                raise TimeoutError("no osdmap")
            fut = asyncio.get_event_loop().create_future()
            self._osdmap_waiters.append(fut)
            try:
                await asyncio.wait_for(fut, timeout=1.0)
            except asyncio.TimeoutError:
                await self.subscribe("osdmap",
                                     0 if self.osdmap is None
                                     else self.osdmap.epoch + 1)
        return self.osdmap

    async def shutdown(self) -> None:
        await self.msgr.shutdown()
