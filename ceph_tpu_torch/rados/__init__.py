"""librados analog: the public client API.

ref: src/librados/librados_cxx.cc (Rados / IoCtx) — connection
bootstrap via MonClient, pool handles, and synchronous+async object
ops riding the Objecter. Method names mirror the reference's C++ API
(``Rados::connect``, ``IoCtx::write/read/remove/stat``,
``IoCtx::get_omap_vals`` …) so reference users find what they expect.

The port's copy of ``ceph_tpu/rados/__init__.py``. A ``Rados`` owns its
device (``device=``, CUDA unless ``"cpu"``; it raises without a card):
its ``MonClient`` decodes the maps the objecter targets by there.
"""

from __future__ import annotations

import asyncio
import json

import itertools

from ceph_tpu_torch.mon.client import MonClient
from ceph_tpu_torch.mon.monitor import MonMap
from ceph_tpu_torch.msg import Dispatcher, Keyring
from ceph_tpu_torch.osd.messages import (
    MWatchNotify,
    OSD_OP_DELETE, OSD_OP_GETXATTR, OSD_OP_NOTIFY, OSD_OP_NOTIFY_ACK,
    OSD_OP_OMAP_GET, OSD_OP_OMAP_RM,
    OSD_OP_OMAP_SET, OSD_OP_PGLS, OSD_OP_READ, OSD_OP_SETXATTR,
    OSD_OP_SNAPTRIM, OSD_OP_STAT, OSD_OP_TRUNCATE, OSD_OP_UNWATCH,
    OSD_OP_WATCH, OSD_OP_WRITE, OSD_OP_WRITEFULL,
    OSD_OP_ZERO,
)
from ceph_tpu_torch.osd.messages import OSD_FLAG_FULL_TRY
from ceph_tpu_torch.osdc.objecter import Objecter, ObjectOperationError

__all__ = ["Rados", "IoCtx", "ObjectOperationError",
           "OSD_FLAG_FULL_TRY"]


class _WatchDispatcher(Dispatcher):
    """Delivers MWatchNotify to registered callbacks and auto-acks
    (ref: librados watch callback + notify_ack)."""

    def __init__(self, rados: "Rados"):
        self.rados = rados

    async def ms_dispatch(self, msg) -> bool:
        if not isinstance(msg, MWatchNotify):
            return False
        ent = self.rados._watches.get(msg.cookie)
        if ent is not None:
            ioctx, oid, cb = ent
            try:
                res = cb(msg.notify_id, msg.payload)
                if hasattr(res, "__await__"):
                    await res
            except Exception:
                pass
            # ack so the notifier's collection completes
            asyncio.ensure_future(ioctx._op(oid, [
                (OSD_OP_NOTIFY_ACK, msg.notify_id, msg.cookie, "", b"")]))
        return True


class Rados:
    """ref: librados::Rados."""

    def __init__(self, monmap: MonMap, name: str = "client.admin",
                 keyring: Keyring | None = None,
                 config: dict | None = None, device=None):
        self.monc = MonClient(name, monmap, keyring=keyring,
                              device=device)
        self.objecter = Objecter(self.monc, config=config)
        # cookie -> (ioctx, oid, callback)
        self._watches: dict[int, tuple] = {}
        self._cookie_gen = itertools.count(1)
        self.monc.msgr.add_dispatcher(_WatchDispatcher(self))

    async def connect(self) -> None:
        await self.monc.subscribe("osdmap", 0)
        # follow the monmap (membership changes at runtime)
        # and our own key lifecycle (rotation reaches us even with a
        # private keyring file)
        await self.monc.subscribe("monmap", 0)
        if self.monc.msgr.keyring is not None:
            await self.monc.subscribe("keyring", 0)
        await self.monc.wait_for_osdmap()

    async def shutdown(self) -> None:
        await self.monc.shutdown()

    async def mon_command(self, cmd, inbl: bytes = b"",
                          timeout: float = 30.0):
        return await self.monc.command(cmd, inbl, timeout=timeout)

    async def pool_create(self, name: str, pg_num: int = 32,
                          **kw) -> None:
        """Create the pool, and return once this client's own osdmap
        holds it, so an ``open_ioctx`` right after finds it. Ceph's
        Objecter holds a pool op's completion until the client has the
        map of the reply's epoch (``Objecter::handle_pool_op_reply``);
        the reference returns on the mon's reply, and its next
        ``open_ioctx`` can raise ``no pool``. The wait is bounded by the
        objecter's op timeout."""
        ret, rs, _ = await self.mon_command(
            dict({"prefix": "osd pool create", "pool": name,
                  "pg_num": pg_num}, **kw))
        if ret != 0:
            raise ObjectOperationError(ret, rs)
        loop = asyncio.get_event_loop()
        deadline = loop.time() + self.objecter.op_timeout
        osdmap = self.monc.osdmap
        while osdmap is None or \
                all(p.name != name for p in osdmap.pools.values()):
            left = deadline - loop.time()
            if left <= 0:
                raise ObjectOperationError(
                    -110, f"pool {name!r} created, but this client's "
                          f"osdmap never held it")
            try:
                osdmap = await self.monc.wait_for_osdmap(
                    min_epoch=1 if osdmap is None else osdmap.epoch + 1,
                    timeout=left)
            except TimeoutError:
                osdmap = self.monc.osdmap

    async def pool_delete(self, name: str) -> None:
        ret, rs, _ = await self.mon_command(
            {"prefix": "osd pool rm", "pool": name})
        if ret != 0:
            raise ObjectOperationError(ret, rs)

    async def open_ioctx(self, pool_name: str) -> "IoCtx":
        pid = await self.objecter.pool_id(pool_name)
        return IoCtx(self, pid, pool_name)

    async def status(self) -> dict:
        ret, rs, out = await self.mon_command({"prefix": "status"})
        if ret != 0:
            raise ObjectOperationError(ret, rs)
        return json.loads(out)


class IoCtx:
    """ref: librados::IoCtx — per-pool I/O handle."""

    def __init__(self, rados: Rados, pool_id: int, pool_name: str):
        self.rados = rados
        self.pool_id = pool_id
        self.pool_name = pool_name
        # self-managed snap state (ref: IoCtx::selfmanaged_snap_set_
        # write_ctx / snap_set_read)
        self.snapc: tuple[int, list[int]] = (0, [])
        self.read_snap: int = 0

    def set_snap_context(self, seq: int, snaps: list[int]) -> None:
        """Write snap context: seq = newest snap id, snaps = all live
        snap ids (newest first, like the reference)."""
        self.snapc = (seq, list(snaps))

    def snap_set_read(self, snap_id: int) -> None:
        """Subsequent reads serve the object state AT this snap
        (0 = head)."""
        self.read_snap = snap_id

    # ops that serve object STATE and therefore honor read_snap; any
    # other op (mutations, watch/unwatch/notify, notify-ack) must go to
    # the head regardless of snap_set_read — librados applies the read
    # snap to reads only (ref: IoCtx::snap_set_read)
    _SNAP_READ_OPS = frozenset((
        OSD_OP_READ, OSD_OP_STAT, OSD_OP_GETXATTR, OSD_OP_OMAP_GET))

    async def _op(self, oid: str, ops, timeout: float = 20.0,
                  snapc: tuple | None = None, snap_id: int | None = None,
                  flags: int = 0):
        if snapc is None:
            snapc = self.snapc if self.snapc[0] else None
        if snap_id is None:
            snap_id = self.read_snap if ops and all(
                o[0] in self._SNAP_READ_OPS for o in ops) else 0
        res, data, extra = await self.rados.objecter.op_submit(
            self.pool_id, oid, ops, timeout=timeout,
            snapc=snapc, snap_id=snap_id, flags=flags)
        if res < 0:
            raise ObjectOperationError(res, f"{oid}")
        return data, extra

    # -- self-managed snapshots -------------------------------------------
    async def selfmanaged_snap_create(self) -> int:
        """Allocate a new snap id from the pool (ref: librados
        selfmanaged_snap_create -> OSDMonitor pool snap_seq)."""
        ret, rs, out = await self.rados.mon_command(
            {"prefix": "osd pool selfmanaged-snap-create",
             "pool": self.pool_name})
        if ret != 0:
            raise ObjectOperationError(ret, rs)
        return json.loads(out)["snapid"]

    async def selfmanaged_snap_remove(self, snap_id: int) -> None:
        ret, rs, _ = await self.rados.mon_command(
            {"prefix": "osd pool selfmanaged-snap-remove",
             "pool": self.pool_name, "snapid": snap_id})
        if ret != 0:
            raise ObjectOperationError(ret, rs)

    async def snap_trim(self, oid: str, snap_id: int) -> None:
        """Drop one snap from one object's clones (the snap trimmer's
        unit of work, client-driven here)."""
        await self._op(oid, [(OSD_OP_SNAPTRIM, snap_id, 0, "", b"")])

    # -- watch/notify ------------------------------------------------------
    async def watch(self, oid: str, callback) -> int:
        """Register callback(notify_id, payload) for notifies on oid;
        returns the watch cookie (ref: IoCtx::watch2)."""
        cookie = next(self.rados._cookie_gen)
        self.rados._watches[cookie] = (self, oid, callback)
        try:
            await self._op(oid, [(OSD_OP_WATCH, cookie, 0, "", b"")])
        except BaseException:
            self.rados._watches.pop(cookie, None)   # no leak on failure
            raise
        return cookie

    async def unwatch(self, oid: str, cookie: int) -> None:
        self.rados._watches.pop(cookie, None)
        await self._op(oid, [(OSD_OP_UNWATCH, cookie, 0, "", b"")])

    async def notify(self, oid: str, payload: bytes = b"",
                     timeout_ms: int = 2000) -> dict:
        """Send payload to every watcher, await their acks (ref:
        IoCtx::notify2). Returns {'acks': [...], 'timeouts': [...]}."""
        _, extra = await self._op(
            oid, [(OSD_OP_NOTIFY, timeout_ms, 0, "", bytes(payload))],
            timeout=max(20.0, timeout_ms / 1000 + 5))
        return extra

    # -- writes ------------------------------------------------------------
    # ``full_try`` (ref: librados OPERATION_FULL_TRY): a write blocked
    # by a FULL cluster / full pool fails fast with -ENOSPC/-EDQUOT
    # instead of parking until the condition clears.
    async def write(self, oid: str, data: bytes, offset: int = 0,
                    timeout: float = 20.0, snapc: tuple | None = None,
                    full_try: bool = False):
        await self._op(oid, [(OSD_OP_WRITE, offset, len(data), "",
                              bytes(data))], timeout=timeout, snapc=snapc,
                       flags=OSD_FLAG_FULL_TRY if full_try else 0)

    async def write_full(self, oid: str, data: bytes,
                         timeout: float = 20.0,
                         snapc: tuple | None = None,
                         full_try: bool = False):
        await self._op(oid, [(OSD_OP_WRITEFULL, 0, len(data), "",
                              bytes(data))], timeout=timeout, snapc=snapc,
                       flags=OSD_FLAG_FULL_TRY if full_try else 0)

    async def truncate(self, oid: str, size: int,
                       snapc: tuple | None = None):
        await self._op(oid, [(OSD_OP_TRUNCATE, size, 0, "", b"")],
                       snapc=snapc)

    async def zero(self, oid: str, offset: int, length: int,
                   snapc: tuple | None = None):
        await self._op(oid, [(OSD_OP_ZERO, offset, length, "", b"")],
                       snapc=snapc)

    async def remove(self, oid: str, snapc: tuple | None = None):
        await self._op(oid, [(OSD_OP_DELETE, 0, 0, "", b"")],
                       snapc=snapc)

    async def setxattr(self, oid: str, name: str, value: bytes):
        await self._op(oid, [(OSD_OP_SETXATTR, 0, 0, name,
                              bytes(value))])

    async def set_omap(self, oid: str, key: str, value: bytes):
        await self._op(oid, [(OSD_OP_OMAP_SET, 0, 0, key,
                              bytes(value))])

    async def rm_omap_key(self, oid: str, key: str):
        await self._op(oid, [(OSD_OP_OMAP_RM, 0, 0, key, b"")])

    # -- reads -------------------------------------------------------------
    async def read(self, oid: str, length: int = 0,
                   offset: int = 0, snap_id: int | None = None,
                   timeout: float = 20.0) -> bytes:
        data, _ = await self._op(
            oid, [(OSD_OP_READ, offset, length, "", b"")],
            snap_id=snap_id, timeout=timeout)
        return data

    async def stat(self, oid: str, snap_id: int | None = None) -> int:
        _, extra = await self._op(oid, [(OSD_OP_STAT, 0, 0, "", b"")],
                                  snap_id=snap_id)
        return extra["size"]

    async def getxattr(self, oid: str, name: str) -> bytes:
        data, _ = await self._op(
            oid, [(OSD_OP_GETXATTR, 0, 0, name, b"")])
        return data

    async def get_omap_vals(self, oid: str,
                            prefix: str = "") -> dict[str, bytes]:
        """All omap pairs, or only keys starting with ``prefix`` (the
        filter runs OSD-side — large omaps don't cross the wire;
        ref: the role of omap_get_vals' filter_prefix)."""
        _, extra = await self._op(
            oid, [(OSD_OP_OMAP_GET, 0, 0, prefix, b"")])
        return {k: bytes.fromhex(v)
                for k, v in extra.get("omap", {}).items()}

    async def list_objects(self) -> list[str]:
        """rados ls: union of per-PG listings (ref: librados
        nobjects_begin over pgls)."""
        osdmap = await self.rados.monc.wait_for_osdmap()
        pool = osdmap.pools[self.pool_id]
        names: set[str] = set()
        for seed in range(pool.pg_num):
            try:
                _, extra = await self._pg_op(
                    seed, [(OSD_OP_PGLS, 0, 0, "", b"")])
                names.update(extra.get("objects", []))
            except ObjectOperationError:
                continue
        return sorted(names)

    async def _pg_op(self, seed: int, ops):
        """Address a specific PG (pgls needs per-PG targeting) through
        the Objecter's full resend machinery."""
        res, data, extra = await self.rados.objecter.op_submit(
            self.pool_id, f".pgls.{seed}", ops, seed=seed, timeout=10.0)
        if res < 0:
            raise ObjectOperationError(res, f"pgls {seed}")
        return data, extra
