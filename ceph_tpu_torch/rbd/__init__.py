"""librbd analog: block images striped over RADOS objects.

ref: src/librbd/ (librbd::RBD / librbd::Image) — an image is a header
object (``rbd_header.<name>``: size/order/features in omap) plus data
objects ``rbd_data.<name>.<N>`` of ``2^order`` bytes each; image I/O
maps byte extents onto those objects exactly like the reference's
Striper (ref: src/osdc/Striper.cc with stripe_count=1). The API keeps
the reference's names: RBD.create/list/remove/clone, Image.read/write/
resize/size/stat/snap_*.

Snapshots ride the RADOS self-managed snap machinery
(ref: librbd snapshots are selfmanaged snaps + the image snapc):
snap_create allocates a pool snap id and records it in the header;
writes carry the image snap context so the OSD clones-on-write; reads
of an Image opened at a snapshot pass the snap id down. Clones are
copy-on-write children referencing a PROTECTED parent snapshot with
client-side fallthrough reads and copy-up on first write, like the
reference's layering (ref: src/librbd/io/CopyupRequest).

Header note: the header omap's ``meta`` blob is the
image's whole control plane — ``size``/``order`` plus ``snaps``
(name -> {id, size-at-snap}), ``protected`` (snap names), ``parent``
({image, snap} for clone children) and ``children``
([(child, parent-snap)] on the PARENT). Every refusal decision
(snap_remove/unprotect/clone/remove) re-reads the header first
(``Image._refresh_meta``) instead of trusting open-time state:
upstream serializes these through cls_rbd on the header object, and
the re-read is this client's seat for that atomicity — deciding on a
stale ``children`` list is exactly the open-clone-child race the
errno-matrix test pins (-EBUSY on unprotect/rm with children, which
applies even to an UNprotected snap: a crash between clone and
protect must not strand the child).

Incremental replication: ``Image.export_diff`` /
``import_diff`` speak the ``rbd diff v1`` tagged stream
(from-snap/to-snap/size/write/zero records), so snapshots chain
between clusters the way ``rbd export-diff | rbd import-diff`` does.

This is also this framework's libradosstriper seat: large-object
striping over many RADOS objects, client-side.

The port's copy of ``ceph_tpu/rbd/__init__.py``. It holds no device
state of its own: an image lives on the ``IoCtx`` it is given, and the
``Rados`` that opened it owns the device (``Rados(device=)``, CUDA
unless ``"cpu"``). Headers, data object names and the ``rbd diff v1``
stream are the reference's bytes, so either package opens the other's
images.
"""

from __future__ import annotations

import json
import struct

from ceph_tpu_torch.rados import IoCtx, ObjectOperationError

__all__ = ["RBD", "Image"]

RBD_DIRECTORY = "rbd_directory"


def _header(name: str) -> str:
    return f"rbd_header.{name}"


def _data(name: str, idx: int) -> str:
    return f"rbd_data.{name}.{idx:016x}"


class RBD:
    """ref: librbd::RBD — image management on one pool."""

    def __init__(self, ioctx: IoCtx):
        self.ioctx = ioctx

    async def create(self, name: str, size: int,
                     order: int = 22) -> None:
        """ref: RBD::create (order = log2 object size, default 4 MiB)."""
        if not (12 <= order <= 26):
            raise ValueError("order must be in [12, 26]")
        existing = await self.list()
        if name in existing:
            raise ObjectOperationError(-17, f"image {name} exists")
        io = self.ioctx
        await io.set_omap(_header(name), "meta", json.dumps(
            {"size": size, "order": order}).encode())
        await io.set_omap(RBD_DIRECTORY, name, b"1")

    async def list(self) -> list[str]:
        try:
            return sorted(await self.ioctx.get_omap_vals(RBD_DIRECTORY))
        except ObjectOperationError:
            return []

    async def remove(self, name: str) -> None:
        """ref: RBD::remove — data objects, header, directory entry.
        Refuses while snapshots exist (like the reference)."""
        img = await self.open(name)
        if img.snaps:
            raise ObjectOperationError(-39, "image has snapshots")
        for idx in img._object_range(0, img.size_bytes):
            try:
                await self.ioctx.remove(_data(name, idx))
            except ObjectOperationError:
                pass
        await self.ioctx.remove(_header(name))
        try:
            await self.ioctx.rm_omap_key(RBD_DIRECTORY, name)
        except ObjectOperationError:
            pass
        # a removed clone must drop off its parent's children list, or
        # the parent snap can never be unprotected/removed (ref:
        # librbd::image::RemoveRequest child detach)
        parent_ref = img.meta.get("parent")
        if parent_ref:
            try:
                parent = await self.open(parent_ref["image"])
                kids = parent.meta.get("children", [])
                kept = [c for c in kids if c[0] != name]
                if kept != kids:
                    parent.meta["children"] = kept
                    await parent._save_meta()
            except ObjectOperationError:
                pass                    # parent already gone

    async def open(self, name: str, snapshot: str | None = None) -> "Image":
        """ref: RBD::open / Image::snap_set — ``snapshot`` opens a
        read-only view at that snap."""
        io = self.ioctx
        try:
            omap = await io.get_omap_vals(_header(name))
        except ObjectOperationError:
            raise ObjectOperationError(-2, f"no image {name}") from None
        if "meta" not in omap:
            raise ObjectOperationError(-2, f"no image {name}")
        meta = json.loads(omap["meta"])
        img = Image(io, name, meta["size"], meta["order"], meta=meta,
                    rbd=self)
        if snapshot is not None:
            if snapshot not in img.snaps:
                raise ObjectOperationError(-2, f"no snap {snapshot}")
            img.snap_name = snapshot
            img.snap_id = img.snaps[snapshot]["id"]
            img.size_bytes = img.snaps[snapshot]["size"]
        return img

    async def clone(self, parent_name: str, snap_name: str,
                    child_name: str) -> None:
        """Copy-on-write child of a PROTECTED parent snapshot
        (ref: RBD::clone; parent must be protected first)."""
        parent = await self.open(parent_name)
        snap = parent.snaps.get(snap_name)
        if snap is None:
            raise ObjectOperationError(-2, f"no snap {snap_name}")
        if snap_name not in parent.meta.get("protected", []):
            raise ObjectOperationError(-22,
                                       f"snap {snap_name} not protected")
        existing = await self.list()
        if child_name in existing:
            raise ObjectOperationError(-17, f"image {child_name} exists")
        meta = {"size": snap["size"], "order": parent.order,
                "parent": {"image": parent_name, "snap": snap_name,
                           "snap_id": snap["id"]}}
        await self.ioctx.set_omap(_header(child_name), "meta",
                                  json.dumps(meta).encode())
        await self.ioctx.set_omap(RBD_DIRECTORY, child_name, b"1")
        # record the child on the parent so protected snaps with
        # children refuse removal (ref: rbd_children tracking)
        children = parent.meta.setdefault("children", [])
        if [child_name, snap_name] not in children:
            children.append([child_name, snap_name])
            await parent._save_meta()


class Image:
    """ref: librbd::Image — byte-addressed I/O over the data objects."""

    def __init__(self, ioctx: IoCtx, name: str, size: int, order: int,
                 meta: dict | None = None, rbd: "RBD | None" = None):
        self.ioctx = ioctx
        self.name = name
        self.size_bytes = size
        self.order = order
        self.obj_size = 1 << order
        self.meta = meta if meta is not None else {"size": size,
                                                   "order": order}
        self.rbd = rbd
        # snaps: name -> {"id": snapid, "size": size_at_snap}
        self.snaps: dict[str, dict] = self.meta.get("snaps", {})
        self.snap_name: str | None = None    # opened-at-snap view
        self.snap_id = 0
        self.parent = self.meta.get("parent")

    # -- snapshot plumbing -------------------------------------------------
    def _snapc(self) -> tuple | None:
        """The image's write snap context: (newest id, all ids desc)
        (ref: librbd ImageCtx::snapc)."""
        ids = sorted((s["id"] for s in self.snaps.values()),
                     reverse=True)
        return (ids[0], ids) if ids else None

    async def _save_meta(self) -> None:
        self.meta["size"] = self.size_bytes
        self.meta["order"] = self.order
        self.meta["snaps"] = self.snaps
        await self.ioctx.set_omap(_header(self.name), "meta",
                                  json.dumps(self.meta).encode())

    def _assert_writable(self) -> None:
        if self.snap_name is not None:
            raise ObjectOperationError(-30, "snapshot view is read-only")

    async def _refresh_meta(self) -> None:
        """Re-read the header before a refusal decision. The children
        list lives in the parent's header omap; another handle's
        clone()/remove() mutates it AFTER this Image was opened, so
        deciding unprotect/rm on the open-time snapshot of meta races
        an open clone child (ref: upstream serializes these through
        cls_rbd on the header object — the re-read is this client's
        seat for that atomicity)."""
        omap = await self.ioctx.get_omap_vals(_header(self.name))
        if "meta" not in omap:
            raise ObjectOperationError(-2, f"no image {self.name}")
        self.meta = json.loads(omap["meta"])
        self.snaps = self.meta.get("snaps", {})
        self.parent = self.meta.get("parent")

    async def snap_create(self, snap_name: str) -> int:
        """ref: Image::snap_create — allocate a self-managed snap id,
        record it; subsequent writes clone-on-write at the OSD."""
        self._assert_writable()
        if snap_name in self.snaps:
            raise ObjectOperationError(-17, f"snap {snap_name} exists")
        sid = await self.ioctx.selfmanaged_snap_create()
        self.snaps[snap_name] = {"id": sid, "size": self.size_bytes}
        await self._save_meta()
        return sid

    async def snap_list(self) -> list[dict]:
        return [{"name": n, "id": s["id"], "size": s["size"]}
                for n, s in sorted(self.snaps.items(),
                                   key=lambda kv: kv[1]["id"])]

    async def snap_protect(self, snap_name: str) -> None:
        """ref: Image::snap_protect — -EBUSY when already protected
        (the reference's errno, pinned by the snap matrix test)."""
        await self._refresh_meta()
        if snap_name not in self.snaps:
            raise ObjectOperationError(-2, f"no snap {snap_name}")
        prot = self.meta.setdefault("protected", [])
        if snap_name in prot:
            raise ObjectOperationError(
                -16, f"snap {snap_name} already protected")
        prot.append(snap_name)
        await self._save_meta()

    async def snap_unprotect(self, snap_name: str) -> None:
        """ref: Image::snap_unprotect — -ENOENT for a missing snap,
        -EINVAL when not protected, -EBUSY while clone children
        reference it. Decides on a FRESH header read: a clone created
        through another handle after this one opened must still
        refuse (the open-child race in the children list)."""
        await self._refresh_meta()
        if snap_name not in self.snaps:
            raise ObjectOperationError(-2, f"no snap {snap_name}")
        if snap_name not in self.meta.get("protected", []):
            raise ObjectOperationError(
                -22, f"snap {snap_name} is not protected")
        children = [c for c in self.meta.get("children", [])
                    if c[1] == snap_name]
        if children:
            raise ObjectOperationError(-16, "snap has clone children")
        self.meta["protected"].remove(snap_name)
        await self._save_meta()

    async def snap_remove(self, snap_name: str) -> None:
        """ref: Image::snap_remove — trims the snap from every data
        object's clones, then drops it from the header and pool.
        Children are checked independently of protection: the
        protect flag and the children list are written in separate
        header updates, so a crash can strand children on an
        unprotected snap — their parent data must still refuse to
        die (-EBUSY, same as the reference's list_children gate)."""
        await self._refresh_meta()
        snap = self.snaps.get(snap_name)
        if snap is None:
            raise ObjectOperationError(-2, f"no snap {snap_name}")
        if snap_name in self.meta.get("protected", []):
            raise ObjectOperationError(-16, f"snap {snap_name} protected")
        if any(c[1] == snap_name
               for c in self.meta.get("children", [])):
            raise ObjectOperationError(-16, "snap has clone children")
        top = max(self.size_bytes, snap["size"])
        for idx in self._object_range(0, top):
            try:
                await self.ioctx.snap_trim(_data(self.name, idx),
                                           snap["id"])
            except ObjectOperationError:
                pass
        await self.ioctx.selfmanaged_snap_remove(snap["id"])
        self.snaps.pop(snap_name, None)
        await self._save_meta()

    async def snap_rollback(self, snap_name: str) -> None:
        """ref: Image::snap_rollback — per-object restore of the snap
        state (itself snapc-protected, so newer snaps still see the
        pre-rollback data)."""
        self._assert_writable()
        snap = self.snaps.get(snap_name)
        if snap is None:
            raise ObjectOperationError(-2, f"no snap {snap_name}")
        sid = snap["id"]
        snapc = self._snapc()
        top = max(self.size_bytes, snap["size"])
        for idx in self._object_range(0, top):
            oid = _data(self.name, idx)
            try:
                old = await self.ioctx.read(oid, snap_id=sid)
            except ObjectOperationError:
                # object absent at snap time: drop the head too
                try:
                    await self.ioctx.remove(oid, snapc=snapc)
                except ObjectOperationError:
                    pass
                continue
            await self.ioctx.write_full(oid, old, snapc=snapc)
        self.size_bytes = snap["size"]
        await self._save_meta()

    def _object_range(self, offset: int, length: int) -> list[int]:
        if length <= 0:
            return []
        first = offset // self.obj_size
        last = (offset + length - 1) // self.obj_size
        return list(range(first, last + 1))

    async def size(self) -> int:
        return self.size_bytes

    async def _parent_image(self) -> "Image":
        if getattr(self, "_parent_img", None) is None:
            self._parent_img = await self.rbd.open(
                self.parent["image"], snapshot=self.parent["snap"])
        return self._parent_img

    async def _copyup(self, idx: int) -> None:
        """First write to a cloned object: materialize the parent
        snap's content in the child first (ref: io/CopyupRequest)."""
        oid = _data(self.name, idx)
        try:
            await self.ioctx.stat(oid)
            return                          # child object exists
        except ObjectOperationError as e:
            if e.errno != -2:
                # a timeout/transport error is NOT "absent": assuming
                # so would overwrite newer child data with the parent
                # snapshot's content
                raise
        parent = await self._parent_image()
        off = idx * self.obj_size
        if off >= parent.size_bytes:
            return
        data = await parent.read(off, self.obj_size)
        if data.rstrip(b"\x00"):
            await self.ioctx.write_full(oid, data, snapc=self._snapc())

    async def write(self, offset: int, data: bytes) -> int:
        """ref: Image::write — extent-split across data objects; the
        image snapc rides every object write (clone-on-write for
        snapshots); clone children copy-up before the first write."""
        self._assert_writable()
        if offset + len(data) > self.size_bytes:
            raise ObjectOperationError(-27, "write past image size")
        snapc = self._snapc()
        done = 0
        while done < len(data):
            abs_off = offset + done
            idx = abs_off // self.obj_size
            within = abs_off % self.obj_size
            n = min(self.obj_size - within, len(data) - done)
            if self.parent is not None:
                await self._copyup(idx)
            await self.ioctx.write(_data(self.name, idx),
                                   data[done:done + n], offset=within,
                                   snapc=snapc)
            done += n
        return done

    async def read(self, offset: int, length: int) -> bytes:
        """ref: Image::read — absent data objects read as zeros; clone
        children fall through to the parent snapshot (layering)."""
        length = min(length, max(self.size_bytes - offset, 0))
        out = bytearray(length)
        done = 0
        while done < length:
            abs_off = offset + done
            idx = abs_off // self.obj_size
            within = abs_off % self.obj_size
            n = min(self.obj_size - within, length - done)
            try:
                piece = await self.ioctx.read(
                    _data(self.name, idx), length=n, offset=within,
                    snap_id=self.snap_id)
                out[done:done + len(piece)] = piece
            except ObjectOperationError as e:
                if e.errno != -2:
                    raise   # timeout/transport error != sparse object
                if self.parent is not None:
                    parent = await self._parent_image()
                    if abs_off < parent.size_bytes:
                        piece = await parent.read(abs_off, n)
                        out[done:done + len(piece)] = piece
                # else sparse: zeros
            done += n
        return bytes(out)

    async def resize(self, new_size: int) -> None:
        """ref: Image::resize — shrink drops whole trailing objects
        (snapc-protected, so snapshots keep the dropped data)."""
        self._assert_writable()
        snapc = self._snapc()
        if new_size < self.size_bytes:
            for idx in self._object_range(
                    new_size, self.size_bytes - new_size):
                if idx * self.obj_size >= new_size:
                    try:
                        await self.ioctx.remove(_data(self.name, idx),
                                                snapc=snapc)
                    except ObjectOperationError:
                        pass
                elif new_size % self.obj_size:
                    try:
                        await self.ioctx.truncate(
                            _data(self.name, idx),
                            new_size % self.obj_size, snapc=snapc)
                    except ObjectOperationError:
                        pass
        self.size_bytes = new_size
        await self._save_meta()

    async def stat(self) -> dict:
        """ref: Image::stat (info_t)."""
        return {"size": self.size_bytes, "order": self.order,
                "obj_size": self.obj_size,
                "num_objs": -(-self.size_bytes // self.obj_size),
                "block_name_prefix": f"rbd_data.{self.name}"}

    # -- incremental export/import ----------------------------------------
    # ref: rbd export-diff / import-diff (src/tools/rbd/action/
    # ExportDiff.cc + ImportDiff.cc); stream format per
    # doc/dev/rbd-diff.rst "rbd diff v1": magic, then tagged records
    # f=from-snap, t=to-snap, s=size, w=offset/length/data,
    # z=offset/length (zeroed extent), e=end. Diffs chain: export-diff
    # from snap A at snap B, import-diff onto a copy holding A,
    # snap B appears — incremental replication without shipping the
    # whole image.

    DIFF_MAGIC = b"rbd diff v1\n"
    _DIFF_GRAIN = 4096

    async def export_diff(self, from_snap: str | None = None) -> bytes:
        """The v1 diff stream from ``from_snap`` to THIS view (open the
        image at a snapshot to export up to that snap; at head for
        up-to-now). ``from_snap=None`` exports the full view (every
        allocated extent)."""
        fv = None
        if from_snap is not None:
            s = self.snaps.get(from_snap)
            if s is None:
                raise ObjectOperationError(-2, f"no snap {from_snap}")
            if self.snap_name is not None and \
                    s["id"] >= self.snap_id:
                raise ObjectOperationError(
                    -22, "from_snap is not older than the exported view")
            fv = Image(self.ioctx, self.name, s["size"], self.order,
                       meta=self.meta, rbd=self.rbd)
            fv.snap_name = from_snap
            fv.snap_id = s["id"]
        out = [self.DIFF_MAGIC]
        if from_snap is not None:
            nb = from_snap.encode()
            out.append(b"f" + struct.pack("<I", len(nb)) + nb)
        if self.snap_name is not None:
            nb = self.snap_name.encode()
            out.append(b"t" + struct.pack("<I", len(nb)) + nb)
        out.append(b"s" + struct.pack("<Q", self.size_bytes))
        g = self._DIFF_GRAIN
        nobj = -(-self.size_bytes // self.obj_size)
        for idx in range(nobj):
            off0 = idx * self.obj_size
            blen = min(self.obj_size, self.size_bytes - off0)
            b = await self.read(off0, blen)
            if fv is not None and off0 < fv.size_bytes:
                a = await fv.read(off0,
                                  min(self.obj_size,
                                      fv.size_bytes - off0))
            else:
                a = b""
            a = a.ljust(len(b), b"\0")
            # classify per grain, merge adjacent same-kind runs. The
            # loop always takes one final kind="end" pass — even when
            # the object's length is not a grain multiple — so an open
            # run covering the tail ALWAYS flushes (a `while pos <=
            # len` guard silently dropped the last run of any object
            # with len % grain != 0).
            run_kind, run_start = None, 0
            pos = 0
            while True:
                if pos < len(b):
                    ca = a[pos:pos + g]
                    cb = b[pos:pos + g]
                    kind = None if ca == cb else \
                        ("z" if cb.strip(b"\0") == b"" else "w")
                else:
                    kind = "end"
                    pos = len(b)     # clamp: the closing flush must
                                     # not overstate a tail z-extent
                if kind != run_kind:
                    if run_kind == "w":
                        data = b[run_start:pos]
                        out.append(b"w" + struct.pack(
                            "<QQ", off0 + run_start, len(data)) + data)
                    elif run_kind == "z":
                        out.append(b"z" + struct.pack(
                            "<QQ", off0 + run_start, pos - run_start))
                    run_kind, run_start = kind, pos
                if kind == "end":
                    break
                pos += g
        out.append(b"e")
        return b"".join(out)

    async def import_diff(self, stream: bytes) -> None:
        """Apply a v1 diff stream to this (head, writable) image: the
        from-snap must exist here, the to-snap is created after the
        data lands (ref: ImportDiff.cc ordering). Every record read is
        bounds-checked: a stream truncated mid-record raises a clean
        ObjectOperationError(-22) instead of leaking struct.error to
        callers like rbd_cli."""
        self._assert_writable()
        if not stream.startswith(self.DIFF_MAGIC):
            raise ObjectOperationError(-22, "not an rbd diff v1 stream")
        pos = len(self.DIFF_MAGIC)
        end_snap = None
        ended = False

        def need(n: int) -> None:
            if pos + n > len(stream):
                raise ObjectOperationError(-22, "truncated diff stream")

        while pos < len(stream) and not ended:
            tag = stream[pos:pos + 1]
            pos += 1
            if tag == b"f":
                need(4)
                (n,) = struct.unpack_from("<I", stream, pos)
                need(4 + n)
                name = stream[pos + 4:pos + 4 + n].decode()
                pos += 4 + n
                if name not in self.snaps:
                    raise ObjectOperationError(
                        -22, f"start snapshot {name} not present")
            elif tag == b"t":
                need(4)
                (n,) = struct.unpack_from("<I", stream, pos)
                need(4 + n)
                end_snap = stream[pos + 4:pos + 4 + n].decode()
                pos += 4 + n
            elif tag == b"s":
                need(8)
                (size,) = struct.unpack_from("<Q", stream, pos)
                pos += 8
                await self.resize(size)
            elif tag == b"w":
                need(16)
                off, n = struct.unpack_from("<QQ", stream, pos)
                pos += 16
                need(n)
                await self.write(off, stream[pos:pos + n])
                pos += n
            elif tag == b"z":
                need(16)
                off, n = struct.unpack_from("<QQ", stream, pos)
                pos += 16
                while n:
                    step = min(n, self.obj_size)
                    await self.write(off, b"\0" * step)
                    off += step
                    n -= step
            elif tag == b"e":
                ended = True
            else:
                raise ObjectOperationError(
                    -22, f"unknown diff record {tag!r}")
        if not ended:
            raise ObjectOperationError(-22, "truncated diff stream")
        if end_snap is not None:
            await self.snap_create(end_snap)
