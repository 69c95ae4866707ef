"""libcephfs-lite: a POSIX-style namespace over RADOS.

ref: src/client/ (Client::ll_* / libcephfs.h) + src/mds/ — the API
surface of libcephfs (mkdir/rmdir/readdir/open/read/write/unlink/
rename/stat) over RADOS objects. The metadata model is the
reference's in miniature: every directory is a *dirfrag* object whose
omap maps entry name -> dentry (type/size), exactly how the MDS stores
directories in the metadata pool (ref: CDir backed by omap objects);
file payloads live in per-file data objects. ``CephFSLite`` applies
metadata ops straight to the dirfrag objects, serialized per object by
the PG op pipeline; the MDS daemon (``cephfs/mds.py``) journals each
mutation and applies it through a ``CephFSLite`` of its own, and the
MDS-backed client is ``cephfs/client.py``. The FSMap the MDSMonitor
commits is ``cephfs/fsmap.py``; the MDSMonitor imports ``_norm`` from
here.

The port's copy of ``ceph_tpu/cephfs/__init__.py``. It holds no device
state: the ``IoCtx`` it is given belongs to a ``Rados`` that owns the
device (``Rados(device=)``, CUDA unless ``"cpu"``). Dirfrag and file
object names and dentry bytes are the reference's, so either package
mounts the other's filesystem.
"""

from __future__ import annotations

import json
import posixpath

from ceph_tpu_torch.rados import IoCtx, ObjectOperationError

__all__ = ["CephFSLite", "FSError"]


class FSError(Exception):
    def __init__(self, errno: int, msg: str):
        super().__init__(msg)
        self.errno = errno


def _norm(path: str) -> str:
    p = posixpath.normpath("/" + path.strip("/"))
    return p


def _dirfrag(path: str) -> str:
    return f".dir{_norm(path)}"


def _fileobj(path: str) -> str:
    return f".file{_norm(path)}"


class CephFSLite:
    """ref: libcephfs.h ceph_mount surface."""

    def __init__(self, ioctx: IoCtx):
        self.ioctx = ioctx

    async def mount(self) -> "CephFSLite":
        """Create the root dirfrag (ref: ceph_mount + mds mkfs root)."""
        try:
            await self.ioctx.get_omap_vals(_dirfrag("/"))
        except ObjectOperationError:
            await self.ioctx.set_omap(_dirfrag("/"), "_self",
                                      _dentry("dir"))
        return self

    # -- dentries ----------------------------------------------------------
    async def _dir_entries(self, path: str) -> dict[str, dict]:
        try:
            omap = await self.ioctx.get_omap_vals(_dirfrag(path))
        except ObjectOperationError:
            raise FSError(-2, f"no such directory {path}") from None
        return {k: json.loads(v) for k, v in omap.items()
                if not k.startswith("_")}

    async def _lookup(self, path: str) -> dict:
        path = _norm(path)
        if path == "/":
            return {"type": "dir", "size": 0}
        parent, name = posixpath.split(path)
        entries = await self._dir_entries(parent)
        if name not in entries:
            raise FSError(-2, f"no such entry {path}")
        return entries[name]

    async def _add_entry(self, parent: str, name: str,
                         ent: dict) -> None:
        await self.ioctx.set_omap(_dirfrag(parent), name,
                                  json.dumps(ent).encode())

    # -- directories -------------------------------------------------------
    async def mkdir(self, path: str) -> None:
        path = _norm(path)
        parent, name = posixpath.split(path)
        entries = await self._dir_entries(parent)      # parent must exist
        if name in entries:
            raise FSError(-17, f"{path} exists")
        await self.ioctx.set_omap(_dirfrag(path), "_self",
                                  _dentry("dir"))
        await self._add_entry(parent, name, json.loads(_dentry("dir")))

    async def rmdir(self, path: str) -> None:
        path = _norm(path)
        if path == "/":
            raise FSError(-22, "cannot remove /")
        if await self._dir_entries(path):
            raise FSError(-39, f"{path} not empty")     # -ENOTEMPTY
        parent, name = posixpath.split(path)
        await self.ioctx.remove(_dirfrag(path))
        await self.ioctx.rm_omap_key(_dirfrag(parent), name)

    async def ls(self, path: str = "/") -> list[str]:
        """ref: ceph_readdir."""
        ent = await self._lookup(path)
        if ent["type"] != "dir":
            raise FSError(-20, f"{path} is not a directory")
        return sorted(await self._dir_entries(path))

    # -- files -------------------------------------------------------------
    async def write_file(self, path: str, data: bytes,
                         offset: int = 0) -> int:
        path = _norm(path)
        parent, name = posixpath.split(path)
        entries = await self._dir_entries(parent)
        old = entries.get(name)
        if old and old["type"] == "dir":
            raise FSError(-21, f"{path} is a directory")
        if offset:
            await self.ioctx.write(_fileobj(path), data, offset=offset)
        else:
            await self.ioctx.write_full(_fileobj(path), data)
        size = max((old or {}).get("size", 0), offset + len(data)) \
            if offset else len(data)
        await self._add_entry(parent, name, {"type": "file",
                                             "size": size})
        return len(data)

    async def set_size(self, path: str, size: int) -> None:
        """Update a file dentry's size without touching data — the MDS
        setattr path after a cap-holding client's direct data write
        (ref: Client::_setattr CEPH_SETATTR_SIZE without truncate)."""
        path = _norm(path)
        parent, name = posixpath.split(path)
        entries = await self._dir_entries(parent)
        ent = entries.get(name)
        if ent is None:
            raise FSError(-2, f"no such entry {path}")
        if ent["type"] != "file":
            raise FSError(-21, f"{path} is a directory")
        ent["size"] = int(size)
        await self._add_entry(parent, name, ent)

    async def read_file(self, path: str, length: int = 0,
                        offset: int = 0) -> bytes:
        ent = await self._lookup(path)
        if ent["type"] != "file":
            raise FSError(-21, f"{path} is a directory")
        try:
            return await self.ioctx.read(_fileobj(_norm(path)),
                                         length=length, offset=offset)
        except ObjectOperationError:
            return b""

    async def unlink(self, path: str) -> None:
        path = _norm(path)
        ent = await self._lookup(path)
        if ent["type"] == "dir":
            raise FSError(-21, f"{path} is a directory")
        parent, name = posixpath.split(path)
        try:
            await self.ioctx.remove(_fileobj(path))
        except ObjectOperationError:
            pass
        await self.ioctx.rm_omap_key(_dirfrag(parent), name)

    async def rename(self, src: str, dst: str) -> None:
        """ref: ceph_rename (files only here)."""
        src, dst = _norm(src), _norm(dst)
        ent = await self._lookup(src)
        if ent["type"] == "dir":
            raise FSError(-21, "directory rename not supported")
        data = await self.read_file(src)
        await self.write_file(dst, data)
        await self.unlink(src)

    async def stat(self, path: str) -> dict:
        """ref: ceph_stat (subset of struct ceph_statx)."""
        ent = await self._lookup(path)
        return {"path": _norm(path), "type": ent["type"],
                "size": ent.get("size", 0)}


def _dentry(kind: str, size: int = 0) -> bytes:
    return json.dumps({"type": kind, "size": size}).encode()
