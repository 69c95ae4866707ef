"""The port's CephFS package. It holds the FSMap (``cephfs/fsmap.py``),
which the MDSMonitor commits, and the path normaliser the MDSMonitor
imports from here. The CephFS client (``CephFSLite``, over RADOS) is
not ported yet."""

from __future__ import annotations

import posixpath


def _norm(path: str) -> str:
    p = posixpath.normpath("/" + path.strip("/"))
    return p
